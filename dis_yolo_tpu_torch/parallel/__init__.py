"""Data parallelism over processes: ``distributed`` joins the process group
and holds the collectives, ``sharding`` the mesh and the placement of
batches and replicated state (the counterpart of
``dis_yolo_tpu/parallel/``; spatial partitioning is not ported yet)."""
