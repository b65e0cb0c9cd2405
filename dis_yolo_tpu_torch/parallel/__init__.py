"""Data parallelism and spatial partitioning over processes:
``distributed`` joins the process group and holds the collectives,
``sharding`` the meshes, the row partition and the placement of batches
and replicated state, ``spatial`` the height-sharded forward, predict and
train step (the counterpart of ``dis_yolo_tpu/parallel/``)."""

from dis_yolo_tpu_torch.parallel.sharding import (HeightShard, Mesh, Mesh2D,
                                                  make_mesh, make_mesh_2d,
                                                  row_partition)

__all__ = ["HeightShard", "Mesh", "Mesh2D", "make_mesh", "make_mesh_2d",
           "row_partition"]

_SPATIAL = ("spatial_forward", "spatial_predict", "spatial_train_step")
__all__ += list(_SPATIAL)


def __getattr__(name):
    # ``spatial`` imports the model, whose layers import this package:
    # its names load on first use
    if name in _SPATIAL:
        from dis_yolo_tpu_torch.parallel import spatial
        return getattr(spatial, name)
    raise AttributeError(name)
