#!/usr/bin/env python3
"""Run chip_smoke.py's data-parallel phase alone.

    python3 scripts/chip_parallel_phase.py [--out results.json]
    python3 scripts/chip_parallel_phase.py --cpu       # rehearsal, 64 px

On the card it builds the kernels, writes the Solver's P6 split under
``build/`` and runs ``chip_smoke.parallel_phase`` at 576^2 (two gloo ranks
on the card against one process, world size 1 over NCCL, two NCCL ranks
when there are two cards, the DP sweep, ``cli train --data-parallel``
under ``torch.distributed.run``).  With ``--cpu`` it runs the same phase
on CPU ranks at 64 px, without the NCCL parts: a rehearsal of its
control flow, not a measurement.
"""

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--out", help="write the phase's record as JSON here")
    parser.add_argument("--cpu", action="store_true",
                        help="rehearse on CPU ranks at 64 px")
    args = parser.parse_args()
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    sys.path.insert(0, REPO)
    import numpy as np
    import torch

    import chip_smoke as cs

    build = os.path.join(REPO, "build")
    os.makedirs(build, exist_ok=True)
    root = tempfile.mkdtemp(prefix="parallel_phase_", dir=build)
    try:
        sol = cs.solver_modules()
        if args.cpu:
            torch.set_num_threads(2)
            cs.solver_split(np, root, sol.rasterize, sol.image_io,
                            sizes=((72, 96), (96, 72)))
            smi, size, device = "cpu rehearsal", 64, "cpu"
        else:
            if not torch.cuda.is_available():
                cs.fail("no CUDA card: pass --cpu for a rehearsal")
            from dis_yolo_tpu_torch.ops import _build
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
            _build.build()
            smi = subprocess.run(
                ["nvidia-smi", "--query-gpu=name,power.limit",
                 "--format=csv,noheader"], capture_output=True, text=True,
                timeout=60).stdout.strip().splitlines()[0]
            cs.solver_split(np, root, sol.rasterize, sol.image_io)
            size, device = 576, "cuda"
        t0 = time.time()
        rec, launches = cs.parallel_phase(np, torch, root, smi, size, device)
        print(f"parallel phase passed in {time.time() - t0:.1f} s; launches "
              f"{launches}", flush=True)
        if args.out:
            with open(args.out, "w") as f:
                json.dump({"parallel": rec, "launches": launches}, f,
                          indent=1, default=str)
    finally:
        shutil.rmtree(root, ignore_errors=True)


if __name__ == "__main__":
    main()
