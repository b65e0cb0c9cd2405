#!/usr/bin/env python3
"""How far JAX's and the port's training gradients at 64 px are from the
port's float64 gradient, with XLA's CPU backend at its default
optimization level and at level 0.

    python scripts/jax_grad_gap_by_xla_level.py [--out DIR]

The case is ``tests/test_torch_train.py::test_total_loss_and_grads_
match_jax``'s: 64 px, float32 weights drawn by its ``random_variables``,
``synthetic_batch(cfg, 2, 3, seed=9)``, the ROI uniforms of
``PRNGKey(1)``, stage 1 (layers 1-52 locked) and nothing locked.  JAX's
gradients come from subprocesses (XLA flags are read at start): float32,
and float64 as ``tests/test_torch_device_corpus.py``'s ``_JAX_FLOAT64``
computes it (x64 on, the package's ``jnp.float32`` bound to float64),
each at both levels.  For each it prints the relative L2 error over all
leaves and the worst leaf's, against the port's float64 gradient, and
the losses.  CPU only; a few minutes.
"""

import argparse
import json
import os
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LEVEL0 = "--xla_backend_optimization_level=0"


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--out", help="keep the inputs and JAX's outputs here")
    args = parser.parse_args()
    sys.path.insert(0, ROOT)
    import tests.conftest  # noqa: F401  (JAX on the CPU)
    import jax
    import numpy as np
    import torch

    from dis_yolo_tpu.config import DISYoloConfig as JaxConfig
    from dis_yolo_tpu_torch.config import DISYoloConfig
    from dis_yolo_tpu_torch.models import api
    from dis_yolo_tpu_torch.models.weights import (flax_from_state_dict,
                                                   state_dict_from_flax)
    from dis_yolo_tpu_torch.train import train_step as ts
    from dis_yolo_tpu_torch.train.synthetic import synthetic_batch
    from tests.test_torch_device_corpus import _JAX_FLOAT64
    from tests.test_torch_train import (STAGE1, flat, jax_uniforms,
                                        random_variables)

    torch.set_num_threads(2)
    torch.backends.mkldnn.enabled = False      # as the test runs the port
    jax_f32 = (_JAX_FLOAT64
               .replace('jax.config.update("jax_enable_x64", True)', "")
               .replace("jnp.float32 = jnp.float64", "")
               .replace("jax.random.uniform = uniform", "")
               .replace("v.astype(np.float64) if v.dtype == np.float32 else v",
                        "v"))
    out_dir = args.out or tempfile.mkdtemp(prefix="grad_gap_")
    os.makedirs(out_dir, exist_ok=True)

    def jax_grads(script, src, tag, flag):
        dst = os.path.join(out_dir, f"{tag}.npz")
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            filter(None, (ROOT, os.environ.get("PYTHONPATH")))),
            XLA_FLAGS=" ".join(filter(None, (os.environ.get("XLA_FLAGS"),
                                             flag))))
        proc = subprocess.run([sys.executable, "-c", script, src, dst],
                              env=env, capture_output=True, text=True)
        if proc.returncode:
            sys.exit(proc.stderr[-3000:])
        with np.load(dst) as z:
            return ({k[2:]: z[k].astype(np.float64) for k in z.files
                     if k.startswith("g:")},
                    {k[2:]: float(z[k]) for k in z.files if k.startswith("m:")})

    def gap(got, want):
        keys = sorted(want)
        worst = max(np.linalg.norm(got[k] - want[k])
                    / max(np.linalg.norm(want[k]), 1e-300) for k in keys)
        a = np.concatenate([got[k].ravel() for k in keys])
        b = np.concatenate([want[k].ravel() for k in keys])
        return float(np.linalg.norm(a - b) / np.linalg.norm(b)), float(worst)

    for locked in (STAGE1, ()):
        kw = dict(image_size=64, compute_dtype="float32", locked_layers=locked,
                  pre_nms_top_k=64)
        variables = random_variables(JaxConfig(**kw), 20 + len(locked))
        cfg = DISYoloConfig(**kw)
        batch = synthetic_batch(cfg, 2, 3, seed=9)
        keys = jax.random.split(jax.random.PRNGKey(1), 2)
        src = os.path.join(out_dir, f"inputs_{len(locked)}.npz")
        arrays = {"cfg": np.asarray(json.dumps(kw)), "keys": np.asarray(keys)}
        for tag, tree in (("v:", variables), ("b:", batch)):
            arrays.update({tag + k: np.asarray(v) for k, v in flat(tree)})
        np.savez(src, **arrays)
        runs = {}
        for name, script in (("JAX float64", _JAX_FLOAT64),
                             ("JAX float32", jax_f32)):
            for level, flag in (("default", ""), ("level 0", LEVEL0)):
                runs[f"{name}, {level}"] = jax_grads(
                    script, src, f"{name.split()[1]}_{len(flag)}_{len(locked)}",
                    flag)
        u_prop, u_gt = jax_uniforms(keys, cfg.max_detection,
                                    cfg.max_box_per_image)
        as_t = lambda x: torch.from_numpy(np.array(x))
        for dtype in ("float64", "float32"):
            model = api.create_model(DISYoloConfig(**dict(
                kw, compute_dtype=dtype)), device="cpu").to(getattr(torch, dtype))
            model.load_state_dict(state_dict_from_flax(variables))
            params = dict(model.named_parameters())
            total, metrics = ts.total_loss(
                model, {k: as_t(v) for k, v in batch.items()}, as_t(u_prop),
                as_t(u_gt))
            grads = torch.autograd.grad(total, list(params.values()))
            tree = flax_from_state_dict(dict(zip(params, grads)))["params"]
            runs[f"port {dtype}"] = (
                {k: np.asarray(v, np.float64) for k, v in flat(tree)},
                {k: float(v.detach()) for k, v in metrics.items()})
        ref = runs["port float64"][0]
        print(f"{len(locked)} layers locked: gradient against the port's "
              f"float64 (relative L2 over all leaves, worst leaf); "
              f"coord_loss, wh_loss", flush=True)
        for name, (g, m) in runs.items():
            print(f"  {name}: {gap(g, ref)}; {m['coord_loss']!r}, "
                  f"{m['wh_loss']!r}", flush=True)


if __name__ == "__main__":
    main()
