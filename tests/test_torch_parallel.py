"""Port parity of the data-parallel layer (``dis_yolo_tpu_torch.parallel``,
sync-BN, the mesh train steps, the DP predict and sweep, multi-process
checkpoints and ``cli train --data-parallel``) on the CPU.

One spawn of two gloo ranks on loopback (``_worker``, a function of this
file; the ranks write their results to files) serves most checks; the
one-process references and the JAX runs are computed here while the
ranks work.  Everything at 64 px, global batch 4 (two rows per rank).

Tolerances, with their reasons:
  * sync ConvBN and train-mode CommutedConcatConvBN against the
    one-process layer on the global batch, float64: 1e-12 (the moments
    are averaged per rank, then over the ranks: another summation order);
    against Flax ``BatchNorm(axis_name)`` under ``shard_map``
    (``check_vma=False``) on 2 virtual devices, float32: 1e-5 x max|ref|;
  * the DP step's float64 gradients, metrics and BN statistics against
    the one-process step on the global batch: 1e-9 x max|ref| (measured
    ~2e-13); after Adam, parameters within 1e-8: Adam's first update is
    ``lr * g / (|g| + 1e-8)``, which scales a gradient's rounding by up
    to lr / 1e-8 where |g| is tiny;
  * float32 against JAX's ``make_jitted_train_step(mesh=2 devices)``:
    the loss within rtol 1e-3 (``tests/test_torch_train.py``'s metric
    tolerance) and the parameters after the step within
    ``tests/test_parallel.py``'s rtol 5e-2, atol 3e-3 (its reason: near
    zero gradients flip an Adam update's sign in float32);
  * the ranks' replicas after three steps: bit-equal;
  * the DP predict and sweep, eval mode, float32: the boxes and scores
    within 1e-5 and the masks within 1e-5 of the one-process run at
    another batch size (the CPU convs may sum in another order).
"""

import hashlib
import json
import os
import shutil
import socket
import subprocess
import sys
import time
import traceback
from pathlib import Path
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh
from jax.sharding import PartitionSpec as P

from dis_yolo_tpu.config import DISYoloConfig as JaxConfig
from dis_yolo_tpu.data import dataset as jax_dataset
from dis_yolo_tpu.models import api as jax_api
from dis_yolo_tpu.models import layers as jax_layers
from dis_yolo_tpu.parallel import sharding as jax_sharding
from dis_yolo_tpu.train import train_step as jax_ts
from dis_yolo_tpu_torch import cli
from dis_yolo_tpu_torch.config import DISYoloConfig
from dis_yolo_tpu_torch.data import dataset
from dis_yolo_tpu_torch.data.device_corpus import CorpusTrainData, upload_corpus
from dis_yolo_tpu_torch.eval.sweep import run_split
from dis_yolo_tpu_torch.models import api
from dis_yolo_tpu_torch.models.layers import (CommutedConcatConvBN, ConvBN,
                                              sync_batch_norm)
from dis_yolo_tpu_torch.models.weights import (flax_from_state_dict,
                                               state_dict_from_flax)
from dis_yolo_tpu_torch.parallel import distributed, sharding
from dis_yolo_tpu_torch.train import checkpoint as ckpt
from dis_yolo_tpu_torch.train import train_step as ts
from dis_yolo_tpu_torch.train.synthetic import synthetic_batch
from tests.test_torch_eval import jax_numpy_fill  # noqa: F401

ROOT = Path(__file__).resolve().parent.parent
SIZE, GLOBAL_B = 64, 4
KW = dict(image_size=SIZE, test_size=SIZE, batch_size=GLOBAL_B,
          pre_nms_top_k=64)
# the float64 knob cases: stage 1 without the locked layers' gradients,
# so the backward stops at layer 53
KNOB_KW = dict(KW, compute_dtype="float64", skip_nonfinite_updates=False)
GRAD_CASES = {"stage1": dict(KW, compute_dtype="float64"),
              "unlocked": dict(KW, compute_dtype="float64", locked_layers=())}
F32_KW = dict(KW, compute_dtype="float32", locked_layers=())
WORKER_TIMEOUT_S = 300
SEED = 41           # the weights, in every process
SAMPLE = 4096       # values of a tensor that cross processes

# the JAX loader's masks from its numpy fill (tests/test_torch_eval.py)
pytestmark = pytest.mark.usefixtures("jax_numpy_fill")


@pytest.fixture(scope="module", autouse=True)
def _few_torch_threads():
    """The suite runs several test files at once, one per process: keep
    torch's CPU thread pool small while this file runs."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module", autouse=True)
def _native_cpu_convs():
    """PyTorch's plain CPU convolutions (``tests/test_torch_train.py``
    says why)."""
    before = torch.backends.mkldnn.enabled
    torch.backends.mkldnn.enabled = False
    yield
    torch.backends.mkldnn.enabled = before


def _free_port() -> int:
    try:
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            return s.getsockname()[1]
    except OSError:
        pytest.skip("loopback sockets unavailable")


def _env():
    env = dict(os.environ, OMP_NUM_THREADS="2", PYTHONPATH=os.pathsep.join(
        filter(None, (str(ROOT), os.environ.get("PYTHONPATH")))))
    env.pop("XLA_FLAGS", None)
    return env


# ------------------------------------------------------------------ inputs

def _random_flax_layer(layer, inputs, seed):
    """Flax variables of ``layer`` with random BN affine and statistics."""
    rng = np.random.RandomState(seed)
    v = jax.tree.map(np.asarray, layer.init(jax.random.PRNGKey(seed),
                                            *inputs))
    feat = v["params"]["bn"]["scale"].shape[0]
    v["params"]["bn"]["scale"] = rng.uniform(0.5, 1.5, feat).astype(np.float32)
    v["params"]["bn"]["bias"] = rng.randn(feat).astype(np.float32)
    v["batch_stats"]["bn"]["mean"] = rng.randn(feat).astype(np.float32)
    v["batch_stats"]["bn"]["var"] = rng.uniform(0.5, 2, feat).astype(
        np.float32)
    return v


def _layer_cases():
    """(name, Flax layer, Flax variables, NHWC inputs, NHWC cotangent,
    port constructor arguments) of the two BN layers, at float32."""
    rng = np.random.RandomState(3)
    x = (rng.randn(GLOBAL_B, 12, 12, 8) * 3 + 1).astype(np.float32)
    skip = (rng.randn(GLOBAL_B, 12, 12, 6) * 2 - 1).astype(np.float32)
    small = rng.randn(GLOBAL_B, 6, 6, 10).astype(np.float32)
    cases = []
    conv = jax_layers.ConvBN(features=16, kernel=3, dtype=jnp.float32,
                             bn_axis="dp")
    cases.append(("convbn", conv, _random_flax_layer(conv, (x[:1],), 4),
                  (x,), rng.randn(GLOBAL_B, 12, 12, 16).astype(np.float32),
                  ("convbn", 8, 16)))
    com = jax_layers.CommutedConcatConvBN(features=12, cin=16,
                                          dtype=jnp.float32, bn_axis="dp")
    cases.append(("commuted", com,
                  _random_flax_layer(com, (skip[:1], small[:1]), 5),
                  (skip, small),
                  rng.randn(GLOBAL_B, 12, 12, 12).astype(np.float32),
                  ("commuted", 16, 12)))
    return cases


def _port_layer(args, dtype):
    kind, cin, feat = args
    if kind == "convbn":
        return ConvBN(cin, feat, 3, 1, dtype=dtype)
    return CommutedConcatConvBN(cin, feat, dtype=dtype)


def _layer_state(v):
    sd = state_dict_from_flax({"params": {"convolutional1": v["params"]},
                               "batch_stats": {"convolutional1":
                                               v["batch_stats"]}})
    return {k.split(".", 1)[1]: t for k, t in sd.items()}


def _run_layer(args, sd, inputs, cot, dtype, mesh=None):
    """A train-mode port layer on NHWC numpy ``inputs`` with the loss
    sum(y * cot): (y NHWC, running mean, running var, input gradients,
    parameter gradients), as float64 numpy."""
    layer = _port_layer(args, dtype)
    layer.load_state_dict(sd)
    layer.to(dtype).train()
    xs = [torch.from_numpy(x).to(dtype).permute(0, 3, 1, 2).requires_grad_()
          for x in inputs]
    with sync_batch_norm(layer, mesh):
        y = layer(*xs)
        loss = (y * torch.from_numpy(cot).to(dtype).permute(0, 3, 1, 2)).sum()
        names = [n for n, _ in layer.named_parameters()]
        grads = torch.autograd.grad(loss, xs + list(layer.parameters()))
    as_np = lambda t: t.detach().double().numpy()
    return dict(y=as_np(y.permute(0, 2, 3, 1)), mean=as_np(layer.bn.running_mean),
                var=as_np(layer.bn.running_var),
                dx=[as_np(g.permute(0, 2, 3, 1)) for g in grads[:len(xs)]],
                dw={n: as_np(g) for n, g in zip(names, grads[len(xs):])})


def _model(kw, dtype):
    """The port's model at ``kw``, initialized from ``SEED`` (the same
    weights in every process), in ``dtype``."""
    return api.init_model(DISYoloConfig(**kw), SEED, device="cpu").to(dtype)


def _spy_grads(store):
    real = ts.adam_apply

    def spy(state, params, grads, cfg):
        store.clear()
        store.update({k: v.detach().clone() for k, v in grads.items()})
        return real(state, params, grads, cfg)
    return mock.patch.object(ts, "adam_apply", spy)


def _rows(batch, mesh):
    return batch if mesh is None else sharding.shard_batch(mesh, batch)


def _summary(tensors):
    """Each tensor as float64 numpy: whole up to ``SAMPLE`` values, else
    ``SAMPLE`` values at fixed random positions, with its L2 norm (the
    results of a 62 M-parameter model cross processes this way)."""
    out = {}
    for k, v in tensors.items():
        flat = v.detach().double().reshape(-1)
        n = flat.numel()
        if n > SAMPLE:
            pos = np.random.RandomState(n % 2**31).randint(0, n, SAMPLE)
            flat_s = flat[torch.from_numpy(pos)]
        else:
            flat_s = flat
        out[k] = (flat_s.numpy(), float(torch.linalg.vector_norm(flat)))
    return out


def close_summary(got, want, tol, msg):
    assert set(got) == set(want), msg
    for k, (w, norm) in want.items():
        close(got[k][0], w, tol, f"{msg} {k}")
        assert abs(got[k][1] - norm) <= tol * max(1.0, norm), (msg, k)


def _grad_step(kw, batch, mesh=None):
    """One float64 step: (gradients taken, metrics, state_dict after),
    summarized."""
    model = _model(kw, torch.float64)
    grads = {}
    with _spy_grads(grads):
        state = ts.init_train_state(model, device="cpu", mesh=mesh)
        step = ts.make_train_step(model, device="cpu", mesh=mesh)
        _, m = step(state, _rows(batch, mesh), torch.Generator().manual_seed(1))
    return (_summary(grads), {k: float(v) for k, v in m.items()},
            _summary(model.state_dict()))


def _permuted_draws(perm):
    """``draw_uniforms`` with its rows reordered by ``perm``."""
    real = ts.draw_uniforms

    def draw(gen, b, d, t, dev):
        return tuple(u[perm] for u in real(gen, b, d, t, dev))
    return mock.patch.object(ts, "draw_uniforms", draw)


def _knob_case(spec, case, mesh=None):
    """grad_accum=2, a K=2 block or a K=2 corpus block, float64, on the
    mesh or on one process.  Returns (gradients of the last step,
    metrics, state_dict after), summarized."""
    kw = dict(KNOB_KW)
    batches = spec["batches"]
    if case == "corpus":
        kw.update(dataset=spec["root"], device_side_augs=True)
    if case == "grad_accum":
        kw.update(grad_accum=2)
    model = _model(kw, torch.float64)
    grads = {}
    gen = torch.Generator().manual_seed(1)
    with _spy_grads(grads):
        state = ts.init_train_state(model, device="cpu", mesh=mesh)
        if case == "grad_accum":
            step = ts.make_train_step(model, device="cpu", mesh=mesh)
            batch = batches[0]
            if mesh is None:
                # microbatch i of a mesh step is every rank's i-th
                # microbatch: rows 0, 2 then 1, 3 of the global batch
                perm = [0, 2, 1, 3]
                with _permuted_draws(perm):
                    _, m = step(state, {k: v[perm] for k, v in batch.items()},
                                gen)
            else:
                _, m = step(state, _rows(batch, mesh), gen)
        else:
            if case == "block":
                block = {k: np.stack([b[k] for b in batches[:2]])
                         for k in batches[0]}
                multi = ts.make_multi_step(model, device="cpu", mesh=mesh)
                run = lambda blk: multi(state, blk, gen)
            else:
                corpus = upload_corpus(CorpusTrainData(
                    DISYoloConfig(**kw), "train", seed=3).corpus, "cpu")
                block = spec["decisions"]
                multi = ts.make_corpus_multi_step(model, device="cpu",
                                                  mesh=mesh)
                aug = torch.Generator().manual_seed(4)
                run = lambda blk: multi(state, corpus, blk, gen, aug)
            if mesh is not None:
                block = sharding.shard_stacked(mesh, block)
            else:
                block = {k: torch.as_tensor(v) for k, v in block.items()}
            _, m = run(block)
    return (_summary(grads), {k: v.double().numpy() for k, v in m.items()},
            _summary(model.state_dict()))


def _digest(t: torch.Tensor) -> str:
    return hashlib.sha256(t.detach().contiguous().numpy().tobytes()).hexdigest()


# ----------------------------------------------------------------- worker

def _worker(spec_path: str, rank: int) -> None:
    """One rank of the gloo spawn: every DP check's rank-side run, its
    results to ``out_<rank>.pt``."""
    torch.set_num_threads(2)
    torch.backends.mkldnn.enabled = False
    spec = torch.load(spec_path, weights_only=False)
    distributed.initialize("cpu", init_method=spec["init"], world_size=2,
                           rank=rank)
    mesh = sharding.make_mesh("cpu")
    out = {}
    t0 = time.perf_counter()
    try:
        # (a) the sync layers, float64 and float32
        out["layers"] = {
            (name, str(dt)): _run_layer(
                args, _layer_state(v), [x[mesh.rows(GLOBAL_B)] for x in xs],
                cot[mesh.rows(GLOBAL_B)], dt, mesh)
            for name, v, xs, cot, args in spec["layer_cases"]
            for dt in (torch.float64, torch.float32)}
        # replicated values checked equal; local rows on the rank's device
        same = distributed.replicate_to_global(mesh, {"w": torch.arange(3.0)})
        try:
            distributed.replicate_to_global(
                mesh, {"w": torch.full((3,), float(rank))})
            differs = None
        except ValueError as e:
            differs = str(e)
        local = distributed.host_local_to_global(
            mesh, {"x": np.full((2, 3), rank)})
        out["placement"] = dict(same=same["w"].tolist(), differs=differs,
                                local=local["x"].tolist())
        _mark(t0, '# (b)')
        # (b) float64 gradients
        out["grads"] = {tag: _grad_step(kw, spec["batches"][0], mesh)
                        for tag, kw in GRAD_CASES.items()}
        _mark(t0, '# (b, c)')
        # (b, c) float32 with JAX's uniforms: step 1, then two more
        model = _model(F32_KW, torch.float32)
        state = ts.init_train_state(model, device="cpu", mesh=mesh)
        step = ts.make_train_step(model, device="cpu", mesh=mesh)
        u = [torch.from_numpy(x) for x in spec["jax_uniforms"]]
        with mock.patch.object(ts, "draw_uniforms", lambda *a: tuple(u)):
            _, m = step(state, _rows(spec["batches"][0], mesh),
                        torch.Generator())
        out["f32_step1"] = {k: float(v) for k, v in m.items()}
        out["f32_params1"] = _summary(dict(model.named_parameters()))
        gen = torch.Generator().manual_seed(2)
        for batch in spec["batches"][1:]:
            step(state, _rows(batch, mesh), gen)
        out["f32_digest3"] = {
            "state": {k: _digest(v) for k, v in model.state_dict().items()},
            "mu": {k: _digest(v) for k, v in state.opt.mu.items()},
            "nu": {k: _digest(v) for k, v in state.opt.nu.items()},
            "count": state.opt.count, "step": state.step}
        # (c') three bf16 steps of the default config
        out["bf16_losses"], out["bf16_params1"] = _bf16_losses(
            spec["batches"], mesh)
        _mark(t0, '# (d)')
        # (d) grad_accum, a K=2 block, a K=2 corpus block
        out["knobs"] = {case: _knob_case(spec, case, mesh)
                        for case in ("grad_accum", "block", "corpus")}
        _mark(t0, '# (e)')
        # (e) the DP predict and sweep, from the seed weights
        model = _model(F32_KW, torch.float32)
        dets, masks = api.predict(model, spec["images"][:GLOBAL_B],
                                  spec["windows"][:GLOBAL_B], 1e-3,
                                  mesh=mesh)
        out["predict"] = (dets.numpy(), masks.numpy())
        out["sweep"] = {route: run_split(
            model.cfg, model, spec["images"], spec["names"], spec["windows"],
            mesh=mesh, device="cpu", device_paste=route == "device_paste",
            gt_sizes=spec["gt_sizes"])[0]
            for route in ("host", "device_paste")}
        _mark(t0, '# (f)')
        # (f) rank 0 writes the checkpoint, both restore it
        out["ckpt"] = _ckpt_case(spec, mesh)
    except BaseException:
        traceback.print_exc()
        raise
    finally:
        distributed.shutdown()
    torch.save(out, spec["out"].format(rank))
    _mark(t0, "end")
    print(f"worker {rank} OK", flush=True)


def _mark(t0, tag):
    """Seconds since ``t0`` at the start of a part, to the rank's log."""
    print(f"{tag} at {time.perf_counter() - t0:.1f} s", flush=True)


def _ckpt_case(spec, mesh):
    kw = dict(KW, compute_dtype="float32", skip_nonfinite_updates=False)
    model = _model(kw, torch.float32)
    state = ts.init_train_state(model, device="cpu", mesh=mesh)
    step = ts.make_train_step(model, device="cpu", mesh=mesh)
    gen = torch.Generator().manual_seed(5)
    step(state, _rows(spec["batches"][0], mesh), gen)
    writes = []
    real = ckpt._write

    def count(*a):
        writes.append(a[1])
        return real(*a)
    with mock.patch.object(ckpt, "_write", count):
        path = ckpt.save_checkpoint_background(spec["ckpt_dir"], state, 1)
    here = os.path.isdir(path)
    fresh = _model(kw, torch.float32)
    restored = ts.init_train_state(fresh, device="cpu", mesh=mesh)
    ckpt.restore_checkpoint(path, restored)
    same = (all(torch.equal(a, b) for a, b in zip(
        model.state_dict().values(), fresh.state_dict().values()))
        and all(torch.equal(state.opt.mu[k], restored.opt.mu[k])
                and torch.equal(state.opt.nu[k], restored.opt.nu[k])
                for k in state.opt.mu)
        and (restored.step, restored.opt.count) == (1, 1))
    step2 = ts.make_train_step(fresh, device="cpu", mesh=mesh)
    _, m = step2(restored, _rows(spec["batches"][1], mesh), gen)
    return dict(writes=writes, dir_seen=here, restored_equal=same,
                post_restore_loss=float(m["total_loss"]))


# --------------------------------------------------------- the spawn

class _Spawn:
    """The ranks started by ``dp_run`` (``tests/test_torch_spatial.py``'s
    too); ``result()`` waits for them (once: ``timeout_s`` in all, then
    it kills them, so ranks stuck in a collective fail the test) and
    returns their outputs by rank."""

    def __init__(self, spec, procs, logs, timeout_s=WORKER_TIMEOUT_S):
        self.spec, self.procs, self.logs = spec, procs, logs
        self.timeout_s = timeout_s
        self._outs = None

    def result(self):
        if self._outs is None:
            deadline = time.monotonic() + self.timeout_s
            for p in self.procs:
                try:
                    p.wait(timeout=max(0.0, deadline - time.monotonic()))
                except subprocess.TimeoutExpired:
                    pass
            self.kill()
            for rank, p in enumerate(self.procs):
                log = Path(self.logs[rank]).read_text()
                assert p.returncode == 0 and f"worker {rank} OK" in log, \
                    f"rank {rank} failed (rc {p.returncode}):\n{log[-4000:]}"
            self._outs = [torch.load(self.spec["out"].format(r),
                                     weights_only=False)
                          for r in range(len(self.procs))]
            print(Path(self.logs[0]).read_text())     # the parts' times
        return self._outs

    def kill(self):
        for p in self.procs:
            if p.poll() is None:
                p.kill()
                p.wait()


@pytest.fixture(scope="module")
def split(tmp_path_factory):
    """The JAX package's synthetic split: 4 train and 2 val images."""
    pytest.importorskip("cv2")
    from dis_yolo_tpu.data.preprocess import build_ground_truth_cache
    from dis_yolo_tpu.data.synthetic import generate_dataset
    root = str(tmp_path_factory.mktemp("dpdata"))
    generate_dataset(root, phases=("train", "val"), images_per_phase=4,
                     image_size=96, seed=0)
    for phase in ("train", "val"):
        build_ground_truth_cache(root, phase)
    return root


@pytest.fixture(scope="module")
def dp_run(split, tmp_path_factory):
    """The inputs, and the two gloo ranks started on them: they run while
    the tests compute their one-process and JAX references."""
    from tests.test_torch_train import jax_uniforms
    tmp = tmp_path_factory.mktemp("dp")
    cfg = DISYoloConfig(**F32_KW)
    keys = jax.random.split(jax.random.PRNGKey(7), GLOBAL_B)
    rng = np.random.RandomState(9)
    ccfg = DISYoloConfig(**dict(KW, dataset=split, device_side_augs=True))
    decisions = CorpusTrainData(ccfg, "train", seed=3)
    dec = [decisions._make_batch() for _ in range(2)]
    spec = dict(
        init=f"tcp://127.0.0.1:{_free_port()}", root=split,
        out=str(tmp / "out_{}.pt"), ckpt_dir=str(tmp / "ckpt"),
        batches=[synthetic_batch(cfg, GLOBAL_B, 3, seed=s) for s in (5, 6, 7)],
        keys=np.asarray(keys),
        jax_uniforms=jax_uniforms(keys, cfg.max_detection,
                                  cfg.max_box_per_image),
        decisions={k: np.stack([d[k] for d in dec]) for k in dec[0]},
        images=rng.rand(5, SIZE, SIZE, 3).astype(np.float32),
        windows=np.tile(np.array([[0.0, 0.0, 1.0, 1.0]], np.float32), (5, 1)),
        names=[f"im{i}" for i in range(5)],
        layer_cases=[(name, v, xs, cot, args)
                     for name, _, v, xs, cot, args in _layer_cases()],
        gt_sizes={f"im{i}": (80, 96) for i in range(5)})
    spec_path = str(tmp / "spec.pt")
    torch.save(spec, spec_path)
    code = ("import sys; from tests.test_torch_parallel import _worker; "
            "_worker(sys.argv[1], int(sys.argv[2]))")
    logs = [str(tmp / f"rank{r}.log") for r in (0, 1)]
    procs = []
    for r in (0, 1):
        with open(logs[r], "w") as log:
            procs.append(subprocess.Popen(
                [sys.executable, "-c", code, spec_path, str(r)], cwd=ROOT,
                env=_env(), stdout=log, stderr=subprocess.STDOUT))
    run = _Spawn(spec, procs, logs)
    # (g)'s training run starts beside the ranks
    out = tmp / "cli"
    run.cli_train = (subprocess.Popen(
        _torchrun_cmd(["train", "--data-parallel", "--output-dir", str(out),
                       "--max-iter", "2", "--save-iter", "2",
                       "--summary-iter", "1"] + _cli_common(split)),
        cwd=ROOT, env=_env(), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True), out)
    yield run
    run.kill()
    if run.cli_train[0].poll() is None:
        run.cli_train[0].kill()
        run.cli_train[0].communicate()
    shutil.rmtree(tmp, ignore_errors=True)


def _torchrun_cmd(args):
    """``python -m dis_yolo_tpu_torch.cli ARGS`` on two ranks under
    ``torch.distributed.run``."""
    return [sys.executable, "-m", "torch.distributed.run", "--nnodes", "1",
            "--nproc-per-node", "2", "--master-addr", "127.0.0.1",
            "--master-port", str(_free_port()), "-m",
            "dis_yolo_tpu_torch.cli", *args]


def _cli_common(split):
    return ["--device", "cpu", "--dataset", split, "--image-size", str(SIZE),
            "--batch-size", "2"]


@pytest.fixture(scope="module")
def refs(dp_run):
    """Every one-process and JAX reference, computed while the ranks
    work."""
    spec = dp_run.spec
    return dict(
        layers={name: (_run_layer(args, _layer_state(v), xs, cot,
                                  torch.float64),
                       _flax_sync_layer(layer, v, xs, cot))
                for name, layer, v, xs, cot, args in _layer_cases()},
        grads={case: _grad_step(kw, spec["batches"][0])
               for case, kw in GRAD_CASES.items()},
        knobs={case: _knob_case(spec, case)
               for case in ("grad_accum", "block", "corpus")},
        serving=_one_process_serving(spec),
        jax_mesh_step=_jax_mesh_step(spec)[:2],
        bf16_drift=_bf16_drift(spec))


def close(got, want, tol, msg=""):
    want = np.asarray(want, np.float64)
    np.testing.assert_allclose(
        np.asarray(got, np.float64), want, rtol=0,
        atol=tol * max(1.0, float(np.abs(want).max())), err_msg=msg)


# ------------------------------------------------------------------ tests

def test_parallel_train_data_host_shard_matches_unsharded_and_jax(split,
                                                                 dp_run):
    """``ParallelTrainData(host_shard=(p, 2))``: the two processes'
    batches concatenated in process order equal the unsharded stream bit
    for bit, and JAX's (``tests/test_torch_data.py``'s tolerances: images
    within 1 LSB, the rest exact).  No process of its own: it runs while
    ``dp_run``'s ranks work."""
    from tests.test_torch_data import _check_batch
    kw = dict(dataset=split, image_size=SIZE, batch_size=GLOBAL_B)
    shards = [dataset.ParallelTrainData(DISYoloConfig(**kw), seed=3,
                                        workers=0, host_shard=(p, 2))
              for p in (0, 1)]
    whole = dataset.ParallelTrainData(DISYoloConfig(**kw), seed=3, workers=0)
    ref = jax_dataset.ParallelTrainData(JaxConfig(**kw), seed=3, workers=0)
    jshards = [jax_dataset.ParallelTrainData(JaxConfig(**kw), seed=3,
                                             workers=0, host_shard=(p, 2))
               for p in (0, 1)]
    for _ in range(3):      # crosses an epoch (4 images, 4 per batch)
        parts = [s.get() for s in shards]
        want = whole.get()
        assert parts[0]["images"].shape[0] == GLOBAL_B // 2
        for key in want:
            np.testing.assert_array_equal(
                np.concatenate([p[key] for p in parts]), want[key],
                err_msg=key)
        _check_batch(want, ref.get())
        for part, jshard in zip(parts, jshards):
            _check_batch(part, jshard.get())
    assert whole.epoch == ref.epoch
    assert [s.epoch for s in shards] == [s.epoch for s in jshards]


def test_plans_and_one_process_mesh(dp_run):
    """The placement math, the backend choice, and a mesh without a
    process group: one process, whose step equals the step without a
    mesh bit for bit (the collectives are identities).  It runs while
    ``dp_run``'s ranks work."""
    assert distributed.assembly_plan(1, 2, (3, 5)) == ((6, 5), (3, 6))
    assert distributed.per_host_batch_size(4) == 4
    assert distributed.choose_backend("cuda", 2, 2) == "nccl"
    assert distributed.choose_backend("cuda", 2, 1) == "gloo"
    assert distributed.choose_backend("cpu", 2, 0) == "gloo"
    assert distributed.initialize("cpu") is None    # WORLD_SIZE unset
    mesh = sharding.make_mesh("cpu")
    assert (mesh.rank, mesh.size, mesh.axis_name) == (0, 1, "dp")
    assert sharding.Mesh(None, 1, 2, torch.device("cpu")).rows(4) == slice(2, 4)
    with pytest.raises(ValueError, match="divisible"):
        sharding.Mesh(None, 0, 2, torch.device("cpu")).rows(3)
    kw = dict(KW, compute_dtype="float32", skip_nonfinite_updates=False)
    batch = synthetic_batch(DISYoloConfig(**kw), 2, 2, seed=1)
    results = []
    for m in (None, mesh):
        model = _model(kw, torch.float32)
        state = ts.init_train_state(model, device="cpu", mesh=m)
        step = ts.make_train_step(model, device="cpu", mesh=m)
        _, metrics = step(state, batch, torch.Generator().manual_seed(3))
        results.append((metrics, model.state_dict()))
    (m0, s0), (m1, s1) = results
    assert all(torch.equal(m0[k], m1[k]) for k in m0)
    assert all(torch.equal(s0[k], s1[k]) for k in s0)
    # sync-BN needs the mesh whose axis it names
    with pytest.raises(ValueError, match="bn_axis"):
        DISYoloConfig(**kw, bn_axis="dp").check_trainable()
    with pytest.raises(ValueError, match="bn_axis"):
        DISYoloConfig(**kw, bn_axis="sp").check_trainable(mesh)
    DISYoloConfig(**kw, bn_axis="dp").check_trainable(mesh)


def _jax_mesh_step(spec, kw=F32_KW, steps=1, devices=2):
    """JAX's train step on ``devices`` of the 8 virtual devices (1: the
    one-device step) from the port's seed weights at ``kw``, ``steps``
    steps on the spec's batches, the keys PRNGKey(7), (8), ...:
    (metrics of the first step, summarized parameters after it, the
    total loss of every step)."""
    jcfg = JaxConfig(**kw)
    model = jax_api.create_model(jcfg)
    v = flax_from_state_dict(_model(kw, torch.float32).state_dict())
    tx = jax_ts.make_optimizer(v["params"], jcfg)
    st = jax_ts.TrainState(v["params"], v["batch_stats"],
                           tx.init(v["params"]), jnp.asarray(0))
    mesh = JaxMesh(np.asarray(jax.devices()[:devices]), ("dp",)) \
        if devices > 1 else None
    step = jax_ts.make_jitted_train_step(model, tx, mesh=mesh)
    if mesh is not None:
        st = jax_sharding.replicate(mesh, st)
    losses = []
    for i, batch in enumerate(spec["batches"][:steps]):
        st, metrics = step(st, batch if mesh is None else
                           jax_sharding.shard_batch(mesh, batch),
                           jax.random.PRNGKey(7 + i))
        losses.append(float(metrics["total_loss"]))
        if i == 0:
            want = {k: float(v) for k, v in metrics.items()}
            want_p = _summary({k: torch.from_numpy(np.asarray(t)) for k, t in
                               state_dict_from_flax(jax.tree.map(np.asarray, {
                                   "params": st.params,
                                   "batch_stats": st.batch_stats})).items()
                               if not k.endswith(("running_mean", "running_var",
                                                  "num_batches_tracked"))})
    return want, want_p, losses


def _bf16_losses(batches, mesh=None):
    """The port's total loss over three steps of the bf16 default config
    (stage 1), one step per batch, on the mesh (this rank's rows) or in
    one process: (the losses, summarized parameters after step 1)."""
    model = _model(KW, torch.float32)
    state = ts.init_train_state(model, device="cpu", mesh=mesh)
    step = ts.make_train_step(model, device="cpu", mesh=mesh)
    gen = torch.Generator().manual_seed(2)
    losses = []
    for b in batches:
        losses.append(float(step(state, _rows(b, mesh), gen)[1]["total_loss"]))
        if len(losses) == 1:
            params1 = _summary(dict(model.named_parameters()))
    return losses, params1


def _bf16_drift(spec):
    """Step 0's references: the port in one process, JAX on one device
    and on 2 of the 8 virtual devices, three bf16 steps each: the losses
    and the parameters after step 1."""
    (jax_one_p, jax_one), (jax_mesh_p, jax_mesh) = (
        _jax_mesh_step(spec, KW, 3, n)[1:] for n in (1, 2))
    port_one, port_one_p = _bf16_losses(spec["batches"])
    return dict(port_one=port_one, port_one_p=port_one_p, jax_one=jax_one,
                jax_one_p=jax_one_p, jax_mesh=jax_mesh, jax_mesh_p=jax_mesh_p)


def _n_apart(got, want, tol=1e-6):
    """Sampled parameter values of two summaries further apart than
    ``tol``."""
    return sum(int((np.abs(got[k][0] - w) > tol).sum())
               for k, (w, _) in want.items())


def test_dp_step_float32_matches_jax_mesh_step(dp_run, refs):
    """(b) float32, nothing locked: the DP step's loss and parameters
    against JAX's mesh step on 2 of the 8 virtual devices, on the same
    weights, global batch and per-image uniforms."""
    want, want_p = refs["jax_mesh_step"]
    outs = dp_run.result()
    for r in (0, 1):
        got = outs[r]["f32_step1"]
        for name, w in want.items():
            np.testing.assert_allclose(got[name], w, rtol=1e-3,
                                       err_msg=f"rank {r} {name}")
        got_p = outs[r]["f32_params1"]
        assert set(got_p) == set(want_p)
        for key, (w, _) in want_p.items():
            np.testing.assert_allclose(got_p[key][0], w, rtol=5e-2,
                                       atol=3e-3, err_msg=key)


def test_bf16_dp_drift_no_worse_than_jax(dp_run, refs):
    """(c') The bf16 default config (stage 1), three steps at global
    batch 4: the port's two ranks against its one process, beside JAX's
    mesh step on 2 virtual devices against its one device, on the same
    batches and seed weights.  Both packages drift from one process by
    rounding (bf16 convs on each device's rows, BN moments averaged in
    another order), and the port's drift is a fault only where it drifts
    and JAX does not:
      * step 1, from the same state: the port's relative loss gap is at
        most 2x JAX's + 1e-3;
      * after step 1: the port's parameters are no further from its one
        process than JAX's from its one device (sampled values more than
        1e-6 apart: Adam's first update is lr * sign(g) where |g| >> 1e-8,
        so every gradient whose sign the rounding flips moves by 2 lr);
      * steps 1-3: the port's largest gap is at most 2x JAX's largest +
        1e-3.  From step 2 on the states differ by those flips, and each
        step's gap swings with them (the wh loss through exp): gap by gap
        the port is ahead at steps 1 and 3 and behind at step 2, so the
        steps are held together."""
    ref = refs["bf16_drift"]
    gap = lambda got, want: [abs(g - w) / abs(w) for g, w in zip(got, want)]
    jax_gap = gap(ref["jax_mesh"], ref["jax_one"])
    jax_apart = _n_apart(ref["jax_mesh_p"], ref["jax_one_p"])
    for r, out in enumerate(dp_run.result()):
        port_gap = gap(out["bf16_losses"], ref["port_one"])
        port_apart = _n_apart(out["bf16_params1"], ref["port_one_p"])
        print(f"rank {r}: loss gaps port {port_gap}, JAX {jax_gap}; "
              f"sampled parameters apart after step 1: port {port_apart}, "
              f"JAX {jax_apart}")
        assert len(port_gap) == len(jax_gap) == 3
        assert port_gap[0] <= 2 * jax_gap[0] + 1e-3, (r, port_gap, jax_gap)
        assert port_apart <= jax_apart, (r, port_apart, jax_apart)
        assert max(port_gap) <= 2 * max(jax_gap) + 1e-3, (r, port_gap,
                                                          jax_gap)


def test_placement_across_ranks(dp_run):
    """``replicate_to_global`` passes values equal on every rank and
    raises on the rank whose value differs from rank 0's;
    ``host_local_to_global`` keeps each rank's rows on it."""
    a, b = (o["placement"] for o in dp_run.result())
    assert a["same"] == b["same"] == [0.0, 1.0, 2.0]
    assert a["differs"] is None and "rank 1" in b["differs"]
    assert a["local"] == [[0] * 3] * 2 and b["local"] == [[1] * 3] * 2


def _flax_sync_layer(layer, v, inputs, cot):
    """The Flax layer in train mode under ``shard_map`` over 2 virtual
    devices, ``check_vma=False`` as the JAX package's mesh step: (y,
    new statistics, input gradients, per-device parameter gradients
    summed) of the loss sum(y * cot) on each device's rows."""
    mesh = JaxMesh(np.asarray(jax.devices()[:2]), ("dp",))
    n_in = len(inputs)

    def local(params, stats, *args):
        xs, c = args[:n_in], args[n_in]

        def loss(p, *x):
            y, new = layer.apply({"params": p, "batch_stats": stats}, *x,
                                 train=True, mutable=["batch_stats"])
            return jnp.sum(y * c), (y, new["batch_stats"])
        (_, (y, new)), grads = jax.value_and_grad(
            loss, argnums=tuple(range(n_in + 1)), has_aux=True)(params, *xs)
        gp = jax.tree.map(lambda g: g[None], grads[0])
        return y, new, list(grads[1:]), gp

    spec = P("dp")
    run = jax.jit(jax.shard_map(
        local, mesh=mesh, in_specs=(P(), P()) + (spec,) * (n_in + 1),
        out_specs=(spec, P(), [spec] * n_in, spec), check_vma=False))
    y, new, dx, gp = run(v["params"], v["batch_stats"], *inputs, cot)
    return dict(y=np.asarray(y), mean=np.asarray(new["bn"]["mean"]),
                var=np.asarray(new["bn"]["var"]),
                dx=[np.asarray(g) for g in dx],
                dw=jax.tree.map(lambda g: np.asarray(g).sum(0), gp))


def test_sync_bn_layers_match_one_process_and_flax(dp_run, refs):
    """(a) Sync ConvBN and train-mode CommutedConcatConvBN on two ranks:
    output, running statistics, input gradients (each rank's rows) and
    parameter gradients (summed over the ranks) equal the one-process
    layer on the global batch in float64, and Flax's sync BatchNorm in
    float32."""
    outs = dp_run.result()
    for name, (one, flax) in refs["layers"].items():
        for dt, tol, want in (("torch.float64", 1e-12, one),
                              ("torch.float32", 1e-5, flax)):
            got = [o["layers"][(name, dt)] for o in outs]
            msg = f"{name} {dt}"
            close(np.concatenate([g["y"] for g in got]), want["y"], tol, msg)
            for i, dx in enumerate(want["dx"]):
                close(np.concatenate([g["dx"][i] for g in got]), dx, tol,
                      f"{msg} dx{i}")
            for g in got:
                close(g["mean"], want["mean"], tol, f"{msg} mean")
                close(g["var"], want["var"], tol, f"{msg} var")
            dw = {k: got[0]["dw"][k] + got[1]["dw"][k] for k in got[0]["dw"]}
            if dt == "torch.float64":
                for k, w in want["dw"].items():
                    close(dw[k], w, tol, f"{msg} {k}")
            else:
                close(dw["bn.weight"], want["dw"]["bn"]["scale"], tol, msg)
                close(dw["bn.bias"], want["dw"]["bn"]["bias"], tol, msg)
                kernel = want["dw"]["conv"]["kernel"].transpose(3, 2, 0, 1)
                close(dw["conv.weight"], kernel, tol, f"{msg} kernel")


@pytest.mark.parametrize("case", list(GRAD_CASES))
def test_dp_step_float64_grads_equal_one_process(dp_run, refs, case):
    """(b) float64: the DP step's gradients (all-reduced, the ones the
    finite check and Adam see), metrics and BN statistics equal the
    one-process step on the global batch within 1e-9, on both ranks;
    the parameters after Adam within 1e-8."""
    _check_against(dp_run.result(), "grads", case, *refs["grads"][case])


def _check_against(outs, key, case, grads, metrics, sd):
    """Both ranks' summarized run of ``case`` against the one-process
    summaries: gradients, metrics and BN statistics within 1e-9, the
    other state within 1e-8."""
    for r, out in enumerate(outs):
        g, m, s = out[key][case]
        close_summary(g, grads, 1e-9, f"rank {r} grad")
        for k, w in metrics.items():
            close(m[k], w, 1e-9, f"rank {r} {k}")
        close_summary({k: v for k, v in s.items() if "running" in k},
                      {k: v for k, v in sd.items() if "running" in k}, 1e-9,
                      f"rank {r} statistics")
        close_summary(s, sd, 1e-8, f"rank {r}")


def test_replicas_bit_equal_after_three_steps(dp_run):
    """(c) Three float32 steps: both ranks hold bit-equal parameters, BN
    statistics and Adam moments."""
    a, b = (o["f32_digest3"] for o in dp_run.result())
    assert a["step"] == b["step"] == 3 and a["count"] == 3
    assert a == b


@pytest.mark.parametrize("case", ["grad_accum", "block", "corpus"])
def test_dp_knobs_equal_one_process(dp_run, refs, case):
    """(d) float64 with the mesh: ``grad_accum=2`` (against one process
    whose microbatches are the ranks' i-th microbatches: rows 0, 2 and
    1, 3), a K=2 block and a K=2 corpus block (each rank assembles its
    rows of the same decisions, with the global batch's augmentation
    draws) equal their one-process runs: the last step's gradients,
    the metrics and BN statistics within 1e-9, parameters within 1e-8."""
    _check_against(dp_run.result(), "knobs", case, *refs["knobs"][case])


def _one_process_serving(spec):
    """The seed model's predict of the first global batch and its sweeps
    of the 5 images by the host and device_paste routes, one process."""
    model = _model(F32_KW, torch.float32)
    dets, masks = api.predict(model, spec["images"][:GLOBAL_B],
                              spec["windows"][:GLOBAL_B], 1e-3, device="cpu")
    cfg = DISYoloConfig(**F32_KW)
    return (dets, masks), {route: run_split(
        cfg, model, spec["images"], spec["names"], spec["windows"],
        device="cpu", device_paste=route == "device_paste",
        gt_sizes=spec["gt_sizes"])[0] for route in ("host", "device_paste")}


def test_dp_predict_and_sweep_equal_one_process(dp_run, refs):
    """(e) The DP predict (each rank its rows) and ``run_split(mesh)``
    on 5 images (a tail batch; the detdata gathered in image order) by
    the host and ``device_paste`` routes equal one process's."""
    spec = dp_run.spec
    outs = dp_run.result()
    (dets, masks), sweeps = refs["serving"]
    got_d = np.concatenate([o["predict"][0] for o in outs])
    got_m = np.concatenate([o["predict"][1] for o in outs])
    assert (got_d[..., 5] > 0).sum() > 10
    np.testing.assert_allclose(got_d, dets.numpy(), rtol=0, atol=1e-5)
    np.testing.assert_allclose(got_m, masks.numpy(), rtol=0, atol=1e-5)
    for route, want in sweeps.items():
        for out in outs:
            got = out["sweep"][route]
            assert [d["imname"] for d in got] == spec["names"]
            for g, w in zip(got, want):
                assert set(g) == set(w)
                for key in w:
                    if key == "imname":
                        continue
                    np.testing.assert_allclose(
                        g[key].astype(np.float64), w[key].astype(np.float64),
                        rtol=0, atol=1e-5, err_msg=f"{route} {key}")


def test_dp_checkpoint_rank0_writes_every_rank_restores(dp_run):
    """(f) A checkpoint of the DP state: rank 0 alone writes it, both
    ranks find it on return, restore it bit-equal and take a finite
    step from it."""
    a, b = (o["ckpt"] for o in dp_run.result())
    assert a["writes"] == [1] and b["writes"] == []
    for out in (a, b):
        assert out["dir_seen"] and out["restored_equal"]
        assert np.isfinite(out["post_restore_loss"])
    assert a["post_restore_loss"] == b["post_restore_loss"]


def test_cli_train_and_eval_data_parallel_under_torchrun(dp_run, split,
                                                         capsys):
    """(g) ``cli train --data-parallel --device cpu`` under
    ``torch.distributed.run``, two ranks, 2 steps with a validation:
    each rank joins over gloo, rank 0 alone writes the metrics and the
    checkpoint, and the run ends cleanly.  Then ``cli eval
    --data-parallel`` of that checkpoint: one result line, rank 0's,
    equal to one process's ``cli eval``."""
    train, out = dp_run.cli_train
    common = _cli_common(split)
    try:
        log, _ = train.communicate(timeout=WORKER_TIMEOUT_S)
        assert train.returncode == 0, log[-4000:]
        for r in (0, 1):
            assert f"rank {r} of 2, backend gloo" in log, log[-4000:]
        ck = out / "checkpoint"
        assert (ck / "step_00000002" / "state").is_file()
        rows = (ck / "train_metrics.jsonl").read_text().splitlines()
        assert sum('"kind": "train"' in r for r in rows) == 2, rows
        assert sum('"kind": "val"' in r for r in rows) == 1, rows
        assert "mAP50" in log
        ev = ["eval", "--phase", "val", "--checkpoint",
              str(ck / "step_00000002")] + common
        proc = subprocess.run(_torchrun_cmd(ev + ["--data-parallel"]),
                              cwd=ROOT, env=_env(), capture_output=True,
                              text=True, timeout=WORKER_TIMEOUT_S)
        assert proc.returncode == 0, (proc.stdout + proc.stderr)[-4000:]
        got = [json.loads(x) for x in proc.stdout.splitlines()
               if x.startswith("{")]
        capsys.readouterr()
        with torch.backends.mkldnn.flags(enabled=True):     # as the ranks
            cli.main(ev)
        want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert len(got) == 1
        for key in ("AP", "mAP", "recall", "precision", "iou", "miou"):
            assert got[0][key] == want[key], key
    finally:
        shutil.rmtree(out, ignore_errors=True)
