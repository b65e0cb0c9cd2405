"""Port parity of spatial partitioning (``dis_yolo_tpu_torch.parallel.
spatial``: the height-sharded forward, predict and ``dp x sp`` train step)
on the CPU, at ``tests/conftest.py::small_cfg``'s 96 px (stride-32 grid of
3 rows).

One spawn of four gloo ranks on loopback (``_worker``; results come back
through files) sets up three meshes: the 2 x 2 grid (sp groups {0, 1} and
{2, 3}, dp groups {0, 2} and {1, 3}), each of its rows alone as a 1-D
``sp = 2`` mesh (2 + 1 stride-32 rows), and the 1-D ``sp = 4`` mesh
(1 + 1 + 1 + 0: rank 3 owns no row).  The references run here while the
ranks work: JAX's unsharded functions (which JAX's own spatial tests in
``tests/test_parallel.py`` tie to its sharded ones), JAX's
``spatial_forward`` on 4 virtual devices once, and the port in one
process.

Tolerances, with their reasons (JAX's spatial tests' own where there is
one):
  * the forward, bf16: rtol 1e-2, atol 3e-3 (``test_spatial_forward_
    matches_unsharded``, ``test_2d_mesh_dp_x_sp``);
  * predict, float32: the same kept rows and classes, boxes and scores
    within rtol 1e-5, masks within rtol 1e-4, atol 1e-5 inside their
    boxes (JAX's route on the CPU sigmoids every pixel, 0.5 outside a
    box; the port writes 0 there: ``tests/test_torch_predict.py``), and
    the whole masks within 1e-6 of the port's one process;
  * predict, bf16: the kept count within 2, the top 5 scores within rtol
    1e-2, atol 3e-3 (``test_spatial_predict_bf16_close``);
  * the float32 train step on the 2 x 2 grid against JAX's unsharded
    step: the loss within rtol 1e-4, the parameters within rtol 5e-2,
    atol 3e-3 (``test_2d_mesh_dp_x_sp_train_step``: an Adam update whose
    tiny gradient flips sign moves by 2 lr);
  * the float64 step's gradients (summed over sp, averaged over dp),
    metrics and BN statistics against the one-process step: 1e-9 x
    max|ref| (measured ~1e-13); parameters after Adam within 1e-8
    (``tests/test_torch_parallel.py`` says why);
  * the int8 graph on ``sp = 4`` (``QuantConv`` exchanges int8 halo
    rows): every accumulator row bit-equal to one process's conv of the
    same int8 input; the raw outputs held to JAX's ``spatial_forward``
    of the same int8 tree by ``tests/test_torch_quant.py::
    test_int8_graph_matches_jax``'s rule (normalized MAE at most twice
    JAX's own against the image moved by one ulp: rounding flips
    cascade); predict's kept count within 2 of one process;
  * the calibration graph's raws, and the deploy, s2d, commuted-decoder,
    stride-1 and stride-4 graphs' (float32): the bf16 forward's
    tolerances, against one process and JAX's unsharded forward;
  * the float64 step with ``remat`` against the plain spatial step:
    1e-12 x max|ref| (bit-equal expected), and 1e-9 of one process;
    ``grad_accum=2`` on the grid against one process at 1e-9 (stage 1
    without the locked gradients, as ``tests/test_torch_parallel.py``'s
    knob cases: the backward stops at layer 53).
"""

import functools
import subprocess
import sys
import time
import traceback
from contextlib import contextmanager
from pathlib import Path
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh

from dis_yolo_tpu.config import DISYoloConfig as JaxConfig
from dis_yolo_tpu.models import api as jax_api
from dis_yolo_tpu.parallel import spatial as jax_spatial
from dis_yolo_tpu.train import train_step as jax_ts
from dis_yolo_tpu_torch.config import DISYoloConfig
from dis_yolo_tpu_torch.models import api, fold, layers, quant, s2d
from dis_yolo_tpu_torch.models.weights import (flax_from_state_dict,
                                               state_dict_from_flax)
from dis_yolo_tpu_torch.parallel import distributed, sharding, spatial
from dis_yolo_tpu_torch.train import train_step as ts
from dis_yolo_tpu_torch.train.synthetic import synthetic_batch
from tests.test_torch_parallel import (_Spawn, _digest, _env, _free_port,
                                       _spy_grads, _summary, close,
                                       close_summary)

ROOT = Path(__file__).resolve().parent.parent
SIZE, WORLD = 96, 4
KW = dict(image_size=SIZE, test_size=SIZE, batch_size=2, pre_nms_top_k=64)
F32_KW = dict(KW, compute_dtype="float32")
F64_KW = dict(KW, compute_dtype="float64", locked_layers=())
ACCUM_KW = dict(KW, compute_dtype="float64", skip_nonfinite_updates=False,
                grad_accum=2, batch_size=4)
SEED = 3            # the port's weights, in every process
# the other graphs the sharded forward takes (float32, on sp = 4)
GRAPHS = {"deploy": dict(deploy=True),
          "s2d": dict(deploy=True, s2d_stem=True),
          "commute": dict(decoder_commute=True),
          "stride1": dict(mask_stride=1),
          "stride4": dict(mask_stride=4)}
COLLECTIVE_TIMEOUT_S = 180      # a rank stuck in a collective raises
SPAWN_TIMEOUT_S = 600


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
    """PyTorch's plain CPU convolutions, as the ranks run them
    (``tests/test_torch_train.py`` says why)."""
    before = torch.backends.mkldnn.enabled
    torch.backends.mkldnn.enabled = False
    yield
    torch.backends.mkldnn.enabled = before


def _model(kw):
    """The port's model at ``kw`` from ``SEED`` (float64 parameters in a
    float64 model)."""
    cfg = DISYoloConfig(**kw)
    return api.init_model(cfg, SEED, device="cpu").to(
        torch.float64 if cfg.compute_dtype == "float64" else torch.float32)


def _np(tensors):
    return [t.detach().numpy() for t in tensors]


@contextmanager
def _conv_inputs():
    """Records [input rows, kernel, stride, width, rows F.conv2d got] of
    every ``layers.conv_same`` call while it runs."""
    records = []
    real_same, real_conv = layers.conv_same, layers.F.conv2d

    def same(x, weight, bias, stride, shard=None):
        records.append([x.shape[2], weight.shape[-1], stride, x.shape[3],
                        None])
        return real_same(x, weight, bias, stride, shard)

    def conv(x, *args, **kwargs):
        records[-1][4] = x.shape[2]
        return real_conv(x, *args, **kwargs)
    with mock.patch.object(layers, "conv_same", same), \
            mock.patch.object(layers.F, "conv2d", conv):
        yield records


@contextmanager
def _accumulators(names=None):
    """Records [layer, this rank's int8 input rows (NHWC), its int32
    accumulator rows] of every ``QuantConv`` call while it runs (the
    layer's name where ``names`` maps modules to names, else None)."""
    records = []
    real = quant.QuantConv.accumulate

    def spy(self, x):
        acc = real(self, x)
        records.append([(names or {}).get(self),
                        quant.quantize_input(x, self.inv_sx).numpy(),
                        acc.numpy()])
        return acc
    with mock.patch.object(quant.QuantConv, "accumulate", spy):
        yield records


def _int8_models(absmax=None):
    """The calibration graph on the seed weights folded to the deploy
    form, and with ``absmax`` the int8 graph (its layers quantized)."""
    dsd = fold.deploy_variables(_seed_state(2))
    calib = api.create_model(DISYoloConfig(**F32_KW, quant=True,
                                           quant_calibrate=True),
                             device="cpu")
    calib.load_state_dict(dsd)
    if absmax is None:
        return calib, dsd
    int8 = api.create_model(DISYoloConfig(**F32_KW, quant=True), device="cpu")
    int8.load_state_dict(quant.quantize_deploy(dsd, absmax))
    return int8, calib


@functools.lru_cache(maxsize=None)
def _seed_state(mask_stride):
    """The float32 seed weights of the decoder of ``mask_stride``."""
    return _model(dict(F32_KW, mask_stride=mask_stride)).state_dict()


def _graph(name):
    """(model, state_dict) of ``GRAPHS[name]``, float32, the seed
    weights in that graph's form."""
    kw = dict(F32_KW, **GRAPHS[name])
    sd = _seed_state(kw.get("mask_stride", 2))
    if kw.get("deploy"):
        sd = fold.deploy_variables(sd)
    if kw.get("s2d_stem"):
        sd = s2d.s2d_stem_variables(sd)
    model = api.create_model(DISYoloConfig(**kw), device="cpu")
    model.load_state_dict(sd)
    return model, sd


def _f32_step(spec, mesh):
    """The float32 step (stage 1, JAX's uniforms) on the grid: (metrics,
    summarized parameters, a digest of the state after it)."""
    model = _model(F32_KW)
    state = ts.init_train_state(model, device="cpu", mesh=mesh)
    step = spatial.spatial_train_step(model, mesh)
    u = [torch.from_numpy(x) for x in spec["jax_uniforms"]]
    with mock.patch.object(ts, "draw_uniforms", lambda *a: tuple(u)):
        _, m = step(state, spec["batch"], torch.Generator())
    digest = [_digest(v) for v in model.state_dict().values()] \
        + [_digest(v) for v in state.opt.mu.values()]
    return ({k: float(v) for k, v in m.items()},
            _summary(dict(model.named_parameters())), digest)


def _grad_step(batch, mesh=None, kw=F64_KW, update=True):
    """One float64 step (by default nothing locked: train-mode BN
    everywhere): (gradients taken, metrics, state_dict after),
    summarized; on the spatial mesh or in one process.  ``update=False``
    takes the gradients and skips Adam (the parameters stay)."""
    model = _model(kw)
    grads = {}
    spy = _spy_grads(grads) if update else mock.patch.object(
        ts, "adam_apply", lambda state, params, g, cfg: grads.update(g))
    with spy:
        state = ts.init_train_state(model, device="cpu", mesh=mesh)
        step = ts.make_train_step(model, device="cpu") if mesh is None \
            else spatial.spatial_train_step(model, mesh)
        _, m = step(state, batch, torch.Generator().manual_seed(1))
    return (_summary(grads), {k: float(v) for k, v in m.items()},
            _summary(model.state_dict()))


# ----------------------------------------------------------------- worker

def _worker(spec_path: str, rank: int) -> None:
    """One rank of the spawn: every spatial check's rank-side run, its
    results to ``out_<rank>.pt``."""
    torch.set_num_threads(1)
    torch.backends.mkldnn.enabled = False
    spec = torch.load(spec_path, weights_only=False)
    distributed.initialize("cpu", init_method=spec["init"], world_size=WORLD,
                           rank=rank, timeout_s=COLLECTIVE_TIMEOUT_S)
    t0 = time.perf_counter()
    out = {}
    try:
        grid = sharding.make_mesh_2d(2, 2, "cpu")
        line = sharding.make_mesh_2d(1, 4, "cpu")
        alone = sharding.Mesh(None, 0, 1, torch.device("cpu"), "dp")
        meshes = {"sp2": sharding.Mesh2D(alone, grid.sp, grid.sp),
                  "sp4": line}
        out["ranks"] = {tag: (m.dp.rank, m.sp.rank, m.world.rank)
                        for tag, m in dict(meshes, grid=grid).items()}
        # (a) the forward, bf16, its convs' inputs recorded; on the grid
        bf16 = _model(KW)
        out["forward"], out["conv_inputs"] = {}, {}
        for tag, mesh in meshes.items():
            with _conv_inputs() as rec:
                out["forward"][tag] = _np(spatial.spatial_forward(
                    bf16, mesh)(spec["img0"]))
            out["conv_inputs"][tag] = rec
        out["forward"]["grid"] = _np(spatial.spatial_forward(bf16, grid)(
            spec["img5"]))
        print(f"forward at {time.perf_counter() - t0:.1f} s", flush=True)
        # (b, c) predict, float32 on both 1-D meshes, bf16 on sp = 4
        f32 = _model(F32_KW)
        out["predict_f32"] = {tag: _np(spatial.spatial_predict(
            f32, mesh, obj_thresh=1e-6)(spec["img1"], spec["win"]))
            for tag, mesh in meshes.items()}
        out["predict_bf16"] = _np(spatial.spatial_predict(
            bf16, line, obj_thresh=1e-6)(spec["img1"], spec["win"]))
        print(f"predict at {time.perf_counter() - t0:.1f} s", flush=True)
        # (d) the float32 step on the grid
        out["f32_step"] = _f32_step(spec, grid)
        print(f"f32 step at {time.perf_counter() - t0:.1f} s", flush=True)
        # (e) float64 gradients on the grid and on sp = 4
        out["grads"] = {tag: _grad_step(spec["batch64"], mesh)
                        for tag, mesh in (("grid", grid), ("sp4", line))}
        print(f"grads at {time.perf_counter() - t0:.1f} s", flush=True)
        # (f) the int8 graph on sp = 4, its accumulators recorded; the
        # calibration graph
        int8, calib = _int8_models(spec["absmax"])
        with _accumulators() as acc:
            out["int8_forward"] = _np(spatial.spatial_forward(int8, line)(
                spec["img1"]))
        out["int8_acc"] = acc
        out["int8_predict"] = _np(spatial.spatial_predict(
            int8, line, obj_thresh=1e-6)(spec["img1"], spec["win"]))
        out["calib_forward"] = _np(spatial.spatial_forward(calib, line)(
            spec["img1"]))
        out["calib_records"] = [m.records for m in calib.modules()
                                if isinstance(m, quant.QuantConv)]
        # (g) the other graphs on sp = 4
        out["graphs"] = {name: _np(spatial.spatial_forward(
            _graph(name)[0], line)(spec["img0"])) for name in GRAPHS}
        print(f"graphs at {time.perf_counter() - t0:.1f} s", flush=True)
        # (h) remat on the grid and on sp = 4; (i) grad_accum on the grid
        out["remat"] = {tag: _grad_step(spec["batch64"], mesh,
                                        dict(F64_KW, remat=True), False)
                        for tag, mesh in (("grid", grid), ("sp4", line))}
        print(f"remat at {time.perf_counter() - t0:.1f} s", flush=True)
        out["grad_accum"] = _grad_step(spec["batch_accum"], grid, ACCUM_KW,
                                       False)
        print(f"grad_accum at {time.perf_counter() - t0:.1f} s", flush=True)
    except BaseException:
        traceback.print_exc()
        raise
    finally:
        distributed.shutdown()
    torch.save(out, spec["out"].format(rank))
    print(f"worker {rank} OK", flush=True)


@pytest.fixture(scope="module")
def sp_run(tmp_path_factory):
    """The inputs, and the four gloo ranks started on them: they run while
    the references are computed."""
    from tests.test_torch_train import jax_uniforms
    from tests.test_train_step import make_batch
    tmp = tmp_path_factory.mktemp("sp")
    cfg = DISYoloConfig(**F32_KW)
    keys = jax.random.split(jax.random.PRNGKey(7), 2)
    image = lambda seed, b: np.random.RandomState(seed).rand(
        b, SIZE, SIZE, 3).astype(np.float32)
    spec = dict(
        init=f"tcp://127.0.0.1:{_free_port()}", out=str(tmp / "out_{}.pt"),
        img0=image(0, 1), img1=image(1, 1), img5=image(5, 2),
        win=np.array([[0.0, 0.0, 1.0, 1.0]], np.float32),
        batch={k: np.asarray(v) for k, v in make_batch(cfg, b=2).items()},
        jax_uniforms=jax_uniforms(keys, cfg.max_detection,
                                  cfg.max_box_per_image),
        batch64=synthetic_batch(DISYoloConfig(**F64_KW), 2, 3, seed=5),
        batch_accum=synthetic_batch(DISYoloConfig(**ACCUM_KW), 4, 3, seed=6))
    # the int8 graph's calibration, one process on the predict image
    spec["absmax"] = quant.calibrate_deploy(*_int8_models(), spec["img1"])
    spec_path = str(tmp / "spec.pt")
    torch.save(spec, spec_path)
    code = ("import sys; from tests.test_torch_spatial import _worker; "
            "_worker(sys.argv[1], int(sys.argv[2]))")
    logs = [str(tmp / f"rank{r}.log") for r in range(WORLD)]
    env = dict(_env(), OMP_NUM_THREADS="1")
    procs = []
    for r in range(WORLD):
        with open(logs[r], "w") as log:
            procs.append(subprocess.Popen(
                [sys.executable, "-c", code, spec_path, str(r)], cwd=ROOT,
                env=env, stdout=log, stderr=subprocess.STDOUT))
    run = _Spawn(spec, procs, logs, SPAWN_TIMEOUT_S)
    yield run
    run.kill()


def _jax(kw):
    """JAX's model and the port's seed weights as Flax variables."""
    return (jax_api.create_model(JaxConfig(**kw)),
            flax_from_state_dict(_model(kw).state_dict()))


def _jax_step(spec):
    """JAX's unsharded float32 step: (metrics, summarized parameters)."""
    model, v = _jax(F32_KW)
    tx = jax_ts.make_optimizer(v["params"], JaxConfig(**F32_KW))
    st = jax_ts.TrainState(v["params"], v["batch_stats"],
                           tx.init(v["params"]), jnp.asarray(0))
    new, metrics = jax_ts.make_jitted_train_step(model, tx)(
        st, spec["batch"], jax.random.PRNGKey(7))
    params = state_dict_from_flax(jax.tree.map(np.asarray, {
        "params": new.params, "batch_stats": new.batch_stats}))
    return ({k: float(v) for k, v in metrics.items()},
            _summary({k: torch.from_numpy(np.asarray(t))
                      for k, t in params.items() if not k.endswith(
                          ("running_mean", "running_var",
                           "num_batches_tracked"))}))


@pytest.fixture(scope="module")
def refs(sp_run):
    """JAX's and the one-process port's references, computed while the
    ranks work (JAX's functions jitted: one compile for each)."""
    spec = sp_run.spec
    out = {}
    model, v = _jax(KW)
    forward = jax.jit(lambda v, x: jax_api.forward(model, v, x))
    as_np = lambda xs: [np.asarray(x) for x in xs]
    out["forward"] = as_np(forward(v, spec["img0"]))
    mesh = JaxMesh(np.asarray(jax.devices()[:4]), ("sp",))
    out["jax_spatial_forward"] = as_np(jax_spatial.spatial_forward(
        model, mesh)(v, jnp.asarray(spec["img0"])))
    # the two images of the grid's batch, one at a time
    out["forward_b2"] = [np.concatenate(x) for x in zip(*(
        as_np(forward(v, spec["img5"][i:i + 1])) for i in range(2)))]
    for tag, kw in (("bf16", KW), ("f32", F32_KW)):
        model, v = _jax(kw)
        out[f"predict_{tag}"] = as_np(jax.jit(
            lambda v, x, w: jax_api.predict(model, v, x, w, obj_thresh=1e-6))(
                v, spec["img1"], spec["win"]))
    out["port_predict_f32"] = _np(api.predict(
        _model(F32_KW), spec["img1"], spec["win"], 1e-6, device="cpu"))
    out["step"] = _jax_step(spec)
    out["grads"] = _grad_step(spec["batch64"])
    out["grad_accum"] = _grad_step(spec["batch_accum"], None, ACCUM_KW, False)
    # the int8 graph: JAX's spatial_forward on 4 virtual devices, on the
    # image and on the image moved by one ulp; the port's one process
    int8, calib = _int8_models(spec["absmax"])
    jmodel = jax_api.create_model(JaxConfig(**F32_KW, quant=True))
    run = jax_spatial.spatial_forward(jmodel, mesh)
    qv = flax_from_state_dict(int8.state_dict())
    moved = np.nextafter(spec["img1"], np.float32(2)).astype(np.float32)
    out["jax_int8"] = [as_np(run(qv, jnp.asarray(x)))
                       for x in (spec["img1"], moved)]
    names = {m: n for n, m in int8.named_children()}
    with _accumulators(names) as acc:
        out["int8_forward"] = _np(api.forward(int8, spec["img1"],
                                              device="cpu"))
    out["int8_acc"], out["int8_model"] = acc, int8
    out["int8_predict"] = _np(api.predict(int8, spec["img1"], spec["win"],
                                          1e-6, device="cpu"))
    out["calib_forward"] = _np(api.forward(calib, spec["img1"],
                                           device="cpu"))
    # the other graphs: JAX's unsharded forward and the port's one process
    out["graphs"] = {}
    for name, kw in GRAPHS.items():
        model, sd = _graph(name)
        jmodel = jax_api.create_model(JaxConfig(**F32_KW, **kw))
        out["graphs"][name] = (
            as_np(jax.jit(lambda v, x: jax_api.forward(jmodel, v, x))(
                flax_from_state_dict(sd), spec["img0"])),
            _np(api.forward(model, spec["img0"], device="cpu")))
    _seed_state.cache_clear()
    return out


# ------------------------------------------------------------------ tests

def test_meshes_and_row_partition(sp_run):
    """The uneven partitions of the 3 stride-32 rows, a one-process grid,
    the entry points' refusals and the graphs they take (the int8 graph,
    ``remat`` in the step: the ranks run them).  It runs while the ranks
    work."""
    assert sharding.row_partition(3, 2) == [(0, 2), (2, 3)]
    assert sharding.row_partition(3, 4) == [(0, 1), (1, 2), (2, 3), (3, 3)]
    assert sharding.row_partition(18, 2) == [(0, 9), (9, 18)]
    cpu = torch.device("cpu")
    one = sharding.Mesh(None, 0, 1, cpu, "dp")
    last = sharding.Mesh2D(one, sharding.Mesh(None, 3, 4, cpu, "sp"), one)
    shard = sharding.HeightShard(last, 96, 96)
    # stride 1, 2, 8, 32: rank 3 of 4 owns nothing
    assert shard.ranges(96) == (96, [(0, 32), (32, 64), (64, 96), (96, 96)])
    assert shard.ranges(48)[1][1] == (16, 32)
    assert shard.ranges(12) == (12, [(0, 4), (4, 8), (8, 12), (12, 12)])
    assert shard.ranges(3)[1] == [(0, 1), (1, 2), (2, 3), (3, 3)]
    assert shard.image_rows() == slice(96, 96)
    with pytest.raises(ValueError, match="multiples of 32"):
        sharding.HeightShard(last, 80, 96)
    mesh = sharding.make_mesh_2d(1, 1, "cpu")
    assert (mesh.dp.size, mesh.sp.size, mesh.world.size) == (1, 1, 1)
    with pytest.raises(ValueError, match="needs 4 processes"):
        sharding.make_mesh_2d(2, 2, "cpu")
    for graph in (dict(quant=True), dict(quant=True, quant_calibrate=True)):
        assert callable(spatial.spatial_forward(api.create_model(
            DISYoloConfig(**KW, **graph), device="cpu"), mesh))
    with pytest.raises(TypeError, match="Mesh2D"):
        spatial.spatial_forward(_model(KW), one)
    assert callable(spatial.spatial_train_step(
        _model(dict(F32_KW, remat=True)), mesh))
    with pytest.raises(ValueError, match="bn_axis"):
        spatial.spatial_train_step(_model(dict(F32_KW, bn_axis="dp")), mesh)
    with pytest.raises(ValueError, match="K-step"):
        ts.make_multi_step(_model(F32_KW), mesh=mesh)
    # a one-process grid is the unsharded forward (float32; its SAME
    # rows are explicit zeros, so the convs may sum in another order)
    model = _model(F32_KW)
    img = np.random.RandomState(2).rand(1, SIZE, SIZE, 3).astype(np.float32)
    _close(_np(spatial.spatial_forward(model, mesh)(img)),
           _np(api.forward(model, img, device="cpu")), 1e-5, 1e-6, "1 x 1")


def _close(got, want, rtol, atol, msg):
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g, w, rtol=rtol, atol=atol,
                                   err_msg=f"{msg} out {i}")


@pytest.mark.parametrize("tag", ["sp2", "sp4"])
def test_spatial_forward_matches_unsharded(sp_run, refs, tag):
    """bf16, one image: the outputs of ``sp = 2`` (2 + 1 stride-32 rows)
    and ``sp = 4`` (one rank without rows), equal on every rank, against
    JAX's unsharded forward and JAX's ``spatial_forward`` on 4 virtual
    devices."""
    outs = sp_run.result()
    got = outs[0]["forward"][tag]
    assert [x.shape for x in got] == [x.shape for x in refs["forward"]]
    for out in outs[1:]:
        for a, b in zip(out["forward"][tag], got):
            np.testing.assert_array_equal(a, b)
    _close(got, refs["forward"], 1e-2, 3e-3, f"{tag} vs JAX forward")
    _close(got, refs["jax_spatial_forward"], 1e-2, 3e-3,
           f"{tag} vs JAX spatial_forward")


def test_spatial_predict_exact_keep_set_f32(sp_run, refs):
    """float32, both 1-D meshes: the unsharded keep set row for row."""
    wd, wm = refs["predict_f32"]
    wd = wd[0]
    for out in sp_run.result():
        for tag, (gd, gm) in out["predict_f32"].items():
            pd, pm = refs["port_predict_f32"]
            np.testing.assert_allclose(gd, pd, rtol=0, atol=1e-6,
                                       err_msg=tag)
            np.testing.assert_allclose(gm, pm, rtol=0, atol=1e-6,
                                       err_msg=tag)
            gd, gm = gd[0], gm[0]
            n_want, n_got = int((wd[:, 5] > 0).sum()), int((gd[:, 5] > 0).sum())
            assert n_want == n_got and n_want > 0, (tag, n_want, n_got)
            np.testing.assert_array_equal(wd[:, 4], gd[:, 4])
            np.testing.assert_allclose(gd[:, :4], wd[:, :4], rtol=1e-5,
                                       atol=1e-6, err_msg=tag)
            np.testing.assert_allclose(gd[:, 5], wd[:, 5], rtol=1e-5,
                                       atol=1e-7, err_msg=tag)
            # the port writes 0 outside each box, JAX's CPU route 0.5
            inside = gm != 0
            np.testing.assert_allclose(gm[inside], wm[0][inside], rtol=1e-4,
                                       atol=1e-5, err_msg=tag)
            assert np.all(wm[0][~inside] == 0.5)


def test_spatial_predict_bf16_close(sp_run, refs):
    """bf16 on ``sp = 4``: set-level statistics, as JAX's test holds."""
    wd, wm = refs["predict_bf16"]
    wd = wd[0]
    for out in sp_run.result():
        gd, gm = out["predict_bf16"]
        gd = gd[0]
        n_want, n_got = int((wd[:, 5] > 0).sum()), int((gd[:, 5] > 0).sum())
        assert abs(n_want - n_got) <= 2
        k = min(5, n_want, n_got)
        np.testing.assert_allclose(np.sort(gd[:, 5])[::-1][:k],
                                   np.sort(wd[:, 5])[::-1][:k],
                                   rtol=1e-2, atol=3e-3)
        assert gm.shape == wm.shape


def test_2d_mesh_dp_x_sp(sp_run, refs):
    """The grid's ranks (world rank d * 2 + s), and the forward of two
    images on the 2 x 2 grid (one image per dp rank, its height over 2
    sp ranks): whole on every rank, against JAX's unsharded forward."""
    for out in sp_run.result():
        rank = out["ranks"]["grid"][2]
        assert out["ranks"]["grid"] == (rank // 2, rank % 2, rank)
        assert out["ranks"]["sp2"] == (0, rank % 2, rank % 2)
        assert out["ranks"]["sp4"] == (0, rank, rank)
        _close(out["forward"]["grid"], refs["forward_b2"], 1e-2, 3e-3,
               "2 x 2")


def test_2d_mesh_dp_x_sp_train_step(sp_run, refs):
    """float32 (stage 1) on the 2 x 2 grid with JAX's per-image
    uniforms: the loss against JAX's unsharded step, the parameters after
    it, and the four replicas bit-equal."""
    want, want_p = refs["step"]
    outs = sp_run.result()
    for r, out in enumerate(outs):
        metrics, params, digest = out["f32_step"]
        np.testing.assert_allclose(metrics["total_loss"], want["total_loss"],
                                   rtol=1e-4, err_msg=f"rank {r}")
        assert set(params) == set(want_p)
        for key, (w, _) in want_p.items():
            np.testing.assert_allclose(params[key][0], w, rtol=5e-2,
                                       atol=3e-3, err_msg=key)
        assert digest == outs[0]["f32_step"][2], f"rank {r}'s replica"


@pytest.mark.parametrize("tag", ["grid", "sp4"])
def test_spatial_step_float64_grads_equal_one_process(sp_run, refs, tag):
    """float64, train-mode BN in every layer, uneven shards (2 + 1 rows
    on the grid; 1 + 1 + 1 + 0 on ``sp = 4``): the step's gradients
    (summed over sp, averaged over dp), metrics and BN statistics equal
    the one-process step on the global batch within 1e-9 on every rank;
    the parameters after Adam within 1e-8."""
    grads, metrics, sd = refs["grads"]
    for r, out in enumerate(sp_run.result()):
        g, m, s = out["grads"][tag]
        close_summary(g, grads, 1e-9, f"rank {r} grad")
        for k, w in metrics.items():
            close(m[k], w, 1e-9, f"rank {r} {k}")
        close_summary({k: v for k, v in s.items() if "running" in k},
                      {k: v for k, v in sd.items() if "running" in k}, 1e-9,
                      f"rank {r} statistics")
        close_summary(s, sd, 1e-8, f"rank {r}")


@pytest.mark.parametrize("tag", ["sp2", "sp4"])
def test_convs_see_only_their_rows_and_halo(sp_run, tag):
    """Every conv of the forward gets this rank's rows and its window's
    halo, ``kernel - stride`` rows (``kernel`` zero rows on a rank
    without rows), never more: at strides 1 to 8 (global heights 96 to
    12) no rank holds the whole height.  An all-gather of the activations
    cannot pass this."""
    n_convs = len(dict(_model(KW).named_children()))
    for r, out in enumerate(sp_run.result()):
        rec = out["conv_inputs"][tag]
        assert len(rec) == n_convs
        assert sum(rows == 0 for rows, *_ in rec) == (n_convs if tag == "sp4"
                                                     and r == 3 else 0)
        for rows, kernel, stride, width, got in rec:
            want = rows + kernel - stride if rows else kernel
            assert got == want, (r, rows, kernel, stride, width, got)
            if width >= 12:                     # square: height = width
                assert got < width, (r, rows, kernel, stride, width, got)


# ------------------------------------------------- the int8 graph (sp = 4)

def _rows_of(width):
    """Every rank's rows, on ``sp = 4``, of a tensor whose width is
    ``width``."""
    cpu = torch.device("cpu")
    one = sharding.Mesh(None, 0, 1, cpu, "dp")
    mesh = sharding.Mesh2D(one, sharding.Mesh(None, 0, 4, cpu, "sp"), one)
    return sharding.HeightShard(mesh, SIZE, SIZE).ranges(width)[1]


def test_int8_spatial_accumulators_equal_one_process(sp_run, refs):
    """Every QuantConv of the int8 graph on ``sp = 4`` (1 + 1 + 1 + 0
    rows): each rank's int32 accumulator rows equal, bit for bit, one
    process's conv of the same int8 input, the ranks' own rows put
    together (their halos came from the other ranks, as int8); and the
    first quantized layer's int8 input is one process's."""
    outs = sp_run.result()
    want = refs["int8_acc"]
    model = refs["int8_model"]
    assert len(want) == len(set(n for n, *_ in want)) == sum(
        isinstance(m, quant.QuantConv) for m in model.modules())
    for i, (name, x_one, acc_one) in enumerate(want):
        mod = getattr(model, name)
        x_q = np.concatenate([out["int8_acc"][i][1] for out in outs], 1)
        assert x_q.shape == x_one.shape, name
        if i == 0:
            np.testing.assert_array_equal(x_q, x_one, err_msg=name)
        whole = quant.int8_conv(torch.from_numpy(x_q), mod.w_q,
                                mod.stride).numpy()
        ranges = _rows_of(whole.shape[2])
        for r, out in enumerate(outs):
            _, mine, acc = out["int8_acc"][i]
            a, b = ranges[r]
            assert mine.shape[1] == acc.shape[1] * mod.stride, name
            assert acc.dtype == np.int32 and acc.shape == whole[:, a:b].shape
            np.testing.assert_array_equal(acc, whole[:, a:b],
                                          err_msg=f"{name} rank {r}")
        if np.array_equal(x_q, x_one):
            np.testing.assert_array_equal(whole, acc_one, err_msg=name)


def _norm_mae(got, want):
    got, want = (np.asarray(a, np.float64) for a in (got, want))
    return np.abs(got - want).mean() / (np.abs(want).mean() + 1e-6)


def test_int8_spatial_forward_matches_jax_and_one_process(sp_run, refs):
    """The int8 graph's raw outputs on ``sp = 4``, equal on every rank,
    against JAX's ``spatial_forward`` of the same int8 tree on 4 virtual
    devices and against the port's one process: each output's normalized
    MAE at most twice JAX's own against the image moved by one ulp, and
    below the JAX package's int8 bound of 0.25
    (``tests/test_torch_quant.py::test_int8_graph_matches_jax``'s rule:
    an ulp upstream flips a rounding, and flips cascade)."""
    outs = sp_run.result()
    got = outs[0]["int8_forward"]
    for out in outs[1:]:
        for a, b in zip(out["int8_forward"], got):
            np.testing.assert_array_equal(a, b)
    want, moved = refs["jax_int8"]
    for i, (g, w, m, one) in enumerate(zip(got, want, moved,
                                           refs["int8_forward"])):
        assert g.shape == w.shape == one.shape and np.isfinite(g).all()
        spread = _norm_mae(m, w)
        for tag, ref in (("JAX spatial_forward", w), ("one process", one)):
            mae = _norm_mae(g, ref)
            print(f"int8 out {i}: MAE vs {tag} {mae:.4g} (JAX's spread "
                  f"{spread:.4g})")
            assert mae <= 2 * spread and mae < 0.25, (i, tag, mae, spread)


def test_int8_spatial_predict_kept_within_two(sp_run, refs):
    """int8 predict on ``sp = 4``: equal on every rank, and the kept count
    within 2 of one process's, the top 5 scores within rtol 1e-2 (the
    bf16 rule)."""
    outs = sp_run.result()
    wd, wm = refs["int8_predict"]
    for out in outs:
        gd, gm = out["int8_predict"]
        np.testing.assert_array_equal(gd, outs[0]["int8_predict"][0])
        assert gd.shape == wd.shape and gm.shape == wm.shape
        n_want, n_got = (int((d[0, :, 5] > 0).sum()) for d in (wd, gd))
        assert n_want > 0 and abs(n_want - n_got) <= 2, (n_want, n_got)
        k = min(5, n_want, n_got)
        np.testing.assert_allclose(np.sort(gd[0, :, 5])[::-1][:k],
                                   np.sort(wd[0, :, 5])[::-1][:k],
                                   rtol=1e-2, atol=3e-3)


def test_calibration_graph_sharded_keeps_no_records(sp_run, refs):
    """The calibration graph (float convs) on ``sp = 4``: the raws within
    the bf16 forward's tolerances of one process, and no QuantConv keeps
    per-rank statistics that could pass for the image's."""
    for r, out in enumerate(sp_run.result()):
        _close(out["calib_forward"], refs["calib_forward"], 1e-2, 3e-3,
               f"calibration graph rank {r}")
        assert out["calib_records"] and all(
            rec == {} for rec in out["calib_records"]), r


@pytest.mark.parametrize("name", list(GRAPHS))
def test_spatial_forward_other_graphs(sp_run, refs, name):
    """The deploy graph, deploy + s2d stem (its 2-wide conv pads rows (0,
    1)), the commuted decoder and the stride-1 and stride-4 decoders
    (float32) on ``sp = 4``, equal on every rank, against JAX's unsharded
    forward (the bf16 forward's tolerances) and the port's one process
    (rtol 1e-5: the explicit SAME rows sum in another order)."""
    outs = sp_run.result()
    want, one = refs["graphs"][name]
    got = outs[0]["graphs"][name]
    assert [g.shape for g in got] == [w.shape for w in want]
    for out in outs[1:]:
        for a, b in zip(out["graphs"][name], got):
            np.testing.assert_array_equal(a, b)
    _close(got, want, 1e-2, 3e-3, f"{name} vs JAX forward")
    _close(got, one, 1e-5, 1e-6, f"{name} vs one process")


# --------------------------------------------- remat and grad_accum (float64)

@pytest.mark.parametrize("tag", ["grid", "sp4"])
def test_spatial_step_remat_equals_plain_step(sp_run, refs, tag):
    """float64, nothing locked, ``remat``: every ConvBN recomputed in the
    backward, its halo exchange and BN's moment sums with it.  The
    gradients, metrics and BN statistics equal the plain spatial step's
    on the same rows (1e-12 x max|ref|; bit-equal expected) on 2 + 1 and
    1 + 1 + 1 + 0 row splits, and the one-process step's within 1e-9."""
    grads, metrics, sd = refs["grads"]
    running = lambda summary: {k: v for k, v in summary.items()
                               if "running" in k}
    for r, out in enumerate(sp_run.result()):
        g, m, s = out["remat"][tag]
        pg, pm, ps = out["grads"][tag]
        close_summary(g, pg, 1e-12, f"rank {r} remat grad")
        for k, w in pm.items():
            close(m[k], w, 1e-12, f"rank {r} remat {k}")
            close(m[k], metrics[k], 1e-9, f"rank {r} remat {k}")
        close_summary(running(s), running(ps), 1e-12,
                      f"rank {r} remat statistics")
        close_summary(g, grads, 1e-9, f"rank {r} remat grad vs one process")
        close_summary(running(s), running(sd), 1e-9,
                      f"rank {r} remat statistics vs one process")


def test_spatial_step_grad_accum_equals_one_process(sp_run, refs):
    """float64, ``grad_accum=2`` on the 2 x 2 grid, global batch 4: each
    microbatch is two rows of the global batch, one per dp rank (JAX's
    spatial step partitions the one-device program, whose microbatches
    are slices of the global batch).  The gradients, metrics and BN
    statistics (moved once per microbatch) equal the one-process
    ``grad_accum=2`` step's within 1e-9."""
    grads, metrics, sd = refs["grad_accum"]
    for r, out in enumerate(sp_run.result()):
        g, m, s = out["grad_accum"]
        close_summary(g, grads, 1e-9, f"rank {r} grad")
        for k, w in metrics.items():
            close(m[k], w, 1e-9, f"rank {r} {k}")
        close_summary(s, sd, 1e-9, f"rank {r} state")
