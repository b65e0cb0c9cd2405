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
    (``tests/test_torch_parallel.py`` says why).
"""

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
from dis_yolo_tpu_torch.models import api, layers
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
SEED = 3            # the port's weights, in every process


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


def _grad_step(batch, mesh=None):
    """One float64 step, nothing locked (train-mode BN everywhere):
    (gradients taken, metrics, state_dict after), summarized; on the
    spatial mesh or in one process."""
    model = _model(F64_KW)
    grads = {}
    with _spy_grads(grads):
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
                           rank=rank)
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
        batch64=synthetic_batch(DISYoloConfig(**F64_KW), 2, 3, seed=5))
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
    run = _Spawn(spec, procs, logs)
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
    return out


# ------------------------------------------------------------------ tests

def test_meshes_and_row_partition(sp_run):
    """The uneven partitions of the 3 stride-32 rows, a one-process grid
    and the entry points' refusals.  It runs while the ranks work."""
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
    quant = api.create_model(DISYoloConfig(**KW, deploy=True, quant=True),
                             device="cpu")
    with pytest.raises(ValueError, match="int8"):
        spatial.spatial_forward(quant, mesh)
    with pytest.raises(TypeError, match="Mesh2D"):
        spatial.spatial_forward(_model(KW), one)
    model = _model(dict(F32_KW, remat=True))
    with pytest.raises(ValueError, match="remat"):
        spatial.spatial_train_step(model, mesh)
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
