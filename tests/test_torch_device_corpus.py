"""Port parity of ``dis_yolo_tpu_torch.data.device_corpus`` against the
JAX package's ``data/device_corpus.py`` and against the port's own wire
loader, on a 6-image synthetic split at seed 7, 96 px, on the CPU.

Tolerances, with their reasons:
  * the census, the loader's decisions, the true boxes and the label
    grids: exact (the same integer and float32 math);
  * images: at most 1 LSB against JAX (XLA on the CPU may contract the
    bilinear's multiply-adds) and against the wire loader (OpenCV's
    fixed-point resize against float bilinear);
  * masks: exact except at .5 bilinear knife edges, whose count the
    tests state.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dis_yolo_tpu.config import DISYoloConfig as JaxConfig
from dis_yolo_tpu.data import device_corpus as jax_dc
from dis_yolo_tpu_torch.config import DISYoloConfig
from dis_yolo_tpu_torch.data import dataset
from dis_yolo_tpu_torch.data import device_corpus as dc
from tests.test_torch_eval import jax_numpy_fill  # noqa: F401

# the JAX corpus's masks from its numpy fill (tests/test_torch_eval.py)
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


@pytest.fixture(scope="module")
def synth_root(tmp_path_factory, jax_numpy_fill):
    """The JAX package's synthetic split (``tests/test_device_corpus.py``'s
    recipe: 6 images of 160 px, seed 11), rasterized by JAX's numpy
    fill."""
    pytest.importorskip("cv2")
    from dis_yolo_tpu.data.preprocess import build_ground_truth_cache
    from dis_yolo_tpu.data.synthetic import generate_dataset
    root = str(tmp_path_factory.mktemp("corpusdata"))
    generate_dataset(root, phases=("train",), images_per_phase=6,
                     image_size=160, seed=11)
    build_ground_truth_cache(root, "train")
    return root


KW = dict(image_size=96, test_size=96, batch_size=2, pre_nms_top_k=64,
          device_side_augs=True)


@pytest.fixture(scope="module")
def loaders(synth_root):
    """(cfg, port corpus loader, JAX corpus loader, port wire loader,
    port device corpus, JAX device corpus), all at seed 7."""
    cfg = DISYoloConfig(dataset=synth_root, **KW)
    jcfg = JaxConfig(dataset=synth_root, **KW)
    port = dc.CorpusTrainData(cfg, "train", seed=7)
    ref = jax_dc.CorpusTrainData(jcfg, "train", seed=7)
    wire = dataset.DefectTrainData(cfg, "train", seed=7, host_augs=False)
    return (cfg, port, ref, wire, dc.upload_corpus(port.corpus, "cpu"),
            jax_dc.upload_corpus(ref.corpus))


def T(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def test_census_and_decisions_match_jax(loaders):
    """The corpus arrays and three batches of decisions (crossing an
    epoch) equal JAX's, and the normalized boxes equal the wire
    loader's."""
    cfg, port, ref, wire, _, _ = loaders
    for f in ("images", "masks_packed", "sizes", "boxes", "classids",
              "nvalid"):
        np.testing.assert_array_equal(getattr(port.corpus, f),
                                      getattr(ref.corpus, f), err_msg=f)
    assert port.corpus.nbytes() == ref.corpus.nbytes()
    assert port.corpus.nvalid.max() >= 1
    for _ in range(4):
        p, r, w = port._make_batch(), ref._make_batch(), wire._make_batch()
        assert set(p) == set(r)
        for k in p:
            np.testing.assert_array_equal(p[k], r[k], err_msg=k)
        np.testing.assert_array_equal(p["true_box"],
                                      w["true_boxes"][:, 0, 0, 0])
    assert port.epoch == ref.epoch == 2


def test_assemble_matches_jax_and_wire_loader(loaders):
    """Assembled batches against JAX's ``make_assemble_fn`` on the same
    decisions (grids, boxes and windows exact, images within 1 LSB,
    masks exact outside knife edges) and against the wire loader's
    ``build_example(host_augs=False)`` batches."""
    cfg, _, _, _, corpus, jcorpus = loaders
    port = dc.CorpusTrainData(cfg, "train", seed=3, corpus=loaders[1].corpus)
    wire = dataset.DefectTrainData(cfg, "train", seed=3, host_augs=False)
    assemble = dc.make_assemble_fn(cfg)
    jassemble = jax.jit(jax_dc.make_assemble_fn(JaxConfig(**{
        k: getattr(cfg, k) for k in KW})))
    stats = {"jax_img": 0, "jax_mask": 0, "wire_img": 0, "wire_mask": 0}
    for _ in range(3):
        p = port._make_batch()
        got = assemble(corpus, T(p))
        want = jassemble(jcorpus, {k: jnp.asarray(v) for k, v in p.items()})
        w = dataset.expand_batch(wire._make_batch())
        assert got["images"].dtype == torch.uint8
        assert got["true_masks"].dtype == torch.bool
        for k in ("true_boxes", "labels_s8", "labels_s16", "labels_s32",
                  "windows"):
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                          err_msg=k)
            np.testing.assert_array_equal(got[k].numpy(), w[k], err_msg=k)
        img = got["images"].numpy().astype(np.int16)
        d_jax = np.abs(img - np.asarray(want["images"]).astype(np.int16))
        d_wire = np.abs(img - np.round(w["images"] * 255).astype(np.int16))
        assert d_jax.max() <= 1 and d_wire.max() <= 1
        stats["jax_img"] += int((d_jax > 0).sum())
        stats["wire_img"] += int((d_wire > 0).sum())
        m = got["true_masks"].numpy()
        stats["jax_mask"] += int((m != np.asarray(want["true_masks"])).sum())
        stats["wire_mask"] += int((m != w["true_masks"]).sum())
    # measured over the 3 x 55296 image values: 5 off by 1 LSB against
    # JAX, 14339 against the wire loader; no mask pixel lies on a knife
    # edge in these batches (3 x 368640 mask pixels)
    assert stats["jax_img"] <= 16 and stats["wire_img"] <= 0.1 * 3 * img.size
    assert stats["jax_mask"] == 0 and stats["wire_mask"] == 0, stats


@pytest.mark.parametrize("seed", [0, 1])
def test_place_masks_equals_unpacked_resize(seed):
    """``_place_masks`` (the masks' words read at the four taps, a
    16-entry table per pixel) equals the bilinear resize of the unpacked
    0/1 masks rounded to bool, ``_resize_place``, bit for bit: random
    masks and image sizes under a corpus maximum, placements that
    shrink, enlarge, halve exactly (weights 0.5: the knife edges), keep
    the size and touch the canvas's edges, an empty mask; 5 masks in
    int32 words and 40 in int64 ones."""
    rng = np.random.RandomState(seed)
    b, t, hm, wm, size = 6, (5, 40)[seed], 37, 53, 48
    masks = rng.rand(b, t, hm, wm) < 0.4
    masks[:, -1] = False
    packed = torch.from_numpy(np.packbits(masks.reshape(b, t, -1), axis=-1))
    ih = torch.from_numpy(rng.randint(8, hm + 1, b))
    iw = torch.from_numpy(rng.randint(8, wm + 1, b))
    ih[0], iw[0] = 36, 48
    new_h = torch.from_numpy(rng.randint(4, size + 1, b))
    new_w = torch.from_numpy(rng.randint(4, size + 1, b))
    new_h[0], new_w[0] = 18, 24              # exactly half
    new_h[1], new_w[1] = ih[1].clamp(max=size), iw[1].clamp(max=size)
    dy = torch.from_numpy(rng.randint(0, size + 1, b)) % (size - new_h + 1)
    dx = torch.from_numpy(rng.randint(0, size + 1, b)) % (size - new_w + 1)
    dy[2], dx[2] = size - new_h[2], size - new_w[2]
    taps = dc._taps(ih, iw, new_h, new_w, dy, dx, size)
    words = dc._mask_words(packed, hm, wm)
    assert words.dtype == (torch.int32, torch.int64)[seed]
    got = dc._place_masks(words, t, taps)
    unpacked = torch.from_numpy(masks).permute(0, 2, 3, 1)
    want = torch.round(dc._resize_place(unpacked, taps, 0.0)) != 0
    assert got.shape == (b, t, size, size) and got.dtype == torch.bool
    assert torch.equal(got, want.permute(0, 3, 1, 2))
    assert 0 < int(got.sum()) < got.numel() and not got[:, -1].any()


def test_grids_first_wins_and_zero_boxes():
    """Two boxes on one cell and anchor: the first wins, as
    ``assign_anchors``' occupied-cell skip and JAX's ``_grids_one``; an
    image with no valid box gives empty, finite grids."""
    cfg = DISYoloConfig(image_size=96, test_size=96)
    t = cfg.max_box_per_image
    boxes = np.zeros((2, t, 5), np.float32)
    boxes[0, 0] = [48.0, 48.0, 30.0, 30.0, 1]
    boxes[0, 1] = [49.0, 49.0, 31.0, 29.0, 2]   # same cell, same anchor
    boxes[0, 2] = [10.0, 80.0, 8.0, 60.0, 0]
    nvalid = np.asarray([3, 0], np.int32)
    anchors = torch.from_numpy(cfg.anchors_array())
    got = dc._grids(torch.from_numpy(boxes), torch.from_numpy(boxes),
                    torch.from_numpy(nvalid), anchors, cfg.base_grid,
                    cfg.anchors_per_scale, cfg.num_class, 96.0)
    host = dataset.assign_anchors(boxes[0, :3, :4],
                                  boxes[0, :3, 4].astype(np.int64), cfg)
    for i, (g, h) in enumerate(zip(got, host)):
        np.testing.assert_array_equal(g[0].numpy(), h)
        want = jax_dc._grids_one(jnp.asarray(boxes[0]), jnp.asarray(boxes[0]),
                                 jnp.asarray(3), jnp.asarray(anchors.numpy()),
                                 cfg.base_grid, cfg.anchors_per_scale,
                                 cfg.num_class, 96.0)[i]
        np.testing.assert_array_equal(g[0].numpy(), np.asarray(want))
        assert float(g[1].abs().sum()) == 0.0
    assert sum(float(g[0, ..., 4].sum()) for g in got) == 2.0


def test_corpus_refusals_and_device(loaders):
    """No corpus without device-side augs; ``upload_corpus`` targets CUDA
    unless given the CPU, and raises without a card."""
    cfg = loaders[0]
    with pytest.raises(ValueError, match="device_side_augs"):
        dc.CorpusTrainData(cfg.replace(device_side_augs=False), "train",
                           corpus=loaders[1].corpus)
    with pytest.raises(ValueError, match="device_side_augs"):
        cfg.replace(device_corpus=True,
                    device_side_augs=False).check_trainable()
    cfg.replace(device_corpus=True).check_trainable()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            dc.upload_corpus(loaders[1].corpus)
    up = loaders[4]
    assert up["images"].dtype == torch.uint8 and up["sizes"].dtype == torch.int32
    assert up["images"].shape == loaders[1].corpus.images.shape


def test_corpus_block_bit_equals_single_steps(loaders):
    """A K=3 block through ``make_corpus_multi_step`` equals three single
    steps of ``make_train_step`` on the batches ``make_assemble_fn``
    builds from the same decisions, bit for bit (64 px, float32)."""
    from dis_yolo_tpu_torch.models import api
    from dis_yolo_tpu_torch.train import train_step as ts
    cfg = DISYoloConfig(**dict(KW, image_size=64, test_size=64),
                        dataset=loaders[0].dataset, compute_dtype="float32",
                        device_corpus=True, steps_per_dispatch=3)
    cfg.check_trainable()
    data = dc.CorpusTrainData(cfg, "train", seed=5, corpus=loaders[1].corpus)
    params = [data._make_batch() for _ in range(3)]
    corpus = dc.upload_corpus(data.corpus, "cpu")
    assemble = dc.make_assemble_fn(cfg)
    models = [api.init_model(cfg, 2, device="cpu") for _ in range(2)]
    gens = [(torch.Generator().manual_seed(6), torch.Generator().manual_seed(7))
            for _ in range(2)]
    s1 = ts.init_train_state(models[0], device="cpu")
    step = ts.make_train_step(models[0], device="cpu")
    rows = []
    for p in params:
        s1, m = step(s1, assemble(corpus, T(p)), *gens[0])
        rows.append(m)
    s2 = ts.init_train_state(models[1], device="cpu")
    multi = ts.make_corpus_multi_step(models[1], device="cpu")
    block = {k: np.stack([p[k] for p in params]) for k in params[0]}
    s2, stacked = multi(s2, corpus, block, *gens[1])
    for key, value in models[0].state_dict().items():
        assert torch.equal(value, models[1].state_dict()[key]), key
    for key in s1.opt.mu:
        assert torch.equal(s1.opt.mu[key], s2.opt.mu[key]), key
    assert s1.step == s2.step == 3
    for key, value in stacked.items():
        assert torch.equal(value, torch.stack([r[key] for r in rows])), key
    assert bool(torch.isfinite(stacked["total_loss"]).all())
    with pytest.raises(ValueError, match="device_side_augs"):
        ts.make_corpus_multi_step(api.create_model(
            cfg.replace(device_side_augs=False, device_corpus=False),
            device="cpu"), device="cpu")


SLICE_SIZE = 96

# JAX's grads_and_aux in float64, jitted, in a fresh process (x64 is a
# process-wide switch): the package's float32 casts raised to float64 by
# binding ``jnp.float32`` to float64 before it is imported, and the ROI
# priorities drawn as the float32 run draws them (the same threefry
# bits), widened.  Reads the inputs from argv[1], writes argv[2].
_JAX_FLOAT64 = r"""
import json, sys
import jax
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_threefry_partitionable", True)
jax.config.update("jax_enable_x64", True)
import jax.numpy as jnp
import numpy as np
jnp.float32 = jnp.float64
_uniform = jax.random.uniform
def uniform(key, shape=(), dtype=None, minval=0.0, maxval=1.0):
    return _uniform(key, shape, np.float32, minval, maxval).astype(jnp.float64)
jax.random.uniform = uniform
from dis_yolo_tpu.config import DISYoloConfig
from dis_yolo_tpu.models import api
from dis_yolo_tpu.train import train_step as ts
src = np.load(sys.argv[1])
def tree(prefix):
    out = {}
    for name in src.files:
        if name.startswith(prefix):
            *path, leaf = name[len(prefix):].split("/")
            node = out
            for p in path:
                node = node.setdefault(p, {})
            v = src[name]
            node[leaf] = v.astype(np.float64) if v.dtype == np.float32 else v
    return out
cfg = DISYoloConfig(**json.loads(src["cfg"].item()))
model = api.create_model(cfg)
v, batch, keys = tree("v:"), tree("b:"), src["keys"]
grads, stats, metrics = jax.jit(
    lambda p, s, b: ts.grads_and_aux(p, s, b, keys, model))(
    v["params"], v["batch_stats"], batch)
k1 = jax.random.split(keys[0])[0]
out = {"u": np.asarray(jax.random.uniform(k1, (cfg.max_detection,)))}
for tag, t in (("g:", grads), ("s:", stats), ("m:", metrics)):
    for path, leaf in jax.tree_util.tree_flatten_with_path(t)[0]:
        out[tag + "/".join(p.key for p in path)] = np.asarray(leaf)
np.savez(sys.argv[2], **out)
"""

# XLA's CPU backend at its default optimization level computes another
# gradient of this slice than JAX op by op (and than finite differences
# of JAX's own forward): the reference runs at level 0, where the jitted
# gradient equals the op-by-op one (ROADMAP section C).
XLA_EXACT = "--xla_backend_optimization_level=0"


def start_jax_float64(src, dst, xla_flag):
    """Start ``_JAX_FLOAT64`` on the inputs in ``src`` with ``xla_flag``
    added to XLA_FLAGS.  Returns (the process, a function that waits for
    it and returns (grads, stats, metrics, the first image's ROI
    uniforms), flat, read into memory; ``dst`` is deleted then)."""
    import os
    import subprocess
    import sys
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        filter(None, (root, os.environ.get("PYTHONPATH")))),
        XLA_FLAGS=" ".join(filter(None, (os.environ.get("XLA_FLAGS"),
                                         xla_flag))))
    proc = subprocess.Popen([sys.executable, "-c", _JAX_FLOAT64, src, dst],
                            cwd=root, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)

    def wait():
        log, _ = proc.communicate(timeout=600)
        assert proc.returncode == 0, log[-3000:]
        with np.load(dst) as out:
            arrays = {k: out[k] for k in out.files}
        os.remove(dst)
        part = lambda tag: {k[2:]: v for k, v in arrays.items()
                            if k.startswith(tag)}
        return part("g:"), part("s:"), part("m:"), arrays["u"]
    return proc, wait


@pytest.fixture(scope="module", autouse=True)
def slice_case(loaders, tmp_path_factory):
    """The whole-slice case's inputs (weights, decisions, keys, draws and
    the port's assembled, augmented batch) and its two float64 JAX runs,
    started when the module starts: they take about a minute and run
    beside the module's other tests.  A run nobody waited for is killed
    at the end, and the runs' files (0.25 GB in, 0.5 GB out each) are
    deleted."""
    import json
    import shutil
    from tests.test_torch_device_augment import jax_draws
    from tests.test_torch_train import flat, jax_uniforms, random_variables
    from dis_yolo_tpu_torch.data import device_augment as da
    from dis_yolo_tpu_torch.train import train_step as ts
    cfg, port, _, _, corpus, _ = loaders
    kw = dict(KW, compute_dtype="float32", locked_layers=())
    variables = random_variables(JaxConfig(**kw), 41)
    p = dc.CorpusTrainData(cfg, "train", seed=9, corpus=port.corpus
                           )._make_batch()
    ka, kb = jax.random.split(jax.random.PRNGKey(8))
    keys = jax.random.split(kb, 2)
    u_prop, u_gt = (torch.from_numpy(u) for u in jax_uniforms(
        keys, cfg.max_detection, cfg.max_box_per_image))
    batch = ts.prepare_batch(dc.make_assemble_fn(cfg)(corpus, T(p)))
    batch = da.augment_batch(batch, jax_draws(ka, 2, SLICE_SIZE), SLICE_SIZE)
    f64_kw = dict(kw, compute_dtype="float64", param_dtype="float64")
    tmp = tmp_path_factory.mktemp("jax_f64")
    src = str(tmp / "in.npz")
    arrays = {"v:" + k: v for k, v in flat(variables)}
    arrays.update({"b:" + k: v.numpy() for k, v in batch.items()})
    np.savez(src, cfg=json.dumps(f64_kw), keys=np.asarray(keys), **arrays)
    runs = {tag: start_jax_float64(src, str(tmp / f"{tag}.npz"), flag)
            for tag, flag in (("exact", XLA_EXACT), ("default", ""))}
    yield dict(kw=kw, variables=variables, p=p, ka=ka, keys=keys,
               u_prop=u_prop, u_gt=u_gt, batch=batch,
               jax_f64={tag: wait for tag, (_, wait) in runs.items()})
    for proc, _ in runs.values():
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    shutil.rmtree(tmp, ignore_errors=True)


def rel_l2(got, want):
    """Relative L2 error per leaf and over all leaves."""
    per = {k: np.linalg.norm(got[k] - w) / np.linalg.norm(w)
           for k, w in want.items()}
    g = np.concatenate([np.ravel(got[k]) for k in want])
    w = np.concatenate([np.ravel(v) for v in want.values()])
    return per, np.linalg.norm(g - w) / np.linalg.norm(w)


def test_slice_assemble_augment_grads_match_jax(loaders, slice_case):
    """The slice as a whole at 96 px, float32, nothing locked: corpus
    assemble -> prepare -> augment -> loss and gradients.  Against JAX's
    ``make_assemble_fn`` -> ``prepare_batch`` -> ``augment_batch`` ->
    ``grads_and_aux`` on the same weights (``state_dict_from_flax``),
    decisions and the draws JAX makes from its keys: the batch the loss
    sees bit-equal (the images' uint8 values; their float32 ``/ 255``
    within 1 ulp), the metrics within rtol 1e-3 and the BN statistics
    within 1e-3 x max|ref| (``tests/test_torch_train.py``'s tolerances).

    The gradients are held against JAX's ``grads_and_aux`` in float64 on
    that batch (``_JAX_FLOAT64`` at ``XLA_EXACT``): the port's float64
    run agrees within 1e-9 (metrics, statistics and every gradient leaf:
    one function), the port's float32 run within a relative L2 error of
    1e-1 per leaf and 3e-2 over all leaves (``test_torch_train.py``'s
    tolerance).  JAX's float32 gradient and its float64 gradient at
    XLA's default optimization level are printed beside them; neither
    is a reference here (ROADMAP section C).
    """
    from dis_yolo_tpu.models import api as jax_api
    from dis_yolo_tpu.data import device_augment as jax_da
    from dis_yolo_tpu.train import train_step as jax_ts
    from dis_yolo_tpu_torch.models import api
    from dis_yolo_tpu_torch.models.weights import (flax_from_state_dict,
                                                   state_dict_from_flax)
    from dis_yolo_tpu_torch.train import train_step as ts
    from tests.test_torch_train import assert_trees_close, close, flat

    jcorpus = loaders[5]
    kw, variables, p = slice_case["kw"], slice_case["variables"], \
        slice_case["p"]
    ka, keys, batch = slice_case["ka"], slice_case["keys"], \
        slice_case["batch"]
    u_prop, u_gt = slice_case["u_prop"], slice_case["u_gt"]
    jax_f64 = slice_case["jax_f64"]
    jcfg = JaxConfig(**kw)
    jmodel = jax_api.create_model(jcfg)

    def port_grads(dtype, batch):
        model = api.create_model(DISYoloConfig(**dict(
            kw, compute_dtype=str(dtype).split(".")[1])), device="cpu")
        model.load_state_dict(state_dict_from_flax(variables))
        model.to(dtype)
        params = dict(model.named_parameters())
        grads, metrics = ts.grads_and_aux(
            model, {k: v.to(dtype) if v.is_floating_point() else v
                    for k, v in batch.items()},
            u_prop.to(dtype), u_gt.to(dtype), list(params.values()))
        model.eval()
        state = flax_from_state_dict(model.state_dict())
        grads = flax_from_state_dict(dict(zip(params, grads)))["params"]
        return dict(flat(state["batch_stats"])), dict(flat(grads)), metrics

    @jax.jit
    def jax_slice(params, stats, pj):
        b = jax_ts.prepare_batch(jax_dc.make_assemble_fn(jcfg)(jcorpus, pj))
        b = jax_da.augment_batch(ka, b, SLICE_SIZE)
        return b, jax_ts.grads_and_aux(params, stats, b, keys, jmodel)

    want_batch, (jax_g32, want_stats, want_m) = jax_slice(
        variables["params"], variables["batch_stats"],
        {k: jnp.asarray(v) for k, v in p.items()})
    for k, want in want_batch.items():
        if k == "images":      # uint8 / 255: XLA multiplies by 1/255
            np.testing.assert_allclose(batch[k].numpy(), np.asarray(want),
                                       rtol=1.2e-7, atol=0)
            want = np.round(np.asarray(want) * 255) / 255
            got = np.round(batch[k].numpy() * 255) / 255
            np.testing.assert_array_equal(got, want)
            continue
        np.testing.assert_array_equal(batch[k].numpy(), np.asarray(want),
                                      err_msg=k)
    stats, got_g, metrics = port_grads(torch.float32, batch)
    assert float(want_m["mask_loss"]) > 0
    for name in want_m:
        close(metrics[name], want_m[name], 1e-3, 1e-6, name)
    assert_trees_close(stats, dict(flat(jax.tree.map(np.asarray,
                                                     want_stats))), 0, 1e-3)

    stats64, port_g64, port_m64 = port_grads(torch.float64, batch)
    ref_g, ref_s, ref_m, ref_u = jax_f64["exact"]()
    # the float64 run drew the float32 run's ROI priorities
    np.testing.assert_array_equal(ref_u, u_prop[0].numpy())
    assert all(v.dtype == np.float64 for v in ref_g.values())
    assert set(ref_g) == set(got_g)
    for name in ref_m:
        close(port_m64[name], ref_m[name], 1e-9, 1e-12, name)
    for key in ref_s:
        close(stats64[key], ref_s[key], 1e-9, 1e-12, key)
    per64, all64 = rel_l2(port_g64, ref_g)
    per, err = rel_l2(got_g, ref_g)
    _, jax32 = rel_l2(dict(flat(jax.tree.map(np.asarray, jax_g32))), ref_g)
    dflt_g, _, dflt_m, _ = jax_f64["default"]()
    for name in ref_m:       # the forward is the same at either level
        close(dflt_m[name], ref_m[name], 1e-9, 1e-12, name)
    _, dflt = rel_l2(dflt_g, ref_g)
    print(f"gradients against JAX float64 (XLA level 0), relative L2 over "
          f"all leaves (worst leaf): port float64 {all64:.3g} "
          f"({max(per64.values()):.3g}), port float32 {err:.3g} "
          f"({max(per.values()):.3g}), JAX float32 {jax32:.3g}, JAX "
          f"float64 at XLA's default level {dflt:.3g}")
    assert max(per64.values()) <= 1e-9, per64
    for key, e in per.items():
        assert e <= 1e-1, f"{key}: relative L2 error {e}"
    assert err <= 3e-2, f"all leaves: relative L2 error {err}"
