"""Port parity: ``dis_yolo_tpu_torch`` DISYolo + weight bridge vs the JAX
``DISYolo`` with the same weights, on the CPU at float32.

Every parameter and BN statistic is drawn with numpy (BN scale/bias/mean/
var included, so a swapped field cannot hide behind the default init) and
handed to both sides.  JAX only traces ``init`` (``jax.eval_shape``) for
the tree's shapes and compiles one ``apply`` per (config, size).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dis_yolo_tpu.config import DISYoloConfig as JaxConfig
from dis_yolo_tpu.models import api as jax_api
from dis_yolo_tpu_torch.config import DISYoloConfig
from dis_yolo_tpu_torch.models import api
from dis_yolo_tpu_torch.models.weights import (flax_from_state_dict,
                                               state_dict_from_flax)


@pytest.fixture(scope="module", autouse=True)
def _few_torch_threads():
    """The suite runs several test files at once, one per process: keep
    torch's CPU thread pool small while this file runs."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def random_variables(jcfg, seed):
    """Flax {params, batch_stats} for ``jcfg``, every leaf drawn with numpy:
    xavier-uniform kernels, small random head biases, BN scale in
    [0.5, 1.5], bias/mean ~ 0.1 N(0,1), var in [0.5, 1.5]."""
    model = jax_api.create_model(jcfg)
    shapes = jax.eval_shape(
        lambda: model.init(jax.random.PRNGKey(0),
                           jnp.zeros((1, 64, 64, 3), jnp.float32)))
    rng = np.random.RandomState(seed)

    def draw(path, leaf):
        name = path[-1].key
        shape = leaf.shape
        if name == "kernel":
            fan = shape[0] * shape[1] * (shape[2] + shape[3])
            lim = np.sqrt(6.0 / fan)
            return rng.uniform(-lim, lim, shape).astype(np.float32)
        if name in ("scale", "var"):
            return rng.uniform(0.5, 1.5, shape).astype(np.float32)
        return (0.1 * rng.randn(*shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def as_numpy_tree(tree):
    return jax.tree.map(np.asarray, tree)


def assert_tree_equal(a, b):
    assert set(a) == set(b)
    for key in a:
        if isinstance(a[key], dict):
            assert_tree_equal(a[key], b[key])
        else:
            np.testing.assert_array_equal(np.asarray(a[key]),
                                          np.asarray(b[key]), err_msg=key)


@pytest.fixture(scope="module")
def bridged():
    """(JAX model, numpy variables, torch model) per mask_stride."""
    built = {}

    def get(mask_stride):
        if mask_stride not in built:
            kw = dict(image_size=64, compute_dtype="float32",
                      mask_stride=mask_stride)
            jcfg = JaxConfig(**kw)
            variables = as_numpy_tree(random_variables(jcfg, 10 + mask_stride))
            model = api.create_model(DISYoloConfig(**kw), device="cpu")
            model.load_state_dict(state_dict_from_flax(variables))
            built[mask_stride] = (jax_api.create_model(jcfg), variables, model)
        return built[mask_stride]

    return get


def test_weight_bridge_round_trip(bridged):
    """flax -> state_dict -> flax is the identity, leaf for leaf, and the
    state_dict loads strictly into the torch model."""
    _, variables, model = bridged(2)
    back = flax_from_state_dict(state_dict_from_flax(variables))
    assert_tree_equal(back, {"params": dict(variables["params"]),
                             "batch_stats": dict(variables["batch_stats"])})
    # and torch -> flax -> torch through the live module
    sd = model.state_dict()
    again = state_dict_from_flax(flax_from_state_dict(sd))
    assert list(again) == list(sd)
    for key in sd:
        torch.testing.assert_close(again[key], sd[key], rtol=0, atol=0)


@pytest.mark.parametrize("mask_stride,size",
                         [(2, 64), (2, 96), (1, 64), (4, 64)])
def test_forward_parity_f32(bridged, mask_stride, size):
    """All four outputs (3 raw heads + score maps) match JAX at f32 within
    rtol=1e-4, atol=1e-4*max(1, max|ref|).  Measured on the CPU: max abs
    error 1.6e-5 (96 px, raw_s32, max|ref| 4.9); at most 3.3e-6 of
    max|ref| on any output of the four cases."""
    jmodel, variables, model = bridged(mask_stride)
    images = np.random.RandomState(size + mask_stride).rand(
        2, size, size, 3).astype(np.float32)
    want = jax.jit(lambda v, x: jmodel.apply(v, x, train=False))(
        variables, jnp.asarray(images))
    got = api.forward(model, images, device="cpu")
    assert len(got) == len(want) == 4
    for i, (g, w) in enumerate(zip(got, want)):
        w = np.asarray(w)
        assert g.dtype == torch.float32 and tuple(g.shape) == w.shape
        np.testing.assert_allclose(
            g.numpy(), w, rtol=1e-4, atol=1e-4 * max(1.0, np.abs(w).max()),
            err_msg=f"output {i}")


def test_init_model_is_seeded_and_flax_like():
    """init_model: same seed, same weights; xavier-uniform bounds; BN and
    bias at Flax's initial values."""
    cfg = DISYoloConfig(image_size=64)
    a = api.init_model(cfg, seed=3, device="cpu")
    b = api.init_model(cfg, seed=3, device="cpu")
    c = api.init_model(cfg, seed=4, device="cpu")
    for (key, va), vb, vc in zip(a.state_dict().items(),
                                 b.state_dict().values(),
                                 c.state_dict().values()):
        torch.testing.assert_close(va, vb, rtol=0, atol=0)
        if key.endswith("conv.weight"):
            cout, cin, kh, kw = va.shape
            assert va.abs().max() <= np.sqrt(6.0 / (kh * kw * (cin + cout)))
            assert not torch.equal(va, vc)
    w = flax_from_state_dict(a.state_dict())
    assert np.all(w["params"]["convolutional1"]["bn"]["scale"] == 1.0)
    assert np.all(w["batch_stats"]["convolutional1"]["bn"]["var"] == 1.0)
    assert np.all(w["params"]["convolutional59"]["conv"]["bias"] == 0.0)


def test_config_copy_matches_jax_config():
    """The port's DISYoloConfig is a field-for-field copy of the JAX one:
    same names, defaults and derived values."""
    import dataclasses
    fields = [(f.name, f.default) for f in dataclasses.fields(JaxConfig)]
    assert fields == [(f.name, f.default)
                      for f in dataclasses.fields(DISYoloConfig)]
    for kw in ({}, dict(image_size=96, mask_stride=4, k_map=5)):
        j, t = JaxConfig(**kw), DISYoloConfig(**kw)
        for name in ("num_class", "base_grid", "mask_size", "num_scoremaps",
                     "output_depth"):
            assert getattr(j, name) == getattr(t, name), name
        assert j.grid_sizes() == t.grid_sizes()
        assert j.snapshot() == t.snapshot()
        np.testing.assert_array_equal(j.anchors_array(), t.anchors_array())
        assert t.replace(k_map=7).num_scoremaps == 49


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_ignores_the_batch_stride_of_one_image(dtype):
    """A batch of one made with a numpy newaxis (batch stride 0) and the
    same image in a row-major batch give the same bits: the forward takes
    its input to row-major strides, so PyTorch picks the same conv
    kernels for both (at float32 on the CPU they differed by ~1e-7)."""
    model = api.init_model(DISYoloConfig(image_size=64, compute_dtype=dtype),
                           7, device="cpu")
    image = np.random.RandomState(0).rand(64, 64, 3).astype(np.float32)
    assert torch.from_numpy(image[None]).stride(0) == 0
    batch = np.zeros((1, 64, 64, 3), np.float32)
    batch[0] = image
    for a, b in zip(api.forward(model, image[None], device="cpu"),
                    api.forward(model, batch, device="cpu")):
        assert torch.equal(a, b)
