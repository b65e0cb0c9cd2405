"""Port parity of int8 post-training quantization: ``QuantConv``,
``calibrate_deploy``, ``quantize_deploy``, the int8 graph and the weight
bridge of the deploy and int8 trees, ``dis_yolo_tpu_torch`` vs
``dis_yolo_tpu.models.quant`` on the CPU at float32.

Exact: the int8 inputs and the int32 accumulators of one QuantConv on
identical inputs, every quantized layer of the graph on the input JAX's
layer saw, the calibration statistics on identical inputs, and
``quantize_deploy``'s leaves.  Whole graphs agree within the stated
tolerances: the float layers sum in other orders, so a layer's input can
differ by an ulp between the frameworks, now and then such an ulp moves a
value across a rounding boundary of its quantization (a "flip", counted
here), and flips cascade through the int8 layers.
"""

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dis_yolo_tpu.models import api as jax_api
from dis_yolo_tpu.models import fold as jax_fold
from dis_yolo_tpu.models import quant as jax_quant
from dis_yolo_tpu_torch.models import api, fold, quant
from dis_yolo_tpu_torch.models.weights import (flax_from_state_dict,
                                               state_dict_from_flax)
from tests.test_torch_deploy import port_cfg
from tests.test_torch_model import (as_numpy_tree, assert_tree_equal,
                                    random_variables)


@pytest.fixture(scope="module", autouse=True)
def _few_torch_threads():
    """The suite runs several test files at once, one per process: keep
    torch's CPU thread pool small while this file runs."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def jax_x_q(x, inv_sx):
    return np.asarray(jnp.clip(jnp.round(jnp.asarray(x, jnp.float32) * inv_sx),
                               -127.0, 127.0).astype(jnp.int8))


@pytest.mark.parametrize("kernel,stride,cin,cout,hw", [
    (3, 1, 5, 7, (8, 8)), (3, 2, 16, 24, (9, 12)), (1, 1, 24, 8, (5, 7)),
    (2, 1, 12, 10, (6, 6)), (3, 2, 8, 16, (2, 2))])
def test_quantconv_accumulators_exact(kernel, stride, cin, cout, hw):
    """One QuantConv, same input and weights: int8 input and int32
    accumulators bit-exact against XLA's s8 x s8 -> s32 conv (the tiny
    shapes take _int_mm's zero padding); the output within float32
    rounding (rtol 1e-6: the dequant multiply-add may fuse in XLA)."""
    rng = np.random.RandomState(kernel * 100 + cin)
    x = rng.uniform(-2, 2, (2,) + hw + (cin,)).astype(np.float32)
    w = rng.randn(kernel, kernel, cin, cout).astype(np.float32)
    b = rng.randn(cout).astype(np.float32)
    absmax = float(np.abs(x).max()) * 0.8            # some inputs clip
    jq = jax_quant.quantize_deploy(
        {"params": {"layer": {"conv": {"kernel": w, "bias": b}}}},
        {"layer": absmax})["params"]["layer"]
    sd = {"layer.conv.weight": torch.from_numpy(w.transpose(3, 2, 0, 1).copy()),
          "layer.conv.bias": torch.from_numpy(b)}
    qsd = quant.quantize_deploy(sd, {"layer": absmax})
    mod = quant.QuantConv(cin, cout, kernel, stride, dtype=torch.float32)
    mod.load_state_dict({k.split(".", 1)[1]: v for k, v in qsd.items()})

    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    x_q = quant.quantize_input(xt, mod.inv_sx)
    want_xq = jax_x_q(x, jq["inv_sx"])
    np.testing.assert_array_equal(x_q.numpy(), want_xq)
    acc = quant.int8_conv(x_q, mod.w_q, stride)
    want_acc = np.asarray(jax.lax.conv_general_dilated(
        jnp.asarray(want_xq), jnp.asarray(jq["w_q"]), (stride, stride), "SAME",
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
        preferred_element_type=jnp.int32))
    assert acc.dtype == torch.int32
    np.testing.assert_array_equal(acc.numpy(), want_acc)

    jmod = jax_quant.QuantConv(features=cout, kernel=kernel, stride=stride,
                               dtype=jnp.float32)
    want = np.asarray(jmod.apply({"params": jq}, jnp.asarray(x)))
    got = mod(xt).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6,
                               atol=1e-6 * np.abs(want).max())


def test_int8_conv_exact_past_float32():
    """Sums past 2^24 (a 3x3x1024 layer at full scale: 9216 * 127^2) stay
    exact: the int32 result equals an int64 numpy sum."""
    x_q = torch.full((1, 3, 3, 1024), 127, dtype=torch.int8)
    x_q[0, 1, 1, :5] = -127
    w_q = torch.full((8, 1024, 3, 3), 127, dtype=torch.int8)
    w_q[3, 7, 1, 1] = 126
    acc = quant.int8_conv(x_q, w_q, 1)
    xp = np.pad(x_q.numpy().astype(np.int64), ((0, 0), (1, 1), (1, 1), (0, 0)))
    w = w_q.numpy().astype(np.int64).transpose(2, 3, 1, 0)
    want = sum(np.tensordot(xp[:, i:i + 3, j:j + 3], w[i, j], axes=([3], [0]))
               for i in range(3) for j in range(3))
    assert want.max() > 2 ** 24
    np.testing.assert_array_equal(acc.numpy().astype(np.int64), want)


@pytest.mark.parametrize("pct", [99.9, 50.0])
def test_calibration_statistics_exact(pct):
    """On identical inputs the recorded absmax and percentile equal JAX's:
    2.4 M elements, so the subsample is strided (every 2nd element of the
    NHWC ravel)."""
    x = np.random.RandomState(9).standard_cauchy(
        (2, 48, 48, 520)).astype(np.float32)
    jmod = jax_quant.QuantConv(features=4, kernel=1, calibrate=True,
                               calib_pct=pct, dtype=jnp.float32)
    params = jmod.init(jax.random.PRNGKey(0), jnp.zeros((1, 1, 1, 520)))
    _, inter = jax.jit(lambda v, a: jmod.apply(
        v, a, mutable=["intermediates"]))(params, jnp.asarray(x))
    got = quant.record_input_scale(torch.from_numpy(x).permute(0, 3, 1, 2),
                                   pct)
    for key in ("in_absmax", "in_pct"):
        assert float(got[key]) == float(inter["intermediates"][key][0]), key


@pytest.fixture(scope="module")
def deploy(small_cfg):
    """(JAX f32 config, numpy deploy tree, port deploy state_dict, images)
    from random ConvBN weights with random BN statistics."""
    jcfg = small_cfg.replace(compute_dtype="float32")
    variables = as_numpy_tree(random_variables(jcfg, 41))
    dv = as_numpy_tree(jax_fold.deploy_variables(variables))
    images = np.random.RandomState(42).rand(
        2, jcfg.image_size, jcfg.image_size, 3).astype(np.float32)
    return jcfg, dv, fold.deploy_variables(state_dict_from_flax(variables)), \
        images


@pytest.fixture(scope="module")
def calibrated(deploy):
    """JAX's and the port's calibration dicts (absmax and 99.9 pct)."""
    jcfg, dv, dsd, images = deploy
    jc = jax_api.create_model(jcfg.replace(quant=True, quant_calibrate=True))
    model = api.create_model(port_cfg(jcfg, quant=True, quant_calibrate=True),
                             device="cpu")
    out = {}
    for use_pct in (False, True):
        out[use_pct] = (
            jax_quant.calibrate_deploy(jc, dv, jnp.asarray(images), use_pct),
            quant.calibrate_deploy(model, dsd, images, use_pct))
    return out


@pytest.mark.parametrize("use_pct", [False, True])
def test_calibrate_deploy_matches_jax(calibrated, use_pct):
    """Same layers (the default hybrid: 5..81, no stem, no bias heads),
    scales within rtol 1e-5: each layer's input comes out of float layers
    that sum in another order than XLA's."""
    want, got = calibrated[use_pct]
    assert set(got) == set(want)
    assert "convolutional5" in got and "convolutional1" not in got
    assert "convolutional82" not in got
    for name in want:
        np.testing.assert_allclose(got[name], want[name], rtol=1e-5,
                                   err_msg=name)


def test_quantize_deploy_leaves_equal(deploy, calibrated):
    """Same deploy weights and the same calibration dict: every leaf of the
    int8 tree equal, dtypes included (w_q int8 HWIO <-> OIHW)."""
    _, dv, dsd, _ = deploy
    absmax = calibrated[False][0]
    want = as_numpy_tree(jax_quant.quantize_deploy(dv, absmax))
    got = flax_from_state_dict(quant.quantize_deploy(dsd, absmax))
    assert_tree_equal(got, want)
    for name, layer in want["params"].items():
        for leaf, value in (layer.items() if "w_q" in layer else ()):
            assert got["params"][name][leaf].dtype == value.dtype, (name, leaf)
    assert got["params"]["convolutional5"]["w_q"].dtype == np.int8
    assert set(got["params"]["convolutional1"]) == {"conv"}


def test_int8_graph_matches_jax(deploy, calibrated):
    """The int8 graph on the same int8 tree.

    Layer by layer: each port QuantConv, given the input JAX's layer saw
    (captured by method interception), gives JAX's int8 input exactly and
    JAX's output within float32 rounding.  End to end the two graphs
    drift apart the way any int8 chain does: the first quantized layer's
    input comes out of float layers with ulp-level differences, a few of
    its values flip a quantization step (at most 1e-4 of them), and each
    flip moves the next layers' inputs by a step, so flips cascade.  JAX
    against itself, with the image moved by one ulp, shows the same
    cascade; the port may be at most twice as far from JAX (flips and
    normalized MAE of each raw output) as JAX is from itself there, and
    within the JAX package's own int8 bound of 0.25
    (tests/test_quant.py).  Measured: 314716 flips of 4.17 M quantized
    values against JAX's 370791, MAE 0.009-0.026 against 0.009-0.027."""
    jcfg, dv, dsd, images = deploy
    absmax = calibrated[False][0]
    qv = as_numpy_tree(jax_quant.quantize_deploy(dv, absmax))
    jmodel = jax_api.create_model(jcfg.replace(quant=True))

    def run(v, x):
        seen = {}

        def grab(next_fun, args, kwargs, context):
            y = next_fun(*args, **kwargs)
            if (isinstance(context.module, jax_quant.QuantConv)
                    and context.method_name == "__call__"):
                seen[context.module.name] = (args[0], y)
            return y

        with nn.intercept_methods(grab):
            out = jmodel.apply(v, x, train=False)
        return out, seen

    run = jax.jit(run)
    want, jseen = run(qv, jnp.asarray(images))
    moved = np.nextafter(images, np.float32(2)).astype(np.float32)
    want_moved, jseen_moved = run(qv, jnp.asarray(moved))
    model = api.create_model(port_cfg(jcfg, quant=True), device="cpu")
    model.load_state_dict(state_dict_from_flax(qv))
    tin = {}
    for name, mod in model.named_children():
        if isinstance(mod, quant.QuantConv):
            mod.register_forward_pre_hook(
                lambda m, a, _n=name: tin.__setitem__(_n, a[0]))
    got = api.forward(model, images, device="cpu")
    assert set(tin) == set(jseen) == set(absmax)

    flips = flips_jax = total = 0
    for name, (jx, jy) in jseen.items():
        mod = getattr(model, name)
        inv = qv["params"][name]["inv_sx"]
        jx_t = torch.from_numpy(np.array(jx)).permute(0, 3, 1, 2)
        np.testing.assert_array_equal(
            quant.quantize_input(jx_t, mod.inv_sx).numpy(), jax_x_q(jx, inv))
        with torch.no_grad():
            y = mod(jx_t).permute(0, 2, 3, 1).numpy()
        jy = np.asarray(jy)
        np.testing.assert_allclose(y, jy, rtol=1e-6,
                                   atol=1e-6 * np.abs(jy).max(), err_msg=name)
        xq = jax_x_q(jx, inv)
        n = int((quant.quantize_input(tin[name], mod.inv_sx).numpy()
                 != xq).sum())
        if name == "convolutional5":
            assert n <= 1e-4 * xq.size, n
        flips += n
        flips_jax += int((jax_x_q(jseen_moved[name][0], inv) != xq).sum())
        total += xq.size
    print(f"int8 graph: {flips} of {total} quantized inputs flip against "
          f"JAX ({flips_jax} for JAX against itself, image moved 1 ulp)")
    assert flips <= 2 * flips_jax
    for i, (g, w, m) in enumerate(zip(got, want, want_moved)):
        g, w, m = (np.asarray(a, np.float64) for a in (g, w, m))
        assert g.shape == w.shape
        scale = np.abs(w).mean() + 1e-6
        mae, mae_jax = np.abs(g - w).mean() / scale, np.abs(m - w).mean() / scale
        assert mae <= 2 * mae_jax and mae < 0.25, (i, mae, mae_jax)


def test_deploy_and_quant_trees_round_trip(deploy, calibrated):
    """The bridge carries the deploy tree ({params} only) and the int8 tree
    both ways, and each loads strictly into its port graph."""
    jcfg, dv, _, _ = deploy
    qv = as_numpy_tree(jax_quant.quantize_deploy(dv, calibrated[False][0]))
    for tree, graph in ((dv, dict(deploy=True)), (qv, dict(quant=True))):
        sd = state_dict_from_flax(tree)
        back = flax_from_state_dict(sd)
        assert set(back) == {"params"}
        assert_tree_equal(back, tree)
        model = api.create_model(port_cfg(jcfg, **graph), device="cpu")
        model.load_state_dict(sd)
        again = model.state_dict()
        assert set(again) == set(sd)
        for key in sd:
            assert again[key].dtype == sd[key].dtype
            assert torch.equal(again[key], sd[key]), key
    assert state_dict_from_flax(qv)["convolutional5.w_q"].dtype == torch.int8


def test_int8_graph_serves_and_calibrates_threshold(deploy, calibrated):
    """predict and calibrate_threshold on the int8 graph (CPU)."""
    from dis_yolo_tpu_torch.utils.runtime import calibrate_threshold

    jcfg, _, dsd, images = deploy
    cfg = port_cfg(jcfg, quant=True)
    model = api.create_model(cfg, device="cpu")
    model.load_state_dict(quant.quantize_deploy(dsd, calibrated[True][1]))
    thresh = calibrate_threshold(model, torch.from_numpy(images[:1]), cfg)
    dets, masks = api.predict(model, images, np.array(
        [[0.0, 0.0, 1.0, 1.0]] * 2, np.float32), thresh, device="cpu")
    assert tuple(dets.shape) == (2, cfg.max_detection, 6)
    assert tuple(masks.shape) == (2, cfg.max_detection, 48, 48)
    assert bool(torch.isfinite(dets).all()) and bool((dets[0, :, 5] > 0).any())
