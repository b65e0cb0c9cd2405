"""Port parity of the float serving graphs: BN folding, the deploy graph,
the commuted decoder and the space-to-depth stem, ``dis_yolo_tpu_torch``
vs ``dis_yolo_tpu`` on the same weights, on the CPU at float32 and
``small_cfg``'s 96 px.

Exact: the folded and deploy weights (same float32 ops in the same
order), ``space_to_depth`` and the s2d kernel transform.  Forward outputs
within rtol=1e-4, atol=1e-4*max(1, max|ref|), the tolerance of
``test_torch_model.py``'s forward parity (convolutions sum in other
orders in the two frameworks).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from dis_yolo_tpu.models import api as jax_api
from dis_yolo_tpu.models import fold as jax_fold
from dis_yolo_tpu.models import s2d as jax_s2d
from dis_yolo_tpu_torch.config import DISYoloConfig
from dis_yolo_tpu_torch.models import api, fold, s2d
from dis_yolo_tpu_torch.models.layers import _same_pad, conv_same
from dis_yolo_tpu_torch.models.weights import (flax_from_state_dict,
                                               state_dict_from_flax)
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


@pytest.fixture(scope="module")
def setup(small_cfg):
    """(JAX f32 config, numpy ConvBN tree with random BN, torch
    state_dict, images [2,96,96,3])."""
    jcfg = small_cfg.replace(compute_dtype="float32")
    variables = as_numpy_tree(random_variables(jcfg, 31))
    images = np.random.RandomState(32).rand(
        2, jcfg.image_size, jcfg.image_size, 3).astype(np.float32)
    return jcfg, variables, state_dict_from_flax(variables), images


def port_cfg(jcfg, **kw):
    """The port's float32 config with ``jcfg``'s sizes, plus ``kw``."""
    return DISYoloConfig(image_size=jcfg.image_size, test_size=jcfg.test_size,
                         batch_size=jcfg.batch_size,
                         pre_nms_top_k=jcfg.pre_nms_top_k,
                         compute_dtype="float32", **kw)


def assert_outputs_close(got, want):
    assert len(got) == len(want) == 4
    for i, (g, w) in enumerate(zip(got, want)):
        w = np.asarray(w)
        assert g.dtype == torch.float32 and tuple(g.shape) == w.shape
        np.testing.assert_allclose(
            g.numpy(), w, rtol=1e-4, atol=1e-4 * max(1.0, np.abs(w).max()),
            err_msg=f"output {i}")


def run_both(jcfg, jvars, sd, images, **graph):
    """Forward of the graph ``graph`` in JAX (``jvars``) and in the port
    (``sd``, loaded strictly)."""
    jmodel = jax_api.create_model(jcfg.replace(**graph))
    want = jax.jit(lambda v, x: jmodel.apply(v, x, train=False))(
        jvars, jnp.asarray(images))
    model = api.create_model(port_cfg(jcfg, **graph), device="cpu")
    model.load_state_dict(sd)
    return api.forward(model, images, device="cpu"), want


def test_fold_batchnorm_bit_equal(setup):
    """fold_batchnorm on the state_dict == JAX's on the Flax tree, leaf for
    leaf, bit for bit; bias convs untouched."""
    jcfg, variables, sd, _ = setup
    want = as_numpy_tree(jax_fold.fold_batchnorm(
        jax_api.create_model(jcfg), variables))
    got = flax_from_state_dict(fold.fold_batchnorm(sd))
    assert_tree_equal(got, want)
    assert torch.equal(fold.fold_batchnorm(sd)["convolutional82.conv.bias"],
                       sd["convolutional82.conv.bias"])


def test_deploy_variables_bit_equal(setup):
    """deploy_variables: {params} only, conv/{kernel, bias} per layer, bit
    for bit JAX's."""
    _, variables, sd, _ = setup
    want = as_numpy_tree(jax_fold.deploy_variables(variables))
    got = flax_from_state_dict(fold.deploy_variables(sd))
    assert set(got) == {"params"}
    assert_tree_equal(got, want)
    for name, layer in got["params"].items():
        assert set(layer) == {"conv"} and set(layer["conv"]) == {"kernel",
                                                                  "bias"}, name


def test_bench_graph_forward_parity(setup):
    """The JAX package's bench graph: decoder_commute + fold_batchnorm."""
    jcfg, variables, sd, images = setup
    jvars = as_numpy_tree(jax_fold.fold_batchnorm(
        jax_api.create_model(jcfg), variables))
    got, want = run_both(jcfg, jvars, fold.fold_batchnorm(sd), images,
                         decoder_commute=True)
    assert_outputs_close(got, want)


def test_decoder_commute_forward_parity(setup):
    """decoder_commute with the unfolded ConvBN tree: the commuted decoder
    nodes take the ConvBN's parameters, against JAX and against the
    port's own concat form."""
    jcfg, variables, sd, images = setup
    got, want = run_both(jcfg, variables, sd, images, decoder_commute=True)
    assert_outputs_close(got, want)
    model = api.create_model(port_cfg(jcfg), device="cpu")
    model.load_state_dict(sd)
    assert_outputs_close(got, api.forward(model, images, device="cpu"))


def test_deploy_forward_parity(setup):
    jcfg, variables, sd, images = setup
    jvars = as_numpy_tree(jax_fold.deploy_variables(variables))
    got, want = run_both(jcfg, jvars, fold.deploy_variables(sd), images,
                         deploy=True)
    assert_outputs_close(got, want)


def test_space_to_depth_exact():
    """The port's NCHW space_to_depth, on the NHWC view, is JAX's on the
    same NHWC input: the (a, b, ch) packing, bit for bit."""
    x = np.random.RandomState(3).randn(2, 6, 10, 3).astype(np.float32)
    want = np.asarray(jax_s2d.space_to_depth(jnp.asarray(x)))
    got = s2d.space_to_depth(torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(), want)
    # channel (a*2 + b)*C + ch of block (i, j) is pixel (2i+a, 2j+b)
    assert got[1, (1 * 2 + 0) * 3 + 2, 2, 4] == x[1, 5, 8, 2]


def test_s2d_stem_kernels_exact():
    """The numpy kernel transform is the JAX package's, on odd channel
    counts (s2d_stem_variables is checked in test_s2d_forward_parity)."""
    rng = np.random.RandomState(4)
    w1, b1 = rng.randn(3, 3, 3, 5).astype(np.float32), rng.randn(5)
    w2, b2 = rng.randn(3, 3, 5, 7).astype(np.float32), rng.randn(7)
    for g, w in zip(s2d.s2d_stem_kernels(w1, b1, w2, b2),
                    jax_s2d.s2d_stem_kernels(w1, b1, w2, b2)):
        assert g.shape == w.shape
        np.testing.assert_array_equal(g, w)


def test_conv_same_pads_two_wide_kernel_low0_high1():
    """conv2' is a 2x2 stride-1 conv padded (0, 1): what conv_same gives a
    2-wide kernel, and XLA's 'SAME'."""
    assert _same_pad(288, 2, 1) == (0, 1) and _same_pad(5, 2, 1) == (0, 1)
    rng = np.random.RandomState(5)
    x = rng.randn(1, 4, 5, 5).astype(np.float32)
    w = rng.randn(3, 4, 2, 2).astype(np.float32)
    got = conv_same(torch.from_numpy(x), torch.from_numpy(w), None, 1)
    want = F.conv2d(F.pad(torch.from_numpy(x), (0, 1, 0, 1)),
                    torch.from_numpy(w))
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    jx = jax.lax.conv_general_dilated(
        jnp.asarray(x.transpose(0, 2, 3, 1)), jnp.asarray(w.transpose(2, 3, 1, 0)),
        (1, 1), "SAME", dimension_numbers=("NHWC", "HWIO", "NHWC"))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), np.asarray(jx),
                               rtol=1e-5, atol=1e-5)


def test_s2d_forward_parity(setup):
    """The s2d graph against JAX's on JAX's transformed tree (the bridge
    carries the 3x3x12x128 and 2x2x128x64 kernels), and against the
    port's own deploy graph."""
    jcfg, variables, sd, images = setup
    jvars = as_numpy_tree(jax_s2d.s2d_stem_variables(
        jax_fold.deploy_variables(variables)))
    ssd = s2d.s2d_stem_variables(fold.deploy_variables(sd))
    assert_tree_equal(flax_from_state_dict(ssd), jvars)
    assert tuple(ssd["convolutional1.conv.weight"].shape) == (128, 12, 3, 3)
    assert tuple(ssd["convolutional2.conv.weight"].shape) == (64, 128, 2, 2)
    got, want = run_both(jcfg, jvars, state_dict_from_flax(jvars), images,
                         deploy=True, s2d_stem=True)
    assert_outputs_close(got, want)
    model = api.create_model(port_cfg(jcfg, deploy=True), device="cpu")
    model.load_state_dict(fold.deploy_variables(sd))
    assert_outputs_close(got, api.forward(model, images, device="cpu"))


@pytest.mark.parametrize("graph", [dict(s2d_stem=True),
                                   dict(s2d_stem=True, deploy=True,
                                        mask_stride=1)])
def test_s2d_value_errors(small_cfg, graph):
    """s2d_stem without deploy, or with mask_stride 1, raises ValueError,
    in the port as in JAX."""
    with pytest.raises(ValueError, match="s2d_stem requires deploy"):
        jax_api.init_variables(small_cfg.replace(**graph),
                               jax.random.PRNGKey(0))
    with pytest.raises(ValueError, match="s2d_stem requires deploy"):
        api.create_model(port_cfg(small_cfg, **graph), device="cpu")
