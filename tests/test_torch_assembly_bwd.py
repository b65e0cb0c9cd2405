"""Port parity of the mask assembly's training path: the plain version of
kernel K3 (``assemble_bwd_plain``), K1's pixel-box mode and the port's
``assemble_masks_trainable`` against the JAX package's custom-VJP
assembly, whose Pallas kernels run in interpret mode, on the CPU.

Everything is compared bit for bit: every logit is a copy of a score-map
value, and the backward adds the ROIs' gradients pixel by pixel in
ascending ROI order from 0, as the Pallas backward does.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dis_yolo_tpu.ops.pallas_assembly import (_assembly_bwd,
                                              assemble_masks_trainable as
                                              jax_trainable)
from dis_yolo_tpu_torch.ops.cuda_assembly import (assemble_bwd_cuda,
                                                  assemble_masks_trainable)
from dis_yolo_tpu_torch.ops.custom_ops import assemble_masks_batch_cuda
from dis_yolo_tpu_torch.ops.mask_assembly import assemble_bwd_plain


@pytest.fixture(scope="module", autouse=True)
def _few_torch_threads():
    """The suite runs several test files at once, one per process: keep
    torch's CPU thread pool small while this file runs."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def T(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def px_boxes(rng, b, r, s, n_zero):
    """[b,r,4] rounded yxyx pixel boxes; the last ``n_zero`` ROIs of each
    image are zero boxes (a padded proposal), one is inverted."""
    u = rng.uniform(0, 1, (b, r, 4)).astype(np.float32)
    y1, y2 = np.minimum(u[..., 0], u[..., 2]), np.maximum(u[..., 0], u[..., 2])
    x1, x2 = np.minimum(u[..., 1], u[..., 3]), np.maximum(u[..., 1], u[..., 3])
    boxes = np.round(np.stack([y1, x1, y2, x2], -1) * np.float32(s))
    boxes[:, 0] = boxes[:, 0, [2, 1, 0, 3]]          # y2 < y1: empty
    boxes[:, r - n_zero:] = 0.0
    return boxes.astype(np.float32)


def case(seed, b, r, s, k, layout="random", n_zero=2):
    """Score maps, ROIs and upstream gradient.  ``layout``: "random" is
    ``px_boxes``; "upright" has no zero box and un-inverts the first ROI;
    "full" has no zero box and makes ROI 1 the whole map."""
    rng = np.random.RandomState(seed)
    sm = rng.randn(b, s, s, k * k).astype(np.float32)
    boxes = px_boxes(rng, b, r, s, n_zero if layout == "random" else 0)
    if layout == "upright":
        boxes[:, 0] = boxes[:, 0, [2, 1, 0, 3]]
    elif layout == "full":
        boxes[:, 1] = [0.0, 0.0, s, s]
    g = rng.randn(b, r, s, s).astype(np.float32)
    return sm, boxes, g


def param(seed, b, r, s, k, layout="random"):
    """One case, named by its numbers (and its layout unless random)."""
    name = "-".join(map(str, (seed, b, r, s, k)))
    return pytest.param(seed, b, r, s, k, layout,
                        id=name if layout == "random" else f"{name}-{layout}")


CASES = [param(31, 2, 10, 64, 3), param(32, 2, 10, 64, 5),
         param(33, 1, 10, 64, 7),
         # S=576: the Pallas backward takes its row-tiled layout
         param(34, 1, 4, 576, 3),
         # the edges of kernel K3's design: a row length off the 16-byte
         # grid (S=37), k=1, a single ROI, a ROI over the whole map
         param(36, 2, 10, 37, 3), param(37, 2, 10, 32, 1),
         param(38, 2, 1, 32, 3, "upright"), param(39, 1, 10, 40, 3, "full")]


@pytest.mark.parametrize("seed,b,r,s,k,layout", CASES)
def test_bwd_plain_bit_exact_vs_pallas(seed, b, r, s, k, layout):
    """assemble_bwd_plain == _assembly_bwd(interpret=True), transposed
    back to [S,S,k*k], image by image."""
    sm, boxes, g = case(seed, b, r, s, k, layout)
    got = assemble_bwd_plain(T(boxes), T(g), k).numpy()
    assert got.shape == (b, s, s, k * k) and got.any()
    for i in range(b):
        want = _assembly_bwd((k * k, s, s), jnp.asarray(boxes[i]),
                             jnp.asarray(g[i]), k, interpret=True)
        np.testing.assert_array_equal(
            got[i], np.transpose(np.asarray(want), (1, 2, 0)))
    # the wrapper takes the plain version for CPU tensors
    np.testing.assert_array_equal(
        assemble_bwd_cuda(T(boxes), T(g), k).numpy(), got)


@pytest.mark.parametrize("seed,b,r,s,k,layout", CASES[:3])
def test_trainable_forward_and_grad_bit_exact(seed, b, r, s, k, layout):
    """The port's autograd.Function against the JAX custom VJP (Pallas in
    interpret mode): logits, and the score-map gradient of sum(logits*w),
    bit for bit; the boxes' gradient is zero."""
    sm, boxes, g = case(seed, b, r, s, k, layout)
    sm_t = T(sm).requires_grad_(True)
    boxes_t = T(boxes).requires_grad_(True)
    logits = assemble_masks_trainable(sm_t, boxes_t, k)
    (logits * T(g)).sum().backward()
    # K1 in pixel-box mode (CPU: its plain version) gives the same logits
    np.testing.assert_array_equal(
        assemble_masks_batch_cuda(T(sm), T(boxes), k, apply_sigmoid=False,
                                  pixel_boxes=True).numpy(),
        logits.detach().numpy())
    assert not boxes_t.grad.any()

    @jax.jit
    def fwd_bwd(x, bpx, w):
        out, vjp = jax.vjp(lambda x: jax_trainable(x, bpx, k, True), x)
        return out, vjp(w)[0]

    for i in range(b):
        want_f, want_g = fwd_bwd(jnp.asarray(sm[i]), jnp.asarray(boxes[i]),
                                 jnp.asarray(g[i]))
        np.testing.assert_array_equal(logits[i].detach().numpy(),
                                      np.asarray(want_f))
        np.testing.assert_array_equal(sm_t.grad[i].numpy(), np.asarray(want_g))


def test_pixel_mode_equals_normalized_mode_on_rounded_boxes():
    """K1's plain version: normalized boxes rounded by the wrapper and the
    same boxes given already rounded give the same logits."""
    rng = np.random.RandomState(35)
    s, k = 48, 3
    sm = T(rng.randn(2, s, s, k * k).astype(np.float32))
    norm = T(rng.uniform(0, 1, (2, 6, 4)).astype(np.float32))
    px = torch.round(norm * s)
    a = assemble_masks_batch_cuda(sm, norm, k, apply_sigmoid=False)
    b = assemble_masks_batch_cuda(sm, px, k, apply_sigmoid=False,
                                  pixel_boxes=True)
    assert torch.equal(a, b)
