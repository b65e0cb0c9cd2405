"""Port parity of the channel extraction (kernel K4's plain version) and of
the single-image assembly ``assemble_masks_cuda`` with and without it,
against ``dis_yolo_tpu.ops.pallas_assembly`` (``_extract_planes`` and
``assemble_masks_pallas(..., use_extract=True)`` in interpret mode), on
the CPU.  Score maps in bf16 and f32; the extraction and the logits are
bit-exact, the sigmoid within 1e-6 (the Pallas sigmoid and the port's
``1/(1+exp(-x))`` may differ by an ulp) and exactly 0 outside the box.
"""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from dis_yolo_tpu.ops import mask_assembly as jax_ma
from dis_yolo_tpu.ops.pallas_assembly import (_extract_planes,
                                              assemble_masks_pallas)
from dis_yolo_tpu_torch.ops.cuda_assembly import (assemble_masks_batch_cuda,
                                                  assemble_masks_cuda,
                                                  extract_planes_cuda,
                                                  extract_planes_plain)


@pytest.fixture(scope="module", autouse=True)
def _few_torch_threads():
    """The suite runs several test files at once, one per process: keep
    torch's CPU thread pool small while this file runs."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def to_torch(x: np.ndarray) -> torch.Tensor:
    """numpy f32 or ml_dtypes bf16 -> torch, same bits."""
    if x.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(x.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(x))


def scoremap(rng, s, k, dtype):
    """[S,S,k*k] in ``dtype``; f32 maps carry values no bf16 holds."""
    sm = rng.randn(s, s, k * k).astype(np.float32)
    return sm.astype(ml_dtypes.bfloat16) if dtype == "bfloat16" else sm


@pytest.fixture(scope="module")
def case(rng=np.random.RandomState(7)):
    """test_pallas_assembly.py's case: S=64, k=3, D=12, 2 padding rows."""
    S, k, D = 64, 3, 12
    sm = rng.randn(S, S, k * k).astype(np.float32)
    b = rng.uniform(0, 1, (D, 4)).astype(np.float32)
    boxes = np.stack([np.minimum(b[:, 0], b[:, 2]), np.minimum(b[:, 1], b[:, 3]),
                      np.maximum(b[:, 0], b[:, 2]), np.maximum(b[:, 1], b[:, 3])],
                     axis=1)
    boxes[-2:] = 0.0   # padding rows
    return sm, boxes, k


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
# S=37: rows off the 16-byte grid for kernel K4; k=1: one plane
@pytest.mark.parametrize("s,k", [(64, 3), (40, 5), (24, 7), (37, 3), (16, 1)])
def test_extract_plain_matches_pallas(s, k, dtype):
    """extract_planes_plain == _extract_planes(interpret=True) bit for bit,
    one image and a batch of two; the wrapper on CPU tensors launches
    nothing."""
    rng = np.random.RandomState(s + k)
    sms = [scoremap(rng, s, k, dtype) for _ in range(2)]
    want = [np.asarray(_extract_planes(jnp.asarray(sm.reshape(s, s * k * k)),
                                       k, interpret=True)) for sm in sms]
    assert all(w.dtype == np.float32 for w in want)
    sm2d = torch.stack([to_torch(sm).reshape(s, s * k * k) for sm in sms])
    before = extract_planes_cuda.launches
    got = extract_planes_cuda(sm2d, k)
    assert extract_planes_cuda.launches == before
    assert got.dtype == torch.float32 and tuple(got.shape) == (2, k * k, s, s)
    np.testing.assert_array_equal(got.numpy(), np.stack(want))
    np.testing.assert_array_equal(extract_planes_plain(sm2d[:1], k).numpy(),
                                  want[0][None])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_extract_plain_on_offset_view(dtype):
    """extract_planes_plain, and the wrapper's CPU route, on a contiguous
    view one element into its storage (for kernel K4 a pointer off the
    16-byte grid) equal it on the same values unshifted."""
    rng = np.random.RandomState(11)
    s, k = 37, 3
    flat = to_torch(np.stack([scoremap(rng, s, k, dtype)
                              for _ in range(2)]).reshape(-1))
    view = torch.cat([flat[:1], flat])[1:].view(2, s, s * k * k)
    assert view.storage_offset() == 1 and view.is_contiguous()
    want = extract_planes_plain(flat.view(2, s, s * k * k), k).numpy()
    np.testing.assert_array_equal(extract_planes_plain(view, k).numpy(), want)
    np.testing.assert_array_equal(extract_planes_cuda(view, k).numpy(), want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("use_extract", [False, True])
def test_assemble_masks_cuda_matches_pallas_extract(case, use_extract, dtype):
    """assemble_masks_cuda, both routes, against assemble_masks_pallas(
    interpret=True, use_extract=True): logits bit-exact, and equal to the
    JAX gather path; sigmoid within 1e-6 inside the box, 0 outside."""
    sm, boxes, k = case
    if dtype == "bfloat16":
        sm = sm.astype(ml_dtypes.bfloat16)
    want = np.asarray(assemble_masks_pallas(
        jnp.asarray(sm), jnp.asarray(boxes), k, apply_sigmoid=False,
        interpret=True, use_extract=True))
    got = assemble_masks_cuda(to_torch(sm), torch.from_numpy(boxes), k,
                              apply_sigmoid=False, use_extract=use_extract)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(want, np.asarray(jax_ma.assemble_masks(
        jnp.asarray(sm, jnp.float32), jnp.asarray(boxes), k)))
    want_p = np.asarray(assemble_masks_pallas(
        jnp.asarray(sm), jnp.asarray(boxes), k, apply_sigmoid=True,
        interpret=True, use_extract=True))
    probs = assemble_masks_cuda(to_torch(sm), torch.from_numpy(boxes), k,
                                use_extract=use_extract).numpy()
    np.testing.assert_allclose(probs, want_p, rtol=0, atol=1e-6)
    inside = want != 0
    assert (probs[~inside] == 0).all() and (probs[inside] > 0).all()
    assert not probs[-2:].any()                     # padding rows


@pytest.mark.parametrize("k", [3, 5])
def test_planes_layout_equals_nhwc(k):
    """K1's plain version on channel planes equals it on the NHWC map, for
    a batch of two (the layout K4 hands to K1)."""
    rng = np.random.RandomState(20 + k)
    sms = np.stack([scoremap(rng, 32, k, "float32") for _ in range(2)])
    b = rng.uniform(0, 1, (2, 6, 4)).astype(np.float32)
    boxes = np.concatenate([np.minimum(b[..., :2], b[..., 2:]),
                            np.maximum(b[..., :2], b[..., 2:])], -1)
    boxes[:, -1] = 0.0
    planes = torch.from_numpy(sms).permute(0, 3, 1, 2).contiguous()
    for sig in (False, True):
        want = assemble_masks_batch_cuda(torch.from_numpy(sms),
                                         torch.from_numpy(boxes), k, sig)
        got = assemble_masks_batch_cuda(planes, torch.from_numpy(boxes), k,
                                        sig, planes=True)
        assert torch.equal(got, want)
    with pytest.raises(ValueError, match=rf"\[B,{k * k},S,S\]"):
        assemble_masks_batch_cuda(torch.from_numpy(sms),
                                  torch.from_numpy(boxes), k, planes=True)
