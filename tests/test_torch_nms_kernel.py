"""K2's contract at its edges: the plain version (``nms_cuda`` on CPU
tensors) index-exact against the TPU kernel (``nms_pallas`` in interpret
mode) and the JAX ``_select_suppress_nms``, on inputs the main path never
gives it: unsorted scores, NaN and -inf scores, K=1 and max_det > K.
Inputs come from numpy seeds; tolerance: exact indices.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dis_yolo_tpu.ops import nms as jax_nms
from dis_yolo_tpu.ops.pallas_nms import nms_pallas
from dis_yolo_tpu_torch.ops.custom_ops import nms_cuda
from dis_yolo_tpu_torch.utils.profiling import counters


@pytest.fixture(scope="module", autouse=True)
def _few_torch_threads():
    """The suite runs several test files at once, one per process: keep
    torch's CPU thread pool small while this file runs."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _candidates(seed, k):
    """Score-sorted overlapping boxes of 3 classes, scores on a 1/16 grid
    (ties), about half of them valid."""
    rng = np.random.RandomState(seed)
    lo = rng.uniform(0, 0.7, (k, 2)).astype(np.float32)
    hw = rng.uniform(0.1, 0.3, (k, 2)).astype(np.float32)
    boxes = np.concatenate([lo, lo + hw], 1)
    scores = np.sort(np.round(rng.uniform(0, 1, k) * 16) / 16)[::-1]
    scores = scores.astype(np.float32)
    classes = rng.randint(0, 3, k).astype(np.int32)
    return boxes, scores, classes, scores > 0.4


def _unsorted(seed, k):
    boxes, scores, classes, valid = _candidates(seed, k)
    perm = np.random.RandomState(seed + 1).permutation(k)
    return boxes[perm], scores[perm], classes[perm], valid[perm]


def _with_score(seed, k, at, value, valid_there):
    boxes, scores, classes, valid = _candidates(seed, k)
    scores[at], valid[at] = value, valid_there
    return boxes, scores, classes, valid


CASES = {
    # name: (candidates, max_det, every pick -1)
    "unsorted": (lambda: _unsorted(1, 64), 20, False),
    "valid_nan": (lambda: _with_score(2, 64, 7, np.nan, True), 20, True),
    "invalid_nan": (lambda: _with_score(3, 64, 7, np.nan, False), 20, False),
    "valid_neg_inf_inside": (lambda: _with_score(4, 64, 3, -np.inf, True), 20,
                             False),
    "valid_neg_inf_last": (lambda: _with_score(5, 64, 63, -np.inf, True), 64,
                           False),
    "k1": (lambda: _with_score(6, 1, 0, 0.9, True), 5, False),
    "k1_valid_nan": (lambda: _with_score(7, 1, 0, np.nan, True), 5, True),
    "max_det_above_k": (lambda: _candidates(8, 16), 40, False),
    "max_det_1": (lambda: _unsorted(9, 64), 1, False),
}


@pytest.mark.parametrize("name", list(CASES))
def test_nms_plain_edges_index_exact(name):
    make, max_det, none_kept = CASES[name]
    arrays = make()
    got = nms_cuda(*(torch.from_numpy(np.ascontiguousarray(x[None])) for x in arrays),
                   max_det, 0.3)[0].numpy()
    assert got.dtype == np.int64 and got.shape == (max_det,)
    args = [jnp.asarray(x) for x in arrays]
    np.testing.assert_array_equal(got, np.asarray(
        nms_pallas(*args, max_det, 0.3, interpret=True)))
    np.testing.assert_array_equal(got, np.asarray(
        jax_nms._select_suppress_nms(*args, 0.3, max_det)))
    assert (got == -1).all() == none_kept
    assert counters().get("kernel.k2", 0) == 0  # CPU tensors: no launch
