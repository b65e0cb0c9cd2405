"""Port parity of ``dis_yolo_tpu_torch.data.device_augment`` against the
JAX package's ``data/device_augment.py`` on the CPU, at 64 px.

JAX draws from threefry keys, the port from a ``torch.Generator``; so
each test derives from the key the draws JAX's ``augment_batch`` makes
(``split(key, 3)``, per image ``split(k, 4)``, the ``randint`` and
``uniform`` calls), hands them to the port's ``augment_batch`` and
compares the result with JAX's on that key.

Tolerances: everything bit-exact.  The photometric images were allowed
1/255 on 0.1% of the pixels (XLA's fusion contracts multiply-adds that
PyTorch rounds twice); the port takes the hue's multiply-add as one
rounding, as XLA and OpenCV do, and measures no difference.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dis_yolo_tpu.data import device_augment as jax_da
from dis_yolo_tpu_torch.config import DISYoloConfig
from dis_yolo_tpu_torch.data import device_augment as da
from dis_yolo_tpu_torch.train.synthetic import synthetic_batch
from dis_yolo_tpu_torch.train.train_step import prepare_batch

SIZE = 64


@pytest.fixture(scope="module", autouse=True)
def _few_torch_threads():
    """The suite runs several test files at once, one per process: keep
    torch's CPU thread pool small while this file runs."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def jax_draws(key, b, size, flips=True, photometric=True):
    """The draws JAX's ``augment_batch`` makes from ``key``, in the
    port's layout (``draw_augment``'s keys)."""
    kf, kp, kd = jax.random.split(key, 3)
    out = {}
    if flips:
        out["flip"] = np.asarray(jax.random.randint(kf, (b,), 1, 4))
    if photometric:
        out["bnl"] = np.asarray(jax.random.randint(kp, (b,), 1, 5))
        salt, coeff, blur = [], [], []
        for k in jax.random.split(kd, b):
            k1, k2, k3, k4 = jax.random.split(k, 4)
            salt.append(np.asarray(jax.random.uniform(k1, (size, size))))
            coeff.append(np.asarray(jax.random.uniform(k2, (), minval=0.5,
                                                       maxval=1.5)))
            blur.append(int(jax.random.randint(k3, (), 0, 4)) * 3
                        + int(jax.random.randint(k4, (), 0, 3)))
        out.update(salt=np.stack(salt), coeff=np.stack(coeff),
                   blur=np.asarray(blur))
    return {k: torch.from_numpy(np.array(v)) for k, v in out.items()}


@pytest.fixture(scope="module")
def batch():
    """An expanded 4-image batch in the loader's layout: uint8-valued
    images with a texture (so the photometric branches change pixels),
    three boxes per image in the grids."""
    cfg = DISYoloConfig(image_size=SIZE)
    wire = synthetic_batch(cfg, 4, 3, seed=2)
    rng = np.random.RandomState(3)
    wire["images"] = rng.randint(0, 256, wire["images"].shape).astype(np.uint8)
    return {k: v.numpy() for k, v in prepare_batch(
        {k: torch.from_numpy(v) for k, v in wire.items()}).items()}


@pytest.fixture(scope="module")
def jax_augment():
    return jax.jit(jax_da.augment_batch, static_argnums=(2, 3, 4))


def run_both(jax_augment, batch, key, flips, photometric):
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    want = jax_augment(key, jb, SIZE, flips, photometric)
    draws = jax_draws(key, 4, SIZE, flips, photometric)
    got = da.augment_batch({k: torch.from_numpy(v) for k, v in batch.items()},
                           draws, SIZE, flips, photometric)
    return got, {k: np.asarray(v) for k, v in want.items()}, draws


def test_flips_match_jax_bit_exact(jax_augment, batch):
    """Five keys x 4 images (every flip drawn): images, masks, true boxes
    and the three grids bit-equal to JAX's."""
    seen = set()
    for seed in range(5):
        got, want, draws = run_both(jax_augment, batch,
                                    jax.random.PRNGKey(seed), True, False)
        seen |= set(draws["flip"].tolist())
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)
    assert seen == {1, 2, 3}


def test_photometric_matches_jax(jax_augment, batch):
    """Flips and photometric together over six keys (every branch
    drawn): every field bit-exact."""
    seen = set()
    for seed in range(10, 16):
        got, want, draws = run_both(jax_augment, batch,
                                    jax.random.PRNGKey(seed), True, True)
        seen |= set(draws["bnl"].tolist())
        for k in want:
            np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)
    assert seen == {1, 2, 3, 4}


def test_each_blur_kernel_and_lightness_match_jax():
    """JAX's per-image photometric on 64 keys with the blur branch forced
    (all 12 kernels drawn) and with lightness forced, against the port's
    branch on the derived kernel index and coefficient."""
    rng = np.random.RandomState(4)
    img = (rng.randint(0, 256, (64, SIZE, SIZE, 3)) / 255.0).astype(np.float32)
    keys = jax.random.split(jax.random.PRNGKey(5), 64)
    one = jax.jit(jax.vmap(jax_da._photometric_single))
    kidx, coeff = [], []
    for k in keys:
        _, k2, k3, k4 = jax.random.split(k, 4)
        kidx.append(int(jax.random.randint(k3, (), 0, 4)) * 3
                    + int(jax.random.randint(k4, (), 0, 3)))
        coeff.append(float(jax.random.uniform(k2, (), minval=0.5, maxval=1.5)))
    assert set(kidx) == set(range(12))
    np.testing.assert_array_equal(da._motion_kernel_table(),
                                  jax_da._motion_kernel_table())
    x = torch.from_numpy(img)
    for branch, got in (
            (4, da._blur(x, torch.tensor(kidx))),
            (3, da._lightness(x, torch.tensor(coeff, dtype=torch.float32)))):
        want = np.asarray(one(keys, jnp.full((64,), branch), jnp.asarray(img)))
        np.testing.assert_array_equal(got.numpy(), want, err_msg=branch)


def test_hls_round_trip_matches_jax():
    """``_rgb2hls_u8`` and ``_hls2rgb_u8`` on every 8-bit RGB level mix:
    H, L and S and the round trip against JAX's."""
    rng = np.random.RandomState(6)
    img = rng.randint(0, 256, (128, 128, 3)).astype(np.float32)
    got = da._rgb2hls_u8(torch.from_numpy(img))
    want = jax.jit(jax_da._rgb2hls_u8)(jnp.asarray(img))
    for g, w, name in zip(got, want, "HLS"):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
    back = da._hls2rgb_u8(*got)
    want_back = jax.jit(jax_da._hls2rgb_u8)(*[jnp.asarray(g.numpy())
                                             for g in got])
    np.testing.assert_array_equal(back.numpy(), np.asarray(want_back))


def test_draw_augment_shapes_ranges_and_salt():
    """Draws on the generator's device with their ranges; equal seeds
    give equal draws; salt and pepper never hit the last row or column."""
    gen = torch.Generator().manual_seed(0)
    d = da.draw_augment(gen, 3, SIZE)
    assert set(d) == {"flip", "bnl", "salt", "coeff", "blur"}
    assert d["salt"].shape == (3, SIZE, SIZE) and d["salt"].device.type == "cpu"
    assert set(d["flip"].tolist()) <= {1, 2, 3}
    assert set(d["bnl"].tolist()) <= {1, 2, 3, 4}
    assert bool(((d["coeff"] >= 0.5) & (d["coeff"] <= 1.5)).all())
    assert set(d["blur"].tolist()) <= set(range(12))
    again = da.draw_augment(torch.Generator().manual_seed(0), 3, SIZE)
    assert all(torch.equal(d[k], again[k]) for k in d)
    assert set(da.draw_augment(gen, 2, SIZE, photometric=False)) == {"flip"}
    x = torch.full((1, 8, 8, 3), 0.5)
    u = torch.zeros((1, 8, 8))
    out = da._salt_pepper(x, u)                  # salt everywhere hitable
    assert bool((out[0, :7, :7] == 1.0 / 255.0).all())
    assert bool((out[0, 7] == 0.5).all()) and bool((out[0, :, 7] == 0.5).all())
