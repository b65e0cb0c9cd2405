"""The port's single-card training knobs on the CPU at 64 px, float32:
``grad_accum`` and the commuted decoder in training against the JAX
package's ``grads_and_aux`` (one JAX compile), ``remat`` against the
plain step, and the K-step block against K single steps.

Tolerances: against JAX those of
``tests/test_torch_train.py::test_total_loss_and_grads_match_jax``
(metrics rtol 1e-3; gradients relative L2 error <= 1e-1 per leaf and
<= 3e-2 over all leaves; BN statistics within 1e-3 x max|ref|, the
whole-model forward's); the port against itself bit for bit.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dis_yolo_tpu.config import DISYoloConfig as JaxConfig
from dis_yolo_tpu.models import api as jax_api
from dis_yolo_tpu.train import train_step as jax_ts
from dis_yolo_tpu_torch.config import DISYoloConfig
from dis_yolo_tpu_torch.models import api
from dis_yolo_tpu_torch.models.weights import (flax_from_state_dict,
                                               state_dict_from_flax)
from dis_yolo_tpu_torch.train import train_step as ts
from dis_yolo_tpu_torch.train.synthetic import synthetic_batch
from tests.test_torch_train import (assert_trees_close, close, flat,
                                    jax_uniforms, random_variables)

KW = dict(image_size=64, compute_dtype="float32", pre_nms_top_k=64)


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


def T(x):
    return torch.from_numpy(np.array(x))


def test_grad_accum_and_commuted_decoder_match_jax():
    """``grads_and_aux`` with ``grad_accum=2`` on a batch of 4 through
    the commuted decoder, nothing locked, against JAX's: the averaged
    metrics and gradients, and the BN statistics after both
    microbatches; the finite check sees the averages.  A batch of 3
    raises."""
    kw = dict(KW, grad_accum=2, decoder_commute=True, locked_layers=())
    jcfg = JaxConfig(**kw)
    variables = random_variables(jcfg, 31)
    jmodel = jax_api.create_model(jcfg)
    model = api.create_model(DISYoloConfig(**kw), device="cpu")
    model.load_state_dict(state_dict_from_flax(variables))
    batch = synthetic_batch(model.cfg, 4, 3, seed=14)
    keys = jax.random.split(jax.random.PRNGKey(2), 4)
    u_prop, u_gt = jax_uniforms(keys, model.cfg.max_detection,
                                model.cfg.max_box_per_image)

    want_g, want_stats, want_m = jax.jit(functools.partial(
        jax_ts.grads_and_aux, model=jmodel))(
        variables["params"], variables["batch_stats"],
        {k: jnp.asarray(v) for k, v in batch.items()}, keys)

    params = dict(model.named_parameters())
    model.train()
    grads, metrics = ts.grads_and_aux(
        model, {k: T(v) for k, v in batch.items()}, T(u_prop), T(u_gt),
        list(params.values()))
    model.eval()
    assert set(metrics) == set(want_m)
    assert float(want_m["mask_loss"]) > 0
    for name in want_m:
        close(metrics[name], want_m[name], 1e-3, 1e-6, name)
    stats = flax_from_state_dict(model.state_dict())["batch_stats"]
    assert_trees_close(stats, jax.tree.map(np.asarray, want_stats), 0, 1e-3)
    got_g = dict(flat(flax_from_state_dict(dict(zip(params, grads)))["params"]))
    want_g = dict(flat(jax.tree.map(np.asarray, want_g)))
    assert set(got_g) == set(want_g)
    for key, want in want_g.items():
        err = np.linalg.norm(got_g[key] - want) / np.linalg.norm(want)
        assert err <= 1e-1, f"{key}: relative L2 error {err}"
    got_all = np.concatenate([got_g[k].ravel() for k in want_g])
    want_all = np.concatenate([w.ravel() for w in want_g.values()])
    err = np.linalg.norm(got_all - want_all) / np.linalg.norm(want_all)
    assert err <= 3e-2, f"all leaves: relative L2 error {err}"

    odd = {k: T(v[:3]) for k, v in batch.items()}
    with pytest.raises(ValueError, match="not divisible by grad_accum 2"):
        ts.grads_and_aux(model, odd, T(u_prop[:3]), T(u_gt[:3]),
                         list(params.values()))


def _model(cfg, seed=0):
    return api.init_model(cfg, seed, device="cpu")


def _assert_same_state(a, b, sa, sb):
    for key, value in a.state_dict().items():
        assert torch.equal(value, b.state_dict()[key]), key
    assert sa.step == sb.step and sa.opt.count == sb.opt.count
    for key in sa.opt.mu:
        assert torch.equal(sa.opt.mu[key], sb.opt.mu[key]), key
        assert torch.equal(sa.opt.nu[key], sb.opt.nu[key]), key


def test_remat_step_bit_equals_plain_step():
    """Two stage-2 steps with ``remat`` (every ConvBN recomputed in the
    backward) against the plain model: parameters, moments, the running
    statistics (moved once per step, not again in the recompute) and
    metrics bit-equal; the state_dict names are the same."""
    cfg = DISYoloConfig(**KW, locked_layers=())
    plain, rem = _model(cfg), _model(cfg.replace(remat=True))
    assert list(plain.state_dict()) == list(rem.state_dict())
    rem.load_state_dict(plain.state_dict())
    assert all(m.remat for m in rem.modules() if hasattr(m, "remat"))
    batch = synthetic_batch(cfg, 2, 3, seed=15)
    states, metrics = [], []
    for model in (plain, rem):
        state = ts.init_train_state(model, device="cpu")
        step = ts.make_train_step(model, device="cpu")
        gen = torch.Generator().manual_seed(3)
        rows = []
        for _ in range(2):
            state, m = step(state, batch, gen)
            rows.append(m)
        states.append(state)
        metrics.append(rows)
    _assert_same_state(plain, rem, *states)
    for a, b in zip(*metrics):
        for key in a:
            assert torch.equal(a[key], b[key]), key


def test_block_bit_equals_single_steps_with_device_augs():
    """A K=3 block (``make_multi_step``) with device-side augs equals three
    single steps from the same state and generators, bit for bit: the
    weights, the optimizer, both generators' states and the stacked
    metrics."""
    cfg = DISYoloConfig(**KW, device_side_augs=True, steps_per_dispatch=3)
    cfg.check_trainable()
    single, blocked = _model(cfg, 1), _model(cfg, 1)
    batches = [synthetic_batch(cfg, 2, 3, seed=20 + i) for i in range(3)]
    for b in batches:        # the loader's wire format: uint8 images
        b["images"] = np.round(b["images"] * 255).astype(np.uint8)
    gens = [(torch.Generator().manual_seed(4), torch.Generator().manual_seed(5))
            for _ in range(2)]

    s1 = ts.init_train_state(single, device="cpu")
    step = ts.make_train_step(single, device="cpu")
    rows = []
    for b in batches:
        s1, m = step(s1, b, *gens[0])
        rows.append(m)
    with pytest.raises(ValueError, match="aug_generator"):
        step(s1, batches[0], gens[0][0])

    s2 = ts.init_train_state(blocked, device="cpu")
    multi = ts.make_multi_step(blocked, device="cpu")
    block = {k: np.stack([b[k] for b in batches]) for k in batches[0]}
    s2, stacked = multi(s2, block, *gens[1])

    _assert_same_state(single, blocked, s1, s2)
    for g1, g2 in zip(*gens):
        assert torch.equal(g1.get_state(), g2.get_state())
    for key, value in stacked.items():
        assert value.shape == (3,)
        assert torch.equal(value, torch.stack([r[key] for r in rows])), key
