"""``calibrate_threshold`` of the port against the JAX package's, on a
model left in train mode (as ``total_loss`` leaves it).

The JAX function always runs ``forward(..., train=False)``; the port's
must do the same whatever mode the module is in: normalize with the
running BN statistics, update none of them, and hand the module back in
its mode.  Weights and BN statistics are drawn with numpy and carried
from JAX through ``models/weights.py``.

Tolerance against JAX: the float32 forward parity of
``tests/test_torch_model.py`` (rtol 1e-4, atol 1e-4 x max(1, max|ref|)),
applied to the threshold (a score in [0, 1]); against the port's own
eval-mode call: equality.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dis_yolo_tpu.config import DISYoloConfig as JaxConfig
from dis_yolo_tpu.models import api as jax_api
from dis_yolo_tpu.utils.runtime import calibrate_threshold as jax_calibrate
from dis_yolo_tpu_torch.config import DISYoloConfig
from dis_yolo_tpu_torch.models import api
from dis_yolo_tpu_torch.models.weights import state_dict_from_flax
from dis_yolo_tpu_torch.utils.runtime import calibrate_threshold
from tests.test_torch_model import as_numpy_tree, random_variables


@pytest.fixture(scope="module", autouse=True)
def _few_torch_threads():
    """The suite runs several test files at once, one per process: keep
    torch's CPU thread pool small while this file runs."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def test_calibrate_threshold_train_mode_model():
    size = 96
    kw = dict(image_size=size, test_size=size, compute_dtype="float32")
    jcfg, cfg = JaxConfig(**kw), DISYoloConfig(**kw)
    variables = as_numpy_tree(random_variables(jcfg, 7))
    model = api.create_model(cfg, device="cpu")
    model.load_state_dict(state_dict_from_flax(variables))
    images = np.random.RandomState(size).rand(2, size, size, 3).astype(
        np.float32)
    timages = torch.from_numpy(images)

    model.eval()
    want_eval = calibrate_threshold(model, timages, cfg)
    model.train()
    stats = {k: v.clone() for k, v in model.state_dict().items()
             if "running" in k or "num_batches" in k}
    assert len(stats) > 100
    got = calibrate_threshold(model, timages, cfg)

    assert model.training                # handed back in its mode
    for key, before in stats.items():
        assert torch.equal(model.state_dict()[key], before), key
    assert got == want_eval
    want = jax_calibrate(jax_api.create_model(jcfg), variables,
                         jnp.asarray(images), jcfg)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    assert 0.0 < got < 1.0
