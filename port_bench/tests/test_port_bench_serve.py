"""The serving driver's whole run at 64 px on the CPU, sound and with the
timed path broken underneath: each fault must turn ``correct`` false."""

import pytest
import torch

from port_bench import manifest
from port_bench.tests.tiny import tiny_run

CELLS = [w["name"] for w in manifest.load()["workloads"]
         if manifest.traffic(w["traffic"])["driver"] == "serve"]


@pytest.mark.parametrize("workload", CELLS)
def test_the_inner_loop_runs_and_is_correct(workload):
    out = tiny_run(workload)
    assert out.attempted > 0 and out.failed == 0
    assert out.correct, out.checks
    assert {name for name, _, _ in out.checks} == set(
        manifest.limits(workload))
    assert set(out.e2e) == {"serve_img_per_s", "serve_batch_p95_ms",
                            "peak_mem_gib", "setup_s"}
    assert out.e2e["serve_img_per_s"] > 0
    assert out.counters["flops_per_image"] > 0


def _half_batch(monkeypatch):
    from dis_yolo_tpu_torch.models import api
    forward = api.forward

    def half(model, images, device=None):
        n = images.shape[0] // 2
        outs = forward(model, images[:n], device)
        return tuple(torch.cat([o, o], 0) for o in outs)

    monkeypatch.setattr(api, "forward", half)


def _zeroed_maps(monkeypatch):
    # the decoder broken: K1, the assembly and the paste of all-zero score
    # maps agree with the reference's, so only raw_err can see it
    from dis_yolo_tpu_torch.models import api
    forward = api.forward

    def zeroed(model, images, device=None):
        outs = tuple(forward(model, images, device))
        return outs[:3] + (torch.zeros_like(outs[3]),)

    monkeypatch.setattr(api, "forward", zeroed)


def _altered_score(monkeypatch):
    from dis_yolo_tpu_torch.models import api
    predict = api.predict_from_outputs

    def altered(*a, **kw):
        dets, masks = predict(*a, **kw)
        dets = dets.clone()
        dets[..., 5] = dets[..., 5] * (1 + 2 ** -20)    # 8 ulps
        return dets, masks

    monkeypatch.setattr(api, "predict_from_outputs", altered)


def _altered_masks(monkeypatch):
    from dis_yolo_tpu_torch.models import api
    assemble = api.assemble_masks_batch_cuda

    def altered(*a, **kw):
        m = assemble(*a, **kw)
        return torch.where(m > 0, 1.0 - m, m)

    monkeypatch.setattr(api, "assemble_masks_batch_cuda", altered)


def _altered_paste(monkeypatch):
    from dis_yolo_tpu_torch.ops import paste
    paste_batch = paste.paste_masks_batch

    def altered(*a, **kw):
        full, valid, sem = paste_batch(*a, **kw)
        sem = sem.clone()
        sem[0, 0, 0] = sem[0, 0, 0] + 1
        return full, valid, sem

    monkeypatch.setattr(paste, "paste_masks_batch", altered)


@pytest.mark.parametrize("fault,caught_by", [
    (_half_batch, "raw_err"), (_zeroed_maps, "raw_err"),
    (_altered_score, "det_diff"),
    (_altered_masks, "mask_diff"), (_altered_paste, "paste_diff")])
def test_a_broken_timed_path_is_not_correct(fault, caught_by, monkeypatch):
    fault(monkeypatch)
    out = tiny_run()
    assert out.attempted > 0
    assert not out.correct
    checks = {name: (value, limit) for name, value, limit in out.checks}
    assert checks[caught_by][0] > checks[caught_by][1], checks
