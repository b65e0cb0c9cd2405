"""A cell of the benchmark cut to 64 px for tests on the CPU: the same
driver, reference and checks, with tiny photos and batches."""

from port_bench import harness, manifest


def tiny_context(workload="s2-serve-b8-dense", seconds=1.0, seed=2 ** 31 + 5,
                 limits=None) -> harness.Context:
    m = manifest.load()
    w = manifest.cell(m, workload)
    cfg = manifest.config(w["config"])
    # the anchors scaled with the image, so boxes keep their proportions
    cfg["config"].update(image_size=64, test_size=64, anchors=[
        [a * 64 / 576 for a in pair] for pair in cfg["config"]["anchors"]])
    tr = manifest.traffic(w["traffic"])
    tr.update(batch=2, pool=8, sizes=[[48, 64], [64, 48]],
              min_survivors=min(tr["min_survivors"], 5))
    return harness.Context(workload=workload, config=cfg, traffic=tr,
                           limits=limits or manifest.limits(workload),
                           seed=seed, seconds=seconds, trace=False,
                           device="cpu")


def tiny_run(workload="s2-serve-b8-dense", **kw):
    ctx = tiny_context(workload, **kw)
    tr = manifest.traffic(manifest.cell(manifest.load(), workload)["traffic"])
    return manifest.driver(tr["driver"]).run(ctx)
