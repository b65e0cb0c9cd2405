"""The training cell cut to 64 px for tests on the CPU: the same driver,
reference and checks, with tiny photos, B=2 and a pool of 8.

The port convolves in float32 here (``compute_dtype``), where the card
runs the configured bfloat16: at 64 px and B=2, train-mode BatchNorm
normalizes over 8 values a channel at stride 32, and bfloat16's rounding
through it reads ``raw_err`` 0.23 and a median leaf's gradient gap of
0.18 on the CPU, above the limits the card's readings at 576 px and
B=16 set."""

from port_bench import harness, manifest

CELL = "s2-train-stage2-b16"


def tiny_train_context(seconds=0.5, seed=2 ** 31 + 7, limits=None,
                       config=None) -> harness.Context:
    m = manifest.load()
    w = manifest.cell(m, CELL)
    cfg = manifest.config(w["config"])
    # the anchors scaled with the image, so boxes keep their proportions
    cfg["config"].update(image_size=64, test_size=64, compute_dtype="float32",
                         anchors=[[a * 64 / 576 for a in pair]
                                  for pair in cfg["config"]["anchors"]])
    cfg["config"].update(config or {})
    tr = manifest.traffic(w["traffic"])
    tr["knobs"]["batch_size"] = 2
    tr.update(pool=8, sizes=[[48, 64], [64, 48]], warmup_blocks=0)
    return harness.Context(workload=CELL, config=cfg, traffic=tr,
                           limits=limits or manifest.limits(CELL),
                           seed=seed, seconds=seconds, trace=False,
                           device="cpu")


def tiny_train_run(graph="default", **kw):
    ctx = tiny_train_context(**kw)
    return manifest.driver(ctx.traffic["driver"]).run(ctx, graph=graph)
