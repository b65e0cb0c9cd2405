"""The harness: BENCHMARK.json against its contract, cells found by
name, the result line, the trace's reduction, and runs that must fail."""

import hashlib
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from port_bench import harness, manifest, run, trace

REPO = Path(__file__).resolve().parents[2]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _line_ok(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_benchmark_json_keeps_the_contract():
    raw = (REPO / "BENCHMARK.json").read_bytes()
    assert len(raw) <= 64 * 1024
    m = json.loads(raw)
    assert set(m) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert 1 <= len(m["command"]) <= 32 and all(map(_line_ok, m["command"]))
    assert m["paths"] == ["port_bench"]
    assert isinstance(m["run_seconds"], int) and 1 <= m["run_seconds"] <= 51
    # a full check of 24 cells fits 43200 s
    assert (2 + 14 * 24) * (m["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    configs = {c["name"]: c for c in m["configs"]}
    assert 1 <= len(configs) == len(m["configs"]) <= 24
    for c in m["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line_ok(c["source"])
        assert _line_ok(c["why"]) and len(c["reduced"]) <= 16
        assert c["file"] == f"port_bench/configs/{c['name']}.json"
        body = json.loads((REPO / c["file"]).read_text())
        assert body["source"] == c["source"] and body["reduced"] == c["reduced"]
    cells = m["workloads"]
    assert 1 <= len(cells) <= 24
    assert len({w["name"] for w in cells}) == len(cells)
    assert len({(w["config"], w["traffic"]) for w in cells}) == len(cells)
    for w in cells:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["config"] in configs and w["chips"] == 1
        assert _line_ok(w["why"])
        assert (REPO / "port_bench/traffic" / f"{w['traffic']}.json").exists()
        assert (REPO / "port_bench/limits" / f"{w['name']}.json").exists()
    assert {w["config"] for w in cells} == set(configs)
    e2e = {e["name"]: e for e in m["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    names = list(e2e) + [p["name"] for p in m["per_layer"]]
    assert len(set(names)) == len(names)
    for e in m["end_to_end"]:
        assert set(e) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert NAME.match(e["name"]) and UNIT.match(e["unit"])
        assert e["better"] in ("lower", "higher")
        assert e["source"] in ("host_clock", "device_trace")
        assert 0.01 <= e["bound"] <= 0.25
    layers = {}
    for p in m["per_layer"]:
        assert set(p) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert NAME.match(p["name"]) and UNIT.match(p["unit"])
        assert p["better"] in ("lower", "higher") and _line_ok(p["layer"])
        assert p["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert p["moves"] in e2e
        assert (REPO / "port_bench/metrics" / f"{p['name']}.py").exists()
        for w in p.get("workloads", [c["name"] for c in cells]):
            assert w in e2e[p["moves"]].get("workloads", [w])
        layers.setdefault(p["layer"].lower(), set()).add(p["layer"])
    assert all(len(v) == 1 for v in layers.values())
    for w in cells:
        reported = [e["name"] for e in manifest.metrics_of(m, w["name"],
                                                           "end_to_end")]
        assert "setup_s" in reported and len(reported) >= 2
        assert manifest.metrics_of(m, w["name"], "per_layer")


def test_a_file_and_an_entry_add_a_config_a_mix_a_metric_and_a_cell(tmp_path):
    shutil.copytree(REPO / "port_bench", tmp_path / "port_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(REPO / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    root = tmp_path / "port_bench"

    def digest():
        return {p: hashlib.sha256(p.read_bytes()).hexdigest()
                for p in sorted(root.rglob("*")) if p.is_file()}

    before = digest()
    m = json.loads((tmp_path / "BENCHMARK.json").read_text())
    cfg = json.loads((root / "configs/disyolo-576-s2.json").read_text())
    cfg["name"] = "new-config"
    (root / "configs/new-config.json").write_text(json.dumps(cfg))
    (root / "traffic/new-mix.json").write_text(json.dumps(
        {"driver": "serve", "batch": 4, "pool": 16, "sizes": [[720, 960]],
         "max_defects": 2, "min_survivors": 5, "profile_batches": 5,
         "sync_batches": 1}))
    (root / "limits/new-cell.json").write_text(json.dumps({"raw_err": 1.0}))
    (root / "metrics/new_metric.serve.py").write_text(
        "def read(out):\n    return out.counters.get('batches')\n")
    m["configs"].append({"name": "new-config", "source": cfg["source"],
                         "file": "port_bench/configs/new-config.json",
                         "reduced": [], "why": "a test"})
    m["workloads"].append({"name": "new-cell", "config": "new-config",
                           "traffic": "new-mix", "chips": 1, "why": "a test"})
    m["per_layer"].append({"name": "new_metric.serve", "unit": "batches",
                           "better": "lower", "source": "program_counter",
                           "layer": "host", "moves": "setup_s"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(m))
    after = digest()
    assert {p: h for p, h in before.items() if after[p] != h} == {}

    got = manifest.load(tmp_path / "BENCHMARK.json")
    w = manifest.cell(got, "new-cell")
    assert manifest.config(w["config"], root)["name"] == "new-config"
    assert manifest.traffic(w["traffic"], root)["batch"] == 4
    assert manifest.limits("new-cell", root) == {"raw_err": 1.0}
    assert manifest.driver("serve", root).run
    reader = manifest.metric_reader("new_metric.serve", root)
    out = harness.Outcome(e2e={}, attempted=1, failed=0, memory_peak_bytes=0,
                          checks=[], counters={"batches": 7.0})
    assert reader.read(out) == 7.0
    names = [p["name"] for p in manifest.metrics_of(got, "new-cell",
                                                    "per_layer")]
    assert names == ["new_metric.serve"]


def _outcome(traced):
    t = trace.Trace(window_s=1.0, busy_s=0.5, calls=2,
                    ops=[(0.0, 0.2, "k_a", "forward", "kernel"),
                         (0.3, 0.3, "k_b", "paste", "kernel")],
                    gaps={"forward/aten::item": 0.5}) if traced else None
    return harness.Outcome(
        e2e={"serve_img_per_s": 100.0, "serve_batch_p95_ms": 40.0,
             "peak_mem_gib": 2.0, "setup_s": 20.0},
        attempted=10, failed=0, memory_peak_bytes=2 << 30,
        checks=[("raw_err", 0.1, 0.3), ("det_diff", 0, 0)],
        counters={"rate_img_per_s": 100.0, "flops_per_image": 1e11,
                  "syncs_per_batch": 19.0, "k1_bound_s_per_call": 1e-5,
                  "paste_bound_s": 0.01, "batches": 10.0},
        trace=t)


@pytest.mark.parametrize("traced", [False, True])
def test_the_result_line(traced):
    m = manifest.load()
    device = {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1,
              "memory_peak_bytes": 2 << 30}
    line = run.result_line(m, "s2-serve-b8-dense", _outcome(traced), traced,
                           device)
    keys = ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line) == keys + (["breakdown"] if traced else []) + ["checks"]
    assert line["correct"] is True
    assert line["checks"]["raw_err"] == {"value": 0.1, "limit": 0.3}
    want = manifest.metrics_of(m, "s2-serve-b8-dense",
                               "per_layer" if traced else "end_to_end")
    if not traced:
        assert set(line["metrics"]) == {e["name"] for e in want}
    else:
        assert set(line["metrics"]) <= {e["name"] for e in want}
        assert line["metrics"]["idle_share.serve"]["value"] == 50.0
        assert line["metrics"]["forward_ms.serve"]["value"] == 100.0
        assert line["breakdown"]["device_ops"][0] == ["k_b", 0.3]
        assert len(line["breakdown"]["idle_gaps"]) <= 10
    for entry in line["metrics"].values():
        assert set(entry) == {"value", "unit"}
    json.dumps(line)


def test_a_check_with_nothing_to_compare_prints_valid_json():
    out = _outcome(False)
    out.checks.append(("raw_err_missing", float("inf"), 0.3))
    out.e2e["serve_batch_p95_ms"] = float("inf")
    line = run.result_line(manifest.load(), "s2-serve-b8-dense", out, False,
                           {"platform": "gpu"})
    assert out.correct is False and line["correct"] is False
    json.loads(json.dumps(line, allow_nan=False))


def test_a_check_over_its_limit_is_not_correct():
    out = _outcome(False)
    out.checks.append(("paste_diff", 1, 0))
    assert out.correct is False
    out.checks.pop()
    out.failed = 1
    assert out.correct is False


def test_reduce_events_unions_spans_and_labels_gaps():
    ev = [
        {"cat": "user_annotation", "name": trace.WINDOW_SPAN, "ts": 0,
         "dur": 100, "tid": 1},
        {"cat": "user_annotation", "name": "forward", "ts": 0, "dur": 40,
         "tid": 1},
        {"cat": "user_annotation", "name": "paste", "ts": 50, "dur": 40,
         "tid": 1},
        {"cat": "cpu_op", "name": "aten::item", "ts": 30, "dur": 10,
         "tid": 1},
        {"cat": "cuda_runtime", "name": "launch", "ts": 1,
         "args": {"correlation": 1}},
        {"cat": "cuda_runtime", "name": "launch", "ts": 2,
         "args": {"correlation": 2}},
        {"cat": "cuda_runtime", "name": "launch", "ts": 55,
         "args": {"correlation": 3}},
        {"cat": "kernel", "name": "a", "ts": 10, "dur": 20,
         "args": {"correlation": 1}},
        {"cat": "kernel", "name": "b", "ts": 20, "dur": 15,
         "args": {"correlation": 2}},
        {"cat": "gpu_memcpy", "name": "c", "ts": 60, "dur": 10,
         "args": {"correlation": 3}},
    ]
    t = trace.reduce_events(ev, calls=1)
    assert t.window_s == pytest.approx(100e-6)
    # [10, 35] and [60, 70]: 35 us, the overlap counted once
    assert t.busy_s == pytest.approx(35e-6)
    assert t.span_device_s("forward") == pytest.approx(35e-6)
    assert t.span_device_s("paste") == pytest.approx(10e-6)
    assert len(t.kernels()) == 2
    assert t.gaps["forward/aten::item"] == pytest.approx(25e-6)
    assert t.gaps["forward"] == pytest.approx(10e-6)
    assert t.gaps["paste"] == pytest.approx(30e-6)


def test_without_a_card_a_run_fails_and_prints_no_result(capsys,
                                                         monkeypatch):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = run.main(["--workload", "s2-serve-b8-dense", "--seed", "1",
                   "--seconds", "1", "--trace", "0"])
    assert rc != 0
    assert capsys.readouterr().out == ""


def test_without_the_port_a_run_fails_and_prints_no_result(tmp_path):
    shutil.copytree(REPO / "port_bench", tmp_path / "port_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(REPO / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    # past the card check, as on the card: the port's import must fail
    code = ("import sys, runpy, torch\n"
            "torch.cuda.is_available = lambda: True\n"
            "torch.cuda.device_count = lambda: 1\n"
            "sys.argv = ['run', '--workload', 's2-serve-b8-dense', "
            "'--seed', '1', '--seconds', '1', '--trace', '0']\n"
            "runpy.run_module('port_bench.run', run_name='__main__')\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                         capture_output=True, text=True, timeout=300,
                         env={"PATH": "/usr/bin:/bin",
                              "PYTHONPATH": str(tmp_path)})
    assert res.returncode != 0
    assert "dis_yolo_tpu_torch" in res.stderr
    assert not any(l.startswith("{") for l in res.stdout.splitlines())
