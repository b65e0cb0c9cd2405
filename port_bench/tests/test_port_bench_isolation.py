"""The benchmark imports neither JAX nor the JAX package, and its
reference imports nothing of the port."""

import ast
import subprocess
import sys
from pathlib import Path

from port_bench import harness

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "dis_yolo_tpu"}


def _imports(path: Path):
    """Top-level module names of every import in the file."""
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module.split(".")[0]


def test_no_module_imports_jax_or_the_jax_package():
    files = sorted(ROOT.rglob("*.py"))
    assert len(files) > 10
    bad = {str(f.relative_to(ROOT)): sorted(set(_imports(f)) & FORBIDDEN)
           for f in files}
    assert {f: b for f, b in bad.items() if b} == {}


def test_the_reference_imports_nothing_of_the_port():
    files = sorted((ROOT / "reference").rglob("*.py"))
    assert files
    for f in files:
        names = set(_imports(f))
        assert "dis_yolo_tpu_torch" not in names, f
        assert not any(n.startswith("dis_yolo") for n in names), f


def test_a_whole_name_is_compared(monkeypatch):
    monkeypatch.setitem(sys.modules, "dis_yolo_tpu_torch_fake", object())
    monkeypatch.setitem(sys.modules, "jaxlike", object())
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", object())
    assert harness.forbidden_modules() == ["jax"]


def test_a_run_leaves_no_jax_in_sys_modules():
    code = (
        "import sys, torch\n"
        "torch.set_num_threads(2)\n"
        "from port_bench.tests.tiny import tiny_run\n"
        "out = tiny_run()\n"
        "from port_bench import harness\n"
        "assert out.attempted > 0\n"
        "print(sorted({m.split('.')[0] for m in sys.modules} & "
        "{'jax', 'jaxlib', 'flax', 'dis_yolo_tpu'}))\n"
        "print('dis_yolo_tpu_torch' in sys.modules)\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT.parent,
                         capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    lines = res.stdout.strip().splitlines()
    assert lines[-2:] == ["[]", "True"]
