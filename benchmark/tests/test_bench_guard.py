"""Nothing the benchmark runs imports JAX or the JAX package, and the
reference imports nothing of the program."""

import ast
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "vacancy_tpu"}
PROGRAM = "vacancy_tpu_torch"


def _imports(path: Path):
    """Top-level names of every module ``path`` imports."""
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__") and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value).split(".")[0]


def _sources():
    files = sorted(BENCH.rglob("*.py"))
    assert len(files) > 20
    return files


def test_no_file_imports_jax_or_the_jax_package():
    bad = [(str(p.relative_to(BENCH)), name) for p in _sources()
           for name in _imports(p) if name in FORBIDDEN]
    assert not bad, bad


def test_reference_imports_nothing_of_the_program():
    files = sorted((BENCH / "reference").rglob("*.py"))
    assert files
    bad = [(str(p.relative_to(BENCH)), name) for p in files
           for name in _imports(p) if name in FORBIDDEN | {PROGRAM}]
    assert not bad, bad


def test_guard_compares_whole_top_level_names(tmp_path):
    path = tmp_path / "probe.py"
    path.write_text("import vacancy_tpu.ops\nfrom jax import numpy\n"
                    "import vacancy_tpu_torch\n")
    found = set(_imports(path))
    assert found == {"vacancy_tpu", "jax", "vacancy_tpu_torch"}
    assert found & FORBIDDEN == {"vacancy_tpu", "jax"}


def test_run_checks_sys_modules_after_the_window(monkeypatch):
    import importlib

    run = importlib.import_module("run")
    assert run.FORBIDDEN == ("jax", "jaxlib", "flax", "vacancy_tpu")
    monkeypatch.setitem(sys.modules, "vacancy_tpu_torch.fake", object())
    assert "vacancy_tpu" not in run._forbidden_modules()
    monkeypatch.setitem(sys.modules, "vacancy_tpu.fake", object())
    assert "vacancy_tpu" in run._forbidden_modules()


def test_the_benchmark_process_holds_no_jax(tmp_path):
    """Importing what a run imports, in a fresh interpreter, loads no
    forbidden module."""
    import subprocess

    code = ("import sys; sys.path[:0] = [%r, %r]\n"
            "import run, control\n"
            "from harness import cells, driver, program, check, trace\n"
            "import reference, vacancy_tpu_torch\n"
            "print(run._forbidden_modules())\n" % (str(BENCH),
                                                 str(BENCH.parent)))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=tmp_path)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"
