"""Nothing the benchmark runs imports JAX or the JAX package ``repro``:
a scan of the harness's sources, the run-time check on loaded modules,
and the runs that must exit without a result."""
from __future__ import annotations

import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))

import pb_harness  # noqa: E402

SOURCES = sorted(HERE.rglob("*.py"))


def imported_roots(path: Path) -> set:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            roots.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module":
            if node.args and isinstance(node.args[0], ast.Constant):
                roots.add(str(node.args[0].value).split(".")[0])
    return roots


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(HERE)))
def test_no_source_imports_jax_or_the_jax_package(path):
    assert not imported_roots(path) & pb_harness.FORBIDDEN


def test_reference_imports_nothing_of_the_program():
    for name in ("pb_ref.py", "pb_gen.py"):
        assert "repro_torch" not in imported_roots(HERE / name)


def test_roots_are_compared_whole():
    assert pb_harness.forbidden_modules(["repro_torch", "repro_torch.core", "jaxtyping",
                                         "reprox", "numpy"]) == []
    assert pb_harness.forbidden_modules(["repro.core.engine", "jax", "jaxlib.xla_client",
                                         "flax.linen"]) == ["flax", "jax", "jaxlib", "repro"]


def _run(cwd: Path, *extra: str) -> subprocess.CompletedProcess:
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    return subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", "pe50k.q8", "--seed", "3",
         "--seconds", "1", "--trace", "0", *extra],
        cwd=cwd, env=env, capture_output=True, text=True, timeout=300)


def test_no_card_no_result():
    out = _run(HERE.parent)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "CUDA" in out.stderr


def test_benchmark_files_alone_give_no_result(tmp_path):
    shutil.copy(HERE.parent / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(HERE, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "out"))
    out = _run(tmp_path)
    assert out.returncode != 0 and out.stdout.strip() == ""
