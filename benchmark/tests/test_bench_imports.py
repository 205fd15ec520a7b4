"""Nothing the benchmark runs imports JAX or the JAX package: the check
compares whole top-level module names."""

import ast
import subprocess
import sys

from benchmark import manifest as mf
from benchmark import run


def test_top_level_names_are_compared_whole():
    assert run.forbidden_modules(["jax.numpy", "jaxlib", "flax.linen", "genomad_tpu.ops.sw"]) == [
        "flax.linen", "genomad_tpu.ops.sw", "jax.numpy", "jaxlib"]
    assert run.forbidden_modules(["genomad_torch", "genomad_torch.ops", "jaxtyping", "genomad_tpux", "numpy"]) == []


def test_no_source_of_the_benchmark_imports_them():
    for path in mf.ROOT.rglob("*.py"):
        if "tests" in path.parts:
            continue
        for node in ast.walk(ast.parse(path.read_text())):
            names = [a.name for a in node.names] if isinstance(node, ast.Import) else [node.module or ""] if isinstance(node, ast.ImportFrom) else []
            assert not run.forbidden_modules(names), (path, names)


def test_the_harness_and_the_port_load_none_of_them():
    code = (
        "import benchmark.run as r, benchmark.control, benchmark.repeat, benchmark.entries.end_to_end, "
        "benchmark.entries.nn_classification, genomad_torch.cli, genomad_torch.modules.annotate, "
        "genomad_torch.modules.find_proviruses, genomad_torch.modules.nn_classification; "
        "print(r.forbidden_modules())"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=mf.REPO, capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "[]"


def test_a_directory_with_only_the_benchmark_exits_non_zero(tmp_path):
    import shutil

    shutil.copy(mf.REPO / "BENCHMARK.json", tmp_path)
    shutil.copytree(mf.ROOT, tmp_path / "benchmark", ignore=shutil.ignore_patterns("cache", "__pycache__"))
    out = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload", "nn.metagenome", "--seed", "1",
                          "--seconds", "1", "--trace", "0"], cwd=tmp_path, capture_output=True, text=True)
    assert out.returncode != 0 and out.stdout.strip() == ""
