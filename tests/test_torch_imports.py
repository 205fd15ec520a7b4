"""The PyTorch port stands alone: it imports neither JAX nor the JAX
package, and its entry points refuse to run without a card unless the
caller asks for the CPU."""

import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]

_IMPORT_EVERYTHING = """
import importlib, pkgutil, sys
import genomad_torch
names = ["genomad_torch"] + [m.name for m in pkgutil.walk_packages(genomad_torch.__path__, "genomad_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke  # the chip script imports the port only
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "genomad_tpu"))
assert not bad, bad
print(" ".join(names))
"""

# the modules of the third slice (end-to-end), each imported above
END_TO_END_MODULES = (
    "genomad_torch.ops.features",
    "genomad_torch.ops.trna",
    "genomad_torch.models.forest",
    "genomad_torch.models.crf",
    "genomad_torch.models.fusion",
    "genomad_torch.modules.marker_classification",
    "genomad_torch.modules.find_proviruses",
    "genomad_torch.modules.aggregated_classification",
    "genomad_torch.modules.score_calibration",
    "genomad_torch.modules.summary",
    "genomad_torch.modules.download",
    "genomad_torch.tools.profile_forward",
)

# the modules of the last slice (the trainer and the mesh), each imported above
TRAIN_AND_MESH_MODULES = (
    "genomad_torch.train",
    "genomad_torch.parallel",
    "genomad_torch.parallel.mesh",
    "genomad_torch.parallel.sharded_search",
)


def test_port_modules_import_neither_jax_nor_the_jax_package():
    out = subprocess.run(
        [sys.executable, "-c", _IMPORT_EVERYTHING], cwd=REPO, capture_output=True, text=True, timeout=120
    )
    assert out.returncode == 0, out.stderr
    names = out.stdout.split()
    # every module of the slices (nn-classification, annotate, end-to-end, trainer and mesh) was imported
    assert len(names) >= 29 + len(END_TO_END_MODULES) + len(TRAIN_AND_MESH_MODULES)
    assert set(END_TO_END_MODULES) <= set(names)
    assert set(TRAIN_AND_MESH_MODULES) <= set(names)


def test_no_import_of_jax_in_the_port_sources():
    pattern = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|genomad_tpu)\b", re.MULTILINE)
    sources = sorted((REPO / "genomad_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    offenders = [str(p.relative_to(REPO)) for p in sources if pattern.search(p.read_text())]
    assert not offenders


def test_resolve_device_raises_without_cuda():
    from genomad_torch.device import resolve_device

    if torch.cuda.is_available():
        pytest.skip("a card is present: resolve_device(None) is cuda there")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device(None)
    with pytest.raises(RuntimeError):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")


def test_nn_classification_without_cuda_raises(tmp_path):
    from genomad_torch.modules import nn_classification

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    fasta = tmp_path / "in.fna"
    fasta.write_text(">a\n" + "ACGT" * 1000 + "\n")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        nn_classification.main(fasta, tmp_path / "out", verbose=False)
    assert not (tmp_path / "out").exists()


def test_kernel_wrappers_refuse_other_devices():
    from genomad_torch.ops import conv

    tokens = torch.zeros((1, 8), dtype=torch.int32, device="meta")
    kernel = torch.zeros((6, 257, 128), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        conv.embed_conv(tokens, kernel, torch.zeros(128, device="meta"))
    with pytest.raises(ValueError, match="different devices"):
        conv.embed_conv(torch.zeros((1, 8), dtype=torch.int32), kernel, torch.zeros(128, device="meta"))


def test_native_library_builds_under_the_port_build_dir():
    """The C++ prefilter compiles into the port's gitignored build/, not
    next to its source, and never into the JAX package."""
    from genomad_torch import native
    from genomad_torch.build_dir import library_path

    build = REPO / "genomad_torch" / "build"
    path = library_path("genomad_native", native._SOURCES, native._GXX_FLAGS)
    assert path.parent == build
    assert path.is_relative_to(REPO / "genomad_torch")
    assert not path.is_relative_to(REPO / "genomad_tpu")
