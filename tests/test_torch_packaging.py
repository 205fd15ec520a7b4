"""The port installs as a package that can build its own native code: the
wheel holds every kernel source, the C++ prefilter and the data files, and
the builds go to the user cache when the installed package directory is
read-only. CPU only; the wheel is built offline from a copy of the tree."""

import os
import shutil
import stat
import subprocess
import sys
import zipfile
from pathlib import Path

import pytest

from genomad_torch import build_dir as bd

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "genomad_torch"
# the files an installed genomad-torch reads from its own directory
PORT_FILES = ("csrc/*.cu", "csrc/*.cuh", "native/*.cpp", "data/*")


def test_wheel_holds_the_port_sources_and_data(tmp_path):
    src = tmp_path / "src"
    src.mkdir()
    for name in ("pyproject.toml", "README.md"):
        shutil.copy(REPO / name, src)
    for pkg in ("genomad_tpu", "genomad_torch"):
        shutil.copytree(REPO / pkg, src / pkg, ignore=shutil.ignore_patterns("build", "__pycache__", "*.so"))
    env = {**os.environ, "PIP_NO_INDEX": "1", "PIP_DISABLE_PIP_VERSION_CHECK": "1"}
    subprocess.run(
        [sys.executable, "-m", "pip", "wheel", str(src), "--no-deps", "--no-build-isolation", "-q", "-w", str(tmp_path / "out")],
        check=True, env=env, timeout=120, capture_output=True,
    )
    (wheel,) = (tmp_path / "out").glob("*.whl")
    names = set(zipfile.ZipFile(wheel).namelist())
    want = sorted(f"genomad_torch/{p.relative_to(PORT).as_posix()}" for pattern in PORT_FILES for p in PORT.glob(pattern))
    assert any(n.endswith("sw.cu") for n in want) and any(n.endswith("prefilter.cpp") for n in want)
    assert [n for n in want if n not in names] == []
    assert not any("/build/" in n for n in names)  # no built library ships


READ_ONLY = stat.S_IRUSR | stat.S_IXUSR | stat.S_IRGRP | stat.S_IXGRP | stat.S_IROTH | stat.S_IXOTH


def test_build_dir_falls_back_to_the_user_cache_when_read_only(tmp_path, monkeypatch):
    site = tmp_path / "site"
    pkg, pkg_built = site / "genomad_torch", site / "built" / "genomad_torch"
    (pkg_built / "build").mkdir(parents=True)  # a writable build/ in a read-only package
    pkg.mkdir()
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path / "cache"))
    assert bd.build_dir(pkg) == pkg / "build"  # writable: the package's own build/
    if os.geteuid() == 0:  # root passes every permission check: judge by the mode bits, as for a user
        monkeypatch.setattr(bd, "_writable", lambda p: bool(p.stat().st_mode & stat.S_IWUSR))
    pkg.chmod(READ_ONLY)
    pkg_built.chmod(READ_ONLY)
    try:
        assert bd.build_dir(pkg) == tmp_path / "cache" / "genomad_torch"
        assert bd.build_dir(pkg_built) == pkg_built / "build"
        monkeypatch.delenv("XDG_CACHE_HOME")
        assert bd.build_dir(pkg) == Path.home() / ".cache" / "genomad_torch"
    finally:
        pkg.chmod(stat.S_IRWXU)
        pkg_built.chmod(stat.S_IRWXU)


def test_kernel_and_prefilter_builds_use_the_build_dir():
    """The kernels and the prefilter build where build_dir says (the
    checkout's package is writable: its own build/)."""
    from genomad_torch import native
    from genomad_torch.ops import _build

    assert _build._target("sw").parent == bd.build_dir() == PORT / "build"
    assert bd.library_path("genomad_native", native._SOURCES, native._GXX_FLAGS).parent == bd.build_dir()
    assert _build.CSRC == PORT / "csrc"


@pytest.mark.parametrize("module", ["ops._build", "native"])
def test_builds_follow_a_read_only_install(tmp_path, module):
    """In a fresh process whose package directory reports read-only, the
    kernels and the prefilter both build into the cache directory (the
    prefilter is built there and loaded from there)."""
    library = {"ops._build": "m._target('sw')", "native": "m.library()._name"}[module]
    code = (
        "import os, sys; from pathlib import Path; import genomad_torch.build_dir as bd; "
        "bd._writable = lambda p: False; "
        f"import genomad_torch.{module} as m; "
        f"print(Path({library}).parent)"
    )
    env = {**os.environ, "XDG_CACHE_HOME": str(tmp_path)}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True, text=True, timeout=120, check=True)
    assert Path(out.stdout.strip()) == tmp_path / "genomad_torch"


def test_kernels_and_prefilter_are_named_by_content_and_flags(tmp_path):
    """One naming scheme for every native library: a hash of the sources'
    content and the compiler flags. A touched file keeps its library; an
    edited source or another flag names a new one."""
    from genomad_torch import native
    from genomad_torch.ops import _build

    src = tmp_path / "a.cpp"
    src.write_text("int f() { return 1; }\n")
    name = bd.library_name("x", [src], ["-O3"])
    assert name.startswith("libx-") and name.endswith(".so")
    os.utime(src, (0, 0))
    assert bd.library_name("x", [src], ["-O3"]) == name
    assert bd.library_name("x", [src], ["-O2"]) != name
    src.write_text("int f() { return 2; }\n")
    assert bd.library_name("x", [src], ["-O3"]) != name
    prefilter = bd.library_path("genomad_native", native._SOURCES, native._GXX_FLAGS)
    assert prefilter.name == bd.library_name("genomad_native", sorted((PORT / "native").glob("*.cpp")), native._GXX_FLAGS)
    assert native.library()._name == str(prefilter)
    assert _build._target("sw").name == bd.library_name("sw", sorted((PORT / "csrc").glob("*.cu*")), _build.NVCC_FLAGS)


def test_a_failed_host_build_raises_with_the_compiler_output(tmp_path, monkeypatch):
    """The C++ prefilter is the search's only prefilter: when its compiler
    fails, loading it raises with the compiler's output, and so does a
    search that needs it, in place of returning hits. Nothing is left in
    the build dir."""
    from genomad_torch import native
    from genomad_torch.ops import protein_search as tps
    from genomad_torch.ops.profiledb import ProfileDB

    cxx = tmp_path / "cxx"
    cxx.write_text("#!/bin/sh\necho 'prefilter.cpp:1:1: error: this compiler always fails'\nexit 1\n")
    cxx.chmod(0o755)
    monkeypatch.setattr(native, "_CXX", str(cxx))
    monkeypatch.setattr(bd, "_writable", lambda p: False)
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path / "cache"))
    db = ProfileDB.synthetic(seed=5, n_profiles=300, min_len=40, max_len=60)  # above 256: the search prefilters
    native.library.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="this compiler always fails"):
            native.library()
        with pytest.raises(RuntimeError, match="this compiler always fails"):
            tps.search(["q"], ["MKVLAAGIVGLLSTAQAQE" * 4], db, device="cpu")
    finally:
        native.library.cache_clear()
    assert list((tmp_path / "cache" / "genomad_torch").iterdir()) == []
