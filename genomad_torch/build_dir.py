"""How the port builds and loads its native code: the CUDA kernels
(``ops._build``, with ``nvcc``) and the C++ prefilter (``native``, with
``g++``).

A library goes to the package's own ``build/`` (gitignored) in a checkout,
or any install whose package directory can be written. An installed
package's directory may be read-only (a system or shared environment); its
builds then go to the user's cache, ``$XDG_CACHE_HOME/genomad_torch`` (by
default ``~/.cache/genomad_torch``). Every library there is named by a hash
of its sources' content and its compiler flags (:func:`library_name`), so
an edited source builds anew and versions that share the cache never load
each other's. A build that fails raises with the compiler's output: there
is no fallback to select.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parent


def _writable(path: Path) -> bool:
    return os.access(path, os.W_OK)


def build_dir(package_dir: Path = PACKAGE_DIR) -> Path:
    """``package_dir / "build"`` when it (or, before it exists, the package
    directory) can be written, else the user cache directory. Creates
    nothing."""
    local = package_dir / "build"
    if _writable(local if local.is_dir() else package_dir):
        return local
    cache = os.environ.get("XDG_CACHE_HOME") or Path.home() / ".cache"
    return Path(cache) / "genomad_torch"


def library_name(name: str, sources, flags) -> str:
    """``lib<name>-<hash>.so``, the hash over the content of ``sources`` (in
    their order) and the compiler ``flags``."""
    digest = hashlib.sha256()
    for src in sources:
        digest.update(Path(src).read_bytes())
    digest.update(" ".join(flags).encode())
    return f"lib{name}-{digest.hexdigest()[:16]}.so"


def library_path(name: str, sources, flags) -> Path:
    """Where the library ``name`` of ``sources`` and ``flags`` is built."""
    return build_dir() / library_name(name, sources, flags)


def compile_library(name: str, compiler: str, sources, flags, hashed=None) -> tuple[Path, str]:
    """The library ``name``: ``compiler flags sources -o lib``, unless it is
    built already. Its name hashes ``hashed`` (default ``sources``; pass
    the headers they include too) and ``flags``. The compiler writes a
    file private to this process and thread, renamed into place, so a
    concurrent first use never loads a half-written library. Returns the
    path and the compiler's output (empty when nothing was built); raises
    ``RuntimeError`` with that output when the compiler fails or cannot
    run."""
    target = library_path(name, sources if hashed is None else hashed, flags)
    if target.exists():
        return target, ""
    target.parent.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".{os.getpid()}-{threading.get_ident()}.tmp")
    cmd = [compiler, *flags, *map(str, sources), "-o", str(tmp)]
    try:
        proc = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    except OSError as e:
        raise RuntimeError(f"{name}: cannot run {compiler}: {e}") from e
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"{name}: {' '.join(cmd)} failed with exit code {proc.returncode}:\n{proc.stdout}")
    os.replace(tmp, target)
    return target, proc.stdout


def load_library(path: Path, signatures: dict, restype=ctypes.c_int) -> ctypes.CDLL:
    """The library at ``path``, with ``signatures`` (each entry point's
    ``argtypes``) and ``restype`` applied to its entry points: the kernels
    return an int ``cudaError_t``, the prefilter an int64."""
    lib = ctypes.CDLL(str(path))
    for fn, argtypes in signatures.items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = restype
    return lib
