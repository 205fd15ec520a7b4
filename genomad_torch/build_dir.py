"""Where the port builds its native code: the CUDA kernels
(``ops._build``) and the C++ prefilter (``native``).

In a checkout, or any install whose package directory can be written, that
is the package's own ``build/`` (gitignored). An installed package's
directory may be read-only (a system or shared environment); its builds
then go to the user's cache, ``$XDG_CACHE_HOME/genomad_torch`` (by default
``~/.cache/genomad_torch``). Every library there is named by a hash of
its sources' content and its compiler flags (:func:`library_name`), so an
edited source builds anew and versions that share the cache never load
each other's.
"""

from __future__ import annotations

import hashlib
import os
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
