"""Build and load the hand-written CUDA kernels (``genomad_torch/csrc``).

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled at first
use by ``nvcc`` into ``<build dir>/lib<name>-<hash>.so`` (the hash covers
the sources and the flags, so an edited source is rebuilt), then loaded with
``ctypes``. The build dir is ``genomad_torch/build/``, or the user cache
when the installed package cannot be written (``genomad_torch.build_dir``).
Nothing here includes PyTorch's headers: a build takes seconds. Pointers cross as ``c_void_p`` and the stream is PyTorch's
current stream; every entry point returns ``cudaGetLastError()``, which
:func:`check` turns into an exception.

Only the CUDA toolkit is needed (``nvcc`` on PATH, or under ``CUDA_HOME`` or
``/usr/local/cuda``). Nothing is built or loaded when this module is
imported.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

from genomad_torch.build_dir import PACKAGE_DIR, build_dir, library_name

CSRC = PACKAGE_DIR / "csrc"
BUILD_DIR = build_dir()
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]
SOURCES = ("embed_conv", "embed_conv_wgrad", "causal_conv", "fused_reduce", "sw")

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and Path(root, "bin", "nvcc").exists():
            return str(Path(root, "bin", "nvcc"))
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def _target(name: str) -> Path:
    # every source of csrc, since the .cuh headers are shared
    return BUILD_DIR / library_name(name, sorted(CSRC.glob("*.cu*")), NVCC_FLAGS)


def build(names=SOURCES) -> dict[str, str]:
    """Compile the named kernels that are not built yet, one ``nvcc`` per
    source, all started together. Returns each build's compiler output
    (register and shared-memory use from ``-Xptxas -v``)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        target = _target(name)
        if target.exists():
            continue
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), tmp, target)
    logs = {}
    failed = []
    for name, (proc, tmp, target) in procs.items():
        out, _ = proc.communicate()
        logs[name] = out
        if proc.returncode != 0:
            failed.append(f"{name}:\n{out}")
            continue
        os.replace(tmp, target)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return logs


def load(name: str, signatures: dict) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built if needed.
    ``signatures`` maps each C entry point to its ``argtypes``; every entry
    point returns an int (a ``cudaError_t``)."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            target = _target(name)
            if not target.exists():
                build((name,))
            lib = ctypes.CDLL(str(target))
            for fn, argtypes in signatures.items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
            _libs[name] = lib
        return lib


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError_t {err}")


def stream_ptr(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def on_cuda(*tensors: torch.Tensor) -> bool:
    """True for CUDA inputs (launch the kernel), False for CPU inputs (take
    the plain version); raises on mixed or other devices."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"inputs are on different devices: {sorted(map(str, devices))}")
    device = devices.pop()
    if device.type == "cuda":
        return True
    if device.type == "cpu":
        return False
    raise ValueError(f"unsupported device {device}")


def refuse_grad(what: str, *tensors: torch.Tensor) -> None:
    """Raises when grad mode is on and an input requires grad. The kernels
    have no backward and write into ``torch.empty`` through ctypes, so
    their outputs carry no ``grad_fn``: a training forward that reached one
    would drop every gradient upstream of it without an error. Inference
    never trips this (the model holds buffers; the nn pipeline runs under
    ``inference_mode``)."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{what}: the kernel has no backward; an input requires grad. Train "
            "through the differentiable forward (genomad_torch.models.igloo.apply_train)."
        )


def require(cond: bool, message: str) -> None:
    if not cond:
        raise ValueError(message)


# dtypes every kernel takes: float32 for parity runs, bfloat16 in production
DTYPES = (torch.float32, torch.bfloat16)
# the bf16 tensor-core kernels are built for the model's channel count
TC_CHANNELS = 128

P = ctypes.c_void_p
I = ctypes.c_int
F = ctypes.c_float
