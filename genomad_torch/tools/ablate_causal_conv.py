"""Where K4's time goes: the bf16 ``causal_conv`` kernel beside copies of
itself with one part taken out, timed on the card.

    python -m genomad_torch.tools.ablate_causal_conv [B] [L]

Builds ``genomad_torch/csrc/causal_conv.cu`` and, from the same source with
a line edited out, kernels that skip the products (the memory path and the
epilogue alone), the x loads (the producer marks each buffer full without
loading it), the output stores, or the loads and the stores (the
tensor-core path and the epilogue's arithmetic alone). Their
outputs are wrong by design; only their times mean something. Each runs at
B x L x 128 (default 128 x 6,016, the nn path's shape), in turns with the
others and with two yardsticks: ``F.conv1d`` (cuDNN) on the same inputs,
and a ``copy_`` of x, which moves the bytes K4 must move (x read, out
written) at the rate the card's memory reaches. Prints milliseconds per
launch (min and median of the turns), and the median SM clock and board
power nvidia-smi reads while each runs alone for a second, as one JSON line,
beside the card's name and power limit. A measurement: it needs a card and raises without
one.
"""

from __future__ import annotations

import ctypes
import json
import shutil
import statistics
import subprocess
import sys

import torch

from genomad_torch.ops import _build, conv

# text in causal_conv.cu -> what each ablation puts in its place
_PRODUCTS = ("wgmma_m64n128k16(d, da, db, k | kk);", "if (k < 0) wgmma_m64n128k16(d, da, db, k | kk);")
# the producer completes each buffer's barrier without loading anything
_LOADS = ("mbar_expect(full, X_BYTES);\n                    asm volatile(",
          "mbar_arrive(full);\n                    if (tile < 0) asm volatile(")
_STORES = ("if (pos < L) *reinterpret_cast<uint4*>", "if (pos < 0) *reinterpret_cast<uint4*>")
ABLATIONS = {
    "kernel": (),
    "no products": (_PRODUCTS,),
    "no x loads": (_LOADS,),
    "no stores": (_STORES,),
    "products only": (_LOADS, _STORES),
}


def ablated_sources(source: str) -> dict[str, str]:
    """Each ablation's source; raises if an edited line is not in
    ``source`` exactly once (the kernel changed under the tool)."""
    out = {}
    for name, edits in ABLATIONS.items():
        text = source
        for old, new in edits:
            if text.count(old) != 1:
                raise ValueError(f"{name}: expected one {old!r} in causal_conv.cu")
            text = text.replace(old, new)
        out[name] = text
    return out


def build_variants(name: str, sources: dict[str, str]) -> dict[str, ctypes.CDLL]:
    """Each source text built as ``csrc/<name>.cu`` beside copies of the
    shared headers (one nvcc each, all started together) and loaded with
    the entry points of ``ops.conv._SIGNATURES[name]``."""
    root = _build.BUILD_DIR / f"ablate_{name}"
    shutil.rmtree(root, ignore_errors=True)
    procs = {}
    for i, (variant, text) in enumerate(sources.items()):
        d = root / str(i)
        d.mkdir(parents=True)
        (d / f"{name}.cu").write_text(text)
        for header in _build.CSRC.glob("*.cuh"):
            shutil.copy(header, d)
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(d / "lib.so"), str(d / f"{name}.cu")]
        procs[variant] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), d)
    libs = {}
    for variant, (proc, d) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {variant}:\n{log}")
        lib = ctypes.CDLL(str(d / "lib.so"))
        for fn, argtypes in conv._SIGNATURES[name].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        libs[variant] = lib
    return libs


def _ms(fn, iters: int = 50) -> float:
    for _ in range(3):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _clocks(fn, seconds: float = 1.0) -> dict:
    """Median SM clock (MHz) and board power (W) that nvidia-smi samples
    while ``fn`` runs back to back for about ``seconds``."""
    per_call = _ms(fn, iters=10) / 1e3
    smi = subprocess.Popen(["nvidia-smi", "--query-gpu=clocks.sm,power.draw", "--format=csv,noheader,nounits",
                            "-lms", "50"], stdout=subprocess.PIPE, text=True)
    try:
        for _ in range(max(1, int(seconds / per_call))):
            fn()
        torch.cuda.synchronize()
    finally:
        smi.terminate()
    # the first two samples may come before the loop starts
    samples = [line.split(",") for line in smi.communicate()[0].splitlines()[2:] if line.strip()]
    if not samples:
        return {"sm_mhz": None, "power_w": None}
    return {"sm_mhz": statistics.median(float(c) for c, _ in samples),
            "power_w": statistics.median(float(p) for _, p in samples)}


def main(B: int = 128, L: int = 6016, turns: int = 3) -> dict:
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: this tool times kernels on the card")
    C = _build.TC_CHANNELS
    libs = build_variants("causal_conv", ablated_sources((_build.CSRC / "causal_conv.cu").read_text()))
    gen = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn((B, L, C), generator=gen, device="cuda").bfloat16()
    w = (torch.randn((6, C, C), generator=gen, device="cuda") * 0.05).bfloat16()
    bias = (torch.randn(C, generator=gen, device="cuda") * 0.1).bfloat16()
    out = torch.empty_like(x)
    stream = _build.stream_ptr(x.device)
    slope = conv._slope(torch.bfloat16)

    def launch(lib):
        _build.check(lib.causal_conv_launch(x.data_ptr(), w.data_ptr(), bias.data_ptr(), out.data_ptr(),
                                            B, L, C, 1, slope, 1, stream), "causal_conv")

    x_ncl, w_oik = x.transpose(1, 2).contiguous(), w.permute(2, 1, 0).contiguous()
    copy_out = torch.empty_like(x)
    runs = {name: (lambda lib=lib: launch(lib)) for name, lib in libs.items()}
    runs["F.conv1d (cuDNN)"] = lambda: torch.nn.functional.conv1d(x_ncl, w_oik, bias, padding=5)
    runs["copy_ of x (bytes floor)"] = lambda: copy_out.copy_(x)
    times = {name: [] for name in runs}
    for _ in range(turns):  # in turns, forward and back, so drift hits every run alike
        for name in list(runs) + list(runs)[::-1]:
            times[name].append(_ms(runs[name]))
    clocks = {name: _clocks(fn) for name, fn in runs.items()}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    result = {
        "card": smi, "B": B, "L": L, "C": C,
        "ms": {name: {"min": min(t), "median": statistics.median(t), **clocks[name]} for name, t in times.items()},
    }
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main(*map(int, sys.argv[1:3]))
