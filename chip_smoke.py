#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``genomad_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py        # from the root of a checkout, one card

Phases (any failure makes the script exit non-zero without the final line):

1. device   - requires CUDA; prints the card's name and power limit.
2. build    - compiles every kernel of ``genomad_torch/csrc`` with nvcc.
3. kernels  - holds K5 embed_conv, K4 causal_conv and K2 fused_reduce against
              their plain PyTorch versions at the main path's shapes (B=128,
              L=6016, C=128, full-size synthetic weights, tokens from random
              DNA with N runs) in bf16 and in f32 (TF32 off), and at a ragged
              shape; times kernel, plain version and the PyTorch library call
              that computes the same function, beside the card's bound.
4. main     - nn-classification through its entry point on a synthetic
              metagenome of >= 24 Mbp (bf16, batch 128); checks the TSV, the
              kernels' launch counts, and the f32 forward with the kernels
              against the all-plain f32 forward on the CPU.

Prints the kernel table as one JSON line ({"kernels": [...]}), the
``nvidia-smi`` name and power limit, and, last, the device line
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import math
import re
import subprocess
import sys
import tempfile
import time
import traceback
from pathlib import Path

import numpy as np
import torch

SEED = 0
BATCH = 128  # the CLI default
N_CONTIGS = 400
CONTIG_BP = 60_000
# H100 SXM data-sheet peaks (dense): memory and the rates each kernel's
# operations run at
PEAK_BYTES_PER_S = 3.35e12
PEAK_BF16_TC_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12

# tolerances, |kernel - plain| <= atol + rtol * |plain|:
# bf16 outputs may differ by about one bf16 rounding step (2^-8 relative)
# where the f32 accumulations of the tensor cores and of cuBLAS round to
# different neighbours; f32 outputs differ by summation order only.
TOL = {
    torch.bfloat16: dict(rtol=1.6e-2, atol=1e-2),
    torch.float32: dict(rtol=1e-4, atol=1e-4),
}
# the f32 probabilities of the whole forward, kernels on the card vs plain on the CPU
FORWARD_F32_ATOL = 1e-4


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_time(fn, iters: int, warmup: int = 2) -> float:
    """Mean milliseconds per call, by CUDA events around `iters` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def max_err(got, ref, dtype) -> float:
    """Max |got - ref|; raises when any element is outside the tolerance."""
    got, ref = got.float(), ref.float()
    tol = TOL[dtype]
    if not torch.isfinite(got).all():
        raise AssertionError("kernel output is not finite")
    bad = (got - ref).abs() > tol["atol"] + tol["rtol"] * ref.abs()
    err = float((got - ref).abs().max())
    if bool(bad.any()):
        raise AssertionError(f"{int(bad.sum())} elements outside {tol} (max abs err {err})")
    return err


def random_bases(rng, n, length=6000, n_fraction=0.02):
    """(n, length) base codes of random DNA with N runs."""
    codes = rng.integers(0, 4, size=(n, length), dtype=np.uint8)
    for row in codes:
        for start in rng.integers(0, length, size=max(1, int(n_fraction * length / 20))):
            row[start : start + int(rng.integers(1, 40))] = 4
    return codes


def bound(bytes_moved: float, bf16_tc_flops: float = 0.0, f32_flops: float = 0.0):
    t_bytes = bytes_moved / PEAK_BYTES_PER_S * 1e3
    t_ops = (bf16_tc_flops / PEAK_BF16_TC_FLOPS + f32_flops / PEAK_F32_FLOPS) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# Phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------


def kernel_phase(results: dict) -> None:
    from genomad_torch.device import disable_tf32
    from genomad_torch.models import igloo
    from genomad_torch.ops import conv, patch_reduce

    disable_tf32()
    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED)
    raw = igloo.init_params(SEED)
    bases = torch.from_numpy(random_bases(rng, BATCH)).to(dev)
    tokens = igloo._tokens_from_bases(igloo._pad_bases(bases)).contiguous()  # (128, 6016)
    B, L = tokens.shape
    C = igloo.CHANNELS
    entries = {}

    for dtype in (torch.float32, torch.bfloat16):
        p = igloo.params_from_numpy(raw, dtype)
        p = {g: {n: t.to(dev) for n, t in d.items()} for g, d in p.items()}
        name = str(dtype).split(".")[1]
        h1 = conv.embed_conv(tokens, p["conv1"]["kernel"], p["conv1"]["bias"])
        e5 = max_err(h1, conv.embed_conv_plain(tokens, p["conv1"]["kernel"], p["conv1"]["bias"]), dtype)
        h2 = conv.causal_conv(h1, p["conv2"]["kernel"], p["conv2"]["bias"])
        e4 = max_err(h2, conv.causal_conv_plain(h1, p["conv2"]["kernel"], p["conv2"]["bias"]), dtype)
        e4n = max_err(
            conv.causal_conv(h1, p["conv3"]["kernel"], p["conv3"]["bias"], apply_leaky=False),
            conv.causal_conv_plain(h1, p["conv3"]["kernel"], p["conv3"]["bias"], apply_leaky=False),
            dtype,
        )
        ig = p["igloo1"]
        mpi, pooled = patch_reduce.fused_reduce(h1, ig["patches"], ig["w_patch"], ig["w_v"])
        mpi_ref, pooled_ref = patch_reduce.fused_reduce_plain(h1, ig["patches"], ig["w_patch"], ig["w_v"])
        e2m = max_err(mpi, mpi_ref, torch.float32)  # mpi is f32 for both dtypes
        e2p = max_err(pooled, pooled_ref, dtype)
        torch.cuda.synchronize()
        log(f"# kernels {name} B={B} L={L}: K5 {e5:.3g}  K4 {e4:.3g} (no leaky {e4n:.3g})  K2 mpi {e2m:.3g} pooled {e2p:.3g}")
        if dtype == torch.bfloat16:
            entries = {
                "embed_conv": dict(err=e5, args=(tokens, p["conv1"]["kernel"], p["conv1"]["bias"])),
                "causal_conv": dict(err=max(e4, e4n), args=(h1, p["conv2"]["kernel"], p["conv2"]["bias"])),
                "fused_reduce": dict(err=max(e2m, e2p), args=(h1, ig["patches"], ig["w_patch"], ig["w_v"])),
            }

    # ragged shapes: B and L multiples of no tile
    for dtype in (torch.float32, torch.bfloat16):
        Br, Lr = 3, 1001
        tok = torch.from_numpy(rng.integers(0, 257, (Br, Lr), dtype=np.int32)).to(dev)
        tok[0, :9] = 0
        k1 = torch.from_numpy(rng.normal(0, 0.2, (6, 257, C)).astype(np.float32)).to(dev, dtype)
        k2 = torch.from_numpy(rng.normal(0, 0.1, (6, C, C)).astype(np.float32)).to(dev, dtype)
        bias = torch.from_numpy(rng.normal(0, 0.2, C).astype(np.float32)).to(dev, dtype)
        x = conv.embed_conv(tok, k1, bias)
        max_err(x, conv.embed_conv_plain(tok, k1, bias), dtype)
        max_err(conv.causal_conv(x, k2, bias), conv.causal_conv_plain(x, k2, bias), dtype)
        patches = torch.from_numpy(igloo.random_patches(rng, vector_size=Lr)).to(dev)
        w_patch = torch.from_numpy(rng.normal(0, 0.1, (igloo.N_PATCHES, 4, C)).astype(np.float32)).to(dev, dtype)
        w_v = k2[0].contiguous()
        mpi, pooled = patch_reduce.fused_reduce(x, patches, w_patch, w_v)
        mpi_ref, pooled_ref = patch_reduce.fused_reduce_plain(x, patches, w_patch, w_v)
        max_err(mpi, mpi_ref, torch.float32)
        max_err(pooled, pooled_ref, dtype)
    log("# ragged B=3 L=1001: all kernels agree with their plain versions (f32, bf16)")

    # timings at the main path's shapes, bf16
    tok, k1, b1 = entries["embed_conv"]["args"]
    h1, k2, b2 = entries["causal_conv"]["args"]
    y, patches, w_patch, w_v = entries["fused_reduce"]["args"]
    V = k1.shape[1]
    # library yardsticks (timed only here; the port never calls them)
    table = torch.cat([k1.reshape(6 * V, C), k1.new_zeros(1, C)])  # last row: causal padding
    padded = torch.nn.functional.pad(tok.long(), (5, 0), value=-1)
    bag = torch.stack([padded[:, k : k + L] for k in range(6)], dim=-1)
    bag = torch.where(bag >= 0, bag + V * torch.arange(6, device=dev), torch.full_like(bag, 6 * V)).reshape(-1, 6)
    x_ncl = h1.transpose(1, 2).contiguous()
    w_oik = k2.permute(2, 1, 0).contiguous()  # (C_out, C_in, 6)

    es = h1.element_size()
    timings = {
        "embed_conv": dict(
            kernel=lambda: conv.embed_conv(tok, k1, b1),
            plain=lambda: conv.embed_conv_plain(tok, k1, b1),
            library=lambda: torch.nn.functional.embedding_bag(bag, table, mode="sum"),
            bound=bound(tok.numel() * 4 + k1.numel() * es + C * es + B * L * C * es, f32_flops=B * L * C * 6),
            replaces="genomad_tpu/ops/conv_pallas.py:160",
            launches_per_batch=1,
        ),
        "causal_conv": dict(
            kernel=lambda: conv.causal_conv(h1, k2, b2),
            plain=lambda: conv.causal_conv_plain(h1, k2, b2),
            library=lambda: torch.nn.functional.conv1d(x_ncl, w_oik, b2, padding=5),
            bound=bound(2 * B * L * C * es + k2.numel() * es + C * es, bf16_tc_flops=2 * 6 * C * C * L * B),
            replaces="genomad_tpu/ops/conv_pallas.py:80",
            launches_per_batch=2,
        ),
        "fused_reduce": dict(
            kernel=lambda: patch_reduce.fused_reduce(y, patches, w_patch, w_v),
            plain=lambda: patch_reduce.fused_reduce_plain(y, patches, w_patch, w_v),
            library=None,
            bound=bound(
                y.numel() * es + patches.numel() * 4 + w_patch.numel() * es + w_v.numel() * es
                + B * patches.shape[0] * 4 + B * (L // 8) * C * es,
                bf16_tc_flops=2 * B * (L // 8 * 8) * C * C,
                f32_flops=2 * B * patches.numel() * C,
            ),
            replaces="genomad_tpu/ops/patch_reduce.py:162",
            launches_per_batch=2,
        ),
    }
    for name, t in timings.items():
        ms = cuda_time(t["kernel"], iters=20)
        plain_ms = cuda_time(t["plain"], iters=3, warmup=1)
        library_ms = None
        if t["library"] is not None:
            try:
                library_ms = cuda_time(t["library"], iters=20)
            except RuntimeError as exc:  # a yardstick only: report it and go on
                log(f"# {name}: library call failed ({exc}); library_ms = null")
        bound_ms, bound_by = t["bound"]
        results[name] = {
            "name": name,
            "route": "cuda",
            "source": f"genomad_torch/csrc/{name}.cu",
            "replaces": t["replaces"],
            "launches": None,  # filled from the main path's run
            "launches_per_batch": t["launches_per_batch"],
            "max_abs_err": entries[name]["err"],
            "ms": ms,
            "plain_ms": plain_ms,
            "bound_ms": bound_ms,
            "bound_by": bound_by,
            "library_ms": library_ms,
        }
        log(
            f"# {name}: {ms:.4f} ms (plain {plain_ms:.4f}, library {library_ms}, bound {bound_ms:.4f} by {bound_by}), "
            f"{t['launches_per_batch']} launch(es) per batch"
        )


# ---------------------------------------------------------------------------
# Phase 4: the main path through nn-classification
# ---------------------------------------------------------------------------


def write_metagenome(path: Path, rng) -> int:
    """>= 24 Mbp: 400 contigs of 60 kbp with N runs, plus short and N-rich
    ones. Returns the number of bases written."""
    alphabet = np.frombuffer(b"ACGT", dtype=np.uint8)
    total = 0
    with open(path, "w") as f:
        for i in range(N_CONTIGS):
            seq = alphabet[rng.integers(0, 4, CONTIG_BP)]
            for start in rng.integers(0, CONTIG_BP, size=5):
                seq[start : start + int(rng.integers(10, 200))] = ord("N")
            f.write(f">contig_{i} synthetic\n{seq.tobytes().decode()}\n")
            total += CONTIG_BP
        extras = {
            "short_1200": alphabet[rng.integers(0, 4, 1_200)].tobytes().decode(),
            "short_3000": alphabet[rng.integers(0, 4, 3_000)].tobytes().decode(),
            "n_rich": (
                alphabet[rng.integers(0, 4, 6_000)].tobytes().decode() + "N" * 5_000
                + alphabet[rng.integers(0, 4, 7_000)].tobytes().decode()
            ),
            "n_flanked": "N" * 300 + alphabet[rng.integers(0, 4, 9_000)].tobytes().decode() + "n" * 50,
        }
        for name, seq in extras.items():
            f.write(f">{name}\n{seq}\n")
            total += len(seq)
    return total


def main_path_phase(results: dict, workdir: Path, card: str) -> dict:
    from genomad_torch import utils
    from genomad_torch.models import igloo, weights
    from genomad_torch.modules import nn_classification
    from genomad_torch.ops import conv, patch_reduce
    from genomad_torch.paths import GenomadOutputs

    rng = np.random.default_rng(SEED + 1)
    fasta = workdir / "metagenome.fna"
    total_bp = write_metagenome(fasta, rng)
    out_dir = workdir / "out"

    # launches made above to compare and time the kernels do not count
    kernels = (conv.embed_conv, conv.causal_conv, patch_reduce.fused_reduce)
    for k in kernels:
        k.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    nn_classification.main(fasta, out_dir, batch_size=BATCH, verbose=False)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k.__name__: k.launches for k in kernels}
    peak_mem_gib = torch.cuda.max_memory_allocated() / 2**30

    outputs = GenomadOutputs(utils.output_prefix(fasta), out_dir)
    n_windows = len(np.load(outputs.seq_window_id_output)["contig_ids"])
    n_batches = math.ceil(n_windows / BATCH)
    rows = outputs.nn_classification_output.read_text().splitlines()
    n_contigs = N_CONTIGS + 4
    if rows[0] != "seq_name\tchromosome_score\tplasmid_score\tvirus_score" or len(rows) != n_contigs + 1:
        raise AssertionError(f"expected a header and {n_contigs} rows, got {len(rows)} lines")
    scores = np.array([[float(v) for v in r.split("\t")[1:]] for r in rows[1:]])
    if scores.shape != (n_contigs, 3) or not np.isfinite(scores).all():
        raise AssertionError(f"bad score table shape {scores.shape}")
    worst = float(np.abs(scores.sum(1) - 1).max())
    if worst > 1.5e-4 + 1e-9:  # three 4-decimal roundings
        raise AssertionError(f"a score row sums to 1 +- {worst}")

    # the module's own stage timers, in the log in order: window-encoding,
    # nn-inference (the log file drops the bracketed stage names)
    encode_s, inference_s = map(float, re.findall(r"completed in ([0-9.]+)s", outputs.nn_classification_log.read_text()))

    # f32 forward with the kernels against the all-plain f32 forward on the CPU
    bases = np.load(outputs.seq_window_id_output)["bases"][:: max(1, n_windows // 6)][:6]
    raw = weights.load_params()
    with torch.inference_mode():
        gpu = igloo.IglooClassifier(raw, device="cuda", dtype=torch.float32).forward_bases(torch.from_numpy(bases).cuda()).cpu()
        cpu = igloo.IglooClassifier(raw, device="cpu", dtype=torch.float32).forward_bases(torch.from_numpy(bases))
    fwd_err = float((gpu - cpu).abs().max())
    if not fwd_err <= FORWARD_F32_ATOL:
        raise AssertionError(f"f32 forward with kernels differs from the plain forward by {fwd_err}")

    summary = {
        "card": card,
        "input_bp": total_bp,
        "contigs": n_contigs,
        "windows": n_windows,
        "batches": n_batches,
        "wall_s": wall,
        "encode_s": encode_s,
        "inference_s": inference_s,
        "windows_per_s": n_windows / inference_s,
        "mbp_per_s_inference": n_windows * 6000 / 1e6 / inference_s,
        "mbp_per_s_end_to_end": total_bp / 1e6 / wall,
        "launches": launches,
        "forward_f32_max_abs_err_vs_cpu_plain": fwd_err,
        "peak_mem_gib": peak_mem_gib,
    }
    log("# main path: " + json.dumps(summary))

    expect = {name: results[name]["launches_per_batch"] * n_batches for name in launches}
    for name, n in launches.items():
        results[name]["launches"] = n
    if launches != expect:
        raise AssertionError(f"launch counts {launches} != expected {expect} for {n_batches} batches")

    log("# where the time goes: " + json.dumps(where_the_time_goes(fasta, outputs.seq_window_id_output, workdir)))
    return summary


def where_the_time_goes(fasta: Path, cache_npz: Path, workdir: Path) -> dict:
    """The main path's stages timed one by one on the same input (host clock,
    synchronised), and the device's share of a steady inference pass
    (torch.profiler's kernel time over the pass's wall time). Diagnostics
    only: a failure here is reported, not fatal."""
    from genomad_torch import sequence, utils
    from genomad_torch.models import igloo, weights
    from genomad_torch.ops import nn_pipeline

    stages: dict = {}

    def timed(name, fn):
        torch.cuda.synchronize()
        start = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        stages[name] = time.perf_counter() - start
        return out

    try:
        timed("check_fasta_s", lambda: sequence.check_fasta(fasta))
        timed("md5_s", lambda: utils.get_md5(fasta))
        bases = timed("encode_windows_s", lambda: nn_pipeline.encode_windows(fasta)[0])
        timed("savez_compressed_s", lambda: np.savez_compressed(workdir / "cache.npz", bases=bases))
        timed("load_cache_s", lambda: np.load(cache_npz)["bases"])
        raw = timed("load_params_s", weights.load_params)
        model = timed("model_to_device_s", lambda: igloo.IglooClassifier(raw))
        n_batches = math.ceil(len(bases) / BATCH)
        timed("predict_windows_steady_s", lambda: nn_pipeline.predict_windows(model, bases, BATCH))
        stages["steady_ms_per_batch"] = stages["predict_windows_steady_s"] * 1e3 / n_batches
    except Exception as exc:  # noqa: BLE001 - diagnostics must not hide the contract's result
        stages["error"] = repr(exc)
        return stages
    try:
        from torch.profiler import ProfilerActivity, profile

        few = bases[: 8 * BATCH]
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            nn_pipeline.predict_windows(model, few, BATCH)
        # kernels only: an operator's own entry repeats its kernels' device time
        kernels = [e for e in prof.key_averages() if str(e.device_type).endswith("CUDA")]
        device_us = {e.key: e.self_device_time_total for e in kernels if e.self_device_time_total > 0}
        per_batch_ms = sum(device_us.values()) / 1e3 / math.ceil(len(few) / BATCH)
        stages["device_ms_per_batch"] = per_batch_ms
        stages["device_busy_share"] = per_batch_ms / stages["steady_ms_per_batch"]
        top = sorted(device_us.items(), key=lambda kv: -kv[1])[:10]
        stages["device_ms_per_batch_by_kernel"] = {k[:60]: v / 1e3 / math.ceil(len(few) / BATCH) for k, v in top}
    except Exception as exc:  # noqa: BLE001
        stages["profiler"] = f"not measured: {exc!r}"
    return stages


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs an NVIDIA GPU.", file=sys.stderr)
        return 1
    from genomad_torch.ops import _build

    failures = []
    smi = None
    try:
        smi = nvidia_smi()
        log(f"# device: {torch.cuda.get_device_name(0)} | nvidia-smi: {smi} | torch {torch.__version__} cuda {torch.version.cuda}")
    except Exception:  # noqa: BLE001 - report the phase and go on to the next
        failures.append("device")
        traceback.print_exc()

    try:
        t0 = time.perf_counter()
        logs = _build.build()
        log(f"# build: {time.perf_counter() - t0:.1f} s for {sorted(logs) or 'nothing (already built)'}")
        for name, out in logs.items():
            for line in out.splitlines():
                if "registers" in line or "spill" in line:
                    log(f"#   {name}: {line.strip()}")
    except Exception:  # noqa: BLE001
        failures.append("build")
        traceback.print_exc()

    results: dict = {}
    if not failures:
        try:
            kernel_phase(results)
        except Exception:  # noqa: BLE001
            failures.append("kernels")
            traceback.print_exc()
    if not failures:
        try:
            with tempfile.TemporaryDirectory(prefix="genomad_torch_smoke_") as tmp:
                main_path_phase(results, Path(tmp), smi)
        except Exception:  # noqa: BLE001
            failures.append("main")
            traceback.print_exc()

    if failures:
        print(f"chip_smoke: failed phases: {failures}", file=sys.stderr)
        return 1
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: r[k] for k in keys} for r in results.values()]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
