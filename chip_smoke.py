#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``genomad_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py                  # from the root of a checkout, one card
    python3 chip_smoke.py --only kernels   # device, build and the kernel phase only

Phases (any failure makes the script exit non-zero without the final line).
``--only PHASE[,PHASE]`` runs device and build, the named phases and those
they read from (main and forward read the kernel table; end-to-end reads
kernels, sw and annotate; mesh reads annotate): the quick check of a kernel change. It exits 0
when those phases pass and never prints the kernel table or the final line:
only the full run, with no arguments, does.

1. device   - requires CUDA; prints the card's name and power limit.
2. build    - compiles every kernel of ``genomad_torch/csrc`` with nvcc,
              one process per source, all started together.
3. kernels  - holds K5 embed_conv (tokens) and embed_conv_bases (base
              codes, the tokenizer fused in), K4 causal_conv, K2
              fused_reduce and K3 patch_reduce against their plain PyTorch
              versions at the nn path's shapes (B=128, L=6016, C=128,
              full-size synthetic weights, random DNA with N runs) in bf16
              and in f32 (TF32 off), and at a ragged shape; K5 bit for bit,
              also on ``embed_conv_edge_cases`` (its two forms equal to each
              other); K2 and K3 also on ``fused_reduce_edge_cases`` (K3's
              mpi bit-equal to K2's) and K4 at the edges of its persistent
              schedule (B=1 L=70, B=133 L=6016, L=5); K5, K4 and K2 each
              bit-equal to themselves on a rerun; times
              kernel, plain version and the PyTorch library call that
              computes the same function, beside the card's bound, and K2
              and K3 with all, a quarter and none of the patches; conv1's
              gradient kernel (embed_conv_wgrad) at the training cell's
              shapes against the exact sums, bitwise equal on a rerun, timed
              beside float32 index_add_ and the index_put_ it replaces.
4. sw       - holds K1 sw_pairs (Smith-Waterman) bit for bit against its
              plain version: the annotate path's buckets (Lq = Lp = 128,
              256, 384 and 512, N = 4096 pairs from an integral
              20,000-profile DB staged in bf16), forward and reverse passes,
              with and without the real lengths, a float-PSSM f32 bucket, a
              ragged N, one 1024 x 1024 pair, one 4096-bucket pair, one
              4,500-residue query of the 32768 query bucket and the edge
              cases of ``sw_edge_cases`` (f32 and bf16); the long-profile
              DB's cases (SW_LONG_CASES: the 768 and 1024 chunk widths and
              the long body at 256 x 4096 and 4096 x 4096, bf16 and f32);
              a search over 300 profiles, 40 of them long, card == CPU
              (the long body's launches); times the kernel by case and the
              plain version, beside the bound and the cells/s. ``--only
              sw`` is the loop for K1 work.
5. main     - nn-classification through its entry point on a synthetic
              metagenome of >= 24 Mbp (bf16, batch 128); checks the TSV, the
              kernels' launch counts (K5's bases form, never its token
              form), and the f32 forward with the kernels against the
              all-plain f32 forward on the CPU.
6. forward  - the forward profiler (genomad_torch.tools.profile_forward,
              the path of K3 and of K5's token form) at B=128: ms per stage,
              their launches.
7. annotate - annotate through its entry point on a DB directory with the
              20,000-profile integral DB and a 16-profile integrase DB, over
              a ~2 Mbp synthetic genome with planted marker genes; checks the
              genes table, K1's forward and reverse launches and the card's
              prefilter (every group, no host group), and prints where the
              time goes.
8. end-to-end - cli.run_end_to_end (score calibration on) on annotate's DB
              directory over a ~2 Mbp genome of make_gene genes plus planted
              host-virus-host contigs with an integrase gene: a provirus on
              the planted contigs, K1 in annotate and find-proviruses, K5/K4/K2
              in both NN passes, the summary tables; where the time goes by
              module, K1 by stage, the CRF's T and seconds.
9. mesh     - on annotate's DB, its proteins and 500 queries of the search
              phase's mix (60% planted), search with
              (1, 2) and (2, 4) meshes whose every cell is cuda:0 against
              search without a mesh (targets, integer bitscores, taxids
              equal, E-values within 1e-4), K1's launches by cell; each
              search runs twice, the first staging its DB shards (cold),
              the second timed with its host seconds by stage (warm);
              dense_best_hits with and without a mesh equal;
              predict_windows on a (2, 1) mesh against none (bit for bit).
              One card checks the routing and the merge, not scaling.
10. card-vs-cpu - run_end_to_end on the card and with device="cpu" on a small
              fixture: files byte-equal, NN-branch scores within 1e-2.
11. search  - the marker search on an in-memory 227,897-profile integral DB
              (the real geNomad DB's profile count) with 500 mixed queries:
              cold and steady seconds, k residues/s, pairs, K1 cells/s and
              the staged DB's device memory; a 2,000-profile search on
              the card against the port's own CPU run; the stop rule on
              the card against the CPU over 8.4 M pairs (ms of each).
12. train   - the trainer (genomad_torch.train) at full width in f32 (TF32
              off): 20 steps of make_train_step at B = 64 windows of 5,997
              tokens, dropout 0.2, on a separable toy task (the loss must
              fall by 20%; every leaf's step-1 gradient finite and not all
              zero; conv1's gradient kernel once a step); the training
              loop (train.Trainer.fit) on a labelled
              FASTA of 20 batches (ms per step, windows/s, peak memory);
              one step at B = 4,
              dropout 0, on the card against the CPU; and
              make_sharded_train_step in a one-rank NCCL group
              (initialize_distributed) bit-equal to the unsharded step.

Prints the kernel table as one JSON line ({"kernels": [...]}), the
``nvidia-smi`` name and power limit, and, last, the device line
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import re
import shutil
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

# K1: the f32 operations of _sw_forward's recurrence per DP cell (f: 2 sub
# + max; h0: add + 2 max; t: sub + add; prefix max; e: sub; h: max; row
# max), each one lane-op at 33.5 T/s (132 SMs x 128 lanes x 1.98 GHz, half
# the 67 TFLOP/s f32 rate, which counts an FMA as two)
SW_OPS_PER_CELL = 12
PEAK_F32_LANE_OPS = 33.5e12
SW_DB_PROFILES = 20_000
REAL_DB_PROFILES = 227_897  # the geNomad DB's profile count
SW_PAIRS = 4096
# the 20,000-profile DB's buckets (lengths 60-400); 256 and 384 draw their
# pairs first, so that they stay the pairs of the runs before 128 and 512 joined
SW_BUCKETS = (256, 384, 128, 512)
# K1's long-profile DB: integral and above 4,096 profiles, so it stages in
# bf16 as the real DB does, with lengths 513-3,000 (the 768, 1024 and 4096
# buckets); its cases (name, profile bucket, query bound, pairs): the upper
# two chunk widths, ordinary proteins against long profiles (the common
# real case) and long against long, the long body's
SW_LONG_DB_PROFILES = 4_500
SW_LONG_CASES = (
    ("768x768", 768, 768, 4096), ("1024x1024", 1024, 1024, 4096),
    ("256x4096", 4096, 256, 4096), ("4096x4096", 4096, 4096, 1024),
)
# the long-profile search, card against CPU: 300 profiles, 40 of them long
SW_LONG_SEARCH = dict(n_short=260, n_long=40, long_len=(1025, 3000), queries=60)
GENOME_MBP = 2.0
N_SEARCH_QUERIES = 500
N_HVH_CONTIGS = 3  # planted host-virus-host contigs in the end-to-end input

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
    if got.shape != ref.shape:
        raise AssertionError(f"kernel output shape {tuple(got.shape)} != {tuple(ref.shape)}")
    if got.numel() == 0:
        return 0.0
    tol = TOL[dtype]
    if not torch.isfinite(got).all():
        raise AssertionError("kernel output is not finite")
    bad = (got - ref).abs() > tol["atol"] + tol["rtol"] * ref.abs()
    err = float((got - ref).abs().max())
    if bool(bad.any()):
        raise AssertionError(f"{int(bad.sum())} elements outside {tol} (max abs err {err})")
    return err


def bit_equal(got, ref, what: str) -> float:
    """Raises unless got is finite and equal to ref element for element
    (torch.equal: -0.0 equals +0.0); returns the max abs difference: 0."""
    if got.shape != ref.shape or got.dtype != ref.dtype:
        raise AssertionError(f"{what}: {tuple(got.shape)} {got.dtype} != {tuple(ref.shape)} {ref.dtype}")
    if not torch.isfinite(got.float()).all():
        raise AssertionError(f"{what}: output is not finite")
    if not torch.equal(got, ref):
        raise AssertionError(f"{what}: {int((got != ref).sum())} of {got.numel()} values differ")
    return 0.0


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
    tokens = conv.tokens_from_bases(conv.pad_bases(bases, igloo.L_PAD + 3)).contiguous()  # (128, 6016)
    B, L = tokens.shape
    C = igloo.CHANNELS
    entries = {}

    for dtype in (torch.float32, torch.bfloat16):
        p = igloo.params_from_numpy(raw, dtype)
        p = {g: {n: t.to(dev) for n, t in d.items()} for g, d in p.items()}
        name = str(dtype).split(".")[1]
        k1, b1 = p["conv1"]["kernel"], p["conv1"]["bias"]
        h1 = conv.embed_conv(tokens, k1, b1)
        e5 = bit_equal(h1, conv.embed_conv_plain(tokens, k1, b1), f"K5 {name}")
        bit_equal(conv.embed_conv(tokens, k1, b1, False), conv.embed_conv_plain(tokens, k1, b1, False), f"K5 {name} no leaky")
        hb = conv.embed_conv_bases(bases, k1, b1, L)
        bit_equal(hb, conv.embed_conv_bases_plain(bases, k1, b1, L), f"K5 bases {name}")
        bit_equal(hb, h1, f"K5 bases {name} against the token kernel")
        h2 = conv.causal_conv(h1, p["conv2"]["kernel"], p["conv2"]["bias"])
        e4 = max_err(h2, conv.causal_conv_plain(h1, p["conv2"]["kernel"], p["conv2"]["bias"]), dtype)
        e4n = max_err(
            conv.causal_conv(h1, p["conv3"]["kernel"], p["conv3"]["bias"], apply_leaky=False),
            conv.causal_conv_plain(h1, p["conv3"]["kernel"], p["conv3"]["bias"], apply_leaky=False),
            dtype,
        )
        ig = p["igloo1"]
        ig["slots"] = patch_reduce.slot_table(ig["patches"], ig["w_patch"])
        mpi, pooled = patch_reduce.fused_reduce(h1, ig["patches"], ig["w_patch"], ig["w_v"], slots=ig["slots"])
        mpi_ref, pooled_ref = patch_reduce.fused_reduce_plain(h1, ig["patches"], ig["w_patch"], ig["w_v"])
        e2m = max_err(mpi, mpi_ref, torch.float32)  # mpi is f32 for both dtypes
        e2p = max_err(pooled, pooled_ref, dtype)
        mpi3 = patch_reduce.patch_reduce(h1, ig["patches"], ig["w_patch"], slots=ig["slots"])
        e3 = max_err(mpi3, patch_reduce.patch_reduce_plain(h1, ig["patches"], ig["w_patch"]), torch.float32)
        if not torch.equal(mpi3, mpi):  # one code path: K3's mpi is K2's bit for bit
            raise AssertionError(f"K3 mpi differs from K2 mpi ({dtype}) in {int((mpi3 != mpi).sum())} values")
        torch.cuda.synchronize()
        log(f"# kernels {name} B={B} L={L}: K5 bit-equal (with and without LeakyReLU; the bases form too)  K4 {e4:.3g} (no leaky {e4n:.3g})  K2 mpi {e2m:.3g} pooled {e2p:.3g}  "
            f"K3 {e3:.3g} (bit-equal to K2 mpi)")
        if dtype == torch.bfloat16:
            entries = {
                "embed_conv": dict(err=e5, args=(tokens, p["conv1"]["kernel"], p["conv1"]["bias"])),
                "embed_conv_bases": dict(err=e5, args=(bases, p["conv1"]["kernel"], p["conv1"]["bias"], L)),
                "causal_conv": dict(err=max(e4, e4n), args=(h1, p["conv2"]["kernel"], p["conv2"]["bias"])),
                "fused_reduce": dict(err=max(e2m, e2p), args=(h1, ig["patches"], ig["w_patch"], ig["w_v"]), slots=ig["slots"]),
                "patch_reduce": dict(err=e3, args=(h1, ig["patches"], ig["w_patch"])),
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
        bit_equal(x, conv.embed_conv_plain(tok, k1, bias), "K5 ragged")
        max_err(conv.causal_conv(x, k2, bias), conv.causal_conv_plain(x, k2, bias), dtype)
    log("# ragged B=3 L=1001: K5 bit-equal, K4 agrees with its plain version (f32, bf16)")

    # K5 on the edges of its persistent schedule and of the causal halo,
    # tokens from the plain tokenizer, f32 and bf16
    erng = np.random.default_rng(SEED + 11)
    for case, (bn, Le) in embed_conv_edge_cases().items():
        bases_e = torch.from_numpy(bn).to(dev)
        tok = conv.tokens_from_bases(conv.pad_bases(bases_e, Le + 3)).contiguous()
        for dtype in (torch.float32, torch.bfloat16):
            k1 = torch.from_numpy(erng.normal(0, 0.2, (6, 257, C)).astype(np.float32)).to(dev, dtype)
            bias = torch.from_numpy(erng.normal(0, 0.2, C).astype(np.float32)).to(dev, dtype)
            what = f"K5 edge case {case} {str(dtype).split('.')[1]}"
            x = conv.embed_conv(tok, k1, bias)
            bit_equal(x, conv.embed_conv_plain(tok, k1, bias), what)
            xb = conv.embed_conv_bases(bases_e, k1, bias, Le)
            bit_equal(xb, conv.embed_conv_bases_plain(bases_e, k1, bias, Le), what + " bases")
            bit_equal(xb, x, what + " bases against the token kernel")
        torch.cuda.synchronize()
        log(f"# K5 edge case {case} B={tok.shape[0]} L={Le}: bit-equal, the bases form too (f32, bf16)")

    # K2 and K3 at the edges of their persistent schedule, f32 and bf16
    for name, (yn, pn, wpn, wvn) in fused_reduce_edge_cases().items():
        patches = torch.from_numpy(pn).to(dev)
        for dtype in (torch.float32, torch.bfloat16):
            x, w_patch, w_v = (torch.from_numpy(a).to(dev, dtype) for a in (yn, wpn, wvn))
            mpi, pooled = patch_reduce.fused_reduce(x, patches, w_patch, w_v)
            mpi_ref, pooled_ref = patch_reduce.fused_reduce_plain(x, patches, w_patch, w_v)
            e = max(max_err(mpi, mpi_ref, torch.float32), max_err(pooled, pooled_ref, dtype))
            mpi3 = patch_reduce.patch_reduce(x, patches, w_patch)
            e = max(e, max_err(mpi3, patch_reduce.patch_reduce_plain(x, patches, w_patch), torch.float32))
            if not torch.equal(mpi3, mpi):
                raise AssertionError(f"K2 edge case {name} ({dtype}): K3 mpi differs from K2 mpi in {int((mpi3 != mpi).sum())} values")
            if name == "B3_L1001":  # K3 takes any C
                xc, wc = x[..., :40].contiguous(), w_patch[..., :40].contiguous()
                e = max(e, max_err(patch_reduce.patch_reduce(xc, patches, wc), patch_reduce.patch_reduce_plain(xc, patches, wc), torch.float32))
            torch.cuda.synchronize()
            log(f"# K2 edge case {name} B={x.shape[0]} L={x.shape[1]} {str(dtype).split('.')[1]}: K2 and K3 {e:.3g} (K3 mpi bit-equal to K2's)")

    tok, k1, b1 = entries["embed_conv"]["args"]
    bit_equal(conv.embed_conv(tok, k1, b1), conv.embed_conv(tok, k1, b1), "K5 rerun")
    bit_equal(conv.embed_conv_bases(bases, k1, b1, L), conv.embed_conv_bases(bases, k1, b1, L), "K5 bases rerun")
    log(f"# K5 rerun at B={B} L={L}: bit-equal, the bases form too")

    # K4's persistent schedule (tiles of 64 rows, two per block and round,
    # one block per SM) at its edges, bf16: one tile plus a ragged one; a
    # tile count that is no multiple of the grid; a sequence shorter than
    # the halo
    h1, k2, b2 = entries["causal_conv"]["args"]
    for Be, Le in ((1, 70), (133, L), (4, 5)):
        x = torch.from_numpy(rng.normal(0, 1, (Be, Le, C)).astype(np.float32)).to(dev, torch.bfloat16)
        e = max(
            max_err(conv.causal_conv(x, k2, b2, leaky), conv.causal_conv_plain(x, k2, b2, leaky), torch.bfloat16)
            for leaky in (True, False)
        )
        log(f"# K4 edge B={Be} L={Le}: {e:.3g} (bf16, with and without LeakyReLU)")
    first, again = conv.causal_conv(h1, k2, b2), conv.causal_conv(h1, k2, b2)
    if not torch.equal(first, again):
        raise AssertionError(f"K4 rerun differs from the first run in {int((first != again).sum())} values")
    log(f"# K4 rerun at B={B} L={L}: bit-equal")
    y, patches, w_patch, w_v = entries["fused_reduce"]["args"]
    slots = entries["fused_reduce"]["slots"]
    first, again = (patch_reduce.fused_reduce(y, patches, w_patch, w_v, slots=slots) for _ in range(2))
    if not (torch.equal(first[0], again[0]) and torch.equal(first[1], again[1])):
        raise AssertionError("K2 rerun differs from the first run")
    log(f"# K2 rerun at B={B} L={L}: mpi and pooled bit-equal")

    # timings at the main path's shapes, bf16
    tok, k1, b1 = entries["embed_conv"]["args"]
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
            source="genomad_torch/csrc/embed_conv.cu",
            launches_per_batch=None,  # on the forward profiler's path; the nn module runs the bases form
        ),
        "embed_conv_bases": dict(
            kernel=lambda: conv.embed_conv_bases(bases, k1, b1, L),
            plain=lambda: conv.embed_conv_bases_plain(bases, k1, b1, L),
            library=None,  # no single PyTorch call tokenizes and embeds
            bound=bound(bases.numel() + k1.numel() * es + C * es + B * L * C * es, f32_flops=B * L * C * 6),
            replaces="genomad_tpu/ops/conv_pallas.py:160",
            source="genomad_torch/csrc/embed_conv.cu",
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
            kernel=lambda: patch_reduce.fused_reduce(y, patches, w_patch, w_v, slots=slots),
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
        "patch_reduce": dict(
            kernel=lambda: patch_reduce.patch_reduce(y, patches, w_patch, slots=slots),
            plain=lambda: patch_reduce.patch_reduce_plain(y, patches, w_patch),
            library=None,  # no single PyTorch call computes the patch reduction
            # y is read only at the rows the patches name
            bound=bound(
                B * int(torch.unique(patches).numel()) * C * es + patches.numel() * 4 + w_patch.numel() * es
                + B * patches.shape[0] * 4,
                f32_flops=2 * B * patches.numel() * C,
            ),
            replaces="genomad_tpu/ops/patch_reduce.py:219",
            source="genomad_torch/csrc/fused_reduce.cu",
            launches_per_batch=None,  # on the forward profiler's path, not the nn module's
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
            "source": t.get("source", f"genomad_torch/csrc/{name}.cu"),
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
            f"{t['launches_per_batch']} launch(es) per nn batch"
        )
    log("# K2 by part: " + json.dumps(fused_reduce_parts(y, patches, w_patch, w_v)))
    results["embed_conv_wgrad"] = embed_conv_wgrad_row()


def train_windows(rng, n: int, length: int):
    """(n, length) int32 tokens of the training cell's kind: random windows
    with N runs, every third cut at a contig's end and padded with N, and,
    in a batch of more than one, row 0 all N."""
    from genomad_torch.ops import conv

    bases = random_bases(rng, n, length + 3)
    for row in bases[2::3]:
        row[int(rng.integers(length // 3, length)) :] = 4
    if n > 1:
        bases[0] = 4
    return conv.tokens_from_bases(torch.from_numpy(bases)).contiguous()


def rel_l2(got, ref) -> float:
    got, ref = got.double(), ref.double()
    return float(torch.linalg.vector_norm(got - ref) / torch.linalg.vector_norm(ref))


def embed_conv_wgrad_row() -> dict:
    """conv1's gradient kernel at the training cell's shapes (B = 64, L =
    5,997, V = 257, C = 128, f32), against the exact sums (the plain version
    in float64) there, in a batch of one and at ragged shapes; bitwise equal
    to itself on a rerun; timed beside its plain version (float32
    ``index_add_``), the library path it replaces (the ``index_put_`` with
    accumulation that autograd of the (B, L+5, 6C) gather runs) and its
    bound. The kernel table's row."""
    from genomad_torch.models import igloo
    from genomad_torch.ops import conv

    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED + 20)
    gen = torch.Generator(device=dev).manual_seed(SEED + 20)
    B, L, V, C = TRAIN_BATCH, igloo.WINDOW_TOKENS, igloo.VOCAB, igloo.CHANNELS
    errs = {}
    for Be, Le, Ce in ((B, L, C), (1, L, C), (3, 1001, 64), (4, 5, 32)):
        tok = train_windows(rng, Be, Le).to(dev)
        dout = torch.randn((Be, Le, Ce), generator=gen, device=dev)
        dw, db = conv.embed_conv_wgrad(tok, dout, V)
        exact = conv.embed_conv_wgrad_plain(tok, dout.double(), V)
        errs[f"B{Be}_L{Le}_C{Ce}"] = max(rel_l2(dw, exact[0]), rel_l2(db, exact[1]))
    if max(errs.values()) > WGRAD_REL_L2:
        raise AssertionError(f"embed_conv_wgrad against the exact sums (relative L2): {errs}")
    tok = train_windows(rng, B, L).to(dev)
    dout = torch.randn((B, L, C), generator=gen, device=dev)
    first, again = conv.embed_conv_wgrad(tok, dout, V), conv.embed_conv_wgrad(tok, dout, V)
    bit_equal(again[0], first[0], "embed_conv_wgrad dW rerun")
    bit_equal(again[1], first[1], "embed_conv_wgrad dbias rerun")
    f32_gap = rel_l2(first[0], conv.embed_conv_wgrad_plain(tok, dout, V)[0])
    torch.cuda.synchronize()
    log(f"# embed_conv_wgrad against the exact sums, relative L2: {json.dumps(errs)}; against float32 index_add_ "
        f"{f32_gap:.3g}; bitwise equal on a rerun")

    # the library path: autograd of the gather table[padded] accumulates the
    # gathered tensor's gradient into the (V+1, 6C) table with index_put_
    padded = torch.nn.functional.pad(tok.long(), (5, 0), value=V)
    gathered = torch.zeros((B, L + 5, 6 * C), device=dev)
    for k in range(6):
        gathered[:, k : k + L, k * C : (k + 1) * C] = dout
    ms = cuda_time(lambda: conv.embed_conv_wgrad(tok, dout, V), iters=20)
    plain_ms = cuda_time(lambda: conv.embed_conv_wgrad_plain(tok, dout, V), iters=3, warmup=1)
    library_ms = cuda_time(lambda: torch.zeros((V + 1, 6 * C), device=dev).index_put_((padded,), gathered, accumulate=True), iters=3, warmup=1)
    del gathered
    bound_ms, bound_by = bound(dout.numel() * 4 + tok.numel() * 4 + 6 * V * C * 4 + C * 4)
    log(f"# embed_conv_wgrad: {ms:.4f} ms (plain {plain_ms:.4f}, library {library_ms:.4f}, bound {bound_ms:.4f} by {bound_by}), "
        "1 call (2 launches) a training step")
    return {
        "name": "embed_conv_wgrad",
        "route": "cuda",
        "source": "genomad_torch/csrc/embed_conv_wgrad.cu",
        "replaces": None,  # JAX's training step leaves conv1's gradient to XLA
        "launches": None,  # filled from the train phase
        "launches_per_batch": 1,  # a training step
        "max_abs_err": max(errs.values()),  # relative L2 against the exact sums
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": library_ms,
    }


# name -> (B, bases per row, L positions)
EMBED_EDGE_CASES = {
    "B1_L1": (1, 4, 1),  # one position: five causal taps
    "L5": (4, 8, 5),  # shorter than the halo
    "L6": (4, 9, 6),  # the halo and one position
    "B133_L6016": (133, 6000, 6016),  # the model's shape; 3,192 tiles, no multiple of the grid
    "B3_L1001": (3, 1001, 1001),  # a ragged tile; the last 3 tokens read N padding
    "token_edges": (2, 64, 64),  # tokens 0 at t < 5, token 256, a code above 4
    "all_N": (2, 600, 600),  # row 1 all N
}


def embed_conv_edge_cases(max_rows: int | None = None) -> dict:
    """Edge cases of K5's persistent schedule (a block owns a channel slice
    and strides over 256-position tiles) and of its causal halo: name ->
    (bases (B, n) uint8 codes, L), the tokens or bases of a length-L conv1.
    Each row is drawn from its own seed, so ``max_rows`` keeps the first
    rows of a case as they are (tests/test_torch_kernels.py holds the plain
    versions against JAX on them; the kernel phase holds the kernels
    against the plain versions on every row)."""
    cases = {}
    for k, (name, (B, n, L)) in enumerate(EMBED_EDGE_CASES.items()):
        rows = B if max_rows is None else min(B, max_rows)
        bases = np.stack([
            random_bases(np.random.default_rng([SEED + 10, k, b]), 1, n)[0] if n >= 600
            else np.random.default_rng([SEED + 10, k, b]).integers(0, 4, n, dtype=np.uint8)
            for b in range(rows)
        ])
        if name in ("L5", "L6"):
            bases[0, 2] = 4  # tokens 0 at t = 0..2
        if name == "token_edges":
            bases[0, :2] = 4  # tokens 0 at t = 0, 1
            bases[0, 10:20] = 3  # TTTT: token 256 at t = 10..16
            bases[0, 30] = 9  # any code >= 4 is N
            if rows > 1:
                bases[1, :4] = 3  # token 256 at t = 0
                bases[1, 4] = 4  # tokens 0 at t = 1..4
        if name == "all_N" and rows > 1:
            bases[1] = 4
        cases[name] = (bases, L)
    return cases


def fused_reduce_parts(y, patches, w_patch, w_v) -> dict:
    """Where K2's time goes at the main path's shape: K2 and K3 with all of
    the patches, with the first quarter of them and with none (K3 with none
    streams y and does nothing else; K2 with none adds the products and the
    pool), ms by CUDA events."""
    from genomad_torch.ops import patch_reduce

    out = {}
    for share, P in (("all", patches.shape[0]), ("quarter", patches.shape[0] // 4), ("none", 0)):
        p, wp = patches[:P].contiguous(), w_patch[:P].contiguous()
        slots = patch_reduce.slot_table(p, wp, -(-y.shape[1] // 64))
        out[f"K2_{share}_ms"] = cuda_time(lambda: patch_reduce.fused_reduce(y, p, wp, w_v, slots=slots), iters=20)
        out[f"K3_{share}_ms"] = cuda_time(lambda: patch_reduce.patch_reduce(y, p, wp, slots=slots), iters=20)
    return out


# name -> (B, L, the patches' positions drawn from [0, n))
FUSED_EDGE_CASES = {
    "B1_L70": (1, 70, 70),  # one tile plus a ragged one
    "B133_L6016": (133, 6016, 5997),  # more batch rows than blocks: no multiple of the grid
    "L5": (4, 5, 5),  # no pool window: mpi only
    "B3_L1001": (3, 1001, 1001),
    "fullest_tile": (2, 6016, 64),  # all 8,400 slots in the first 64 rows
}


def fused_reduce_edge_cases(max_rows: int | None = None) -> dict:
    """Edge cases of K2/K3's persistent schedule (a block owns whole batch
    rows and walks their 64-row tiles of 8 pool windows), at the model's C =
    128 and 2,100 patches of 4: name -> numpy f32 (y (B, L, C), patches (P,
    S) int32, w_patch (P, S, C), w_v (C, C)). Each batch row of y is drawn
    from its own seed, so ``max_rows`` keeps the first rows of a case as
    they are (tests/test_torch_kernels.py holds the plain versions against
    JAX on them; the kernel phase holds the kernels against the plain
    versions on every row)."""
    C = 128
    cases = {}
    for k, (name, (B, L, n)) in enumerate(FUSED_EDGE_CASES.items()):
        rng = np.random.default_rng([SEED + 9, k])
        patches = np.stack([np.sort(rng.choice(n, 4, replace=False)) for _ in range(2100)]).astype(np.int32)
        w_patch = rng.normal(0, 0.1, (2100, 4, C)).astype(np.float32)
        w_v = rng.normal(0, 0.1, (C, C)).astype(np.float32)
        rows = B if max_rows is None else min(B, max_rows)
        y = np.stack([np.random.default_rng([SEED + 9, k, b]).normal(0, 1, (L, C)).astype(np.float32) for b in range(rows)])
        cases[name] = (y, patches, w_patch, w_v)
    return cases


# ---------------------------------------------------------------------------
# Phase 5: the nn-classification path
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
    kernels = (conv.embed_conv_bases, conv.causal_conv, patch_reduce.fused_reduce)
    for k in (*kernels, conv.embed_conv):
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
    if launches != expect:
        raise AssertionError(f"launch counts {launches} != expected {expect} for {n_batches} batches")
    if conv.embed_conv.launches:  # the bases are tokenized inside the kernel only
        raise AssertionError(f"the token kernel ran {conv.embed_conv.launches} times on the nn path")

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
        timed("cache_write_s", lambda: utils.savez_compressed_threaded(workdir / "cache.npz", bases=bases))
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
        stages["device_ms_per_batch_by_kernel"] = {k[:80]: v / 1e3 / math.ceil(len(few) / BATCH) for k, v in top}
    except Exception as exc:  # noqa: BLE001
        stages["profiler"] = f"not measured: {exc!r}"
    return stages


# ---------------------------------------------------------------------------
# Synthetic profile DBs and inputs of the annotate path (the recipes of
# bench.py: _bench_db, bench_search's query mix, _synthetic_genome)
# ---------------------------------------------------------------------------


def bench_db(n_profiles: int):
    """Integral scores, lengths 60-400, background consensus residues."""
    from genomad_torch.ops.profiledb import ProfileDB
    from genomad_torch.ops.statistics import BACKGROUND_FREQS

    return ProfileDB.synthetic(
        seed=1, n_profiles=n_profiles, min_len=60, max_len=400,
        residue_freqs=BACKGROUND_FREQS, integral=True,
    )


def bench_queries(db, n_queries: int, seed: int = 0):
    """60% mutated consensus sequences (planted hits, 10% substitutions),
    40% background residues of length 60-400. Returns (names, seqs,
    planted target per query or -1)."""
    from genomad_torch.ops.profiledb import ALPHABET, N_AA
    from genomad_torch.ops.statistics import BACKGROUND_FREQS

    rng = np.random.default_rng(seed)
    names, seqs, targets = [], [], []
    for qi in range(n_queries):
        if qi % 5 < 3:
            target = int(rng.integers(0, db.n_profiles))
            seq = db.consensus(target).copy()
            pos = rng.choice(len(seq), len(seq) // 10, replace=False)
            seq[pos] = rng.integers(0, N_AA, len(pos))
        else:
            target = -1
            seq = rng.choice(N_AA, int(rng.integers(60, 400)), p=BACKGROUND_FREQS)
        names.append(f"q_{qi}")
        seqs.append("".join(ALPHABET[r] for r in seq))
        targets.append(target)
    return names, seqs, np.array(targets)


# codons in the order of the residue alphabet ACDEFGHIKLMNPQRSTVWY
CODONS = [
    "GCT", "TGT", "GAT", "GAA", "TTT", "GGT", "CAT", "ATT", "AAA", "CTG",
    "ATG", "AAT", "CCG", "CAA", "CGT", "TCT", "ACT", "GTT", "TGG", "TAT",
]


def synthetic_genome(total_mbp: float, seed: int = 7):
    """Contigs with a gene-like structure: alternating spacers and ORFs."""
    rng = np.random.default_rng(seed)
    bases = np.array(list("ACGT"))
    records = []
    total = 0
    target = int(total_mbp * 1e6)
    ci = 0
    while total < target:
        parts = []
        length = 0
        contig_target = min(50_000, target - total)
        while length < contig_target:
            spacer = "".join(rng.choice(bases, int(rng.integers(50, 200))))
            n_codons = int(rng.integers(100, 400))
            orf = "ATG" + "".join(CODONS[i] for i in rng.integers(0, 20, n_codons)) + "TAA"
            parts.append(spacer + orf)
            length += len(spacer) + len(orf)
        seq = "".join(parts)
        records.append((f"bench_contig_{ci}", seq))
        total += len(seq)
        ci += 1
    return records, total


def planted_contigs(db, n_genes: int, seed: int):
    """Contigs of ten genes each whose proteins are mutated consensus
    sequences of random DB profiles (the gene caller, self-trained on the
    synthetic genome, calls part of them on the forward strand: those are
    the marker hits)."""
    rng = np.random.default_rng(seed)
    bases = np.array(list("ACGT"))
    records, targets = [], []
    for ci in range(0, n_genes, 10):
        parts = []
        for _ in range(10):
            target = int(rng.integers(0, db.n_profiles))
            prot = db.consensus(target).copy()
            pos = rng.choice(len(prot), len(prot) // 10, replace=False)
            prot[pos] = rng.integers(0, 20, len(pos))
            spacer = "".join(rng.choice(bases, int(rng.integers(50, 200))))
            parts.append(spacer + "ATG" + "".join(CODONS[r] for r in prot) + "TAA")
            targets.append(target)
        records.append((f"planted_contig_{ci // 10}", "".join(parts)))
    return records, targets


def write_db_dir(db_dir: Path, db) -> None:
    """A geNomad DB directory around ``db`` (bench.py's layout): packed
    profiles (the minimal DB is the same file), a 16-profile integrase DB,
    17-column marker metadata and a minimal taxdump."""
    from genomad_torch.ops.profiledb import ProfileDB

    db_dir.mkdir(parents=True, exist_ok=True)
    (db_dir / "version.txt").write_text("1.9\n")
    db.save(db_dir / "genomad_profiles.npz")
    shutil.copyfile(db_dir / "genomad_profiles.npz", db_dir / "genomad_mini_profiles.npz")
    ProfileDB.synthetic(seed=99, n_profiles=16, min_len=60, max_len=90).save(db_dir / "genomad_integrase_profiles.npz")
    header = "\t".join(
        ["marker", "c1", "class", "c3", "spm_c", "spm_p", "spm_v", "gv",
         "uscg", "ph", "vh", "conjscan", "amr", "acc", "desc", "t1", "t2"]
    )
    with open(db_dir / "nodes.dmp", "w") as f:
        for tx, parent, rank in [(1, 1, "no rank"), (10, 1, "realm")]:
            f.write(f"{tx}\t|\t{parent}\t|\t{rank}\t|\n")
    with open(db_dir / "names.dmp", "w") as f:
        for tx, name in [(1, "root"), (10, "Duplodnaviria")]:
            f.write(f"{tx}\t|\t{name}\t|\t\t|\tscientific name\t|\n")
    with open(db_dir / "genomad_marker_metadata.tsv", "w") as f:
        f.write(header + "\n")
        for i, name in enumerate(db.names):
            spec = "VV" if i % 2 else "CC"
            spm = ("0.1", "0.2", "0.9") if i % 2 else ("0.9", "0.2", "0.1")
            f.write(
                f"{name}\tx\t{spec}\tx\t{spm[0]}\t{spm[1]}\t{spm[2]}\t0\tNA\t0\t"
                f"{1 if i % 2 else 0}\tNA\tNA\tPF{i:05d}\tdesc{i}\tx\tx\n"
            )


# ---------------------------------------------------------------------------
# Phase 4: K1 (Smith-Waterman) against its plain version
# ---------------------------------------------------------------------------


def sw_bucket_pairs(db, Lp_bound: int, n_pairs: int, rng, dev, Lq_bound: int | None = None):
    """Operands of one (query bucket, profile bucket) launch of the search:
    the DB's staged profile bucket of length class ``Lp_bound``, and one
    query row per pair in the query bucket of bound ``Lq_bound`` (default
    ``Lp_bound``): a third of them the pair's profile consensus with 10%
    substitutions and three deletions (a window of it, of a length in the
    query bucket, where it is longer), the rest background residues.
    Returns (all_q, all_p, idx, (q_len, p_len))."""
    from genomad_torch.ops import protein_search as ps
    from genomad_torch.ops.profiledb import N_AA
    from genomad_torch.ops.statistics import BACKGROUND_FREQS

    Lq_bound = Lq_bound or Lp_bound
    b = ps._BOUNDS.index(Lp_bound)
    qb = ps._BOUNDS.index(Lq_bound)
    lo = ps._BOUNDS[qb - 1] if qb else 0
    _, all_p, _, p_len = ps._get_staged_profiles(db, b, dev)
    ids = np.where(ps._bucket_bound(db.lengths) == b)[0]
    rows = rng.integers(0, len(ids), n_pairs)
    all_q = np.full((n_pairs, Lq_bound), 20, np.int32)
    q_len = np.zeros(n_pairs, np.int32)
    for k, r in enumerate(rows):
        if k % 3 == 0:
            seq = db.consensus(int(ids[r])).astype(np.int32)
            if len(seq) > Lq_bound:
                n = int(rng.integers(lo + 4, Lq_bound + 4))
                start = int(rng.integers(0, len(seq) - n + 1))
                seq = seq[start : start + n]
            pos = rng.choice(len(seq), len(seq) // 10, replace=False)
            seq[pos] = rng.integers(0, N_AA, len(pos))
            seq = np.delete(seq, rng.choice(len(seq), 3, replace=False))
            if len(seq) <= lo:  # keep the row in this query bucket
                seq = np.concatenate([seq, rng.integers(0, N_AA, lo + 1 - len(seq))])
        else:
            seq = rng.choice(N_AA, int(rng.integers(lo + 1, Lq_bound + 1)), p=BACKGROUND_FREQS)
        all_q[k, : len(seq)] = seq
        q_len[k] = len(seq)
    idx = np.stack([np.arange(n_pairs), rows]).astype(np.int32)
    return (
        torch.from_numpy(all_q).to(dev), all_p, torch.from_numpy(idx).to(dev),
        (torch.from_numpy(q_len).to(dev), p_len),
    )


def sw_equal(got, ref, what: str) -> float:
    """Raises unless best, end_i and end_j are bit-equal; returns max |diff|."""
    for name, g, r in zip(("best", "end_i", "end_j"), got, ref):
        if not torch.equal(g, r):
            bad = int((g != r).sum())
            raise AssertionError(f"K1 {what}: {name} differs from the plain version in {bad} of {g.numel()} pairs")
    return float((got[0] - ref[0]).abs().max()) if got[0].numel() else 0.0


def sw_cells(q_len, p_len, idx, ends=None) -> float:
    """DP cells K1 computes at the pairs' real lengths."""
    rows = q_len[idx[0].long()].double()
    cols = p_len[idx[1].long()].double()
    if ends is not None:
        rows = torch.minimum(rows, ends[0].double() + 1)
        cols = torch.minimum(cols, ends[1].double() + 1)
    return float((rows * cols).sum())


def sw_bound(all_q, all_p, idx, q_len, p_len, cells):
    """(ms, by): the larger of the bytes each input is read once / written
    once (the referenced query rows and profiles at their real lengths, the
    indices, the outputs) over 3.35 TB/s, and the recurrence's operations
    over 33.5 T lane-ops/s."""
    q_rows = torch.unique(idx[0].long())
    p_rows = torch.unique(idx[1].long())
    n = idx.shape[1]
    bytes_moved = (
        float(q_len[q_rows].double().sum()) * 4
        + float(p_len[p_rows].double().sum()) * 21 * all_p.element_size()
        + n * 8 + n * 12
    )
    t_bytes = bytes_moved / PEAK_BYTES_PER_S * 1e3
    t_ops = cells * SW_OPS_PER_CELL / PEAK_F32_LANE_OPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def k1_device_s(device_us: dict) -> float:
    """Seconds of K1 in a profile's device time by kernel name (every
    instantiation of both bodies of csrc/sw.cu)."""
    return sum(v for k, v in device_us.items() if "::sw_chunk_kernel<" in k or "::sw_slab_kernel<" in k) / 1e6


def long_profile_db():
    """K1's long-profile DB (SW_LONG_DB_PROFILES integral profiles of 513-3,000 columns)."""
    from genomad_torch.ops.profiledb import ProfileDB
    from genomad_torch.ops.statistics import BACKGROUND_FREQS

    return ProfileDB.synthetic(
        seed=5, n_profiles=SW_LONG_DB_PROFILES, min_len=513, max_len=3000,
        residue_freqs=BACKGROUND_FREQS, integral=True,
    )


def long_search_case(n_short: int, n_long: int, long_len: tuple, queries: int, seed: int = SEED + 8):
    """A DB of ``n_short`` profiles of bench_db's recipe (lengths 60-400)
    and ``n_long`` of ``long_len`` columns, integral, and queries of
    100-1,000 residues: a third 300-600-residue windows of a long profile's
    consensus that end past its column 1,024 (10% substitutions), a third
    mutated consensus sequences of short profiles, a third background.
    Returns (db, names, seqs, {query name: planted profile name})."""
    from genomad_torch.ops.profiledb import ALPHABET, N_AA, ProfileDB
    from genomad_torch.ops.statistics import BACKGROUND_FREQS

    rng = np.random.default_rng(seed)
    kw = dict(residue_freqs=BACKGROUND_FREQS, integral=True)
    short = ProfileDB.synthetic(seed=seed, n_profiles=n_short, min_len=60, max_len=400, **kw)
    long = ProfileDB.synthetic(seed=seed + 1, n_profiles=n_long, min_len=long_len[0], max_len=long_len[1], **kw)
    pssms = [short.profile(i) for i in range(n_short)] + [long.profile(i) for i in range(n_long)]
    db = ProfileDB.from_profiles([f"GENOMAD.{i:06d}.XX" for i in range(len(pssms))], pssms)
    names, seqs, planted = [], [], {}
    for qi in range(queries):
        if qi % 3 == 0:
            t = n_short + int(rng.integers(0, n_long))
            n = int(rng.integers(300, 601))
            plen = int(db.lengths[t])
            start = int(rng.integers(max(0, min(1055, plen) - n), plen - n + 1))
            seq = db.consensus(t)[start : start + n].astype(np.int64)
        elif qi % 3 == 1:
            t = int(rng.choice(np.where(db.lengths[:n_short] >= 100)[0]))
            seq = db.consensus(t).astype(np.int64)
        else:
            t = -1
            seq = rng.choice(N_AA, int(rng.integers(100, 1001)), p=BACKGROUND_FREQS)
        if t >= 0:
            pos = rng.choice(len(seq), len(seq) // 10, replace=False)
            seq[pos] = rng.integers(0, N_AA, len(pos))
            planted[f"q_{qi}"] = str(db.names[t])
        names.append(f"q_{qi}")
        seqs.append("".join(ALPHABET[r] for r in seq))
    return db, names, seqs, planted


def sw_kernel_phase(results: dict, db) -> None:
    from genomad_torch.ops import protein_search as ps
    from genomad_torch.ops import sw
    from genomad_torch.ops.profiledb import ProfileDB

    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED + 2)
    errs = []
    timed = sw_chunk_cases(db, rng, dev)
    for L in SW_BUCKETS:
        t = timed[L]
        if t["args"][1].dtype != torch.bfloat16:
            raise AssertionError(f"the {SW_DB_PROFILES}-profile integral DB staged as {t['args'][1].dtype}, not bf16")
        sw_check_case(t, f"{L}x{L}", (torch.bfloat16,), 777, errs)
        log(f"# sw {L}x{L}: N={SW_PAIRS} bf16 forward/reverse/full-bucket/ragged bit-equal; "
            f"{t['cells_f'] / SW_PAIRS:.0f} cells per pair forward, {t['cells_r'] / SW_PAIRS:.0f} reverse; "
            f"best max {float(t['fwd'][0].max())}")

    # float PSSMs staged in f32 (small DBs and non-integral ones)
    fdb = ProfileDB.synthetic(seed=4, n_profiles=600, min_len=129, max_len=256)
    fb = ps._BOUNDS.index(256)
    _, fp, _, fp_len = ps._get_staged_profiles(fdb, fb, dev)
    if fp.dtype != torch.float32:
        raise AssertionError("a float-PSSM DB must stage in f32")
    fq, _, fidx, (fq_len, _) = sw_bucket_pairs(fdb, 256, 1024, rng, dev)
    ffwd = sw.sw_pairs(fq, fp, fidx, lengths=(fq_len, fp_len))
    errs.append(sw_equal(ffwd, sw.sw_pairs_plain(fq, fp, fidx), "forward 256x256 f32 float PSSMs"))
    fends = torch.stack([ffwd[1], ffwd[2]])
    errs.append(sw_equal(
        sw.sw_pairs(fq, fp, fidx, ends=fends, lengths=(fq_len, fp_len)),
        sw.sw_pairs_plain(fq, fp, fidx, ends=fends), "reverse 256x256 f32 float PSSMs",
    ))

    # one 1024 x 1024 pair, one 4096-bucket pair and one 4,500-residue query
    # of the 32768 query bucket (32,768 rows of carries per warp of the long
    # body) against a 1,100-column profile, f32 and bf16
    for Lq, Lp, lq, lp in ((1024, 1024, 1024, 1024), (384, 4096, 384, 3000), (32768, 4096, 4500, 1100)):
        cons = rng.integers(0, 20, lp)
        pssm = np.round(rng.normal(-2.0, 0.7, (lp, 20)))
        pssm[np.arange(lp), cons] += 7
        p = np.zeros((1, Lp, 21), np.float32)
        p[0, :lp, :20] = pssm
        q = np.full((1, Lq), 20, np.int32)
        q[0, : min(lq, lp)] = cons[:lq]
        q[0, lp:lq] = rng.integers(0, 20, max(lq - lp, 0))
        q[0, :lq:7] = rng.integers(0, 20, len(q[0, :lq:7]))
        qt = torch.from_numpy(q).to(dev)
        pair = torch.zeros((2, 1), dtype=torch.int32, device=dev)
        lens = (torch.tensor([lq], dtype=torch.int32, device=dev), torch.tensor([lp], dtype=torch.int32, device=dev))
        for dtype in (torch.float32, torch.bfloat16):
            pt = torch.from_numpy(p).to(dev, dtype)
            one = sw.sw_pairs(qt, pt, pair, lengths=lens)
            errs.append(sw_equal(one, sw.sw_pairs_plain(qt, pt, pair), f"forward {Lq}x{Lp} {dtype}"))
            e1 = torch.stack([one[1], one[2]])
            errs.append(sw_equal(sw.sw_pairs(qt, pt, pair, ends=e1), sw.sw_pairs_plain(qt, pt, pair, ends=e1), f"reverse {Lq}x{Lp} {dtype}"))
    torch.cuda.synchronize()
    log("# sw: float-PSSM f32 bucket, 1024x1024 pair, 4096-bucket pair and 4500x1100 pair of the 32768 query bucket bit-equal (forward and reverse)")

    for name, case in sw_edge_cases().items():
        bq, bp, bidx, blens = case["bucket"]
        eq, ep, eidx = (torch.from_numpy(a).to(dev) for a in (bq, bp, bidx))
        lens = tuple(torch.from_numpy(a).to(dev) for a in blens)
        for dtype in (torch.float32, torch.bfloat16):
            pt = ep.to(dtype)
            one = sw.sw_pairs(eq, pt, eidx, lengths=lens)
            errs.append(sw_equal(one, sw.sw_pairs_plain(eq, pt, eidx), f"edge case {name} forward {dtype}"))
            errs.append(sw_equal(sw.sw_pairs(eq, pt, eidx), sw.sw_pairs_plain(eq, pt, eidx), f"edge case {name} full bucket {dtype}"))
            if case["expect"] is not None:
                got = [(float(b), int(i), int(j)) for b, i, j in zip(*(x.cpu() for x in one))]
                if got != case["expect"]:
                    raise AssertionError(f"K1 edge case {name} {dtype}: {got} != {case['expect']}")
            if case["reverse"]:
                e1 = torch.stack([one[1], one[2]])
                errs.append(sw_equal(sw.sw_pairs(eq, pt, eidx, ends=e1, lengths=lens),
                                     sw.sw_pairs_plain(eq, pt, eidx, ends=e1), f"edge case {name} reverse {dtype}"))
    torch.cuda.synchronize()
    log(f"# sw: the {len(SW_EDGE_CASES)} edge cases bit-equal in f32 and bf16 (forward, full bucket, reverse where marked)")
    t0 = time.perf_counter()
    long_timed = sw_long_cases(np.random.default_rng(SEED + 3), dev)
    for name, t in long_timed.items():
        sw_check_case(t, name, (torch.bfloat16, torch.float32), t["n"] // 5 + 3, errs)
        log(f"# sw long {name}: N={t['n']} bf16 and f32 forward/full-bucket/reverse/ragged bit-equal; "
            f"{t['cells_f'] / t['n']:.0f} cells per pair forward, {t['cells_r'] / t['n']:.0f} reverse; "
            f"best max {float(t['fwd'][0].max())}")
    log(f"# sw long: cases drawn and checked in {time.perf_counter() - t0:.1f} s")

    timing = sw_chunk_timing(timed)
    for L in (256, 384):
        timing[f"plain_{L}_ms"] = cuda_time(lambda: sw.sw_pairs_plain(*timed[L]["args"]), iters=3, warmup=1)
    long_timing = sw_long_timing(long_timed)
    long_timing["plain_256x4096_ms"] = cuda_time(lambda: sw.sw_pairs_plain(*long_timed["256x4096"]["args"]),
                                                 iters=2, warmup=1)
    results["sw_pairs"] = {
        "name": "sw_pairs",
        "route": "cuda",
        "source": "genomad_torch/csrc/sw.cu",
        "replaces": "genomad_tpu/ops/sw_pallas.py:150",
        "launches": None,  # filled from the annotate path's run
        "max_abs_err": max(errs),
        "ms": timing["forward_by_bucket"][256]["forward_ms"],
        "plain_ms": timing["plain_256_ms"],
        "bound_ms": timing["forward_by_bucket"][256]["bound_ms"],
        "bound_by": timing["forward_by_bucket"][256]["bound_by"],
        "library_ms": None,  # no PyTorch call computes Smith-Waterman
    }
    results["sw_pairs_long"] = {
        "name": "sw_pairs_long",
        "route": "cuda",
        "source": "genomad_torch/csrc/sw.cu",
        "replaces": "genomad_tpu/ops/sw_pallas.py:150",
        "launches": sw_long_search(),  # the long-profile search's, counted from 0
        "max_abs_err": max(errs),
        "ms": long_timing["256x4096"]["ms"],
        "plain_ms": long_timing["plain_256x4096_ms"],
        "bound_ms": long_timing["256x4096"]["bound_ms"],
        "bound_by": long_timing["256x4096"]["bound_by"],
        "library_ms": None,
    }
    log("# sw timing (bf16, N=4096, real lengths): " + json.dumps({**timing, "long_profile_db": long_timing}))


def sw_check_case(t: dict, what: str, dtypes, n_ragged: int, errs: list) -> None:
    """K1 on one drawn case (sw_chunk_cases, sw_long_cases) bit-equal to
    the plain version with its profiles in each of ``dtypes``: forward with
    the real lengths and over the full bucket, reverse (which rescores each
    alignment to the same integral score), and the first ``n_ragged`` pairs
    forward and reverse."""
    from genomad_torch.ops import sw

    (all_q, all_p, idx), lengths = t["args"], t["lengths"]
    ragged = idx[:, :n_ragged].contiguous()
    for dtype in dtypes:
        p = all_p.to(dtype)
        w = f"{what} {dtype}"
        fwd = sw.sw_pairs(all_q, p, idx, lengths=lengths)
        ref = sw.sw_pairs_plain(all_q, p, idx)
        errs.append(sw_equal(fwd, ref, f"forward {w} (real lengths)"))
        errs.append(sw_equal(sw.sw_pairs(all_q, p, idx), ref, f"forward {w} (full bucket)"))
        ends = torch.stack([fwd[1], fwd[2]])
        rev = sw.sw_pairs(all_q, p, idx, ends=ends, lengths=lengths)
        errs.append(sw_equal(rev, sw.sw_pairs_plain(all_q, p, idx, ends=ends), f"reverse {w}"))
        if not torch.equal(rev[0], fwd[0]):
            raise AssertionError(f"K1 {w}: the reverse pass rescored an alignment differently (integral scores)")
        r_ends = ends[:, :n_ragged].contiguous()
        errs.append(sw_equal(sw.sw_pairs(all_q, p, ragged, lengths=lengths),
                             sw.sw_pairs_plain(all_q, p, ragged), f"ragged N={n_ragged} forward {w}"))
        errs.append(sw_equal(sw.sw_pairs(all_q, p, ragged, ends=r_ends, lengths=lengths),
                             sw.sw_pairs_plain(all_q, p, ragged, ends=r_ends), f"ragged N={n_ragged} reverse {w}"))
    torch.cuda.synchronize()


def sw_chunk_cases(db, rng, dev) -> dict:
    """The annotate path's buckets of ``db`` (SW_BUCKETS, N = SW_PAIRS,
    drawn in that order from ``rng``): each bucket's operands, its forward
    result (real lengths), the ends that select its reverse pass, and the
    cells of both passes."""
    from genomad_torch.ops import sw

    timed = {}
    for L in SW_BUCKETS:
        all_q, all_p, idx, lengths = sw_bucket_pairs(db, L, SW_PAIRS, rng, dev)
        fwd = sw.sw_pairs(all_q, all_p, idx, lengths=lengths)
        ends = torch.stack([fwd[1], fwd[2]])
        timed[L] = dict(args=(all_q, all_p, idx), lengths=lengths, fwd=fwd, ends=ends, n=SW_PAIRS,
                        cells_f=sw_cells(*lengths, idx), cells_r=sw_cells(*lengths, idx, ends))
    return timed


def sw_chunk_timing(timed: dict) -> dict:
    """CUDA-event times at the annotate path's shapes: forward by bucket,
    reverse and the full bucket at 256; each with its Gcells/s and bound."""
    from genomad_torch.ops import sw

    by_bucket = {}
    for L in sorted(SW_BUCKETS):
        t = timed[L]
        ms_l = cuda_time(lambda: sw.sw_pairs(*t["args"], lengths=t["lengths"]), iters=20)
        bound_l, by_l = sw_bound(*t["args"], *t["lengths"], t["cells_f"])
        by_bucket[L] = {"forward_ms": ms_l, "gcells_s": t["cells_f"] / ms_l / 1e6, "bound_ms": bound_l, "bound_by": by_l}
    t = timed[256]
    all_q, all_p, idx = t["args"]
    rev_ms = cuda_time(lambda: sw.sw_pairs(all_q, all_p, idx, ends=t["ends"], lengths=t["lengths"]), iters=20)
    full_ms = cuda_time(lambda: sw.sw_pairs(all_q, all_p, idx), iters=20)  # every bucket cell, no real lengths
    rev_bound = sw_bound(all_q, all_p, idx, *t["lengths"], t["cells_r"])
    full_lengths = tuple(torch.full_like(n, 256) for n in t["lengths"])
    full_bound = sw_bound(all_q, all_p, idx, *full_lengths, SW_PAIRS * 256 * 256)
    return {
        "forward_by_bucket": by_bucket,
        "forward_256_full_bucket_ms": full_ms, "full_bucket_gcells_s": SW_PAIRS * 256 * 256 / full_ms / 1e6,
        "forward_256_full_bucket_bound_ms": full_bound[0], "forward_256_full_bucket_bound_by": full_bound[1],
        "reverse_256_ms": rev_ms, "reverse_256_gcells_s": t["cells_r"] / rev_ms / 1e6,
        "reverse_256_bound_ms": rev_bound[0], "reverse_256_bound_by": rev_bound[1],
        "library_ms": "null: no PyTorch call computes Smith-Waterman",
    }


def sw_long_cases(rng, dev) -> dict:
    """The long-profile DB's cases (SW_LONG_CASES, drawn in that order from
    ``rng``): each case's operands, its forward result (real lengths), the
    ends of its reverse pass and the cells of both passes."""
    from genomad_torch.ops import sw

    t0 = time.perf_counter()
    ldb = long_profile_db()
    log(f"# sw long: {SW_LONG_DB_PROFILES}-profile DB of 513-3,000 columns built in {time.perf_counter() - t0:.1f} s")
    timed = {}
    for name, Lp, Lq, n in SW_LONG_CASES:
        all_q, all_p, idx, lengths = sw_bucket_pairs(ldb, Lp, n, rng, dev, Lq_bound=Lq)
        if all_p.dtype != torch.bfloat16:
            raise AssertionError(f"the {SW_LONG_DB_PROFILES}-profile integral DB staged as {all_p.dtype}, not bf16")
        fwd = sw.sw_pairs(all_q, all_p, idx, lengths=lengths)
        ends = torch.stack([fwd[1], fwd[2]])
        timed[name] = dict(args=(all_q, all_p, idx), lengths=lengths, fwd=fwd, ends=ends, n=n,
                           cells_f=sw_cells(*lengths, idx), cells_r=sw_cells(*lengths, idx, ends))
    return timed


def sw_long_timing(timed: dict) -> dict:
    """CUDA-event times of the long-profile DB's cases (bf16, real lengths)
    and of the reverse pass at 256 x 4096, each with its cells, Gcells/s,
    bound and x-bound."""
    from genomad_torch.ops import sw

    def row(ms, cells, args, lengths):
        b, by = sw_bound(*args, *lengths, cells)
        return {"ms": ms, "cells": cells, "gcells_s": cells / ms / 1e6, "bound_ms": b, "bound_by": by, "x_bound": ms / b}

    out = {}
    for name, Lp, _, n in SW_LONG_CASES:
        t = timed[name]
        ms = cuda_time(lambda: sw.sw_pairs(*t["args"], lengths=t["lengths"]), iters=20 if Lp <= 1024 else 5)
        out[name] = {"n": n, **row(ms, t["cells_f"], t["args"], t["lengths"])}
    t = timed["256x4096"]
    ms = cuda_time(lambda: sw.sw_pairs(*t["args"], ends=t["ends"], lengths=t["lengths"]), iters=5)
    out["256x4096 reverse"] = {"n": t["n"], **row(ms, t["cells_r"], t["args"], t["lengths"])}
    return out


def sw_long_search() -> int:
    """``protein_search.search`` over a DB with long profiles
    (SW_LONG_SEARCH): the card's hits equal device="cpu"'s. Returns the
    long body's launches in the card's search, counted from 0."""
    from genomad_torch.ops import protein_search as ps
    from genomad_torch.ops import sw

    db, names, seqs, planted = long_search_case(**SW_LONG_SEARCH)
    sw.sw_pairs.launches = sw.sw_pairs.forward_launches = sw.sw_pairs.reverse_launches = sw.sw_pairs.long_launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    on_card = ps.search(names, seqs, db)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    launches = sw.sw_pairs.long_launches
    t0 = time.perf_counter()
    on_cpu = ps.search(names, seqs, db, device="cpu")
    cpu_s = time.perf_counter() - t0
    if on_card != on_cpu or not on_card:
        raise AssertionError(f"long-profile search: card {len(on_card)} hits != CPU {len(on_cpu)} hits")
    if launches <= 0:
        raise AssertionError("the long-profile search never launched K1's long body")
    found = {kind: sum(on_card.get(q, ("",))[0] == planted[q] for q in planted if int(q[2:]) % 3 == r)
             for kind, r in (("long windows", 0), ("short consensus", 1))}
    log(f"# sw long search ({db.n_profiles} profiles, {SW_LONG_SEARCH['n_long']} of "
        f"{SW_LONG_SEARCH['long_len'][0]}-{SW_LONG_SEARCH['long_len'][1]} columns; {len(names)} queries): card == CPU, "
        f"{len(on_card)} hits; planted found {found}; long-body launches {launches} of {sw.sw_pairs.launches}; "
        f"{card_s:.2f} s on the card (cold), {cpu_s:.1f} s on the CPU")
    return launches


def _sw_edge_bucket(Lq, Lp, q_lens, p_lens, rng, planted=None):
    """A staged bucket (code 20 past each query's length; zero rows past
    each profile's length and a zero column 20), with every (query,
    profile) pair. With ``planted`` (a list of (profile, row, column, score)
    cells), query row i is residue i % 20 and every profile scores -4 but at
    the planted cells, where the column scores that row's residue of query
    0; without it, integral random profiles, each with a consensus residue
    per column that query k % nq copies (every ninth residue from the fifth
    changed)."""
    nq, npf = len(q_lens), len(p_lens)
    all_q = np.full((nq, Lq), 20, np.int32)
    for k, n in enumerate(q_lens):
        all_q[k, :n] = np.arange(n) % 20 if planted is not None else rng.integers(0, 20, n)
    all_p = np.zeros((npf, Lp, 21), np.float32)
    for k, n in enumerate(p_lens):
        if planted is not None:
            all_p[k, :n, :20] = -4.0
        else:  # integral PSSM with a consensus residue per column
            all_p[k, :n, :20] = np.round(rng.normal(-2.0, 0.8, (n, 20)))
            cons = rng.integers(0, 20, n)
            all_p[k, np.arange(n), cons] += 7.0
            m = min(n, q_lens[k % nq])
            all_q[k % nq, :m] = cons[:m]  # a planted match in query k % nq
            all_q[k % nq, 4:m:9] = rng.integers(0, 20, len(range(4, m, 9)))
    for prof, i, j, v in planted or ():
        all_p[prof, j, all_q[0, i]] = v
    idx = np.array([(a, b) for a in range(nq) for b in range(npf)], np.int32).T.copy()
    return all_q, all_p, idx, (np.asarray(q_lens, np.int32), np.asarray(p_lens, np.int32))


SW_EDGE_CASES = (
    "tie_row_cols_31_32_Lp64", "tie_row_cols_255_256_Lp384", "tie_row_cols_263_264_Lp384", "tie_two_rows",
    "lengths_1_31_33", "length_257", "ncols_5", "all_negative", "reverse_257",
    "lengths_Lp512", "lengths_Lp768", "lengths_Lp1024",
    "tie_row_cols_511_512_Lp4096", "tie_row_cols_1023_1024_Lp4096", "tie_two_slabs_Lp4096", "gap_across_1024_Lp4096",
    "lengths_1025_2048_3001_Lp4096", "length_5000_Lp32768",
)


def sw_edge_cases() -> dict:
    """Edge cases of K1's register-chunk layout (lane l holds columns
    [l k, l k + k), k = ceil(ncols / 32)), integral: name -> {"bucket":
    (all_q, all_p, idx, (q_len, p_len)) numpy arrays, "reverse": whether the
    reverse pass is checked too, "expect": [(best, end_i, end_j)] per pair or
    None}. Equal maxima in one row must give the first column, equal maxima
    in two rows the earlier row; columns 31/32 at Lp = 64 (k = 2) and 263/264
    at Lp = 384 (k = 12) sit on either side of a lane's chunk, 255/256 at
    Lp = 384 inside one. The 512, 768 and 1024 buckets (KMAX 16, 24, 32;
    k rounded up to a multiple of KMAX / 8) get real lengths that take k at
    KMAX and k rounded up past ncols (500 and 200 columns at 512; 700, 500
    and 130 at 768; 900 and 200 at 1024), forward and reverse.
    tests/test_torch_sw.py holds the plain version against the JAX oracle
    on them; the sw phase holds the kernel against the plain version.

    The long body (Lp > 1024: slabs of 512 columns with per-row carries):
    equal maxima at columns 511 and 512, and 1,023 and 1,024, of one row
    (the first wins) and in two slabs with the later slab's cell in the
    earlier row (it wins); a
    horizontal gap from column 1,014 to 1,034 that the best alignment needs
    (its E crosses the slab edge in the carry); real lengths 1,025, 2,048
    and 3,001 against queries of up to 3,001 residues (consensus matches
    across the slabs; 1,025 ends at its last slab's only column), forward
    and reverse; and a 5,000-column profile of the 32,768 bucket matched
    from column 3,900 on."""
    rng = np.random.default_rng(SEED + 7)
    cases = {}

    def add(name, bucket, expect=None, reverse=False):
        cases[name] = {"bucket": bucket, "expect": expect, "reverse": reverse}

    for name, Lp, cols in (("tie_row_cols_31_32_Lp64", 64, (31, 32)),
                           ("tie_row_cols_255_256_Lp384", 384, (255, 256)),
                           ("tie_row_cols_263_264_Lp384", 384, (263, 264))):
        add(name, _sw_edge_bucket(16, Lp, [16], [Lp], rng, planted=[(0, 3, c, 9.0) for c in cols]),
            expect=[(9.0, 3, cols[0])])
    # the later row's cell lies in an earlier lane: the earlier row wins
    add("tie_two_rows", _sw_edge_bucket(16, 64, [16], [64], rng, planted=[(0, 2, 40, 9.0), (0, 6, 10, 9.0)]),
        expect=[(9.0, 2, 40)])
    add("lengths_1_31_33", _sw_edge_bucket(64, 64, [1, 31, 33], [1, 31, 33], rng))
    add("length_257", _sw_edge_bucket(384, 384, [257, 300], [257, 257], rng))
    add("ncols_5", _sw_edge_bucket(40, 64, [40, 5], [5, 5], rng))  # fewer real columns than lanes
    add("all_negative", _sw_edge_bucket(16, 64, [16], [50], rng, planted=[]), expect=[(0.0, 0, 0)])
    add("reverse_257", _sw_edge_bucket(384, 384, [257, 300], [257, 257], rng), reverse=True)
    for name, L, q_lens, p_lens in (("lengths_Lp512", 512, [500, 210], [500, 200]),
                                    ("lengths_Lp768", 768, [700, 520, 140], [700, 500, 130]),
                                    ("lengths_Lp1024", 1024, [900, 210], [900, 200])):
        add(name, _sw_edge_bucket(L, L, q_lens, p_lens, rng), reverse=True)

    for lo in (511, 1023):
        add(f"tie_row_cols_{lo}_{lo + 1}_Lp4096",
            _sw_edge_bucket(16, 4096, [16], [1500], rng, planted=[(0, 3, c, 9.0) for c in (lo, lo + 1)]),
            expect=[(9.0, 3, lo)])
    add("tie_two_slabs_Lp4096",
        _sw_edge_bucket(16, 4096, [16], [2100], rng, planted=[(0, 6, 500, 9.0), (0, 2, 1500, 9.0)]),
        expect=[(9.0, 2, 1500)])
    # two diagonal runs of ten 6s, (2..11, 1005..1014) and (12..21,
    # 1035..1044): joined by a gap of 20 columns in row 11 they score
    # 60 - 30 + 60 = 90, either alone 60
    runs = [(0, 2 + d, 1005 + d, 6.0) for d in range(10)] + [(0, 12 + d, 1035 + d, 6.0) for d in range(10)]
    add("gap_across_1024_Lp4096", _sw_edge_bucket(24, 4096, [24], [1100], rng, planted=runs),
        expect=[(90.0, 21, 1044)], reverse=True)
    lq, lp, _, lens = _sw_edge_bucket(4096, 4096, [3001, 1500, 700], [1025, 2048, 3001], rng)
    pairs = np.array([[0, 1, 2, 0], [0, 1, 2, 2]], np.int32)  # the three planted matches and one other
    add("lengths_1025_2048_3001_Lp4096", (lq, lp, pairs, lens), reverse=True)
    long_q, long_p, long_idx, long_lens = _sw_edge_bucket(384, 32768, [300], [5000], rng)
    cons = long_p[0, 3900:4200, :20].argmax(1)  # a match from column 3,900 on
    long_q[0, :300] = cons
    long_q[0, 4:300:9] = rng.integers(0, 20, len(range(4, 300, 9)))
    add("length_5000_Lp32768", (long_q, long_p, long_idx, long_lens), reverse=True)
    return cases


# ---------------------------------------------------------------------------
# Phase 7: annotate through its entry point
# ---------------------------------------------------------------------------


def annotate_phase(results: dict, workdir: Path, db) -> dict:
    from genomad_torch import native
    from genomad_torch.modules import annotate
    from genomad_torch.ops import conv, patch_reduce, sw
    from genomad_torch.ops import protein_search as ps
    from genomad_torch.ops.prefilter import card_prefilter_batch
    from genomad_torch.paths import GenomadOutputs

    t0 = time.perf_counter()
    db_dir = workdir / "genomad_db"
    write_db_dir(db_dir, db)
    records, total_bp = synthetic_genome(GENOME_MBP, seed=11)
    planted, targets = planted_contigs(db, 50, seed=SEED + 3)
    fasta = workdir / "genome.fna"
    with open(fasta, "w") as f:
        for h, s in records + planted:
            f.write(f">{h}\n{s}\n")
    total_bp += sum(len(s) for _, s in planted)
    setup_s = time.perf_counter() - t0

    for k in (conv.embed_conv, conv.embed_conv_bases, conv.causal_conv, patch_reduce.fused_reduce):
        k.launches = 0
    sw.sw_pairs.launches = sw.sw_pairs.forward_launches = sw.sw_pairs.reverse_launches = 0
    native.native_prefilter_batch.uses = card_prefilter_batch.launches = 0
    ps.STATS.clear()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    annotate.main(fasta, workdir / "out", db_dir, verbose=False)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    ps.join_prestage()  # its bucket in flight counts in STATS, not in the wall
    fwd, rev = sw.sw_pairs.forward_launches, sw.sw_pairs.reverse_launches
    nn_launches = (conv.embed_conv.launches + conv.embed_conv_bases.launches + conv.causal_conv.launches
                   + patch_reduce.fused_reduce.launches)
    stats = dict(ps.STATS)

    outputs = GenomadOutputs(fasta.stem, workdir / "out")
    rows = [line.split("\t") for line in outputs.annotate_genes_output.read_text().splitlines()]
    if rows[0][:4] != ["gene", "start", "end", "length"] or any(len(r) != 20 for r in rows):
        raise AssertionError("the genes table must have 20 columns")
    hits = {r[0]: r[8] for r in rows[1:] if r[8] != "NA"}
    planted_hits = sum(1 for g, m in hits.items() if g.startswith("planted_contig_"))
    if not hits:
        raise AssertionError("no marker hit in the genes table")
    if fwd <= 0 or rev <= 0 or sw.sw_pairs.launches != fwd + rev:
        raise AssertionError(f"K1 launches on the annotate path: forward {fwd}, reverse {rev}")
    if nn_launches:
        raise AssertionError("the nn kernels ran on the annotate path")
    if card_prefilter_batch.launches <= 0 or native.native_prefilter_batch.uses:
        raise AssertionError("the card's prefilter must serve every call of the search")
    if stats.get("prefilter.card_groups", 0) != stats.get("search.groups", -1) or stats.get("prefilter.host_groups"):
        raise AssertionError(f"prefilter groups: card {stats.get('prefilter.card_groups')}, host "
                             f"{stats.get('prefilter.host_groups')}, search {stats.get('search.groups')}")

    # the module's own stage timers, in the log in order: gene-calling, marker-search
    gene_s, search_s = map(float, re.findall(r"completed in ([0-9.]+)s", outputs.annotate_log.read_text()))
    summary = {
        "input_bp": total_bp,
        "genes": len(rows) - 1,
        "marker_hits": len(hits),
        "marker_hits_on_planted_contigs": f"{planted_hits} (of {len(targets)} planted genes)",
        "db_profiles": db.n_profiles,
        "wall_s": wall,
        "k1_launches": {"forward": fwd, "reverse": rev},
        "pairs": {"forward": int(stats.get("pairs_forward", 0)), "reverse": int(stats.get("pairs_reverse", 0))},
        "card_prefilter_calls": card_prefilter_batch.launches,
        "setup_s (DB dir + FASTA, not in wall)": setup_s,
    }
    log("# annotate: " + json.dumps(summary))
    where = {
        "gene_calling_s": gene_s,
        "marker_search_s": search_s,
        "prefilter_s (prefilter thread, on the card)": stats.get("prefilter_s", 0.0),
        "prestage_s (prestage thread)": stats.get("prestage_s", 0.0),
        "bucket_staging_s": stats.get("staging_s", 0.0),
        "staging_wait_s": stats.get("staging_wait_s", 0.0),
        "sw_forward_s": stats.get("sw_forward_s", 0.0),
        "sw_reverse_s": stats.get("sw_reverse_s", 0.0),
        "finalize_s": stats.get("finalize_s", 0.0),
        "db_load_index_and_rest_of_search_s": search_s - sum(stats.get(k, 0.0) for k in ("staging_s", "staging_wait_s", "sw_forward_s", "sw_reverse_s", "finalize_s")),
        "tables_and_rest_s": wall - gene_s - search_s,
        "k1_gcells_per_s_forward_stage": stats.get("cells_forward", 0.0) / max(stats.get("sw_forward_s", 0.0), 1e-9) / 1e9,
    }
    log("# where the time goes (annotate): " + json.dumps(where))
    return summary


# ---------------------------------------------------------------------------
# Phase 11: the marker search at the real DB's profile count
# ---------------------------------------------------------------------------


def search_device_share(names, seqs, db) -> dict:
    """Device kernel time of one more steady search (torch.profiler) over
    its wall time. Diagnostics only: a failure is reported, not fatal."""
    from genomad_torch.ops import protein_search as ps

    try:
        from torch.profiler import ProfilerActivity, profile

        t0 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            ps.search(names, seqs, db)
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        kernels = [e for e in prof.key_averages() if str(e.device_type).endswith("CUDA")]
        device_us = {e.key: e.self_device_time_total for e in kernels if e.self_device_time_total > 0}
        device_s = sum(device_us.values()) / 1e6
        top = sorted(device_us.items(), key=lambda kv: -kv[1])[:5]
        return {
            "profiled_search_wall_s": wall,
            "device_s": device_s,
            "device_busy_share": device_s / wall,
            "k1_device_s": k1_device_s(device_us),
            "device_s_by_kernel": {k[:80]: v / 1e6 for k, v in top},
        }
    except Exception as exc:  # noqa: BLE001 - diagnostics must not hide the contract's result
        return {"device_busy_share": f"not measured: {exc!r}"}


def cold_and_steady(names, seqs, db) -> dict:
    """Times the search on a DB with nothing staged (cold), then again
    (steady): each run's wall, its STATS (read after its prestage thread
    has ended) and its hits. Raises if the two runs' hits differ."""
    from genomad_torch.ops import protein_search as ps

    out = {}
    for run in ("cold", "steady"):
        ps.STATS.clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out[run + "_hits"] = ps.search(names, seqs, db)
        torch.cuda.synchronize()
        out[run + "_s"] = time.perf_counter() - t0
        ps.join_prestage()
        out[run + "_stats"] = dict(ps.STATS)
    if out["steady_hits"] != out["cold_hits"]:
        raise AssertionError("the steady search differs from the cold one")
    return out


def real_db() -> tuple:
    """The search's DB at the real DB's profile count, with its k-mer index
    and int8 PSSM built outside any search's time: (db, build seconds,
    index and int8 seconds)."""
    t0 = time.perf_counter()
    db = bench_db(REAL_DB_PROFILES)
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    db.kmer_index(1)
    if db.pssm_i8 is None:
        raise AssertionError("the synthetic integral DB must have an int8 PSSM")
    return db, build_s, time.perf_counter() - t0


def real_db_phase() -> dict:
    from genomad_torch.ops import protein_search as ps
    from genomad_torch.ops import sw

    db, build_s, index_s = real_db()
    names, seqs, targets = bench_queries(db, N_SEARCH_QUERIES)
    residues = sum(len(s) for s in seqs)

    sw.sw_pairs.forward_launches = sw.sw_pairs.reverse_launches = 0
    torch.cuda.reset_peak_memory_stats()
    runs = cold_and_steady(names, seqs, db)
    hits, cold_s, steady_s = runs["steady_hits"], runs["cold_s"], runs["steady_s"]
    cold_stats, stats = runs["cold_stats"], runs["steady_stats"]
    planted = np.where(targets >= 0)[0]
    found = sum(1 for qi in planted if hits.get(names[qi], ("",))[0] == str(db.names[targets[qi]]))
    if found < 0.9 * len(planted):
        raise AssertionError(f"only {found} of {len(planted)} planted queries hit their profile")
    staged_gb = sum(
        t.numel() * t.element_size() for _, t, _, _ in db.__dict__["_torch_device_buckets"].values()
    ) / 1e9
    summary = {
        "db_profiles": db.n_profiles,
        "db_positions": db.total_positions,
        "queries": len(names),
        "residues": residues,
        "db_build_s": build_s,
        "kmer_index_and_int8_s": index_s,
        "cold_s": cold_s,
        "steady_s": steady_s,
        "steady_k_residues_per_s": residues / 1e3 / steady_s,
        "hits": len(hits),
        "planted_found": f"{found}/{len(planted)}",
        "pairs_forward": int(stats["pairs_forward"]),
        "pairs_reverse": int(stats["pairs_reverse"]),
        "cells_forward": stats["cells_forward"],
        "k1_gcells_per_s_forward_stage": stats["cells_forward"] / stats["sw_forward_s"] / 1e9,
        "steady_stages_s": {k: v for k, v in stats.items() if k.endswith("_s")},
        "cold_stages_s": {k: v for k, v in cold_stats.items() if k.endswith("_s")},
        "staged_db_gb": staged_gb,
        "peak_device_gb": torch.cuda.max_memory_allocated() / 1e9,
    }
    summary.update(search_device_share(names, seqs, db))
    log("# search at the real DB's size: " + json.dumps(summary))
    summary["prefilter"] = prefilter_row(db, seqs[:BATCH])
    log("# prefilter, one group: " + json.dumps(summary["prefilter"]))
    del db

    # the card against the port's own CPU run, on a 2,000-profile DB
    small = bench_db(2_000)
    names, seqs, _ = bench_queries(small, 60, seed=5)
    on_card = ps.search(names, seqs, small)
    on_cpu = ps.search(names, seqs, small, device="cpu")
    if on_card != on_cpu or not on_card:
        raise AssertionError(f"2,000-profile search: card {len(on_card)} hits != CPU {len(on_cpu)} hits")
    log(f"# search 2,000 profiles x 60 queries: card == CPU ({len(on_card)} hits)")
    summary["stop_rule"] = stop_rule_card_vs_cpu()
    return summary


def prefilter_row(db, seqs) -> dict:
    """The card's prefilter on one search group (``seqs``) against the
    real DB's size, as the marker search calls it (-s 4.2, composition
    bias on): its lists equal to the C++'s (ids, and scores bit for bit),
    the call's wall (host clock, median of 3 after a warm-up), the device
    seconds of its kernels (a profiled call), the C++ on every host core
    (median of 3), and the bound: each index hit's 8-byte entry and one
    32-byte sector a row of each candidate's full window (2 x 16 + 5 rows)
    at 3.35 TB/s."""
    from genomad_torch import native, trace
    from genomad_torch.ops import blosum, profiledb
    from genomad_torch.ops.prefilter import card_prefilter_batch

    residues = [profiledb.encode_protein(s) for s in seqs]
    kw = dict(max_out_per_query=db.n_profiles, kmer_thr=blosum.kmer_score_threshold(4.2),
              bias_list=[blosum.comp_bias(r) for r in residues])
    index = db.kmer_index(1)
    dev = torch.device("cuda")

    def timed(fn, **more):
        times = []
        for _ in range(4):
            before = dict(trace.COUNTERS)
            t0 = time.perf_counter()
            out = fn(index, residues, db, 25.0, **kw, **more)
            times.append(time.perf_counter() - t0)
        work = {k: trace.COUNTERS[k] - before.get(k, 0.0) for k in native.WORK_KEYS[:4]}
        return out, float(np.median(times[1:])), work

    card, card_s, work = timed(card_prefilter_batch, device=dev)
    cpp, cpp_s, cpp_work = timed(native.native_prefilter_batch)
    if card[2] != cpp[2] or work != cpp_work or any(
        not np.array_equal(a, b) for a, b in zip(card[0], cpp[0])
    ) or any(not np.array_equal(a.view(np.int32), b.view(np.int32)) for a, b in zip(card[1], cpp[1])):
        raise AssertionError("card prefilter != C++ prefilter on the real DB's group")
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        card_prefilter_batch(index, residues, db, 25.0, device=dev, **kw)
        torch.cuda.synchronize()
    by_kernel = {e.key: e.self_device_time_total / 1e6 for e in prof.key_averages()
                 if str(e.device_type).endswith("CUDA") and "prefilter_" in e.key}
    bound_s = (8 * work["prefilter.hits"] + 32 * 37 * work["prefilter.candidates"]) / PEAK_BYTES_PER_S
    return {
        "queries": len(seqs), "residues": int(sum(len(r) for r in residues)), **work,
        "selected": int(sum(len(i) for i in card[0])),
        "card_call_ms": 1e3 * card_s, "kernels_ms": 1e3 * sum(by_kernel.values()),
        "kernels_ms_by_name": {re.search(r"prefilter_\w+", k).group(0): 1e3 * v for k, v in by_kernel.items()},
        "cpp_ms": 1e3 * cpp_s, "host_cores": os.cpu_count(), "bound_ms": 1e3 * bound_s,
    }


def stop_rule_card_vs_cpu(n: int = 8_400_000, n_profiles: int = 227_897) -> dict:
    """``protein_search._stop_rule`` on the card against the same function
    on the CPU over a table of an e2e job's size: scores
    from a handful of values (-0.0 and +0.0 among them) so most pairs tie,
    carries in, a quarter of the profiles keeping nothing and a quarter
    everything. Raises unless aligned, carry and stopped are equal; returns
    each side's ms (the card's a CUDA-event mean of 5 after a warm-up)."""
    from genomad_torch.ops import protein_search as ps

    rng = np.random.default_rng(18)
    profs = rng.integers(0, n_profiles, n).astype(np.int32)
    pf = rng.choice(np.array([-0.0, 0.0, 25.0, 26.5, 31.0, 40.0], np.float32), n)
    keep = rng.random(n) < np.array([0.0, 0.05, 0.5, 1.0], np.float32)[profs % 4]
    out = {"pairs": n, "profiles": n_profiles}
    for R in (1, 280):
        carry = rng.integers(0, R, n_profiles)
        host = [torch.from_numpy(a) for a in (profs, pf, keep, carry)]
        t = time.perf_counter()
        on_cpu = ps._stop_rule(*host, R)
        out[f"cpu_ms_r{R}"] = (time.perf_counter() - t) * 1e3
        dev = [a.cuda() for a in host]
        ps._stop_rule(*dev, R)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(5):
            on_card = ps._stop_rule(*dev, R)
        end.record()
        torch.cuda.synchronize()
        out[f"card_ms_r{R}"] = start.elapsed_time(end) / 5
        for name, a, b in zip(("aligned", "carry", "stopped"), on_card, on_cpu):
            if not torch.equal(a.cpu(), b):
                raise AssertionError(f"stop rule, max_rejected {R}: {name} on the card != on the CPU")
        out[f"stopped_r{R}"] = int(on_cpu[2].sum())
    log("# stop rule, card == CPU: " + json.dumps(out))
    return out


# ---------------------------------------------------------------------------
# Phase 6: the forward by stage (the forward profiler, K3's path)
# ---------------------------------------------------------------------------


def forward_phase(results: dict) -> dict:
    from genomad_torch.ops import conv, patch_reduce
    from genomad_torch.tools import profile_forward

    patch_reduce.patch_reduce.launches = conv.embed_conv.launches = conv.embed_conv_bases.launches = 0
    torch.cuda.synchronize()
    out = profile_forward.profile_forward(BATCH)
    torch.cuda.synchronize()
    launches = patch_reduce.patch_reduce.launches
    if launches <= 0 or launches != out["k3_launches"]:
        raise AssertionError(f"K3 launches on the forward profiler's path: {launches}")
    if conv.embed_conv.launches <= 0 or conv.embed_conv_bases.launches <= 0:
        raise AssertionError(f"K5 launches on the forward profiler's path: tokens {conv.embed_conv.launches}, "
                             f"bases {conv.embed_conv_bases.launches}")
    results["patch_reduce"]["launches"] = launches
    results["embed_conv"]["launches"] = conv.embed_conv.launches
    log("# forward by stage: " + json.dumps(out))
    return out


# ---------------------------------------------------------------------------
# Phase 8: end-to-end through run_end_to_end (FASTA -> summary)
# ---------------------------------------------------------------------------


def _codons_for():
    """Synonymous codons per amino acid under code 11."""
    from genomad_torch.ops.gene_calling import _CODON_TABLE_11

    table: dict = {}
    for i, aa in enumerate(_CODON_TABLE_11):
        table.setdefault(aa, []).append("ACGT"[i // 16] + "ACGT"[(i // 4) % 4] + "ACGT"[i % 4])
    return table


def make_gene(protein: str, seed: int = 0, rbs: str = "AGGAGG", spacer: int = 7) -> str:
    """RBS + spacer + ATG + CDS + stop on the forward strand, with varied
    synonymous codons so the antisense frames hit stops as natural sequence
    does (the recipe of the gene-calling tests)."""
    codons = _codons_for()
    rng = np.random.default_rng(seed)
    return rbs + "C" * spacer + "ATG" + "".join(codons[aa][rng.integers(0, len(codons[aa]))] for aa in protein) + "TAA"


def intergenic(n: int) -> str:
    """Stop-dense filler on both strands under every genetic code ('TTAA'
    is its own reverse complement and tiles TAA through every frame)."""
    return ("TTAA" * (n // 4 + 1))[:n]


def consensus_protein(db, p: int) -> str:
    from genomad_torch.ops.profiledb import ALPHABET

    return "".join(ALPHABET[r] for r in db.consensus(p))


def gene_genome(db, total_mbp: float, seed: int):
    """Contigs of up to 50 kbp built with ``make_gene``: proteins of 100-400
    background residues, a tenth of them mutated consensus sequences of DB
    profiles (10% substitutions: marker hits), each gene after a TTAA
    spacer. The gene caller trains on the whole input, and on this genome
    it learns the planted genes' recipe (``synthetic_genome``'s one codon
    per residue and missing RBS train it to call none of them). Returns
    (records, total bp)."""
    from genomad_torch.ops.profiledb import ALPHABET
    from genomad_torch.ops.statistics import BACKGROUND_FREQS

    rng = np.random.default_rng(seed)
    records, total = [], 0
    while total < total_mbp * 1e6:
        parts, length = [], 0
        while length < min(50_000, total_mbp * 1e6 - total):
            if rng.random() < 0.1:
                prot = db.consensus(int(rng.integers(0, db.n_profiles))).copy()
                pos = rng.choice(len(prot), len(prot) // 10, replace=False)
                prot[pos] = rng.integers(0, 20, len(pos))
            else:
                prot = rng.choice(20, int(rng.integers(100, 400)), p=BACKGROUND_FREQS)
            gene = intergenic(int(rng.integers(30, 200))) + make_gene("".join(ALPHABET[r] for r in prot), seed=int(rng.integers(0, 1 << 30)))
            parts.append(gene)
            length += len(gene)
        records.append((f"genome_contig_{len(records)}", "".join(parts) + intergenic(30)))
        total += len(records[-1][1])
    return records, total


def host_virus_host_contigs(db, integrase_db, n_contigs: int, seed: int):
    """Contigs of 7 host genes (even profiles: CC markers), 20 virus genes
    (odd profiles: VV markers), an integrase gene (integrase DB) and 7 host
    genes. Returns [(name, seq)]."""
    rng = np.random.default_rng(seed)
    even = np.arange(0, db.n_profiles, 2)
    odd = np.arange(1, db.n_profiles, 2)
    records = []
    for ci in range(n_contigs):
        host = [int(x) for x in rng.choice(even, 14, replace=False)]
        virus = [int(x) for x in rng.choice(odd, 20, replace=False)]
        parts = [intergenic(60)]
        for k, prot in enumerate(
            [consensus_protein(db, p) for p in host[:7] + virus]
            + [consensus_protein(integrase_db, ci % integrase_db.n_profiles)]
            + [consensus_protein(db, p) for p in host[7:]]
        ):
            parts += [make_gene(prot, seed=1000 * ci + k), intergenic(30)]
        records.append((f"hvh_contig_{ci}", "".join(parts)))
    return records


def _kernel_counts() -> dict:
    from genomad_torch.ops import conv, patch_reduce, sw

    return {
        "sw_pairs_forward": sw.sw_pairs.forward_launches,
        "sw_pairs_reverse": sw.sw_pairs.reverse_launches,
        "sw_pairs_long": sw.sw_pairs.long_launches,
        "embed_conv": conv.embed_conv.launches,
        "embed_conv_bases": conv.embed_conv_bases.launches,
        "causal_conv": conv.causal_conv.launches,
        "fused_reduce": patch_reduce.fused_reduce.launches,
        "patch_reduce": patch_reduce.patch_reduce.launches,
    }


def _reset_kernel_counts() -> None:
    from genomad_torch.ops import conv, patch_reduce, sw

    sw.sw_pairs.launches = sw.sw_pairs.forward_launches = sw.sw_pairs.reverse_launches = sw.sw_pairs.long_launches = 0
    for k in (conv.embed_conv, conv.embed_conv_bases, conv.causal_conv, patch_reduce.fused_reduce, patch_reduce.patch_reduce):
        k.launches = 0


K1_COUNTS = ("sw_pairs_forward", "sw_pairs_reverse")
NN_COUNTS = ("embed_conv_bases", "causal_conv", "fused_reduce")


class StageRecorder:
    """Wraps each module's ``main`` (and the CRF) while run_end_to_end runs:
    per call, its wall seconds and the kernel launches and search pairs it
    added. annotate and the NN contig pass overlap in time (two threads), so
    each claims only its own kernels (K1 and the search's pairs for
    annotate, K5/K4/K2 for nn-classification); the stages that run alone
    claim every count."""

    MODULES = ("annotate", "nn_classification", "find_proviruses", "marker_classification",
               "aggregated_classification", "score_calibration", "summary")
    OWN = {"annotate": K1_COUNTS, "nn_classification": NN_COUNTS}

    def __init__(self):
        self.calls: list = []
        self.crf: list = []
        self._saved: list = []

    def __enter__(self):
        import importlib

        from genomad_torch.models import crf
        from genomad_torch.ops import protein_search as ps

        for name in self.MODULES:
            module = importlib.import_module(f"genomad_torch.modules.{name}")
            self._wrap(module, "main", name, ps)
        original = crf.score_provirus_genes_batch
        self._saved.append((crf, "score_provirus_genes_batch", original))

        def crf_timed(spm_v_list, spm_c_list, device=None):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = original(spm_v_list, spm_c_list, device=device)
            torch.cuda.synchronize()
            self.crf.append({"contigs": len(spm_v_list), "T": max((len(v) for v in spm_v_list), default=0),
                             "s": time.perf_counter() - t0})
            return out

        crf.score_provirus_genes_batch = crf_timed
        return self

    def _wrap(self, module, attr, name, ps):
        original = getattr(module, attr)
        self._saved.append((module, attr, original))

        own = self.OWN.get(name)
        searches = own is None or own == K1_COUNTS  # the nn pass never searches

        def timed(*args, **kwargs):
            before = _kernel_counts()
            pairs = (ps.STATS.get("pairs_forward", 0), ps.STATS.get("pairs_reverse", 0)) if searches else (0, 0)
            t0 = time.perf_counter()
            try:
                return original(*args, **kwargs)
            finally:
                torch.cuda.synchronize()
                after = _kernel_counts()
                self.calls.append({
                    "stage": name,
                    "wall_s": time.perf_counter() - t0,
                    "launches": {k: (after[k] - before[k]) if own is None or k in own else 0 for k in after},
                    "pairs_forward": int(ps.STATS.get("pairs_forward", 0) - pairs[0]) if searches else 0,
                    "pairs_reverse": int(ps.STATS.get("pairs_reverse", 0) - pairs[1]) if searches else 0,
                })

        setattr(module, attr, timed)

    def __exit__(self, *exc):
        for module, attr, original in reversed(self._saved):
            setattr(module, attr, original)
        return False


def end_to_end_phase(results: dict, workdir: Path, db) -> dict:
    from genomad_torch import cli, database
    from genomad_torch.ops import protein_search as ps
    from genomad_torch.ops.profiledb import ProfileDB
    from genomad_torch.paths import GenomadOutputs

    db_dir = workdir / "genomad_db"  # the annotate phase's 20,000-profile DB directory
    integrase_db = ProfileDB.load(db_dir / "genomad_integrase_profiles.npz")
    records, total_bp = gene_genome(db, GENOME_MBP, seed=SEED + 6)
    planted = host_virus_host_contigs(db, integrase_db, N_HVH_CONTIGS, seed=SEED + 4)
    fasta = workdir / "e2e.fna"
    with open(fasta, "w") as f:
        for h, seq in records + planted:
            f.write(f">{h}\n{seq}\n")
    total_bp += sum(len(seq) for _, seq in planted)
    out_dir = workdir / "e2e_out"

    # as a fresh process: the annotate phase's loaded DB is dropped (its
    # k-mer index file stays on disk, as it does for a user's later runs)
    database._PROFILE_DB_CACHE.clear()
    torch.cuda.empty_cache()
    _reset_kernel_counts()
    ps.STATS.clear()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with StageRecorder() as rec:
        # --relaxed (every summary filter off): the synthetic NN weights and
        # forest make the scores meaningless, and the default filters may
        # drop every row
        cli.run_end_to_end(fasta, out_dir, db_dir, verbose=False, enable_score_calibration=True, **cli._RELAXED)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _kernel_counts()

    outputs = GenomadOutputs(fasta.stem, out_dir)
    by_stage: dict = {}
    for call in rec.calls:
        name = call["stage"]
        if name in by_stage:  # the second nn-classification call: the provirus pass
            name += "_provirus_pass"
        by_stage[name] = call
    k1, nn = K1_COUNTS, NN_COUNTS
    for stage in ("annotate", "find_proviruses"):
        got = by_stage[stage]["launches"]
        if not all(got[k] > 0 for k in k1):
            raise AssertionError(f"K1 did not launch forward and reverse in {stage}: {got}")
    for stage in ("nn_classification", "nn_classification_provirus_pass"):
        got = by_stage.get(stage, {}).get("launches", {})
        if not all(got.get(k, 0) > 0 for k in nn):
            raise AssertionError(f"K5/K4/K2 did not all launch in {stage}: {got}")
    if launches["patch_reduce"] or launches["embed_conv"]:
        raise AssertionError(f"K3 or K5's token form ran on the end-to-end path: {launches}")
    if any(launches[k] != sum(c["launches"][k] for c in rec.calls) for k in launches):
        raise AssertionError(f"kernel launches outside the module entry points: {launches}")

    provirus_rows = [r.split("\t") for r in outputs.find_proviruses_output.read_text().splitlines()[1:]]
    found = sorted({r[1] for r in provirus_rows if r[1].startswith("hvh_contig_")})
    if not found:
        raise AssertionError(f"no provirus found on the {N_HVH_CONTIGS} planted contigs ({len(provirus_rows)} in all)")
    with_integrase = sum(1 for r in provirus_rows if r[1].startswith("hvh_contig_") and r[8] != "NA")
    tables = {}
    for name, header in (("summary_virus_output", "seq_name\tlength\ttopology\tcoordinates"),
                         ("summary_plasmid_output", "seq_name\tlength\ttopology\tn_genes")):
        lines = getattr(outputs, name).read_text().splitlines()
        if not lines or not lines[0].startswith(header):
            raise AssertionError(f"{name}: bad header {lines[:1]}")
        tables[name] = len(lines) - 1
    if not sum(tables.values()):
        raise AssertionError("the summary tables have no rows")
    calibrated = np.load(outputs.calibrated_aggregated_classification_npz_output)["predictions"]
    if not np.isfinite(calibrated).all() or calibrated.shape[1] != 3:
        raise AssertionError("calibrated aggregated scores are not finite (N, 3)")

    for name in ("sw_pairs", "embed_conv_bases", "causal_conv", "fused_reduce"):
        results[name]["launches"] = launches[name] if name != "sw_pairs" else launches["sw_pairs_forward"] + launches["sw_pairs_reverse"]
    summary = {
        "input_bp": total_bp,
        "contigs": len(records) + len(planted),
        "wall_s": wall,
        "proviruses": len(provirus_rows),
        "planted_contigs_with_a_provirus": f"{len(found)} of {N_HVH_CONTIGS}",
        "proviruses_with_their_integrase": with_integrase,
        "summary_rows": tables,
        "launches": launches,
    }
    log("# end-to-end: " + json.dumps(summary))
    where = {
        stage: {
            "wall_s": c["wall_s"],
            **({"k1_launches": {"forward": c["launches"]["sw_pairs_forward"], "reverse": c["launches"]["sw_pairs_reverse"]},
                "pairs": {"forward": c["pairs_forward"], "reverse": c["pairs_reverse"]}}
               if c["launches"]["sw_pairs_forward"] else {}),
            **({"nn_launches": {k: c["launches"][k] for k in nn}} if c["launches"]["embed_conv_bases"] else {}),
        }
        for stage, c in by_stage.items()
    }
    where["crf"] = rec.crf
    where["overlap_note"] = "annotate runs on a worker thread beside the nn contig pass; their walls overlap"
    where.update(end_to_end_device_share(fasta, out_dir, db_dir))
    log("# where the time goes (end-to-end): " + json.dumps(where))
    return summary


def end_to_end_device_share(fasta: Path, out_dir: Path, db_dir: Path) -> dict:
    """Device kernel time of one more run (--restart, torch.profiler) over
    its wall time. Diagnostics only: a failure is reported, not fatal."""
    from genomad_torch import cli

    try:
        from torch.profiler import ProfilerActivity, profile

        t0 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            cli.run_end_to_end(fasta, out_dir, db_dir, verbose=False, enable_score_calibration=True, restart=True, **cli._RELAXED)
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        kernels = [e for e in prof.key_averages() if str(e.device_type).endswith("CUDA")]
        device_us = {e.key: e.self_device_time_total for e in kernels if e.self_device_time_total > 0}
        device_s = sum(device_us.values()) / 1e6
        top = sorted(device_us.items(), key=lambda kv: -kv[1])[:6]
        return {
            "profiled_rerun_wall_s": wall,
            "device_s": device_s,
            "device_busy_share": device_s / wall,
            "k1_device_s": k1_device_s(device_us),
            "device_s_by_kernel": {k[:80]: v / 1e6 for k, v in top},
        }
    except Exception as exc:  # noqa: BLE001 - diagnostics must not hide the contract's result
        return {"device_busy_share": f"not measured: {exc!r}"}


# ---------------------------------------------------------------------------
# Phase 10: run_end_to_end on the card against device="cpu"
# ---------------------------------------------------------------------------

# the scores that pass through the bf16 NN branch agree to this bound (the
# nn-classification module's, PR 1); every other output is byte-equal, or
# within f32 summation order (rtol 1e-5) for the feature and marker npz
NN_ATOL = 1e-2
NPZ_RTOL = 1e-5


def _compare_npz(ref_path: Path, got_path: Path, **tol) -> float:
    ref, got = np.load(ref_path), np.load(got_path)
    if sorted(ref.files) != sorted(got.files):
        raise AssertionError(f"{ref_path.name}: keys {got.files} != {ref.files}")
    worst = 0.0
    for key in ref.files:
        if ref[key].dtype.kind in "fc":
            np.testing.assert_allclose(got[key], ref[key], err_msg=f"{ref_path.name}:{key}", **tol)
            if ref[key].size:
                worst = max(worst, float(np.abs(got[key] - ref[key]).max()))
        else:
            np.testing.assert_array_equal(got[key], ref[key], err_msg=f"{ref_path.name}:{key}")
    return worst


def _compare_summary(ref_path: Path, got_path: Path) -> int:
    ref = [line.split("\t") for line in ref_path.read_text().splitlines()]
    got = [line.split("\t") for line in got_path.read_text().splitlines()]
    if got[0] != ref[0] or len(got) != len(ref):
        raise AssertionError(f"{ref_path.name}: {len(got)} lines != {len(ref)}")
    scores = {i for i, name in enumerate(ref[0]) if name.endswith("_score") or name == "fdr"}
    for r, g in zip(ref[1:], got[1:]):
        if [g[i] for i in range(len(g)) if i not in scores] != [r[i] for i in range(len(r)) if i not in scores]:
            raise AssertionError(f"{ref_path.name}: row {g} != {r}")
        np.testing.assert_allclose([float(g[i]) for i in sorted(scores)], [float(r[i]) for i in sorted(scores)], atol=NN_ATOL, rtol=0)
    return len(ref) - 1


def card_vs_cpu_phase(workdir: Path) -> dict:
    from genomad_torch import cli
    from genomad_torch.ops.profiledb import ProfileDB
    from genomad_torch.paths import GenomadOutputs

    db = ProfileDB.synthetic(seed=17, n_profiles=40, min_len=60, max_len=120)
    db_dir = workdir / "small_db"
    write_db_dir(db_dir, db)
    integrase_db = ProfileDB.load(db_dir / "genomad_integrase_profiles.npz")
    records = host_virus_host_contigs(db, integrase_db, 1, seed=SEED + 5)
    for name, profiles in (("host1", (0, 2, 4, 6, 8, 10)), ("virus1", (1, 3, 5, 7, 9, 11))):
        seq = intergenic(60) + "".join(make_gene(consensus_protein(db, p), seed=p) + intergenic(30) for p in profiles)
        records.append((name, seq + intergenic(800)))
    fasta = workdir / "small.fna"
    fasta.write_text("".join(f">{h}\n{seq}\n" for h, seq in records))
    walls = {}
    for device in ("cuda", "cpu"):
        t0 = time.perf_counter()
        cli.run_end_to_end(fasta, workdir / device, db_dir, verbose=False, enable_score_calibration=True,
                           device=device, **cli._RELAXED)
        walls[device] = time.perf_counter() - t0
    ref, got = GenomadOutputs("small", workdir / "cpu"), GenomadOutputs("small", workdir / "cuda")
    byte_equal = (
        "annotate_proteins_output", "annotate_mmseqs2_output", "annotate_genes_output", "annotate_taxonomy_output",
        "find_proviruses_output", "find_proviruses_nucleotide_output", "find_proviruses_proteins_output",
        "find_proviruses_genes_output", "find_proviruses_taxonomy_output", "find_proviruses_mmseqs2_output",
        "features_output",
    )
    for name in byte_equal:
        if getattr(got, name).read_bytes() != getattr(ref, name).read_bytes():
            raise AssertionError(f"card != CPU: {name} differs")
    errs = {}
    for name in ("features_npz_output", "marker_classification_npz_output"):
        errs[name] = _compare_npz(getattr(ref, name), getattr(got, name), rtol=NPZ_RTOL, atol=0)
    for name in ("nn_classification_npz_output", "aggregated_classification_npz_output",
                 "calibrated_aggregated_classification_npz_output", "provirus_nn_classification_npz_output"):
        errs[name] = _compare_npz(getattr(ref, name), getattr(got, name), atol=NN_ATOL, rtol=0)
    rows = _compare_summary(ref.summary_virus_output, got.summary_virus_output)
    rows += _compare_summary(ref.summary_plasmid_output, got.summary_plasmid_output)
    proviruses = len(got.find_proviruses_output.read_text().splitlines()) - 1
    if not rows or not proviruses:
        raise AssertionError(f"card == CPU fixture: {rows} summary rows, {proviruses} proviruses")
    summary = {"contigs": len(records), "proviruses": proviruses, "summary_rows": rows,
               "wall_s": walls, "max_abs_diff": errs}
    log("# card == CPU (run_end_to_end, small fixture): " + json.dumps(summary))
    return summary


# ---------------------------------------------------------------------------
# Phase 9: the mesh (every cell on this card)
# ---------------------------------------------------------------------------

MESH_SHAPES = ((1, 2), (2, 4))
# beside annotate's proteins (few of which hit), the search phase's mix of
# planted and background queries, so that the hits compared are many
N_MESH_EXTRA_QUERIES = 500
DENSE_QUERIES, DENSE_PROFILES = 64, 512


def hits_equivalent(got: dict, want: dict, what: str) -> None:
    """The JAX package's assert_hits_equivalent: the same queries, targets,
    integer bitscores and taxids; E-values within a relative 1e-4."""
    if got.keys() != want.keys():
        raise AssertionError(f"{what}: {len(got.keys() ^ want.keys())} queries differ")
    for q, (wt, we, wb, wx) in want.items():
        gt, ge, gb, gx = got[q]
        if (gt, gb, gx) != (wt, wb, wx) or abs(ge - we) > 1e-4 * abs(we):
            raise AssertionError(f"{what}: {q}: {got[q]} != {want[q]}")


def mesh_phase(workdir: Path, db) -> dict:
    """On one card every mesh cell is cuda:0: this checks the routing and
    the merge, not scaling."""
    from genomad_torch import sequence
    from genomad_torch.models import igloo, weights
    from genomad_torch.ops import nn_pipeline, sw
    from genomad_torch.ops import protein_search as ps
    from genomad_torch.ops.profiledb import N_AA
    from genomad_torch.parallel import mesh as meshlib
    from genomad_torch.parallel import sharded_search
    from genomad_torch.paths import GenomadOutputs

    records = list(sequence.read_fasta(GenomadOutputs("genome", workdir / "out").annotate_proteins_output))
    extra_names, extra_seqs, _ = bench_queries(db, N_MESH_EXTRA_QUERIES, seed=SEED + 8)
    names = [r.accession for r in records] + extra_names
    seqs = [r.seq for r in records] + extra_seqs
    phase_t0 = time.perf_counter()
    db.kmer_index(1)  # built once per DB object; not in the walls below
    cold, walls, stages, launches = {}, {}, {}, {}

    def search_twice(key, mesh=None):
        """The first search at a mesh shape stages its DB shards (cold);
        the second is timed alone (warm), with the host seconds by stage
        and K1's launches."""
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ps.search(names, seqs, db, mesh=mesh)
        torch.cuda.synchronize()
        cold[key] = time.perf_counter() - t0
        ps.join_prestage()
        if mesh is not None:
            mesh.cell_launches.clear()
        ps.STATS.clear()
        before = sw.sw_pairs.launches
        t0 = time.perf_counter()
        hits = ps.search(names, seqs, db, mesh=mesh)
        torch.cuda.synchronize()
        walls[key] = time.perf_counter() - t0
        stages[key] = {k: v for k, v in ps.STATS.items() if k.endswith("_s")}
        return hits, sw.sw_pairs.launches - before

    ref, launches["none"] = search_twice("none")
    if not ref:
        raise AssertionError("no hit without a mesh")
    for shape in MESH_SHAPES:
        mesh = meshlib.make_mesh(*shape, devices=["cuda:0"] * (shape[0] * shape[1]))
        key = f"{shape[0]}x{shape[1]}"
        got, total = search_twice(key, mesh)
        hits_equivalent(got, ref, f"search on a {key} mesh")
        per_cell = {f"{g},{d}": mesh.cell_launches.get((g, d), 0) for g, d in mesh.rank_cells}
        if min(per_cell.values()) <= 0 or sum(per_cell.values()) != total:
            raise AssertionError(f"K1 launches by cell on the {key} mesh: {per_cell}, {total} in all")
        launches[key] = per_cell

    # dense best hits: mutated consensus queries of the first profiles
    rng = np.random.default_rng(SEED + 9)
    ids = np.arange(DENSE_PROFILES)
    lp = int(db.lengths[ids].max())
    profiles = np.zeros((len(ids), lp, N_AA), np.float32)
    for i in ids:
        prof = db.profile(int(i))
        profiles[i, : len(prof)] = prof
    queries = np.full((DENSE_QUERIES, lp), 20, np.int32)
    for qi, target in enumerate(rng.choice(ids, DENSE_QUERIES, replace=False)):
        cons = db.consensus(int(target)).copy()
        pos = rng.choice(len(cons), len(cons) // 10, replace=False)
        cons[pos] = rng.integers(0, N_AA, len(pos))
        queries[qi, : len(cons)] = cons
    best, score = sharded_search.dense_best_hits(queries, profiles)
    for shape in MESH_SHAPES:
        mesh = meshlib.make_mesh(*shape, devices=["cuda:0"] * (shape[0] * shape[1]))
        b, sc = sharded_search.dense_best_hits(queries, profiles, mesh=mesh)
        if not (np.array_equal(b, best) and np.array_equal(sc, score)):
            raise AssertionError(f"dense_best_hits on a {shape} mesh != without a mesh")

    # predict_windows over a (2, 1) mesh against none
    model = igloo.IglooClassifier(weights.load_params(), device="cuda")
    bases = random_bases(rng, 3 * BATCH + 17)
    plain = nn_pipeline.predict_windows(model, bases, BATCH)
    on_mesh = nn_pipeline.predict_windows(model, bases, BATCH, mesh=meshlib.make_mesh(2, 1, devices=["cuda:0"] * 2))
    # the same kernels on the same rows: equal bit for bit
    nn_err = bit_equal(torch.from_numpy(on_mesh), torch.from_numpy(plain), "predict_windows on a (2, 1) mesh")

    summary = {
        "queries": f"{len(records)} of annotate + {N_MESH_EXTRA_QUERIES} mixed",
        "db_profiles": db.n_profiles,
        "hits": len(ref),
        "search_wall_s": walls,
        "search_cold_s": cold,
        "search_stages_s": stages,
        "k1_launches_by_cell": launches,
        "dense_best_hits": {"queries": DENSE_QUERIES, "profiles": DENSE_PROFILES, "equal": True},
        "predict_windows_2x1_max_abs_diff": nn_err,
        "note": "every cell is cuda:0: routing and merging, not scaling",
        "phase_s": time.perf_counter() - phase_t0,
    }
    log("# mesh: " + json.dumps(summary))
    return summary


# ---------------------------------------------------------------------------
# Phase 12: the trainer at full width
# ---------------------------------------------------------------------------

TRAIN_BATCH = 64
TRAIN_STEPS = 20
TRAIN_LR = 1e-3
TRAIN_DROPOUT = 0.2
TRAIN_CHECK_BATCH = 4
# conv1's gradient kernel against the exact (float64) sums: float32's own
# rounding in its order of summation
WGRAD_REL_L2 = 1e-6
# one step on the card against the same step on the CPU (f32, TF32 off):
# the loss to a relative 1e-5, each leaf's gradient to 1e-4 of its max |g|
TRAIN_LOSS_RTOL = 1e-5
TRAIN_GRAD_RTOL = 1e-4


def toy_windows(rng, n: int, length: int):
    """A separable toy task: window i has class i % 3 and draws its tokens
    from the class's third of 1..256."""
    labels = np.arange(n) % 3
    lo = 1 + 85 * labels
    tokens = (lo[:, None] + rng.integers(0, 85, size=(n, length))).astype(np.int32)
    return tokens, labels.astype(np.int32)


def _leaf_grads(state) -> dict:
    return {f"{g}/{n}": p.grad.detach().clone() for g, sub in state.trainable.items() for n, p in sub.items()}


def train_steps(raw, device, tokens, labels, steps: int, dropout: float, seed: int = SEED):
    """``steps`` steps of make_train_step from ``raw`` on ``device``: the
    losses, host ms per step (synchronised) and step 1's gradients."""
    from genomad_torch import train
    from genomad_torch.models import igloo

    opt = train.make_optimizer(TRAIN_LR)
    state = train.init_train_state(igloo.params_from_numpy(raw, torch.float32), opt, device=device)
    step = train.make_train_step(opt, dropout_rate=dropout)
    gen = torch.Generator(device=device).manual_seed(seed)
    tokens_d, labels_d = torch.from_numpy(tokens).to(device), torch.from_numpy(labels).to(device)
    losses, ms, grads = [], [], None
    for i in range(steps):
        t0 = time.perf_counter()
        state, loss = step(state, tokens_d, labels_d, gen)
        losses.append(float(loss))  # waits for the step
        ms.append((time.perf_counter() - t0) * 1e3)
        if i == 0:
            grads = _leaf_grads(state)
    return losses, ms, grads


def loop_throughput(raw, steps: int) -> dict:
    """The training loop (``train.Trainer.fit``) on a labelled FASTA of
    ``steps`` x TRAIN_BATCH one-window contigs, from a fresh state: one warm
    call, then one timed call (synchronised). ms a step, windows a second and
    the peak memory of the timed call."""
    from genomad_torch import train
    from genomad_torch.models import igloo

    rng = np.random.default_rng(SEED + 12)
    opt = train.make_optimizer(TRAIN_LR)
    state = train.init_train_state(igloo.params_from_numpy(raw, torch.float32), opt)
    trainer = train.Trainer(state, train.make_train_step(opt, TRAIN_DROPOUT), TRAIN_BATCH, SEED)
    bases = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, (steps * TRAIN_BATCH, 6000))]
    with tempfile.TemporaryDirectory(prefix="genomad_torch_train_") as tmp:
        fasta = Path(tmp) / "labelled.fna"
        with open(fasta, "w") as f:
            for i, row in enumerate(bases):
                f.write(f">w{i}|{train.CLASSES[i % 3]}\n{row.tobytes().decode()}\n")
        trainer.fit(fasta)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        done = trainer.fit(fasta)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return {"loop_steps": done, "ms_per_step": wall / done * 1e3, "windows_per_s": done * TRAIN_BATCH / wall,
            "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30}


def train_step_device_share(raw, tokens, labels) -> dict:
    """Device kernel time of one steady training step (torch.profiler,
    after two warm steps) over its wall time, and the kernels that take
    most of it. Diagnostics only: a failure is reported, not fatal."""
    from genomad_torch import train
    from genomad_torch.models import igloo

    try:
        from torch.profiler import ProfilerActivity, profile

        opt = train.make_optimizer(TRAIN_LR)
        state = train.init_train_state(igloo.params_from_numpy(raw, torch.float32), opt)
        step = train.make_train_step(opt, dropout_rate=TRAIN_DROPOUT)
        gen = torch.Generator(device="cuda").manual_seed(SEED)
        tokens_d, labels_d = torch.from_numpy(tokens).cuda(), torch.from_numpy(labels).cuda()
        for _ in range(2):
            state, _ = step(state, tokens_d, labels_d, gen)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            step(state, tokens_d, labels_d, gen)
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        kernels = [e for e in prof.key_averages() if str(e.device_type).endswith("CUDA")]
        device_us = {e.key: e.self_device_time_total for e in kernels if e.self_device_time_total > 0}
        device_ms = sum(device_us.values()) / 1e3
        top = sorted(device_us.items(), key=lambda kv: -kv[1])[:6]
        return {
            "profiled_step_wall_ms": wall * 1e3,
            "device_ms": device_ms,
            "device_busy_share": device_ms / (wall * 1e3),
            "device_ms_by_kernel": {k[:80]: v / 1e3 for k, v in top},
        }
    except Exception as exc:  # noqa: BLE001 - diagnostics must not hide the contract's result
        return {"device_busy_share": f"not measured: {exc!r}"}


def train_phase(results: dict) -> dict:
    import os
    import socket

    import torch.distributed as dist

    from genomad_torch import train
    from genomad_torch.device import disable_tf32
    from genomad_torch.models import igloo
    from genomad_torch.ops import conv
    from genomad_torch.parallel import mesh

    disable_tf32()
    raw = igloo.init_params(SEED)
    rng = np.random.default_rng(SEED + 11)

    # (a) full width, B = 64, dropout on: the loss falls; step 1's gradients;
    # conv1's gradient kernel once a step
    tokens, labels = toy_windows(rng, TRAIN_BATCH, igloo.WINDOW_TOKENS)
    launches = conv.embed_conv_wgrad.launches
    losses, ms, grads = train_steps(raw, "cuda", tokens, labels, TRAIN_STEPS, TRAIN_DROPOUT)
    launches = conv.embed_conv_wgrad.launches - launches
    if launches != TRAIN_STEPS:
        raise AssertionError(f"conv1's gradient kernel ran {launches} times in {TRAIN_STEPS} steps")
    if "embed_conv_wgrad" in results:
        results["embed_conv_wgrad"]["launches"] = launches
    bad = [k for k, g in grads.items() if not bool(torch.isfinite(g).all()) or not bool((g != 0).any())]
    if bad:
        raise AssertionError(f"step 1: gradients not finite or all zero for {bad}")
    if not losses[-1] < 0.8 * losses[0]:
        raise AssertionError(f"the loss did not fall by 20% in {TRAIN_STEPS} steps: {losses}")
    loop = loop_throughput(raw, TRAIN_STEPS)

    # (b) one step at B = 4, dropout 0: the card against the CPU
    tokens4, labels4 = toy_windows(rng, TRAIN_CHECK_BATCH, igloo.WINDOW_TOKENS)
    card_loss, _, card_grads = train_steps(raw, "cuda", tokens4, labels4, 1, 0.0)
    cpu_loss, _, cpu_grads = train_steps(raw, "cpu", tokens4, labels4, 1, 0.0)
    loss_rel = abs(card_loss[0] - cpu_loss[0]) / abs(cpu_loss[0])
    grad_rel = {}
    for key, ref in cpu_grads.items():
        scale = float(ref.abs().max())
        grad_rel[key] = float((card_grads[key].cpu() - ref).abs().max()) / max(scale, 1e-30)
    worst = max(grad_rel, key=grad_rel.get)
    if not loss_rel <= TRAIN_LOSS_RTOL or not grad_rel[worst] <= TRAIN_GRAD_RTOL:
        raise AssertionError(f"card != CPU step: loss rel {loss_rel}, worst gradient {worst} rel {grad_rel[worst]}")

    # (c) the data-parallel step in a one-rank NCCL group == the unsharded step, bit for bit
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    saved = {k: os.environ.get(k) for k in ("RANK", "LOCAL_RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")}
    os.environ.update(RANK="0", LOCAL_RANK="0", WORLD_SIZE="1", MASTER_ADDR="localhost", MASTER_PORT=str(port))
    try:
        if not mesh.initialize_distributed() or dist.get_backend() != "nccl":
            raise AssertionError("initialize_distributed did not join an NCCL group")
        results = []
        opt = train.make_optimizer(TRAIN_LR)
        for step in (train.make_train_step(opt, TRAIN_DROPOUT), train.make_sharded_train_step(opt, dropout_rate=TRAIN_DROPOUT)):
            state = train.init_train_state(igloo.params_from_numpy(raw, torch.float32), opt)
            gen = torch.Generator(device="cuda").manual_seed(SEED)
            state, loss = step(state, torch.from_numpy(tokens4).cuda(), torch.from_numpy(labels4).cuda(), gen)
            values = {f"{g}/{n}": p.detach() for g, sub in state.trainable.items() for n, p in sub.items()}
            results.append((loss, _leaf_grads(state), values))
        (l0, g0, p0), (l1, g1, p1) = results
        bit_equal(l1.reshape(1), l0.reshape(1), "sharded step loss")
        for key in g0:
            bit_equal(g1[key], g0[key], f"sharded step gradient {key}")
            bit_equal(p1[key], p0[key], f"sharded step parameter {key}")
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v

    summary = {
        "batch": TRAIN_BATCH,
        "window_tokens": igloo.WINDOW_TOKENS,
        "dtype": "float32 (TF32 off)",
        "steps": TRAIN_STEPS,
        "dropout": TRAIN_DROPOUT,
        "lr": TRAIN_LR,
        "loss_first_last": [losses[0], losses[-1]],
        "first_step_ms": ms[0],
        "loop": loop,
        "leaves_with_finite_nonzero_grad": len(grads),
        "card_vs_cpu_b4": {"loss_rel": loss_rel, "worst_grad_rel_of_max": grad_rel[worst], "worst_leaf": worst},
        "one_rank_nccl_step": "bit-equal to the unsharded step (loss, gradients, parameters)",
    }
    log("# train: " + json.dumps(summary))
    log("# where the time goes (train step, B = 64): " + json.dumps(train_step_device_share(raw, tokens, labels)))
    return summary


PHASES = ("kernels", "sw", "main", "forward", "annotate", "end-to-end", "mesh", "card-vs-cpu", "search", "train")
# what a phase reads from the phases before it: the kernel table (launches
# per batch, the rows the later phases fill in) and annotate's DB directory
REQUIRES = {
    "main": ("kernels",),
    "forward": ("kernels",),
    "end-to-end": ("kernels", "sw", "annotate"),
    "mesh": ("annotate",),  # annotate's DB and proteins
}


def parse_args(argv: list[str]) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description="Smoke run of genomad_torch on one NVIDIA GPU.")
    parser.add_argument("--only", metavar="PHASE[,PHASE]", help=f"run only these of {', '.join(PHASES)}")
    return parser.parse_args(argv)


def select_phases(argv: list[str]) -> tuple[str, ...]:
    """The phases a run takes after device and build: every phase with no
    arguments; with ``--only PHASE[,PHASE]`` the named ones and those they
    read from, in the script's order. Raises ValueError on an unknown name."""
    args = parse_args(argv)
    if args.only is None:
        return PHASES
    names = {n.strip() for n in args.only.split(",") if n.strip()}
    unknown = sorted(names - set(PHASES))
    if unknown or not names:
        raise ValueError(f"--only takes phases of {PHASES}, got {args.only!r}")
    for name in list(names):
        names.update(REQUIRES.get(name, ()))
    return tuple(p for p in PHASES if p in names)


def main(argv: list[str] | None = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    phases = select_phases(argv)
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
                if "registers" in line or "spill" in line or "wgmma" in line or "Function properties" in line:
                    log(f"#   {name}: {line.strip()}")
    except Exception:  # noqa: BLE001
        failures.append("build")
        traceback.print_exc()

    results: dict = {}
    db = None
    with tempfile.TemporaryDirectory(prefix="genomad_torch_smoke_") as tmp:
        tmp = Path(tmp)
        for sub in ("main", "annotate", "card_cpu"):
            (tmp / sub).mkdir()
        runs = {
            "kernels": lambda: kernel_phase(results),
            "sw": lambda: sw_kernel_phase(results, db),
            "main": lambda: main_path_phase(results, tmp / "main", smi),
            "forward": lambda: forward_phase(results),
            "annotate": lambda: annotate_phase(results, tmp / "annotate", db),
            # on annotate's DB directory
            "end-to-end": lambda: end_to_end_phase(results, tmp / "annotate", db),
            "mesh": lambda: mesh_phase(tmp / "annotate", db),
            "card-vs-cpu": lambda: card_vs_cpu_phase(tmp / "card_cpu"),
            "search": real_db_phase,
            "train": lambda: train_phase(results),
        }
        for name in phases:
            if failures:
                break
            try:
                if name in ("sw", "annotate", "mesh") and db is None:
                    t0 = time.perf_counter()
                    db = bench_db(SW_DB_PROFILES)
                    log(f"# {SW_DB_PROFILES}-profile integral DB built in {time.perf_counter() - t0:.1f} s")
                if name == "card-vs-cpu":
                    db = None  # the later phases build their own DBs
                runs[name]()
            except Exception:  # noqa: BLE001
                failures.append(name)
                traceback.print_exc()

    if failures:
        print(f"chip_smoke: failed phases: {failures}", file=sys.stderr)
        return 1
    if phases != PHASES:
        log(f"# --only: phases {list(phases)} passed (the full run alone prints the kernel table and the ok line)")
        return 0
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: r[k] for k in keys} for r in results.values()]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
