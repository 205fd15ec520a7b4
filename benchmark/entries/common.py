"""What the entries share: the device, the card's description, the port's
counters, and the check of the NN scores and window encodings against the
plain IGLOO reference."""

from __future__ import annotations

import gc
import os
import subprocess
from pathlib import Path

import numpy as np
import torch

from benchmark.reference import fasta, igloo

# the port's launch counters that per-layer metrics read
KERNEL_COUNTERS = {
    "k4_launches": ("genomad_torch.ops.conv", "causal_conv", "launches"),
    "k2_launches": ("genomad_torch.ops.patch_reduce", "fused_reduce", "launches"),
}


def records(path: Path) -> list:
    return [(r.header, r.seq) for r in fasta.read_fasta(path)]


class Base:
    """``device``: None runs the port on the card, as its users do; "cpu"
    runs its plain versions (the harness's own tests)."""

    def __init__(self, config: dict, device):
        self.config = config
        self.device = device
        self.on_card = device is None
        self._windows: dict = {}
        self.db = None
        self.widths = igloo.widths(config)

    def settle(self) -> None:
        if self.on_card:
            torch.cuda.synchronize()

    def device_info(self) -> dict:
        info = {"platform": "gpu" if self.on_card else "cpu", "count": 1, "host_cores": os.cpu_count()}
        if self.on_card:
            info["kind"] = torch.cuda.get_device_name(0)
            try:
                out = subprocess.run(
                    ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader,nounits"],
                    capture_output=True, text=True, timeout=60, check=True,
                ).stdout.split()
                info["power_limit_w"] = float(out[0])
            except Exception:  # noqa: BLE001 - a note beside the numbers
                pass
        else:
            info["kind"] = "cpu"
        return info

    def counters(self) -> dict:
        import importlib

        out = {}
        for name, (module, fn, attr) in KERNEL_COUNTERS.items():
            out[name] = float(getattr(getattr(importlib.import_module(module), fn), attr))
        from genomad_torch.ops import protein_search

        out.update({f"stats.{k}": float(v) for k, v in list(protein_search.STATS.items())})
        return out

    def windows_of(self, path: Path) -> int:
        if path not in self._windows:
            self._windows[path] = igloo.window_count(records(path), self.widths)
        return self._windows[path]

    def release(self) -> None:
        """Frees the port's state before the references run."""
        from genomad_torch import database

        database._PROFILE_DB_CACHE.clear()
        gc.collect()
        if self.on_card:
            torch.cuda.synchronize()
            torch.cuda.empty_cache()

    def reference(self, quantize: bool = False) -> igloo.Reference:
        """The float32 reference; ``quantize``: the control, in float8, the
        step below the bfloat16 the configuration states."""
        if quantize and self.config["dtype"] != "bfloat16":
            raise ValueError(f"no control below {self.config['dtype']}")
        w = self.widths
        return igloo.Reference(igloo.init_params(w, self.config["nn_weights_seed"]), w, "cuda" if self.on_card else "cpu", quantize)


def nn_outputs(out: Path, prefix: str) -> tuple:
    """The port's contig scores and window cache of one job."""
    nn_dir = out / f"{prefix}_nn_classification"
    scores = np.load(nn_dir / f"{prefix}_nn_classification.npz")
    cache = np.load(nn_dir / f"{prefix}_encoded_sequences" / f"{prefix}_seq_window_id.npz")
    return (
        dict(zip(scores["contig_names"].tolist(), scores["predictions"])),
        cache["bases"], cache["contig_names"].tolist(), cache["contig_ids"],
    )


def nn_check(ref: igloo.Reference, jobs: list, judged: dict) -> tuple[int, float]:
    """(window rows that differ, widest score gap) over ``jobs``, each
    (fasta path, job output dir). The window cache is compared row for row
    with the reference's encoding; every contig's three scores against the
    reference forward's mean over its windows. A contig the port left out
    reads a gap of 1."""
    rows_differing, gap = 0, 0.0
    for path, out in jobs:
        recs = records(path)
        bases, names, ids = igloo.encode_windows(recs, ref.w)
        got_scores, got_bases, got_names, got_ids = nn_outputs(out, path.stem)
        if got_bases.shape != bases.shape or got_names != names or not np.array_equal(got_ids, ids):
            rows_differing += max(len(bases), len(got_bases))
        else:
            rows_differing += int((got_bases != bases).any(axis=1).sum())
        want = igloo.contig_scores(ref.forward_bases(bases), ids, len(names))
        judged["windows"] = judged.get("windows", 0) + len(bases)
        judged["contigs"] = judged.get("contigs", 0) + len(names)
        for name, row in zip(names, want):
            got = got_scores.get(name)
            gap = max(gap, 1.0 if got is None else float(np.abs(np.asarray(got, np.float64) - row).max()))
    return rows_differing, gap
