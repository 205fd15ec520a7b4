"""The control of the NN score check: the plain reference put in the
port's place and computed one precision step below the configuration's
bfloat16 (float8 e4m3 with per-tensor scales, ``reference.igloo``'s
``quantize``). For each seed it makes the cell's job pool, takes the jobs
a run checks (the first and one drawn from the seed, as ``benchmark.run``
does when the window reaches them) and prints the widest gap between the
control's contig scores and the float32 reference's: the check's upper
reading. The benchmark's own runs never run it.

    python3 -m benchmark.control --workload CELL --seeds 1 2 3
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
from pathlib import Path

import numpy as np


def control_gap(workload: str, seed: int, device=None, overrides=None) -> dict:
    from benchmark import generator, manifest as mf
    from benchmark.entries.common import Base, records
    from benchmark.reference import igloo
    from benchmark import dbsynth

    cell = mf.cell(mf.load_manifest(), workload)
    config = mf.config(cell["config"])
    mix = mf.traffic(cell["traffic"])
    if overrides:
        config = {**config, **overrides.get("config", {})}
        mix = {**mix, **overrides.get("traffic", {})}
    db = None
    if "db" in config:
        cache = dbsynth.CACHE if not overrides else Path(tempfile.mkdtemp(prefix="genomad-bench-control-"))
        db, _ = dbsynth.ensure_db(cell["config"], config["db"], cache)
    base = Base(config, device)
    rng = np.random.default_rng([seed, 7])
    picks = sorted({0, int(rng.integers(1, config["check_jobs_within"]))})
    ref, ctl = base.reference(), base.reference(quantize=True)
    gap, windows = 0.0, 0
    with tempfile.TemporaryDirectory() as tmp:
        for i in picks:
            job = generator.make_job(mix, config, seed, i % mix["pool_jobs"], db)
            path = Path(tmp) / f"sample{i}.fna"
            job.write_fasta(path)
            bases, names, ids = igloo.encode_windows(records(path), base.widths)
            want = igloo.contig_scores(ref.forward_bases(bases), ids, len(names))
            got = igloo.contig_scores(ctl.forward_bases(bases), ids, len(names))
            gap = max(gap, float(np.abs(got - want).max()))
            windows += len(bases)
    return {"workload": workload, "seed": seed, "control_nn_score_gap": gap, "windows": windows}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    args = parser.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 3
    for seed in args.seeds:
        print(json.dumps(control_gap(args.workload, seed)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
