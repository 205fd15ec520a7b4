"""Runs cells one after another, each run a process of its own, and keeps
every result line:

    python3 -m benchmark.repeat --out FILE.jsonl CELL:SEED:SECONDS:TRACE ...

Each line of FILE is {"cell", "seed", "seconds", "trace", "rc", "wall_s",
"result" (the run's last stdout line, parsed), "stderr_tail"}. At the end
it prints, per cell and metric of the untraced runs, the median and the
spread (the distance between the quartiles of
``statistics.quantiles(values, n=4)`` as a share of the median), which is
what the bounds of ``BENCHMARK.json`` are set from.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path


def spreads(lines: list) -> dict:
    by: dict = {}
    for line in lines:
        r = line.get("result")
        if not r or line["trace"]:
            continue
        for name, m in r["metrics"].items():
            by.setdefault(line["cell"], {}).setdefault(name, []).append(m["value"])
    out = {}
    for cell, metrics in by.items():
        for name, values in metrics.items():
            if len(values) >= 2:
                q1, med, q3 = statistics.quantiles(values, n=4)
                out[f"{cell} {name}"] = {"n": len(values), "median": statistics.median(values), "spread": (q3 - q1) / statistics.median(values)}
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--out", required=True)
    parser.add_argument("runs", nargs="+", help="CELL:SEED:SECONDS:TRACE")
    args = parser.parse_args(argv)
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    lines = []
    for spec in args.runs:
        cell, seed, seconds, trace = spec.rsplit(":", 3)
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "benchmark.run", "--workload", cell, "--seed", seed, "--seconds", seconds, "--trace", trace],
            capture_output=True, text=True,
        )
        line = {"cell": cell, "seed": int(seed), "seconds": float(seconds), "trace": int(trace), "rc": proc.returncode,
                "wall_s": time.perf_counter() - t0, "stderr_tail": proc.stderr[-3000:]}
        try:
            line["result"] = json.loads(proc.stdout.strip().splitlines()[-1])
        except (IndexError, json.JSONDecodeError):
            line["result"] = None
            line["stdout_tail"] = proc.stdout[-3000:]
        lines.append(line)
        with open(out, "a") as f:
            f.write(json.dumps(line) + "\n")
        r = line["result"] or {}
        print(json.dumps({k: line[k] for k in ("cell", "seed", "trace", "rc", "wall_s")}
                         | {"correct": r.get("correct"), "metrics": {k: v["value"] for k, v in r.get("metrics", {}).items()},
                            "checks": {k: v["value"] for k, v in r.get("checks", {}).items()}}), flush=True)
    print(json.dumps({"spreads": spreads(lines)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
