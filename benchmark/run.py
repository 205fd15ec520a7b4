"""Run one cell of ``BENCHMARK.json`` once:

    python3 -m benchmark.run --workload CELL --seed N --seconds S --trace 0|1

Set-up: the configuration's DB (written on a checkout's first run), the job
pool from ``--seed``, the port's entry with its DB and kernels loaded, one
warm-up job. ``setup_s`` is the time from the process's start to the end of
the warm-up job less the harness's own work in it (the DB's synthesis or
load and the job pool), which no user of the program pays. Window: one client, closed loop: a job starts when the last
ends, jobs start until ``--seconds`` have passed, then the job in flight
finishes. With ``--trace 1`` the harness's spans, the port's counters and
``torch.profiler``'s device activity are recorded over the window and the
cell's per-layer metrics are printed instead of its end-to-end ones. Every
metric but ``setup_s`` is read by ``benchmark/metrics/<name>.py``. Then
the check against the plain references. The last line of standard output
is one JSON object; the compared numbers with their limits are also the
last lines of standard error.
"""

from __future__ import annotations

import time

_T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent
CACHE = ROOT / "cache"
FORBIDDEN = ("jax", "jaxlib", "flax", "genomad_tpu")
WARM_UP_JOB = (1 << 32) - 1  # the warm-up job's stream, apart from the pool's


def _cache_env() -> None:
    """Every build and kernel cache at a fixed path of the checkout."""
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
    os.environ["USE_FLAX"] = "0"
    os.environ.setdefault("USE_TF", "0")


def forbidden_modules(names=None) -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    names = sys.modules if names is None else names
    return sorted({n for n in names if n.split(".", 1)[0] in FORBIDDEN})


class Window:
    """The closed loop: runs jobs from the pool until ``seconds`` have
    passed, then lets the job in flight end. Keeps the output directory of
    the jobs in ``keep`` and of the latest job; deletes the others once the
    next job has ended."""

    def __init__(self, entry, pool, fastas, workdir: Path, seconds: float, keep: set, spans=None):
        self.entry, self.pool, self.fastas = entry, pool, fastas
        self.workdir, self.seconds, self.keep, self.spans = workdir, seconds, keep, spans
        self.done: list = []  # (job index, pool index, out dir, bp)
        self.job_s: list = []
        self.failed = 0

    def run(self) -> None:
        self.t0 = time.perf_counter()
        k = 0
        while time.perf_counter() - self.t0 < self.seconds:
            i = k % len(self.pool)
            out = self.workdir / f"job{k}"
            if self.spans is not None:
                self.spans.job = k
            t = time.perf_counter()
            try:
                self.entry.run(self.fastas[i], out)
            except Exception as exc:  # noqa: BLE001 - a failed job is counted, the loop goes on
                self.failed += 1
                print(f"job {k} failed: {exc!r}", file=sys.stderr)
            self.job_s.append(time.perf_counter() - t)
            self.done.append((k, i, out, self.pool[i].bp))
            if len(self.done) > 1 and self.done[-2][0] not in self.keep:
                shutil.rmtree(self.done[-2][2], ignore_errors=True)
            k += 1
        self.t1 = time.perf_counter()


def run_cell(workload: str, seed: int, seconds: float, trace: bool, device=None, overrides=None, workdir=None) -> dict:
    """One run of a cell; returns the result object. ``device``: None is
    the card (the benchmark's runs); "cpu" with ``overrides`` (a smaller
    configuration and mix) serves the harness's own tests."""
    import numpy as np
    import torch

    from benchmark import generator, manifest as mf, tracing
    import importlib

    manifest = mf.load_manifest()
    cell = mf.cell(manifest, workload)
    config = mf.config(cell["config"])
    mix = mf.traffic(cell["traffic"])
    if overrides:
        config = {**config, **overrides.get("config", {})}
        mix = {**mix, **overrides.get("traffic", {})}
    # a mix may set a check's limit for its cell: a contig's score gap, a
    # mean over its windows, shrinks with the contig lengths the mix draws
    config = {**config, "limits": {**config["limits"], **mix.get("limits", {})}}
    entry_mod = importlib.import_module(f"benchmark.entries.{config['entry']}")
    own = Path(workdir) if workdir else Path(tempfile.mkdtemp(prefix="genomad-bench-"))
    try:
        parts = {"start": time.perf_counter() - _T_START}
        t = time.perf_counter()
        entry = entry_mod.Entry(cell["config"], config, device, CACHE if not overrides else own / "cache")
        parts["harness_db"] = time.perf_counter() - t
        t = time.perf_counter()
        pool = generator.make_pool(mix, config, seed, entry.db)
        pool_dir = own / "pool"
        pool_dir.mkdir(parents=True, exist_ok=True)
        fastas = []
        for i, job in enumerate(pool):
            fastas.append(pool_dir / f"sample{i}.fna")
            job.write_fasta(fastas[-1])
        warm = generator.make_job({**mix, **mix.get("warm_up", {})}, {**config, "sample_mbp": mix["warm_up_mbp"]}, seed, WARM_UP_JOB, entry.db)
        warm_fasta = pool_dir / "warmup.fna"
        warm.write_fasta(warm_fasta)
        parts["pool"] = time.perf_counter() - t
        t = time.perf_counter()
        entry.run(warm_fasta, own / "warmup")
        shutil.rmtree(own / "warmup", ignore_errors=True)
        entry.settle()
        parts["warm_up_job"] = time.perf_counter() - t
        setup_s = time.perf_counter() - _T_START - parts["harness_db"] - parts["pool"]

        rng = np.random.default_rng([seed, 7])
        keep = entry.check_sample(rng)
        spans = tracing.Spans() if trace else None
        if spans is not None:
            for owner, attr, name, stats in entry.span_points():
                spans.wrap(owner, attr, name, stats)
        counters0 = entry.counters()
        window = Window(entry, pool, fastas, own / "jobs", seconds, keep, spans)
        (own / "jobs").mkdir()
        profiler = tracing.Profiler() if trace and entry.on_card else None
        if profiler is not None:
            with profiler:
                window.run()
                entry.settle()
        else:
            window.run()
        if spans is not None:
            spans.restore()
        counters = tracing.delta(entry.counters(), counters0)
        peak = int(torch.cuda.max_memory_allocated()) if entry.on_card else 0

        mbp = sum(d[3] for d in window.done) / 1e6
        wall = window.t1 - window.t0
        device_info = entry.device_info()
        device_info["memory_peak_bytes"] = peak
        result = {"attempted": len(window.done), "failed": window.failed, "job_s": window.job_s}
        dev = None
        if trace:
            dev = profiler.read(window.t0, window.t1) if profiler is not None else tracing.DeviceTrace([], window.t0, window.t1)
            device_info["busy_s"] = dev.busy_s()
            device_info["window_s"] = wall
            result["breakdown"] = {"device_ops": dev.top_ops(), "idle_gaps": dev.idle_by_span(spans.spans)}
        windows = sum(entry.windows_of(fastas[d[1]]) for d in window.done)
        ctx = Context(spans, dev, counters, mbp, windows, wall, entry.widths)
        metrics = {}
        for m in mf.metrics_of_cell(manifest, workload, "per_layer" if trace else "end_to_end"):
            value = setup_s if m["name"] == "setup_s" else mf.metric_reader(m["name"])(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        result["metrics"] = metrics
        result["device"] = device_info

        reached = [(k, i, out) for k, i, out, _ in window.done if k in keep]
        kept = reached or [window.done[-1][:3]]
        entry.release()
        t = time.perf_counter()
        checks = entry.check(pool, fastas, kept, own / "check")
        result["check_s"] = time.perf_counter() - t
        result["setup_parts_s"] = parts
        ok = window.failed == 0 and len(window.done) > 0 and all(c["value"] <= c["limit"] for c in checks.values())
        return {"correct": bool(ok), **result, "judged": entry.judged, "checks": checks}
    finally:
        if not workdir:
            shutil.rmtree(own, ignore_errors=True)


class Context:
    """What a metric's reader gets: the harness's spans and the device trace
    (both None without ``--trace 1``), the port's counters over the window,
    the Mbp and NN windows of the jobs run, the window's length in seconds
    (from its start to the last job's end) and the configuration's model
    widths."""

    def __init__(self, spans, device, counters, mbp, windows, window_s, widths):
        self.spans, self.device, self.counters = spans, device, counters
        self.mbp, self.windows, self.window_s, self.widths = mbp, windows, window_s, widths


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    _cache_env()
    try:
        import torch

        from benchmark import manifest as mf

        chips = mf.cell(mf.load_manifest(), args.workload)["chips"]
        import genomad_torch  # noqa: F401 - the system under test must be there
    except Exception as exc:  # noqa: BLE001
        print(f"cannot run: {exc!r}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"needs {chips} CUDA device(s); found {torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 3
    result = run_cell(args.workload, args.seed, args.seconds, bool(args.trace))
    bad = forbidden_modules()
    if bad:
        print(f"JAX or the JAX package was loaded: {bad}", file=sys.stderr)
        return 4
    checks = result["checks"]
    for name, c in checks.items():
        print(f"{name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stdout.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
