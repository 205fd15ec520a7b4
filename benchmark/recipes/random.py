"""Random ACGT contigs with runs of N and a share of N-rich contigs (a
5,000-N block after the first window), for the NN module."""

from __future__ import annotations

from benchmark.generator import ACGT, Job, contig_lengths


def make(rng, shape, job: str, mix: dict, db, total_bp: int) -> Job:
    records = []
    runs = mix["n_runs"]
    for i, n in enumerate(contig_lengths(shape, mix["contigs"], total_bp)):
        seq = ACGT[rng.integers(0, 4, n)]
        for start in shape.integers(0, n, shape.poisson(runs["per_10kbp"] * n / 1e4)):
            seq[start : start + int(shape.integers(runs["bp"][0], runs["bp"][1] + 1))] = ord("N")
        if n >= 12_000 and shape.random() < mix["n_rich_share"]:
            seq[6_500:11_500] = ord("N")
        records.append((f"{job}_c{i}", seq.tobytes().decode()))
    return Job(job, records)
