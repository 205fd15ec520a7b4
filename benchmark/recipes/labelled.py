"""Labelled contigs for training: random contigs of one class each, drawn
per contig at the mix's class shares, with bases at the class's GC content
and runs of N, named ``<job>_c<i>|<class>`` (the trainer's labels)."""

from __future__ import annotations

from benchmark.generator import ACGT, Job, contig_lengths


def make(rng, shape, job: str, mix: dict, db, total_bp: int) -> Job:
    classes = mix["classes"]
    names = list(classes)
    shares = [classes[n]["share"] for n in names]
    runs = mix["n_runs"]
    records = []
    for i, n in enumerate(contig_lengths(shape, mix["contigs"], total_bp)):
        k = int(rng.choice(len(names), p=shares))
        gc = classes[names[k]]["gc"]
        seq = ACGT[rng.choice(4, n, p=[(1 - gc) / 2, gc / 2, gc / 2, (1 - gc) / 2])]
        for start in shape.integers(0, n, shape.poisson(runs["per_10kbp"] * n / 1e4)):
            seq[start : start + int(shape.integers(runs["bp"][0], runs["bp"][1] + 1))] = ord("N")
        records.append((f"{job}_c{i}|{names[k]}", seq.tobytes().decode()))
    return Job(job, records)
