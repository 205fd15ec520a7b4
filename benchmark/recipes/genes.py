"""Metagenome contigs of genes: a share of the proteins are mutated
consensus sequences of DB profiles (the marker hits), the rest background
residues; plus host-virus-host contigs, each with a prophage of
virus-marker genes and an integrase gene between chromosome-marker genes."""

from __future__ import annotations

import numpy as np

from benchmark.generator import INTEGRASE, GeneContig, Job, contig_lengths


def _hvh_contig(rng, shape, name: str, db, genes: dict, k: int) -> tuple:
    """7 chromosome-marker genes (even profiles), 20 virus-marker genes (odd
    profiles), an integrase gene and 7 more chromosome-marker genes, each
    an unmutated consensus; the prophage runs from the first virus-marker
    gene to the integrase."""
    even = rng.choice(np.arange(0, db.n_profiles, 2), 14, replace=False)
    odd = rng.choice(np.arange(1, db.n_profiles, 2), 20, replace=False)
    contig = GeneContig(name, rng, shape, genes)
    for p in list(even[:7]) + list(odd):
        contig.add(db.consensus(int(p)), int(p))
    contig.add(db.integrase_consensus[k % len(db.integrase_consensus)], INTEGRASE)
    contig.prophage = (name, contig.written[7][1], contig.written[-1][2])
    for p in even[7:]:
        contig.add(db.consensus(int(p)), int(p))
    return contig


def make(rng, shape, job: str, mix: dict, db, total_bp: int) -> Job:
    genes = mix["genes"]
    records, written = [], []
    hvh = [_hvh_contig(rng, shape, f"{job}_hvh{k}", db, genes, int(rng.integers(0, 1 << 30))) for k in range(mix["hvh_contigs"])]
    for c in hvh:
        total_bp -= c.length
    for i, n in enumerate(contig_lengths(shape, mix["contigs"], total_bp)):
        contig = GeneContig(f"{job}_c{i}", rng, shape, genes)
        contig.fill(n, genes["planted_share"], None, db)
        records.append(contig.done())
        written += contig.written
    for c in hvh:
        records.append(c.done())
        written += c.written
    return Job(job, records, written, [c.prophage for c in hvh])
