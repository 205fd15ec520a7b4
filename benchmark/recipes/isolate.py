"""An isolate: one chromosome contig with prophages (an integrase gene and
a share of virus-marker genes, odd profiles) among host genes (a share of
them chromosome markers, even profiles), and one plasmid contig."""

from __future__ import annotations

import numpy as np

from benchmark.generator import INTEGRASE, GeneContig, Job


def make(rng, shape, job: str, mix: dict, db, total_bp: int) -> Job:
    genes, phage = mix["genes"], mix["prophage"]
    even = np.arange(0, db.n_profiles, 2)
    odd = np.arange(1, db.n_profiles, 2)
    chrom = GeneContig(f"{job}_chromosome", rng, shape, genes)
    n_phage = phage["count"]
    host_bp = (total_bp - n_phage * phage["bp"]) // (n_phage + 1)
    prophages = []
    for k in range(n_phage + 1):
        chrom.fill(chrom.length + host_bp, genes["planted_share"], even, db)
        if k < n_phage:
            chrom.add(db.integrase_consensus[int(rng.integers(0, len(db.integrase_consensus)))], INTEGRASE)
            first = len(chrom.written) - 1
            chrom.fill(chrom.length + phage["bp"], phage["virus_marker_share"], odd, db)
            prophages.append((chrom.name, chrom.written[first][1], chrom.written[-1][2]))
    plasmid = GeneContig(f"{job}_plasmid", rng, shape, genes)
    plasmid.fill(mix["plasmid_bp"], genes["planted_share"], None, db)
    return Job(job, [chrom.done(), plasmid.done()], chrom.written + plasmid.written, prophages)
