"""The one traffic generator: reads a traffic mix's data file
(``benchmark/traffic/<mix>.json``) and makes a pool of jobs from ``--seed``.

A job is one sample FASTA. Its sizes (contig lengths, runs of N, which
genes are planted, protein and spacer lengths) come from a stream fixed
by the job's index alone, ``default_rng([SIZES, index])``; its content
(bases, residues, profiles, codons) from ``default_rng([seed, index])``.
So every seed gives the same sizes, and so about the same work, with
other sequences, and a seed gives the same jobs whatever the pool size.

The mix's ``content`` names its recipe, ``benchmark/recipes/<content>.py``,
whose ``make(rng, shape, name, mix, db, total_bp)`` returns the ``Job``; a
new kind of traffic is a new recipe file. The pieces here are the recipes'
own: log-normal contig lengths, and genes (a Shine-Dalgarno RBS, a spacer,
ATG, the codons of a protein with varied synonymous codons, TAA) between
stop-dense TTAA spacers.

Contig lengths are log-normal, clipped. Each job records, 1-based and on
the forward strand, every gene it wrote as (contig, begin, end, profile),
profile -1 for a background protein and -2 for an integrase, and each
prophage region as (contig, begin, end): from its integrase gene to its
last gene.
"""

from __future__ import annotations

import importlib
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

from benchmark.dbsynth import ALPHABET, BACKGROUND_FREQS, N_AA

# the standard code (11) over codons in ACGT order (AAA, AAC, AAG, AAT, ...)
_CODON_TABLE_11 = "KNKNTTTTRSRSIIMIQHQHPPPPRRRRLLLLEDEDAAAAGGGGVVVV*Y*YSSSS*CWCLFLF"
SYNONYMS: dict[str, list[str]] = {}
for _i, _aa in enumerate(_CODON_TABLE_11):
    SYNONYMS.setdefault(_aa, []).append("ACGT"[_i // 16] + "ACGT"[(_i // 4) % 4] + "ACGT"[_i % 4])
ACGT = np.frombuffer(b"ACGT", np.uint8)
SIZES = 0x5EED5
BACKGROUND, INTEGRASE = -1, -2  # the profile of a gene that is no marker


@dataclass
class Job:
    name: str
    records: list  # [(contig name, sequence str)]
    genes: list = field(default_factory=list)  # [(contig, begin, end, profile)]
    prophages: list = field(default_factory=list)  # [(contig, begin, end)]

    @property
    def planted(self) -> list:
        """The marker genes: (contig, begin, end, profile)."""
        return [g for g in self.genes if g[3] >= 0]

    @property
    def bp(self) -> int:
        return sum(len(s) for _, s in self.records)

    def write_fasta(self, path: Path) -> None:
        with open(path, "w") as f:
            for name, seq in self.records:
                f.write(f">{name}\n{seq}\n")


def contig_lengths(rng, spec: dict, total_bp: int) -> list[int]:
    """Log-normal lengths (median, sigma, clipped to [min_bp, max_bp])
    until they add up to ``total_bp``; the last one is cut to fit, and
    dropped when that leaves it under ``min_bp``."""
    out, total = [], 0
    while total < total_bp:
        n = int(np.clip(rng.lognormal(np.log(spec["median_bp"]), spec["sigma"]), spec["min_bp"], spec["max_bp"]))
        n = min(n, total_bp - total)
        if n < spec["min_bp"] and out:
            break
        out.append(n)
        total += n
    return out


def make_gene(rng, protein: str, rbs: str = "AGGAGG", spacer: int = 7) -> tuple[str, int]:
    """(gene, offset of its ATG): RBS + spacer + ATG + CDS + TAA."""
    cds = "".join(SYNONYMS[aa][rng.integers(0, len(SYNONYMS[aa]))] for aa in protein)
    return rbs + "C" * spacer + "ATG" + cds + "TAA", len(rbs) + spacer


def intergenic(n: int) -> str:
    """Stop-dense filler on both strands in every frame."""
    return ("TTAA" * (n // 4 + 1))[:n]


def mutated(rng, residues: np.ndarray, rate: float) -> np.ndarray:
    prot = np.array(residues, copy=True)
    pos = rng.choice(len(prot), int(len(prot) * rate), replace=False)
    prot[pos] = rng.integers(0, N_AA, len(pos))
    return prot


def text(residues) -> str:
    return "".join(ALPHABET[r] for r in residues)


class GeneContig:
    """Builds one contig of genes, recording each as it is written."""

    def __init__(self, name: str, rng, shape, genes: dict):
        self.name, self.rng, self.shape, self.genes = name, rng, shape, genes
        self.parts: list[str] = []
        self.length = 0
        self.written: list = []
        self.prophage = None

    def add(self, residues, profile: int) -> None:
        """A gene of ``residues``; ``profile`` as in ``Job.genes``."""
        lo, hi = self.genes["intergenic_bp"]
        spacer = intergenic(int(self.shape.integers(lo, hi + 1)))
        gene, atg = make_gene(self.rng, text(residues))
        begin = self.length + len(spacer) + atg + 1
        self.written.append((self.name, begin, begin + 3 * len(residues) + 5, int(profile)))
        self.parts += [spacer, gene]
        self.length += len(spacer) + len(gene)

    def background(self) -> np.ndarray:
        lo, hi = self.genes["protein_len"]
        return self.rng.choice(N_AA, int(self.shape.integers(lo, hi + 1)), p=BACKGROUND_FREQS)

    def fill(self, target_bp: int, share: float, profiles, db) -> None:
        while self.length < target_bp:
            if self.shape.random() < share:
                p = int(profiles[self.rng.integers(0, len(profiles))]) if profiles is not None else int(self.rng.integers(0, db.n_profiles))
                self.add(mutated(self.rng, db.consensus(p), self.genes["substitution_rate"]), p)
            else:
                self.add(self.background(), BACKGROUND)

    def done(self) -> tuple[str, str]:
        return self.name, "".join(self.parts) + intergenic(30)


def make_job(mix: dict, config: dict, seed: int, index: int, db=None) -> Job:
    """Job ``index`` of the pool of ``seed``."""
    rng = np.random.default_rng([seed % (1 << 64), index % (1 << 32)])
    shape = np.random.default_rng([SIZES, index % (1 << 32)])
    name = f"s{index}"
    total_bp = int(round(config["sample_mbp"] * 1e6))
    recipe = importlib.import_module(f"benchmark.recipes.{mix['content']}")
    return recipe.make(rng, shape, name, mix, db, total_bp)


def make_pool(mix: dict, config: dict, seed: int, db=None) -> list[Job]:
    return [make_job(mix, config, seed, i, db) for i in range(mix["pool_jobs"])]
