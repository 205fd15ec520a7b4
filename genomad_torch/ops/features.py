"""Marker-branch feature extraction: per-contig gene/marker statistics.

Computes the 25-feature vector consumed by the decision forest, plus the
auxiliary per-contig counts used by downstream filters. Numeric parity with
genomad/modules/marker_classification.py:58-335:

Feature order (marker_classification.py:223-233):
  0 strand_switch_rate, 1 coding_density,
  2 no_rbs_freq, 3 sd_bacteroidetes_rbs_freq, 4 sd_canonical_rbs_freq,
  5 tatata_rbs_freq,
  6-14 specificity-class freqs (CC CP CV PC PP PV VC VP VV),
  15-17 aggregate marker freqs (C P V),
  18-20 median SPMs (C P V),
  21-23 logistic(compound score, T=2) (v_vs_c, v_vs_p, p_vs_c),
  24 gv_marker_freq.

Compound score:      sum(exp(spm_a) - exp(spm_b)) over the contig's markers.
Marker enrichment:   sum(exp(spm_x) - exp(spm_y + spm_z)).
Overflow in exp for extremely marker-dense contigs is tolerated (inf ->
logistic saturates to 1.0), matching the reference's warning suppression
(marker_classification.py:13-16).

A copy of ``genomad_tpu/ops/features.py`` (host, numpy).
"""

from __future__ import annotations

import warnings
from collections import Counter
from dataclasses import dataclass, field
from pathlib import Path
from typing import List

import numpy as np

from genomad_torch import sequence, utils

FEATURE_FILE_HEADER = "\t".join(
    [
        "seq_name", "n_genes", "n_uscg", "n_plasmid_hallmarks", "n_virus_hallmarks",
        "genetic_code", "strand_switch_rate", "coding_density", "no_rbs_freq",
        "sd_bacteroidetes_rbs_freq", "sd_canonical_rbs_freq", "tatata_rbs_freq",
        "cc_marker_freq", "cp_marker_freq", "cv_marker_freq", "pc_marker_freq",
        "pp_marker_freq", "pv_marker_freq", "vc_marker_freq", "vp_marker_freq",
        "vv_marker_freq", "c_marker_freq", "p_marker_freq", "v_marker_freq",
        "median_c_spm", "median_p_spm", "median_v_spm", "v_vs_c_score_logistic",
        "v_vs_p_score_logistic", "p_vs_c_score_logistic", "gv_marker_freq",
        "marker_enrichment_c", "marker_enrichment_p", "marker_enrichment_v",
    ]
)

_SPECIFICITY_CLASSES = ("CC", "CP", "CV", "PC", "PP", "PV", "VC", "VP", "VV")


@dataclass
class AnnotatedContig:
    seq_name: str
    contig_length: int
    coding_length: int = 0
    n_genes: int = 0
    n_uscg: int = 0
    n_plasmid_hallmarks: int = 0
    n_virus_hallmarks: int = 0
    genetic_code: int = 11
    n_gv_markers: int = 0
    class_counts: Counter = field(default_factory=Counter)
    spm_c: List[float] = field(default_factory=list)
    spm_p: List[float] = field(default_factory=list)
    spm_v: List[float] = field(default_factory=list)
    gene_strands: List[int] = field(default_factory=list)
    gene_rbs: List[str] = field(default_factory=list)

    @property
    def n_markers(self) -> int:
        return len(self.spm_c)

    @property
    def strand_switch_rate(self) -> float:
        if self.n_genes < 2:
            return 0.0
        switches = sum(
            self.gene_strands[i] != self.gene_strands[i + 1]
            for i in range(self.n_genes - 1)
        )
        return switches / (self.n_genes - 1)

    def compound_score(self, a: str, b: str) -> float:
        spm = {"c": self.spm_c, "p": self.spm_p, "v": self.spm_v}
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            return float((np.exp(spm[a]) - np.exp(spm[b])).sum())

    def marker_enrichment(self, x: str) -> float:
        spm = {"c": self.spm_c, "p": self.spm_p, "v": self.spm_v}
        others = [k for k in "cpv" if k != x]
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            return float(
                (np.exp(spm[x]) - np.exp(np.add(spm[others[0]], spm[others[1]]))).sum()
            )


def read_rbs_categories(rbs_file: Path) -> dict:
    categories = {}
    for line in utils.read_file(rbs_file):
        rbs, category = line.strip("\n").split("\t")
        categories[rbs] = category
    return categories


def yield_annotated_contigs(input_path, genes_output, database_obj, rbs_categories: dict):
    """Stream the genes table into per-contig accumulators
    (reference: marker_classification.py:141-214)."""
    contigs = {
        seq.accession: AnnotatedContig(seq.accession, len(seq))
        for seq in sequence.read_fasta(input_path, strip_n=True)
    }
    marker_features = database_obj.get_marker_features()
    for line in utils.read_file(genes_output, skip_header=True):
        fields = line.strip("\n").split("\t")
        gene, gene_length, strand, genetic_code, rbs, match = (
            fields[0], int(fields[3]), int(fields[4]), int(fields[6]), fields[7], fields[8],
        )
        contig = gene.rsplit("_", 1)[0]
        if contig not in contigs:  # all-N contigs are absent after strip_n
            continue
        spec_class, spm_c, spm_p, spm_v, gv_marker, uscg, p_hallmark, v_hallmark = (
            marker_features.get(match, (None, 0.0, 0.0, 0.0, 0, 0, 0, 0))
        )
        c = contigs[contig]
        c.n_genes += 1
        c.coding_length += gene_length
        c.gene_strands.append(strand)
        c.gene_rbs.append(rbs_categories.get(rbs, "None"))
        c.genetic_code = genetic_code
        if spec_class:
            c.spm_c.append(spm_c)
            c.spm_p.append(spm_p)
            c.spm_v.append(spm_v)
            c.n_gv_markers += gv_marker
            c.n_uscg += uscg
            c.n_plasmid_hallmarks += p_hallmark
            c.n_virus_hallmarks += v_hallmark
            if spec_class in _SPECIFICITY_CLASSES:
                c.class_counts[spec_class] += 1
    yield from contigs.values()


def get_feature_array(input_path, genes_output, database_obj, rbs_file):
    """Columnar feature table (reference: marker_classification.py:217-335).

    Returns (names, n_genes, n_uscg, n_hallmarks, genetic_code,
    features (N, 25), marker_enrichment (N, 3)).
    """
    rbs_categories = read_rbs_categories(rbs_file)
    names, n_genes_arr, n_uscg_arr, hallmarks_arr, code_arr = [], [], [], [], []
    features_arr, enrichment_arr = [], []
    for c in yield_annotated_contigs(input_path, genes_output, database_obj, rbs_categories):
        names.append(c.seq_name)
        n_genes_arr.append(c.n_genes)
        n_uscg_arr.append(c.n_uscg)
        hallmarks_arr.append([c.n_plasmid_hallmarks, c.n_virus_hallmarks])
        code_arr.append(c.genetic_code)
        rbs_freq = Counter(c.gene_rbs)
        n = c.n_genes
        class_freqs = [c.class_counts[k] / n if n else 0.0 for k in _SPECIFICITY_CLASSES]
        n_c = sum(c.class_counts[k] for k in ("CC", "CP", "CV"))
        n_p = sum(c.class_counts[k] for k in ("PC", "PP", "PV"))
        n_v = sum(c.class_counts[k] for k in ("VC", "VP", "VV"))
        features_arr.append(
            [
                c.strand_switch_rate,
                c.coding_length / c.contig_length,
                rbs_freq.get("None", 0) / n if n else 0.0,
                rbs_freq.get("SD_Bacteroidetes", 0) / n if n else 0.0,
                rbs_freq.get("SD_Canonical", 0) / n if n else 0.0,
                rbs_freq.get("TATATA_3_6", 0) / n if n else 0.0,
                *class_freqs,
                n_c / n if n else 0.0,
                n_p / n if n else 0.0,
                n_v / n if n else 0.0,
                float(np.median(c.spm_c)) if c.n_markers else 0.0,
                float(np.median(c.spm_p)) if c.n_markers else 0.0,
                float(np.median(c.spm_v)) if c.n_markers else 0.0,
                float(utils.logistic(c.compound_score("v", "c"), 2)),
                float(utils.logistic(c.compound_score("v", "p"), 2)),
                float(utils.logistic(c.compound_score("p", "c"), 2)),
                c.n_gv_markers / n if n else 0.0,
            ]
        )
        enrichment_arr.append(
            [c.marker_enrichment("c"), c.marker_enrichment("p"), c.marker_enrichment("v")]
        )
    return (
        np.array(names),
        np.array(n_genes_arr),
        np.array(n_uscg_arr),
        np.array(hallmarks_arr),
        np.array(code_arr),
        np.array(features_arr),
        np.array(enrichment_arr),
    )
