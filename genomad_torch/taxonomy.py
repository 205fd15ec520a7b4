"""Taxonomy engine: NCBI-style taxdump parsing and bitscore-weighted
majority-vote lineage assignment.

Replaces the reference's taxopy dependency (genomad/taxonomy.py:15-108,
taxopy.TaxDb / taxopy.find_majority_vote). Semantics preserved:

  * majority vote: the deepest taxon supported by MORE than ``fraction`` of
    the total bitscore weight (support = sum of weights of genes whose
    lineage contains the taxon); ``agreement`` is that support fraction.
  * Nucleocytoviricota guard: a phylum-level Nucleocytoviricota call with
    agreement < 0.6 in the presence of any Caudoviricetes marker is re-voted
    at fraction 0.6 (genomad/taxonomy.py:61-74).
  * below-family ranks are truncated unless lenient_taxonomy
    (genomad/taxonomy.py:77-100), with agreement recomputed for the
    truncated taxon.

A copy of ``genomad_tpu/taxonomy.py``.
"""

from __future__ import annotations

from collections import defaultdict
from pathlib import Path

from genomad_torch import utils

_DISALLOWED_STRICT_RANKS = {"subfamily", "genus", "subgenus", "species"}


class TaxDb:
    """Parsed nodes.dmp / names.dmp (pipe-delimited taxdump format)."""

    def __init__(self, nodes_dmp: Path, names_dmp: Path):
        self.parent: dict[int, int] = {}
        self.rank: dict[int, str] = {}
        self.taxid2name: dict[int, str] = {}
        for line in utils.read_file(nodes_dmp):
            fields = [f.strip() for f in line.split("|")]
            taxid, parent, rank = int(fields[0]), int(fields[1]), fields[2]
            self.parent[taxid] = parent
            self.rank[taxid] = rank
        for line in utils.read_file(names_dmp):
            fields = [f.strip() for f in line.split("|")]
            if len(fields) > 3 and fields[3] == "scientific name":
                self.taxid2name[int(fields[0])] = fields[1]

    def lineage(self, taxid: int) -> list[int]:
        """taxid -> root path, leaf first (includes the taxid itself)."""
        out = [taxid]
        while self.parent.get(taxid, taxid) != taxid:
            taxid = self.parent[taxid]
            out.append(taxid)
        return out


class Taxon:
    def __init__(self, taxid: int, taxdb: TaxDb):
        self.taxid = taxid
        self._taxdb = taxdb
        self.taxid_lineage = taxdb.lineage(taxid)
        self.agreement = 1.0

    @property
    def rank(self) -> str:
        return self._taxdb.rank.get(self.taxid, "no rank")

    @property
    def name(self) -> str:
        return self._taxdb.taxid2name.get(self.taxid, str(self.taxid))

    @property
    def ranked_taxid_lineage(self) -> list[tuple[str, int]]:
        """(rank, taxid) pairs from leaf to root, skipping 'no rank' nodes."""
        return [
            (self._taxdb.rank.get(t, "no rank"), t)
            for t in self.taxid_lineage
            if self._taxdb.rank.get(t, "no rank") != "no rank"
        ]

    @property
    def rank_taxid_dictionary(self) -> dict[str, int]:
        return {rank: taxid for rank, taxid in reversed(self.ranked_taxid_lineage)}

    @property
    def rank_name_dictionary(self) -> dict[str, str]:
        return {
            rank: self._taxdb.taxid2name.get(taxid, str(taxid))
            for rank, taxid in reversed(self.ranked_taxid_lineage)
        }


def find_majority_vote(taxon_list, taxdb: TaxDb, weights=None, fraction: float = 0.5) -> Taxon:
    """Deepest taxon supported by more than ``fraction`` of the total weight."""
    if weights is None:
        weights = [1.0] * len(taxon_list)
    total = float(sum(weights))
    support: dict[int, float] = defaultdict(float)
    depth: dict[int, int] = {}
    for taxon, weight in zip(taxon_list, weights):
        lineage = taxon.taxid_lineage
        for level, taxid in enumerate(lineage):
            support[taxid] += weight
            depth[taxid] = len(lineage) - level  # root=1, leaf=len
    candidates = [t for t, s in support.items() if s > fraction * total]
    if not candidates:
        # the root is shared by everything; only possible with fraction >= 1
        candidates = [taxon_list[0].taxid_lineage[-1]]
    best = max(candidates, key=lambda t: (depth[t], support[t]))
    majority = Taxon(best, taxdb)
    majority.agreement = support[best] / total
    return majority


def get_conservative_taxon(taxon: Taxon, taxdb: TaxDb) -> Taxon:
    """Walk up the lineage to the first rank at or above family
    (reference: genomad/taxonomy.py:8-12)."""
    for rank, taxid in taxon.ranked_taxid_lineage:
        if rank not in _DISALLOWED_STRICT_RANKS:
            return Taxon(taxid, taxdb)
    return taxon


def write_taxonomic_assignment(
    taxonomy_output,
    genes_output,
    database_obj,
    lenient_taxonomy: bool = False,
    full_ictv_lineage: bool = False,
) -> None:
    """Per-contig taxonomy table (reference: genomad/taxonomy.py:15-108).

    genes_output columns: gene at [0], bitscore at [10], taxid at [14]
    (20-column annotate genes table; see modules/annotate.py).
    """
    if full_ictv_lineage:
        output_ranks = [
            "realm", "subrealm", "kingdom", "subkingdom", "phylum", "subphylum",
            "class", "subclass", "order", "suborder", "family",
        ]
        if lenient_taxonomy:
            output_ranks += ["subfamily", "genus", "subgenus", "species"]
    else:
        output_ranks = ["realm", "kingdom", "phylum", "class", "order", "family"]
        if lenient_taxonomy:
            output_ranks += ["genus", "species"]

    taxdb = database_obj.get_taxdb()
    contig_taxid_dict: dict[str, tuple[list, list]] = defaultdict(lambda: ([], []))
    for line in utils.read_file(genes_output, skip_header=True):
        fields = line.split("\t")
        gene, bitscore, taxid = fields[0], fields[10], fields[14]
        contig = gene.rsplit("_", 1)[0]
        if taxid != "1":
            contig_taxid_dict[contig][0].append(int(taxid))
            contig_taxid_dict[contig][1].append(int(bitscore))

    with open(taxonomy_output, "w") as fout:
        fout.write("seq_name\tn_genes_with_taxonomy\tagreement\ttaxid\tlineage\n")
        for contig, (taxids, bitscores) in contig_taxid_dict.items():
            taxon_list = [Taxon(t, taxdb) for t in taxids]
            if len(taxon_list) > 1:
                majority_taxon = find_majority_vote(taxon_list, taxdb, weights=bitscores, fraction=0.5)
                agreement = majority_taxon.agreement
                # Nucleocytoviricota guard (taxonomy.py:61-74)
                if (
                    majority_taxon.rank_name_dictionary.get("phylum") == "Nucleocytoviricota"
                    and agreement < 0.6
                    and any(
                        t.rank_name_dictionary.get("class") == "Caudoviricetes"
                        for t in taxon_list
                    )
                ):
                    majority_taxon = find_majority_vote(taxon_list, taxdb, weights=bitscores, fraction=0.6)
                    agreement = majority_taxon.agreement
                if not lenient_taxonomy and majority_taxon.rank in _DISALLOWED_STRICT_RANKS:
                    majority_taxon = get_conservative_taxon(majority_taxon, taxdb)
                    agreement = 0.0
                    for t, w in zip(taxon_list, bitscores):
                        if t.rank_taxid_dictionary.get(majority_taxon.rank) == majority_taxon.taxid:
                            agreement += w / sum(bitscores)
            else:
                majority_taxon = taxon_list[0]
                agreement = 1.0
                if not lenient_taxonomy and majority_taxon.rank in _DISALLOWED_STRICT_RANKS:
                    majority_taxon = get_conservative_taxon(majority_taxon, taxdb)
            lineage = [majority_taxon.rank_name_dictionary.get(r, "") for r in output_ranks]
            lineage = ";".join(["Viruses"] + lineage)
            fout.write(
                f"{contig}\t{len(taxon_list)}\t{agreement:.4f}\t{majority_taxon.taxid}\t{lineage}\n"
            )
