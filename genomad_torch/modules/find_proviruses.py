"""find-proviruses module: provirus demarcation, boundary refinement, excision.

Contract parity with genomad/modules/find_proviruses.py:15-827:

  * target contigs = those carrying >= 1 chromosome and >= 1 virus marker;
  * per-gene provirus scores from the 2-state CRF (genomad_tpu.models.crf);
  * RLE island smoothing with the reference's size/marker thresholds
    (find_proviruses.py:152-226);
  * boundary extension to reciprocal-nearest integrases (<= 10 kb) and
    tRNAs (<= 5 kb), blocked by intervening chromosome markers
    (find_proviruses.py:229-333);
  * provirus acceptance by summed v-vs-c score (12 plain / 8 integrase /
    8 edge — cli.py:565-590);
  * excised FASTA/protein/gene outputs and provirus taxonomy.

The integrase search runs the port's marker search
(``modules.annotate.run_search``) at sensitivity 8.2 against the integrase
profile DB: that DB holds at most 256 profiles, so it takes the all-pairs
path and kernel K1 (forward and reverse) on ``device``. The CRF runs on
``device`` too; the tRNA scan is the host detector (genomad_torch.ops.trna).

Port of ``genomad_tpu/modules/find_proviruses.py``: the gene tables,
island, edge and acceptance logic and every output file are the JAX
module's. Everything runs on ``device`` (None = the card; raises without
one, before anything is written); ``mesh`` goes to the integrase search, as
in the JAX module. Spans (``genomad_torch.trace``): ``module.find_proviruses``
around ``fp.integrase_search``, ``fp.trna``, ``fp.crf`` (through the scores'
copy to the host) and ``fp.tables`` (the provirus tables, sequences and
taxonomy).
"""

from __future__ import annotations

import sys
from collections import OrderedDict, defaultdict
from dataclasses import dataclass, field
from pathlib import Path
from typing import List, Optional

import numpy as np

from genomad_torch import database, sequence, taxonomy, trace, utils
from genomad_torch.device import resolve_device
from genomad_torch.models import crf
from genomad_torch.ops import trna as trna_lib
from genomad_torch.paths import GenomadOutputs


@dataclass
class GeneTable:
    seq_name: str
    starts: List[int] = field(default_factory=list)
    ends: List[int] = field(default_factory=list)
    spm_c: List[float] = field(default_factory=list)
    spm_v: List[float] = field(default_factory=list)
    v_vs_c_score: List[float] = field(default_factory=list)
    c_markers: List[bool] = field(default_factory=list)
    v_markers: List[bool] = field(default_factory=list)
    integrases: List[bool] = field(default_factory=list)
    trna_starts: List[int] = field(default_factory=list)
    trna_ends: List[int] = field(default_factory=list)

    @property
    def n_genes(self) -> int:
        return len(self.starts)

    @property
    def n_c_markers(self) -> int:
        return sum(self.c_markers)

    @property
    def n_v_markers(self) -> int:
        return sum(self.v_markers)

    @property
    def integrase_starts(self) -> List[int]:
        return [s for s, i in zip(self.starts, self.integrases) if i]

    @property
    def integrase_ends(self) -> List[int]:
        return [e for e, i in zip(self.ends, self.integrases) if i]


@dataclass
class Provirus:
    seq_name: str
    start: int
    end: int
    n_genes: int
    v_vs_c_score: float
    has_integrase: bool
    integrase_indices: List[int]
    is_edge: bool

    @property
    def provirus_name(self) -> str:
        return f"{self.seq_name}|provirus_{self.start}_{self.end}"


def yield_gene_tables(genes_output, database_obj, integrase_output=None, aragorn_output=None):
    """Stream per-contig gene tables from the annotate genes TSV
    (reference: find_proviruses.py:91-149)."""
    marker_features = database_obj.get_marker_features()
    integrase_genes = set()
    if integrase_output is not None and Path(integrase_output).exists():
        for line in utils.read_file(integrase_output):
            integrase_genes.add(line.strip().split("\t")[0].split()[0])
    trna_dict = defaultdict(lambda: ([], []))
    if aragorn_output is not None and Path(aragorn_output).exists():
        for line in utils.read_file(aragorn_output):
            name, start, end = line.strip().split("\t")
            contig = name.rsplit("_", 2)[0]
            trna_dict[contig][0].append(int(start))
            trna_dict[contig][1].append(int(end))
    current: Optional[GeneTable] = None
    for line in utils.read_file(genes_output, skip_header=True):
        fields = line.strip("\n").split("\t")
        gene, start, end, match = fields[0], int(fields[1]), int(fields[2]), fields[8]
        spec_class, spm_c, _, spm_v, *_ = marker_features.get(match, (None, 0.0, 0.0, 0.0, 0))
        contig = gene.rsplit("_", 1)[0]
        if current is None or contig != current.seq_name:
            if current is not None:
                yield current
            current = GeneTable(contig)
            current.trna_starts, current.trna_ends = trna_dict[contig]
        current.starts.append(start)
        current.ends.append(end)
        current.spm_c.append(spm_c)
        current.spm_v.append(spm_v)
        current.v_vs_c_score.append(float(np.exp(spm_v) - np.exp(spm_c)))
        current.c_markers.append(bool(spec_class) and spec_class.startswith("C"))
        current.v_markers.append(bool(spec_class) and spec_class.startswith("V"))
        current.integrases.append(gene in integrase_genes)
    if current is not None:
        yield current


def tag_provirus_genes(
    provirus_scores,
    threshold,
    genetable: GeneTable,
    min_markers_host_island=2,
    min_markers_host_edge=1,
    min_genes_host_island=6,
    min_genes_host_edge=4,
    min_markers_phage_island=1,
    min_markers_phage_edge=1,
    min_genes_phage_island=5,
    min_genes_phage_edge=3,
):
    """Threshold CRF scores and absorb small islands
    (reference: find_proviruses.py:152-226). Returns 0/1 labels per gene."""
    labels = (np.asarray(provirus_scores) >= threshold).astype(int).tolist()

    def absorb(labels, target_value, min_genes_island, min_markers_island, min_genes_edge, min_markers_edge):
        counts, values = utils.rle_encode(labels)
        offset = 0
        for i, (count, value) in enumerate(zip(counts, values)):
            if value == target_value:
                spm_c = np.array(genetable.spm_c[offset : offset + count])
                spm_v = np.array(genetable.spm_v[offset : offset + count])
                n_c = int((spm_c > spm_v).sum())
                n_v = int((spm_v > spm_c).sum())
                if target_value == 0:
                    n_own, n_other = n_c, n_v
                else:
                    n_own, n_other = n_v, n_c
                in_edge = i == 0 or i == len(counts) - 1
                if in_edge:
                    flip = count < min_genes_edge or n_own < min_markers_edge or n_own <= n_other
                else:
                    flip = count < min_genes_island or n_own < min_markers_island or n_own <= n_other
                if flip:
                    values[i] = 1 - target_value
            offset += count
        return utils.rle_decode(counts, values)

    # Convert small host regions to phage, then small phage regions to host
    labels = absorb(labels, 0, min_genes_host_island, min_markers_host_island, min_genes_host_edge, min_markers_host_edge)
    labels = absorb(labels, 1, min_genes_phage_island, min_markers_phage_island, min_genes_phage_edge, min_markers_phage_edge)
    return labels


def extend_provirus_edges(provirus_labels, genetable: GeneTable, feature_type: str, max_dist: int):
    """Extend provirus boundaries toward reciprocal-nearest integrases/tRNAs
    (reference: find_proviruses.py:229-333)."""
    if feature_type == "integrase":
        features = list(zip(genetable.integrase_starts, genetable.integrase_ends))
    elif feature_type == "trna":
        features = list(zip(genetable.trna_starts, genetable.trna_ends))
    else:
        return provirus_labels
    if len(set(provirus_labels)) <= 1 or not features:
        return provirus_labels
    counts, values = utils.rle_encode(provirus_labels)
    provirus_coordinates = []
    offset = 0
    for count, value in zip(counts, values):
        if value == 1:
            provirus_coordinates.append(
                [genetable.starts[offset], genetable.ends[offset + count - 1]]
            )
        offset += count
    if not provirus_coordinates:
        return provirus_labels
    chromosome_markers = [
        (s, e)
        for s, e, is_c in zip(genetable.starts, genetable.ends, genetable.c_markers)
        if is_c
    ]
    # signed distances feature -> provirus (+ right of, - left of, 0 overlap)
    distances = []
    for f_start, f_end in features:
        row = []
        for p_start, p_end in provirus_coordinates:
            if f_start > p_end:
                row.append(f_end - p_end)
            elif f_end < p_start:
                row.append(f_start - p_start)
            else:
                row.append(0)
        distances.append(row)
    closest_provirus = [min(range(len(row)), key=lambda i: abs(row[i])) for row in distances]
    closest_feature = [
        min(range(len(features)), key=lambda fi: abs(distances[fi][pi]))
        for pi in range(len(provirus_coordinates))
    ]
    modified = False
    for fi, pi in enumerate(closest_provirus):
        distance = distances[fi][pi]
        if abs(distance) > max_dist or closest_feature[pi] != fi:
            continue
        if distance > 0 and not any(
            ms >= provirus_coordinates[pi][1] and me <= provirus_coordinates[pi][1] + distance
            for ms, me in chromosome_markers
        ):
            provirus_coordinates[pi][1] += distance
            modified = True
        elif distance < 0 and not any(
            me <= provirus_coordinates[pi][0] and ms >= provirus_coordinates[pi][0] + distance
            for ms, me in chromosome_markers
        ):
            provirus_coordinates[pi][0] += distance
            modified = True
    if not modified:
        return provirus_labels
    return [
        int(
            any(
                g_start >= p_start and g_end <= p_end
                for p_start, p_end in provirus_coordinates
            )
        )
        for g_start, g_end in zip(genetable.starts, genetable.ends)
    ]


def yield_proviruses(genetable: GeneTable, provirus_labels, threshold, in_edge_threshold, has_integrase_threshold):
    """Accept provirus islands by summed v-vs-c score
    (reference: find_proviruses.py:336-377)."""
    counts, values = utils.rle_encode(provirus_labels)
    n_islands = len(counts)
    offset = 0
    for i, (count, value) in enumerate(zip(counts, values)):
        if value == 1:
            v_vs_c = float(sum(genetable.v_vs_c_score[offset : offset + count]))
            has_integrase = any(genetable.integrases[offset : offset + count])
            in_edge = i in (0, n_islands - 1)
            if (
                (in_edge and v_vs_c >= in_edge_threshold)
                or (has_integrase and v_vs_c >= has_integrase_threshold)
                or (not in_edge and not has_integrase and v_vs_c >= threshold)
            ):
                integrase_indices = [
                    offset + k
                    for k in range(count)
                    if genetable.integrases[offset + k]
                ]
                yield Provirus(
                    genetable.seq_name,
                    genetable.starts[offset],
                    genetable.ends[offset + count - 1],
                    count,
                    v_vs_c,
                    has_integrase,
                    integrase_indices,
                    in_edge,
                )
        offset += count


@trace.spanned("module.find_proviruses")
def main(
    input_path,
    output_path,
    database_path,
    cleanup=False,
    restart=False,
    skip_integrase_identification=False,
    skip_trna_identification=False,
    threads=None,
    verbose=True,
    lenient_taxonomy=False,
    full_ictv_lineage=False,
    crf_threshold=0.4,
    marker_threshold=12.0,
    marker_threshold_integrase=8.0,
    marker_threshold_edge=8.0,
    max_integrase_distance=10_000,
    max_trna_distance=5_000,
    sensitivity=8.2,
    evalue=1e-3,
    device=None,
    mesh=None,
):
    device = resolve_device(device)
    input_path, output_path = Path(input_path), Path(output_path)
    output_path.mkdir(exist_ok=True)
    prefix = utils.output_prefix(input_path)
    outputs = GenomadOutputs(prefix, output_path)
    console = utils.Console(outputs.find_proviruses_log, verbose)
    parameter_dict = {
        "skip_integrase_identification": skip_integrase_identification,
        "skip_trna_identification": skip_trna_identification,
        "crf_threshold": crf_threshold,
        "marker_threshold": marker_threshold,
        "marker_threshold_integrase": marker_threshold_integrase,
        "marker_threshold_edge": marker_threshold_edge,
        "max_integrase_distance": max_integrase_distance,
        "max_trna_distance": max_trna_distance,
        "sensitivity": sensitivity,
        "evalue": evalue,
    }

    output_files = [
        outputs.find_proviruses_execution_info,
        outputs.find_proviruses_output,
        outputs.find_proviruses_nucleotide_output,
        outputs.find_proviruses_proteins_output,
        outputs.find_proviruses_genes_output,
        outputs.find_proviruses_taxonomy_output,
    ]
    descriptions = [
        "execution parameters",
        "provirus data",
        "provirus nucleotide sequences",
        "provirus protein sequences",
        "provirus gene annotation data",
        "provirus taxonomic assignment",
    ]
    if not skip_integrase_identification:
        output_files.append(outputs.find_proviruses_mmseqs2_output)
        descriptions.append("integrase search output file")
    if not skip_trna_identification:
        output_files.append(outputs.find_proviruses_aragorn_output)
        descriptions.append("tRNA search output file")
    utils.display_header(
        console,
        "find-proviruses",
        "This will find putative proviral regions within the input sequences.",
        outputs.find_proviruses_dir,
        output_files,
        descriptions,
    )

    if not outputs.annotate_genes_output.exists() or not outputs.annotate_proteins_output.exists():
        console.error(
            f"{outputs.annotate_genes_output.name} and "
            f"{outputs.annotate_proteins_output.name} were not found. Please "
            "execute the annotate module to generate them."
        )
        sys.exit(1)
    if not utils.compare_executions(input_path, {}, outputs.annotate_execution_info, only_md5=True):
        console.error("The input FASTA file is different from the one used in the annotate module.")
        sys.exit(1)
    if not sequence.check_fasta(input_path):
        console.error(f"{input_path} is either empty or contains duplicate identifiers.")
        sys.exit(1)

    skip = False
    if (
        outputs.find_proviruses_execution_info.exists()
        and any(p.exists() for p in output_files)
        and not restart
    ):
        if utils.compare_executions(input_path, parameter_dict, outputs.find_proviruses_execution_info):
            skip = True
            console.log("Previous execution detected. Steps will be skipped unless their outputs are not found.")

    outputs.find_proviruses_dir.mkdir(exist_ok=True)
    utils.write_execution_info(
        "find-proviruses", input_path, parameter_dict, outputs.find_proviruses_execution_info
    )

    database_obj = database.Database(database_path)

    # Target contigs: >= 1 C and >= 1 V marker (find_proviruses.py:550-561)
    target_contigs = {
        gt.seq_name
        for gt in yield_gene_tables(outputs.annotate_genes_output, database_obj)
        if gt.n_c_markers and gt.n_v_markers
    }

    if not target_contigs:
        console.log("No potential provirus-carrying sequences were identified.")
        for f in output_files:
            if f != outputs.find_proviruses_execution_info:
                open(f, "w").close()
        with open(outputs.find_proviruses_output, "w") as fout:
            fout.write(
                "seq_name\tsource_seq\tstart\tend\tlength\tn_genes\t"
                "v_vs_c_score\tin_seq_edge\tintegrases\n"
            )
        with open(outputs.find_proviruses_genes_output, "w") as fout:
            fout.write(
                "gene\tstart\tend\tlength\tstrand\tgc_content\tgenetic_code\trbs_motif\t"
                "marker\tevalue\tbitscore\tuscg\tannotation_accessions\tannotation_description\n"
            )
        console.log("genomad-torch find-proviruses finished!", style="yellow")
        return

    # Integrase search (find_proviruses.py:588-617)
    if skip and outputs.find_proviruses_mmseqs2_output.exists():
        console.log("Skipping integrase search (previous output found).")
    elif not skip_integrase_identification:
        from genomad_torch.modules import annotate as annotate_mod

        with trace.span("fp.integrase_search"):
            sequence.filter_fasta(
                outputs.annotate_proteins_output,
                outputs.find_proviruses_mmseqs2_input,
                target_contigs,
                ignore_gene_suffix=True,
            )
            annotate_mod.run_search(
                outputs.find_proviruses_mmseqs2_input,
                outputs.find_proviruses_mmseqs2_output,
                database_obj,
                use_integrase_db=True,
                sensitivity=sensitivity,
                evalue=evalue,
                device=device,
                threads=threads,
                mesh=mesh,
            )
        console.log(f"Integrases written to {outputs.find_proviruses_mmseqs2_output.name}.")

    # tRNA search (find_proviruses.py:629-655)
    if skip and outputs.find_proviruses_aragorn_output.exists():
        console.log("Skipping tRNA identification (previous output found).")
    elif not skip_trna_identification:
        with trace.span("fp.trna"):
            sequence.filter_fasta(input_path, outputs.find_proviruses_aragorn_input, target_contigs)
            trna_lib.Aragorn(
                outputs.find_proviruses_aragorn_input, outputs.find_proviruses_aragorn_output
            ).run_parallel_aragorn(threads)
        console.log(f"tRNAs written to {outputs.find_proviruses_aragorn_output.name}.")

    # CRF tagging + island logic (find_proviruses.py:657-695)
    provirus_dict = OrderedDict()
    gene_tables = [
        gt
        for gt in yield_gene_tables(
            outputs.annotate_genes_output,
            database_obj,
            None if skip_integrase_identification else outputs.find_proviruses_mmseqs2_output,
            None if skip_trna_identification else outputs.find_proviruses_aragorn_output,
        )
        if gt.seq_name in target_contigs
    ]
    with trace.span("fp.crf"):
        all_scores = crf.score_provirus_genes_batch(
            [gt.spm_v for gt in gene_tables], [gt.spm_c for gt in gene_tables], device=device
        )
    for genetable, scores in zip(gene_tables, all_scores):
        labels = tag_provirus_genes(scores, crf_threshold, genetable)
        if not skip_integrase_identification:
            labels = extend_provirus_edges(labels, genetable, "integrase", max_integrase_distance)
        if not skip_trna_identification:
            labels = extend_provirus_edges(labels, genetable, "trna", max_trna_distance)
        if len(set(labels)) > 1:
            provirus_dict[genetable.seq_name] = list(
                yield_proviruses(
                    genetable,
                    labels,
                    threshold=marker_threshold,
                    in_edge_threshold=marker_threshold_edge,
                    has_integrase_threshold=marker_threshold_integrase,
                )
            )
    console.log("Provirus regions identified.")

    with trace.span("fp.tables"):
        # provirus.tsv (find_proviruses.py:697-729)
        with open(outputs.find_proviruses_output, "w") as fout:
            fout.write(
                "seq_name\tsource_seq\tstart\tend\tlength\tn_genes\t"
                "v_vs_c_score\tin_seq_edge\tintegrases\n"
            )
            for proviruses in provirus_dict.values():
                for p in proviruses:
                    integrase_genes = (
                        ";".join(f"{p.provirus_name}_{i + 1}" for i in p.integrase_indices)
                        if p.has_integrase
                        else "NA"
                    )
                    fout.write(
                        f"{p.provirus_name}\t{p.seq_name}\t{p.start}\t{p.end}\t"
                        f"{p.end - p.start + 1}\t{p.n_genes}\t{p.v_vs_c_score:.4f}\t"
                        f"{p.is_edge}\t{integrase_genes}\n"
                    )

        # excised nucleotide sequences (find_proviruses.py:731-746)
        with open(outputs.find_proviruses_nucleotide_output, "w") as fout:
            for seq in sequence.read_fasta(input_path):
                for p in provirus_dict.get(seq.accession, []):
                    fout.write(str(sequence.Sequence(p.provirus_name, seq.seq[p.start - 1 : p.end])))

        # provirus proteins (find_proviruses.py:748-775)
        with open(outputs.find_proviruses_proteins_output, "w") as fout:
            for seq in sequence.read_fasta(outputs.annotate_proteins_output):
                contig = seq.accession.rsplit("_", 1)[0]
                if contig not in provirus_dict:
                    continue
                start = int(seq.header.split()[2])
                end = int(seq.header.split()[4])
                for p in provirus_dict[contig]:
                    if start >= p.start and end <= p.end:
                        gene_number = seq.accession.rsplit("_", 1)[1]
                        header = f"{p.provirus_name}_{gene_number} {seq.header.split(maxsplit=1)[1]}"
                        fout.write(str(sequence.Sequence(header, seq.seq)))
                        break

        # provirus genes table (find_proviruses.py:777-810). NOTE: the header
        # has 16 columns but data rows carry the full 20 columns of the
        # annotate table with the gene renamed — reference behavior preserved
        # because taxonomy parses fields from fixed positions.
        with open(outputs.find_proviruses_genes_output, "w") as fout:
            fout.write(
                "gene\tstart\tend\tlength\tstrand\tgc_content\tgenetic_code\trbs_motif\t"
                "marker\tevalue\tbitscore\tuscg\ttaxid\ttaxname\tannotation_accessions\t"
                "annotation_description\n"
            )
            for line in utils.read_file(outputs.annotate_genes_output, skip_header=True):
                fields = line.strip("\n").split("\t")
                contig = fields[0].rsplit("_", 1)[0]
                if contig not in provirus_dict:
                    continue
                start, end = int(fields[1]), int(fields[2])
                for p in provirus_dict[contig]:
                    if start >= p.start and end <= p.end:
                        gene_number = fields[0].rsplit("_", 1)[1]
                        fout.write(f"{p.provirus_name}_{gene_number}\t" + "\t".join(fields[1:]) + "\n")
                        break

        # provirus taxonomy (find_proviruses.py:812-825)
        taxonomy.write_taxonomic_assignment(
            outputs.find_proviruses_taxonomy_output,
            outputs.find_proviruses_genes_output,
            database_obj,
            lenient_taxonomy=lenient_taxonomy,
            full_ictv_lineage=full_ictv_lineage,
        )

    if cleanup:
        for f in (outputs.find_proviruses_mmseqs2_input, outputs.find_proviruses_aragorn_input):
            if f.exists():
                f.unlink()

    console.log("genomad-torch find-proviruses finished!", style="yellow")
