"""summary module: post-classification filtering and final reports.

Contract parity with genomad/modules/summary.py:11-706: classifier priority
ladder (calibrated_aggregated > aggregated > calibrated_marker > marker >
calibrated_nn > nn), ranked score filtering with gene-based criteria (skipped
when annotate was not run), provirus-vs-parent dedup, FDR cut for calibrated
scores, DTR/ITR/Provirus topology labels, and the virus/plasmid FASTA,
protein, gene, and summary tables.

A copy of ``genomad_tpu/modules/summary.py`` (numpy); the files it writes
are the JAX module's.
"""

from __future__ import annotations

import itertools
import sys
from collections import defaultdict
from pathlib import Path

import numpy as np

from genomad_torch import sequence, trace, utils
from genomad_torch.paths import GenomadOutputs


def get_fdr_array(probability_array):
    """Cumulative FDR down a ranked score list (reference: summary.py:11-18)."""
    p = np.asarray(probability_array, dtype=np.float64)
    if not len(p):
        return np.array([])
    return np.cumsum(1 - p) / np.arange(1, len(p) + 1)


def flag_sequences(
    contig_name_array,
    contig_score_array,
    length_dict,
    class_index,
    min_score,
    max_fdr,
    min_number_genes,
    min_marker_enrichment,
    min_hallmarks,
    min_hallmarks_short,
    max_uscg,
    n_genes_dict,
    filters_dict,
    annotate_exec,
    provirus_name_array=None,
    provirus_score_array=None,
    max_length_short_seq=2_500,
):
    """Rank sequences by class score and apply the filter battery
    (reference: summary.py:21-104)."""
    if (
        provirus_name_array is not None
        and provirus_score_array is not None
        and len(provirus_name_array)
        and len(provirus_score_array)
    ):
        name_array = np.concatenate([contig_name_array, provirus_name_array])
        score_array = np.concatenate([contig_score_array, provirus_score_array])
        provirus_name_set = set(provirus_name_array)
    else:
        name_array = contig_name_array
        score_array = contig_score_array
        provirus_name_set = set()
    length_array = np.array([length_dict[n] for n in name_array])
    selected_names, selected_scores = [], []
    added_contigs, added_proviruses = set(), set()
    for i in score_array[:, class_index].argsort()[::-1]:
        n_genes = n_genes_dict.get(name_array[i], 0)
        n_uscg, marker_enrichment, n_hallmarks = filters_dict.get(
            name_array[i], (0, np.zeros(3), (0, 0))
        )
        marker_enrichment = marker_enrichment[class_index]
        n_hallmarks = n_hallmarks[class_index - 1]
        passes = score_array[i].argmax() == class_index and score_array[i, class_index] >= min_score
        if annotate_exec:
            passes = (
                passes
                and n_genes >= min_number_genes
                and marker_enrichment >= min_marker_enrichment
                and (
                    n_hallmarks >= min_hallmarks
                    if length_array[i] >= max_length_short_seq
                    else n_hallmarks >= min_hallmarks_short
                )
                and n_uscg <= max_uscg
            )
        if not passes:
            continue
        # Provirus-vs-parent dedup (summary.py:81-92): a provirus and its
        # source contig never both appear in the output.
        if name_array[i] in provirus_name_set:
            contig_name = name_array[i].rsplit("|", 1)[0]
            if contig_name not in added_contigs:
                selected_names.append(name_array[i])
                selected_scores.append(score_array[i, class_index])
                added_proviruses.add(contig_name)
        else:
            if name_array[i] not in added_proviruses:
                selected_names.append(name_array[i])
                selected_scores.append(score_array[i, class_index])
                added_contigs.add(name_array[i])
    if max_fdr is None:
        return np.array(selected_names), np.array(selected_scores), np.array([])
    fdr_array = get_fdr_array(selected_scores)
    keep = fdr_array <= max_fdr
    return np.array(selected_names)[keep], np.array(selected_scores)[keep], fdr_array[keep]


@trace.spanned("module.summary")
def main(
    input_path,
    output_path,
    verbose=True,
    min_score=0.7,
    max_fdr=0.1,
    min_number_genes=1,
    min_plasmid_marker_enrichment=0.1,
    min_virus_marker_enrichment=0.0,
    min_plasmid_hallmarks=0,
    min_plasmid_hallmarks_short_seqs=1,
    min_virus_hallmarks=0,
    min_virus_hallmarks_short_seqs=1,
    max_uscg=4,
):
    input_path, output_path = Path(input_path), Path(output_path)
    output_path.mkdir(exist_ok=True)
    prefix = utils.output_prefix(input_path)
    outputs = GenomadOutputs(prefix, output_path)
    console = utils.Console(outputs.summary_log, verbose)
    parameter_dict = {
        "min_score": min_score,
        "max_fdr": max_fdr,
        "min_number_genes": min_number_genes,
        "min_plasmid_hallmarks": min_plasmid_hallmarks,
        "min_plasmid_hallmarks_short_seqs": min_plasmid_hallmarks_short_seqs,
        "min_virus_hallmarks": min_virus_hallmarks,
        "min_virus_hallmarks_short_seqs": min_virus_hallmarks_short_seqs,
        "min_plasmid_marker_enrichment": min_plasmid_marker_enrichment,
        "min_virus_marker_enrichment": min_virus_marker_enrichment,
        "max_uscg": max_uscg,
    }

    # Which upstream modules ran? (reference: summary.py:146-211)
    annotate_exec = all(
        p.exists()
        for p in (
            outputs.annotate_execution_info,
            outputs.annotate_proteins_output,
            outputs.annotate_genes_output,
            outputs.annotate_taxonomy_output,
        )
    )
    marker_exec = all(
        p.exists()
        for p in (
            outputs.marker_classification_execution_info,
            outputs.marker_classification_npz_output,
            outputs.features_npz_output,
        )
    )
    nn_exec = all(
        p.exists()
        for p in (outputs.nn_classification_execution_info, outputs.nn_classification_npz_output)
    )
    aggregated_exec = all(
        p.exists()
        for p in (
            outputs.aggregated_classification_execution_info,
            outputs.aggregated_classification_npz_output,
        )
    )
    find_proviruses_exec = all(
        p.exists()
        for p in (
            outputs.find_proviruses_execution_info,
            outputs.find_proviruses_output,
            outputs.find_proviruses_nucleotide_output,
            outputs.find_proviruses_proteins_output,
            outputs.find_proviruses_genes_output,
        )
    )
    calib_exists = outputs.score_calibration_execution_info.exists()
    calib_marker_exec = calib_exists and outputs.calibrated_marker_classification_npz_output.exists()
    calib_nn_exec = calib_exists and outputs.calibrated_nn_classification_npz_output.exists()
    calib_aggregated_exec = calib_exists and outputs.calibrated_aggregated_classification_npz_output.exists()

    def provirus_variant(base_exec, npz):
        return base_exec and find_proviruses_exec and npz.exists()

    # Classifier priority ladder (reference: summary.py:214-265)
    ladder = [
        (
            "calibrated_aggregated",
            calib_aggregated_exec,
            outputs.calibrated_aggregated_classification_npz_output,
            outputs.provirus_calibrated_aggregated_classification_npz_output,
        ),
        (
            "aggregated",
            aggregated_exec,
            outputs.aggregated_classification_npz_output,
            outputs.provirus_aggregated_classification_npz_output,
        ),
        (
            "calibrated_marker",
            calib_marker_exec,
            outputs.calibrated_marker_classification_npz_output,
            outputs.provirus_calibrated_marker_classification_npz_output,
        ),
        (
            "marker",
            marker_exec,
            outputs.marker_classification_npz_output,
            outputs.provirus_marker_classification_npz_output,
        ),
        (
            "calibrated_nn",
            calib_nn_exec,
            outputs.calibrated_nn_classification_npz_output,
            outputs.provirus_calibrated_nn_classification_npz_output,
        ),
        ("nn", nn_exec, outputs.nn_classification_npz_output, outputs.provirus_nn_classification_npz_output),
    ]
    for selected_classifier, ok, contig_npz, provirus_npz in ladder:
        if ok:
            break
    else:
        console.error(
            "No previous execution of the marker-classification, "
            "nn-classification, aggregated-classification, or "
            "score-calibration were detected. Please execute at least one of "
            "these modules."
        )
        sys.exit(1)
    include_provirus = provirus_variant(True, provirus_npz)

    output_files = [
        outputs.summary_execution_info,
        outputs.summary_virus_output,
        outputs.summary_plasmid_output,
        outputs.summary_virus_sequences_output,
        outputs.summary_plasmid_sequences_output,
    ]
    descriptions = [
        "execution parameters",
        "virus classification summary",
        "plasmid classification summary",
        "virus nucleotide FASTA file",
        "plasmid nucleotide FASTA file",
    ]
    if annotate_exec:
        output_files += [
            outputs.summary_virus_proteins_output,
            outputs.summary_plasmid_proteins_output,
            outputs.summary_virus_genes_output,
            outputs.summary_plasmid_genes_output,
        ]
        descriptions += [
            "virus protein FASTA file",
            "plasmid protein FASTA file",
            "virus gene annotation data",
            "plasmid gene annotation data",
        ]
    utils.display_header(
        console,
        "summary",
        "This will summarize the results across modules into a classification report.",
        outputs.summary_dir,
        output_files,
        descriptions,
    )

    # Same-input verification (reference: summary.py:310-346)
    md5_list = [utils.get_md5(input_path)]
    for ok, info in (
        (find_proviruses_exec, outputs.find_proviruses_execution_info),
        (marker_exec, outputs.marker_classification_execution_info),
        (nn_exec, outputs.nn_classification_execution_info),
        (aggregated_exec, outputs.aggregated_classification_execution_info),
        (calib_marker_exec or calib_nn_exec or calib_aggregated_exec, outputs.score_calibration_execution_info),
    ):
        if ok:
            md5_list.append(utils.get_execution_info(info)[0])
    if len(set(md5_list)) > 1:
        console.error("Different input FASTA files were used as input for the different modules.")
        sys.exit(1)

    outputs.summary_dir.mkdir(exist_ok=True)
    utils.write_execution_info("summary", input_path, parameter_dict, outputs.summary_execution_info)
    console.log(f"Using scores from {selected_classifier}.")
    if selected_classifier == "nn":
        console.log("Gene-based filters will not be applied.")

    # Gene/USCG/enrichment lookups (reference: summary.py:395-424)
    n_genes_dict, genetic_code_dict, filters_dict = {}, {}, {}
    if marker_exec:
        feats = np.load(outputs.features_npz_output)
        for k, v1, v2, v3, v4, v5 in zip(
            feats["contig_names"],
            feats["contig_n_uscg"],
            feats["contig_n_genes"],
            feats["contig_genetic_code"],
            feats["contig_marker_enrichment"],
            feats["contig_n_hallmarks"],
        ):
            n_genes_dict[k] = v2
            genetic_code_dict[k] = v3
            filters_dict[k] = (v1, v4, v5)
        if include_provirus and outputs.provirus_features_npz_output.exists():
            pfeats = np.load(outputs.provirus_features_npz_output)
            for k, v1, v2, v3, v4, v5 in zip(
                pfeats["provirus_names"],
                pfeats["provirus_n_uscg"],
                pfeats["provirus_n_genes"],
                pfeats["provirus_genetic_code"],
                pfeats["provirus_marker_enrichment"],
                pfeats["provirus_n_hallmarks"],
            ):
                n_genes_dict[k] = v2
                genetic_code_dict[k] = v3
                filters_dict[k] = (v1, v4, v5)

    contig_npz_data = np.load(contig_npz)
    contig_names = contig_npz_data["contig_names"]
    contig_predictions = contig_npz_data["predictions"]
    if include_provirus:
        provirus_npz_data = np.load(provirus_npz)
        provirus_names = provirus_npz_data["provirus_names"]
        provirus_predictions = provirus_npz_data["predictions"]
    else:
        provirus_names = np.array([])
        provirus_predictions = np.array([])

    # Sequence lengths
    length_dict = {seq.accession: len(seq) for seq in sequence.read_fasta(input_path)}
    if include_provirus:
        for seq in sequence.read_fasta(outputs.find_proviruses_nucleotide_output):
            length_dict[seq.accession] = len(seq)

    # FDR only applies to calibrated probabilities (summary.py:452-453)
    if not selected_classifier.startswith("calibrated"):
        max_fdr = None
    plasmid_names, plasmid_scores, plasmid_fdr = flag_sequences(
        contig_names,
        contig_predictions,
        length_dict,
        1,
        min_score,
        max_fdr,
        min_number_genes,
        min_plasmid_marker_enrichment,
        min_plasmid_hallmarks,
        min_plasmid_hallmarks_short_seqs,
        max_uscg,
        n_genes_dict,
        filters_dict,
        annotate_exec,
    )
    virus_names, virus_scores, virus_fdr = flag_sequences(
        contig_names,
        contig_predictions,
        length_dict,
        2,
        min_score,
        max_fdr,
        min_number_genes,
        min_virus_marker_enrichment,
        min_virus_hallmarks,
        min_virus_hallmarks_short_seqs,
        max_uscg,
        n_genes_dict,
        filters_dict,
        annotate_exec,
        provirus_name_array=provirus_names,
        provirus_score_array=provirus_predictions,
    )
    plasmid_name_set, virus_name_set = set(plasmid_names), set(virus_names)
    console.log(
        f"{len(plasmid_names):,} plasmid(s) and {len(virus_names):,} virus(es) were identified."
    )

    # Nucleotide FASTAs + topology labels (summary.py:495-529)
    terminal_repeat_dict = {}
    with (
        open(outputs.summary_plasmid_sequences_output, "w") as fout_p,
        open(outputs.summary_virus_sequences_output, "w") as fout_v,
    ):
        for seq in sequence.read_fasta(input_path):
            if seq.accession in plasmid_name_set or seq.accession in virus_name_set:
                if seq.has_dtr():
                    terminal_repeat_dict[seq.accession] = "DTR"
                elif seq.has_itr():
                    terminal_repeat_dict[seq.accession] = "ITR"
                else:
                    terminal_repeat_dict[seq.accession] = "No terminal repeats"
                (fout_p if seq.accession in plasmid_name_set else fout_v).write(str(seq))
        if include_provirus:
            for seq in sequence.read_fasta(outputs.find_proviruses_nucleotide_output):
                if seq.accession in virus_name_set:
                    terminal_repeat_dict[seq.accession] = "Provirus"
                    fout_v.write(str(seq))

    conjscan_genes_dict = defaultdict(list)
    amr_genes_dict = defaultdict(list)
    if annotate_exec:
        # Protein FASTAs (summary.py:531-552)
        with (
            open(outputs.summary_plasmid_proteins_output, "w") as fout_p,
            open(outputs.summary_virus_proteins_output, "w") as fout_v,
        ):
            for seq in sequence.read_fasta(outputs.annotate_proteins_output):
                contig = seq.accession.rsplit("_", 1)[0]
                if contig in plasmid_name_set:
                    fout_p.write(str(seq))
                elif contig in virus_name_set:
                    fout_v.write(str(seq))
            if include_provirus:
                for seq in sequence.read_fasta(outputs.find_proviruses_proteins_output):
                    if seq.accession.rsplit("_", 1)[0] in virus_name_set:
                        fout_v.write(str(seq))

        # Gene tables + CONJscan/AMR gene lists (summary.py:554-593)
        gene_header = (
            "gene\tstart\tend\tlength\tstrand\tgc_content\tgenetic_code\trbs_motif\tmarker\t"
            "evalue\tbitscore\tuscg\tplasmid_hallmark\tvirus_hallmark\ttaxid\ttaxname\t"
            "annotation_conjscan\tannotation_amr\tannotation_accessions\tannotation_description\n"
        )
        with (
            open(outputs.summary_plasmid_genes_output, "w") as fout_p,
            open(outputs.summary_virus_genes_output, "w") as fout_v,
        ):
            fout_p.write(gene_header)
            fout_v.write(gene_header)
            for line in utils.read_file(outputs.annotate_genes_output, skip_header=True):
                fields = line.split("\t")
                seq_name = fields[0].rsplit("_", 1)[0]
                if seq_name in plasmid_name_set:
                    fout_p.write(line)
                    if fields[16] != "NA":
                        conjscan_genes_dict[seq_name].append(fields[16])
                    if fields[17] != "NA":
                        amr_genes_dict[seq_name].append(fields[17])
                elif seq_name in virus_name_set:
                    fout_v.write(line)
            if include_provirus:
                for line in utils.read_file(outputs.find_proviruses_genes_output, skip_header=True):
                    if line.split("\t")[0].rsplit("_", 1)[0] in virus_name_set:
                        fout_v.write(line)

    # Provirus coordinates + taxonomy lookups (summary.py:595-621)
    provirus_coord_dict = {}
    if include_provirus:
        for line in utils.read_file(outputs.find_proviruses_output, skip_header=True):
            seq_name, _, start, end, *_ = line.strip().split("\t")
            if seq_name in virus_name_set:
                provirus_coord_dict[seq_name] = (int(start), int(end))
    taxonomy_dict = {}
    if annotate_exec:
        for line in utils.read_file(outputs.annotate_taxonomy_output, skip_header=True):
            seq_name, _, _, _, lineage = line.strip().split("\t")
            if seq_name in virus_name_set:
                taxonomy_dict[seq_name] = lineage
        if include_provirus and outputs.find_proviruses_taxonomy_output.exists():
            for line in utils.read_file(outputs.find_proviruses_taxonomy_output, skip_header=True):
                seq_name, _, _, _, lineage = line.strip().split("\t")
                if seq_name in virus_name_set:
                    taxonomy_dict[seq_name] = lineage

    # Plasmid summary (summary.py:623-665)
    with open(outputs.summary_plasmid_output, "w") as fout:
        fout.write(
            "seq_name\tlength\ttopology\tn_genes\tgenetic_code\tplasmid_score\t"
            "fdr\tn_hallmarks\tmarker_enrichment\tconjugation_genes\tamr_genes\n"
        )
        for seq_name, score, fdr in itertools.zip_longest(
            plasmid_names, plasmid_scores, plasmid_fdr, fillvalue="NA"
        ):
            length = length_dict.get(seq_name, "NA")
            topology = terminal_repeat_dict.get(seq_name, "NA")
            n_genes = n_genes_dict.get(seq_name, "NA")
            genetic_code = genetic_code_dict.get(seq_name, "NA")
            score = f"{score:.4f}"
            fdr = fdr if isinstance(fdr, str) else f"{fdr:.4f}"
            if annotate_exec:
                _, marker_enrichment, n_hallmarks = filters_dict.get(seq_name, (0, np.zeros(3), (0, 0)))
                n_hallmarks = n_hallmarks[0]
                marker_enrichment = f"{marker_enrichment[1]:.4f}"
                conjugation_genes = ";".join(conjscan_genes_dict.get(seq_name, [])) or "NA"
                amr_genes = ";".join(amr_genes_dict.get(seq_name, [])) or "NA"
            else:
                marker_enrichment = n_hallmarks = conjugation_genes = amr_genes = "NA"
            fout.write(
                f"{seq_name}\t{length}\t{topology}\t{n_genes}\t{genetic_code}\t{score}\t"
                f"{fdr}\t{n_hallmarks}\t{marker_enrichment}\t{conjugation_genes}\t{amr_genes}\n"
            )

    # Virus summary (summary.py:667-698)
    with open(outputs.summary_virus_output, "w") as fout:
        fout.write(
            "seq_name\tlength\ttopology\tcoordinates\tn_genes\tgenetic_code\t"
            "virus_score\tfdr\tn_hallmarks\tmarker_enrichment\ttaxonomy\n"
        )
        for seq_name, score, fdr in itertools.zip_longest(
            virus_names, virus_scores, virus_fdr, fillvalue="NA"
        ):
            length = length_dict.get(seq_name, "NA")
            topology = terminal_repeat_dict.get(seq_name, "NA")
            coord = provirus_coord_dict.get(seq_name, "NA")
            coord = "-".join(map(str, coord)) if isinstance(coord, tuple) else coord
            n_genes = n_genes_dict.get(seq_name, "NA")
            genetic_code = genetic_code_dict.get(seq_name, "NA")
            score = f"{score:.4f}"
            fdr = fdr if isinstance(fdr, str) else f"{fdr:.4f}"
            if annotate_exec:
                _, marker_enrichment, n_hallmarks = filters_dict.get(seq_name, (0, np.zeros(3), (0, 0)))
                n_hallmarks = n_hallmarks[1]
                marker_enrichment = f"{marker_enrichment[2]:.4f}"
                taxonomy = taxonomy_dict.get(seq_name, "Unclassified")
            else:
                marker_enrichment = n_hallmarks = taxonomy = "NA"
            fout.write(
                f"{seq_name}\t{length}\t{topology}\t{coord}\t{n_genes}\t{genetic_code}\t"
                f"{score}\t{fdr}\t{n_hallmarks}\t{marker_enrichment}\t{taxonomy}\n"
            )

    console.log(
        f"Summary files were written to {outputs.summary_plasmid_output.name} "
        f"and {outputs.summary_virus_output.name}."
    )
    console.log("genomad-torch summary finished!", style="yellow")
