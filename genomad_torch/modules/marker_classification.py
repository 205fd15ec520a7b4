"""marker-classification module: gene-feature engineering + decision forest.

Port of ``genomad_tpu/modules/marker_classification.py``: the same files,
the same resume rules; the forest runs on ``device`` (None = the card;
raises without one, before anything is written), ``"cpu"`` runs it on the
CPU. Contract parity with genomad/modules/marker_classification.py:338-769: reads
the annotate module's genes table, builds the 25-feature vectors, evaluates
the tree ensemble (output margins -> softmax(T=2)), and writes feature +
classification tables for contigs and (when available) proviruses.
"""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np

from genomad_torch import database, sequence, trace, utils
from genomad_torch.device import resolve_device
from genomad_torch.models import forest as forest_lib
from genomad_torch.ops import features as features_lib
from genomad_torch.paths import GenomadData, GenomadOutputs


def _write_features_tsv(path, names, n_genes, n_uscg, n_hallmarks, genetic_code, features, enrichment):
    with open(path, "w") as fout:
        fout.write(f"{features_lib.FEATURE_FILE_HEADER}\n")
        for name, ng, nu, nh, gc, feats, enr in zip(
            names, n_genes, n_uscg, n_hallmarks, genetic_code, features, enrichment
        ):
            feats_s = "".join(f"{x:.4f}\t" for x in feats).strip()
            enr_s = "".join(f"{x:.4f}\t" for x in enr).strip()
            fout.write(f"{name}\t{ng}\t{nu}\t{nh[0]}\t{nh[1]}\t{gc}\t{feats_s}\t{enr_s}\n")


def _write_scores_tsv(path, names, predictions):
    with open(path, "w") as fout:
        fout.write("seq_name\tchromosome_score\tplasmid_score\tvirus_score\n")
        for name, scores in zip(names, predictions):
            formatted = "".join(f"{x:.4f}\t" for x in scores).strip()
            fout.write(f"{name}\t{formatted}\n")


def _classify(features: np.ndarray, forest: forest_lib.Forest, device) -> np.ndarray:
    margins = forest.predict_margin(features.astype(np.float32), device=device)
    return utils.softmax(margins, temperature=2)


@trace.spanned("module.marker_classification")
def main(input_path, output_path, database_path, restart=False, threads=None, verbose=True, device=None):
    device = resolve_device(device)
    input_path, output_path = Path(input_path), Path(output_path)
    output_path.mkdir(exist_ok=True)
    prefix = utils.output_prefix(input_path)
    outputs = GenomadOutputs(prefix, output_path)
    console = utils.Console(outputs.marker_classification_log, verbose)
    parameter_dict = {}

    classify_proviruses = utils.check_provirus_execution(prefix, input_path, output_path)

    output_files = [
        outputs.marker_classification_execution_info,
        outputs.features_output,
        outputs.features_npz_output,
        outputs.marker_classification_output,
        outputs.marker_classification_npz_output,
    ]
    descriptions = [
        "execution parameters",
        "sequence feature data: tabular format",
        "sequence feature data: binary format",
        "sequence classification: tabular format",
        "sequence classification: binary format",
    ]
    if classify_proviruses:
        output_files += [
            outputs.provirus_features_output,
            outputs.provirus_features_npz_output,
            outputs.provirus_marker_classification_output,
            outputs.provirus_marker_classification_npz_output,
        ]
        descriptions += [
            "provirus feature data: tabular format",
            "provirus feature data: binary format",
            "provirus classification: tabular format",
            "provirus classification: binary format",
        ]
    utils.display_header(
        console,
        "marker-classification",
        "This will classify the input sequences into chromosome, plasmid, or "
        "virus based on the presence of geNomad markers and other "
        "gene-related features.",
        outputs.marker_classification_dir,
        output_files,
        descriptions,
    )

    if not outputs.annotate_genes_output.exists():
        console.error(
            f"{outputs.annotate_genes_output.name} was not found in the output "
            "directory. Please execute the annotate module to generate it."
        )
        sys.exit(1)
    if not utils.compare_executions(input_path, {}, outputs.annotate_execution_info, only_md5=True):
        console.error(
            "The input FASTA file is different from the one used in the "
            "annotate module. Please execute both modules using the same input."
        )
        sys.exit(1)
    if not sequence.check_fasta(input_path):
        console.error(f"{input_path} is either empty or contains duplicate identifiers.")
        sys.exit(1)

    skip = False
    if (
        outputs.marker_classification_execution_info.exists()
        and any(p.exists() for p in output_files)
        and not restart
    ):
        if utils.compare_executions(input_path, parameter_dict, outputs.marker_classification_execution_info):
            skip = True
            console.log("Previous execution detected. Steps will be skipped unless their outputs are not found.")

    outputs.marker_classification_dir.mkdir(exist_ok=True)
    utils.write_execution_info(
        "marker_classification", input_path, parameter_dict,
        outputs.marker_classification_execution_info,
    )

    database_obj = database.Database(database_path)
    forest = None

    # --- contig features ---
    if skip and outputs.features_npz_output.exists():
        cached = np.load(outputs.features_npz_output)
        contig_names = cached["contig_names"]
        contig_features = cached["contig_features"]
        feature_payload = {k: cached[k] for k in cached.files}
    else:
        (
            contig_names, contig_n_genes, contig_n_uscg, contig_n_hallmarks,
            contig_genetic_code, contig_features, contig_marker_enrichment,
        ) = features_lib.get_feature_array(
            input_path, outputs.annotate_genes_output, database_obj, GenomadData.rbs_file
        )
        feature_payload = {
            "contig_names": contig_names,
            "contig_n_genes": contig_n_genes,
            "contig_n_uscg": contig_n_uscg,
            "contig_n_hallmarks": contig_n_hallmarks,
            "contig_genetic_code": contig_genetic_code,
            "contig_features": contig_features,
            "contig_marker_enrichment": contig_marker_enrichment,
        }
        np.savez_compressed(outputs.features_npz_output, **feature_payload)
        console.log("Sequence features computed.")
    _write_features_tsv(
        outputs.features_output,
        feature_payload["contig_names"],
        feature_payload["contig_n_genes"],
        feature_payload["contig_n_uscg"],
        feature_payload["contig_n_hallmarks"],
        feature_payload["contig_genetic_code"],
        feature_payload["contig_features"],
        feature_payload["contig_marker_enrichment"],
    )

    # --- contig classification ---
    if skip and outputs.marker_classification_npz_output.exists():
        contig_predictions = np.load(outputs.marker_classification_npz_output)["predictions"]
    else:
        if not len(contig_features):
            console.error("No sequences were found. Please check your input FASTA.")
            sys.exit(1)
        forest = forest_lib.load_forest(console)
        contig_predictions = _classify(contig_features, forest, device)
        np.savez_compressed(
            outputs.marker_classification_npz_output,
            contig_names=contig_names,
            predictions=contig_predictions,
        )
        console.log("Sequences classified.")
    _write_scores_tsv(outputs.marker_classification_output, contig_names, contig_predictions)

    # --- proviruses ---
    if classify_proviruses:
        if skip and outputs.provirus_features_npz_output.exists():
            cached = np.load(outputs.provirus_features_npz_output)
            provirus_payload = {k: cached[k] for k in cached.files}
        else:
            (
                provirus_names, provirus_n_genes, provirus_n_uscg, provirus_n_hallmarks,
                provirus_genetic_code, provirus_features, provirus_marker_enrichment,
            ) = features_lib.get_feature_array(
                outputs.find_proviruses_nucleotide_output,
                outputs.find_proviruses_genes_output,
                database_obj,
                GenomadData.rbs_file,
            )
            provirus_payload = {
                "provirus_names": provirus_names,
                "provirus_n_genes": provirus_n_genes,
                "provirus_n_uscg": provirus_n_uscg,
                "provirus_n_hallmarks": provirus_n_hallmarks,
                "provirus_genetic_code": provirus_genetic_code,
                "provirus_features": provirus_features,
                "provirus_marker_enrichment": provirus_marker_enrichment,
            }
            np.savez_compressed(outputs.provirus_features_npz_output, **provirus_payload)
            console.log("Provirus features computed.")
        _write_features_tsv(
            outputs.provirus_features_output,
            provirus_payload["provirus_names"],
            provirus_payload["provirus_n_genes"],
            provirus_payload["provirus_n_uscg"],
            provirus_payload["provirus_n_hallmarks"],
            provirus_payload["provirus_genetic_code"],
            provirus_payload["provirus_features"],
            provirus_payload["provirus_marker_enrichment"],
        )
        if skip and outputs.provirus_marker_classification_npz_output.exists():
            cached = np.load(outputs.provirus_marker_classification_npz_output)
            provirus_predictions = cached["predictions"]
            provirus_names = cached["provirus_names"]
        else:
            if forest is None:
                forest = forest_lib.load_forest(console)
            provirus_names = provirus_payload["provirus_names"]
            provirus_predictions = _classify(provirus_payload["provirus_features"], forest, device)
            np.savez_compressed(
                outputs.provirus_marker_classification_npz_output,
                provirus_names=provirus_names,
                predictions=provirus_predictions,
            )
            console.log("Proviruses classified.")
        _write_scores_tsv(
            outputs.provirus_marker_classification_output, provirus_names, provirus_predictions
        )

    console.log("genomad-torch marker-classification finished!", style="yellow")
