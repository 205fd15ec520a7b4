"""aggregated-classification module: fuse marker & NN branch scores.

Contract parity with genomad/modules/aggregated_classification.py:37-322:
requires prior marker-classification and nn-classification runs on the same
input (MD5-checked), weights the marker branch by total marker frequency
(features columns 15:18), writes <prefix>_aggregated_classification.{tsv,npz}
plus provirus variants.

A copy of ``genomad_tpu/modules/aggregated_classification.py`` (numpy).
"""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np

from genomad_torch import sequence, trace, utils
from genomad_torch.models import fusion
from genomad_torch.paths import GenomadOutputs


def _write_scores_tsv(path, names, predictions):
    with open(path, "w") as fout:
        fout.write("seq_name\tchromosome_score\tplasmid_score\tvirus_score\n")
        for name, scores in zip(names, predictions):
            formatted = "".join(f"{x:.4f}\t" for x in scores).strip()
            fout.write(f"{name}\t{formatted}\n")


@trace.spanned("module.aggregated_classification")
def main(input_path, output_path, restart=False, verbose=True):
    input_path, output_path = Path(input_path), Path(output_path)
    output_path.mkdir(exist_ok=True)
    prefix = utils.output_prefix(input_path)
    outputs = GenomadOutputs(prefix, output_path)
    console = utils.Console(outputs.aggregated_classification_log, verbose)
    parameter_dict = {}

    classify_proviruses = utils.check_provirus_execution(prefix, input_path, output_path)

    output_files = [
        outputs.aggregated_classification_execution_info,
        outputs.aggregated_classification_output,
        outputs.aggregated_classification_npz_output,
    ]
    descriptions = [
        "execution parameters",
        "sequence classification: tabular format",
        "sequence classification: binary format",
    ]
    if classify_proviruses:
        output_files += [
            outputs.provirus_aggregated_classification_output,
            outputs.provirus_aggregated_classification_npz_output,
        ]
        descriptions += [
            "provirus classification: tabular format",
            "provirus classification: binary format",
        ]
    utils.display_header(
        console,
        "aggregated-classification",
        "This will aggregate the results of the marker-classification and "
        "nn-classification modules to classify the input sequences into "
        "chromosome, plasmid, or virus.",
        outputs.aggregated_classification_dir,
        output_files,
        descriptions,
    )

    # Required inputs (reference: aggregated_classification.py:96-119)
    required = [
        outputs.marker_classification_execution_info,
        outputs.features_npz_output,
        outputs.marker_classification_npz_output,
        outputs.nn_classification_execution_info,
        outputs.nn_classification_npz_output,
    ]
    if classify_proviruses:
        required += [
            outputs.provirus_marker_classification_npz_output,
            outputs.provirus_nn_classification_npz_output,
        ]
    missing = [p.name for p in required if not p.exists()]
    if missing:
        console.error(
            "The following files could not be found: "
            + ", ".join(missing)
            + ". Make sure to execute the marker-classification and "
            "nn-classification modules."
        )
        sys.exit(1)

    # Same-input verification (reference: aggregated_classification.py:121-137)
    input_md5 = utils.get_md5(input_path)
    marker_md5 = utils.get_execution_info(outputs.marker_classification_execution_info)[0]
    nn_md5 = utils.get_execution_info(outputs.nn_classification_execution_info)[0]
    if input_md5 != marker_md5 or input_md5 != nn_md5:
        console.error(
            "Different input FASTA files were used as input for the "
            "marker-classification, nn-classification, and "
            "aggregated-classification modules."
        )
        sys.exit(1)

    if not sequence.check_fasta(input_path):
        console.error(f"{input_path} is either empty or contains duplicate identifiers.")
        sys.exit(1)

    skip = False
    if (
        outputs.aggregated_classification_execution_info.exists()
        and any(p.exists() for p in output_files)
        and not restart
    ):
        if utils.compare_executions(input_path, parameter_dict, outputs.aggregated_classification_execution_info):
            skip = True
            console.log("Previous execution detected. Steps will be skipped unless their outputs are not found.")

    outputs.aggregated_classification_dir.mkdir(exist_ok=True)
    utils.write_execution_info(
        "aggregated_classification", input_path, parameter_dict,
        outputs.aggregated_classification_execution_info,
    )

    # Total marker frequency = sum of feature columns 15:18
    contig_marker_freq = np.load(outputs.features_npz_output)["contig_features"][:, 15:18].sum(1)
    if classify_proviruses:
        provirus_marker_freq = np.load(outputs.provirus_features_npz_output)[
            "provirus_features"
        ][:, 15:18].sum(1)

    # --- contigs ---
    if skip and outputs.aggregated_classification_npz_output.exists():
        cached = np.load(outputs.aggregated_classification_npz_output)
        contig_names, contig_predictions = cached["contig_names"], cached["predictions"]
    else:
        contig_names = np.load(outputs.marker_classification_npz_output)["contig_names"]
        marker_predictions = np.load(outputs.marker_classification_npz_output)["predictions"]
        nn_predictions = np.load(outputs.nn_classification_npz_output)["predictions"]
        contig_predictions = fusion.branch_attention(
            contig_marker_freq, marker_predictions, nn_predictions
        )
        np.savez_compressed(
            outputs.aggregated_classification_npz_output,
            contig_names=contig_names,
            predictions=contig_predictions,
        )
        console.log("Sequences classified.")
    _write_scores_tsv(outputs.aggregated_classification_output, contig_names, contig_predictions)

    # --- proviruses ---
    if classify_proviruses:
        if skip and outputs.provirus_aggregated_classification_npz_output.exists():
            cached = np.load(outputs.provirus_aggregated_classification_npz_output)
            provirus_names, provirus_predictions = cached["provirus_names"], cached["predictions"]
        else:
            provirus_names = np.load(outputs.provirus_marker_classification_npz_output)["provirus_names"]
            marker_predictions = np.load(outputs.provirus_marker_classification_npz_output)["predictions"]
            nn_predictions = np.load(outputs.provirus_nn_classification_npz_output)["predictions"]
            provirus_predictions = fusion.branch_attention(
                provirus_marker_freq, marker_predictions, nn_predictions
            )
            np.savez_compressed(
                outputs.provirus_aggregated_classification_npz_output,
                provirus_names=provirus_names,
                predictions=provirus_predictions,
            )
            console.log("Proviruses classified.")
        _write_scores_tsv(
            outputs.provirus_aggregated_classification_output, provirus_names, provirus_predictions
        )

    console.log("genomad-torch aggregated-classification finished!", style="yellow")
