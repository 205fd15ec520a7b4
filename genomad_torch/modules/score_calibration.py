"""score-calibration module: composition-aware calibrated probabilities.

Contract parity with genomad/modules/score_calibration.py:53-587: estimates
sample composition (empirical argmax frequencies when >= 1,000 sequences and
--composition auto, otherwise the metagenome/virome presets) and pushes every
available classifier's scores through the per-classifier calibration MLP.

A copy of ``genomad_tpu/modules/score_calibration.py`` (numpy).
"""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np

from genomad_torch import trace, utils
from genomad_torch.models import fusion
from genomad_torch.paths import GenomadData, GenomadOutputs

_PRESETS = {
    # reference: score_calibration.py:362-373
    "metagenome": {
        "marker": np.array([0.84, 0.05, 0.11]),
        "nn": np.array([0.67, 0.20, 0.13]),
        "aggregated": np.array([0.72, 0.17, 0.11]),
    },
    "virome": {
        "marker": np.array([0.26, 0.004, 0.736]),
        "nn": np.array([0.23, 0.06, 0.71]),
        "aggregated": np.array([0.24, 0.025, 0.735]),
    },
}


def _write_scores_tsv(path, names, predictions):
    with open(path, "w") as fout:
        fout.write("seq_name\tchromosome_score\tplasmid_score\tvirus_score\n")
        for name, (c, p, v) in zip(names, predictions):
            fout.write(f"{name}\t{c:.4f}\t{p:.4f}\t{v:.4f}\n")


@trace.spanned("module.score_calibration")
def main(input_path, output_path, composition="auto", force_auto=False, verbose=True):
    input_path, output_path = Path(input_path), Path(output_path)
    output_path.mkdir(exist_ok=True)
    prefix = utils.output_prefix(input_path)
    outputs = GenomadOutputs(prefix, output_path)
    console = utils.Console(outputs.score_calibration_log, verbose)
    parameter_dict = {"composition": composition, "force_auto": force_auto}

    if composition not in {"auto", "metagenome", "virome"}:
        console.error("Invalid value for the composition parameter.")
        sys.exit(1)

    find_proviruses_exec = utils.check_provirus_execution(prefix, input_path, output_path)

    # classifier -> (contig npz, provirus npz, contig outputs, provirus outputs)
    classifiers = {
        "marker": (
            outputs.marker_classification_npz_output,
            outputs.provirus_marker_classification_npz_output,
            (outputs.calibrated_marker_classification_output, outputs.calibrated_marker_classification_npz_output),
            (outputs.provirus_calibrated_marker_classification_output, outputs.provirus_calibrated_marker_classification_npz_output),
            outputs.marker_classification_execution_info,
        ),
        "nn": (
            outputs.nn_classification_npz_output,
            outputs.provirus_nn_classification_npz_output,
            (outputs.calibrated_nn_classification_output, outputs.calibrated_nn_classification_npz_output),
            (outputs.provirus_calibrated_nn_classification_output, outputs.provirus_calibrated_nn_classification_npz_output),
            outputs.nn_classification_execution_info,
        ),
        "aggregated": (
            outputs.aggregated_classification_npz_output,
            outputs.provirus_aggregated_classification_npz_output,
            (outputs.calibrated_aggregated_classification_output, outputs.calibrated_aggregated_classification_npz_output),
            (outputs.provirus_calibrated_aggregated_classification_output, outputs.provirus_calibrated_aggregated_classification_npz_output),
            outputs.aggregated_classification_execution_info,
        ),
    }

    executed = {
        name: spec
        for name, spec in classifiers.items()
        if spec[4].exists() and spec[0].exists()
    }
    if not executed:
        console.error(
            "No previous execution of the marker-classification, "
            "nn-classification, or aggregated-classification modules were "
            "detected. Please execute at least one of these modules."
        )
        sys.exit(1)

    # Same-input verification across all consumed modules
    md5_list = [utils.get_md5(input_path)]
    for name, spec in executed.items():
        md5_list.append(utils.get_execution_info(spec[4])[0])
    if find_proviruses_exec:
        md5_list.append(utils.get_execution_info(outputs.find_proviruses_execution_info)[0])
    if len(set(md5_list)) > 1:
        console.error("Different input FASTA files were used as input for the different modules.")
        sys.exit(1)

    utils.display_header(
        console,
        "score-calibration",
        "This will calibrate the classification scores based on the sample composition.",
        outputs.score_calibration_dir,
        [outputs.score_calibration_execution_info, outputs.score_calibration_compositions_output],
        ["execution parameters", "estimated compositions"],
    )

    outputs.score_calibration_dir.mkdir(exist_ok=True)
    utils.write_execution_info(
        "score_calibration", input_path, parameter_dict, outputs.score_calibration_execution_info
    )

    # Load scores per classifier (+provirus scores when available)
    score_data = {}
    for name, spec in executed.items():
        contig_npz = np.load(spec[0])
        contig_names = contig_npz["contig_names"]
        contig_scores = contig_npz["predictions"]
        provirus_names, provirus_scores = None, None
        if find_proviruses_exec and spec[1].exists():
            pro_npz = np.load(spec[1])
            provirus_names = pro_npz["provirus_names"]
            provirus_scores = pro_npz["predictions"]
        score_data[name] = (contig_names, contig_scores, provirus_names, provirus_scores)

    # Composition estimation (reference: score_calibration.py:311-373)
    any_scores = next(iter(score_data.values()))
    n_sequences = len(any_scores[0]) + (len(any_scores[2]) if any_scores[2] is not None else 0)
    if n_sequences < 1_000 and composition == "auto" and not force_auto:
        console.warning(
            "Your sample has less than 1,000 sequences, which does not allow "
            "precise composition estimation. The 'metagenome' preset will be "
            "used instead. Use --force-auto to force empirical estimation."
        )
        composition = "metagenome"

    if composition == "auto":
        composition_dict = {}
        for name, (cn, cs, pn, ps) in score_data.items():
            all_scores = cs if ps is None or not len(ps) else np.concatenate([cs, ps])
            composition_dict[name] = fusion.get_empirical_sample_composition(all_scores)
    else:
        composition_dict = {k: v for k, v in _PRESETS[composition].items() if k in executed}

    np.savez_compressed(
        outputs.score_calibration_compositions_npz_output,
        marker=composition_dict.get("marker", np.zeros(3)),
        nn=composition_dict.get("nn", np.zeros(3)),
        aggregated=composition_dict.get("aggregated", np.zeros(3)),
    )
    with open(outputs.score_calibration_compositions_output, "w") as fout:
        fout.write("model\tchromosome\tplasmid\tvirus\n")
        for k, v in composition_dict.items():
            fout.write(f"{k}\t" + "\t".join(f"{i:.4f}" for i in v) + "\n")
    console.log(f"Estimated compositions written to {outputs.score_calibration_compositions_output.name}.")

    # Calibrate + write
    weights_file = GenomadData.score_calibration_weights_file
    for name, (cn, cs, pn, ps) in score_data.items():
        spec = executed[name]
        calibrated = fusion.score_batch_correction(cs, composition_dict[name], name, weights_file)
        np.savez_compressed(spec[2][1], contig_names=cn, predictions=calibrated)
        _write_scores_tsv(spec[2][0], cn, calibrated)
        console.log(f"Calibrated {name} scores written to {spec[2][0].name}.")
        if pn is not None and len(pn):
            calibrated_p = fusion.score_batch_correction(ps, composition_dict[name], name, weights_file)
            np.savez_compressed(spec[3][1], provirus_names=pn, predictions=calibrated_p)
            _write_scores_tsv(spec[3][0], pn, calibrated_p)

    console.log("genomad-torch score-calibration finished!", style="yellow")
