"""On-disk contract: every output path for every pipeline module.

The reference enumerates ~70 Path properties by hand (genomad/_paths.py:37-433).
Here the same contract is expressed as a declarative table: each entry maps an
attribute name to (subdirectory key, filename template). ``{p}`` expands to the
run prefix. A ``None`` directory means the file lives at the output-dir root.
Filenames are byte-identical to the reference so downstream tooling that
consumes a geNomad output directory keeps working.

A copy of ``genomad_tpu/paths.py``; only ``GenomadData.data_dir`` differs
(this package's own ``data/`` directory).
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path

# module-name -> subdirectory template
_DIRS = {
    "annotate": "{p}_annotate",
    "find_proviruses": "{p}_find_proviruses",
    "marker_classification": "{p}_marker_classification",
    "nn_classification": "{p}_nn_classification",
    "aggregated_classification": "{p}_aggregated_classification",
    "score_calibration": "{p}_score_calibration",
    "summary": "{p}_summary",
}

# attribute -> (dir key | None | special, filename template)
_FILES = {
    # annotate (reference _paths.py:44-74)
    "annotate_log": (None, "{p}_annotate.log"),
    "annotate_execution_info": ("annotate", "{p}_annotate.json"),
    "annotate_proteins_output": ("annotate", "{p}_proteins.faa"),
    "annotate_mmseqs2_dir": ("annotate", "{p}_mmseqs2"),
    "annotate_mmseqs2_output": ("annotate", "{p}_mmseqs2.tsv"),
    "annotate_genes_output": ("annotate", "{p}_genes.tsv"),
    "annotate_taxonomy_output": ("annotate", "{p}_taxonomy.tsv"),
    # find-proviruses (reference _paths.py:78-124,184-186)
    "find_proviruses_log": (None, "{p}_find_proviruses.log"),
    "find_proviruses_execution_info": ("find_proviruses", "{p}_find_proviruses.json"),
    "find_proviruses_output": ("find_proviruses", "{p}_provirus.tsv"),
    "find_proviruses_genes_output": ("find_proviruses", "{p}_provirus_genes.tsv"),
    "find_proviruses_proteins_output": ("find_proviruses", "{p}_provirus_proteins.faa"),
    "find_proviruses_nucleotide_output": ("find_proviruses", "{p}_provirus.fna"),
    "find_proviruses_mmseqs2_input": ("find_proviruses", "{p}_provirus_mmseqs2_input.faa"),
    "find_proviruses_mmseqs2_dir": ("find_proviruses", "{p}_provirus_mmseqs2"),
    "find_proviruses_mmseqs2_output": ("find_proviruses", "{p}_provirus_mmseqs2.tsv"),
    "find_proviruses_aragorn_input": ("find_proviruses", "{p}_provirus_aragorn_input.fna"),
    "find_proviruses_aragorn_output": ("find_proviruses", "{p}_provirus_aragorn.tsv"),
    "find_proviruses_taxonomy_output": ("find_proviruses", "{p}_provirus_taxonomy.tsv"),
    # marker-classification (reference _paths.py:128-182)
    "marker_classification_log": (None, "{p}_marker_classification.log"),
    "marker_classification_execution_info": ("marker_classification", "{p}_marker_classification.json"),
    "features_output": ("marker_classification", "{p}_features.tsv"),
    "features_npz_output": ("marker_classification", "{p}_features.npz"),
    "marker_classification_output": ("marker_classification", "{p}_marker_classification.tsv"),
    "marker_classification_npz_output": ("marker_classification", "{p}_marker_classification.npz"),
    "provirus_features_output": ("marker_classification", "{p}_provirus_features.tsv"),
    "provirus_features_npz_output": ("marker_classification", "{p}_provirus_features.npz"),
    "provirus_marker_classification_output": ("marker_classification", "{p}_provirus_marker_classification.tsv"),
    "provirus_marker_classification_npz_output": ("marker_classification", "{p}_provirus_marker_classification.npz"),
    # nn-classification (reference _paths.py:190-236)
    "nn_classification_log": (None, "{p}_nn_classification.log"),
    "nn_classification_execution_info": ("nn_classification", "{p}_nn_classification.json"),
    "encoded_sequences_dir": ("nn_classification", "{p}_encoded_sequences"),
    "nn_classification_output": ("nn_classification", "{p}_nn_classification.tsv"),
    "nn_classification_npz_output": ("nn_classification", "{p}_nn_classification.npz"),
    "encoded_proviruses_dir": ("nn_classification", "{p}_encoded_proviruses"),
    "provirus_nn_classification_output": ("nn_classification", "{p}_provirus_nn_classification.tsv"),
    "provirus_nn_classification_npz_output": ("nn_classification", "{p}_provirus_nn_classification.npz"),
    # aggregated-classification (reference _paths.py:240-281)
    "aggregated_classification_log": (None, "{p}_aggregated_classification.log"),
    "aggregated_classification_execution_info": ("aggregated_classification", "{p}_aggregated_classification.json"),
    "aggregated_classification_output": ("aggregated_classification", "{p}_aggregated_classification.tsv"),
    "aggregated_classification_npz_output": ("aggregated_classification", "{p}_aggregated_classification.npz"),
    "provirus_aggregated_classification_output": ("aggregated_classification", "{p}_provirus_aggregated_classification.tsv"),
    "provirus_aggregated_classification_npz_output": ("aggregated_classification", "{p}_provirus_aggregated_classification.npz"),
    # score-calibration (reference _paths.py:285-387)
    "score_calibration_log": (None, "{p}_score_calibration.log"),
    "score_calibration_execution_info": ("score_calibration", "{p}_score_calibration.json"),
    "score_calibration_compositions_output": ("score_calibration", "{p}_compositions.tsv"),
    "score_calibration_compositions_npz_output": ("score_calibration", "{p}_compositions.npz"),
    "calibrated_marker_classification_output": ("score_calibration", "{p}_calibrated_marker_classification.tsv"),
    "calibrated_marker_classification_npz_output": ("score_calibration", "{p}_calibrated_marker_classification.npz"),
    "calibrated_nn_classification_output": ("score_calibration", "{p}_calibrated_nn_classification.tsv"),
    "calibrated_nn_classification_npz_output": ("score_calibration", "{p}_calibrated_nn_classification.npz"),
    "calibrated_aggregated_classification_output": ("score_calibration", "{p}_calibrated_aggregated_classification.tsv"),
    "calibrated_aggregated_classification_npz_output": ("score_calibration", "{p}_calibrated_aggregated_classification.npz"),
    "provirus_calibrated_marker_classification_output": ("score_calibration", "{p}_provirus_calibrated_marker_classification.tsv"),
    "provirus_calibrated_marker_classification_npz_output": ("score_calibration", "{p}_provirus_calibrated_marker_classification.npz"),
    "provirus_calibrated_nn_classification_output": ("score_calibration", "{p}_provirus_calibrated_nn_classification.tsv"),
    "provirus_calibrated_nn_classification_npz_output": ("score_calibration", "{p}_provirus_calibrated_nn_classification.npz"),
    "provirus_calibrated_aggregated_classification_output": ("score_calibration", "{p}_provirus_calibrated_aggregated_classification.tsv"),
    "provirus_calibrated_aggregated_classification_npz_output": ("score_calibration", "{p}_provirus_calibrated_aggregated_classification.npz"),
    # summary (reference _paths.py:391-433)
    "summary_log": (None, "{p}_summary.log"),
    "summary_execution_info": ("summary", "{p}_summary.json"),
    "summary_virus_output": ("summary", "{p}_virus_summary.tsv"),
    "summary_virus_sequences_output": ("summary", "{p}_virus.fna"),
    "summary_virus_proteins_output": ("summary", "{p}_virus_proteins.faa"),
    "summary_virus_genes_output": ("summary", "{p}_virus_genes.tsv"),
    "summary_plasmid_output": ("summary", "{p}_plasmid_summary.tsv"),
    "summary_plasmid_sequences_output": ("summary", "{p}_plasmid.fna"),
    "summary_plasmid_proteins_output": ("summary", "{p}_plasmid_proteins.faa"),
    "summary_plasmid_genes_output": ("summary", "{p}_plasmid_genes.tsv"),
}

# nested-in-dir special cases (reference _paths.py:207-208,223-224)
_NESTED = {
    "seq_window_id_output": ("encoded_sequences_dir", "{p}_seq_window_id.npz"),
    "provirus_window_id_output": ("encoded_proviruses_dir", "{p}_provirus_window_id.npz"),
}


@dataclass
class GenomadOutputs:
    prefix: str
    output_dir: Path

    def __getattr__(self, name: str) -> Path:
        p = self.prefix
        if name.endswith("_dir") and name[:-4] in _DIRS:
            return self.output_dir / _DIRS[name[:-4]].format(p=p)
        if name in _FILES:
            dir_key, template = _FILES[name]
            base = self.output_dir if dir_key is None else self.output_dir / _DIRS[dir_key].format(p=p)
            return base / template.format(p=p)
        if name in _NESTED:
            parent_attr, template = _NESTED[name]
            return getattr(self, parent_attr) / template.format(p=p)
        raise AttributeError(name)


class GenomadData:
    """Bundled model/data asset paths (reference analog: genomad/_paths.py:12-34).

    Trained weights are not shipped; without them the classifier runs on
    deterministic synthetic weights (models.weights.load_params)."""

    data_dir = Path(__file__).parent / "data"

    decision_forest_file = data_dir / "decision_forest.ubj"
    nn_model_file = data_dir / "nn_classifier.h5"
    nn_params_file = data_dir / "nn_classifier.npz"
    rbs_file = data_dir / "rbs_categories.tsv"
    score_calibration_weights_file = data_dir / "score_calibration_weights.npz"
