"""The ``nn-classification`` command's body,
``genomad_torch.modules.nn_classification.main``, at batch 128 on a fresh
output directory per job.

Spans: the module (``nn_module``), the window encoding (``encode``,
``nn_pipeline.encode_windows``) and the forward over all windows
(``inference``, ``nn_pipeline.predict_windows``, which ends on the copy of
the scores to the host). Check: every window of the sampled jobs' caches
against the reference's encoding, and every contig's scores against the
plain float32 IGLOO forward.
"""

from __future__ import annotations

from pathlib import Path

from benchmark.entries.common import Base, nn_check


class Entry(Base):
    def __init__(self, name: str, config: dict, device, cache: Path):
        super().__init__(config, device)

    def run(self, fasta: Path, out: Path) -> None:
        from genomad_torch.modules import nn_classification

        nn_classification.main(fasta, out, batch_size=self.config["batch_size"], verbose=False, device=self.device)

    def check_sample(self, rng) -> set:
        """Two jobs of the window, drawn from the seed among the first few."""
        return {0, int(rng.integers(1, self.config["check_jobs_within"]))}

    def span_points(self) -> list:
        from genomad_torch.modules import nn_classification
        from genomad_torch.ops import nn_pipeline

        return [
            (nn_classification, "main", "nn_module", None),
            (nn_pipeline, "encode_windows", "encode", None),
            (nn_pipeline, "predict_windows", "inference", None),
        ]

    def check(self, pool, fastas, kept, workdir: Path) -> dict:
        self.judged = {"jobs": len(kept)}
        rows, gap = nn_check(self.reference(), [(fastas[i], out) for _, i, out in kept], self.judged)
        limits = self.config["limits"]
        return {
            "window_rows_differing": {"value": rows, "limit": limits["window_rows_differing"]},
            "nn_score_gap": {"value": gap, "limit": limits["nn_score_gap"]},
        }
