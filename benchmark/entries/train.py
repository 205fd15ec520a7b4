"""Fine-tuning IGLOO through the port's training loop,
``genomad_torch.train.Trainer.fit``, a labelled FASTA a job, from one train
state kept across the run's jobs as one training run keeps it: float32 with
TF32 off, AdamW at the configuration's learning rate and weight decay, its
batch and dropout, from the port's weights (``models.weights.load_params``,
the seed-0 fallback where no trained weights are installed). The state is
made at the first job, so that ``setup_s`` counts it.

Spans: the loop's call (``train_fit``) and its window encoding (``encode``,
``nn_pipeline.encode_windows``).

Check, on two jobs of the window drawn from the seed. The first step of each
is recorded: the trained leaves, AdamW's moments and the dropout generator's
state before it; its tokens, labels, loss and gradients and the leaves after
it. ``reference.igloo_train`` recomputes that step from the same leaves and
moments, at the same batch, with the keep masks drawn from the recorded
generator state (float32, TF32 off):
- ``train_loss_gap``: |loss - reference| / |reference|;
- ``train_grad_gap``: the largest over leaves of |g - g_ref| / |g_ref| (L2),
  g_ref the reference's gradient on the branches the step took where
  float32 may take either (``igloo_train.branches`` and ``match``: a
  (leaky) ReLU's input or a max-pool's margin within 1e-5 of its terms'
  magnitude; one such decision taken the other way moves a leaf's gradient
  by up to about 1%, while float32's own rounding there is below 1e-6);
- ``train_update_gap``: the largest over leaves of |d - d_ref| / |d_ref|
  (L2), d a leaf's change over the step and d_ref AdamW's, written out in
  float64, from the same leaves, moments and the gradient the step
  computed (which ``train_grad_gap`` holds: AdamW divides each gradient by
  its own root mean square, so comparing two updates from two gradients
  would read the gradients' rounding near 0 again, magnified), over the
  elements whose d_ref is at least ``RESOLVED`` float32 spacings of the
  leaf's value (below that, the stored float32 leaf rounds the change by
  up to 1/512 of it and more, whatever the arithmetic);
- ``window_rows_differing``: rows of those steps whose tokens and label are
  those of no window of the jobs run so far, as ``reference.igloo``'s
  ``encode_windows`` and ``tokens`` make them and the contig names label them;
- ``windows_untrained``: the windows of the window's jobs
  (``reference.igloo.window_count``) and those held before it, less those
  trained (the port's counter ``train.windows``) and those held after it;
- ``nonfinite_losses``: the window's ``train.nonfinite_losses``.
``judged`` holds the control's readings (the same steps recomputed by the
reference with TF32 allowed, held to the same yardsticks) and how many
decisions lay within the margin, how many of them were computed and how
many the port's step and the control took the other way (fractions where a
max-pool's tie split its gradient), and the share of the update's elements
that ``train_update_gap`` reads.
"""

from __future__ import annotations

import hashlib
from pathlib import Path

import numpy as np
import torch

from benchmark.entries.common import Base, records
from benchmark.reference import igloo, igloo_train

CLASSES = ("chromosome", "plasmid", "virus")
REFERENCE_BLOCK = 256  # windows tokenized at a time by the check
# an update's elements that float32 holds to 1/256 or better: a change of at
# least this many units in the last place of the leaf's value
RESOLVED = 256


def _gap(got: torch.Tensor, want: torch.Tensor) -> float:
    """|got - want| / |want| in L2 (float64)."""
    got, want = got.double(), want.double()
    return float(torch.linalg.vector_norm(got - want) / max(float(torch.linalg.vector_norm(want)), 1e-300))


def _resolved(before: torch.Tensor, change: torch.Tensor) -> torch.Tensor:
    """Where ``change`` is at least ``RESOLVED`` float32 spacings of ``before``."""
    spacing = torch.nextafter(before, torch.full_like(before, float("inf"))) - before
    return change.abs() >= RESOLVED * spacing.double()


def _digest(row: np.ndarray) -> bytes:
    return hashlib.blake2b(np.ascontiguousarray(row, np.int32).tobytes(), digest_size=16).digest()


class Entry(Base):
    def __init__(self, name: str, config: dict, device, cache: Path):
        super().__init__(config, device)
        from genomad_torch.train import Trainer  # noqa: F401 - a port without the loop fails here, before any work

        self.trainer = None
        self.ran: list = []  # every job's FASTA in order, the warm-up first
        self.window_start = None
        self.keep: set = set()
        self.recorded: dict = {}

    def _start(self) -> None:
        from genomad_torch import train
        from genomad_torch.models import igloo as port_igloo, weights

        c = self.config
        opt = train.make_optimizer(c["learning_rate"], c["weight_decay"])
        state = train.init_train_state(port_igloo.params_from_numpy(weights.load_params(), torch.float32), opt, device=self.device)
        self.trainer = train.Trainer(state, train.make_train_step(opt, c["dropout"]), c["batch_size"], c["train_seed"])

    def run(self, fasta: Path, out: Path) -> None:
        if self.trainer is None:
            self._start()
        job = None if self.window_start is None else len(self.ran) - self.window_start
        self.ran.append(fasta)
        step = self.trainer.step
        if job in self.keep:
            self.trainer.step = self._recording(step, job)
        try:
            self.trainer.fit(fasta)
        finally:
            self.trainer.step = step

    def _recording(self, step, job: int):
        """``step``, keeping of its first call what the check recomputes (on
        the device, with no wait)."""

        def first(state, tokens, labels, generator):
            if job in self.recorded:
                return step(state, tokens, labels, generator)
            leaves = {f"{g}/{n}": p for g, sub in state.trainable.items() for n, p in sub.items()}
            opt = state.optimizer.state
            rec = {
                "before": {k: p.detach().clone() for k, p in leaves.items()},
                "moments": {k: (opt[p]["exp_avg"].clone(), opt[p]["exp_avg_sq"].clone()) for k, p in leaves.items() if "exp_avg" in opt.get(p, {})},
                "step": state.step,
                "generator": generator.get_state(),
                "tokens": tokens.clone(),
                "labels": labels.clone(),
            }
            state, loss = step(state, tokens, labels, generator)
            rec["loss"] = loss.clone()
            rec["grads"] = {k: p.grad.detach().clone() for k, p in leaves.items()}
            rec["after"] = {k: p.detach().clone() for k, p in leaves.items()}
            self.recorded[job] = rec
            return state, loss

        return first

    def check_sample(self, rng) -> set:
        """Two jobs of the window, drawn from the seed among the first few;
        the trainer's counters and carry at the window's start."""
        from genomad_torch import trace

        self.window_start = len(self.ran)
        self.held_before = self.trainer.held
        self.counted_before = {k: trace.COUNTERS[k] for k in ("train.windows", "train.nonfinite_losses")}
        self.keep = {0, int(rng.integers(1, self.config["check_jobs_within"]))}
        return self.keep

    def span_points(self) -> list:
        from genomad_torch import train
        from genomad_torch.ops import nn_pipeline

        return [
            (train.Trainer, "fit", "train_fit", None),
            (nn_pipeline, "encode_windows", "encode", None),
        ]

    def release(self) -> None:
        from genomad_torch import trace

        self.held_after = self.trainer.held
        self.counted_after = {k: trace.COUNTERS[k] for k in self.counted_before}
        self.trainer = None
        super().release()

    # ------------------------------------------------------------ the check

    def _labelled_windows(self, upto: int) -> dict:
        """{digest of a window's tokens: its label} over the first ``upto``
        jobs run, by the reference's encoding."""
        known: dict = {}
        for path in self.ran[:upto]:
            recs = records(path)
            bases, names, ids = igloo.encode_windows(recs, self.widths)
            labels = np.array([CLASSES.index(n.rsplit("|", 1)[-1]) for n in names])[ids] if len(names) else np.zeros(0, int)
            for s in range(0, len(bases), REFERENCE_BLOCK):
                tok = igloo.tokens(torch.as_tensor(bases[s : s + REFERENCE_BLOCK])).numpy()
                for row, label in zip(tok, labels[s : s + REFERENCE_BLOCK]):
                    known[_digest(row)] = int(label)
        return known

    def check(self, pool, fastas, kept, workdir: Path) -> dict:
        c, w = self.config, self.widths
        device = "cuda" if self.on_card else "cpu"
        raw = igloo.init_params(w, c["nn_weights_seed"])
        patches = {g: raw[g]["patches"].astype(np.int64) for g in igloo_train.BLOCKS}
        gaps = {"train_loss_gap": 0.0, "train_grad_gap": 0.0, "train_update_gap": 0.0}
        control = dict.fromkeys(gaps, 0.0)
        rows_differing = 0
        self.judged = {"jobs": len(kept), "steps": 0, "rows": 0, "branches_near": 0, "branches_computed": 0,
                       "branches_taken": 0.0, "control_branches_taken": 0.0}
        known = self._labelled_windows(self.window_start + max(k for k, _, _ in kept) + 1)
        for k, _, _ in kept:
            rec = self.recorded.get(k)
            if rec is None:  # the job ran no step: nothing of it was trained as it should be
                gaps = dict.fromkeys(gaps, 1.0)
                continue
            tokens, labels = rec["tokens"].cpu().numpy(), rec["labels"].cpu().numpy()
            rows_differing += sum(known.get(_digest(row)) != int(label) for row, label in zip(tokens, labels))
            self.judged["steps"] += 1
            self.judged["rows"] += len(tokens)
            before = {key: v.to(device) for key, v in rec["before"].items()}
            moments = {key: (m.to(device), v.to(device)) for key, (m, v) in rec["moments"].items()}
            tokens, labels = rec["tokens"].to(device), rec["labels"].to(device)
            masks = igloo_train.keep_masks(rec["generator"], device, tokens.shape[0], w, c["dropout"])
            ref = igloo_train.branches(before, patches, tokens, labels, masks, w, c["dropout"])
            self.judged["branches_near"] += ref.found
            self.judged["branches_computed"] += len(ref.changes)
            before64 = {key: v.double() for key, v in before.items()}
            moments64 = {key: (m.double(), v.double()) for key, (m, v) in moments.items()}
            port = (float(rec["loss"]), {key: g.to(device) for key, g in rec["grads"].items()},
                    {key: (rec["after"][key] - rec["before"][key]).to(device) for key in rec["after"]})
            low_loss, low_grads = igloo_train.loss_and_grads(before, patches, tokens, labels, masks, w, c["dropout"], tf32=True)
            low_after = igloo_train.adamw(before, low_grads, moments, rec["step"], c["learning_rate"], c["weight_decay"])
            low = (float(low_loss), low_grads, {key: low_after[key] - before[key] for key in low_after})
            for into, (loss, grads, update) in ((gaps, port), (control, low)):
                prefix = "control_" if into is control else ""
                # the reference's gradient on the branches this step took where float32 may take either
                matched, taken = igloo_train.match(grads, ref.grads, ref.changes)
                self.judged[f"{prefix}branches_taken"] += sum(taken)
                if not prefix:
                    by_layer = self.judged.setdefault("branches_taken_by_layer", {})
                    for (layer, *_), share in zip(ref.decisions, taken):
                        by_layer[layer] = by_layer.get(layer, 0) + (share > 0.5)
                # AdamW in float64 on the gradient the step computed, which the line above holds
                own = {key: g.double() for key, g in grads.items()}
                after = igloo_train.adamw(before64, own, moments64, rec["step"], c["learning_rate"], c["weight_decay"])
                ref_update = {key: after[key] - before64[key] for key in after}
                # a change of a few spacings is float32's rounding of the stored leaf, whatever the arithmetic
                held = {key: _resolved(before[key], d) for key, d in ref_update.items()}
                if not prefix:
                    self.judged["update_share_resolved"] = sum(int(h.sum()) for h in held.values()) / sum(h.numel() for h in held.values())
                update, ref_update = ({key: d[key][held[key]] for key in held} for d in (update, ref_update))
                into["train_loss_gap"] = max(into["train_loss_gap"], abs(loss - float(ref.loss)) / abs(float(ref.loss)))
                for name, got, want in (("train_grad_gap", grads, matched), ("train_update_gap", update, ref_update)):
                    leaf_gaps = {key: _gap(got[key], want[key]) for key in want}
                    worst = max(leaf_gaps, key=leaf_gaps.get)
                    if leaf_gaps[worst] > into[name]:
                        into[name] = leaf_gaps[worst]
                        self.judged[f"{prefix}{name}_leaf"] = worst
        trained = self.counted_after["train.windows"] - self.counted_before["train.windows"]
        offered = self.held_before + sum(self.windows_of(p) for p in self.ran[self.window_start :])
        self.judged["windows_offered"] = offered
        self.judged.update({f"control_{name}": value for name, value in control.items()})
        limits = c["limits"]
        checks = {name: {"value": value, "limit": limits[name]} for name, value in gaps.items()}
        checks["window_rows_differing"] = {"value": int(rows_differing), "limit": limits["window_rows_differing"]}
        checks["windows_untrained"] = {"value": int(offered - trained - self.held_after), "limit": limits["windows_untrained"]}
        nonfinite = self.counted_after["train.nonfinite_losses"] - self.counted_before["train.nonfinite_losses"]
        checks["nonfinite_losses"] = {"value": int(nonfinite), "limit": limits["nonfinite_losses"]}
        return checks
