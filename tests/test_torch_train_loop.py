"""The port's training loop (``genomad_torch.train.Trainer``) on the CPU: its
step against the plain float32 reference ``benchmark/reference/igloo_train.py``
(loss, every leaf's gradient, the AdamW update), the labels from contig
names, every window trained once across calls with the carry, the shuffle
set by the seed, and its spans and counters. Small widths (8 channels, 32
patches, dense 16) at the published window of 5,997 tokens."""

import dataclasses

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from benchmark.reference import igloo as ref_igloo
from benchmark.reference import igloo_train as ref_train
from genomad_torch import trace
from genomad_torch import train as ttrain
from genomad_torch.models import igloo as tig
from genomad_torch.ops import nn_pipeline

torch.set_num_threads(2)

W = ref_igloo.Widths(window_bp=6000, min_window_bp=2500, max_window_ns=4000, tokens=5997, vocab=257, channels=8,
                     conv_width=6, igloo_blocks=2, patches=32, patch_size=4, pool=8, dense=16, classes=3)
LR, WD, RATE = 1e-3, 1e-3, 0.2
# the CPU step against the reference: the same float32 arithmetic in other
# orders (a gather against a one-hot convolution, a scatter against its
# gradient); AdamW divides each gradient by its own root mean square, so a
# gradient's rounding near 0 moves its update the most
LOSS_RTOL, GRAD_RTOL, UPDATE_RTOL = 1e-5, 1e-4, 1e-3


def _write_fasta(path, contigs):
    with open(path, "w") as f:
        for name, seq in contigs:
            f.write(f">{name}\n{seq}\n")
    return path


def _contigs(seed, lengths, classes=ttrain.CLASSES):
    rng = np.random.default_rng(seed)
    return [(f"c{seed}_{i}|{classes[i % len(classes)]}", "".join(rng.choice(list("ACGT"), n))) for i, n in enumerate(lengths)]


def _trainer(batch_size, seed=0, param_seed=0, step=None):
    raw = ref_igloo.init_params(W, param_seed)
    opt = ttrain.make_optimizer(LR, WD)
    state = ttrain.init_train_state(tig.params_from_numpy(raw, torch.float32), opt, device="cpu")
    return ttrain.Trainer(state, step or ttrain.make_train_step(opt, RATE), batch_size, seed), raw


def _recording_step():
    """A step that trains nothing and keeps each batch's rows."""
    seen = []

    def step(state, tokens, labels, generator):
        seen.append((tokens.clone(), labels.clone()))
        return state, torch.zeros(())

    return step, seen


def _leaves(state):
    return {f"{g}/{n}": p for g, sub in state.trainable.items() for n, p in sub.items()}


def _rel(got, want):
    return float(torch.linalg.vector_norm(got.double() - want.double()) / torch.linalg.vector_norm(want.double()))


@pytest.mark.parametrize("batch, steps_before", [(2, 0), (4, 0), (4, 2)])
def test_the_loops_step_equals_the_reference(tmp_path, batch, steps_before):
    """The step the loop runs (after ``steps_before`` steps, so that AdamW's
    moments are not zero) against the reference's recomputation from the
    same leaves and moments, with the keep masks of the same generator."""
    trainer, raw = _trainer(batch, seed=3, param_seed=batch)
    fasta = _write_fasta(tmp_path / "a.fna", _contigs(1, [6000] * (batch * (steps_before + 1))))
    batches = trainer.batches(fasta)
    for b in batches[:steps_before]:
        trainer.state, _ = trainer.step(trainer.state, b.tokens, b.labels, trainer.generator)
    state, b = trainer.state, batches[steps_before]
    leaves = _leaves(state)
    before = {k: p.detach().clone() for k, p in leaves.items()}
    moments = {k: (state.optimizer.state[p]["exp_avg"].clone(), state.optimizer.state[p]["exp_avg_sq"].clone())
               for k, p in leaves.items() if steps_before}
    masks = ref_train.keep_masks(trainer.generator.get_state(), "cpu", batch, W, RATE)
    trainer.state, loss = trainer.step(state, b.tokens, b.labels, trainer.generator)

    _, patches = ref_train.fold(raw, W)
    ref_loss, ref_grads = ref_train.loss_and_grads(before, patches, b.tokens, b.labels, masks, W, RATE)
    ref_after = ref_train.adamw(before, ref_grads, moments, steps_before, LR, WD)
    assert float(loss) == pytest.approx(float(ref_loss), rel=LOSS_RTOL)
    assert set(leaves) == set(ref_train.LEAVES)
    for k, p in leaves.items():
        assert _rel(p.grad, ref_grads[k]) <= GRAD_RTOL, k
        assert _rel(p.detach() - before[k], ref_after[k] - before[k]) <= UPDATE_RTOL, k


def test_the_reference_fold_is_the_ports():
    raw = ref_igloo.init_params(W, 4)
    leaves, patches = ref_train.fold(raw, W)
    port = tig.params_from_numpy(raw, torch.float32)
    for key, value in leaves.items():
        group, name = key.split("/")
        np.testing.assert_allclose(port[group][name].numpy(), value, rtol=1e-6, atol=1e-7, err_msg=key)
    for g, positions in patches.items():
        np.testing.assert_array_equal(port[g]["patches"].numpy(), positions)


def test_labels_come_from_contig_names(tmp_path):
    assert [ttrain.contig_label(n) for n in ("a|chromosome", "b|plasmid", "x|y|virus")] == [0, 1, 2]
    for bad in ("c1", "c1|phage", "virus|c1"):
        with pytest.raises(ValueError):
            ttrain.contig_label(bad)
    step, seen = _recording_step()
    trainer, _ = _trainer(3, step=step)
    contigs = _contigs(2, [6000] * 6, classes=("virus", "chromosome", "plasmid"))
    trainer.fit(_write_fasta(tmp_path / "a.fna", contigs))
    label_of = {}
    for name, seq in contigs:
        tok = ref_igloo.tokens(torch.as_tensor(ref_igloo._CODES[np.frombuffer(seq.encode(), np.uint8)][None]))[0]
        label_of[tok.numpy().astype(np.int32).tobytes()] = ("chromosome", "plasmid", "virus").index(name.rsplit("|", 1)[1])
    rows = [(t.numpy().astype(np.int32).tobytes(), int(lab)) for tokens, labels in seen for t, lab in zip(tokens, labels)]
    assert len(rows) == 6 and all(label_of[t] == lab for t, lab in rows)


def test_every_window_is_trained_once_across_calls(tmp_path):
    """7 windows then 6 at batch 4: one batch and 3 held, then two batches
    and 1 held; every window in exactly one batch or the carry, and the
    counters say so."""
    step, seen = _recording_step()
    trainer, _ = _trainer(4, step=step)
    first = _contigs(3, [6000, 6000, 15000, 9000])  # 1 + 1 + 3 (the last of 3,000 bp) + 2 windows
    second = _contigs(4, [18000, 12000, 3000])  # 3 + 2 + 1
    before = {k: trace.COUNTERS[k] for k in ("train.steps", "train.windows", "train.bp")}
    assert trainer.fit(_write_fasta(tmp_path / "a.fna", first)) == 1 and trainer.held == 3
    assert trainer.fit(_write_fasta(tmp_path / "b.fna", second)) == 2 and trainer.held == 1
    all_windows = np.concatenate([nn_pipeline.encode_windows(tmp_path / f)[0] for f in ("a.fna", "b.fna")])
    assert len(all_windows) == 13
    tokens = ref_igloo.tokens(torch.as_tensor(all_windows)).numpy().astype(np.int32)
    trained = [t.numpy().astype(np.int32).tobytes() for batch, _ in seen for t in batch]
    held = ref_igloo.tokens(torch.as_tensor(trainer._held[0])).numpy().astype(np.int32)
    assert sorted(trained + [h.tobytes() for h in held]) == sorted(t.tobytes() for t in tokens)
    assert len(set(trained)) == len(trained) == 12
    counted = {k: trace.COUNTERS[k] - v for k, v in before.items()}
    bp_held = int(trainer._held[2].sum())
    assert counted == {"train.steps": 3, "train.windows": 12, "train.bp": 6000 * 2 + 15000 + 9000 + 18000 + 12000 + 3000 - bp_held}


def test_the_shuffle_is_set_by_the_seed(tmp_path):
    """A call's batches are ``make_batches``' over its windows, from
    ``(seed, call)``; the same seed gives the same batches."""
    fasta = _write_fasta(tmp_path / "a.fna", _contigs(5, [6000] * 11))
    bases, names, ids = nn_pipeline.encode_windows(fasta)
    labels = np.array([ttrain.contig_label(str(n)) for n in names])[ids]
    runs = []
    for seed in (7, 7, 8):
        step, seen = _recording_step()
        trainer, _ = _trainer(4, seed=seed, step=step)
        trainer.fit(fasta)
        runs.append([b.numpy().tobytes() for b, _ in seen])
    assert runs[0] == runs[1] and runs[0] != runs[2]
    want = [ref_igloo.tokens(torch.as_tensor(b)).numpy().astype(np.int32).tobytes()
            for b, _ in ttrain.make_batches(bases, labels, 4, seed=(7, 0))]
    assert len(want) == 2 and runs[0] == want


def test_spans_and_counters_under_a_profiler(tmp_path):
    fasta = _write_fasta(tmp_path / "a.fna", _contigs(6, [6000] * 5))
    trainer, _ = _trainer(2)
    before = {k: trace.COUNTERS[k] for k in ("train.steps", "train.windows", "train.bp", "train.nonfinite_losses")}
    trace.clear()
    trainer.fit(fasta)
    assert trace.spans() == []  # no profiler: nothing recorded
    with profile(activities=[ProfilerActivity.CPU]):
        trainer.fit(fasta)
    names = [s.name for s in trace.spans()]
    assert names.count("train.batches") == 1 and names.count("train.step") == 3  # 1 held + 5 windows: 3 batches of 2
    for inner in ("train.forward", "train.backward", "train.optimizer"):
        assert names.count(inner) == 3
    by_id = {s.id: s for s in trace.spans()}
    assert all(by_id[s.parent].name == "train.step" for s in trace.spans() if s.name in ("train.forward", "train.optimizer"))
    counted = {k: trace.COUNTERS[k] - v for k, v in before.items()}
    assert counted == {"train.steps": 5, "train.windows": 10, "train.bp": 60000, "train.nonfinite_losses": 0}


def test_nonfinite_losses_are_counted_on_the_device_once_a_call(tmp_path, monkeypatch):
    losses = iter([0.5, float("nan"), float("inf"), 0.25])

    def step(state, tokens, labels, generator):
        return state, torch.tensor(next(losses))

    trainer, _ = _trainer(2, step=step)
    reads = []
    original = torch.Tensor.item
    monkeypatch.setattr(torch.Tensor, "item", lambda t: reads.append(t.shape) or original(t))
    before = trace.COUNTERS["train.nonfinite_losses"]
    assert trainer.fit(_write_fasta(tmp_path / "a.fna", _contigs(7, [6000] * 8))) == 4
    assert trace.COUNTERS["train.nonfinite_losses"] - before == 2
    assert reads == [torch.Size([])]  # one read for the call's four steps


def test_a_window_of_a_contig_keeps_its_own_bases():
    """``train.bp`` of a window: 6,000, less the padding of a contig's last one."""
    bases = np.full((4, 10), 4, np.uint8)
    bases[0], bases[1, :7], bases[2, :10], bases[3, :3] = 0, 1, 2, 3
    bases[2, 8] = 4  # an N inside a contig's window, which is no padding
    bases[1, 3] = 4
    assert ttrain._window_bp(bases, np.array([0, 0, 1, 1])).tolist() == [10, 7, 10, 3]


def test_the_widths_of_the_reference_are_the_published_ones():
    """The configuration's widths, which the reference and the check read."""
    from benchmark import manifest as mf

    w = ref_igloo.widths(mf.config("genomad-train"))
    published = dataclasses.replace(W, channels=tig.CHANNELS, patches=tig.N_PATCHES, dense=tig.ENC_DIM)
    assert w == published and w.pooled == tig.POOLED_LEN
