"""The ``train`` entry (cell ``train.igloo-b64``) at small widths on the CPU:
the sound run comes out correct, with the control (the reference with TF32
rounding) above a limit; runs with the port's training path broken
underneath come out not correct; a port without the loop fails before any
work; the cell's metric readers read a hand-built window."""

import numpy as np
import pytest
import torch

from benchmark import manifest as mf
from benchmark import run, tracing
from benchmark.reference import igloo

CELL = "train.igloo-b64"
TINY_WIDTHS = {"channels": 8, "patches": 32, "dense": 16, "batch_size": 4}
TINY = {"config": {**TINY_WIDTHS, "sample_mbp": 0.05, "check_jobs_within": 2},
        "traffic": {"pool_jobs": 2, "warm_up_mbp": 0.02}}


@pytest.fixture
def train_run(tmp_path, monkeypatch):
    """run_cell of the train cell at TINY sizes on the CPU, one job in the
    window, from the reference's seed-0 weights at those widths in place of
    the port's published-width fallback."""
    from genomad_torch.models import weights

    torch.set_num_threads(4)
    w = igloo.widths({**mf.config("genomad-train"), **TINY_WIDTHS})
    monkeypatch.setattr(weights, "load_params", lambda console=None: igloo.init_params(w, 0))
    runs = iter(range(100))

    def go(seed=5):
        return run.run_cell(CELL, seed, 0.01, False, device="cpu", overrides=TINY, workdir=tmp_path / f"run{next(runs)}")

    return go


def _over(result, name):
    c = result["checks"][name]
    return not result["correct"] and c["value"] > c["limit"]


def test_the_sound_run_is_correct_and_the_control_is_not(train_run):
    result = train_run()
    assert result["correct"], result["checks"]
    assert result["attempted"] == 1 and result["judged"]["steps"] == 1 and result["judged"]["rows"] == 4
    limits = mf.config("genomad-train")["limits"]
    judged = result["judged"]
    assert any(judged[f"control_{n}"] > limits[n] for n in ("train_grad_gap", "train_update_gap")), judged
    assert {"setup_s", "nn_mbp_per_s"} <= set(result["metrics"])


class _ScaleGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return x.clone()

    @staticmethod
    def backward(ctx, grad):
        return grad * (1 + 1e-3)


def test_one_leafs_gradient_scaled(train_run, monkeypatch):
    from genomad_torch import train

    original = train.loss_fn

    def scaled(trainable, static, *a, **k):
        t = {g: dict(sub) for g, sub in trainable.items()}
        t["head_dense"]["kernel"] = _ScaleGrad.apply(t["head_dense"]["kernel"])
        return original(t, static, *a, **k)

    monkeypatch.setattr(train, "loss_fn", scaled)
    assert _over(train_run(), "train_grad_gap")


def test_the_optimizer_step_skipped(train_run, monkeypatch):
    monkeypatch.setattr(torch.optim.AdamW, "step", lambda self, closure=None: None)
    assert _over(train_run(), "train_update_gap")


def test_one_window_dropped_from_a_batch(train_run, monkeypatch):
    from genomad_torch import train

    original = train.Trainer.batches

    def fewer(self, fasta):
        out = original(self, fasta)
        if out:
            out[0] = out[0]._replace(tokens=out[0].tokens[1:], labels=out[0].labels[1:])
        return out

    monkeypatch.setattr(train.Trainer, "batches", fewer)
    assert _over(train_run(), "windows_untrained")


def test_the_port_in_bfloat16(train_run, monkeypatch):
    """The training forward's leaves rounded to bfloat16 (the gradients
    flow back to the float32 leaves)."""
    from genomad_torch.models import igloo as port_igloo

    original = port_igloo.apply_train

    def bf16(params, *a, **k):
        low = {g: sub if not isinstance(sub, dict) else {n: t.to(torch.bfloat16) if t.is_floating_point() else t for n, t in sub.items()}
               for g, sub in params.items()}
        return original(low, *a, **k).float()

    monkeypatch.setattr(port_igloo, "apply_train", bf16)
    result = train_run()
    assert _over(result, "train_grad_gap") and _over(result, "train_loss_gap")


def test_a_label_altered_where_it_is_produced(train_run, monkeypatch):
    from genomad_torch import train

    original = train.contig_label
    monkeypatch.setattr(train, "contig_label", lambda name: (original(name) + 1) % 3)
    assert _over(train_run(), "window_rows_differing")


def test_a_port_without_the_loop_fails_before_any_work(train_run, monkeypatch, tmp_path):
    from benchmark import generator
    from genomad_torch import train

    monkeypatch.delattr(train, "Trainer")
    monkeypatch.setattr(generator, "make_pool", lambda *a, **k: pytest.fail("the pool was made"))
    with pytest.raises(ImportError):
        train_run()


def test_the_cells_readers_read_a_window():
    """A window of 10 s with 1,000 windows trained and 4 Mbp, 6 s busy on
    the card (2 s of it in GEMMs), and 0.5 s of the port's input span."""
    from genomad_torch import trace

    w = igloo.widths(mf.config("genomad-train"))
    trace.clear()
    span = trace.Span("train.batches", {})
    span.id, span.parent, span.job, span.thread, span.t0, span.t1 = 1, None, 1, 0, 101.0, 101.5
    trace._BUFFER.append(span)
    ops = [("sm90_xmma_gemm_f32f32_f32f32_f32_nn_n", 100.0, 102.0), ("elementwise_kernel", 102.0, 106.0)]
    ctx = run.Context(tracing.Spans(), tracing.DeviceTrace(ops, 100.0, 110.0), {"stats.train.windows": 1000.0}, 4.0, 0, 10.0, w)
    read = {m: mf.metric_reader(m)(ctx) for m in ("train.step_mfu", "train.device_idle_share", "train.input_s_per_mbp", "train.gemm_share")}
    trace.clear()
    from benchmark import peaks

    assert read["train.step_mfu"] == pytest.approx(100 * 3 * peaks.igloo_forward_flops(w, 1000) / peaks.PEAK_F32_FLOPS / 10.0)
    assert 1.2 < read["train.step_mfu"] < 1.3  # 2.77 GFLOP a window, x 3, 100 windows a second, at 67 TFLOP/s
    assert read["train.device_idle_share"] == pytest.approx(40.0)
    assert read["train.input_s_per_mbp"] == pytest.approx(0.125)
    assert read["train.gemm_share"] == pytest.approx(100 * 2 / 6)
    assert np.isfinite(list(read.values())).all()


def _straight_through(z, out, slope):
    """``out``'s value with the derivative of a (leaky) ReLU of ``z``."""
    d = torch.where(z > 0, 1.0, slope).to(z.dtype)
    return d, lambda d: out.detach() + d * (z - z.detach())


@pytest.mark.parametrize("layer", ["enc_dense", "head_dense", "conv1", "conv2", "igloo1", "igloo2"])
def test_a_decision_taken_the_other_way_is_matched(layer, monkeypatch):
    """A step whose one decision went the other way (its derivative flipped,
    every value kept): the reference's change for that decision explains its
    gradient, and no other change is taken."""
    from benchmark.reference import igloo_train as it

    torch.manual_seed(0)
    w = igloo.widths({**mf.config("genomad-train"), **TINY_WIDTHS})
    leaves, patches = it.fold(igloo.init_params(w, 3), w)
    leaves = {k: torch.as_tensor(v) for k, v in leaves.items()}
    batch = 4
    tokens = torch.randint(0, w.vocab - 1, (batch, w.tokens))
    labels = torch.tensor([0, 1, 2, 1])
    masks = it.keep_masks(torch.Generator().manual_seed(1).get_state(), "cpu", batch, w, 0.2)
    ref = it.branches(leaves, patches, tokens, labels, masks, w, 0.2, tie=float("inf"), most=1)
    k = [d[0] for d in ref.decisions].index(layer)
    _, b, at, runner_up = ref.decisions[k]

    if layer.startswith("igloo"):
        real, nth = torch.Tensor.amax, it.BLOCKS.index(layer)

        def flip(z, out):
            pick = z.argmax(2)
            pick[(b, at[0], at[2])] = runner_up[1]
            chosen = z.gather(2, pick[:, :, None]).squeeze(2)
            return out.detach() + chosen - chosen.detach()

        owner, name = torch.Tensor, "amax"
    else:
        dense = layer.endswith("_dense")
        owner, name = (torch, "relu") if dense else (it.F, "leaky_relu")
        real = getattr(owner, name)
        nth = ("enc_dense", "head_dense").index(layer) if dense else it.DECIDING.index(layer)
        slope = 0.0 if dense else it.LEAKY_SLOPE

        def flip(z, out):
            d, through = _straight_through(z, out, slope)
            d[(b, *at)] = 1 + slope - d[(b, *at)]
            return through(d)

    calls = []

    def flipped(z, *a, **kw):
        out = real(z, *a, **kw)
        calls.append(1)
        return flip(z, out) if len(calls) == nth + 1 else out

    monkeypatch.setattr(owner, name, flipped)
    _, got = it.loss_and_grads(leaves, patches, tokens, labels, masks, w, 0.2)
    monkeypatch.undo()
    matched, taken = it.match(got, ref.grads, ref.changes)

    def worst(want):
        return max(float(torch.linalg.vector_norm(got[n] - want[n]) / torch.linalg.vector_norm(want[n])) for n in it.LEAVES)

    assert taken[k] == pytest.approx(1.0, abs=1e-3)
    assert max(abs(c) for i, c in enumerate(taken) if i != k) < 1e-3
    assert worst(ref.grads) > 1e-4 and worst(matched) < 1e-5
