"""conv1's gradient kernel (``conv.embed_conv_wgrad``, csrc/embed_conv_wgrad.cu)
on the card: against its plain version at the training cell's shapes and at
the edges of its schedule (tokens as ``chip_smoke.train_windows`` makes
them: N runs, padding past a contig's end, an all-N row), bitwise
repeatable, and a training step on the card against the same step on the
CPU. Marked ``chip``: they skip without a card. On the card (no JAX there,
so without the repository's conftest):

    python -m pytest --noconftest tests/test_torch_wgrad.py -m chip -q

The CPU tests of the plain pair and the autograd Function are in
tests/test_torch_train.py."""

import numpy as np
import pytest
import torch

from chip_smoke import WGRAD_REL_L2, rel_l2, train_windows
from genomad_torch import trace
from genomad_torch.ops import conv

# as tests/test_torch_train.py: the step's gradients on two devices
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.chip
@pytest.mark.parametrize("B, L, V, C", [(64, 5997, 257, 128), (1, 5997, 257, 128), (3, 1001, 257, 64), (4, 5, 9, 32), (2, 1, 257, 32)])
def test_wgrad_kernel_equals_the_exact_sums(B, L, V, C):
    dev = _card()
    tokens = train_windows(np.random.default_rng([B, L]), B, L).to(dev)
    tokens = torch.where(tokens < V, tokens, tokens % V).contiguous()
    dout = torch.randn((B, L, C), generator=torch.Generator(device=dev).manual_seed(L), device=dev)
    dw, dbias = conv.embed_conv_wgrad(tokens, dout, V)
    exact_dw, exact_db = conv.embed_conv_wgrad_plain(tokens, dout.double(), V)
    assert dw.shape == (6, V, C) and dbias.shape == (C,)
    assert rel_l2(dw, exact_dw) <= WGRAD_REL_L2
    assert rel_l2(dbias, exact_db) <= WGRAD_REL_L2


@pytest.mark.chip
def test_wgrad_kernel_is_bitwise_repeatable():
    dev = _card()
    tokens = train_windows(np.random.default_rng(1), 64, 5997).to(dev)
    dout = torch.randn((64, 5997, 128), device=dev)
    launches = conv.embed_conv_wgrad.launches
    first, again = conv.embed_conv_wgrad(tokens, dout, 257), conv.embed_conv_wgrad(tokens, dout, 257)
    assert conv.embed_conv_wgrad.launches == launches + 2
    assert torch.equal(first[0], again[0]) and torch.equal(first[1], again[1])


@pytest.mark.chip
def test_k5_still_refuses_a_table_that_requires_grad():
    dev = _card()
    tokens = torch.zeros((2, 64), dtype=torch.int32, device=dev)
    kernel = torch.zeros((6, 257, 128), device=dev, requires_grad=True)
    with pytest.raises(RuntimeError, match="no backward"):
        conv.embed_conv(tokens, kernel, torch.zeros(128, device=dev))


@pytest.mark.chip
def test_a_training_step_on_the_card_equals_the_cpu_step():
    """One full-width float32 step (dropout 0) at B = 2 on the card, conv1's
    backward through the kernel, against the CPU's plain pair."""
    from genomad_torch import train
    from genomad_torch.device import disable_tf32
    from genomad_torch.models import igloo

    _card()
    disable_tf32()
    raw = igloo.init_params(0)
    tokens = train_windows(np.random.default_rng(5), 3, igloo.WINDOW_TOKENS)[1:]  # N runs; row 1 a contig's end
    labels = torch.tensor([0, 2])
    out = {}
    for device in ("cuda", "cpu"):
        opt = train.make_optimizer(1e-3)
        state = train.init_train_state(igloo.params_from_numpy(raw, torch.float32), opt, device=device)
        before = trace.COUNTERS["conv1.wgrad_kernel"]
        state, loss = train.make_train_step(opt, dropout_rate=0.0)(state, tokens.to(device), labels.to(device), None)
        grads = {f"{g}/{n}": p.grad.detach().cpu() for g, sub in state.trainable.items() for n, p in sub.items()}
        out[device] = (float(loss), grads, trace.COUNTERS["conv1.wgrad_kernel"] - before)
    assert out["cuda"][2] == 1 and out["cpu"][2] == 0
    np.testing.assert_allclose(out["cuda"][0], out["cpu"][0], rtol=1e-5)
    for key, want in out["cpu"][1].items():
        np.testing.assert_allclose(out["cuda"][1][key].numpy(), want.numpy(), **GRAD_TOL, err_msg=key)
