"""The IGLOO causal convolutions: kernels K5 (``embed_conv``, conv1) and K4
(``causal_conv``, conv2/conv3), and the gradient of conv1's table in the
training step (``embed_conv_wgrad``, K5's transpose).

Counterparts of ``genomad_tpu/ops/conv_pallas.py``. Each kernel is written
by hand for Hopper in ``genomad_torch/csrc/`` (see the note at the top of
each source) and has a plain PyTorch version beside it here. A wrapper
launches its kernel for CUDA tensors (or raises) and takes the plain version
only for tensors on the CPU. ``<wrapper>.launches`` counts kernel launches.

Both follow the rounding points of the JAX graph (``igloo._embed_onehot_conv``
/ ``igloo._causal_conv`` + ``_leaky_relu``): the conv result is rounded to the
compute dtype, the bias is added in that dtype, and LeakyReLU(0.1) is applied
in that dtype. In float32 these roundings are no-ops.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from genomad_torch.ops import _build

K_SIZE = 6
HALO = K_SIZE - 1
LEAKY_SLOPE = 0.1
N_CODE = 4  # base code of N / unknown
N_TOKENS = 4**4 + 1  # the 4-mer tokens 1..256, and 0 where a base is N
# K5's shared memory: a 128-byte channel slice of 6 x (V + 1) table rows and
# 24 staged row offsets for each of 32 warps, within the 232,448 B of a block
EMBED_SLICE_BYTES = 128
EMBED_MAX_VOCAB = (232_448 - 32 * 24 * 4) // (K_SIZE * EMBED_SLICE_BYTES) - 1

_SIGNATURES = {
    "embed_conv": {
        "embed_conv_launch": [_build.P] * 4 + [_build.I] * 5 + [_build.F, _build.I, _build.P],
        "embed_conv_bases_launch": [_build.P] * 4 + [_build.I] * 6 + [_build.F, _build.I, _build.P],
    },
    "causal_conv": {
        "causal_conv_launch": [_build.P] * 4 + [_build.I] * 4 + [_build.F, _build.I, _build.P],
    },
    "embed_conv_wgrad": {
        "embed_conv_wgrad_launch": [_build.P] * 4 + [_build.I] * 5 + [_build.P],
        "embed_conv_wgrad_max_vocab": [],
    },
}


def conv_epilogue(acc: torch.Tensor, bias: torch.Tensor, dtype, apply_leaky: bool) -> torch.Tensor:
    """f32 accumulator -> compute dtype, + bias, LeakyReLU (JAX rounding points)."""
    out = acc.to(dtype) + bias.to(dtype)
    if apply_leaky:
        slope = torch.tensor(LEAKY_SLOPE, dtype=dtype, device=out.device)
        out = torch.where(out >= 0, out, out * slope)
    return out


def _slope(dtype) -> float:
    """LeakyReLU slope as the compute dtype holds it (JAX multiplies by the
    weakly-typed 0.1 in that dtype)."""
    return float(torch.tensor(LEAKY_SLOPE, dtype=dtype))


# ---------------------------------------------------------------------------
# The 4-mer tokenizer that feeds conv1
# ---------------------------------------------------------------------------


def pad_bases(bases: torch.Tensor, length: int) -> torch.Tensor:
    """(B, n) base codes -> (B, length): N codes appended past n (the row cut
    when n > length). Padded token positions lie after the real ones and,
    the conv being causal, never influence them."""
    return F.pad(bases, (0, length - bases.shape[1]), value=N_CODE)


def tokens_from_bases(bases: torch.Tensor, word_size: int = 4) -> torch.Tensor:
    """5-ary base codes (B, n) -> tokens (B, n - word_size + 1): the k-mer
    value (2 bits per base, first base highest) of bases t..t+k-1 plus 1,
    or 0 when any of them is N (a code >= 4) (genomad/sequence.py:170-193
    semantics). int32, or int64 for words over 15 bases; the port's one
    k-mer rule (``sequence.tokenize_dna`` calls it)."""
    codes = bases.to(torch.int32 if word_size <= 15 else torch.int64)
    n_out = codes.shape[1] - word_size + 1
    token = codes[:, :n_out]
    valid = token < N_CODE
    for j in range(1, word_size):
        window = codes[:, j : j + n_out]
        valid = valid & (window < N_CODE)
        token = token * 4 + window
    return torch.where(valid, token + 1, torch.zeros_like(token))


# ---------------------------------------------------------------------------
# K5: embed_conv (conv1)
# ---------------------------------------------------------------------------


def embed_conv_plain(tokens: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor, apply_leaky: bool = True) -> torch.Tensor:
    """out[b, t] = bias + sum_k kernel[k, tokens[b, t-5+k]], causal positions
    (t-5+k < 0) adding nothing; f32 sum, rounded as in the JAX graph."""
    k_size, vocab, channels = kernel.shape
    length = tokens.shape[1]
    # row `vocab` of each tap is the causal zero padding
    table = torch.cat([kernel.float(), kernel.new_zeros((k_size, 1, channels), dtype=torch.float32)], dim=1)
    padded = F.pad(tokens.long(), (k_size - 1, 0), value=vocab)
    acc = table[0][padded[:, :length]]
    for k in range(1, k_size):
        acc = acc + table[k][padded[:, k : k + length]]
    return conv_epilogue(acc, bias, kernel.dtype, apply_leaky)


def embed_conv(tokens: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor, apply_leaky: bool = True) -> torch.Tensor:
    """First-layer causal one-hot conv + bias (+ LeakyReLU).

    tokens: (B, L) int32 in [0, V); kernel: (6, V, C) float32 or bfloat16;
    bias: (C,) of the kernel's dtype. Returns (B, L, C) in the kernel's dtype.
    The kernel trusts the token range; the model's tokenizer produces
    [0, 256] for the 257-row vocabulary. On the card V <= EMBED_MAX_VOCAB
    and C is a multiple of 64 (bf16) or 32 (f32): see :func:`_check_embed`.
    """
    if not _build.on_cuda(tokens, kernel, bias):
        return embed_conv_plain(tokens, kernel, bias, apply_leaky)
    _build.refuse_grad("embed_conv", tokens, kernel, bias)
    _build.require(tokens.dim() == 2 and tokens.dtype == torch.int32, "tokens must be (B, L) int32")
    _build.require(tokens.is_contiguous(), "inputs must be contiguous")
    V, C = _check_embed(kernel, bias)
    B, L = tokens.shape
    out = torch.empty((B, L, C), dtype=kernel.dtype, device=tokens.device)
    if out.numel() == 0:
        return out
    lib = _build.load("embed_conv", _SIGNATURES["embed_conv"])
    with torch.cuda.device(tokens.device):
        err = lib.embed_conv_launch(
            tokens.data_ptr(), kernel.data_ptr(), bias.data_ptr(), out.data_ptr(),
            B, L, V, C, int(kernel.dtype == torch.bfloat16), _slope(kernel.dtype), int(apply_leaky),
            _build.stream_ptr(tokens.device),
        )
    _build.check(err, "embed_conv")
    embed_conv.launches += 1
    return out


embed_conv.launches = 0


def embed_conv_bases_plain(bases: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor, length: int, apply_leaky: bool = True) -> torch.Tensor:
    """conv1 on base codes: :func:`embed_conv_plain` on the tokens of the
    port's tokenizer, each row N-padded (or cut) to ``length + 3`` bases."""
    return embed_conv_plain(tokens_from_bases(pad_bases(bases, length + 3)), kernel, bias, apply_leaky)


def embed_conv_bases(bases: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor, length: int, apply_leaky: bool = True) -> torch.Tensor:
    """First-layer conv fed with base codes, the 4-mer tokenizer fused into
    the kernel: (B, n) codes (ACGT = 0..3, anything >= 4 N; bases past n are
    N) -> (B, length, C) in the kernel's dtype, equal to
    ``embed_conv(tokens_from_bases(pad_bases(bases, length + 3)), ...)``.

    On the card the kernel takes uint8 codes, as the nn pipeline sends them,
    and a table of V >= 257 rows (the tokens are [0, 256]); the table checks
    are K5's (:func:`_check_bases`).
    """
    if not _build.on_cuda(bases, kernel, bias):
        return embed_conv_bases_plain(bases, kernel, bias, length, apply_leaky)
    _build.refuse_grad("embed_conv_bases", bases, kernel, bias)
    V, C = _check_bases(bases, kernel, bias, length)
    B, n = bases.shape
    out = torch.empty((B, length, C), dtype=kernel.dtype, device=bases.device)
    if out.numel() == 0:
        return out
    lib = _build.load("embed_conv", _SIGNATURES["embed_conv"])
    with torch.cuda.device(bases.device):
        err = lib.embed_conv_bases_launch(
            bases.data_ptr(), kernel.data_ptr(), bias.data_ptr(), out.data_ptr(),
            B, n, length, V, C, int(kernel.dtype == torch.bfloat16), _slope(kernel.dtype), int(apply_leaky),
            _build.stream_ptr(bases.device),
        )
    _build.check(err, "embed_conv_bases")
    embed_conv_bases.launches += 1
    return out


embed_conv_bases.launches = 0


def _check_bases(bases: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor, length: int) -> tuple[int, int]:
    """The checks the bases form makes before it launches: K5's on the
    table, and uint8 codes (no quiet cast). Returns (V, C)."""
    _build.require(bases.dim() == 2 and bases.dtype == torch.uint8, "bases must be (B, n) uint8 codes")
    _build.require(bases.is_contiguous(), "inputs must be contiguous")
    _build.require(length >= 0, "length must be >= 0")
    V, C = _check_embed(kernel, bias)
    _build.require(V >= N_TOKENS, f"the 4-mer tokens need V >= {N_TOKENS}")
    return V, C


def _check_embed(kernel: torch.Tensor, bias: torch.Tensor) -> tuple[int, int]:
    """The checks K5 makes on its table before it launches: returns (V, C).
    A block keeps one 128-byte channel slice of all six taps in shared
    memory, so V is bounded, C is a whole number of slices and the table is
    copied in 16-byte pieces."""
    _build.require(kernel.dim() == 3 and kernel.shape[0] == K_SIZE, "kernel must be (6, V, C)")
    _build.require(kernel.dtype in _build.DTYPES and bias.dtype == kernel.dtype, "kernel/bias must share a float32 or bfloat16 dtype")
    _build.require(bias.shape == (kernel.shape[2],), "bias must be (C,)")
    _build.require(kernel.is_contiguous() and bias.is_contiguous(), "inputs must be contiguous")
    _, V, C = kernel.shape
    _build.require(1 <= V <= EMBED_MAX_VOCAB, f"the kernel takes V <= {EMBED_MAX_VOCAB} (its table slice lives in shared memory)")
    per_slice = EMBED_SLICE_BYTES // kernel.element_size()
    _build.require(C > 0 and C % per_slice == 0, f"the {kernel.dtype} kernel takes C a multiple of {per_slice}")
    _build.require(kernel.data_ptr() % 16 == 0, "the kernel takes a 16-byte aligned table")
    return V, C


# ---------------------------------------------------------------------------
# conv1's gradient in the training step: embed_conv_wgrad
# ---------------------------------------------------------------------------


def embed_conv_wgrad_plain(tokens: torch.Tensor, dout: torch.Tensor, vocab: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The gradient of :func:`embed_conv_plain`'s table and bias (no
    LeakyReLU) for ``dout`` (B, L, C): dW[k, v] = sum of dout[b, t] over
    the positions with tokens[b, t-5+k] = v, causal positions adding to a
    discarded row V; dbias = sum_v dW[5, v]. ``index_add_`` a tap, in tap
    order, in dout's dtype (float32 below it)."""
    length, channels = dout.shape[1], dout.shape[2]
    padded = F.pad(tokens.long(), (HALO, 0), value=vocab)
    flat = dout.reshape(-1, channels)
    if flat.dtype not in (torch.float32, torch.float64):
        flat = flat.float()
    dw = flat.new_zeros((K_SIZE, vocab + 1, channels))
    for k in range(K_SIZE):
        dw[k].index_add_(0, padded[:, k : k + length].reshape(-1), flat)
    dw = dw[:, :vocab]
    return dw, dw[HALO].sum(0)


def embed_conv_wgrad(tokens: torch.Tensor, dout: torch.Tensor, vocab: int) -> tuple[torch.Tensor, torch.Tensor]:
    """conv1's table and bias gradients, (6, V, C) and (C,), from the
    gradient ``dout`` (B, L, C) of its output before the LeakyReLU:
    :func:`embed_conv_wgrad_plain`'s sums, bitwise the same from run to run.

    tokens: (B, L) int32 in [0, vocab), as K5 takes them (trusted);
    dout: float32, contiguous. On the card C is a multiple of 32 and
    vocab at most the kernel's bound (its accumulator slice lives in shared
    memory): see :func:`_check_wgrad`.
    """
    if not _build.on_cuda(tokens, dout):
        return embed_conv_wgrad_plain(tokens, dout, vocab)
    B, L, C, per_slice = _check_wgrad(tokens, dout, vocab)
    plane = (K_SIZE * vocab + 1) * C  # dW, then dbias
    out = torch.empty(plane, dtype=torch.float32, device=dout.device)
    dw, dbias = out[: plane - C].view(K_SIZE, vocab, C), out[plane - C :]
    if B * L == 0:
        return dw.zero_(), dbias.zero_()
    partial = torch.empty((per_slice, plane), dtype=torch.float32, device=dout.device)
    lib = _build.load("embed_conv_wgrad", _SIGNATURES["embed_conv_wgrad"])
    with torch.cuda.device(dout.device):
        err = lib.embed_conv_wgrad_launch(
            tokens.data_ptr(), dout.data_ptr(), partial.data_ptr(), out.data_ptr(),
            B, L, vocab, C, per_slice, _build.stream_ptr(dout.device),
        )
    _build.check(err, "embed_conv_wgrad")
    embed_conv_wgrad.launches += 1
    return dw, dbias


embed_conv_wgrad.launches = 0

WGRAD_SLICE = 32  # the kernel's channels a block


def _check_wgrad(tokens: torch.Tensor, dout: torch.Tensor, vocab: int) -> tuple[int, int, int, int]:
    """The checks the gradient kernel makes before it launches. Returns
    (B, L, C, blocks a channel slice): each slice gets its share of the
    SMs."""
    _build.require(tokens.dim() == 2 and tokens.dtype == torch.int32, "tokens must be (B, L) int32")
    _build.require(dout.dim() == 3 and dout.shape[:2] == tokens.shape, "dout must be (B, L, C) for (B, L) tokens")
    _build.require(dout.dtype == torch.float32, "the gradient kernel takes float32")
    _build.require(tokens.is_contiguous() and dout.is_contiguous(), "inputs must be contiguous")
    _build.require(dout.data_ptr() % 16 == 0, "the gradient kernel takes a 16-byte aligned dout")
    B, L, C = dout.shape
    _build.require(C > 0 and C % WGRAD_SLICE == 0, f"the gradient kernel takes C a multiple of {WGRAD_SLICE}")
    lib = _build.load("embed_conv_wgrad", _SIGNATURES["embed_conv_wgrad"])
    max_vocab = lib.embed_conv_wgrad_max_vocab()
    _build.require(1 <= vocab <= max_vocab, f"the gradient kernel takes V <= {max_vocab} (its accumulator slice lives in shared memory)")
    sms = torch.cuda.get_device_properties(dout.device).multi_processor_count
    return B, L, C, max(1, sms // (C // WGRAD_SLICE))


# ---------------------------------------------------------------------------
# K4: causal_conv (conv2 / conv3)
# ---------------------------------------------------------------------------


def causal_conv_plain(x: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor, apply_leaky: bool = True) -> torch.Tensor:
    """out[b, t] = bias + sum_k x[b, t-5+k] @ kernel[k] (zero rows before
    t = 0); f32 products and sums, rounded as in the JAX graph."""
    k_size = kernel.shape[0]
    length = x.shape[1]
    xp = F.pad(x.float(), (0, 0, k_size - 1, 0))
    w = kernel.float()
    acc = torch.matmul(xp[:, :length], w[0])
    for k in range(1, k_size):
        acc = acc + torch.matmul(xp[:, k : k + length], w[k])
    return conv_epilogue(acc, bias, x.dtype, apply_leaky)


def causal_conv(x: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor, apply_leaky: bool = True) -> torch.Tensor:
    """Width-6 causal conv + bias (+ LeakyReLU): (B, L, C) -> (B, L, C).

    kernel: (6, C, C) in x's dtype (float32 or bfloat16); bias: (C,). The
    bf16 kernel takes C = 128, the f32 kernel C <= 332.
    """
    if not _build.on_cuda(x, kernel, bias):
        return causal_conv_plain(x, kernel, bias, apply_leaky)
    _build.refuse_grad("causal_conv", x, kernel, bias)
    B, L, C = _check(x, kernel, bias)
    out = torch.empty_like(x)
    if out.numel() == 0:
        return out
    lib = _build.load("causal_conv", _SIGNATURES["causal_conv"])
    with torch.cuda.device(x.device):
        err = lib.causal_conv_launch(
            x.data_ptr(), kernel.data_ptr(), bias.data_ptr(), out.data_ptr(),
            B, L, C, int(x.dtype == torch.bfloat16), _slope(x.dtype), int(apply_leaky),
            _build.stream_ptr(x.device),
        )
    _build.check(err, "causal_conv")
    causal_conv.launches += 1
    return out


causal_conv.launches = 0


def _check(x: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor) -> tuple[int, int, int]:
    """The checks K4 makes before it launches: returns (B, L, C)."""
    _build.require(x.dim() == 3, "x must be (B, L, C)")
    B, L, C = x.shape
    _build.require(kernel.shape == (K_SIZE, C, C), "kernel must be (6, C, C)")
    _build.require(bias.shape == (C,), "bias must be (C,)")
    _build.require(x.dtype in _build.DTYPES and kernel.dtype == x.dtype and bias.dtype == x.dtype, "x/kernel/bias must share a float32 or bfloat16 dtype")
    _build.require(all(t.is_contiguous() for t in (x, kernel, bias)), "inputs must be contiguous")
    if x.dtype == torch.bfloat16:
        _build.require(C == _build.TC_CHANNELS, f"the bf16 kernel takes C = {_build.TC_CHANNELS}")
        # its TMA and 16-byte copies read x and the kernel at 16-byte boundaries
        _build.require(all(t.data_ptr() % 16 == 0 for t in (x, kernel, bias)), "the bf16 kernel takes 16-byte aligned inputs")
    else:
        _build.require((32 + HALO) * C * 4 <= 48 * 1024, "the f32 kernel takes C <= 332")
    return B, L, C
