"""IGLOO sequence classifier in PyTorch (port of genomad_tpu/models/igloo.py).

Inference graph, per 6,000 bp window (5,997 tokens, trunk padded to
L_PAD = 6,016 positions):

    bases (B, 6000) uint8 -> tokens (B, 6016) in [0, 256], N-padded
      | K5 embed_conv_bases: the 4-mer tokens and conv1 (one-hot(257),
      | causal, width 6) + LeakyReLU in one kernel
    h1 (B, 6016, 128) --- IGLOO kernel 1 (K2 fused_reduce + attention) ---.
      | K4 causal_conv x2: conv2, conv3 (+ LeakyReLU)                       |
    h3 (B, 6016, 128) --- IGLOO kernel 2 (K2 fused_reduce + attention) ---+
                                                            concat (B, 256)
      -> Dense 512 + BN + ReLU -> Dense 512 + BN + ReLU -> Dense 3 -> softmax

K2, K4 and K5 are the hand-written kernels of ``genomad_torch.ops``; the
attention of the patch logits over the pooled positions and the dense heads
are plain PyTorch, as JAX leaves them to XLA. Values are rounded to the
compute dtype at the points where the JAX graph rounds them, so the bf16
forward follows ``apply_bases`` of ``make_forward_bases``.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from genomad_torch.device import disable_tf32, resolve_device
from genomad_torch.ops import conv, patch_reduce

# Architecture constants (genomad/neural_network/model.py:15-27)
WINDOW_TOKENS = 5_997
VOCAB = 257
CHANNELS = 128
CONV_KERNEL = 6
N_PATCHES = 2_100
PATCH_SIZE = 4
POOL = 8
POOLED_LEN = WINDOW_TOKENS // POOL  # 749 (keras MaxPool1D 'valid')
# The trunk runs at the JAX package's padded length; positions >= WINDOW_TOKENS
# are masked out of every consumer (patches never reference them, the pooled
# value path is sliced).
L_PAD = 6_016
ENC_DIM = 512
N_CLASSES = 3
BN_EPS = 1e-3  # keras BatchNormalization default epsilon
N_CODE = conv.N_CODE  # base code of N / unknown

Params = Dict[str, Any]


# ---------------------------------------------------------------------------
# Initialization (same numpy draws as genomad_tpu.models.igloo.init_params)
# ---------------------------------------------------------------------------


def _glorot(rng: np.random.Generator, shape) -> np.ndarray:
    fan_in, fan_out = shape[0], shape[-1]
    limit = np.sqrt(6.0 / (fan_in + fan_out))
    return rng.uniform(-limit, limit, size=shape).astype(np.float32)


def random_patches(rng: np.random.Generator, vector_size: int = WINDOW_TOKENS, n_patches: int = N_PATCHES, patch_size: int = PATCH_SIZE) -> np.ndarray:
    """Sorted random position patches (reference igloo.py:280-296 at init)."""
    out = np.empty((n_patches, patch_size), dtype=np.int32)
    for i in range(n_patches):
        out[i] = np.sort(rng.choice(vector_size, size=patch_size, replace=False))
    return out


def init_params(seed: int = 0) -> Params:
    """Deterministic full parameter pytree of numpy arrays (synthetic
    weights), bit-equal to the JAX package's for the same seed."""
    rng = np.random.default_rng(seed)

    def igloo_kernel_params():
        return {
            "patches": random_patches(rng),
            "w_mult": _glorot(rng, (N_PATCHES, PATCH_SIZE, CHANNELS)),
            "w_summer": _glorot(rng, (PATCH_SIZE * CHANNELS, 1))[:, 0],
            "w_bias": _glorot(rng, (1, N_PATCHES))[0],
            "w_qk": _glorot(rng, (N_PATCHES, POOLED_LEN)),
            "w_v": _glorot(rng, (CHANNELS, CHANNELS)),
        }

    def bn_params(dim):
        return {
            "gamma": np.ones(dim, np.float32),
            "beta": np.zeros(dim, np.float32),
            "mean": np.zeros(dim, np.float32),
            "var": np.ones(dim, np.float32),
        }

    return {
        "conv1": {"kernel": _glorot(rng, (CONV_KERNEL, VOCAB, CHANNELS)), "bias": np.zeros(CHANNELS, np.float32)},
        "igloo1": igloo_kernel_params(),
        "conv2": {"kernel": _glorot(rng, (CONV_KERNEL, CHANNELS, CHANNELS)), "bias": np.zeros(CHANNELS, np.float32)},
        "conv3": {"kernel": _glorot(rng, (CONV_KERNEL, CHANNELS, CHANNELS)), "bias": np.zeros(CHANNELS, np.float32)},
        "igloo2": igloo_kernel_params(),
        "enc_dense": {"kernel": _glorot(rng, (2 * CHANNELS, ENC_DIM)), "bias": np.zeros(ENC_DIM, np.float32)},
        "enc_bn": bn_params(ENC_DIM),
        "head_dense": {"kernel": _glorot(rng, (ENC_DIM, ENC_DIM)), "bias": np.zeros(ENC_DIM, np.float32)},
        "head_bn": bn_params(ENC_DIM),
        "out_dense": {"kernel": _glorot(rng, (ENC_DIM, N_CLASSES)), "bias": np.zeros(N_CLASSES, np.float32)},
    }


def params_from_numpy(raw: Params, dtype=torch.bfloat16) -> Dict[str, Dict[str, torch.Tensor]]:
    """Inference parameters from the raw pytree of numpy arrays (as
    ``init_params`` or ``weights.load_npz`` return it), as
    ``genomad_tpu.models.igloo.prepare_params`` folds them:

    * w_mult (P,S,C) x w_summer (S*C,) -> one reduction tensor w_patch;
    * batch norm folded to scale/shift;
    * weights cast to the compute dtype (patches stay int32).

    Returns CPU tensors, grouped as the pytree is.
    """

    def cast(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dtype)

    def fold_igloo(p):
        patch_size, channels = p["w_mult"].shape[1], p["w_mult"].shape[2]
        w_summer = np.asarray(p["w_summer"]).reshape(patch_size, channels)
        return {
            "patches": torch.from_numpy(np.ascontiguousarray(p["patches"], dtype=np.int32)),
            "w_patch": cast(p["w_mult"] * w_summer[None, :, :]),
            "w_bias": cast(p["w_bias"]),
            "w_qk": cast(p["w_qk"]),
            "w_v": cast(p["w_v"]),
        }

    def fold_bn(bn):
        scale = bn["gamma"] / np.sqrt(np.asarray(bn["var"]) + BN_EPS)
        shift = bn["beta"] - np.asarray(bn["mean"]) * scale
        return {"scale": cast(scale), "shift": cast(shift)}

    def cast_all(d):
        return {k: cast(v) for k, v in d.items()}

    return {
        "conv1": cast_all(raw["conv1"]),
        "igloo1": fold_igloo(raw["igloo1"]),
        "conv2": cast_all(raw["conv2"]),
        "conv3": cast_all(raw["conv3"]),
        "igloo2": fold_igloo(raw["igloo2"]),
        "enc_dense": cast_all(raw["enc_dense"]),
        "enc_bn": fold_bn(raw["enc_bn"]),
        "head_dense": cast_all(raw["head_dense"]),
        "head_bn": fold_bn(raw["head_bn"]),
        "out_dense": cast_all(raw["out_dense"]),
    }


# ---------------------------------------------------------------------------
# Forward pass
# ---------------------------------------------------------------------------


class IglooClassifier(torch.nn.Module):
    """The IGLOO window classifier on one device.

    Built from the raw numpy pytree (``init_params`` / ``weights.load_params``)
    through :func:`params_from_numpy`; each pytree group is a submodule whose
    buffers are the prepared tensors (``self.conv1.kernel``, ...).
    ``device=None`` means the card; ``dtype`` is the compute dtype (bfloat16
    in production, float32 for parity runs, which also turns TF32 off).
    """

    def __init__(self, raw_params: Params, device=None, dtype=torch.bfloat16):
        super().__init__()
        self.device = resolve_device(device)
        self.dtype = dtype
        if dtype == torch.float32:
            disable_tf32()
        for group, tensors in params_from_numpy(raw_params, dtype).items():
            module = torch.nn.Module()
            for name, tensor in tensors.items():
                module.register_buffer(name, tensor.to(self.device))
            self.add_module(group, module)
        # the patch kernel trusts its positions: check them once here (the
        # upper bound against each trunk length in forward_tokens)
        positions = np.concatenate([np.ravel(raw_params[g]["patches"]) for g in ("igloo1", "igloo2")])
        if positions.min() < 0:
            raise ValueError("patch positions must be >= 0")
        self._max_patch = int(positions.max())
        for group in (self.igloo1, self.igloo2):  # what the bf16 patch kernel reads
            index, weights = patch_reduce.slot_table(group.patches, group.w_patch)
            group.register_buffer("slot_index", index)
            group.register_buffer("slot_weights", weights)

    def _igloo_kernel(self, y: torch.Tensor, p: torch.nn.Module) -> torch.Tensor:
        """IGLOO patch-attention kernel: (B, L, C) -> (B, C) (reference
        igloo.py:190-217); positions >= WINDOW_TOKENS are ignored."""
        pooled_len = min(y.shape[1], WINDOW_TOKENS) // POOL
        slots = patch_reduce.SlotTable(p.slot_index, p.slot_weights)
        mpi, pooled = patch_reduce.fused_reduce(y, p.patches, p.w_patch, p.w_v, slots=slots)
        pooled = pooled[:, :pooled_len]
        mpi = mpi.to(self.dtype) + p.w_bias
        # f32 logits and attention sums, as JAX's preferred_element_type=f32
        alpha = torch.softmax(torch.matmul(mpi.float(), p.w_qk.float()), dim=-1).to(self.dtype)
        return torch.bmm(alpha.float().unsqueeze(1), pooled.float()).squeeze(1).to(self.dtype)

    @staticmethod
    def _dense_bn_relu(x, dense, bn):
        return torch.relu((torch.matmul(x, dense.kernel) + dense.bias) * bn.scale + bn.shift)

    def _trunk(self, h1: torch.Tensor) -> torch.Tensor:
        """conv1's output (B, L, C) -> (B, 3) float32 class probs: the rest
        of the forward (the JAX ``_forward_from_h1``)."""
        if self._max_patch >= h1.shape[1]:
            raise ValueError(f"patch position {self._max_patch} is outside a trunk of length {h1.shape[1]}")
        a = self._igloo_kernel(h1, self.igloo1)
        h2 = conv.causal_conv(h1, self.conv2.kernel, self.conv2.bias)
        h3 = conv.causal_conv(h2, self.conv3.kernel, self.conv3.bias)
        b = self._igloo_kernel(h3, self.igloo2)
        feat = torch.cat([a, b], dim=-1)
        enc = self._dense_bn_relu(feat, self.enc_dense, self.enc_bn)
        hid = self._dense_bn_relu(enc, self.head_dense, self.head_bn)
        logits = (torch.matmul(hid, self.out_dense.kernel) + self.out_dense.bias).float()
        return torch.softmax(logits, dim=-1)

    def forward_tokens(self, tokens: torch.Tensor) -> torch.Tensor:
        """(B, L) int32 tokens in [0, 256] -> (B, 3) float32 class probs
        (the JAX ``apply`` with its trunk at length L)."""
        return self._trunk(conv.embed_conv(tokens.contiguous(), self.conv1.kernel, self.conv1.bias))

    def forward_bases(self, bases: torch.Tensor) -> torch.Tensor:
        """(B, 6000) base codes (ACGT = 0..3, N = 4), uint8 on the card ->
        (B, 3) float32 class probs: the JAX ``apply_bases``, with the 4-mer
        tokenizer fused into conv1's kernel and the trunk padded to L_PAD."""
        return self._trunk(conv.embed_conv_bases(bases.contiguous(), self.conv1.kernel, self.conv1.bias, L_PAD))


# ---------------------------------------------------------------------------
# Training-mode forward (dropout active): the JAX ``apply_train``
# ---------------------------------------------------------------------------
#
# Plain differentiable PyTorch throughout, as JAX's apply_train leaves this
# work to XLA: the K2/K4/K5 kernels have no backward, and their wrappers
# refuse inputs that require a gradient.


def _leaky_relu(x: torch.Tensor) -> torch.Tensor:
    return torch.nn.functional.leaky_relu(x, negative_slope=0.1)


def _bn(x: torch.Tensor, p: Dict[str, torch.Tensor]) -> torch.Tensor:
    return x * p["scale"] + p["shift"]


def _causal_embed_conv(tokens: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """Width-K causal conv over one-hot tokens as JAX computes it: one
    gather of the (V+1, K*C) table (last row the zero pad token), then the
    K shifted block sums. out[:, t] = bias + sum_k kernel[k][tokens[:, t-K+1+k]]."""
    k_size, vocab, channels = kernel.shape
    length = tokens.shape[1]
    table = torch.cat(
        [kernel.transpose(0, 1).reshape(vocab, k_size * channels), kernel.new_zeros((1, k_size * channels))]
    )
    padded = torch.nn.functional.pad(tokens.long(), (k_size - 1, 0), value=vocab)
    gathered = table[padded]  # (B, L+K-1, K*C)
    out = sum(gathered[:, k : k + length, k * channels : (k + 1) * channels] for k in range(k_size))
    return out + bias


def _causal_conv(x: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """Causal 1-D conv (B, L, C_in) -> (B, L, C_out): the six shifted
    matmuls of ``conv.causal_conv_plain``, without its epilogue."""
    k_size = kernel.shape[0]
    length = x.shape[1]
    xp = torch.nn.functional.pad(x, (0, 0, k_size - 1, 0))
    out = sum(torch.matmul(xp[:, k : k + length], kernel[k]) for k in range(k_size))
    return out + bias


def _igloo_kernel(y: torch.Tensor, p: Dict[str, torch.Tensor]) -> torch.Tensor:
    """The gather branch of JAX's ``_igloo_kernel``: (B, L, C) -> (B, C)."""
    pooled_len = min(y.shape[1], WINDOW_TOKENS) // POOL
    gathered = y[:, p["patches"].long()]  # (B, P, S, C)
    mpi = torch.einsum("bpsc,psc->bp", gathered.float(), p["w_patch"].float())
    y_proj = torch.matmul(y.float(), p["w_v"].float()).to(y.dtype)
    full_windows = y.shape[1] // POOL
    pooled = y_proj[:, : full_windows * POOL].reshape(y.shape[0], full_windows, POOL, -1).amax(dim=2)[:, :pooled_len]
    mpi = mpi.to(y.dtype) + p["w_bias"]
    alpha = torch.softmax(torch.matmul(mpi.float(), p["w_qk"].float()), dim=-1).to(y.dtype)
    return torch.einsum("bl,blc->bc", alpha.float(), pooled.float()).to(y.dtype)


def dropout_masks(generator: torch.Generator, params: Params, batch: int, dropout_rate: float):
    """The four keep masks of :func:`apply_train` for ``batch`` rows of
    ``params``' widths, drawn from ``generator`` in JAX's order (k1 to k4):
    SpatialDropout1D (batch, 1, channels) after conv1, conv2 and conv3, then
    the head's (batch, hidden). Each entry is kept with probability
    1 - dropout_rate. The masks live on the generator's device."""
    channels, hidden = params["conv2"]["kernel"].shape[2], params["head_dense"]["kernel"].shape[1]
    shapes = [(batch, 1, channels)] * 3 + [(batch, hidden)]
    return [torch.rand(s, generator=generator, device=generator.device) >= dropout_rate for s in shapes]


def apply_train(params: Params, tokens: torch.Tensor, generator: torch.Generator | None, dropout_rate: float = 0.2, masks=None) -> torch.Tensor:
    """Forward pass with dropout active (SpatialDropout1D on the conv
    stacks, plain Dropout on the head; reference igloo.py:49-53,
    model.py:43): (B, L) int tokens -> (B, 3) float32 class probs.

    ``params`` is the dict ``params_from_numpy`` returns (float leaves may
    require grad). ``masks``: the four keep masks of :func:`dropout_masks`
    for these rows; drawn from ``generator`` when not given and the rate
    is above 0. At rate 0 nothing is drawn and nothing dropped."""
    p = params
    if dropout_rate and masks is None:
        masks = dropout_masks(generator, p, tokens.shape[0], dropout_rate)

    def drop(x, i):
        if not dropout_rate:
            return x
        keep = masks[i].to(x.device)
        return torch.where(keep, x / (1 - dropout_rate), torch.zeros_like(x))

    h1 = drop(_leaky_relu(_causal_embed_conv(tokens, p["conv1"]["kernel"], p["conv1"]["bias"])), 0)
    a = _igloo_kernel(h1, p["igloo1"])
    h2 = drop(_leaky_relu(_causal_conv(h1, p["conv2"]["kernel"], p["conv2"]["bias"])), 1)
    h3 = drop(_leaky_relu(_causal_conv(h2, p["conv3"]["kernel"], p["conv3"]["bias"])), 2)
    b = _igloo_kernel(h3, p["igloo2"])
    feat = torch.cat([a, b], dim=-1)
    enc = torch.relu(_bn(feat @ p["enc_dense"]["kernel"] + p["enc_dense"]["bias"], p["enc_bn"]))
    hid = drop(torch.relu(_bn(enc @ p["head_dense"]["kernel"] + p["head_dense"]["bias"], p["head_bn"])), 3)
    logits = (hid @ p["out_dense"]["kernel"] + p["out_dense"]["bias"]).float()
    return torch.softmax(logits, dim=-1)
