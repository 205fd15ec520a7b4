"""Plain float32 reference of geNomad's IGLOO window classifier and of its
window encoding, in PyTorch operations only (no kernel of the port).

Follows genomad/neural_network (model.py:15-60, igloo.py), at the widths a
configuration file states (``Widths``; geNomad's are 6,000 bp windows of
5,997 overlapping 4-mer tokens, a vocabulary of 257, 128 channels, conv
width 6, 2,100 patches of 4, pooling by 8, dense 512, 3 classes): token =
1 + the 2-bit packing of the 4 bases, 0 when any is not ACGT; conv1 over
the one-hot tokens (causal) + LeakyReLU(0.1); an IGLOO block (patch logits
from the products with the patch weights, a value projection max-pooled,
softmax attention of the patch logits over the pooled positions); conv2
and conv3 (causal, LeakyReLU); a second IGLOO block; the two block outputs
concatenated into Dense + BN + ReLU, Dense + BN + ReLU, Dense and softmax.
Contig scores are the mean over the contig's windows.

The weights are made here from their seed with the draws of the port's
synthetic fallback (``init_params(seed)``: numpy ``default_rng(seed)``,
Glorot-uniform kernels, sorted random patches, zero biases, identity batch
norm), never read from the port. TF32 is switched off.

``quantize``: the control. Every weight and every layer's output is rounded
through float8 e4m3 with a per-tensor scale (amax / 448), the step below
the bfloat16 the configuration states.
"""

from __future__ import annotations

from dataclasses import dataclass, fields

import numpy as np
import torch

BN_EPS = 1e-3
LEAKY_SLOPE = 0.1


@dataclass(frozen=True)
class Widths:
    """The model's and the window encoding's sizes, as a configuration
    file states them under the same keys."""

    window_bp: int
    min_window_bp: int
    max_window_ns: int
    tokens: int
    vocab: int
    channels: int
    conv_width: int
    igloo_blocks: int
    patches: int
    patch_size: int
    pool: int
    dense: int
    classes: int

    @property
    def pooled(self) -> int:
        return self.tokens // self.pool


def widths(config: dict) -> Widths:
    return Widths(**{f.name: int(config[f.name]) for f in fields(Widths)})

_CODES = np.full(256, 4, np.uint8)
for _c, _b in enumerate(b"ACGT"):
    _CODES[_b] = _c


# ---------------------------------------------------------------- weights


def _glorot(rng, shape) -> np.ndarray:
    limit = np.sqrt(6.0 / (shape[0] + shape[-1]))
    return rng.uniform(-limit, limit, size=shape).astype(np.float32)


def init_params(w: Widths, seed: int = 0) -> dict:
    rng = np.random.default_rng(seed)
    C = w.channels

    def block():
        patches = np.empty((w.patches, w.patch_size), np.int32)
        for i in range(w.patches):
            patches[i] = np.sort(rng.choice(w.tokens, size=w.patch_size, replace=False))
        return {
            "patches": patches,
            "w_mult": _glorot(rng, (w.patches, w.patch_size, C)),
            "w_summer": _glorot(rng, (w.patch_size * C, 1))[:, 0],
            "w_bias": _glorot(rng, (1, w.patches))[0],
            "w_qk": _glorot(rng, (w.patches, w.pooled)),
            "w_v": _glorot(rng, (C, C)),
        }

    def bn(dim):
        return {"gamma": np.ones(dim, np.float32), "beta": np.zeros(dim, np.float32),
                "mean": np.zeros(dim, np.float32), "var": np.ones(dim, np.float32)}

    def dense(shape):
        return {"kernel": _glorot(rng, shape), "bias": np.zeros(shape[-1], np.float32)}

    return {
        "conv1": dense((w.conv_width, w.vocab, C)),
        "igloo1": block(),
        "conv2": dense((w.conv_width, C, C)),
        "conv3": dense((w.conv_width, C, C)),
        "igloo2": block(),
        "enc_dense": dense((w.igloo_blocks * C, w.dense)),
        "enc_bn": bn(w.dense),
        "head_dense": dense((w.dense, w.dense)),
        "head_bn": bn(w.dense),
        "out_dense": dense((w.dense, w.classes)),
    }


# ---------------------------------------------------------------- encoding


def encode_windows(records, w: Widths) -> tuple[np.ndarray, list, np.ndarray]:
    """(contig name, sequence) records -> (bases (n, window_bp) uint8 with
    ACGT = 0..3 and anything else 4, names, window -> contig index), by
    geNomad's rules (nn_classification.py:54-100): leading and trailing N
    trimmed; windows of window_bp, the last dropped under min_window_bp
    unless it is the first; windows after the first dropped above
    max_window_ns N; short windows padded with N."""
    rows, names, ids = [], [], []
    for name, seq in records:
        seq = seq.strip("nN")
        if not seq:
            continue
        contig = len(names)
        names.append(name.split()[0])
        raw = seq.encode("ascii")
        upper = raw.upper()
        for k, start in enumerate(range(0, len(raw), w.window_bp)):
            window = upper[start : start + w.window_bp]
            if len(window) < w.min_window_bp and k > 0:
                break
            if k > 0 and raw[start : start + w.window_bp].count(b"N") > w.max_window_ns:
                continue
            rows.append(_CODES[np.frombuffer(window.ljust(w.window_bp, b"N"), np.uint8)])
            ids.append(contig)
    bases = np.stack(rows) if rows else np.zeros((0, w.window_bp), np.uint8)
    return bases, names, np.array(ids, np.int64)


def tokens(bases: torch.Tensor) -> torch.Tensor:
    codes = bases.long()
    n = codes.shape[1] - 3
    token = codes[:, :n]
    valid = token < 4
    for j in range(1, 4):
        window = codes[:, j : j + n]
        valid = valid & (window < 4)
        token = token * 4 + window
    return torch.where(valid, token + 1, torch.zeros_like(token))


# ---------------------------------------------------------------- forward


def _fp8(x: torch.Tensor) -> torch.Tensor:
    scale = x.abs().amax().clamp_min(1e-30) / 448.0
    return (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


class Reference:
    def __init__(self, raw: dict, w: Widths, device, quantize: bool = False):
        self.w = w
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.device = device
        self.q = _fp8 if quantize else (lambda x: x)

        def t(a):
            return self.q(torch.as_tensor(np.asarray(a, np.float32), device=device))

        self.p = {}
        for g in ("conv1", "conv2", "conv3", "enc_dense", "head_dense", "out_dense"):
            self.p[g] = {"kernel": t(raw[g]["kernel"]), "bias": t(raw[g]["bias"])}
        for g in ("enc_bn", "head_bn"):
            bn = raw[g]
            scale = bn["gamma"] / np.sqrt(bn["var"] + BN_EPS)
            self.p[g] = {"scale": t(scale), "shift": t(bn["beta"] - bn["mean"] * scale)}
        for g in ("igloo1", "igloo2"):
            b = raw[g]
            self.p[g] = {
                "patches": torch.as_tensor(b["patches"].astype(np.int64), device=device),
                "w_patch": t(b["w_mult"] * b["w_summer"].reshape(w.patch_size, w.channels)[None]),
                "w_bias": t(b["w_bias"]), "w_qk": t(b["w_qk"]), "w_v": t(b["w_v"]),
            }

    def _leaky(self, x):
        return self.q(torch.where(x >= 0, x, x * LEAKY_SLOPE))

    def _conv1(self, tok):
        kernel, bias = self.p["conv1"]["kernel"], self.p["conv1"]["bias"]
        K = self.w.conv_width
        out = bias.expand(tok.shape[0], tok.shape[1], self.w.channels).clone()
        for k in range(K):
            shift = K - 1 - k  # out[t] += kernel[k][tok[t - shift]]
            out[:, shift:] += kernel[k][tok[:, : tok.shape[1] - shift]]
        return self._leaky(out)

    def _conv(self, x, g):
        kernel, bias = self.p[g]["kernel"], self.p[g]["bias"]
        K = self.w.conv_width
        out = bias.expand(x.shape[0], x.shape[1], self.w.channels).clone()
        for k in range(K):
            shift = K - 1 - k
            out[:, shift:] += x[:, : x.shape[1] - shift] @ kernel[k]
        return self._leaky(out)

    def _igloo(self, y, g):
        p = self.p[g]
        gathered = y[:, p["patches"]]  # (B, P, S, C)
        mpi = self.q(torch.einsum("bpsc,psc->bp", gathered, p["w_patch"]) + p["w_bias"])
        w = self.w
        proj = y[:, : w.pooled * w.pool] @ p["w_v"]
        pooled = self.q(proj.reshape(y.shape[0], w.pooled, w.pool, w.channels).amax(dim=2))
        alpha = self.q(torch.softmax(mpi @ p["w_qk"], dim=-1))
        return self.q(torch.einsum("bl,blc->bc", alpha, pooled))

    def _dense_bn_relu(self, x, dense, bn):
        d, b = self.p[dense], self.p[bn]
        return self.q(torch.relu((x @ d["kernel"] + d["bias"]) * b["scale"] + b["shift"]))

    @torch.no_grad()
    def forward_bases(self, bases: np.ndarray, block: int = 16) -> np.ndarray:
        """(n, window_bp) uint8 base codes -> (n, classes) float32 probabilities."""
        out = []
        for s in range(0, len(bases), block):
            tok = tokens(torch.as_tensor(bases[s : s + block], device=self.device))
            h1 = self._conv1(tok)
            a = self._igloo(h1, "igloo1")
            h3 = self._conv(self._conv(h1, "conv2"), "conv3")
            b = self._igloo(h3, "igloo2")
            hid = self._dense_bn_relu(self._dense_bn_relu(torch.cat([a, b], -1), "enc_dense", "enc_bn"), "head_dense", "head_bn")
            d = self.p["out_dense"]
            out.append(torch.softmax(hid @ d["kernel"] + d["bias"], dim=-1).cpu().numpy())
        return np.concatenate(out) if out else np.zeros((0, self.w.classes), np.float32)


def contig_scores(window_scores: np.ndarray, ids: np.ndarray, n_contigs: int) -> np.ndarray:
    sums = np.zeros((n_contigs, window_scores.shape[1]))
    np.add.at(sums, ids, window_scores)
    return sums / np.maximum(np.bincount(ids, minlength=n_contigs), 1)[:, None]


def window_count(records, w: Widths) -> int:
    """The number of windows :func:`encode_windows` makes, without making them."""
    n = 0
    for _, seq in records:
        seq = seq.strip("nN")
        for k, start in enumerate(range(0, len(seq), w.window_bp)):
            window = seq[start : start + w.window_bp]
            if len(window) < w.min_window_bp and k > 0:
                break
            if k == 0 or window.count("N") <= w.max_window_ns:
                n += 1
    return n
