"""Plain float32 training step of geNomad's IGLOO window classifier, in
PyTorch operations only (no kernel and no code of the port): the training
forward with dropout from given keep masks, the cross-entropy loss, its
gradients by autograd, and the AdamW update written out by its formula.

The forward follows genomad/neural_network (model.py:14-45, igloo.py:30-217)
at the widths of ``reference.igloo.Widths``, in (batch, channels, positions)
layout:

- conv1: a causal ``conv1d`` over the one-hot tokens (``vocab`` rows; the
  first width - 1 positions see zeros on the left), LeakyReLU(0.1), then
  SpatialDropout1D (one keep mask a window and channel);
- an IGLOO block on conv1's output: the patch positions gathered, their
  products with the patch weights summed to one logit a patch (+ bias); the
  value projection of the first pooled x pool positions, max-pooled by
  ``pool``; softmax of the patch logits times ``w_qk`` over the pooled
  positions, and the pooled values summed under it;
- conv2 and conv3: causal ``conv1d`` (left padding), LeakyReLU, SpatialDropout1D;
- a second IGLOO block on conv3's output;
- the two blocks' outputs concatenated into Dense + BN + ReLU (encoder),
  Dense + BN + ReLU + Dropout (head), Dense and softmax;
- the loss: the mean over the batch of -log(clamp(p, 1e-7, 1)) at the label.

Dropout keeps x / (1 - rate) where its mask keeps and gives 0 elsewhere.
The masks are drawn (:func:`keep_masks`) from a ``torch.Generator``'s state
in the trainer's order: after conv1, conv2 and conv3 a (batch, 1, channels)
mask, then the head's (batch, dense), each kept where ``torch.rand`` >= rate.

Departure from the Keras form: Keras trains ``w_mult`` and ``w_summer`` of
each IGLOO block and batch norm's gamma and beta (with moving statistics).
Here the trained leaves are the folded ones (:func:`fold`): ``w_patch =
w_mult * w_summer`` (one weight a patch position and channel) and batch
norm's inference affine, ``scale = gamma / sqrt(var + eps)`` and ``shift =
beta - mean * scale``, which batch norm applies in training too. The patch
positions are integers and are not trained.

AdamW (Loshchilov and Hutter, decoupled weight decay) at step t, with g
the gradient: m = b1 m + (1 - b1) g; v = b2 v + (1 - b2) g^2; p <- p - lr
wd p - lr (m / (1 - b1^t)) / (sqrt(v / (1 - b2^t)) + eps).

Branches (:func:`branches`, :func:`match`): a (leaky) ReLU and a max-pool
decide, and where a decision's input lies within float32's rounding of its
boundary, two float32 computations in different orders may decide apart.
:func:`branches` finds those decisions (within ``TIE`` of their terms'
magnitude) and computes, for the ones with the most gradient at stake, how
every gradient changes if the decision goes the other way; :func:`match`
gives the reference's gradient on the branches that another step's gradient
took.

TF32 is off (``allow_tf32`` False for matmuls and cuDNN). ``tf32=True`` is
the control, the precision just below float32: on the card the step's
matmuls and convolutions run with TF32 allowed; on the CPU, which has no
TF32, the operands of every product and the gradients flowing into them are
rounded to TF32's 10-bit mantissa.
"""

from __future__ import annotations

import contextlib
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference.igloo import BN_EPS, LEAKY_SLOPE, Widths

LOG_CLAMP = 1e-7
BLOCKS = ("igloo1", "igloo2")
# the trained leaves, "group/name", in the trainer's order
LEAVES = (
    "conv1/kernel", "conv1/bias",
    *(f"igloo1/{n}" for n in ("w_patch", "w_bias", "w_qk", "w_v")),
    "conv2/kernel", "conv2/bias", "conv3/kernel", "conv3/bias",
    *(f"igloo2/{n}" for n in ("w_patch", "w_bias", "w_qk", "w_v")),
    "enc_dense/kernel", "enc_dense/bias", "enc_bn/scale", "enc_bn/shift",
    "head_dense/kernel", "head_dense/bias", "head_bn/scale", "head_bn/shift",
    "out_dense/kernel", "out_dense/bias",
)


def fold(raw: dict, w: Widths) -> tuple[dict, dict]:
    """(trained leaves {"group/name": float32 array}, patch positions
    {block: int64 array}) from Keras-form weights (``reference.igloo.init_params``)."""
    leaves = {}
    for g in ("conv1", "conv2", "conv3", "enc_dense", "head_dense", "out_dense"):
        leaves[f"{g}/kernel"], leaves[f"{g}/bias"] = raw[g]["kernel"], raw[g]["bias"]
    for g in BLOCKS:
        b = raw[g]
        leaves[f"{g}/w_patch"] = b["w_mult"] * b["w_summer"].reshape(w.patch_size, w.channels)[None]
        for n in ("w_bias", "w_qk", "w_v"):
            leaves[f"{g}/{n}"] = b[n]
    for g in ("enc_bn", "head_bn"):
        bn = raw[g]
        scale = bn["gamma"] / np.sqrt(bn["var"] + BN_EPS)
        leaves[f"{g}/scale"], leaves[f"{g}/shift"] = scale, bn["beta"] - bn["mean"] * scale
    leaves = {k: np.asarray(leaves[k], np.float32) for k in LEAVES}
    return leaves, {g: np.asarray(raw[g]["patches"], np.int64) for g in BLOCKS}


def keep_masks(generator_state: torch.Tensor, device, batch: int, w: Widths, rate: float) -> list:
    """The four keep masks a step draws from a generator in ``generator_state``."""
    gen = torch.Generator(device=device)
    gen.set_state(generator_state)
    shapes = [(batch, 1, w.channels)] * 3 + [(batch, w.dense)]
    return [torch.rand(s, generator=gen, device=device) >= rate for s in shapes]


def _round_tf32(x: torch.Tensor) -> torch.Tensor:
    """x rounded to the nearest TF32 value (10 mantissa bits, ties to even)."""
    i = x.contiguous().view(torch.int32)
    return ((i + 0x0FFF + ((i >> 13) & 1)) & -0x2000).view(torch.float32)


class _TF32(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return _round_tf32(x)

    @staticmethod
    def backward(ctx, grad):
        return _round_tf32(grad)


@contextlib.contextmanager
def _precision(tf32: bool, device):
    """TF32 off, or allowed for the control on the card; yields the operand
    rounding of the control on the CPU (the identity otherwise)."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    on_card = torch.device(device).type == "cuda"
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = tf32 and on_card
    try:
        yield _TF32.apply if tf32 and not on_card else (lambda x: x)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def forward(p: dict, patches: dict, tokens: torch.Tensor, masks: list, w: Widths, rate: float, q=lambda x: x,
            taps: dict | None = None) -> torch.Tensor:
    """(batch, tokens) int tokens -> (batch, classes) probabilities in the
    leaves' precision with dropout from ``masks``; ``q`` rounds each
    product's operands. ``taps`` (a dict) receives what :func:`branches`
    reads of each decision, by layer: a (leaky) ReLU's input, the magnitude
    of its terms, its output and the share of its gradient it blocks below
    0; an IGLOO block's projected positions before the max-pool, the
    magnitude of their terms and the pooled values."""
    K = w.conv_width
    keep = [m.transpose(1, 2) for m in masks[:3]] + [masks[3]]  # (B, C, 1) in this layout; the head's (B, dense)

    def tap(name, z, terms, out, blocked):
        if taps is not None:
            if out.requires_grad:
                out.retain_grad()
            taps[name] = (z, terms, out, blocked)
        return out

    def drop(x, i):
        return torch.where(keep[i], x / (1 - rate), 0.0)

    def causal_leaky(x, g):  # x (B, C_in, T); kernel (K, C_in, C_out)
        kernel, bias = p[f"{g}/kernel"].permute(2, 1, 0), p[f"{g}/bias"]
        z = F.conv1d(F.pad(q(x), (K - 1, 0)), q(kernel), bias)
        terms = None
        if taps is not None:
            terms = F.conv1d(F.pad(x.detach().abs(), (K - 1, 0)), kernel.detach().abs(), bias.detach().abs())
        return tap(g, z, terms, F.leaky_relu(z, LEAKY_SLOPE), 1 - LEAKY_SLOPE)

    def igloo(y, g):  # y (B, C, T) -> (B, C)
        yt = q(y.transpose(1, 2))
        gathered = yt[:, patches[g]]  # (B, P, S, C)
        mpi = torch.einsum("bpsc,psc->bp", gathered, q(p[f"{g}/w_patch"])) + p[f"{g}/w_bias"]
        windows = yt[:, : w.pooled * w.pool]
        proj = (windows @ q(p[f"{g}/w_v"])).reshape(y.shape[0], w.pooled, w.pool, w.channels)
        pooled = proj.amax(dim=2)
        if taps is not None:
            if pooled.requires_grad:
                pooled.retain_grad()
            taps[g] = (proj, (windows.detach().abs() @ p[f"{g}/w_v"].detach().abs()).reshape(proj.shape), pooled)
        alpha = torch.softmax(q(mpi) @ q(p[f"{g}/w_qk"]), dim=-1)
        return torch.einsum("bl,blc->bc", q(alpha), q(pooled))

    def dense_bn_relu(x, dense, bn):
        kernel, bias, scale, shift = (p[k] for k in (f"{dense}/kernel", f"{dense}/bias", f"{bn}/scale", f"{bn}/shift"))
        z = (q(x) @ q(kernel) + bias) * scale + shift
        terms = None
        if taps is not None:
            a = [t.detach().abs() for t in (x, kernel, bias, scale, shift)]
            terms = (a[0] @ a[1] + a[2]) * a[3] + a[4]
        return tap(dense, z, terms, torch.relu(z), 1.0)

    onehot = torch.zeros(tokens.shape[0], w.vocab, tokens.shape[1], device=tokens.device, dtype=p["conv1/bias"].dtype)
    onehot.scatter_(1, tokens.long()[:, None, :], 1.0)
    h1 = drop(causal_leaky(onehot, "conv1"), 0)
    a = igloo(h1, "igloo1")
    h2 = drop(causal_leaky(h1, "conv2"), 1)
    h3 = drop(causal_leaky(h2, "conv3"), 2)
    b = igloo(h3, "igloo2")
    hid = drop(dense_bn_relu(dense_bn_relu(torch.cat([a, b], dim=-1), "enc_dense", "enc_bn"), "head_dense", "head_bn"), 3)
    return torch.softmax(q(hid) @ q(p["out_dense/kernel"]) + p["out_dense/bias"], dim=-1)


def _loss(probs: torch.Tensor, labels) -> torch.Tensor:
    return -torch.log(torch.clamp(probs, LOG_CLAMP, 1.0)).gather(1, labels.long()[:, None]).mean()


def loss_and_grads(leaves: dict, patches: dict, tokens, labels, masks: list, w: Widths, rate: float, tf32: bool = False):
    """(loss, {"group/name": gradient}) of the step's batch from ``leaves``
    ({"group/name": float32 tensor}), all on one device."""
    device = tokens.device
    p = {k: v.detach().clone().requires_grad_(True) for k, v in leaves.items()}
    pos = {g: torch.as_tensor(a, device=device) for g, a in patches.items()}
    with _precision(tf32, device) as q:
        loss = _loss(forward(p, pos, tokens, masks, w, rate, q), labels)
        loss.backward()
    return loss.detach(), {k: p[k].grad for k in LEAVES}


# Branches. A (leaky) ReLU and an IGLOO block's max-pool decide: pass or
# block, this position or its runner-up. A float32 step rounds each sum of n
# terms by about sqrt(n) 2^-24 of their magnitude (on the card, at most 9e-7
# of it at a decision's input), so where the input lies within TIE of its
# terms' magnitude from the boundary, float32 arithmetic in another order may
# take the other branch, and that moves a leaf's gradient by up to about 1%.
# TF32 rounds by 2^-11, and almost all of its flips lie beyond TIE.
TIE = 1e-5
BRANCHES = 32  # the most decisions a layer whose other branch is computed, by gradient at stake
DECIDING = ("conv1", "conv2", "conv3", "enc_dense", "head_dense")


class Branches(NamedTuple):
    loss: torch.Tensor
    grads: dict  # {"group/name": gradient}
    changes: list  # [{"group/name": change of the gradient}], one a decision
    decisions: list  # [(layer, window, position, runner-up or None)], one a change
    found: int  # decisions within the margin


def branches(leaves: dict, patches: dict, tokens, labels, masks: list, w: Widths, rate: float,
             tie: float = TIE, most: int = BRANCHES) -> Branches:
    """The step from ``leaves`` (float32, TF32 off) and the branches that
    float32 may take the other way. Each change is that of every gradient
    if one decision within ``tie`` of its boundary goes the other way: a
    (leaky) ReLU that passes blocks, or the reverse; a max-pool's gradient
    goes to the runner-up. Of the decisions found, the ``most`` of each
    layer with the largest gradient at stake are computed, each from the
    gradient of its one window at batch 1."""
    device = tokens.device
    p = {k: v.detach().clone().requires_grad_(True) for k, v in leaves.items()}
    pos = {g: torch.as_tensor(a, device=device) for g, a in patches.items()}
    order = [p[k] for k in LEAVES]
    taps: dict = {}
    with _precision(False, device):
        loss = _loss(forward(p, pos, tokens, masks, w, rate, taps=taps), labels)
        loss.backward()
        grads = {k: p[k].grad.detach().clone() for k in LEAVES}
        near, found = [], 0  # (window, (layer, position, its runner-up or None, gradient at stake))
        for name in DECIDING + BLOCKS:
            if name in BLOCKS:
                proj, terms, pooled = taps[name]
                top = proj.detach().topk(2, dim=2)
                margin, up = top.values[:, :, 0] - top.values[:, :, 1], pooled.grad
                close = (margin > 0) & (margin < tie * terms.gather(2, top.indices).sum(2)) & (up != 0)
                signed = up[close]
                at = close.nonzero().tolist()
                spots = [((l, i, c), (l, j, c)) for (_, l, c), i, j in
                         zip(at, top.indices[:, :, 0][close].tolist(), top.indices[:, :, 1][close].tolist())]
            else:
                z, terms, out, blocked = taps[name]
                z, up = z.detach(), out.grad
                close = (z.abs() < tie * terms) & (up != 0)
                signed = blocked * torch.where(z > 0, -up, up)[close]  # passes: the other branch blocks
                at = close.nonzero().tolist()
                spots = [(tuple(a[1:]), None) for a in at]
            found += len(at)
            ranked = sorted(zip(signed.abs().tolist(), at, signed.tolist(), spots), key=lambda t: -t[0])
            near += [(a[0], (name, *spot, stake)) for _, a, stake, spot in ranked[:most]]
        changes, decisions = [], []
        windows: dict = {}
        for b, what in near:
            windows.setdefault(b, []).append(what)
        for b, whats in windows.items():
            one: dict = {}
            forward(p, pos, tokens[b : b + 1], [m[b : b + 1] for m in masks], w, rate, taps=one)
            for name, spot, runner_up, stake in whats:
                z = one[name][0][0]
                target = stake * (z[spot] if runner_up is None else z[runner_up] - z[spot])
                parts = torch.autograd.grad(target, order, retain_graph=True, allow_unused=True)
                changes.append({k: torch.zeros_like(grads[k]) if d is None else d for k, d in zip(LEAVES, parts)})
                decisions.append((name, b, spot, runner_up))
    return Branches(loss.detach(), grads, changes, decisions, found)


def match(got: dict, want: dict, changes: list) -> tuple:
    """(want + sum_k c_k changes[k], c) with each c_k in [0, 1] closest to
    ``got`` in the sum over leaves of |.|^2 / |want's leaf|^2: the
    reference's gradient on the branches that ``got`` took, a fraction
    where a max-pool's tie split its gradient."""
    if not changes:
        return want, []
    inv = {k: 1.0 / max(float(torch.linalg.vector_norm(want[k].double())), 1e-300) for k in LEAVES}

    def flat(d):
        return torch.cat([(d[k].double() * inv[k]).flatten() for k in LEAVES])

    moves = torch.stack([flat(ch) for ch in changes])
    gram = (moves @ moves.T).cpu().numpy()
    aim = (moves @ (flat(got) - flat(want))).cpu().numpy()
    del moves
    c = np.zeros(len(changes))
    for _ in range(100):  # coordinate descent on the box [0, 1]
        for k in range(len(c)):
            if gram[k, k] > 0:
                c[k] = min(max(c[k] + (aim[k] - gram[k] @ c) / gram[k, k], 0.0), 1.0)
    out = {k: want[k].clone() for k in LEAVES}
    for ck, ch in zip(c, changes):
        if ck:
            for k in LEAVES:
                out[k] += ck * ch[k].to(out[k].dtype)
    return out, c.tolist()


def adamw(leaves: dict, grads: dict, moments: dict, step: int, lr: float, weight_decay: float,
          betas=(0.9, 0.999), eps: float = 1e-8) -> dict:
    """The leaves after AdamW's step ``step + 1`` from ``moments`` ({"group/name":
    (m, v)}; a leaf missing there starts from zeros)."""
    b1, b2 = betas
    t = step + 1
    out = {}
    for k, p in leaves.items():
        g = grads[k]
        m, v = moments.get(k, (torch.zeros_like(p), torch.zeros_like(p)))
        m = b1 * m + (1 - b1) * g
        v = b2 * v + (1 - b2) * g * g
        out[k] = p - lr * weight_decay * p - lr * (m / (1 - b1**t)) / (torch.sqrt(v / (1 - b2**t)) + eps)
    return out
