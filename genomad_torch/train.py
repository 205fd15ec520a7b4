"""Training utilities for the IGLOO window classifier.

Port of ``genomad_tpu/train.py``: cross-entropy fine-tuning of the
inference-form parameters (``models.igloo.params_from_numpy``: the folded
patch tensor and the batch-norm affine are a valid reparametrization) with
AdamW, one step on one device (``make_train_step``) or data-parallel over a
``torch.distributed`` group (``make_sharded_train_step``), and the loop from
labelled FASTA files to steps (:class:`Trainer`).

The forward is ``igloo.apply_train``, plain differentiable PyTorch, as the
JAX step runs XLA's forms and not the Pallas kernels. Integer leaves (the
patch positions) are partitioned out of the trained leaves. The port's
prepared dict holds no derived leaves; ``_DERIVED_KEYS`` keeps the JAX
names so that both partitions have the same keys.
"""

from __future__ import annotations

import functools
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch

from genomad_torch import trace
from genomad_torch.device import disable_tf32, resolve_device
from genomad_torch.models import igloo
from genomad_torch.ops import conv, nn_pipeline

# Derived, non-trainable top-level entries of the JAX package's prepared
# params (recomputed from conv1 by its prepare_params); never trained.
_DERIVED_KEYS = {"base_tables", "igloo1_plan", "igloo2_plan"}


def partition_params(params: dict):
    """Split into (trainable float leaves, static leaves). Trainable leaves
    become leaf tensors that require grad; the integer patch positions and
    any derived group stay static."""
    trainable, static = {}, {}
    for group, sub in params.items():
        if group in _DERIVED_KEYS or sub is None:
            static[group] = sub
            continue
        for name, leaf in sub.items():
            if leaf.is_floating_point():
                trainable.setdefault(group, {})[name] = leaf.detach().clone().requires_grad_(True)
            else:
                static.setdefault(group, {})[name] = leaf
    return trainable, static


def merge_params(trainable: dict, static: dict) -> dict:
    merged = {g: dict(sub) for g, sub in trainable.items()}
    for group, sub in static.items():
        if group in _DERIVED_KEYS or not isinstance(sub, dict):
            merged[group] = sub
        else:
            merged.setdefault(group, {}).update(sub)
    return merged


def _leaves(trainable: dict) -> list:
    return [trainable[g][n] for g in trainable for n in trainable[g]]


class TrainState(NamedTuple):
    trainable: dict
    static: dict
    optimizer: torch.optim.Optimizer  # bound to the trainable leaves; holds the moments
    step: int


def make_optimizer(learning_rate: float = 1e-4, weight_decay: float = 1e-3):
    """AdamW with the reference's l2 strength as decoupled weight decay
    (igloo.py:39 l2_reg): betas (0.9, 0.999) and eps 1e-8, the defaults of
    ``optax.adamw``; both apply p <- p - lr * (m_hat / (sqrt(v_hat) + eps)
    + wd * p). Returns the factory that ``init_train_state`` binds to the
    trainable leaves."""
    return functools.partial(
        torch.optim.AdamW, lr=learning_rate, betas=(0.9, 0.999), eps=1e-8, weight_decay=weight_decay
    )


def init_train_state(params: dict, optimizer, device=None) -> TrainState:
    """``params``: the dict of ``igloo.params_from_numpy`` (float32 for
    training). The leaves go to ``device`` (None = the card; raises
    without one)."""
    device = resolve_device(device)
    params = {g: (None if sub is None else {n: t.to(device) for n, t in sub.items()}) for g, sub in params.items()}
    trainable, static = partition_params(params)
    return TrainState(trainable, static, optimizer(_leaves(trainable)), 0)


def loss_fn(trainable: dict, static: dict, tokens, labels, generator, dropout_rate: float = 0.2, masks=None) -> torch.Tensor:
    """Mean cross-entropy of the training-mode forward pass."""
    probs = igloo.apply_train(merge_params(trainable, static), tokens, generator, dropout_rate, masks=masks)
    log_probs = torch.log(torch.clamp(probs, 1e-7, 1.0))
    return -torch.mean(torch.gather(log_probs, 1, labels.long()[:, None]))


def _optimizer_check(optimizer):
    """A check that a state's optimizer is what the factory ``optimizer``
    builds (its class and hyperparameters): ``init_train_state`` binds the
    instance to the leaves, and a step made with another factory raises."""
    probe = optimizer([torch.zeros(1, requires_grad=True)])

    def check(state: TrainState) -> None:
        if type(state.optimizer) is not type(probe) or state.optimizer.defaults != probe.defaults:
            raise ValueError(
                f"the state's optimizer ({type(state.optimizer).__name__}, {state.optimizer.defaults}) is not "
                f"the one this step was made with ({type(probe).__name__}, {probe.defaults})"
            )

    return check


def make_train_step(optimizer, dropout_rate: float = 0.2):
    """(state, tokens, labels, generator) -> (state, loss). ``optimizer`` is
    the factory the state was built with: the step runs the instance that
    ``init_train_state`` bound in ``state``, and raises when that is not
    what the factory builds. The leaves' ``.grad`` hold this step's
    gradients after it."""
    check = _optimizer_check(optimizer)

    def train_step(state: TrainState, tokens, labels, generator):
        check(state)
        with trace.span("train.step"):
            state.optimizer.zero_grad(set_to_none=True)
            with trace.span("train.forward"):
                loss = loss_fn(state.trainable, state.static, tokens, labels, generator, dropout_rate)
            with trace.span("train.backward"):
                loss.backward()
            with trace.span("train.optimizer"):
                state.optimizer.step()
        return state._replace(step=state.step + 1), loss.detach()

    return train_step


def make_sharded_train_step(optimizer, group=None, dropout_rate: float = 0.2):
    """Data-parallel step over a ``torch.distributed`` group (JAX: batch
    over 'data', parameters and optimizer state replicated). Every rank
    passes the same global batch and a generator in the same state; it
    draws the dropout masks for the global batch, takes its contiguous
    rows, and the gradients and loss are averaged with one ``all_reduce``
    before the optimizer step. So the step computes what the unsharded one
    does, dropout included. Returns the global mean loss. ``optimizer``:
    as in :func:`make_train_step`."""
    check = _optimizer_check(optimizer)
    import torch.distributed as dist

    from genomad_torch.parallel.mesh import group_device

    def train_step(state: TrainState, tokens, labels, generator):
        check(state)
        world, rank = dist.get_world_size(group), dist.get_rank(group)
        batch = tokens.shape[0]
        if batch % world:
            raise ValueError(f"the global batch of {batch} does not divide by the group's {world} ranks")
        rows = slice(rank * batch // world, (rank + 1) * batch // world)
        masks = None
        if dropout_rate:
            masks = [m[rows] for m in igloo.dropout_masks(generator, state.trainable, batch, dropout_rate)]
        with trace.span("train.step"):
            state.optimizer.zero_grad(set_to_none=True)
            with trace.span("train.forward"):
                loss = loss_fn(state.trainable, state.static, tokens[rows], labels[rows], None, dropout_rate, masks=masks)
            with trace.span("train.backward"):
                loss.backward()
            leaves = _leaves(state.trainable)
            flat = torch.cat([p.grad.reshape(-1) for p in leaves] + [loss.detach().reshape(1)])
            reduced = flat.to(group_device(group))
            dist.all_reduce(reduced, group=group)
            flat = reduced.to(flat.device) / world
            offset = 0
            for p in leaves:
                p.grad.copy_(flat[offset : offset + p.numel()].view_as(p))
                offset += p.numel()
            with trace.span("train.optimizer"):
                state.optimizer.step()
        return state._replace(step=state.step + 1), flat[-1]

    return train_step


def _shuffle(n: int, batch_size: int, seed) -> tuple[np.ndarray, np.ndarray]:
    """(rows of each full batch (n_batches, batch_size), the rows left over)
    of ``n`` shuffled from ``seed``, in the JAX package's order."""
    order = np.random.default_rng(seed).permutation(n)
    full = n // batch_size * batch_size
    return order[:full].reshape(-1, batch_size), order[full:]


def make_batches(tokens: np.ndarray, labels: np.ndarray, batch_size: int, seed: int = 0):
    """Shuffled full batches (drops the remainder), in the JAX package's order."""
    for idx in _shuffle(len(tokens), batch_size, seed)[0]:
        yield tokens[idx], labels[idx]


# The classes of a labelled contig, in the order of the modules' score
# columns (chromosome, plasmid, virus).
CLASSES = ("chromosome", "plasmid", "virus")


def contig_label(name: str) -> int:
    """The class of a labelled contig: the token after the last ``|`` of its
    name (``contig_7|virus`` -> 2)."""
    try:
        return CLASSES.index(name.rsplit("|", 1)[-1])
    except ValueError:
        raise ValueError(f"contig {name!r} names no class of {CLASSES} after its last '|'") from None


class Batch(NamedTuple):
    tokens: torch.Tensor  # (batch, WINDOW_TOKENS) int32 on the state's device
    labels: torch.Tensor  # (batch,) int64 on the state's device
    bp: int  # the windows' bases before their N padding


def _window_bp(bases: np.ndarray, contig_ids: np.ndarray) -> np.ndarray:
    """Each window's bases before its N padding: a full window but for a
    contig's last window, whose trailing N are the padding (the contig's own
    trailing N were stripped)."""
    bp = np.full(len(bases), bases.shape[1], np.int64)
    if len(bases):
        last = np.flatnonzero(np.append(contig_ids[1:] != contig_ids[:-1], True))
        tail = bases[last, ::-1] != igloo.N_CODE
        bp[last] -= np.where(tail.any(axis=1), tail.argmax(axis=1), bases.shape[1])
    return bp


class Trainer:
    """Trains the IGLOO classifier on labelled FASTA files, a file a call of
    :meth:`fit`, from one train state (``init_train_state``) and its step
    (``make_train_step``).

    A call encodes the file's windows by the nn-classification rule
    (``nn_pipeline.encode_windows``) and labels each by its contig
    (:func:`contig_label`). With the windows held from the calls before, they
    are shuffled from ``(seed, call)`` in :func:`make_batches`' order; every
    full batch is trained, and the windows past the last one are held for
    the next call (:attr:`held`), so that each window is trained once. The
    call's full batches go to the state's device in one copy (uint8 base
    codes with the labels as one more column) and are tokenized there. The
    dropout masks come from a generator on that device seeded with ``seed``.
    The steps run without a wait for the device; a call counts its
    non-finite losses on the device and reads them once, at its end.

    Counters (``trace.COUNTERS``), added once a call: ``train.steps``,
    ``train.windows`` (the rows of its batches), ``train.bp`` (their bases
    before padding) and ``train.nonfinite_losses``. Spans: ``train.batches``
    (the input: encoding, labels, shuffle, the copy and the tokens) and,
    inside each step, ``train.step``, ``train.forward``, ``train.backward``
    and ``train.optimizer``.
    """

    def __init__(self, state: TrainState, step, batch_size: int = 64, seed: int = 0):
        self.state, self.step, self.batch_size, self.seed = state, step, batch_size, seed
        leaf = _leaves(state.trainable)[0]
        self.device = leaf.device
        if leaf.dtype == torch.float32:
            disable_tf32()
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self.calls = 0
        width = nn_pipeline.WINDOW_LENGTH
        self._held = (np.zeros((0, width), np.uint8), np.zeros(0, np.uint8), np.zeros(0, np.int64))
        self._nonfinite = torch.zeros((), dtype=torch.int32, device=self.device)

    @property
    def held(self) -> int:
        """Windows taken in and not yet trained."""
        return len(self._held[0])

    def batches(self, fasta: Path) -> list[Batch]:
        """The full batches of ``fasta``'s windows and the held ones, on the
        device; the rest is held."""
        with trace.span("train.batches"):
            bases, names, contig_ids = nn_pipeline.encode_windows(fasta)
            labels = np.array([contig_label(str(n)) for n in names], np.uint8)[contig_ids]
            pool = [np.concatenate(pair) for pair in zip(self._held, (bases, labels, _window_bp(bases, contig_ids)))]
            rows, rest = _shuffle(len(pool[0]), self.batch_size, (self.seed, self.calls))
            self.calls += 1
            self._held = tuple(a[rest] for a in pool)
            taken = rows.reshape(-1)
            width = bases.shape[1]
            host = torch.from_numpy(np.column_stack((pool[0][taken], pool[1][taken])))
            if self.device.type == "cuda":
                host = host.pin_memory()
            on_device = host.to(self.device, non_blocking=True)
            tokens = conv.tokens_from_bases(on_device[:, :width])
            labels_d = on_device[:, width].long()
            bp = pool[2][rows].sum(axis=1)
            b = self.batch_size
            return [Batch(tokens[i * b : (i + 1) * b], labels_d[i * b : (i + 1) * b], int(bp[i])) for i in range(len(rows))]

    def fit(self, fasta: Path) -> int:
        """Trains on ``fasta``'s windows with the held ones; returns the
        number of steps."""
        batches = self.batches(fasta)
        windows = bp = 0
        for batch in batches:
            self.state, loss = self.step(self.state, batch.tokens, batch.labels, self.generator)
            self._nonfinite += ~torch.isfinite(loss)
            windows += batch.tokens.shape[0]
            bp += batch.bp
        nonfinite = int(self._nonfinite.item()) if batches else 0  # the call's one wait, for its last step
        self._nonfinite.zero_()
        trace.count_many({"train.steps": len(batches), "train.windows": windows, "train.bp": bp, "train.nonfinite_losses": nonfinite})
        return len(batches)


def trainable_from_numpy(tree: dict, device=None) -> dict:
    """Trainable leaves from a {group: {name: array}} tree of numpy arrays
    (a JAX ``TrainState.trainable`` through ``np.asarray``), as leaf tensors
    that require grad on ``device`` (None = the card)."""
    device = resolve_device(device)
    return {
        g: {n: torch.from_numpy(np.array(a, np.float32)).to(device).requires_grad_(True) for n, a in sub.items()}
        for g, sub in tree.items()
    }


def trainable_to_numpy(trainable: dict) -> dict:
    return {g: {n: t.detach().cpu().numpy() for n, t in sub.items()} for g, sub in trainable.items()}
