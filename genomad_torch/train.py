"""Training utilities for the IGLOO window classifier.

Port of ``genomad_tpu/train.py``: cross-entropy fine-tuning of the
inference-form parameters (``models.igloo.params_from_numpy``: the folded
patch tensor and the batch-norm affine are a valid reparametrization) with
AdamW, one step on one device (``make_train_step``) or data-parallel over a
``torch.distributed`` group (``make_sharded_train_step``).

The forward is ``igloo.apply_train``, plain differentiable PyTorch, as the
JAX step runs XLA's forms and not the Pallas kernels. Integer leaves (the
patch positions) are partitioned out of the trained leaves. The port's
prepared dict holds no derived leaves; ``_DERIVED_KEYS`` keeps the JAX
names so that both partitions have the same keys.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from genomad_torch.device import resolve_device
from genomad_torch.models import igloo

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
        state.optimizer.zero_grad(set_to_none=True)
        loss = loss_fn(state.trainable, state.static, tokens, labels, generator, dropout_rate)
        loss.backward()
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
        state.optimizer.zero_grad(set_to_none=True)
        loss = loss_fn(state.trainable, state.static, tokens[rows], labels[rows], None, dropout_rate, masks=masks)
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
        state.optimizer.step()
        return state._replace(step=state.step + 1), flat[-1]

    return train_step


def make_batches(tokens: np.ndarray, labels: np.ndarray, batch_size: int, seed: int = 0):
    """Shuffled full batches (drops the remainder), in the JAX package's order."""
    rng = np.random.default_rng(seed)
    order = rng.permutation(len(tokens))
    for i in range(0, len(order) - batch_size + 1, batch_size):
        idx = order[i : i + batch_size]
        yield tokens[idx], labels[idx]


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
