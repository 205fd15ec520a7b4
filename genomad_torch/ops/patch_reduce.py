"""The IGLOO patch reduction: kernels K2 (``fused_reduce``) and K3
(``patch_reduce``).

Counterparts of ``genomad_tpu/ops/patch_reduce.py`` ``fused_reduce`` and
``patch_reduce``. Both kernels are written by hand for Hopper in one source,
``genomad_torch/csrc/fused_reduce.cu`` (see the note at its top): K3 is K2
with the value projection and max-pool switched off at compile time, so its
mpi is K2's bit for bit. The plain PyTorch versions are beside them here. A
wrapper launches its kernel for CUDA tensors (or raises) and takes the plain
version only for tensors on the CPU. ``<wrapper>.launches`` counts kernel
launches.

The JAX kernel's tile plan (``build_plan``) turned TPU gathers into MXU
work with one-hot masks. Its idea, the slots grouped by tile of y, is kept
without the one-hot product: :func:`slot_table` lists each 64-row tile's
(p, s) slots with their folded weights ``w_patch`` (P, S, C) in the same
order, and the bf16 kernel dots each slot's weights with the tile's row
once the tile is in shared memory.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from genomad_torch.ops import _build

POOL = 8
_TILE_ROWS = 64  # rows of y per tile in the kernels (f32 smem: 64 x C floats)
# the bf16 kernel keeps the slot table and one batch row's P * S slot dots
# in shared memory
MAX_SLOTS = 12_288

_SIGNATURES = {
    "fused_reduce_launch": [_build.P] * 8 + [_build.I] * 7 + [_build.P],
    "patch_reduce_launch": [_build.P] * 6 + [_build.I] * 7 + [_build.P],
}


class SlotTable(NamedTuple):
    """The patches as the bf16 kernel reads them (:func:`slot_table`)."""

    index: torch.Tensor  # int32 [start (n_tiles + 1) | entries (P * S)]
    weights: torch.Tensor  # (C // 8, P * S, 8): w_patch's slot rows in entry order, by 8-channel cell


def slot_table(patches: torch.Tensor, w_patch: torch.Tensor, n_tiles: int | None = None) -> SlotTable:
    """The (p, s) slots of ``patches`` grouped by the 64-row tile of y that
    their position falls in, and their weights in the same order.

    ``index`` is int32 ``[start (n_tiles + 1) | entries (P * S)]``: tile t's
    slots are ``entries[start[t]:start[t + 1]]``, ordered by position (then
    by (p, s)), each entry ``(p * S + s) * 64 + position % 64``.
    ``weights[c, k]`` holds channels 8c..8c+7 of entry k's row of ``w_patch``
    (P, S, C), so that neighbouring slots' cells are neighbours in memory.
    Positions must lie in [0, 64 n_tiles); ``n_tiles`` defaults to the last
    tile that holds a slot (one host sync), and the table serves any y whose
    positions cover the patches. Built on the patches' device."""
    if n_tiles is None:
        n_tiles = int(patches.max()) // _TILE_ROWS + 1 if patches.numel() else 1
    flat = patches.reshape(-1).long()
    order = torch.argsort(flat, stable=True)
    start = torch.searchsorted(flat[order] // _TILE_ROWS, torch.arange(n_tiles + 1, device=patches.device))
    entries = order * _TILE_ROWS + flat[order] % _TILE_ROWS
    C = w_patch.shape[-1]
    weights = w_patch.reshape(-1, C)[order].reshape(-1, C // 8, 8).transpose(0, 1).contiguous()
    return SlotTable(torch.cat([start, entries]).to(torch.int32), weights)


def patch_reduce_plain(y: torch.Tensor, patches: torch.Tensor, w_patch: torch.Tensor) -> torch.Tensor:
    """mpi (B, P) f32: slot dots in f32, slots summed in order."""
    S = patches.shape[1]
    gathered = y[:, patches.long()].float()  # (B, P, S, C)
    slots = (gathered * w_patch.float()).sum(-1)  # (B, P, S)
    mpi = slots[..., 0]
    for s in range(1, S):
        mpi = mpi + slots[..., s]
    return mpi


def fused_reduce_plain(y: torch.Tensor, patches: torch.Tensor, w_patch: torch.Tensor, w_v: torch.Tensor):
    """(mpi (B, P) f32, pooled (B, L // 8, C) in y's dtype); mpi as
    :func:`patch_reduce_plain`, projection and max in f32."""
    B, L, C = y.shape
    mpi = patch_reduce_plain(y, patches, w_patch)
    n_pool = L // POOL
    proj = torch.matmul(y[:, : n_pool * POOL].float(), w_v.float())
    pooled = proj.view(B, n_pool, POOL, C).amax(dim=2).to(y.dtype)
    return mpi, pooled


def fused_reduce(y: torch.Tensor, patches: torch.Tensor, w_patch: torch.Tensor, w_v: torch.Tensor, *, slots=None):
    """Patch reduction + value projection + max-pool by 8, in one pass over y.

    y: (B, L, C) float32 or bfloat16; patches: (P, S) int32 positions in
    [0, L) (the kernel trusts this range; the model checks it once when it
    is built); w_patch: (P, S, C) and w_v: (C, C) in y's dtype. Returns
    mpi (B, P) float32 and pooled (B, L // 8, C) in y's dtype. The bf16
    kernel takes C = 128 and P * S <= MAX_SLOTS, and reads the patches
    through ``slots``, ``slot_table(patches, w_patch)`` (built here when it
    is not given; trusted like the patches); the f32 kernel takes C <= 192.
    """
    if not _build.on_cuda(y, patches, w_patch, w_v):
        return fused_reduce_plain(y, patches, w_patch, w_v)
    _build.refuse_grad("fused_reduce", y, w_patch, w_v)
    B, L, C, P, S = _check(y, patches, w_patch, w_v)
    _build.require(w_v.shape == (C, C), "w_v must be (C, C)")
    if y.dtype == torch.bfloat16:
        _build.require(C == _build.TC_CHANNELS, f"the bf16 kernel takes C = {_build.TC_CHANNELS}")
        _check_tc(y, P, S, w_v)
    else:
        _build.require(_TILE_ROWS * C * 4 <= 48 * 1024, "the f32 kernel takes C <= 192")
    mpi = torch.empty((B, P), dtype=torch.float32, device=y.device)
    pooled = torch.empty((B, L // POOL, C), dtype=y.dtype, device=y.device)
    if B == 0 or L == 0:
        return mpi, pooled
    index, weights, table_tiles = _slots_for(y, patches, w_patch, slots)
    lib = _build.load("fused_reduce", _SIGNATURES)
    with torch.cuda.device(y.device):
        err = lib.fused_reduce_launch(
            y.data_ptr(), patches.data_ptr(), w_patch.data_ptr(), w_v.data_ptr(), index, weights, mpi.data_ptr(),
            pooled.data_ptr(), B, L, P, S, C, table_tiles, int(y.dtype == torch.bfloat16), _build.stream_ptr(y.device),
        )
    _build.check(err, "fused_reduce")
    fused_reduce.launches += 1
    return mpi, pooled


fused_reduce.launches = 0


def patch_reduce(y: torch.Tensor, patches: torch.Tensor, w_patch: torch.Tensor, *, slots=None) -> torch.Tensor:
    """The patch reduction alone: mpi (B, P) float32, as ``fused_reduce``
    computes it, without the value projection.

    y: (B, L, C) float32 or bfloat16; patches: (P, S) int32 positions in
    [0, L) (trusted, as in ``fused_reduce``); w_patch: (P, S, C) in y's
    dtype; ``slots`` as in ``fused_reduce``. Any C (bf16 at C = 128 takes
    K2's body, with its limits).
    """
    if not _build.on_cuda(y, patches, w_patch):
        return patch_reduce_plain(y, patches, w_patch)
    _build.refuse_grad("patch_reduce", y, w_patch)
    B, L, C, P, S = _check(y, patches, w_patch)
    if y.dtype == torch.bfloat16 and C == _build.TC_CHANNELS:
        _check_tc(y, P, S)
    mpi = torch.empty((B, P), dtype=torch.float32, device=y.device)
    if B == 0 or L == 0:
        return mpi
    index, weights, table_tiles = _slots_for(y, patches, w_patch, slots)
    lib = _build.load("fused_reduce", _SIGNATURES)
    with torch.cuda.device(y.device):
        err = lib.patch_reduce_launch(
            y.data_ptr(), patches.data_ptr(), w_patch.data_ptr(), index, weights, mpi.data_ptr(),
            B, L, P, S, C, table_tiles, int(y.dtype == torch.bfloat16), _build.stream_ptr(y.device),
        )
    _build.check(err, "patch_reduce")
    patch_reduce.launches += 1
    return mpi


patch_reduce.launches = 0


def _check(y, patches, w_patch, *weights):
    """The checks both kernels make: returns (B, L, C, P, S)."""
    _build.require(y.dim() == 3, "y must be (B, L, C)")
    B, L, C = y.shape
    _build.require(patches.dim() == 2 and patches.dtype == torch.int32, "patches must be (P, S) int32")
    P, S = patches.shape
    _build.require(w_patch.shape == (P, S, C), "w_patch must be (P, S, C)")
    _build.require(y.dtype in _build.DTYPES and all(t.dtype == y.dtype for t in (w_patch, *weights)), "y and the weights must share a float32 or bfloat16 dtype")
    _build.require(all(t.is_contiguous() for t in (y, patches, w_patch, *weights)), "inputs must be contiguous")
    return B, L, C, P, S


def _check_tc(y, P, S, *weights):
    """The checks of the bf16 tensor-core body (C = 128): it reads y by TMA
    and w_v in 16-byte cells, and keeps the slot table and a row's P * S
    slot dots in shared memory."""
    _build.require(all(t.data_ptr() % 16 == 0 for t in (y, *weights)), "the bf16 kernel takes 16-byte aligned inputs")
    _build.require(P * S <= MAX_SLOTS, f"the bf16 kernel takes P * S <= {MAX_SLOTS}")


def _slots_for(y, patches, w_patch, slots):
    """(index pointer, weights pointer, tile count) of the slot table the
    bf16 body at C = 128 reads: ``slots`` when given (checked for type,
    device and size), else built for y's length; null for the other
    bodies, which gather the patches' rows themselves."""
    B, L, C = y.shape
    P, S = patches.shape
    if y.dtype != torch.bfloat16 or C != _build.TC_CHANNELS:
        return 0, 0, 0
    if slots is None:
        slots = slot_table(patches, w_patch, -(-L // _TILE_ROWS))
    index, weights = slots
    _build.require(
        index.dtype == torch.int32 and index.dim() == 1 and index.is_contiguous() and index.device == y.device
        and index.numel() >= P * S + 2,
        "slots must be slot_table(patches, w_patch): an int32 index on y's device",
    )
    _build.require(
        weights.shape == (C // 8, P * S, 8) and weights.dtype == y.dtype and weights.is_contiguous()
        and weights.device == y.device and weights.data_ptr() % 16 == 0,
        "slots must be slot_table(patches, w_patch): weights (C // 8, P * S, 8) in y's dtype on y's device",
    )
    return index.data_ptr(), weights.data_ptr(), index.numel() - 1 - P * S
