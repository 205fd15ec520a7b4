"""The IGLOO patch reduction: kernel K2 (``fused_reduce``).

Counterpart of ``genomad_tpu/ops/patch_reduce.py`` ``fused_reduce``. The
kernel is written by hand for Hopper in ``genomad_torch/csrc/fused_reduce.cu``
(see the note at its top); the plain PyTorch version is beside it here. The
wrapper launches the kernel for CUDA tensors (or raises) and takes the plain
version only for tensors on the CPU. ``fused_reduce.launches`` counts kernel
launches.

The JAX kernel's tile plan (``build_plan``) existed to avoid TPU gathers;
only its results are kept: the folded per-slot weights ``w_patch`` (P, S, C)
are gathered against the rows the patches name.
"""

from __future__ import annotations

import torch

from genomad_torch.ops import _build

POOL = 8
_TILE_ROWS = 64  # rows per block in the kernel (f32 smem: 64 x C floats)

_SIGNATURES = {
    "fused_reduce_launch": [_build.P] * 6 + [_build.I] * 6 + [_build.P],
}


def fused_reduce_plain(y: torch.Tensor, patches: torch.Tensor, w_patch: torch.Tensor, w_v: torch.Tensor):
    """(mpi (B, P) f32, pooled (B, L // 8, C) in y's dtype); slot dots in
    f32, slots summed in order, projection and max in f32."""
    B, L, C = y.shape
    S = patches.shape[1]
    gathered = y[:, patches.long()].float()  # (B, P, S, C)
    slots = (gathered * w_patch.float()).sum(-1)  # (B, P, S)
    mpi = slots[..., 0]
    for s in range(1, S):
        mpi = mpi + slots[..., s]
    n_pool = L // POOL
    proj = torch.matmul(y[:, : n_pool * POOL].float(), w_v.float())
    pooled = proj.view(B, n_pool, POOL, C).amax(dim=2).to(y.dtype)
    return mpi, pooled


def fused_reduce(y: torch.Tensor, patches: torch.Tensor, w_patch: torch.Tensor, w_v: torch.Tensor):
    """Patch reduction + value projection + max-pool by 8, in one pass over y.

    y: (B, L, C) float32 or bfloat16; patches: (P, S) int32 positions in
    [0, L) (the kernel trusts this range; the model checks it once when it
    is built); w_patch: (P, S, C) and w_v: (C, C) in y's dtype. Returns
    mpi (B, P) float32 and pooled (B, L // 8, C) in y's dtype. The bf16
    kernel takes C = 128, the f32 kernel C <= 192.
    """
    if not _build.on_cuda(y, patches, w_patch, w_v):
        return fused_reduce_plain(y, patches, w_patch, w_v)
    _build.require(y.dim() == 3, "y must be (B, L, C)")
    B, L, C = y.shape
    _build.require(patches.dim() == 2 and patches.dtype == torch.int32, "patches must be (P, S) int32")
    P, S = patches.shape
    _build.require(w_patch.shape == (P, S, C) and w_v.shape == (C, C), "w_patch must be (P, S, C) and w_v (C, C)")
    _build.require(y.dtype in _build.DTYPES and w_patch.dtype == y.dtype and w_v.dtype == y.dtype, "y/w_patch/w_v must share a float32 or bfloat16 dtype")
    _build.require(all(t.is_contiguous() for t in (y, patches, w_patch, w_v)), "inputs must be contiguous")
    if y.dtype == torch.bfloat16:
        _build.require(C == _build.TC_CHANNELS, f"the bf16 kernel takes C = {_build.TC_CHANNELS}")
    else:
        _build.require(_TILE_ROWS * C * 4 <= 48 * 1024, "the f32 kernel takes C <= 192")
    mpi = torch.empty((B, P), dtype=torch.float32, device=y.device)
    pooled = torch.empty((B, L // POOL, C), dtype=y.dtype, device=y.device)
    if B == 0 or L == 0:
        return mpi, pooled
    lib = _build.load("fused_reduce", _SIGNATURES)
    with torch.cuda.device(y.device):
        err = lib.fused_reduce_launch(
            y.data_ptr(), patches.data_ptr(), w_patch.data_ptr(), w_v.data_ptr(), mpi.data_ptr(), pooled.data_ptr(),
            B, L, P, S, C, int(y.dtype == torch.bfloat16), _build.stream_ptr(y.device),
        )
    _build.check(err, "fused_reduce")
    fused_reduce.launches += 1
    return mpi, pooled


fused_reduce.launches = 0
