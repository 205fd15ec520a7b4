"""The yardstick's arithmetic: the card's published peaks, the least time a
piece of work can take on it, and the operations and bytes of the port's
kernels and of the IGLOO forward, counted from the published widths that
the configuration's file states (``reference.igloo.Widths``).

Peaks: NVIDIA H100 SXM data sheet, dense rates at the 700 W limit. K1's
adds and maxes run as f32 lane operations at 33.5 T/s (132 SMs x 128
lanes x 1.98 GHz, half the 67 TFLOP/s f32 rate, which counts an FMA as
two). The counts name the work the inputs need, whatever implements it:
an embedding lookup counts no multiply, padding positions count nothing,
so no share of a peak can pass 100% when a kernel is fused or removed.
"""

from __future__ import annotations

from benchmark.reference.igloo import Widths

PEAK_BYTES_PER_S = 3.35e12
PEAK_BF16_TC_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12
PEAK_F32_LANE_OPS = 33.5e12

# K1: f32 operations of the affine-gap recurrence per DP cell (f: 2 sub +
# max; h0: add + 2 max; t: sub + add; prefix max; e: sub; h: max; row max)
SW_OPS_PER_CELL = 12

BF16 = 2
F32 = 4


def least_seconds(bytes_moved: float = 0.0, bf16_tc_flops: float = 0.0, f32_flops: float = 0.0, lane_ops: float = 0.0) -> float:
    """The larger of the bytes over the memory bandwidth and the operations
    over the peak rate of their kind (summed over kinds)."""
    t_bytes = bytes_moved / PEAK_BYTES_PER_S
    t_ops = bf16_tc_flops / PEAK_BF16_TC_FLOPS + f32_flops / PEAK_F32_FLOPS + lane_ops / PEAK_F32_LANE_OPS
    return max(t_bytes, t_ops)


def k1_least_seconds(cells: float) -> float:
    """K1 over ``cells`` DP cells at the pairs' real lengths: bound by its
    operations (each pair's query row and profile are read once, a few
    hundred bytes against thousands of cell operations)."""
    return least_seconds(lane_ops=cells * SW_OPS_PER_CELL)


def k4_least_seconds(w: Widths, windows: int, launches: int) -> float:
    """K4 (causal conv, channels -> channels, bf16) over ``windows`` real
    windows of ``tokens`` positions in ``launches`` launches: each
    activation read and written once, the weights once a launch, 2 x K x C
    x C flops a position on the tensor cores."""
    C, K = w.channels, w.conv_width
    positions = windows * w.tokens
    bytes_moved = 2 * positions * C * BF16 + launches * (K * C * C + C) * BF16
    return least_seconds(bytes_moved, bf16_tc_flops=2 * K * C * C * positions)


def k2_least_seconds(w: Widths, windows: int, launches: int) -> float:
    """K2 (IGLOO patch reduction + value projection + max-pool, bf16) over
    ``windows`` windows in ``launches`` launches: y read once, the pooled
    values (bf16) and patch logits (f32) written once, the weights and
    patch table once a launch; the projection of the pooled positions on the
    tensor cores, the patch dot products in f32."""
    C, P, S = w.channels, w.patches, w.patch_size
    bytes_moved = (
        windows * (w.tokens * C * BF16 + P * F32 + w.pooled * C * BF16)
        + launches * (P * S * (4 + C * BF16) + C * C * BF16)
    )
    return least_seconds(
        bytes_moved,
        bf16_tc_flops=windows * 2 * w.pooled * w.pool * C * C,
        f32_flops=windows * 2 * P * S * C,
    )


def igloo_forward_flops(w: Widths, windows: int) -> float:
    """Model FLOPs of the IGLOO forward over ``windows`` windows: conv1 as a
    sum of K looked-up rows (adds only), conv2 and conv3, the IGLOO blocks
    (patch products, value projection of the pooled positions,
    patch-by-position logits, attention sum) and the three dense layers."""
    T, C, K, P, S, D = w.tokens, w.channels, w.conv_width, w.patches, w.patch_size, w.dense
    conv1 = T * K * C
    conv = 2 * T * K * C * C
    igloo = 2 * P * S * C + 2 * w.pooled * w.pool * C * C + 2 * P * w.pooled + 2 * w.pooled * C
    dense = 2 * (w.igloo_blocks * C * D + D * D + D * w.classes)
    return float(windows) * (conv1 + 2 * conv + w.igloo_blocks * igloo + dense)


def mfu_percent(bf16_flops: float, seconds: float, lane_ops: float = 0.0) -> float | None:
    """The work's least time at the peaks as a share of ``seconds``, in %."""
    if seconds <= 0 or (bf16_flops <= 0 and lane_ops <= 0):
        return None
    return 100.0 * least_seconds(bf16_tc_flops=bf16_flops, lane_ops=lane_ops) / seconds
