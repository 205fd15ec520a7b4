"""The share of the card's busy time in the training window spent in GEMM
kernels (cuBLAS and CUTLASS matrix products: names with ``gemm`` or
``gemv``, and cuBLAS's split-K reduction), in %: the split of the step
between its matrix products and the rest (gathers, scatters, elementwise
and reductions)."""

GEMM = ("gemm", "gemv", "splitkreduce")


def read(ctx):
    busy = ctx.device.busy_s()
    gemm = ctx.device.seconds_of(lambda n: any(k in n.lower() for k in GEMM))
    if busy <= 0 or gemm <= 0:
        return None
    return 100.0 * gemm / busy
