"""The yardstick's arithmetic: the card's published peaks, the operations of
a scan combine, and the least time a piece of work needs.

Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates): 3.35 TB/s
of HBM3, 67 TFLOP/s float32 and 34 TFLOP/s float64 outside the tensor
cores. A card set below its 700 W limit runs slower; every run prints the
card's power limit beside its shares.
"""

from __future__ import annotations

PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "float64": 34e12}

# Floating-point operations of one combine of the scans, counted from the
# combines' definitions (a 3x3 product is 45, a matrix-vector product 15,
# the adjugate inverse 42): the filter's 7-state step, the RTS suffix, the
# quaternion chain, the Möbius variance map, the affine map, and the
# integer-valued sums, maxima and minima of the alignment's segments.
COMBINE_FLOPS = {"quat_chain": 41, "filter": 489, "rts": 63, "mobius": 25, "affine3": 7,
                 "add2": 2, "max3": 3, "min3": 3}

# The names the combines carry in the kernels' template arguments.
COMBINE_OF_TYPE = {"QuatChain": "quat_chain", "Filter": "filter", "RtsSuffix": "rts", "Mobius": "mobius",
                   "Affine3": "affine3", "Add2": "add2", "Max3": "max3", "Min3": "min3"}

ITEMSIZE = {"float32": 4, "float64": 8}


def bound_s(nbytes: float, flops: float, dtype: str) -> float:
    """The least seconds: the larger of the bytes at the memory rate and
    the operations at the peak of ``dtype``."""
    return max(nbytes / PEAK_BYTES_PER_S, flops / PEAK_FLOPS[dtype])


def scan_work(op: str, shape, dtype: str):
    """(bytes, operations) of one scan of ``op`` over leaves of ``shape``
    ((L, n) or (L, B, n)): every leaf read once and written once, and
    n - 1 combines a row."""
    numel = 1
    for d in shape:
        numel *= int(d)
    rows = numel // int(shape[0]) // int(shape[-1])
    return 2 * numel * ITEMSIZE[dtype], COMBINE_FLOPS[op] * rows * (int(shape[-1]) - 1)

