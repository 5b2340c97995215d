"""K1 and K2: associative scans over structure-of-arrays leaves.

``associative_scan(op, x, reverse)`` is the inclusive prefix (suffix when
``reverse``) of one of eight fixed combines over ``x`` of shape (L, n): L
leaves of n elements, the layout the JAX package scans; or of shape
(L, B, n), B independent rows each scanned along n (the JAX package's
``vmap`` of the scan, which gives its Pallas kernel a batch grid). It ports the two
Pallas scans of ``gps_optimize_slam_tpu/ops/pallas_scan.py`` and routes
between them as ``make_scan_fn`` does, at this card's own crossover
(:func:`scan_route`):

* on a CUDA tensor it launches :func:`scan_block` (K1, ``csrc/scan.cu``: a
  single pass over many blocks with decoupled look-back; ports
  ``associative_scan_vmem``) up to the length :func:`scan_route` gives it, and
  :func:`scan_tiled` (K2, ``csrc/scan_tiled.cu``: the same look-back protocol
  in one launch of persistent blocks that stage the next tile while they
  scan the present one, each element read once; ports
  ``associative_scan_tiled``) beyond it, or raises;
* on a CPU tensor it runs :func:`scan_plain`, the same function as a
  Hillis-Steele ladder of whole-tensor combines (the JAX package's CPU scan,
  ``pallas_scan.associative_scan_fori``).

A batched scan takes either kernel's batch grid, by the same route: one
launch over every row's tiles (K1: a block a tile; K2: its persistent
blocks drawing tickets over all rows' tiles). Each row meets the tiles and
the in-tile combines of the single-row call on it, and agrees with that
call as two single-row calls agree with each other (the look-back's walk,
which folds whatever its predecessors have published, changes from run to
run).

Argument order follows ``jax.lax.associative_scan``: the accumulated
composite is the FIRST combine argument in both directions (under
``reverse`` that is the later composite). Every output is combined with its
exclusive prefix at least once (the first with the identity), as in the
Pallas ladder; only the Möbius scan notices (its first element comes out
normalised), and its consumer reads a scale-free ratio.

The combines are the JAX package's, written once here for the plain version
and once in ``csrc/scan_ops.cuh`` (shared by both kernels) in the same
arithmetic order.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Tuple

import torch

from gps_optimize_slam_tpu_torch.ops import _build

Leaves = List[torch.Tensor]


def _mmul(a, b):
    return [
        a[3 * i] * b[j] + a[3 * i + 1] * b[3 + j] + a[3 * i + 2] * b[6 + j]
        for i in range(3)
        for j in range(3)
    ]


def _mvec(a, v):
    return [a[3 * i] * v[0] + a[3 * i + 1] * v[1] + a[3 * i + 2] * v[2] for i in range(3)]


def _mT(a):
    return [a[3 * j + i] for i in range(3) for j in range(3)]


def _minv(m):
    """Adjugate inverse on scalar components (kalman_parallel._minv)."""
    m00, m01, m02, m10, m11, m12, m20, m21, m22 = m
    c00 = m11 * m22 - m12 * m21
    c01 = m02 * m21 - m01 * m22
    c02 = m01 * m12 - m02 * m11
    c10 = m12 * m20 - m10 * m22
    c11 = m00 * m22 - m02 * m20
    c12 = m02 * m10 - m00 * m12
    c20 = m10 * m21 - m11 * m20
    c21 = m01 * m20 - m00 * m21
    c22 = m00 * m11 - m01 * m10
    inv_det = 1.0 / (m00 * c00 + m01 * c10 + m02 * c20)
    return [c * inv_det for c in (c00, c01, c02, c10, c11, c12, c20, c21, c22)]


def sym_expand(s):
    """(xx, xy, xz, yy, yz, zz) → row-major 9 components."""
    xx, xy, xz, yy, yz, zz = s
    return [xx, xy, xz, xy, yy, yz, xz, yz, zz]


def _sym6(m):
    return [m[0], m[1], m[2], m[4], m[5], m[8]]


def _quat_chain(a: Leaves, b: Leaves) -> Leaves:
    x1, y1, z1, w1 = a
    x2, y2, z2, w2 = b
    x = w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2
    y = w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2
    z = w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2
    w = w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2
    n = torch.sqrt(x * x + y * y + z * z + w * w)
    big = n > 1e-9
    inv = torch.where(big, 1.0 / torch.where(big, n, torch.ones_like(n)), torch.ones_like(n))
    return [x * inv, y * inv, z * inv, w * inv]


def _filter(e1: Leaves, e2: Leaves) -> Leaves:
    """Affine Kalman filter elements (Särkkä eq. 10), leaves A[9], b[3],
    C[6], eta[3], J[6] (kalman_parallel._combine_filter)."""
    A1, b1, C1, eta1, J1 = e1[0:9], e1[9:12], sym_expand(e1[12:18]), e1[18:21], sym_expand(e1[21:27])
    A2, b2, C2, eta2, J2 = e2[0:9], e2[9:12], sym_expand(e2[12:18]), e2[18:21], sym_expand(e2[21:27])
    t = _mmul(C1, J2)
    t[0], t[4], t[8] = t[0] + 1.0, t[4] + 1.0, t[8] + 1.0
    M = _minv(t)
    A2M = _mmul(A2, M)
    A = _mmul(A2M, A1)
    v = [x + y for x, y in zip(b1, _mvec(C1, eta2))]
    b = [x + y for x, y in zip(_mvec(A2M, v), b2)]
    C = [x + y for x, y in zip(_mmul(_mmul(A2M, C1), _mT(A2)), C2)]
    A1tMt = _mT(_mmul(M, A1))
    v = [x - y for x, y in zip(eta2, _mvec(J2, b1))]
    eta = [x + y for x, y in zip(_mvec(A1tMt, v), eta1)]
    J = [x + y for x, y in zip(_mmul(_mmul(A1tMt, J2), A1), J1)]
    return A + b + _sym6(C) + eta + _sym6(J)


def _rts(first: Leaves, second: Leaves) -> Leaves:
    """RTS suffix composition, leaves M[9], c[3]; ``first`` is the
    accumulated later-in-time composite."""
    M2, c2 = first[:9], first[9:]
    M1, c1 = second[:9], second[9:]
    return _mmul(M1, M2) + [x + y for x, y in zip(_mvec(M1, c2), c1)]


def _mobius(p: Leaves, q: Leaves) -> Leaves:
    """Normalised 2×2 homogeneous products (tridiag._mobius_combine)."""
    p00, p01, p10, p11 = p
    q00, q01, q10, q11 = q
    m00 = q00 * p00 + q01 * p10
    m01 = q00 * p01 + q01 * p11
    m10 = q10 * p00 + q11 * p10
    m11 = q10 * p01 + q11 * p11
    scale = torch.maximum(
        torch.maximum(torch.abs(m00), torch.abs(m01)),
        torch.maximum(torch.abs(m10), torch.abs(m11)),
    )
    inv = 1.0 / torch.clamp(scale, min=torch.finfo(m00.dtype).tiny)
    return [m00 * inv, m01 * inv, m10 * inv, m11 * inv]


def _affine3(a: Leaves, b: Leaves) -> Leaves:
    """Affine composition on (alpha, beta[3]) (tridiag._affine_combine)."""
    return [b[0] * a[0]] + [b[0] * x + y for x, y in zip(a[1:], b[1:])]


def _add(a: Leaves, b: Leaves) -> Leaves:
    return [x + y for x, y in zip(a, b)]


def _max(a: Leaves, b: Leaves) -> Leaves:
    return [torch.maximum(x, y) for x, y in zip(a, b)]


def _min(a: Leaves, b: Leaves) -> Leaves:
    return [torch.minimum(x, y) for x, y in zip(a, b)]


_INF = float("inf")
_EYE9 = (1.0, 0.0, 0.0, 0.0, 1.0, 0.0, 0.0, 0.0, 1.0)

# name → (code in csrc/scan_ops.cuh:dispatch_op, combine, two-sided
# identity). The leaf count is the identity's length.
OPS: Dict[str, Tuple[int, Callable, Tuple[float, ...]]] = {
    "quat_chain": (0, _quat_chain, (0.0, 0.0, 0.0, 1.0)),
    "filter": (1, _filter, _EYE9 + (0.0,) * 18),
    "rts": (2, _rts, _EYE9 + (0.0,) * 3),
    "mobius": (3, _mobius, (1.0, 0.0, 0.0, 1.0)),
    "affine3": (4, _affine3, (1.0, 0.0, 0.0, 0.0)),
    "add2": (5, _add, (0.0, 0.0)),
    "max3": (6, _max, (-_INF,) * 3),
    "min3": (7, _min, (_INF,) * 3),
}


def _check(op: str, x: torch.Tensor) -> None:
    if op not in OPS:
        raise ValueError(f"unknown scan op {op!r}")
    L = len(OPS[op][2])
    if x.ndim not in (2, 3) or x.shape[0] != L:
        raise ValueError(f"{op} scans ({L}, n) or ({L}, B, n) leaves, got {tuple(x.shape)}")
    if x.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"scan leaves must be float32 or float64, got {x.dtype}")


def scan_plain(op: str, x: torch.Tensor, reverse: bool = False) -> torch.Tensor:
    """The plain PyTorch scan: a Hillis-Steele ladder of ceil(log2 n)
    whole-tensor combines (at least one, so the first element also meets
    the identity, as in the kernel), along the last axis; with (L, B, n)
    leaves every row takes the same elementwise combines as alone."""
    _check(op, x)
    _, combine, ident = OPS[op]
    n = x.shape[-1]
    if n == 0:
        return x.clone()
    xs = list((x.flip(-1) if reverse else x).unbind(0))
    off = 1
    while True:
        shifted = [
            torch.cat([torch.full((*leaf.shape[:-1], min(off, n)), v, dtype=x.dtype, device=x.device),
                       leaf[..., : n - off]], -1)
            for v, leaf in zip(ident, xs)
        ]
        xs = combine(shifted, xs)
        off *= 2
        if off >= n:
            break
    out = torch.stack(xs)
    return out.flip(-1) if reverse else out


# The longest scan K1 takes. The JAX package routes by a 4 MiB VMEM budget
# (pallas_scan.py:62, 156-157: K1 while 2·L·n_pad·itemsize fits), which means
# nothing on this card. Measured on an NVIDIA H100 80GB HBM3 at a 700.00 W
# power limit (chip_smoke.py, phase 1 "routes", 271 to 524,289 elements, two
# runs): the 2-4-leaf combines and the 12-leaf RTS scan take the same time on
# both kernels at every length, within the runs' spread; the 27-leaf filter
# is 1.2-1.7x faster on K1 up to 16,385 elements (K2's larger tiles leave
# most SMs idle there), level at 65,537, and 1.1-1.3x faster on K2 from
# 131,073.
#
# A batch of rows (the same card, chip_smoke.py phase 1 "routes", float64,
# every combine, 2 to 64 rows of 16,385 to 524,289 elements, two runs)
# follows rows x elements: up to about 2^20 elements in all the two batch
# grids were level within the runs' spread (the median combine's ratio
# 0.95-1.06), and from 2^21 (4 x 524,289, 8 x 524,289, 16 x 131,073, 64 x
# 65,537) K1's grid was ahead (the median combine 1.08-1.18x, up to 1.5x).
# K1's blocks (one a tile, up to three an SM) keep more warps in flight
# than K2's one persistent block an SM once a batch fills the card, and
# K2's larger tiles no longer pay for it. So a batch takes K2 for rows past
# BLOCK_MAX_ELEMENTS while it holds at most BATCH_TILED_MAX_ELEMENTS
# elements, K1's grid beyond; a single row keeps the single-row rule.
BLOCK_MAX_ELEMENTS = 65_536
BATCH_TILED_MAX_ELEMENTS = 1 << 20


def scan_route(n_leaves: int, n: int, itemsize: int, batch: int = 1) -> str:
    """"block" (K1) or "tiled" (K2) for a scan of ``n_leaves`` leaves of
    ``n`` elements of ``itemsize`` bytes, in each of ``batch`` rows: K2 for
    rows of more than ``BLOCK_MAX_ELEMENTS`` elements, one row or a batch
    of at most ``BATCH_TILED_MAX_ELEMENTS`` elements in all, K1 otherwise,
    the crossovers measured on this card (neither depended on the leaf
    count or the dtype within the runs' spread). Phase 4's 4,661 poses and
    phase 7's buckets stay on K1, and so does phase 10's bucket of four
    long logs (2,097,152 elements a leaf); the chunked path's 262,145-element
    chunks and the fuse-batch command's two 70,000-pose logs take K2."""
    if n <= BLOCK_MAX_ELEMENTS:
        return "block"
    return "tiled" if batch == 1 or batch * n <= BATCH_TILED_MAX_ELEMENTS else "block"


def associative_scan(op: str, x: torch.Tensor, reverse: bool = False) -> torch.Tensor:
    """Inclusive scan of ``op`` over the (L, n) leaves ``x`` (suffix scan
    when ``reverse``), or over each row of (L, B, n) leaves on its own,
    routed to K1 or K2 by :func:`scan_route`; both take :func:`scan_plain`
    for CPU tensors."""
    _check(op, x)
    batch = x.shape[1] if x.ndim == 3 else 1
    if scan_route(x.shape[0], x.shape[-1], x.element_size(), batch) == "block":
        return scan_block(op, x, reverse)
    return scan_tiled(op, x, reverse)


def block_tile(op: str) -> int:
    """Elements per tile (one thread block) of K1 for ``op``: kScanThreads
    times the combine's items per thread (``csrc/scan_lookback.cuh``).
    Builds the kernels on first use."""
    return _build.library().gps_scan_tile(OPS[op][0])


def scan_block(op: str, x: torch.Tensor, reverse: bool = False) -> torch.Tensor:
    """K1: the single-pass look-back scan (``csrc/scan.cu``), at any n, on
    (L, n) leaves or, in one launch over every row's tiles, on (L, B, n)
    leaves. CPU tensors take :func:`scan_plain`."""
    _check(op, x)
    if x.device.type == "cpu":
        return scan_plain(op, x, reverse)
    _build.require_cuda(x)
    out = torch.empty_like(x)
    n = x.shape[-1]
    batch = x.shape[1] if x.ndim == 3 else 1
    if n == 0 or batch == 0:
        return out
    lib = _build.library()
    code, dt = OPS[op][0], _build.dtype_code(x)
    scratch = torch.empty((lib.gps_scan_scratch_bytes(code, dt, n, batch),), dtype=torch.uint8,
                          device=x.device)
    with torch.cuda.device(x.device):
        rc = lib.gps_scan(code, dt, x.data_ptr(), out.data_ptr(), n, batch, int(reverse),
                          scratch.data_ptr(), _build.stream(x.device))
    _build.check(rc, f"scan {op}")
    with _build.COUNT_LOCK:
        scan_block.launches[op] += 1
    return out


def tiled_tile(op: str, dtype: torch.dtype) -> int:
    """Elements per tile of K2 for ``op`` in ``dtype``: kScanThreads times
    the items per thread that two staging buffers allow
    (``csrc/scan_tiled.cu``). Builds the kernels on first use."""
    return _build.library().gps_scan_tiled_tile(OPS[op][0], _build.dtype_code(torch.empty(0, dtype=dtype)))


def scan_tiled(op: str, x: torch.Tensor, reverse: bool = False) -> torch.Tensor:
    """K2: the single-pass look-back scan for long leaves
    (``csrc/scan_tiled.cu``), at any n, on (L, n) leaves or, in the same one
    launch with tickets over every row's tiles, on (L, B, n) leaves: about
    one block per SM slot, each drawing tiles in ticket order and copying
    the next tile (the next row's first, at a row's end) into a second
    shared-memory buffer (``cp.async``) while the present one is folded,
    looked back and written. The 2-4-leaf combines are bound by their bytes,
    the 27-leaf filter by the operations of the scan's own structure. CPU
    tensors take :func:`scan_plain`."""
    _check(op, x)
    if x.device.type == "cpu":
        return scan_plain(op, x, reverse)
    _build.require_cuda(x)
    out = torch.empty_like(x)
    n = x.shape[-1]
    batch = x.shape[1] if x.ndim == 3 else 1
    if n == 0 or batch == 0:
        return out
    lib = _build.library()
    code, dt = OPS[op][0], _build.dtype_code(x)
    scratch = torch.empty((lib.gps_scan_tiled_scratch_bytes(code, dt, n, batch),), dtype=torch.uint8,
                          device=x.device)
    with torch.cuda.device(x.device):
        rc = lib.gps_scan_tiled(code, dt, x.data_ptr(), out.data_ptr(), scratch.data_ptr(),
                                scratch.numel(), n, batch, int(reverse), _build.stream(x.device))
    _build.check(rc, f"tiled scan {op}")
    with _build.COUNT_LOCK:
        scan_tiled.launches[op] += 1
    return out


# Kernel launches per combine, counted where each kernel is launched.
scan_block.launches = {op: 0 for op in OPS}
scan_tiled.launches = {op: 0 for op in OPS}
