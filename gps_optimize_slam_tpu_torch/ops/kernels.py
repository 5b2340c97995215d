"""K3 and K4 (nearest-neighbour distance) and K5 (RANSAC consensus counts).

Ports the three Pallas kernels of ``gps_optimize_slam_tpu/ops/pallas_kernels.py``
and the array code around them:

* :func:`nn_min_dist2`: per query, the minimum squared distance to any
  valid candidate, routed as the JAX package routes it (:func:`nn_route`):
  :func:`nn_resident` (K3, ``csrc/nn.cu``; ports the resident form) while
  the candidate image fits the JAX package's 8 MiB budget, :func:`nn_grid`
  (K4, ``csrc/nn_grid.cu``; ports the pipelined 2-D grid) beyond it. Both
  wrappers compute the per-32-point AABB bounds (:func:`tile_keep_mask`);
  K3's compacts each query tile's kept candidate tiles to the front with a
  stable sort and walks only those, K4's launches one block per (query
  tile, candidate tile) pair and skips the pairs the mask drops.
* :func:`ransac_counts`: per Sim(3) trial, the number of valid points within
  the residual threshold (``ransac_counts``), launched from
  ``csrc/ransac_counts.cu`` in the exact elementwise form.

Each wrapper takes its plain PyTorch version (``*_plain``, below) for CPU
tensors only; a CUDA tensor launches the kernel or raises. Both kernels
compute in the inputs' dtype: the golden run works in float64 UTM
coordinates (~5.4e6 m), where a float32 distance would be off by ~0.5 m.
"""

from __future__ import annotations

import torch

from gps_optimize_slam_tpu_torch.ops import _build

TILE_N = 128  # queries per block of csrc/nn.cu and csrc/nn_grid.cu
TILE_M = 1024  # candidates per tile of both
SUB = 32  # AABB segment length of the pruning bounds (divides both tiles)
_BIG = 3.4e38  # non-finite coordinates are clamped here for the bounds only
# The JAX package's budget for its resident kernel (pallas_kernels.py:85,
# 263): the (8, m_pad) float32 candidate image within 8 MiB.
RESIDENT_BUDGET_BYTES = 8 * 1024 * 1024
# Bound elements per row block of tile_keep_mask (about 50 MB for each of
# its float64 (rows, m_sub, 3) intermediates).
_KEEP_BLOCK_ELEMS = 1 << 21


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def nn_route(m: int) -> str:
    """"resident" (K3) or "grid" (K4) for ``m`` candidates: the rule of
    ``pallas_kernels.nn_min_dist2``, K3 while m_pad·8·4 B ≤ 8 MiB
    (m_pad = m rounded up to TILE_M; K4 above 262,144 candidates)."""
    m_pad = _round_up(max(m, 8), TILE_M)
    return "resident" if m_pad * 8 * 4 <= RESIDENT_BUDGET_BYTES else "grid"


def tile_keep_mask(tp: torch.Tensor, cp: torch.Tensor, vm: torch.Tensor) -> torch.Tensor:
    """(n_pad/TILE_N, m_pad/TILE_M) bool mask of the kernel tiles that may
    hold a nearest neighbour (port of ``pallas_kernels._tile_keep_mask``).

    ``tp`` (n_pad, 3) finite queries (pad rows replicate the last query so
    boxes stay tight), ``cp`` (m_pad, 3) finite candidates, ``vm`` (m_pad,)
    validity. Per 32-point segment pair, the lower bound of the box-to-box
    distance is compared with the per-query-segment minimum of the upper
    bounds; a few-ulp relative slack keeps rounding from flipping a keep into
    a skip, so the segment pair of every query's true NN is kept. Bounds are
    taken in float64 whatever the working dtype.

    The (query segment × candidate segment) bounds are taken in row blocks
    of whole query tiles, each intermediate near ``_KEEP_BLOCK_ELEMS``
    elements, so memory is O(rows·m_sub) and not O(n_sub·m_sub): at
    524,288 × 524,288 the unblocked form would hold (16,384, 16,384, 3)
    float64 tensors of 6.4 GB. Each row's threshold is its own minimum, so
    every block size gives the same mask bit for bit.
    """
    tp = tp.double()
    cp = cp.double()
    n_pad, m_pad = tp.shape[0], cp.shape[0]
    n_sub, m_sub = n_pad // SUB, m_pad // SUB
    per_tile = TILE_N // SUB
    block_rows = max(per_tile, _KEEP_BLOCK_ELEMS // m_sub // per_tile * per_tile)
    tb = tp.reshape(n_sub, SUB, 3)
    t_lo, t_hi = tb.amin(1), tb.amax(1)
    cb = cp.reshape(m_sub, SUB, 3)
    vmr = vm.reshape(m_sub, SUB, 1)
    inf = torch.tensor(float("inf"), dtype=cp.dtype, device=cp.device)
    c_lo = torch.where(vmr, cb, inf).amin(1)
    c_hi = torch.where(vmr, cb, -inf).amax(1)
    rows = []
    for r in range(0, n_sub, block_rows):
        lo, hi = t_lo[r : r + block_rows, None], t_hi[r : r + block_rows, None]
        gap = torch.clamp(torch.maximum(lo - c_hi[None], c_lo[None] - hi), min=0.0)
        lb = torch.sum(gap * gap, dim=-1)
        span = torch.maximum(hi - c_lo[None], c_hi[None] - lo)
        ub = torch.sum(span * span, dim=-1)
        thr = ub.amin(1, keepdim=True)
        keep_sub = lb <= thr + 1e-5 * (thr + 1.0)
        rows.append(keep_sub.reshape(-1, per_tile, m_pad // TILE_M, TILE_M // SUB).any(3).any(1))
    return torch.cat(rows)


def nn_min_dist2_plain(
    traj: torch.Tensor, candidates: torch.Tensor, cand_mask: torch.Tensor, block: int = 512
) -> torch.Tensor:
    """Brute-force minimum over valid candidates of Σₖ(aₖ−bₖ)², in blocks of
    queries (bounded memory); +inf where no candidate is valid."""
    n = traj.shape[0]
    out = torch.empty((n,), dtype=traj.dtype, device=traj.device)
    inf = torch.tensor(float("inf"), dtype=traj.dtype, device=traj.device)
    for s in range(0, n, block):
        d2 = torch.sum((traj[s : s + block, None, :] - candidates[None, :, :]) ** 2, dim=-1)
        d2 = torch.where(cand_mask[None, :], d2, inf)
        out[s : s + block] = d2.amin(1) if candidates.shape[0] else inf
    return out


def _keep(traj: torch.Tensor, candidates: torch.Tensor, cand_mask: torch.Tensor):
    """The tile keep mask (n_tiles, m_tiles) int32 of both NN kernels, and
    the padded validity (m_pad,). The bounds see ``nan_to_num``-sanitised
    coordinates, with the last query replicated into the pad
    (``pallas_kernels.py:241-252``)."""
    n, m = traj.shape[0], candidates.shape[0]
    device = traj.device
    n_pad = _round_up(max(n, 1), TILE_N)
    m_pad = _round_up(max(m, 1), TILE_M)
    tf = torch.nan_to_num(traj.double(), nan=0.0, posinf=_BIG, neginf=-_BIG)
    tp = torch.cat([tf, tf[-1:].expand(n_pad - n, 3)])
    cp = torch.zeros((m_pad, 3), dtype=torch.float64, device=device)
    cp[:m] = torch.nan_to_num(candidates.double(), nan=0.0, posinf=_BIG, neginf=-_BIG)
    vm = torch.zeros((m_pad,), dtype=torch.bool, device=device)
    vm[:m] = cand_mask
    return tile_keep_mask(tp, cp, vm).to(torch.int32), vm


def nn_tiles(traj: torch.Tensor, candidates: torch.Tensor, cand_mask: torch.Tensor):
    """K3's operands besides ``traj``: ``order`` (n_tiles, m_tiles) int32,
    each query tile's kept candidate tiles first in ascending order (a
    stable sort, ``pallas_kernels.py:267-269``); ``nkept`` (n_tiles,) int32;
    ``cand4`` (m_tiles, 4, TILE_M), the raw candidate coordinates and a
    validity row (0 valid, +inf invalid or padding)."""
    m = candidates.shape[0]
    keep, vm = _keep(traj, candidates, cand_mask)
    m_pad = vm.shape[0]
    order = torch.sort(1 - keep, dim=1, stable=True).indices.to(torch.int32).contiguous()
    nkept = keep.sum(1, dtype=torch.int32).contiguous()
    cand4 = torch.zeros((4, m_pad), dtype=traj.dtype, device=traj.device)
    cand4[:3, :m] = candidates.T
    cand4[3] = torch.where(vm, 0.0, float("inf")).to(traj.dtype)
    cand4 = cand4.reshape(4, m_pad // TILE_M, TILE_M).permute(1, 0, 2).contiguous()
    return order, nkept, cand4


def nn_grid_operands(traj: torch.Tensor, candidates: torch.Tensor, cand_mask: torch.Tensor):
    """K4's operands besides ``traj``: ``keep`` (n_tiles, m_tiles) int32,
    ``cand3`` (3, m_pad) the raw candidate coordinates as rows (zeros in the
    pad), ``valid`` (m_pad,) uint8 (the JAX kernel's separate ``bm``
    operand)."""
    m = candidates.shape[0]
    keep, vm = _keep(traj, candidates, cand_mask)
    cand3 = torch.zeros((3, vm.shape[0]), dtype=traj.dtype, device=traj.device)
    cand3[:, :m] = candidates.T
    return keep.contiguous(), cand3, vm.to(torch.uint8)


def _check_nn(traj: torch.Tensor, candidates: torch.Tensor, cand_mask: torch.Tensor) -> None:
    _build.require_cuda(traj)
    _build.require_cuda(traj, candidates, cand_mask, contiguous=False)
    if candidates.dtype != traj.dtype or cand_mask.dtype != torch.bool:
        raise TypeError("candidates must share traj's dtype; cand_mask must be bool")
    if traj.ndim != 2 or traj.shape[1] != 3 or candidates.ndim != 2 or candidates.shape[1] != 3:
        raise ValueError("traj and candidates must be (N, 3) and (M, 3)")
    if cand_mask.shape != (candidates.shape[0],):
        raise ValueError("cand_mask must be (M,)")


def nn_min_dist2(
    traj: torch.Tensor, candidates: torch.Tensor, cand_mask: torch.Tensor
) -> torch.Tensor:
    """Per-query minimum squared distance to any valid candidate.

    traj (N,3) contiguous, candidates (M,3), cand_mask (M,) bool → (N,) in
    traj's dtype, routed to K3 or K4 by :func:`nn_route`; both take
    :func:`nn_min_dist2_plain` for CPU tensors. On CUDA the bounds see sanitised
    coordinates and the kernel the raw ones; outputs for queries with
    non-finite coordinates are unspecified, and a NaN distance never wins
    the minimum.
    """
    if nn_route(candidates.shape[0]) == "resident":
        return nn_resident(traj, candidates, cand_mask)
    return nn_grid(traj, candidates, cand_mask)


def nn_resident(
    traj: torch.Tensor, candidates: torch.Tensor, cand_mask: torch.Tensor
) -> torch.Tensor:
    """K3 (``csrc/nn.cu``): each 128-query block walks its kept candidate
    tiles, at any M. CPU tensors take :func:`nn_min_dist2_plain`."""
    if traj.device.type == "cpu":
        return nn_min_dist2_plain(traj, candidates, cand_mask)
    _check_nn(traj, candidates, cand_mask)
    n = traj.shape[0]
    out = torch.empty((n,), dtype=traj.dtype, device=traj.device)
    if n == 0:
        return out
    order, nkept, cand4 = nn_tiles(traj, candidates, cand_mask)
    lib = _build.library()
    rc = lib.gps_nn_min_dist2(
        _build.dtype_code(traj), traj.data_ptr(), n, cand4.data_ptr(),
        order.data_ptr(), nkept.data_ptr(), order.shape[0], order.shape[1],
        out.data_ptr(), _build.stream(),
    )
    _build.check(rc, "nn_min_dist2 (resident)")
    nn_resident.launches += 1
    return out


def nn_grid(
    traj: torch.Tensor, candidates: torch.Tensor, cand_mask: torch.Tensor
) -> torch.Tensor:
    """K4 (``csrc/nn_grid.cu``): one block per kept (query tile, candidate
    tile) pair, minima folded with atomics, at any M. Equals K3 bit for bit
    on the same inputs. CPU tensors take :func:`nn_min_dist2_plain`."""
    if traj.device.type == "cpu":
        return nn_min_dist2_plain(traj, candidates, cand_mask)
    _check_nn(traj, candidates, cand_mask)
    n = traj.shape[0]
    out = torch.full((n,), float("inf"), dtype=traj.dtype, device=traj.device)
    if n == 0:
        return out
    keep, cand3, valid = nn_grid_operands(traj, candidates, cand_mask)
    if keep.shape[1] > 65535:
        raise ValueError(f"nn_grid takes at most 65535 candidate tiles, got {keep.shape[1]}")
    lib = _build.library()
    rc = lib.gps_nn_grid(
        _build.dtype_code(traj), traj.data_ptr(), n, cand3.data_ptr(), valid.data_ptr(),
        cand3.shape[1], keep.data_ptr(), keep.shape[0], keep.shape[1], out.data_ptr(),
        _build.stream(),
    )
    _build.check(rc, "nn_min_dist2 (grid)")
    nn_grid.launches += 1
    return out


nn_resident.launches = 0
nn_grid.launches = 0


def sim3_residual2(
    src: torch.Tensor, dst: torch.Tensor, R: torch.Tensor, t: torch.Tensor, s: torch.Tensor
) -> torch.Tensor:
    """‖s·R·p + t − d‖² per trial and point, elementwise in the order of
    ``gps_optimize_slam_tpu/ops/ransac.py`` trial_mask (s·(R p) + t − d,
    squared, summed). R (...,3,3), t (...,3), s (...) → (..., N)."""
    p0, p1, p2 = src[:, 0], src[:, 1], src[:, 2]
    e = []
    for j in range(3):
        q = p0 * R[..., j, 0, None] + p1 * R[..., j, 1, None] + p2 * R[..., j, 2, None]
        e.append(s[..., None] * q + t[..., j, None] - dst[:, j])
    return e[0] * e[0] + e[1] * e[1] + e[2] * e[2]


def ransac_counts_plain(
    src: torch.Tensor,
    dst: torch.Tensor,
    valid: torch.Tensor,
    R: torch.Tensor,
    t: torch.Tensor,
    s: torch.Tensor,
    thr2: float,
    block: int = 64,
) -> torch.Tensor:
    """#{i : validᵢ ∧ residual² < thr2} per trial, in blocks of trials."""
    out = []
    for b in range(0, R.shape[0], block):
        r2 = sim3_residual2(src, dst, R[b : b + block], t[b : b + block], s[b : b + block])
        out.append(((r2 < thr2) & valid).sum(-1, dtype=torch.int32))
    if not out:
        return torch.zeros((0,), dtype=torch.int32, device=src.device)
    return torch.cat(out)


def ransac_counts(
    src: torch.Tensor,
    dst: torch.Tensor,
    valid: torch.Tensor,
    R: torch.Tensor,
    t: torch.Tensor,
    s: torch.Tensor,
    thr2: float,
) -> torch.Tensor:
    """Per-trial Sim(3) consensus counts. src/dst (N,3), valid (N,) bool,
    R (T,3,3), t (T,3), s (T,) → (T,) int32. CPU tensors take
    :func:`ransac_counts_plain`."""
    if src.device.type == "cpu":
        return ransac_counts_plain(src, dst, valid, R, t, s, thr2)
    _build.require_cuda(src, dst, valid, R, t, s)
    n, T = src.shape[0], R.shape[0]
    if src.shape != (n, 3) or dst.shape != (n, 3) or valid.shape != (n,):
        raise ValueError("src/dst must be (N, 3) and valid (N,)")
    if R.shape != (T, 3, 3) or t.shape != (T, 3) or s.shape != (T,):
        raise ValueError("R, t, s must be (T, 3, 3), (T, 3), (T,)")
    if len({x.dtype for x in (src, dst, R, t, s)}) != 1 or valid.dtype != torch.bool:
        raise TypeError("src, dst, R, t, s must share one float dtype; valid must be bool")
    out = torch.empty((T,), dtype=torch.int32, device=src.device)
    if T == 0:
        return out
    lib = _build.library()
    rc = lib.gps_ransac_counts(
        _build.dtype_code(src), src.data_ptr(), dst.data_ptr(), valid.data_ptr(), n,
        R.data_ptr(), t.data_ptr(), s.data_ptr(), T, float(thr2), out.data_ptr(),
        _build.stream(),
    )
    _build.check(rc, "ransac_counts")
    ransac_counts.launches += 1
    return out


ransac_counts.launches = 0
