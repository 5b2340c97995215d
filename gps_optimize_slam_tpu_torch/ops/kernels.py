"""K3 and K4 (nearest-neighbour distance), their keep lists, and K5
(RANSAC consensus counts).

Ports the three Pallas kernels of ``gps_optimize_slam_tpu/ops/pallas_kernels.py``
and the array code around them:

* :func:`nn_min_dist2`: per query, the minimum squared distance to any
  valid candidate, routed by the numbers of candidates, query tiles and
  rows (:func:`nn_route`, a rule set from times measured on the H100, not
  the JAX package's VMEM budget): :func:`nn_grid` (K4,
  ``csrc/nn_grid.cu``; ports the pipelined 2-D grid) from
  ``GRID_MIN_CANDIDATES`` candidates at ``GRID_MAX_QUERY_TILES`` query
  tiles or fewer, :func:`nn_resident` (K3, ``csrc/nn.cu``; ports the
  resident form) otherwise. Both
  take the per-query-tile lists of kept candidate tiles and the packed
  candidates from :func:`keep_lists` (``csrc/nn_keep.cu``: the per-32-point
  AABB bounds of :func:`tile_keep_mask`, their compaction and the packing,
  on the card, pruned exactly at two levels: a box per 1024-candidate tile
  rules most tiles out before any of their 32 segment boxes is read, and a
  block of several query tiles shares the candidate boxes it reads), and
  both scan a staged tile with one function (``csrc/nn_tile.cuh``), so they
  agree bit for bit. In K3 the blocks of a query tile (16 or 32 queries
  each) share its list and each walks all of it; K4 launches one block per
  run of ``RUN_TILES`` kept tiles, so a long list is spread over many
  blocks and no block exists for a dropped pair.
* :func:`ransac_counts`: per Sim(3) trial, the number of valid points within
  the residual threshold (``ransac_counts``), launched from
  ``csrc/ransac_counts.cu`` in the exact elementwise form: blocks of 256
  points by 32 trials, integer partial counts added into a zeroed output.

Batch axis: :func:`keep_lists`, :func:`nn_resident`, :func:`nn_min_dist2`
and :func:`ransac_counts` (and their plain versions) also take a leading
batch of B rows, queries (B, n, 3) and candidates (B, m, 3) with a mask
(B, m), or points (B, N, 3) with trials (B, T, ...): the JAX package's
``vmap`` of its kernels, which gives each Pallas call a batch grid. Each
kernel takes the row as one more grid dimension (K4: one more level of
its work list), in one launch for all rows, and each row's output equals
the call on that row alone bit for bit; a batched NN call is routed as a
single row is, counting every row's query tiles.

Each wrapper takes its plain PyTorch version (``*_plain``, below) for CPU
tensors only; a CUDA tensor launches the kernel or raises. Both NN kernels
compute in the inputs' dtype: the golden run works in float64 UTM
coordinates (~5.4e6 m), where a float32 distance would be off by ~0.5 m.
"""

from __future__ import annotations

import torch

from gps_optimize_slam_tpu_torch.ops import _build

TILE_N = 128  # queries per keep list: a block of csrc/nn_grid.cu, 4-8 blocks of csrc/nn.cu
TILE_M = 1024  # candidates per tile of both
SUB = 32  # AABB segment length of the pruning bounds (divides both tiles)
RUN_TILES = 4  # kept candidate tiles per K4 block (csrc/nn_grid.cu kRun)
_BIG = 3.4e38  # non-finite coordinates are clamped here for the bounds only
# K4 from this many candidates on at GRID_MAX_QUERY_TILES query tiles (of
# all rows) or fewer, K3 otherwise (:func:`nn_route`). Measured on an NVIDIA
# H100 80GB HBM3 at a 700.00 W power limit (chip_smoke.py, phase 1
# "routes"): on spatially coherent tracks K3's call was the faster at every
# size (16,384 queries against 4,661 to 1,048,576 candidates, 524,288 x
# 524,288: 2.3 against 2.7-3.1 ms, float32 and float64), since its blocks of
# 16 or 32 queries fill the card where K4's 128-query blocks walk short
# lists; K4's split of a list over blocks pays where a few query tiles each
# keep hundreds of tiles, which only 512 or more candidate tiles allow
# (524,288 shuffled candidates, every tile kept: K4 1.5-2.0x ahead at 6
# query tiles, 1.2-1.3x at 37, level at 64, K3's device time ahead at 128;
# at 64 candidate tiles K3 ahead at any query count).
GRID_MIN_CANDIDATES = 524_288
GRID_MAX_QUERY_TILES = 64
# Bound elements per row block of tile_keep_mask (about 50 MB for each of
# its float64 (rows, m_sub, 3) intermediates).
_KEEP_BLOCK_ELEMS = 1 << 21


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def nn_route(m: int, n: int, batch: int = 1) -> str:
    """"resident" (K3) or "grid" (K4) for ``batch`` rows of ``n`` queries
    against ``m`` candidates each: K4 from ``GRID_MIN_CANDIDATES``
    candidates on where the rows hold ``GRID_MAX_QUERY_TILES`` query tiles
    or fewer in all (where a long keep list can leave K3's few blocks
    walking it alone), K3 otherwise. (The JAX package's rule, its resident
    kernel's 8 MiB VMEM budget, put the change above 262,144 candidates
    whatever the queries.)"""
    query_tiles = batch * _tiles(n, m)[0]
    return "grid" if m >= GRID_MIN_CANDIDATES and query_tiles <= GRID_MAX_QUERY_TILES else "resident"


def tile_keep_mask(tp: torch.Tensor, cp: torch.Tensor, vm: torch.Tensor) -> torch.Tensor:
    """(n_pad/TILE_N, m_pad/TILE_M) bool mask of the kernel tiles that may
    hold a nearest neighbour (port of ``pallas_kernels._tile_keep_mask``),
    the plain version of the keep-list kernel (``csrc/nn_keep.cu``).

    ``tp`` (n_pad, 3) finite queries (pad rows replicate the last query so
    boxes stay tight), ``cp`` (m_pad, 3) finite candidates, ``vm`` (m_pad,)
    validity; or each with a leading batch axis B, giving (B, n_tiles,
    m_tiles), each row's mask that of the row alone. Per 32-point segment pair, the lower bound of the box-to-box
    distance is compared with the per-query-segment minimum of the upper
    bounds; a few-ulp relative slack keeps rounding from flipping a keep into
    a skip, so the segment pair of every query's true NN is kept. Bounds are
    taken in float64 whatever the working dtype, and each three-term sum as
    ``(x0*x0 + x1*x1) + x2*x2``, the kernel's order, so the kernel's lists
    equal this mask bit for bit.

    The (query segment × candidate segment) bounds are taken in row blocks
    of whole query tiles, each intermediate near ``_KEEP_BLOCK_ELEMS``
    elements, so memory is O(rows·m_sub) and not O(n_sub·m_sub): at
    524,288 × 524,288 the unblocked form would hold (16,384, 16,384, 3)
    float64 tensors of 6.4 GB. Each row's threshold is its own minimum, so
    every block size gives the same mask bit for bit.
    """
    if tp.ndim == 2:
        return tile_keep_mask(tp[None], cp[None], vm[None])[0]
    tp = tp.double()
    cp = cp.double()
    B, n_pad, m_pad = tp.shape[0], tp.shape[1], cp.shape[1]
    n_sub, m_sub = n_pad // SUB, m_pad // SUB
    per_tile = TILE_N // SUB
    block_rows = max(per_tile, _KEEP_BLOCK_ELEMS // max(B * m_sub, 1) // per_tile * per_tile)
    tb = tp.reshape(B, n_sub, SUB, 3)
    t_lo, t_hi = tb.amin(2), tb.amax(2)
    cb = cp.reshape(B, m_sub, SUB, 3)
    vmr = vm.reshape(B, m_sub, SUB, 1)
    inf = torch.tensor(float("inf"), dtype=cp.dtype, device=cp.device)
    c_lo = torch.where(vmr, cb, inf).amin(2)[:, None]
    c_hi = torch.where(vmr, cb, -inf).amax(2)[:, None]

    def sq3(v):
        return (v[..., 0] * v[..., 0] + v[..., 1] * v[..., 1]) + v[..., 2] * v[..., 2]

    rows = []
    for r in range(0, n_sub, block_rows):
        lo, hi = t_lo[:, r : r + block_rows, None], t_hi[:, r : r + block_rows, None]
        lb = sq3(torch.clamp(torch.maximum(lo - c_hi, c_lo - hi), min=0.0))
        ub = sq3(torch.maximum(hi - c_lo, c_hi - lo))
        thr = ub.amin(2, keepdim=True)
        keep_sub = lb <= thr + 1e-5 * (thr + 1.0)
        rows.append(keep_sub.reshape(B, -1, per_tile, m_pad // TILE_M, TILE_M // SUB).any(4).any(2))
    return torch.cat(rows, 1)


def keep_lists_plain(keep: torch.Tensor):
    """``order`` (n_tiles, m_tiles) int32, each query tile's kept candidate
    tiles first in ascending order (a stable sort, ``pallas_kernels.py:267-269``),
    and ``nkept`` (n_tiles,) int32, from a :func:`tile_keep_mask` mask (with
    the mask's leading batch axis, if it has one)."""
    keep = keep.to(torch.int32)
    order = torch.sort(1 - keep, dim=-1, stable=True).indices.to(torch.int32).contiguous()
    return order, keep.sum(-1, dtype=torch.int32).contiguous()


def nn_min_dist2_plain(
    traj: torch.Tensor, candidates: torch.Tensor, cand_mask: torch.Tensor, block: int = 512
) -> torch.Tensor:
    """Brute-force minimum over valid candidates of Σₖ(aₖ−bₖ)², in blocks of
    queries (bounded memory); +inf where no candidate is valid. With a
    leading batch axis (traj (B, n, 3), candidates (B, m, 3), cand_mask
    (B, m)) each row against its own candidates, ``block`` (row, query)
    pairs a block."""
    n = traj.shape[-2]
    out = torch.empty(traj.shape[:-1], dtype=traj.dtype, device=traj.device)
    inf = torch.tensor(float("inf"), dtype=traj.dtype, device=traj.device)
    step = max(1, block // (traj.shape[0] if traj.ndim == 3 else 1))
    for s in range(0, n, step):
        d2 = torch.sum((traj[..., s : s + step, None, :] - candidates[..., None, :, :]) ** 2, dim=-1)
        d2 = torch.where(cand_mask[..., None, :], d2, inf)
        out[..., s : s + step] = d2.amin(-1) if candidates.shape[-2] else inf
    return out


def _tiles(n: int, m: int):
    """(n_tiles, m_tiles) of the kernels' padded operands."""
    return _round_up(max(n, 1), TILE_N) // TILE_N, _round_up(max(m, 1), TILE_M) // TILE_M


def bounds_operands(traj: torch.Tensor, candidates: torch.Tensor, cand_mask: torch.Tensor):
    """The operands of :func:`tile_keep_mask`: ``nan_to_num``-sanitised
    float64 coordinates, the last query replicated into the pad, zeros and
    invalid past m (``pallas_kernels.py:241-252``); with the inputs' leading
    batch axis, if they have one."""
    n, m = traj.shape[-2], candidates.shape[-2]
    n_tiles, m_tiles = _tiles(n, m)
    lead, device = traj.shape[:-2], traj.device
    tf = torch.nan_to_num(traj.double(), nan=0.0, posinf=_BIG, neginf=-_BIG)
    tp = torch.cat([tf, tf[..., -1:, :].expand(*lead, n_tiles * TILE_N - n, 3)], -2)
    cp = torch.zeros((*lead, m_tiles * TILE_M, 3), dtype=torch.float64, device=device)
    cp[..., :m, :] = torch.nan_to_num(candidates.double(), nan=0.0, posinf=_BIG, neginf=-_BIG)
    vm = torch.zeros((*lead, m_tiles * TILE_M), dtype=torch.bool, device=device)
    vm[..., :m] = cand_mask
    return tp, cp, vm


def pack_candidates_plain(candidates: torch.Tensor, cand_mask: torch.Tensor, m_tiles: int) -> torch.Tensor:
    """``cand4`` (m_tiles, 4, TILE_M) in the candidates' dtype: the raw
    coordinates as rows x, y, z (zeros in the pad) and a validity row (0
    valid, +inf masked out or padding), the operand both NN kernels walk;
    (B, m_tiles, 4, TILE_M) for a batch of rows."""
    m = candidates.shape[-2]
    lead = candidates.shape[:-2]
    m_pad = m_tiles * TILE_M
    cand4 = torch.zeros((*lead, 4, m_pad), dtype=candidates.dtype, device=candidates.device)
    cand4[..., :3, :m] = candidates.transpose(-1, -2)
    cand4[..., 3, :] = float("inf")
    cand4[..., 3, :m] = torch.where(cand_mask, 0.0, float("inf")).to(candidates.dtype)
    return cand4.reshape(*lead, 4, m_tiles, TILE_M).transpose(-3, -2).contiguous()


def keep_lists(traj: torch.Tensor, candidates: torch.Tensor, cand_mask: torch.Tensor):
    """The operands of both NN kernels besides ``traj``: ``order``
    (n_tiles, m_tiles) and ``nkept`` (n_tiles,) int32, each query tile's
    kept candidate tiles in ascending order and their count, and ``cand4``
    (m_tiles, 4, TILE_M), the packed candidates; each with a leading B for
    a batch of rows (traj (B, n, 3)), built in the same one call. On CUDA the keep-list
    kernel (``csrc/nn_keep.cu``) builds all three from the raw coordinates
    in one call of two launches (entries of ``order`` past ``nkept``
    unspecified). Its lists equal the plain ones bit for bit: a tile is only
    skipped when its own box, which contains its segments' boxes, already
    fails the test that each segment would fail. Its floor on the card is
    the bytes (coordinates read once, packed candidates and lists written
    once), since the tile-level test leaves few segment pairs. CPU
    tensors take :func:`keep_lists_plain` of :func:`tile_keep_mask` and
    :func:`pack_candidates_plain`."""
    n_tiles, m_tiles = _tiles(traj.shape[-2], candidates.shape[-2])
    if traj.device.type == "cpu":
        order, nkept = keep_lists_plain(tile_keep_mask(*bounds_operands(traj, candidates, cand_mask)))
        return order, nkept, pack_candidates_plain(candidates, cand_mask, m_tiles)
    _check_nn(traj, candidates, cand_mask)
    lead, batch = traj.shape[:-2], (traj.shape[0] if traj.ndim == 3 else 1)
    order = torch.empty((*lead, n_tiles, m_tiles), dtype=torch.int32, device=traj.device)
    nkept = torch.empty((*lead, n_tiles), dtype=torch.int32, device=traj.device)
    cand4 = torch.empty((*lead, m_tiles, 4, TILE_M), dtype=traj.dtype, device=traj.device)
    if batch == 0:
        return order, nkept, cand4
    # lo and hi per axis of every segment and of every candidate tile, a row's after another
    boxes = torch.empty((batch * 6 * ((n_tiles * TILE_N + m_tiles * TILE_M) // SUB + m_tiles),),
                        dtype=torch.float64, device=traj.device)
    cand = candidates.contiguous()
    mask = cand_mask.contiguous()
    with torch.cuda.device(traj.device):
        rc = _build.library().gps_nn_keep(
            _build.dtype_code(traj), batch, traj.data_ptr(), traj.shape[-2], cand.data_ptr(),
            mask.data_ptr(), cand.shape[-2], boxes.data_ptr(), n_tiles, m_tiles, order.data_ptr(),
            nkept.data_ptr(), cand4.data_ptr(), _build.stream(traj.device),
        )
    _build.check(rc, "nn keep lists")
    with _build.COUNT_LOCK:
        keep_lists.launches += 1
    return order, nkept, cand4


def nn_grid_operands(traj: torch.Tensor, candidates: torch.Tensor, cand_mask: torch.Tensor):
    """K4's operands besides ``traj``: ``order``, ``nkept`` and ``cand4`` of
    :func:`keep_lists`, and ``ends`` int32, shaped as ``nkept``, the
    inclusive prefix sum of each query tile's runs of at most ``RUN_TILES``
    kept tiles (K4's work list: block b takes query tile i with ends[i-1]
    <= b < ends[i]); with a leading batch axis the sum runs over every
    row's query tiles, one row after another. Its last entry is the grid's
    size, the one value the host reads."""
    order, nkept, cand4 = keep_lists(traj, candidates, cand_mask)
    runs = torch.div(nkept + RUN_TILES - 1, RUN_TILES, rounding_mode="floor")
    ends = torch.cumsum(runs.reshape(-1), 0, dtype=torch.int32).reshape(runs.shape)
    return order, nkept, cand4, ends


def _check_nn(traj: torch.Tensor, candidates: torch.Tensor, cand_mask: torch.Tensor) -> None:
    _build.require_cuda(traj)
    _build.require_cuda(traj, candidates, cand_mask, contiguous=False)
    if candidates.dtype != traj.dtype or cand_mask.dtype != torch.bool:
        raise TypeError("candidates must share traj's dtype; cand_mask must be bool")
    lead = traj.shape[:-2]
    if (traj.ndim not in (2, 3) or traj.shape[-1] != 3 or candidates.shape[:-2] != lead
            or candidates.ndim != traj.ndim or candidates.shape[-1] != 3):
        raise ValueError("traj and candidates must be (N, 3) and (M, 3), or (B, N, 3) and (B, M, 3)")
    if cand_mask.shape != candidates.shape[:-1]:
        raise ValueError("cand_mask must be (M,), or (B, M)")
    if traj.ndim == 3 and traj.shape[0] > 65_535:
        raise ValueError("a batch holds at most 65,535 rows (the grid's y dimension)")


def nn_min_dist2(
    traj: torch.Tensor, candidates: torch.Tensor, cand_mask: torch.Tensor
) -> torch.Tensor:
    """Per-query minimum squared distance to any valid candidate.

    traj (N,3) contiguous, candidates (M,3), cand_mask (M,) bool → (N,) in
    traj's dtype, or a batch of rows, (B, N, 3), (B, M, 3) and (B, M) →
    (B, N), routed to K3 or K4 by :func:`nn_route`; both take
    :func:`nn_min_dist2_plain` for CPU tensors. On CUDA the bounds see
    sanitised coordinates and the kernel the raw ones; outputs for queries
    with non-finite coordinates are unspecified, and a NaN distance never
    wins the minimum.
    """
    batch = traj.shape[0] if traj.ndim == 3 else 1
    if nn_route(candidates.shape[-2], traj.shape[-2], batch) == "resident":
        return nn_resident(traj, candidates, cand_mask)
    return nn_grid(traj, candidates, cand_mask)


def nn_resident(
    traj: torch.Tensor, candidates: torch.Tensor, cand_mask: torch.Tensor
) -> torch.Tensor:
    """K3 (``csrc/nn.cu``): blocks of 16 or 32 queries walk the kept
    candidate tiles of their 128-query tile, at any M; a batch of rows
    (B, N, 3) in one launch, a grid row a sequence. CPU tensors take
    :func:`nn_min_dist2_plain`."""
    if traj.device.type == "cpu":
        return nn_min_dist2_plain(traj, candidates, cand_mask)
    _check_nn(traj, candidates, cand_mask)
    n, batch = traj.shape[-2], (traj.shape[0] if traj.ndim == 3 else 1)
    out = torch.empty(traj.shape[:-1], dtype=traj.dtype, device=traj.device)
    if n == 0 or batch == 0:
        return out
    order, nkept, cand4 = keep_lists(traj, candidates, cand_mask)
    lib = _build.library()
    with torch.cuda.device(traj.device):
        rc = lib.gps_nn_min_dist2(
            _build.dtype_code(traj), batch, traj.data_ptr(), n, cand4.data_ptr(),
            order.data_ptr(), nkept.data_ptr(), order.shape[-2], order.shape[-1],
            out.data_ptr(), _build.stream(traj.device),
        )
    _build.check(rc, "nn_min_dist2 (resident)")
    with _build.COUNT_LOCK:
        nn_resident.launches += 1
    return out


def nn_grid(
    traj: torch.Tensor, candidates: torch.Tensor, cand_mask: torch.Tensor
) -> torch.Tensor:
    """K4 (``csrc/nn_grid.cu``): one block per run of kept candidate tiles
    of a query tile, minima folded with atomics, at any M; a batch of rows
    (B, N, 3) in one launch over every row's runs. Equals K3 bit for bit on
    the same inputs. CPU tensors take :func:`nn_min_dist2_plain`."""
    if traj.device.type == "cpu":
        return nn_min_dist2_plain(traj, candidates, cand_mask)
    _check_nn(traj, candidates, cand_mask)
    if traj.numel() == 0:
        return torch.empty(traj.shape[:-1], dtype=traj.dtype, device=traj.device)
    operands = nn_grid_operands(traj, candidates, cand_mask)
    return grid_launch(traj, operands, int(operands[3].reshape(-1)[-1]))


def grid_launch(traj: torch.Tensor, operands, n_items: int) -> torch.Tensor:
    """K4's launch alone on :func:`nn_grid_operands`' ``operands``, over
    ``n_items`` blocks (the last entry of ``ends``, read by the caller: the
    grid's size is the one value the host needs from the keep lists)."""
    order, nkept, cand4, ends = operands
    n, batch = traj.shape[-2], (traj.shape[0] if traj.ndim == 3 else 1)
    out = torch.full(traj.shape[:-1], float("inf"), dtype=traj.dtype, device=traj.device)
    lib = _build.library()
    if lib.gps_nn_grid_run() != RUN_TILES:
        raise RuntimeError("csrc/nn_grid.cu cuts the keep lists by another run length")
    if n_items == 0:
        return out
    with torch.cuda.device(traj.device):
        rc = lib.gps_nn_grid(
            _build.dtype_code(traj), batch, traj.data_ptr(), n, cand4.data_ptr(), order.data_ptr(),
            nkept.data_ptr(), ends.data_ptr(), order.shape[-2], order.shape[-1], n_items,
            out.data_ptr(), _build.stream(traj.device),
        )
    _build.check(rc, "nn_min_dist2 (grid)")
    with _build.COUNT_LOCK:
        nn_grid.launches += 1
    return out


keep_lists.launches = 0
nn_resident.launches = 0
nn_grid.launches = 0


def sim3_residual2(
    src: torch.Tensor, dst: torch.Tensor, R: torch.Tensor, t: torch.Tensor, s: torch.Tensor
) -> torch.Tensor:
    """‖s·R·p + t − d‖² per trial and point, elementwise in the order of
    ``gps_optimize_slam_tpu/ops/ransac.py`` trial_mask (s·(R p) + t − d,
    squared, summed). src/dst (..., N, 3) broadcast against R (..., 3, 3),
    t (..., 3), s (...) → (..., N): (N, 3) points with (T, 3, 3) trials
    give (T, N), and (B, 1, N, 3) points with (B, T, 3, 3) trials (B, T, N)."""
    p0, p1, p2 = src[..., 0], src[..., 1], src[..., 2]
    e = []
    for j in range(3):
        q = p0 * R[..., j, 0, None] + p1 * R[..., j, 1, None] + p2 * R[..., j, 2, None]
        e.append(s[..., None] * q + t[..., j, None] - dst[..., j])
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
    """#{i : validᵢ ∧ residual² < thr2} per trial, in blocks of trials; with
    a leading batch axis (src, dst (B, N, 3), valid (B, N), trials (B, T,
    ...)) each row's trials against its own points, ``block`` (row, trial)
    pairs a block."""
    if src.ndim == 3:
        src, dst, valid = src[:, None], dst[:, None], valid[:, None]
    T = R.shape[-3]
    step = max(1, block // (R.shape[0] if R.ndim == 4 else 1))
    out = []
    for b in range(0, T, step):
        r2 = sim3_residual2(src, dst, R[..., b : b + step, :, :], t[..., b : b + step, :], s[..., b : b + step])
        out.append(((r2 < thr2) & valid).sum(-1, dtype=torch.int32))
    if not out:
        return torch.zeros(R.shape[:-2], dtype=torch.int32, device=src.device)
    return torch.cat(out, -1)


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
    R (T,3,3), t (T,3), s (T,) → (T,) int32; with a leading batch axis B on
    every operand → (B, T), one launch for all rows. CPU tensors take
    :func:`ransac_counts_plain`."""
    if src.device.type == "cpu":
        return ransac_counts_plain(src, dst, valid, R, t, s, thr2)
    _build.require_cuda(src, dst, valid, R, t, s)
    lead = src.shape[:-2]
    n, T = src.shape[-2], R.shape[-3]
    if src.ndim not in (2, 3) or src.shape != (*lead, n, 3) or dst.shape != (*lead, n, 3) \
            or valid.shape != (*lead, n):
        raise ValueError("src/dst must be (N, 3) and valid (N,), with one leading batch axis at most")
    if R.shape != (*lead, T, 3, 3) or t.shape != (*lead, T, 3) or s.shape != (*lead, T):
        raise ValueError("R, t, s must be (T, 3, 3), (T, 3), (T,), with src's batch axis")
    if len({x.dtype for x in (src, dst, R, t, s)}) != 1 or valid.dtype != torch.bool:
        raise TypeError("src, dst, R, t, s must share one float dtype; valid must be bool")
    batch = lead[0] if lead else 1
    out = torch.zeros((*lead, T), dtype=torch.int32, device=src.device)
    if T == 0 or n == 0 or batch == 0:
        return out
    if batch > 65_535:
        raise ValueError("a batch holds at most 65,535 rows (the grid's z dimension)")
    lib = _build.library()
    with torch.cuda.device(src.device):
        rc = lib.gps_ransac_counts(
            _build.dtype_code(src), batch, src.data_ptr(), dst.data_ptr(), valid.data_ptr(), n,
            R.data_ptr(), t.data_ptr(), s.data_ptr(), T, float(thr2), out.data_ptr(),
            _build.stream(src.device),
        )
    _build.check(rc, "ransac_counts")
    with _build.COUNT_LOCK:
        ransac_counts.launches += 1
    return out


ransac_counts.launches = 0
