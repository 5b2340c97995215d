"""K3 and K4 (nearest-neighbour distance), their keep lists, K5 (RANSAC
consensus counts), and the pose graph's conjugate-gradient solve.

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
  on the card, pruned exactly at three levels: a warp takes a query tile
  from the boxes of groups of 32 candidate tiles to the tile boxes of the
  groups near it and the 32 segment boxes of the tiles near it; optionally
  after a Morton sort of the candidates, :func:`morton_sort_candidates`), and
  both scan a staged tile with one function (``csrc/nn_tile.cuh``), so they
  agree bit for bit. In K3 the blocks of a query tile (16, 32 or 64
  queries each, by :func:`resident_block`) share its list and each walks
  all of it; K4's blocks draw items
  of a work list of runs of ``RUN_TILES`` kept tiles, so a long list is
  spread over many blocks and no work exists for a dropped pair. Neither
  reads a device value on the host, so a CUDA graph holds either launch.
* :func:`ransac_counts`: per Sim(3) trial, the number of valid points within
  the residual threshold (``ransac_counts``), launched from
  ``csrc/ransac_counts.cu``: a list of the point chunks that hold a valid
  point (built on the card), blocks drawing (chunk, trial group) items of
  it, a contracted residual whose hits and misses a certified error band
  decides and the pairs inside the band recounted in the plain elementwise
  order, integer partial counts added into a zeroed output: the plain
  version's counts exactly.
* :func:`pose_cg`: a Gauss-Newton step's normal equations
  (JᵀJ + λI)δ = −Jᵀr solved by conjugate gradients over per-factor Jacobian
  blocks, every iteration inside one launch of ``csrc/pose_cg.cu`` (a
  thread-block cluster; no TPU kernel: the JAX package runs ``jax.scipy``'s
  CG on Hessian-vector products).

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

from typing import Optional

import torch

from gps_optimize_slam_tpu_torch.ops import _build

TILE_N = 128  # queries per keep list: a block of csrc/nn_grid.cu, 1-8 blocks of csrc/nn.cu
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
# at 64 candidate tiles K3 ahead at any query count). Re-measured after
# both kernels' tile loop was redesigned (same card and script, calls,
# float32 / float64): shuffled, K4 1.52 / 1.95x ahead at 6 query tiles,
# 1.30 / 1.19x at 37, level at 64 (1.01 / 0.98x) and at 128 (1.04 /
# 1.02x, K3's device time ahead); on the random walks K3 2.2 / 2.3x ahead
# at 128 query tiles against 524,288 candidates. The crossover did not
# move.
GRID_MIN_CANDIDATES = 524_288
GRID_MAX_QUERY_TILES = 64
# K3's queries a block (csrc/nn.cu) by the launch's query tiles, all rows
# counted (:func:`resident_block`): 16 up to SMALL_GRID_TILES, 32 up to
# LARGE_GRID_TILES, 64 beyond. Measured on an NVIDIA H100 80GB HBM3 at a
# 700.00 W power limit (chip_smoke.py phase 1 "tiers": a launch's device
# ms, random walks, 16 / 32 / 64 queries a block, float32; float64): at 37
# query tiles 0.0099 / 0.0105 / 0.0148; 0.0161 / 0.0210 / 0.0254, at 256
# 0.0558 / 0.0599 / 0.0614; 0.115 / 0.118 / 0.122, at 1,024 0.150 / 0.131
# / 0.142; 0.624 / 0.604 / 0.615, at 2,048 0.484 / 0.437 / 0.424; 0.859 /
# 0.813 / 0.794, at 4,096 0.975 / 0.846 / 0.827; 1.411 / 1.404 / 1.339,
# at the fleet bucket's 2,368 0.263 / 0.229 / 0.212; 0.425 / 0.408 /
# 0.399, and at phase 1's long rows (16,384, float64;
# tools/nn_launch_compare.py) 156.1 / 148.0 / 143.2 ms. At 512 the order
# changes from run to run within a tenth. Eight queries a thread in
# blocks of 128 timed level with 64 or behind and spilled in float64.
SMALL_GRID_TILES = 256
LARGE_GRID_TILES = 1024
RESIDENT_BLOCKS = (16, 32, 64)  # the block sizes csrc/nn.cu launches
# Bound elements per row block of tile_keep_mask (about 50 MB for each of
# its float64 (rows, m_sub, 3) intermediates).
_KEEP_BLOCK_ELEMS = 1 << 21
# The keep-list kernel's level above the tile (csrc/nn_keep.cu): a group
# is 32 candidate tiles, a lane's box each.
GROUP_TILES = 32


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
    inf = torch.full((), float("inf"), dtype=cp.dtype, device=cp.device)
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
    inf = torch.full((), float("inf"), dtype=traj.dtype, device=traj.device)
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
    """``cand3`` (m_tiles, 3, TILE_M) in the candidates' dtype, the operand
    both NN kernels walk: rows x, y, z, a valid candidate's raw coordinates
    and +inf in all three for a masked or padded one (validity folded into
    the coordinates: a finite query's distance to it is +inf, and its raw
    coordinates, NaN or not, are never read); (B, m_tiles, 3, TILE_M) for a
    batch of rows."""
    m = candidates.shape[-2]
    lead = candidates.shape[:-2]
    cand3 = torch.full((*lead, 3, m_tiles * TILE_M), float("inf"), dtype=candidates.dtype,
                       device=candidates.device)
    cand3[..., :m] = torch.where(cand_mask[..., None, :], candidates.transpose(-1, -2), float("inf"))
    return cand3.reshape(*lead, 3, m_tiles, TILE_M).transpose(-3, -2).contiguous()


def keep_split(batch: int, n_tiles: int, m_tiles: int) -> int:
    """The warps a query tile that the keep-list kernel takes for a launch
    of ``batch`` rows of ``n_tiles`` query tiles and ``m_tiles`` candidate
    tiles (``csrc/nn_keep.cu``: 1, or 2, 4 or 8 where the launch's query
    tiles are too few to fill the card and a row has that many groups);
    asked of the built kernels, so CUDA only. Every choice gives the same
    lists."""
    return int(_build.library().gps_nn_keep_split(batch, n_tiles, m_tiles))


def keep_lists(traj: torch.Tensor, candidates: torch.Tensor, cand_mask: torch.Tensor):
    """The operands of both NN kernels besides ``traj``: ``order``
    (n_tiles, m_tiles) and ``nkept`` (n_tiles,) int32, each query tile's
    kept candidate tiles in ascending order and their count, and ``cand3``
    (m_tiles, 3, TILE_M), the packed candidates (rows x, y, z; +inf in all
    three for a masked or padded candidate, as
    :func:`pack_candidates_plain` packs them); each with a leading B for
    a batch of rows (traj (B, n, 3)), built in the same one call. On CUDA the keep-list
    kernel (``csrc/nn_keep.cu``) builds all three from the raw coordinates
    in one call of two launches, three where a row has two groups or more
    (entries of ``order`` past ``nkept`` unspecified). Its lists equal the plain ones bit for bit: a group of
    32 candidate tiles or a tile is only skipped when its own box, which
    contains its tiles' or segments' boxes, already fails the test that
    each segment would fail. A warp (or several, :func:`keep_split`) takes
    a query tile down the levels, so its floor on the card is the bytes
    (coordinates read once, packed candidates and lists written once). CPU
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
    cand3 = torch.empty((*lead, m_tiles, 3, TILE_M), dtype=traj.dtype, device=traj.device)
    if batch == 0:
        return order, nkept, cand3
    # lo and hi per axis of every segment, candidate tile and group, a row's after another
    groups = -(-m_tiles // GROUP_TILES)
    boxes = torch.empty((batch * 6 * ((n_tiles * TILE_N + m_tiles * TILE_M) // SUB + m_tiles + groups),),
                        dtype=torch.float64, device=traj.device)
    cand = candidates.contiguous()
    mask = cand_mask.contiguous()
    with torch.cuda.device(traj.device):
        rc = _build.library().gps_nn_keep(
            _build.dtype_code(traj), batch, traj.data_ptr(), traj.shape[-2], cand.data_ptr(),
            mask.data_ptr(), cand.shape[-2], boxes.data_ptr(), n_tiles, m_tiles, order.data_ptr(),
            nkept.data_ptr(), cand3.data_ptr(), _build.stream(traj.device),
        )
    _build.check(rc, "nn keep lists")
    _build.count_launch(keep_lists)
    return order, nkept, cand3


def nn_grid_operands(traj: torch.Tensor, candidates: torch.Tensor, cand_mask: torch.Tensor):
    """K4's operands besides ``traj``: ``order``, ``nkept`` and ``cand3`` of
    :func:`keep_lists`, and ``ends`` int32, shaped as ``nkept``, the
    inclusive prefix sum of each query tile's runs of at most ``RUN_TILES``
    kept tiles (K4's work list: item b takes query tile i with ends[i-1]
    <= b < ends[i]); with a leading batch axis the sum runs over every
    row's query tiles, one row after another. Its last entry, the list's
    length, is read by the kernel on the device."""
    order, nkept, cand3 = keep_lists(traj, candidates, cand_mask)
    runs = torch.div(nkept + RUN_TILES - 1, RUN_TILES, rounding_mode="floor")
    ends = torch.cumsum(runs.reshape(-1), 0, dtype=torch.int32).reshape(runs.shape)
    return order, nkept, cand3, ends


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


def _spread_bits(x: torch.Tensor) -> torch.Tensor:
    """The low 10 bits of int32 ``x`` spread two zero bits apart (Morton)."""
    x = (x | (x << 16)) & 0x030000FF
    x = (x | (x << 8)) & 0x0300F00F
    x = (x | (x << 4)) & 0x030C30C3
    return (x | (x << 2)) & 0x09249249


def morton_sort_candidates(candidates: torch.Tensor, cand_mask: torch.Tensor):
    """(candidates, cand_mask) reordered along a Morton (Z-order) curve of
    the valid candidates' box, invalid ones last (port of
    ``pallas_kernels._morton_sort_candidates``): float32 coordinates with
    NaN -> 0 and ±inf -> ±3.4e38, 10 bits an axis over 1023 / max(extent,
    1e-6), the key x | y << 1 | z << 2 and 0x7FFFFFFF for an invalid one,
    then one sort by key carrying the coordinates (in their own dtype) and
    the mask; with a leading batch axis, each row by its own box, in one
    sort. It makes every 32-candidate segment and 1024-candidate tile
    spatially compact whatever the input order, which is what the keep
    lists' box bounds feed on; a minimum does not depend on the order, so
    the NN minima are unchanged."""
    if candidates.shape[-2] == 0:
        return candidates, cand_mask
    idx = torch.sort(morton_keys(candidates, cand_mask), dim=-1, stable=True).indices
    return (torch.gather(candidates, -2, idx[..., None].expand(candidates.shape)),
            torch.gather(cand_mask, -1, idx))


def morton_keys(candidates: torch.Tensor, cand_mask: torch.Tensor) -> torch.Tensor:
    """The int32 sort keys of :func:`morton_sort_candidates` (a row's
    shape without the coordinate axis)."""
    f = torch.nan_to_num(candidates.float(), nan=0.0, posinf=3.4e38, neginf=-3.4e38)
    valid = cand_mask[..., None]
    inf = torch.full((), float("inf"), dtype=torch.float32, device=f.device)
    lo = torch.where(valid, f, inf).amin(-2, keepdim=True)
    hi = torch.where(valid, f, -inf).amax(-2, keepdim=True)
    scale = 1023.0 / torch.clamp(hi - lo, min=1e-6)
    q = torch.clamp((f - lo) * scale, 0.0, 1023.0).to(torch.int32)
    key = _spread_bits(q[..., 0]) | (_spread_bits(q[..., 1]) << 1) | (_spread_bits(q[..., 2]) << 2)
    return torch.where(cand_mask, key, 0x7FFFFFFF)


def nn_min_dist2(
    traj: torch.Tensor, candidates: torch.Tensor, cand_mask: torch.Tensor, sort_candidates: bool = False
) -> torch.Tensor:
    """Per-query minimum squared distance to any valid candidate.

    traj (N,3) contiguous, candidates (M,3), cand_mask (M,) bool → (N,) in
    traj's dtype, or a batch of rows, (B, N, 3), (B, M, 3) and (B, M) →
    (B, N), routed to K3 or K4 by :func:`nn_route`; both take
    :func:`nn_min_dist2_plain` for CPU tensors. On CUDA the bounds see
    sanitised coordinates and the kernel the raw ones; outputs for queries
    with non-finite coordinates are unspecified, and a NaN distance never
    wins the minimum. ``sort_candidates`` Morton-orders the candidates
    first (:func:`morton_sort_candidates`, a row at a time in a batch), as
    the JAX package's option does: the same minima, and far fewer kept
    tiles where the candidates come spatially shuffled. Off by default, as
    there: time-ordered candidates are compact already.
    """
    if sort_candidates:
        candidates, cand_mask = morton_sort_candidates(candidates, cand_mask)
    batch = traj.shape[0] if traj.ndim == 3 else 1
    if nn_route(candidates.shape[-2], traj.shape[-2], batch) == "resident":
        return nn_resident(traj, candidates, cand_mask)
    return nn_grid(traj, candidates, cand_mask)


def resident_block(query_tiles: int) -> int:
    """K3's queries a block for a launch of ``query_tiles`` query tiles (all
    rows): 16 (two a thread) while that leaves about 15 blocks an SM or
    fewer, 32 (four a thread) up to ``LARGE_GRID_TILES``, and 64 (eight a
    thread, each staged tile and shared-memory load feeding twice the
    pairs) at the grids of long rows and batches."""
    if query_tiles <= SMALL_GRID_TILES:
        return 16
    return 32 if query_tiles <= LARGE_GRID_TILES else 64


def nn_resident(
    traj: torch.Tensor, candidates: torch.Tensor, cand_mask: torch.Tensor
) -> torch.Tensor:
    """K3 (``csrc/nn.cu``): blocks of 16, 32 or 64 queries
    (:func:`resident_block`) walk the kept candidate tiles of their
    128-query tile, at any M; a batch of rows (B, N, 3) in one launch, a
    grid row a sequence. CPU tensors take :func:`nn_min_dist2_plain`."""
    if traj.device.type == "cpu":
        return nn_min_dist2_plain(traj, candidates, cand_mask)
    _check_nn(traj, candidates, cand_mask)
    if traj.numel() == 0:
        return torch.empty(traj.shape[:-1], dtype=traj.dtype, device=traj.device)
    return resident_launch(traj, keep_lists(traj, candidates, cand_mask))


def resident_launch(traj: torch.Tensor, operands, queries_per_block: Optional[int] = None) -> torch.Tensor:
    """K3's launch alone on :func:`keep_lists`' ``operands``, with
    ``queries_per_block`` queries a block (one of ``RESIDENT_BLOCKS``; by
    default :func:`resident_block`'s choice). Every block size gives the
    same minima bit for bit: a query's minimum is over the same distances."""
    order, nkept, cand3 = operands
    n, batch = traj.shape[-2], (traj.shape[0] if traj.ndim == 3 else 1)
    if queries_per_block is None:
        queries_per_block = resident_block(batch * order.shape[-2])
    out = torch.empty(traj.shape[:-1], dtype=traj.dtype, device=traj.device)
    with torch.cuda.device(traj.device):
        rc = _build.library().gps_nn_min_dist2(
            _build.dtype_code(traj), batch, traj.data_ptr(), n, cand3.data_ptr(),
            order.data_ptr(), nkept.data_ptr(), order.shape[-2], order.shape[-1],
            queries_per_block, out.data_ptr(), _build.stream(traj.device),
        )
    _build.check(rc, "nn_min_dist2 (resident)")
    _build.count_launch(nn_resident)
    return out


def nn_grid(
    traj: torch.Tensor, candidates: torch.Tensor, cand_mask: torch.Tensor
) -> torch.Tensor:
    """K4 (``csrc/nn_grid.cu``): blocks drawing the items of a work list
    of runs of kept candidate tiles of each query tile, minima folded with
    atomics, at any M; a batch of rows (B, N, 3) in one launch over every
    row's runs.
    The kernel reads the list's length on the device, so the call reads
    nothing back and a CUDA graph can hold it. Equals K3 bit for bit on the
    same inputs. CPU tensors take :func:`nn_min_dist2_plain`."""
    if traj.device.type == "cpu":
        return nn_min_dist2_plain(traj, candidates, cand_mask)
    _check_nn(traj, candidates, cand_mask)
    if traj.numel() == 0:
        return torch.empty(traj.shape[:-1], dtype=traj.dtype, device=traj.device)
    return grid_launch(traj, nn_grid_operands(traj, candidates, cand_mask))


def grid_launch(traj: torch.Tensor, operands, max_items: Optional[int] = None) -> torch.Tensor:
    """K4's launch alone on :func:`nn_grid_operands`' ``operands``. The
    kernel reads the work list's length (the last entry of ``ends``) on the
    device, and its blocks draw the items from a ticket counter, so nothing
    is read on the host. The grid is the blocks the card holds at once, at
    most ``max_items``: by default the most items the lists could hold
    (every query tile's runs of all candidate tiles). Any positive cap
    gives the same minima, with fewer blocks drawing more items each."""
    order, nkept, cand3, ends = operands
    n, batch = traj.shape[-2], (traj.shape[0] if traj.ndim == 3 else 1)
    out = torch.full(traj.shape[:-1], float("inf"), dtype=traj.dtype, device=traj.device)
    lib = _build.library()
    if lib.gps_nn_grid_run() != RUN_TILES:
        raise RuntimeError("csrc/nn_grid.cu cuts the keep lists by another run length")
    if max_items is None:
        max_items = min(ends.numel() * -(-order.shape[-1] // RUN_TILES), 2**31 - 1)
    if max_items == 0:
        return out
    ticket = torch.empty((1,), dtype=torch.int32, device=traj.device)
    with torch.cuda.device(traj.device):
        rc = lib.gps_nn_grid(
            _build.dtype_code(traj), batch, traj.data_ptr(), n, cand3.data_ptr(), order.data_ptr(),
            nkept.data_ptr(), ends.data_ptr(), order.shape[-2], order.shape[-1], max_items,
            ticket.data_ptr(), out.data_ptr(), _build.stream(traj.device),
        )
    _build.check(rc, "nn_min_dist2 (grid)")
    _build.count_launch(nn_grid)
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
    return counts_launch(src, dst, valid, R, t, s, thr2)


# K5's two shapes (csrc/ransac_counts.cu), from the card's times (PERF.md):
# a launch of at most COUNT_FEW_POINTS points in all takes 2 points a thread
# on the grid of every chunk (one launch, no scratch); a longer one 4 points
# a thread on the listed walk (a list of the chunks holding a valid point,
# built on the card, then resident blocks that draw them).
COUNT_PER_THREADS = (2, 4)
COUNT_FEW_POINTS = 65_536


def count_per_thread(points: int) -> int:
    """K5's points a thread, and so its shape, for a launch of ``points``
    points in all (rows times n)."""
    return 2 if points <= COUNT_FEW_POINTS else 4


def counts_launch(
    src: torch.Tensor,
    dst: torch.Tensor,
    valid: torch.Tensor,
    R: torch.Tensor,
    t: torch.Tensor,
    s: torch.Tensor,
    thr2: float,
    per_thread: Optional[int] = None,
    recounted: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """K5's launch on operands :func:`ransac_counts` has checked, with
    ``per_thread`` points a thread (2, the grid of every chunk, or 4, the
    listed walk; by default :func:`count_per_thread`'s choice); both give
    the same counts. ``recounted``: a CUDA int64 tensor of one element to
    which the launch adds the pairs it recounted in the plain order."""
    lead = src.shape[:-2]
    n, T = src.shape[-2], R.shape[-3]
    batch = lead[0] if lead else 1
    out = torch.zeros((*lead, T), dtype=torch.int32, device=src.device)
    if T == 0 or n == 0 or batch == 0:
        return out
    if per_thread is None:
        per_thread = count_per_thread(batch * n)
    if recounted is not None and (recounted.dtype != torch.int64 or recounted.device != src.device
                                  or recounted.numel() < 1):
        raise ValueError("recounted must be an int64 tensor of at least one element on src's device")
    lib = _build.library()
    nbytes = lib.gps_ransac_counts_scratch(n, batch, per_thread)
    if nbytes < 0:
        raise ValueError(f"K5 takes {COUNT_PER_THREADS} points a thread, not {per_thread}")
    scratch = torch.empty((-(-nbytes // 4),), dtype=torch.int32, device=src.device) if nbytes else None
    with torch.cuda.device(src.device):
        rc = lib.gps_ransac_counts(
            _build.dtype_code(src), batch, src.data_ptr(), dst.data_ptr(), valid.data_ptr(), n,
            R.data_ptr(), t.data_ptr(), s.data_ptr(), T, float(thr2), out.data_ptr(),
            0 if scratch is None else scratch.data_ptr(), per_thread,
            0 if recounted is None else recounted.data_ptr(), _build.stream(src.device),
        )
    _build.check(rc, "ransac_counts")
    _build.count_launch(ransac_counts)
    return out


ransac_counts.launches = 0


def pose_products(blocks: torch.Tensor, loop_ij: torch.Tensor, gps_valid: torch.Tensor, w_gps: float,
                  damping: float):
    """The pose graph's products over per-factor Jacobian blocks, the plain
    version's: ``(jt, hvp)`` with ``jt(u, u_gps)`` = Jᵀu for the factors'
    rows u (M, 6) and the GNSS rows u_gps (N, 3), and ``hvp(v)`` =
    (JᵀJ + λI)v for v (N, 6).

    ``blocks`` (M, 6, 12): the N − 1 odometry factors (k, k + 1), then the
    closures of ``loop_ij`` (L, 2), columns 0-5 against pose i and 6-11
    against pose j. The GNSS rows are w_gps·I₃ on the positions of the
    poses ``gps_valid`` marks. A pose's sum runs as the kernel's: its
    odometry factors (k, then k − 1), the GNSS row, then the closures in
    order of (closure, end)."""
    n = gps_valid.shape[0]
    odo = torch.arange(n - 1, device=blocks.device)
    ends = torch.stack([loop_ij[:, 0], loop_ij[:, 1]], -1).reshape(-1)
    pi = torch.cat([odo, loop_ij[:, 0]])
    pj = torch.cat([odo + 1, loop_ij[:, 1]])
    valid = gps_valid[:, None]

    def jt(u: torch.Tensor, u_gps: torch.Tensor) -> torch.Tensor:
        t = torch.einsum("mrc,mr->mc", blocks, u)
        out = torch.zeros((n, 6), dtype=blocks.dtype, device=blocks.device)
        out[:-1] = t[: n - 1, :6]
        out[1:] += t[: n - 1, 6:]
        out[:, :3] += torch.where(valid, w_gps * u_gps, torch.zeros_like(u_gps))
        return out.index_add_(0, ends, t[n - 1 :].reshape(-1, 6))

    def hvp(v: torch.Tensor) -> torch.Tensor:
        u = torch.einsum("mrc,mc->mr", blocks, torch.cat([v[pi], v[pj]], -1))
        return jt(u, w_gps * v[:, :3]) + damping * v

    return jt, hvp


def pose_cg_plain(
    blocks: torch.Tensor,
    r0: torch.Tensor,
    r_gps: torch.Tensor,
    gps_valid: torch.Tensor,
    w_gps: float,
    loop_ij: torch.Tensor,
    damping: float,
    maxiter: int,
    tol: float = 1e-10,
):
    """The plain version of :func:`pose_cg`: b = −Jᵀr0, then conjugate
    gradients from x₀ = 0, the recurrence of JAX's
    ``jax.scipy.sparse.linalg.cg`` (``_cg_solve``, no preconditioner):
    r₀ = b (A·0 = 0), stop once γ = r·r ≤ tol²·b·b or after ``maxiter``
    iterations. The while loop runs as ``maxiter`` iterations in which a
    finished solve keeps its values (a selection, not a multiply by a mask:
    α may be 0/0 in a finished step), so nothing is read on the host.
    Returns (δ (N, 6), the active iterations as a 0-d int64 tensor)."""
    jt, hvp = pose_products(blocks, loop_ij, gps_valid, w_gps, damping)
    b = -jt(r0, r_gps)
    bb = torch.sum(b * b)
    atol2 = torch.clamp(tol * tol * bb, min=0.0)
    x, r, p, gamma = torch.zeros_like(b), b, b, bb
    count = torch.zeros((), dtype=torch.int64, device=b.device)
    for _ in range(maxiter):
        active = gamma > atol2
        ap = hvp(p)
        alpha = gamma / torch.sum(p * ap)
        x_new = x + alpha * p
        r_new = r - alpha * ap
        gamma_new = torch.sum(r_new * r_new)
        p_new = r_new + (gamma_new / gamma) * p
        x = torch.where(active, x_new, x)
        r = torch.where(active, r_new, r)
        p = torch.where(active, p_new, p)
        gamma = torch.where(active, gamma_new, gamma)
        count = count + active
    return x, count


def pose_cg(
    blocks: torch.Tensor,
    r0: torch.Tensor,
    r_gps: torch.Tensor,
    gps_valid: torch.Tensor,
    w_gps: float,
    loop_ij: torch.Tensor,
    damping: float,
    maxiter: int,
    tol: float = 1e-10,
):
    """Solve (JᵀJ + λI)δ = −Jᵀr0 by :func:`pose_cg_plain`'s recurrence over
    per-factor Jacobian blocks, every iteration in one launch of
    ``csrc/pose_cg.cu``: a thread-block cluster of up to 16 blocks (at
    least 32 poses a block), each owning a contiguous range of poses; dot
    products folded in a fixed order, so two launches give the same bits.

    ``blocks`` (M, 6, 12) and ``r0`` (M, 6): the N − 1 odometry factors,
    then the L closures of ``loop_ij`` (L, 2) (an invalid closure's zero);
    ``r_gps`` (N, 3) the masked GNSS residual, its rows w_gps·I₃ on the
    positions of the poses ``gps_valid`` (N,) marks. Returns (δ (N, 6), the
    iterations that ran before γ met the tolerance, a 0-d int32 tensor on
    the device). CPU tensors take :func:`pose_cg_plain`."""
    if blocks.device.type == "cpu":
        return pose_cg_plain(blocks, r0, r_gps, gps_valid, w_gps, loop_ij, damping, maxiter, tol)
    _build.require_cuda(blocks, r0, r_gps, gps_valid, loop_ij)
    n, n_loop = r_gps.shape[0], loop_ij.shape[0]
    m = n - 1 + n_loop
    if n < 1 or blocks.shape != (m, 6, 12) or r0.shape != (m, 6) or r_gps.shape != (n, 3) \
            or gps_valid.shape != (n,) or loop_ij.shape != (n_loop, 2):
        raise ValueError("pose_cg takes blocks (N - 1 + L, 6, 12), r0 (N - 1 + L, 6), r_gps (N, 3), "
                         "gps_valid (N,) and loop_ij (L, 2)")
    if blocks.dtype != r0.dtype or blocks.dtype != r_gps.dtype or gps_valid.dtype != torch.bool \
            or loop_ij.dtype != torch.int64:
        raise TypeError("blocks, r0 and r_gps share one float dtype; gps_valid is bool, loop_ij int64")
    if maxiter < 0:
        raise ValueError("maxiter must be at least 0")
    delta = torch.empty((n, 6), dtype=blocks.dtype, device=blocks.device)
    scratch = torch.empty((3, n, 6), dtype=blocks.dtype, device=blocks.device)
    count = torch.empty((), dtype=torch.int32, device=blocks.device)
    with torch.cuda.device(blocks.device):
        rc = _build.library().gps_pose_cg(
            _build.dtype_code(blocks), n, n_loop, blocks.data_ptr(), r0.data_ptr(), r_gps.data_ptr(),
            gps_valid.data_ptr(), float(w_gps), loop_ij.data_ptr(), float(damping), int(maxiter), float(tol),
            delta.data_ptr(), scratch.data_ptr(), count.data_ptr(), _build.stream(blocks.device),
        )
    _build.check(rc, "pose_cg")
    _build.count_launch(pose_cg)
    return delta, count


pose_cg.launches = 0
