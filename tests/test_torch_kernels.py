"""K3 and K4 (nearest-neighbour distance) and K5 (RANSAC counts) of
``ops.kernels``.

On the CPU the wrappers take their plain versions; these are held against
the JAX package's Pallas kernels in interpret mode (K4's function against
the pipelined 2-D grid, forced by a zero resident budget) and its exact
counting form. The array code around the CUDA NN kernels (tile bounds in
row blocks, keep lists, candidate packing) runs here too: a NumPy walk over
exactly the operands each kernel receives, in each kernel's order of work
(K3's blocks of a query tile sharing one keep list, their slices of a
staged tile and the fold; K4's runs; K5's point chunks by trial chunks and
their partial counts), must give the brute-force minimum and the plain
counts, and the K3/K4 routing rule is held at its edges.

Tolerances: NN ≤1e-6 relative against the JAX kernel, which computes in
float32 (inputs are rounded to float32 first, so only the kernel's own
rounding remains); the emulated kernel walk equals the brute force to
1e-14 relative; counts, and the emulated kernel's, exactly equal to JAX's
elementwise form, and within 2 of its float32 quadratic-form kernel (which
the JAX package re-ranks for that reason).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gps_optimize_slam_tpu.ops import pallas_kernels as jpk
from gps_optimize_slam_tpu_torch.ops import kernels


def walk(rng, n, scale=1.0, offset=0.0):
    """A random-walk trajectory (spatially coherent, like the main path's),
    rounded to float32 so both sides see the same inputs."""
    x = np.cumsum(rng.normal(size=(n, 3)) * scale, axis=0) + offset
    return x.astype(np.float32).astype(np.float64)


def jax_nn(traj, cands, mask):
    return np.asarray(
        jpk.nn_min_dist2(jnp.asarray(traj), jnp.asarray(cands), jnp.asarray(mask), interpret=True)
    ).astype(np.float64)


@pytest.mark.parametrize("n,m", [(300, 1500), (5, 7)])
def test_plain_nn_matches_jax_kernel(n, m):
    rng = np.random.default_rng(n)
    traj, cands = walk(rng, n), walk(rng, m, offset=0.5)
    mask = rng.uniform(size=m) > 0.2
    got = kernels.nn_min_dist2(torch.tensor(traj), torch.tensor(cands), torch.tensor(mask)).numpy()
    np.testing.assert_allclose(got, jax_nn(traj, cands, mask), rtol=1e-6)


def test_plain_nn_all_masked_and_nan_rows():
    rng = np.random.default_rng(3)
    traj, cands = walk(rng, 300), walk(rng, 1500)
    traj[[7, 123]] = np.nan  # unspecified rows; the others must not notice
    none = np.zeros(1500, bool)
    got = kernels.nn_min_dist2(torch.tensor(traj), torch.tensor(cands), torch.tensor(none)).numpy()
    assert np.isinf(got[np.isfinite(traj).all(1)]).all()
    mask = rng.uniform(size=1500) > 0.5
    got = kernels.nn_min_dist2(torch.tensor(traj), torch.tensor(cands), torch.tensor(mask)).numpy()
    want = jax_nn(traj, cands, mask)
    ok = np.isfinite(traj).all(1)
    np.testing.assert_allclose(got[ok], want[ok], rtol=1e-6)


NN_THREADS = 256  # csrc/nn.cu kNnThreads
SMALL_GRID_TILES = 256  # csrc/nn.cu kSmallGridTiles: 16 queries a block up to here, 32 beyond


def emulate_kernel(traj, cands, mask, sub=None, per_thread=None, per_vector=2):
    """What csrc/nn.cu computes from the wrapper's operands, in NumPy, in
    its order of work: each 128-query tile is cut into blocks of ``sub``
    queries that share the tile's keep list; a block's 256 threads are
    ``sub / per_thread`` query lanes by slices, a thread holding
    ``per_thread`` queries and scanning every slices-th vector of
    ``per_vector`` candidates (16 bytes: 4 in float32, 2 in float64) of each
    kept tile; the slices' minima are folded at the end. A pair's distance
    is the kernel's, the validity row added as the last term
    (csrc/nn_tile.cuh). Blocks whose queries are all padding do nothing and
    padding queries are never written: the output starts as NaN and must
    come back without one. Returns (out, nkept, m_tiles)."""
    order, nkept, cand4 = (x.numpy() for x in kernels.keep_lists(traj, cands, mask))
    if sub is None:
        sub, per_thread = (16, 2) if order.shape[0] <= SMALL_GRID_TILES else (32, 4)
    lanes = sub // per_thread
    slices = NN_THREADS // lanes
    vectors = kernels.TILE_M // per_vector
    assert lanes * per_thread == sub and lanes * slices == NN_THREADS and kernels.TILE_N % sub == 0
    # candidate columns of each slice: vectors slice, slice + slices, ...
    cols = [(np.arange(sl, vectors, slices)[:, None] * per_vector + np.arange(per_vector)).ravel()
            for sl in range(slices)]
    assert sorted(np.concatenate(cols)) == list(range(kernels.TILE_M))  # every candidate once
    a = traj.numpy()
    n = len(a)
    out = np.full(n, np.nan)
    for block in range(order.shape[0] * (kernels.TILE_N // sub)):
        i, q0 = divmod(block * sub, kernels.TILE_N)
        q0 += i * kernels.TILE_N
        if q0 >= n:
            continue
        q = np.zeros((sub, 3))
        q[: max(0, min(sub, n - q0))] = a[q0 : q0 + sub]
        best = np.full((slices, sub), np.inf)
        for k in range(nkept[i]):
            blk = cand4[order[i, k]]  # (4, TILE_M): x, y, z, validity (+0 or +inf)
            for sl in range(slices):
                c = cols[sl]
                d = ((q[:, 0, None] - blk[0, c]) ** 2 + (q[:, 1, None] - blk[1, c]) ** 2
                     + (q[:, 2, None] - blk[2, c]) ** 2 + blk[3, c])
                best[sl] = np.fmin(best[sl], d.min(1))
        rows = min(sub, n - q0)
        out[q0 : q0 + rows] = best.min(0)[:rows]
    assert not np.isnan(out).any()
    return out, nkept, order.shape[1]


NN_BLOCKS = [(16, 2, 2), (16, 2, 4), (32, 4, 2), (32, 4, 4)]  # (queries a block, a thread, candidates a vector)


@pytest.mark.parametrize("sub,per_thread,per_vector", NN_BLOCKS)
@pytest.mark.parametrize("n,m,scale", [(2000, 3000, 1.0), (700, 2500, 5.0), (130, 1025, 0.3),
                                       (1131, 3000, 1.0), (5, 1, 1.0)])
def test_kernel_operands_give_the_exact_minimum(n, m, scale, sub, per_thread, per_vector):
    """Both block sizes of K3 and both vector widths, at a ragged last block
    (2000 = 15 tiles + 80; 1131 = 8 tiles + 107, its last block 11 queries
    of 16 or 32; 130 = one tile + 2) and at fewer queries than one block
    takes (5)."""
    rng = np.random.default_rng(m)
    traj = torch.tensor(walk(rng, n, scale))
    cands = torch.tensor(walk(rng, m, scale, offset=2.0))
    mask = torch.tensor(rng.uniform(size=m) > 0.1)
    got, nkept, m_tiles = emulate_kernel(traj, cands, mask, sub, per_thread, per_vector)
    want = kernels.nn_min_dist2_plain(traj, cands, mask).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-14)
    if n in (2000, 700):
        assert nkept.sum() < nkept.size * m_tiles  # the pruning did skip tiles
    none, _, _ = emulate_kernel(traj, cands, torch.zeros_like(mask), sub, per_thread, per_vector)
    assert np.isinf(none).all()  # every candidate masked: +inf, not NaN


@pytest.mark.parametrize("offset", [0.0, 5.4e6])  # local frame and UTM magnitudes
def test_keep_mask_never_drops_the_true_nn_tile(offset):
    """The explicit-order float64 bounds ((x0² + x1²) + x2², the kernel's
    order) keep the tile of every query's true nearest neighbour, in the
    mask and in the compacted keep lists."""
    rng = np.random.default_rng(11)
    for scale in (0.2, 1.0, 20.0):
        traj, cands = walk(rng, 1500, scale, offset), walk(rng, 2200, scale, offset + 1.0)
        mask = rng.uniform(size=2200) > 0.3
        d2 = ((traj[:, None] - cands[None]) ** 2).sum(-1)
        nn = np.where(mask[None], d2, np.inf).argmin(1)
        n_pad = -(-1500 // kernels.TILE_N) * kernels.TILE_N
        m_pad = -(-2200 // kernels.TILE_M) * kernels.TILE_M
        tp = np.concatenate([traj, np.repeat(traj[-1:], n_pad - 1500, 0)])
        cp = np.zeros((m_pad, 3))
        cp[:2200] = cands
        vm = np.zeros(m_pad, bool)
        vm[:2200] = mask
        keep = kernels.tile_keep_mask(torch.tensor(tp), torch.tensor(cp), torch.tensor(vm)).numpy()
        q = np.arange(1500)
        assert keep[q // kernels.TILE_N, nn // kernels.TILE_M].all()
        order, nkept, _ = (x.numpy() for x in kernels.keep_lists(
            torch.tensor(traj), torch.tensor(cands), torch.tensor(mask)))
        for i in range(order.shape[0]):
            assert set(nn[i * kernels.TILE_N : (i + 1) * kernels.TILE_N] // kernels.TILE_M) <= set(
                order[i, : nkept[i]])


def test_keep_lists_plain_compacts_the_mask_in_ascending_order():
    rng = np.random.default_rng(17)
    keep = torch.tensor(rng.uniform(size=(9, 13)) > 0.6)
    keep[2] = False  # a row with nothing kept
    keep[5] = True  # a row with everything kept
    order, nkept = kernels.keep_lists_plain(keep)
    assert order.dtype == torch.int32 and nkept.dtype == torch.int32
    assert torch.equal(order, torch.sort(1 - keep.to(torch.int32), dim=1, stable=True).indices.to(torch.int32))
    assert torch.equal(nkept, keep.sum(1).to(torch.int32))
    for i in range(keep.shape[0]):
        kept = order[i, : nkept[i]]
        assert torch.equal(kept, torch.nonzero(keep[i]).flatten().to(torch.int32))  # ascending
        assert bool((kept[1:] > kept[:-1]).all())


def sim3_trials(rng, n, T):
    src = rng.normal(size=(n, 3)) * 20
    dst = 0.98 * src + np.array([3.0, -2.0, 1.0]) + rng.normal(size=(n, 3)) * 2.0
    q = rng.normal(size=(T, 4))
    q[:, :3] *= 0.02
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    x, y, z, w = q.T
    R = np.stack([
        1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
        2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
        2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y),
    ], -1).reshape(T, 3, 3)
    t = np.array([3.0, -2.0, 1.0]) + rng.normal(size=(T, 3)) * 0.5
    s = 0.98 + rng.normal(size=T) * 0.01
    valid = rng.uniform(size=n) > 0.1
    return src, dst, valid, R, t, s


def jax_exact_counts(src, dst, valid, R, t, s, thr2):
    """The JAX package's exact counting form (ransac.py trial_mask)."""
    pred = s[:, None, None] * (jnp.asarray(src)[None] @ jnp.swapaxes(jnp.asarray(R), 1, 2)) + t[:, None]
    res2 = jnp.sum((pred - jnp.asarray(dst)[None]) ** 2, axis=-1)
    return np.asarray(jnp.sum((res2 < thr2) & jnp.asarray(valid)[None], axis=1))


def test_plain_counts_match_jax_exact_and_kernel():
    rng = np.random.default_rng(5)
    src, dst, valid, R, t, s = sim3_trials(rng, 1500, 300)
    args = [torch.tensor(a) for a in (src, dst, valid, R, t, s)]
    got = kernels.ransac_counts(*args, 16.0).numpy()
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, jax_exact_counts(src, dst, valid, R, t, s, 16.0))
    approx = np.asarray(jpk.ransac_counts(
        jnp.asarray(src), jnp.asarray(dst), jnp.asarray(valid), jnp.asarray(R),
        jnp.asarray(t), jnp.asarray(s), thr2=16.0, interpret=True,
    ))
    assert np.abs(got - approx).max() <= 2
    assert 0 < got.min() and got.max() < valid.sum()  # the threshold cuts


COUNT_THREADS, COUNT_TRIALS = 256, 32  # csrc/ransac_counts.cu: points and trials a block


def emulate_count_kernel(src, dst, valid, R, t, s, thr2):
    """What csrc/ransac_counts.cu computes, in NumPy, in its order of work:
    a grid of (chunks of 256 points) x (chunks of 32 trials); a block's
    threads hold one point each and walk the block's trials, each warp of 32
    points adds its hits of a trial into the block's counter, and the block
    adds its counters into the zeroed output. The residual is the kernel's
    elementwise expression."""
    n, T = len(src), len(R)
    out = np.zeros(T, np.int32)
    for p0 in range(0, n, COUNT_THREADS):
        i = np.arange(p0, p0 + COUNT_THREADS)
        ok = (i < n) & valid[np.minimum(i, n - 1)]
        p = np.where(ok[:, None], src[np.minimum(i, n - 1)], 0.0)
        d = np.where(ok[:, None], dst[np.minimum(i, n - 1)], 0.0)
        for t0 in range(0, T, COUNT_TRIALS):
            tc = min(COUNT_TRIALS, T - t0)
            block = np.zeros(COUNT_TRIALS, np.int32)
            for u in range(tc):
                r, tt, sc = R[t0 + u], t[t0 + u], s[t0 + u]
                e = [sc * (p[:, 0] * r[j, 0] + p[:, 1] * r[j, 1] + p[:, 2] * r[j, 2]) + tt[j] - d[:, j]
                     for j in range(3)]
                hit = ok & (e[0] * e[0] + e[1] * e[1] + e[2] * e[2] < thr2)
                for warp in hit.reshape(-1, 32):  # one sum a warp, kept by lane u
                    block[u] += warp.sum()
            out[t0 : t0 + tc] += block[:tc]
    return out


@pytest.mark.parametrize("n,T,none_valid", [(1500, 300, False), (279, 1000, False), (5003, 333, False),
                                            (1, 1, False), (1500, 300, True)])
def test_emulated_count_kernel_equals_plain_and_jax_exact(n, T, none_valid):
    """Ragged point chunks (1500 = 5 x 256 + 220, 279, 5003) and trial chunks
    (300 = 9 x 32 + 12, 1000, 333), one point and one trial, and no valid
    point: the per-chunk partial counts sum to the plain counts exactly."""
    rng = np.random.default_rng(n + T)
    src, dst, valid, R, t, s = sim3_trials(rng, n, T)
    if none_valid:
        valid = np.zeros(n, bool)
    got = emulate_count_kernel(src, dst, valid, R, t, s, 16.0)
    plain = kernels.ransac_counts_plain(*[torch.tensor(a) for a in (src, dst, valid, R, t, s)], 16.0).numpy()
    np.testing.assert_array_equal(got, plain)
    np.testing.assert_array_equal(got, jax_exact_counts(src, dst, valid, R, t, s, 16.0))
    if none_valid:
        assert (got == 0).all()
    elif n >= 279:
        assert 0 < got.max() < n  # the threshold cuts


def test_nn_route_matches_jax():
    """The port's own rule at its edges: K4 from ``GRID_MIN_CANDIDATES`` on
    where all rows hold ``GRID_MAX_QUERY_TILES`` query tiles or fewer, K3
    otherwise, whatever the padding; the in-core path's sizes and the
    chunked evaluation's 524,288 x 524,288 blocks take K3, a few query tiles
    against many candidates K4, a batch counted by all its rows' tiles."""
    edge, tiles = kernels.GRID_MIN_CANDIDATES, kernels.GRID_MAX_QUERY_TILES
    assert edge == 524_288 and tiles == 64
    few = tiles * kernels.TILE_N  # the most queries K4 takes in one row
    for m in (0, 1, 1024, 4661, 262_144, 262_145, 300_000, edge - 1):
        assert kernels.nn_route(m, 700) == "resident", m
        assert kernels.nn_route(m, few) == "resident", m
    for m in (edge, edge + 1, 1_048_576):
        assert kernels.nn_route(m, 1) == "grid", m
        assert kernels.nn_route(m, few) == "grid", m
        assert kernels.nn_route(m, few + 1) == "resident", m  # a 65th query tile
        assert kernels.nn_route(m, edge) == "resident", m  # the chunked evaluation's block
    assert kernels.nn_route(edge, 4661) == "grid"  # 37 query tiles
    assert kernels.nn_route(edge, 700, batch=4) == "grid"  # 4 x 6 query tiles
    assert kernels.nn_route(edge, 700, batch=11) == "resident"  # 66
    assert kernels.nn_route(edge, few // 4, batch=4) == "grid"
    assert kernels.nn_route(edge, few // 4 + 1, batch=4) == "resident"
    # Where the JAX package's rule sat (its resident kernel's 8 MiB VMEM
    # budget): the change above 262,144 candidates, half the port's edge,
    # whatever the queries.
    jax_last = jpk._RESIDENT_BUDGET_BYTES // (jpk._PAD_DIM * 4)
    assert jax_last == 262_144 and kernels.nn_route(jax_last + 1, 1) == "resident"


@pytest.mark.parametrize("n,m", [(300, 2500), (40, 777)])
def test_plain_nn_matches_jax_pipelined_kernel(n, m):
    rng = np.random.default_rng(n + m)
    traj, cands = walk(rng, n), walk(rng, m, offset=0.5)
    mask = rng.uniform(size=m) > 0.2
    orig = jpk._RESIDENT_BUDGET_BYTES
    jpk._RESIDENT_BUDGET_BYTES = 0  # force the pipelined 2-D grid
    try:
        want = np.asarray(jpk.nn_min_dist2.__wrapped__(
            jnp.asarray(traj), jnp.asarray(cands), jnp.asarray(mask), interpret=True
        )).astype(np.float64)
    finally:
        jpk._RESIDENT_BUDGET_BYTES = orig
    for fn in (kernels.nn_min_dist2, kernels.nn_grid, kernels.nn_resident):
        got = fn(torch.tensor(traj), torch.tensor(cands), torch.tensor(mask)).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-6)


def emulate_grid_kernel(traj, cands, mask):
    """What csrc/nn_grid.cu computes from the wrapper's operands, in NumPy:
    block b of the work list takes query tile i (ends[i-1] <= b < ends[i])
    and its run of at most RUN_TILES kept tiles, and folds its minima."""
    order, nkept, cand4, ends = (x.numpy() for x in kernels.nn_grid_operands(traj, cands, mask))
    a = traj.numpy()
    out = np.full(len(a), np.inf)
    for b in range(int(ends[-1])):
        i = int(np.searchsorted(ends, b, side="right"))
        k0 = (b - (ends[i - 1] if i else 0)) * kernels.RUN_TILES
        rows = slice(i * kernels.TILE_N, min(len(a), (i + 1) * kernels.TILE_N))
        q = a[rows]
        for k in range(k0, min(nkept[i], k0 + kernels.RUN_TILES)):
            blk = cand4[order[i, k]]  # (4, TILE_M), validity folded in row 3
            d = ((q[:, 0, None] - blk[0]) ** 2 + (q[:, 1, None] - blk[1]) ** 2
                 + (q[:, 2, None] - blk[2]) ** 2 + (0.0 - blk[3]) ** 2)
            out[rows] = np.minimum(out[rows], d.min(1))
    return out, nkept, ends


@pytest.mark.parametrize("n,m,scale,shuffle", [(2000, 3000, 1.0, False), (130, 1025, 0.3, False),
                                               (700, 9000, 3.0, True)])
def test_grid_kernel_operands_give_the_exact_minimum(n, m, scale, shuffle):
    """Shuffled candidates spread every tile over the whole track, so every
    tile is kept and each query tile's list spans several K4 blocks."""
    rng = np.random.default_rng(m + 1)
    traj = torch.tensor(walk(rng, n, scale))
    cands = walk(rng, m, scale, offset=2.0)
    cands = torch.tensor(cands[rng.permutation(m)] if shuffle else cands)
    mask = torch.tensor(rng.uniform(size=m) > 0.1)
    got, nkept, ends = emulate_grid_kernel(traj, cands, mask)
    want = kernels.nn_min_dist2_plain(traj, cands, mask).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, emulate_kernel(traj, cands, mask)[0])  # K3's walk
    runs = -(-nkept // kernels.RUN_TILES)
    np.testing.assert_array_equal(ends, np.cumsum(runs))
    if shuffle:
        assert (runs > 1).all()  # a query tile's list spans several blocks
    elif n >= 700:
        m_tiles = -(-m // kernels.TILE_M)
        assert nkept.sum() < nkept.size * m_tiles  # the grid covers kept work only


def test_blocked_keep_mask_equals_the_unblocked_one(monkeypatch):
    rng = np.random.default_rng(21)
    n_pad, m_pad = 40 * kernels.TILE_N, 9 * kernels.TILE_M
    n_sub, m_sub = n_pad // kernels.SUB, m_pad // kernels.SUB
    tp = torch.tensor(walk(rng, n_pad, 2.0))
    cp = torch.tensor(walk(rng, m_pad, 2.0, offset=1.0))
    vm = torch.tensor(rng.uniform(size=m_pad) > 0.2)
    default = kernels.tile_keep_mask(tp, cp, vm)
    monkeypatch.setattr(kernels, "_KEEP_BLOCK_ELEMS", n_sub * m_sub)  # one block
    whole = kernels.tile_keep_mask(tp, cp, vm)
    assert whole.shape == (40, 9) and 0 < int(whole.sum()) < whole.numel()
    assert torch.equal(default, whole)
    # One query tile per block, three per block (a ragged last block), and
    # a budget below one tile, which still takes one tile.
    per_tile = kernels.TILE_N // kernels.SUB
    for elems in (per_tile * m_sub, 3 * per_tile * m_sub, 1):
        monkeypatch.setattr(kernels, "_KEEP_BLOCK_ELEMS", elems)
        assert torch.equal(kernels.tile_keep_mask(tp, cp, vm), whole), elems


# --- The keep-list kernel's order of work (csrc/nn_keep.cu), emulated ------
#
# The kernel cannot run here, so its two-level pruning is emulated in NumPy
# with the plain version's float64 expressions: a box per candidate tile (the
# min/max over its 32 segment boxes), thr seeded from the upper bounds
# between the tile boxes and the box around the block's query segments, the
# tile-level test before any segment is looked at in both passes (against
# the running thr, which is folded in after each chunk of tiles, and
# against the slackened bound; the block box's bound against the largest
# thr goes first and alone rules a tile out), and blocks of Q query tiles
# that share one test and one thr sweep (the last block replicating its
# last segment).
# The mask must equal ``kernels.tile_keep_mask`` bit for bit: that is what
# proves the tile-level test exact where no card is.


def _sq3(v):
    return (v[..., 0] * v[..., 0] + v[..., 1] * v[..., 1]) + v[..., 2] * v[..., 2]


def _lb(qlo, qhi, clo, chi):
    return _sq3(np.maximum(np.maximum(qlo - chi, clo - qhi), 0.0))


def _ub(qlo, qhi, clo, chi):
    return _sq3(np.maximum(qhi - clo, chi - qlo))


def emulate_keep_kernel(traj, cands, mask, Q, chunk):
    """(keep mask, segment boxes read) of the kernel's order of work with
    ``Q`` query tiles a block and ``chunk`` candidate tiles a sweep step."""
    tp, cp, vm = (x.numpy() for x in kernels.bounds_operands(traj, cands, mask))
    per_q, per_c = kernels.TILE_N // kernels.SUB, kernels.TILE_M // kernels.SUB
    tb = tp.reshape(-1, kernels.SUB, 3)
    t_lo, t_hi = tb.min(1), tb.max(1)
    cb, v = cp.reshape(-1, kernels.SUB, 3), vm.reshape(-1, kernels.SUB, 1)
    c_lo, c_hi = np.where(v, cb, np.inf).min(1), np.where(v, cb, -np.inf).max(1)
    n_sub, m_tiles = len(t_lo), len(c_lo) // per_c
    n_tiles = n_sub // per_q
    tile_lo = c_lo.reshape(m_tiles, per_c, 3).min(1)
    tile_hi = c_hi.reshape(m_tiles, per_c, 3).max(1)
    keep = np.zeros((n_tiles, m_tiles), bool)
    read = 0
    for first in range(0, n_tiles, Q):
        segs = np.minimum(first * per_q + np.arange(Q * per_q), n_sub - 1)
        qlo, qhi = t_lo[segs][:, None], t_hi[segs][:, None]  # (QS, 1, 3)
        blo, bhi = qlo.min(0), qhi.max(0)  # (1, 3): the block box
        thr = np.full(len(segs), _ub(blo, bhi, tile_lo, tile_hi).min())  # the seed
        for base in range(0, m_tiles, chunk):
            t = np.arange(base, min(base + chunk, m_tiles))
            coarse = _lb(blo, bhi, tile_lo[t], tile_hi[t]) <= thr.max()
            near = (_lb(qlo, qhi, tile_lo[t][None], tile_hi[t][None]) <= thr[:, None]).any(0)
            assert not (near & ~coarse).any()  # the block box's bound alone decides nothing else
            near &= coarse
            for tile in t[near]:
                s = slice(tile * per_c, (tile + 1) * per_c)
                read += per_c
                new = _ub(qlo, qhi, c_lo[s][None], c_hi[s][None]).min(1)
                near_thr = new if tile == t[near][0] else np.minimum(near_thr, new)
            if near.any():
                thr = np.minimum(thr, near_thr)  # folded in after the chunk
        bound = thr + 1e-5 * (thr + 1.0)
        for base in range(0, m_tiles, chunk):
            t = np.arange(base, min(base + chunk, m_tiles))
            coarse = _lb(blo, bhi, tile_lo[t], tile_hi[t]) <= bound.max()
            near = (_lb(qlo, qhi, tile_lo[t][None], tile_hi[t][None]) <= bound[:, None]).any(0)
            assert not (near & ~coarse).any()
            near &= coarse
            for tile in t[near]:
                s = slice(tile * per_c, (tile + 1) * per_c)
                read += per_c
                passes = (_lb(qlo, qhi, c_lo[s][None], c_hi[s][None]) <= bound[:, None]).any(1)
                for i in range(min(Q, n_tiles - first)):
                    keep[first + i, tile] = passes[i * per_q : (i + 1) * per_q].any()
    return keep, read


def track(rng, n, offset, kind):
    """float64 points: a drive (steady motion plus a random walk, the main
    path's kind of track) or uniform scatter, in a local frame or at UTM
    magnitudes."""
    if kind == "walk":
        return np.cumsum(rng.normal(size=(n, 3)) * 0.3 + np.array([0.8, 0.1, 0.0]), axis=0) + offset
    return rng.uniform(-40.0, 40.0, size=(n, 3)) + offset


KEEP_MASKS = ("random", "all-masked", "part-masked")


@pytest.mark.parametrize("Q,chunk", [(1, 256), (2, 2), (4, 3)])
@pytest.mark.parametrize("masking", KEEP_MASKS)
@pytest.mark.parametrize("offset", [0.0, 5.4e6])
@pytest.mark.parametrize("kind,n,m", [("walk", 1500, 5000), ("walk", 700, 1025), ("walk", 130, 7),
                                      ("scatter", 900, 5000)])
def test_emulated_keep_kernel_equals_plain_mask(kind, n, m, offset, masking, Q, chunk):
    rng = np.random.default_rng(n + m + Q)
    traj, cands = track(rng, n, offset, kind), track(rng, m, offset + 0.3, kind)
    if masking == "random":
        mask = rng.uniform(size=m) > 0.1
    elif masking == "all-masked":
        mask = np.zeros(m, bool)
    else:  # whole tiles and runs of segments masked out, one tile left with a single fix
        mask = rng.uniform(size=m) > 0.1
        mask[: min(m, kernels.TILE_M)] = False
        mask[min(m - 1, 3)] = True
        mask[m // 2 : m // 2 + 3 * kernels.SUB] = False
    args = [torch.tensor(a) for a in (traj, cands, mask)]
    want = kernels.tile_keep_mask(*kernels.bounds_operands(*args)).numpy()
    got, read = emulate_keep_kernel(*args, Q, chunk)
    np.testing.assert_array_equal(got, want)
    n_tiles, m_tiles = want.shape
    if masking == "all-masked":
        assert want.all()  # no finite upper bound: every tile kept, as in the JAX mask
    elif kind == "walk" and m == 5000 and masking == "random":
        # The tile-level test bites: under half of the first version's two
        # reads of every segment box per query tile.
        assert read < n_tiles * m_tiles * (kernels.TILE_M // kernels.SUB)


# --- The batch grids (the JAX package's vmap of each kernel), emulated -----
#
# A batched call lays its B rows one after another in device memory and
# launches one grid whose extra dimension is the row; a block offsets every
# pointer by its row (csrc/nn_keep.cu, csrc/nn.cu, csrc/ransac_counts.cu).
# These emulations read flat buffers through those offsets and run the
# single-row order of work on what they find, so a wrong stride shows as a
# row reading its neighbour's data.


def batch_of(rng, ns, ms, offset=0.0):
    """(traj (B, n, 3), cands (B, m, 3), mask (B, m)) of B ragged rows:
    row r's real queries and candidates fill its first ns[r] and ms[r]
    entries, the rest repeats its last point and is masked out, as
    ``pad_batch`` pads; the last row has every candidate masked."""
    n, m = max(ns), max(ms)
    traj, cands, mask = np.zeros((len(ns), n, 3)), np.zeros((len(ns), m, 3)), np.zeros((len(ns), m), bool)
    for r, (nr, mr) in enumerate(zip(ns, ms)):
        t, c = walk(rng, nr, 1.0, offset), walk(rng, mr, 1.0, offset + 2.0)
        traj[r, :nr], traj[r, nr:] = t, t[-1]
        cands[r, :mr], cands[r, mr:] = c, c[-1]
        mask[r, :mr] = rng.uniform(size=mr) > 0.1
    mask[-1] = False
    return torch.tensor(traj), torch.tensor(cands), torch.tensor(mask)


def emulate_batched_nn_kernel(traj, cands, mask):
    """K3's batch grid from flat device-memory images of the batched
    operands: block (x, y) takes row y's slices at the kernel's offsets
    (traj + 3 n y, cand + 4096 m_tiles y, order + n_tiles m_tiles y,
    nkept + n_tiles y, out + n y) and does the single-row tile's work."""
    B, n, _ = traj.shape
    order, nkept, cand4 = kernels.keep_lists(traj, cands, mask)
    n_tiles, m_tiles = order.shape[1:]
    flat = {k: v.reshape(-1).numpy() for k, v in
            dict(traj=traj, cand=cand4, order=order, nkept=nkept).items()}
    out = np.full(B * n, np.nan)
    for y in range(B):
        t = flat["traj"][3 * n * y : 3 * n * (y + 1)].reshape(n, 3)
        c4 = flat["cand"][4 * kernels.TILE_M * m_tiles * y:][: 4 * kernels.TILE_M * m_tiles]
        o = flat["order"][n_tiles * m_tiles * y:][: n_tiles * m_tiles].reshape(n_tiles, m_tiles)
        k = flat["nkept"][n_tiles * y:][:n_tiles]
        for i in range(n_tiles):
            q = t[i * kernels.TILE_N : (i + 1) * kernels.TILE_N]
            best = np.full(len(q), np.inf)
            for kk in range(k[i]):
                blk = c4.reshape(m_tiles, 4, kernels.TILE_M)[o[i, kk]]
                d = ((q[:, 0, None] - blk[0]) ** 2 + (q[:, 1, None] - blk[1]) ** 2
                     + (q[:, 2, None] - blk[2]) ** 2 + blk[3])
                best = np.fmin(best, d.min(1))
            out[n * y + i * kernels.TILE_N :][: len(q)] = best
    assert not np.isnan(out).any()
    return out.reshape(B, n)


@pytest.mark.parametrize("ns,ms", [((300, 150, 1, 300), (1500, 700, 1025, 9)), ((5,), (1,)),
                                   ((130,) * 3, (2100, 3000, 40))])
def test_batched_nn_and_keep_lists_equal_each_row_alone(ns, ms):
    """Ragged rows, B = 1 and an all-masked row: the batched plain keep
    lists, packed candidates and minima equal the single-row ones on each
    row bit for bit, and so does K3's batch grid read through its row
    offsets; K4's batched operands are each row's own."""
    rng = np.random.default_rng(sum(ns) + sum(ms))
    traj, cands, mask = batch_of(rng, ns, ms)
    order, nkept, cand4 = kernels.keep_lists(traj, cands, mask)
    got = kernels.nn_min_dist2(traj, cands, mask)
    assert torch.equal(got, kernels.nn_resident(traj, cands, mask))
    emulated = emulate_batched_nn_kernel(traj, cands, mask)
    np.testing.assert_array_equal(emulated, got.numpy())
    for r in range(len(ns)):
        o1, k1, c1 = kernels.keep_lists(traj[r], cands[r], mask[r])
        assert torch.equal(order[r], o1) and torch.equal(nkept[r], k1) and torch.equal(cand4[r], c1)
        assert torch.equal(got[r], kernels.nn_min_dist2_plain(traj[r], cands[r], mask[r]))
    assert torch.isinf(got[-1]).all()  # every candidate of the last row masked
    # K4's operands of the batch: each row's own, and ends each row's runs
    # after the rows before it (one work list over all rows).
    o, k, c, ends = kernels.nn_grid_operands(traj, cands, mask)
    assert torch.equal(o, order) and torch.equal(k, nkept) and torch.equal(c, cand4)
    assert ends.shape == nkept.shape and ends.dtype == torch.int32
    start = 0
    for r in range(len(ns)):
        e1 = kernels.nn_grid_operands(traj[r], cands[r], mask[r])[3]
        assert torch.equal(ends[r], e1 + start)
        start += int(e1[-1])


def emulate_batched_grid_kernel(traj, cands, mask):
    """K4's batch grid (csrc/nn_grid.cu) from flat device-memory images of
    its batched operands: block b finds its entry of ``ends`` by the
    kernel's binary search (the first entry above b, over every row's query
    tiles), takes the row and query tile of that entry and its run of at
    most RUN_TILES kept tiles, reads the row's slices at the kernel's
    offsets, and folds each query's minimum into an output prefilled with
    +inf by an atomicMin on the bit pattern (int64 views of non-negative
    float64 order like the values)."""
    B, n, _ = traj.shape
    order, nkept, cand4, ends = kernels.nn_grid_operands(traj, cands, mask)
    n_tiles, m_tiles = order.shape[1:]
    flat = {k: v.reshape(-1).numpy() for k, v in
            dict(traj=traj, cand=cand4, order=order, nkept=nkept, ends=ends).items()}
    e = flat["ends"]
    out = np.full(B * n, np.inf)
    bits = out.view(np.int64)
    tile_elems = 4 * kernels.TILE_M
    for b in range(int(e[-1])):
        lo, hi = 0, len(e) - 1
        while lo < hi:
            mid = (lo + hi) // 2
            lo, hi = (lo, mid) if e[mid] > b else (mid + 1, hi)
        k0 = (b - (e[lo - 1] if lo else 0)) * kernels.RUN_TILES
        row, i = divmod(lo, n_tiles)
        t = flat["traj"][3 * n * row:][: 3 * n].reshape(n, 3)
        c4 = flat["cand"][tile_elems * m_tiles * row:][: tile_elems * m_tiles].reshape(m_tiles, 4, -1)
        o = flat["order"][n_tiles * m_tiles * row:][: n_tiles * m_tiles].reshape(n_tiles, m_tiles)
        kept = flat["nkept"][n_tiles * row + i]
        assert k0 < kept  # no block without work
        q = t[i * kernels.TILE_N : (i + 1) * kernels.TILE_N]
        best = np.full(len(q), np.inf)
        for k in range(k0, min(kept, k0 + kernels.RUN_TILES)):
            blk = c4[o[i, k]]
            d = ((q[:, 0, None] - blk[0]) ** 2 + (q[:, 1, None] - blk[1]) ** 2
                 + (q[:, 2, None] - blk[2]) ** 2 + blk[3])
            best = np.fmin(best, d.min(1))
        at = n * row + i * kernels.TILE_N + np.arange(len(q))
        win = best < np.inf
        bits[at[win]] = np.minimum(bits[at[win]], best[win].view(np.int64))
    return out.reshape(B, n), nkept.numpy(), ends.numpy()


@pytest.mark.parametrize("ns,ms,shuffle", [((300, 150, 1, 300), (1500, 700, 1025, 9), False),
                                           ((130,) * 3, (2100, 3000, 40), False),
                                           ((700, 129, 260), (9000, 5000, 2048), True), ((5,), (1,), False)])
def test_batched_grid_work_list_gives_each_rows_minimum(ns, ms, shuffle):
    """K4's batch grid on ragged rows with an all-masked last row (and
    B = 1): equal to the plain minimum of each row alone bit for bit, and
    to K3's batch grid; with shuffled candidates every query tile's list
    spans several blocks, and the work list's runs are each row's own runs
    after the rows before it."""
    rng = np.random.default_rng(sum(ns) + sum(ms) + shuffle)
    traj, cands, mask = batch_of(rng, ns, ms)
    if shuffle:
        perm = torch.stack([torch.tensor(rng.permutation(cands.shape[1])) for _ in ns])
        cands = torch.gather(cands, 1, perm[..., None].expand(-1, -1, 3))
        mask = torch.gather(mask, 1, perm)
    got, nkept, ends = emulate_batched_grid_kernel(traj, cands, mask)
    np.testing.assert_array_equal(got, emulate_batched_nn_kernel(traj, cands, mask))  # K3's batch grid
    for r in range(len(ns)):
        np.testing.assert_array_equal(got[r], kernels.nn_min_dist2_plain(traj[r], cands[r], mask[r]).numpy())
    assert np.isinf(got[-1]).all()
    runs = -(-nkept // kernels.RUN_TILES)
    np.testing.assert_array_equal(ends, np.cumsum(runs).reshape(runs.shape))
    if shuffle:
        assert (runs[:-1].max(1) > 1).all()  # long lists spread over several blocks


def jax_vmap_pipelined_nn(traj, cands, mask, monkeypatch):
    """``jax.vmap`` of the JAX package's ``nn_min_dist2`` forced onto its
    pipelined ``_nn_kernel`` (the resident budget patched to 1024 bytes;
    the unjitted function, so no other test's trace is reused), in
    interpret mode."""
    monkeypatch.setattr(jpk, "_RESIDENT_BUDGET_BYTES", 1024)
    fn = jax.vmap(lambda a, b, c: jpk.nn_min_dist2.__wrapped__(a, b, c, interpret=True))
    return np.asarray(fn(jnp.asarray(traj), jnp.asarray(cands), jnp.asarray(mask))).astype(np.float64)


def test_batched_plain_nn_matches_jax_vmap_of_the_pipelined_kernel(monkeypatch):
    """The plain version, and the batched wrappers on CPU tensors, against
    the JAX package's vmapped pipelined kernel on 2 rows of 300 queries x
    3,000 candidates (3 candidate tiles), the second row ragged in its
    validity: ≤1e-6 relative (the JAX kernel computes in float32)."""
    rng = np.random.default_rng(33)
    traj = np.stack([walk(rng, 300), walk(rng, 300, offset=3.0)])
    cands = np.stack([walk(rng, 3000, offset=0.5), walk(rng, 3000, offset=2.5)])
    mask = rng.uniform(size=(2, 3000)) > 0.2
    mask[1, 2000:] = False
    want = jax_vmap_pipelined_nn(traj, cands, mask, monkeypatch)
    assert want.shape == (2, 300)
    t = [torch.tensor(a) for a in (traj, cands, mask)]
    for fn in (kernels.nn_min_dist2_plain, kernels.nn_min_dist2, kernels.nn_grid, kernels.nn_resident):
        np.testing.assert_allclose(fn(*t).numpy(), want, rtol=1e-6)


@pytest.mark.parametrize("grid_min,want", [(None, "nn_resident"), (1, "nn_grid")])
def test_batched_nn_calls_the_routed_wrapper(monkeypatch, grid_min, want):
    """``nn_min_dist2`` on a batch calls the wrapper ``nn_route`` names for
    all its rows' query tiles (here 3 x 1 tiles against 1,500 candidates:
    K3 by the card's thresholds, K4 with the candidate edge lowered)."""
    if grid_min is not None:
        monkeypatch.setattr(kernels, "GRID_MIN_CANDIDATES", grid_min)
    calls = []
    for name in ("nn_grid", "nn_resident"):
        real = getattr(kernels, name)
        monkeypatch.setattr(kernels, name, lambda *a, _n=name, _f=real: calls.append(_n) or _f(*a))
    rng = np.random.default_rng(4)
    traj, cands, mask = batch_of(rng, (100, 60, 128), (1500, 900, 300))
    assert kernels.nn_route(cands.shape[1], traj.shape[1], traj.shape[0]) == want[len("nn_"):]
    out = kernels.nn_min_dist2(traj, cands, mask)
    assert calls == [want] and out.shape == (3, 128)


def emulate_batched_keep_boxes(traj, cands, mask):
    """The keep-list kernel's box scratch for a batch: per row, at offset
    box_stride * row with box_stride = 6 (n_sub + m_sub + m_tiles), the
    query segments' boxes (6, n_sub), the candidate segments' (6, m_sub) and
    the candidate tiles' (6, m_tiles), lo then hi per axis, written by the
    segment-box step and read back through the same offsets; the keep step
    then runs the single-row order of work (``emulate_keep_kernel``'s
    passes) on each row's boxes."""
    tp, cp, vm = (x.numpy() for x in kernels.bounds_operands(traj, cands, mask))
    B = tp.shape[0]
    per_c = kernels.TILE_M // kernels.SUB
    n_sub, m_sub = tp.shape[1] // kernels.SUB, cp.shape[1] // kernels.SUB
    m_tiles = m_sub // per_c
    stride = 6 * (n_sub + m_sub + m_tiles)
    scratch = np.full(B * stride, np.nan)
    for y in range(B):
        tb = tp[y].reshape(n_sub, kernels.SUB, 3)
        cb, v = cp[y].reshape(m_sub, kernels.SUB, 3), vm[y].reshape(m_sub, kernels.SUB, 1)
        c_lo, c_hi = np.where(v, cb, np.inf).min(1), np.where(v, cb, -np.inf).max(1)
        boxes = [np.concatenate([tb.min(1), tb.max(1)], 1).T.ravel(),
                 np.concatenate([c_lo, c_hi], 1).T.ravel(),
                 np.concatenate([c_lo.reshape(m_tiles, per_c, 3).min(1),
                                 c_hi.reshape(m_tiles, per_c, 3).max(1)], 1).T.ravel()]
        scratch[stride * y : stride * (y + 1)] = np.concatenate(boxes)
    assert not np.isnan(scratch).any()
    rows = []
    for y in range(B):
        s = scratch[stride * y :]
        tbox = s[: 6 * n_sub].reshape(6, n_sub)
        cbox = s[6 * n_sub : 6 * (n_sub + m_sub)].reshape(6, m_sub)
        tilebox = s[6 * (n_sub + m_sub) : stride].reshape(6, m_tiles)
        rows.append((tbox, cbox, tilebox))
    return rows


def test_batched_keep_kernel_reads_its_rows_boxes():
    """Each row's boxes, written and read through the batch grid's offsets,
    are the row's own (the single-row emulation's operands), and the batched
    plain mask equals the single-row mask on every row."""
    rng = np.random.default_rng(3)
    traj, cands, mask = batch_of(rng, (700, 300, 130), (5000, 1025, 7))
    want = kernels.tile_keep_mask(*kernels.bounds_operands(traj, cands, mask))
    for y, (tbox, cbox, tilebox) in enumerate(emulate_batched_keep_boxes(traj, cands, mask)):
        tp, cp, vm = (x.numpy() for x in kernels.bounds_operands(traj[y], cands[y], mask[y]))
        tb = tp.reshape(-1, kernels.SUB, 3)
        np.testing.assert_array_equal(tbox, np.concatenate([tb.min(1), tb.max(1)], 1).T)
        cb, v = cp.reshape(-1, kernels.SUB, 3), vm.reshape(-1, kernels.SUB, 1)
        c_lo, c_hi = np.where(v, cb, np.inf).min(1), np.where(v, cb, -np.inf).max(1)
        np.testing.assert_array_equal(cbox, np.concatenate([c_lo, c_hi], 1).T)
        per_c = kernels.TILE_M // kernels.SUB
        np.testing.assert_array_equal(tilebox[:3].T, c_lo.reshape(-1, per_c, 3).min(1))
        single = kernels.tile_keep_mask(*kernels.bounds_operands(traj[y], cands[y], mask[y]))
        assert torch.equal(want[y], single)
        got, _ = emulate_keep_kernel(traj[y], cands[y], mask[y], Q=2, chunk=3)
        np.testing.assert_array_equal(got, single.numpy())


@pytest.mark.parametrize("n,T", [(700, 70), (279, 40)])
def test_batched_counts_equal_each_row_alone(n, T):
    """K5's batch grid (grid z the row): flat images of B rows of points and
    trials, each block reading its row's at offsets 3 n z (points), n z
    (mask), 9 T z, 3 T z, T z (trials) and T z (counts); the emulated counts
    equal the batched plain counts and each row's single-row counts
    exactly, with a row of no valid point."""
    rng = np.random.default_rng(n)
    rows = [sim3_trials(rng, n, T) for _ in range(3)]
    src, dst, valid, R, t, s = (np.stack(x) for x in zip(*rows))
    valid[1] = False
    got = kernels.ransac_counts(*[torch.tensor(a) for a in (src, dst, valid, R, t, s)], 16.0).numpy()
    assert got.shape == (3, T) and got.dtype == np.int32
    flat = [a.reshape(-1) for a in (src, dst, valid, R, t, s)]
    for z in range(3):
        fs, fd, fv, fR, ft, fsc = flat
        row = (fs[3 * n * z:][: 3 * n].reshape(n, 3), fd[3 * n * z:][: 3 * n].reshape(n, 3), fv[n * z:][:n],
               fR[9 * T * z:][: 9 * T].reshape(T, 3, 3), ft[3 * T * z:][: 3 * T].reshape(T, 3), fsc[T * z:][:T])
        np.testing.assert_array_equal(emulate_count_kernel(*row, 16.0), got[z])
        np.testing.assert_array_equal(
            kernels.ransac_counts_plain(*[torch.tensor(a) for a in row], 16.0).numpy(), got[z])
    assert (got[1] == 0).all()
