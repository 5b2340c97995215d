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
    """The port's own rule at its edges: K3 below ``GRID_MIN_CANDIDATES``,
    K4 from there on, whatever the padding; the in-core path's sizes take
    K3 and the chunked evaluation's 524,288-candidate blocks K4."""
    edge = kernels.GRID_MIN_CANDIDATES
    assert edge == 524_288
    for m in (0, 1, 1024, 4661, 262_144, 262_145, 300_000, edge - 1):
        assert kernels.nn_route(m) == "resident", m
    for m in (edge, edge + 1, 1_048_576):
        assert kernels.nn_route(m) == "grid", m
    # Where the JAX package's rule sat (its resident kernel's 8 MiB VMEM
    # budget): the change above 262,144 candidates, half the port's edge.
    jax_last = jpk._RESIDENT_BUDGET_BYTES // (jpk._PAD_DIM * 4)
    assert jax_last == 262_144 and kernels.nn_route(jax_last + 1) == "resident"


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
