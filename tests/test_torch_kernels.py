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
counts, and the K3/K4 routing rule is held at its edges. The NN
emulations compute a pair's distance as the kernels do (csrc/nn_tile.cuh:
d0*d0, then two fused multiply-adds, each rounded once; ``fma`` emulates
the contraction exactly in NumPy) on the packed candidates (+inf
coordinates for a masked or padded one).

Tolerances: NN ≤1e-6 relative against the JAX kernel, which computes in
float32 (inputs are rounded to float32 first, so only the kernel's own
rounding remains); the emulated kernel walks equal the brute force with
the kernels' arithmetic (``kernel_min_dist2``) exactly, and the plain
version's, which rounds each square and sum, to 1e-14 relative; counts, and the emulated kernel's, exactly equal to JAX's
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


@pytest.mark.parametrize("n,m,shuffle", [(300, 1500, True), (130, 3000, False), (700, 9000, True), (5, 7, True)])
def test_sort_candidates_gives_the_jax_minima(n, m, shuffle):
    """``nn_min_dist2(sort_candidates=True)`` against the JAX package's
    option (its Morton sort, then its kernel in interpret mode): minima
    ≤1e-6 relative (the JAX kernel computes in float32), and equal to the
    unsorted port bit for bit. The sort itself: the port's keys of JAX's
    sorted candidates ascend (the same key function), the port's own sorted
    keys ascend, the sorted set is the input's, and shuffled candidates keep
    fewer tiles once sorted."""
    rng = np.random.default_rng(n + m)
    traj, cands = walk(rng, n), walk(rng, m, offset=0.5)
    if shuffle:
        cands = cands[rng.permutation(m)]
    mask = rng.uniform(size=m) > 0.2
    want = np.asarray(jpk.nn_min_dist2(jnp.asarray(traj), jnp.asarray(cands), jnp.asarray(mask), interpret=True,
                                       sort_candidates=True)).astype(np.float64)
    t, c, mk = (torch.tensor(a) for a in (traj, cands, mask))
    got = kernels.nn_min_dist2(t, c, mk, sort_candidates=True)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)
    assert torch.equal(got, kernels.nn_min_dist2(t, c, mk))
    jc, jv = jpk._morton_sort_candidates(jnp.asarray(cands), jnp.asarray(mask))
    jc, jv = torch.tensor(np.asarray(jc)), torch.tensor(np.asarray(jv))
    assert (torch.diff(kernels.morton_keys(jc, jv).long()) >= 0).all()
    sc, sm = kernels.morton_sort_candidates(c, mk)
    assert (torch.diff(kernels.morton_keys(sc, sm).long()) >= 0).all()
    assert torch.equal(sm, jv) and int(sm.sum()) == int(mask.sum())
    rows = lambda a: np.unique(a.numpy(), axis=0)  # noqa: E731
    np.testing.assert_array_equal(rows(sc[sm]), rows(c[mk]))
    if shuffle and m > 4 * kernels.TILE_M:
        assert kernels.keep_lists(t, sc, sm)[1].sum() < kernels.keep_lists(t, c, mk)[1].sum()


def test_batched_sort_candidates_sorts_each_row_by_its_own_box():
    """With a batch axis the sort takes each row's own box (one sort over
    the rows): each row equals the row sorted alone, and the batched minima
    equal JAX's option row by row (≤1e-6 relative) and the unsorted batch
    bit for bit."""
    rng = np.random.default_rng(17)
    traj, cands, mask = batch_of(rng, (300, 150, 64), (1500, 2100, 40), offset=0.0)
    cands = torch.stack([row[torch.tensor(rng.permutation(cands.shape[1]))] for row in cands])
    mask[2] = torch.tensor(rng.uniform(size=cands.shape[1]) > 0.5)
    sc, sm = kernels.morton_sort_candidates(cands, mask)
    for r in range(3):
        c1, m1 = kernels.morton_sort_candidates(cands[r], mask[r])
        assert torch.equal(sc[r], c1) and torch.equal(sm[r], m1)
    got = kernels.nn_min_dist2(traj, cands, mask, sort_candidates=True)
    assert torch.equal(got, kernels.nn_min_dist2(traj, cands, mask))
    for r in range(3):
        want = jpk.nn_min_dist2(jnp.asarray(traj[r].numpy()), jnp.asarray(cands[r].numpy()),
                                jnp.asarray(mask[r].numpy()), interpret=True, sort_candidates=True)
        np.testing.assert_allclose(got[r].numpy(), np.asarray(want).astype(np.float64), rtol=1e-6)


def _split(a):
    """Veltkamp's split of float64 ``a`` into hi + lo, 26 significant bits each."""
    c = 134217729.0 * a  # 2^27 + 1
    hi = c - (c - a)
    return hi, a - hi


def _two_prod(a, b):
    """(p, e): p = a*b rounded, p + e = a*b exactly (Dekker)."""
    p = a * b
    ah, al = _split(a)
    bh, bl = _split(b)
    return p, ((ah * bh - p) + ah * bl + al * bh) + al * bl


def _two_sum(a, b):
    """(s, e): s = a + b rounded, s + e = a + b exactly (Knuth)."""
    s = a + b
    bb = s - a
    return s, (a - (s - bb)) + (b - bb)


def fma(a, b, c):
    """a*b + c rounded once, in float64 (the card's ``__fma_rn``), by Boldo
    and Melquiond's emulation: the exact product (uh, ul), the exact sum
    (th, tl) of c and uh, tl + ul rounded to odd, then th + that rounded to
    nearest. Non-finite operands or results take a*b + c, which gives the
    same infinities and NaNs; a product in the subnormal range would break
    the exact transformations and raises."""
    a, b, c = np.broadcast_arrays(*(np.asarray(x, np.float64) for x in (a, b, c)))
    with np.errstate(invalid="ignore", over="ignore"):
        uh, ul = _two_prod(a, b)
        th, tl = _two_sum(c, uh)
        v, e = _two_sum(tl, ul)
        odd = (v.view(np.int64) & 1) == 1
        v = np.where((e != 0) & ~odd, np.nextafter(v, np.where(e > 0, np.inf, -np.inf)), v)
        z = th + v
        plain = a * b + c
    special = ~(np.isfinite(a) & np.isfinite(b) & np.isfinite(c) & np.isfinite(plain))
    tiny = (uh != 0) & (np.abs(uh) < 2.0**-960)
    assert not (tiny & ~special).any(), "a product in the subnormal range"
    return np.where(special, plain, z)


def kernel_d2(q, blk):
    """(len(q), blk.shape[1]) squared distances from the queries q (k, 3)
    to the packed candidates blk (3, w), as csrc/nn_tile.cuh's tile_min
    computes them: fma(d2, d2, fma(d1, d1, d0 * d0)), d = a - b."""
    d0, d1, d2 = (q[:, k, None] - blk[k][None] for k in range(3))
    return fma(d2, d2, fma(d1, d1, d0 * d0))


def kernel_min_dist2(traj, cands, mask):
    """The brute-force minimum with the kernels' arithmetic: each candidate
    packed as the kernels receive it (+inf coordinates where masked), each
    distance by ``kernel_d2``, a NaN never winning (+inf with no valid
    candidate); with a leading batch axis, each row against its own."""
    a, c, v = (np.asarray(x) for x in (traj, cands, mask))
    if a.ndim == 3:
        return np.stack([kernel_min_dist2(*row) for row in zip(a, c, v)])
    packed = np.where(v[:, None], c, np.inf).T
    return np.fmin.reduce(kernel_d2(a, packed), axis=1, initial=np.inf)


@pytest.mark.parametrize("scale", [1.0, 2.0**40, 2.0**-30])
def test_emulated_fma_rounds_once(scale):
    """``fma`` equals a*b + c rounded once from the exact rational value
    (Python's int division rounds correctly), on operands whose two
    roundings differ now and then, at several magnitudes; and keeps the
    infinities and NaNs of a*b + c."""
    from fractions import Fraction

    rng = np.random.default_rng(int(np.log2(scale)) + 64)
    a = rng.normal(size=4000) * scale
    b = a * (1 + rng.normal(size=4000) * 2.0**-20)
    c = np.abs(rng.normal(size=4000)) * scale * scale
    got = fma(a, b, c)
    want = np.array([float(Fraction(x) * Fraction(y) + Fraction(z)) for x, y, z in zip(a, b, c)])
    np.testing.assert_array_equal(got, want)
    assert (got != a * b + c).sum() > 10  # the emulation does round once where the plain form rounds twice
    inf, nan = np.inf, np.nan
    np.testing.assert_array_equal(fma([-inf, 2.0, nan, inf], [-inf, 3.0, 1.0, 0.0], [1.0, inf, 0.0, 1.0]),
                                  [inf, inf, nan, nan])


NN_THREADS = 256  # csrc/nn.cu kNnThreads
PER_THREAD = {16: 2, 32: 4, 64: 8}  # csrc/nn.cu: queries a thread for each block size


def emulate_kernel(traj, cands, mask, sub=None, per_thread=None, per_vector=2):
    """What csrc/nn.cu computes from the wrapper's operands, in NumPy, in
    its order of work: each 128-query tile is cut into blocks of ``sub``
    queries that share the tile's keep list; a block's 256 threads are
    ``sub / per_thread`` query lanes by slices, a thread holding
    ``per_thread`` queries and scanning every slices-th vector of
    ``per_vector`` candidates (16 bytes: 4 in float32, 2 in float64) of each
    kept tile; the slices' minima are folded at the end. A pair's distance
    is the kernel's (``kernel_d2``) on the packed tile's three rows, a
    NaN never winning. The block size is the wrapper's
    (``kernels.resident_block``) unless given. Blocks whose queries are all
    padding do nothing and padding queries are never written: the output
    starts as NaN and must come back without one. Returns (out, nkept,
    m_tiles)."""
    order, nkept, cand3 = (x.numpy() for x in kernels.keep_lists(traj, cands, mask))
    if sub is None:
        sub = kernels.resident_block(order.shape[0])
        per_thread = PER_THREAD[sub]
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
            blk = cand3[order[i, k]]  # (3, TILE_M): x, y, z, +inf where masked
            for sl in range(slices):
                best[sl] = np.fmin(best[sl], np.fmin.reduce(kernel_d2(q, blk[:, cols[sl]]), axis=1))
        rows = min(sub, n - q0)
        out[q0 : q0 + rows] = best.min(0)[:rows]
    assert not np.isnan(out).any()
    return out, nkept, order.shape[1]


# (queries a block, a thread, candidates a vector): every block size of
# csrc/nn.cu in both dtypes' vector widths
NN_BLOCKS = [(sub, PER_THREAD[sub], per_vector) for sub in kernels.RESIDENT_BLOCKS for per_vector in (2, 4)]


@pytest.mark.parametrize("sub,per_thread,per_vector", NN_BLOCKS)
@pytest.mark.parametrize("n,m,scale", [(2000, 3000, 1.0), (700, 2500, 5.0), (130, 1025, 0.3),
                                       (1131, 3000, 1.0), (5, 1, 1.0)])
def test_kernel_operands_give_the_exact_minimum(n, m, scale, sub, per_thread, per_vector):
    """Every block size of K3 and both vector widths, at a ragged last
    block (2000 = 15 tiles + 80; 1131 = 8 tiles + 107, its last block 11
    queries of 16 or more; 130 = one tile + 2) and at fewer queries than
    one block takes (5): the brute force with the kernels' arithmetic
    exactly, the plain version to its rounding."""
    rng = np.random.default_rng(m)
    traj = torch.tensor(walk(rng, n, scale))
    cands = torch.tensor(walk(rng, m, scale, offset=2.0))
    mask = torch.tensor(rng.uniform(size=m) > 0.1)
    got, nkept, m_tiles = emulate_kernel(traj, cands, mask, sub, per_thread, per_vector)
    np.testing.assert_array_equal(got, kernel_min_dist2(traj, cands, mask))
    want = kernels.nn_min_dist2_plain(traj, cands, mask).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-14)
    if n in (2000, 700):
        assert nkept.sum() < nkept.size * m_tiles  # the pruning did skip tiles
    none, _, _ = emulate_kernel(traj, cands, torch.zeros_like(mask), sub, per_thread, per_vector)
    assert np.isinf(none).all()  # every candidate masked: +inf, not NaN


@pytest.mark.parametrize("raw", [np.nan, np.inf, -np.inf])
def test_masked_non_finite_candidates_never_reach_the_minimum(raw):
    """Masked candidates with a NaN or infinite raw coordinate are packed
    as +inf, so K3's and K4's walks give what they gave when a validity row
    was added as a fourth term: each query's minimum over the valid
    candidates alone (never NaN), and +inf for a row with every candidate
    masked."""
    rng = np.random.default_rng(19)
    traj, c = torch.tensor(walk(rng, 300)), walk(rng, 2500, offset=1.0)
    mask = rng.uniform(size=2500) > 0.2
    dirty = np.flatnonzero(~mask)[::3]
    c[dirty, rng.integers(0, 3, size=len(dirty))] = raw
    cands, vm = torch.tensor(c), torch.tensor(mask)
    want = kernel_min_dist2(traj, c[mask], np.ones(mask.sum(), bool))
    assert np.isfinite(want).all()
    for got in (emulate_kernel(traj, cands, vm)[0], emulate_grid_kernel(traj, cands, vm)[0]):
        np.testing.assert_array_equal(got, want)
    _, _, cand3 = kernels.keep_lists(traj, cands, vm)
    assert not torch.isnan(cand3).any()
    for got in (emulate_kernel(traj, cands, torch.zeros_like(vm))[0],
                emulate_grid_kernel(traj, cands, torch.zeros_like(vm))[0]):
        assert np.isposinf(got).all()


def emulate_keep_packing(cands, mask, m_tiles):
    """The packed tiles as csrc/nn_keep.cu's segment_boxes_kernel writes
    them, from flat images of a row's candidates and mask: the block of
    candidate tile t, lane p of it, writes cand3[t * 3 * 1024 + d * 1024 +
    p % 1024] = cand[3 p + d] where the candidate is valid (p < m and
    mask[p] set) and +inf otherwise, for d = x, y, z."""
    flat, valid_of = np.asarray(cands).reshape(-1), np.asarray(mask)
    m = len(valid_of)
    out = np.full(m_tiles * 3 * kernels.TILE_M, np.nan)
    for p in range(m_tiles * kernels.TILE_M):
        valid = p < m and valid_of[p]
        for d in range(3):
            out[(p // kernels.TILE_M) * 3 * kernels.TILE_M + d * kernels.TILE_M + p % kernels.TILE_M] = (
                flat[3 * p + d] if valid else np.inf)
    return out.reshape(m_tiles, 3, kernels.TILE_M)


@pytest.mark.parametrize("m", [1, 1500, 2048])
def test_plain_packing_is_the_keep_kernels_contract(m):
    """``pack_candidates_plain`` (what ``keep_lists`` returns on the CPU)
    equals the keep-list kernel's packing, emulated by its address
    arithmetic, bit for bit: a valid candidate's raw coordinates, NaN ones
    included, and +inf in x, y and z for a masked or padded one; each row of
    a batch as that row alone."""
    rng = np.random.default_rng(m)
    c = walk(rng, m)
    mask = rng.uniform(size=m) > 0.3
    c[0, 1], c[-1, 0] = np.nan, -np.inf  # non-finite, valid or masked as drawn
    mask[0] = True
    m_tiles = -(-m // kernels.TILE_M)
    cands, vm = torch.tensor(c), torch.tensor(mask)
    got = kernels.pack_candidates_plain(cands, vm, m_tiles)
    assert got.shape == (m_tiles, 3, kernels.TILE_M) and got.dtype == torch.float64
    want = emulate_keep_packing(c, mask, m_tiles)
    np.testing.assert_array_equal(got.numpy().view(np.int64), want.view(np.int64))
    bits = got.view(torch.int64)
    assert torch.equal(kernels.keep_lists(torch.tensor(walk(rng, 5)), cands, vm)[2].view(torch.int64), bits)
    batch = kernels.pack_candidates_plain(torch.stack([cands, cands.flip(0)]), torch.stack([vm, vm.flip(0)]), m_tiles)
    assert torch.equal(batch[0].view(torch.int64), bits)
    np.testing.assert_array_equal(batch[1].numpy().view(np.int64),
                                  emulate_keep_packing(c[::-1], mask[::-1], m_tiles).view(np.int64))
    f32 = kernels.pack_candidates_plain(cands.float(), vm, m_tiles)
    np.testing.assert_array_equal(f32.numpy(), want.astype(np.float32))


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


COUNT_THREADS = {4: 256, 2: 128}  # csrc/ransac_counts.cu: a block's threads (the listed walk's at 4 points
#                                   a thread, kCountThreads; the grid's at 2, kGridThreads), 32 P points a warp
COUNT_MAX_GROUPS = 4  # csrc/ransac_counts.cu kMaxGroups: groups of 32 trials a block at most
BAND_SAFE = {np.float32: 2.0**60, np.float64: 2.0**500}  # csrc/ransac_counts.cu Band<T>::kSafe
BAND_UNIT = {np.float32: 2.0**-24, np.float64: 2.0**-53}
BAND_ETA = {np.float32: 2.0**-149, np.float64: 2.0**-1074}


def fma32(a, b, c):
    """a*b + c rounded once to float32 (the card's ``__fmaf_rn``): the
    product is exact in float64, the sum exact as a float64 pair (th, tl),
    rounded to odd in float64 and then to float32, which rounds correctly
    (53 >= 24 + 2 bits). Non-finite operands or results take a*b + c."""
    a, b, c = np.broadcast_arrays(*(np.asarray(x, np.float32) for x in (a, b, c)))
    a64, b64, c64 = (x.astype(np.float64) for x in (a, b, c))
    with np.errstate(invalid="ignore", over="ignore"):
        prod = a64 * b64
        th, tl = _two_sum(c64, prod)
        odd = (th.view(np.int64) & 1) == 1
        v = np.where((tl != 0) & ~odd, np.nextafter(th, np.where(tl > 0, np.inf, -np.inf)), th)
        z = v.astype(np.float32)
        plain = a * b + c
    special = ~(np.isfinite(a) & np.isfinite(b) & np.isfinite(c) & np.isfinite(plain))
    return np.where(special, plain, z)


def kernel_fma(a, b, c, dt):
    return fma32(a, b, c) if dt == np.float32 else fma(a, b, c)


def fast_res2(a, tt, p, d, dt):
    """K5's contracted residual (csrc/ransac_counts.cu): a = s R (9 values, one
    rounding), e_j = fma(a_j0, p0, fma(a_j1, p1, fma(a_j2, p2, t_j - d_j))),
    res2 = fma(e0, e0, fma(e1, e1, e2 * e2)); a (..., 9), tt (..., 3) broadcast
    against p, d (..., 3) in dtype ``dt``."""
    with np.errstate(invalid="ignore", over="ignore"):
        e = [kernel_fma(a[..., 3 * j], p[..., 0], kernel_fma(a[..., 3 * j + 1], p[..., 1], kernel_fma(
            a[..., 3 * j + 2], p[..., 2], (tt[..., j] - d[..., j]).astype(dt), dt), dt), dt) for j in range(3)]
        return kernel_fma(e[0], e[0], kernel_fma(e[1], e[1], (e[2] * e[2]).astype(dt), dt), dt)


def plain_res2(R, s, tt, p, d, dt):
    """The plain order (``kernels.sim3_residual2``), each operation rounded in
    ``dt``: R (..., 9), s (...), tt (..., 3) broadcast against p, d (..., 3)."""
    with np.errstate(invalid="ignore", over="ignore"):
        e = [(s * ((p[..., 0] * R[..., 3 * j] + p[..., 1] * R[..., 3 * j + 1]) + p[..., 2] * R[..., 3 * j + 2])
              + tt[..., j]) - d[..., j] for j in range(3)]
        return ((e[0] * e[0] + e[1] * e[1]) + e[2] * e[2]).astype(dt)


def count_band(R, s, tt, pmax, dmax, thr2, dt):
    """(lo, hi, unsafe) of csrc/ransac_counts.cu's band_roots and
    stage_trial for trials R (T, 9), s (T,), tt (T, 3) and a block's largest
    |p_k| and |d_j|: a pair with res2' < lo is a hit, one with res2' >= hi a
    miss; delta the 1-norm. Computed in float64 rounded to nearest and
    stepped one ulp outward after every operation, so at least as wide as
    the kernel's directed roundings; an unsafe trial and block (every pair
    recounted) gets (-inf, +inf)."""
    up = lambda x: np.nextafter(x, np.inf)  # noqa: E731
    dn = lambda x: np.nextafter(x, -np.inf)  # noqa: E731
    u, eta, safe_at = BAND_UNIT[dt], BAND_ETA[dt], BAND_SAFE[dt]
    g10, g3 = 10 * u * (1 + 2.0**-19), 3 * u * (1 + 2.0**-19)
    thr2 = float(dt(thr2))
    R, s, tt = (np.asarray(x, np.float64) for x in (R, s, tt))
    s_abs = np.abs(s)
    safe = np.full(len(s), 0 < thr2 < safe_at)
    delta = np.zeros(len(s))
    with np.errstate(invalid="ignore", over="ignore"):
        for j in range(3):
            q = np.zeros(len(s))
            for k in range(3):
                q = up(q + up(np.abs(R[:, 3 * j + k]) * float(pmax[k])))
            r_max = np.max(np.abs(R[:, 3 * j: 3 * j + 3]), 1)
            r_max = np.where(np.isnan(R[:, 3 * j: 3 * j + 3]).any(1), np.nan, r_max)
            m = up(up(up(s_abs * q) + np.abs(tt[:, j])) + float(dmax[j]))
            safe &= (m < safe_at) & (q < safe_at) & (up(s_abs * r_max) < safe_at)
            delta = up(delta + up(up(g10 * m) + 16 * eta))
        one_up, one_dn = up(1 + g3), dn(1 - g3)
        r_lo = dn(dn(np.sqrt(dn(dn(thr2 - 4 * eta) / one_up))) - delta)
        r_hi = up(up(np.sqrt(up(up(thr2 + 4 * eta) / one_dn))) + delta)
        lo = np.where(r_lo > 0, dn(dn(one_dn * dn(r_lo * r_lo)) - 4 * eta), -np.inf)
        hi = up(up(one_up * up(r_hi * r_hi)) + 4 * eta)
    lo, hi = np.where(safe, lo, -np.inf), np.where(safe, hi, np.inf)
    if dt == np.float32:  # rounded to float32 down and up
        lo32, hi32 = lo.astype(np.float32), hi.astype(np.float32)
        lo32 = np.where(lo32.astype(np.float64) > lo, np.nextafter(lo32, np.float32(-np.inf)), lo32)
        hi32 = np.where(hi32.astype(np.float64) < hi, np.nextafter(hi32, np.float32(np.inf)), hi32)
        return lo32, hi32, ~safe
    return lo, hi, ~safe


def emulate_count_kernel(src, dst, valid, R, t, s, thr2, per_thread=4, blocks=528, seed=0, stats=None):
    """What csrc/ransac_counts.cu computes, in NumPy, in its order of work,
    in the inputs' dtype (float32 or float64). At ``per_thread`` = 4, the
    listed walk: the list kernel's entries, one a chunk of 256 ``per_thread``
    points (256 threads) holding a valid point, in the order the atomics happen to give
    them (shuffled by ``seed``), and trial groups a block, the most (at most
    4) that leave an item for each of the launch's blocks (``blocks``
    resident, fewer when the items at one group are fewer). At 2, the grid
    of every chunk of 128 ``per_thread`` points (128 threads): an item a block, the groups chosen on the host from
    every chunk and ``blocks``, and a chunk with no valid point adding
    nothing. Items (entry, group of trials) run in any order; in each, the
    warps' runs of 32 ``per_thread`` points (a warp with
    no valid point skipping the walk, a masked point held as p = 0,
    d = -inf), the block's largest valid magnitudes, each trial's record
    (a = s R rounded once, t) and band (``count_band``), the contracted
    residual (``fast_res2``), its certified hits, and the plain order
    (``plain_res2``) for every pair the band leaves open; the block's partial
    counts added into a zeroed output. ``stats`` (a dict) receives the
    pairs computed and recounted."""
    dt = np.asarray(src).dtype.type
    src, dst, R, t, s = (np.asarray(x, dt) for x in (src, dst, R, t, s))
    valid = np.asarray(valid, bool)
    n, T = len(src), len(R)
    thr2_t = dt(thr2)
    chunk = COUNT_THREADS[per_thread] * per_thread
    chunks = -(-n // chunk)
    listed = {4: True, 2: False}[per_thread]
    entries = [c for c in range(chunks) if not listed or valid[c * chunk:(c + 1) * chunk].any()]
    rng = np.random.default_rng(seed)
    rng.shuffle(entries)
    groups_all = -(-T // 32)
    if listed:  # on the card, from the list's length and the launch's grid
        g = max(1, min(COUNT_MAX_GROUPS, len(entries) * groups_all // min(blocks, chunks * groups_all)))
    else:  # on the host, from every chunk and the resident blocks
        g = max(1, min(COUNT_MAX_GROUPS, chunks * groups_all // blocks))
    per_item = 32 * g
    tchunks = -(-T // per_item)
    items = [(e, k) for e in entries for k in range(tchunks)]
    rng.shuffle(items)
    out = np.zeros(T, np.int64)
    Rf = R.reshape(T, 9)
    computed = recounted = 0
    for c, k in items:
        t0 = k * per_item
        tc = min(per_item, T - t0)
        i = c * chunk + np.arange(chunk)
        ok = (i < n) & valid[np.minimum(i, n - 1)]
        if not ok.any():  # the grid's empty chunk: its block stops after its loads
            continue
        p = np.where(ok[:, None], src[np.minimum(i, n - 1)], dt(0))
        d = np.where(ok[:, None], dst[np.minimum(i, n - 1)], dt(-np.inf))
        warp_active = ok.reshape(-1, 32 * per_thread).any(1).repeat(32 * per_thread)
        pmax = np.abs(src[i[ok]]).max(0) if ok.any() else np.zeros(3, dt)
        dmax = np.abs(dst[i[ok]]).max(0) if ok.any() else np.zeros(3, dt)
        tr = slice(t0, t0 + tc)
        a = (s[tr, None] * Rf[tr]).astype(dt)
        lo, hi, unsafe = count_band(Rf[tr], s[tr], t[tr], pmax, dmax, thr2_t, dt)
        pa, da = p[None, warp_active], d[None, warp_active]
        q = fast_res2(a[:, None], t[tr, None], pa, da, dt)
        hit = q < lo[:, None]
        open_ = unsafe[:, None] | (~hit & (q < hi[:, None]))
        u_open, j_open = np.nonzero(open_)
        redo = plain_res2(Rf[tr][u_open], s[tr][u_open], t[tr][u_open], pa[0, j_open], da[0, j_open], dt)
        hit[u_open, j_open] = redo < thr2_t
        out[tr] += hit.sum(1)
        computed += q.size
        recounted += len(u_open)
    if stats is not None:
        stats.update(computed=computed, recounted=recounted)
    return out.astype(np.int32)


def window_mask(n, start, length):
    """A 180 s-style Sim(3) window: one contiguous run of valid points in a
    row that is masked elsewhere."""
    valid = np.zeros(n, bool)
    valid[start:start + length] = True
    return valid


def near_threshold(rng, n, T, dt, thr2=16.0):
    """Adversarial pairs: each dst is trial 0's prediction s R p + t plus
    sqrt(thr2) along a random direction, nudged by up to 4 ulps a
    coordinate, in ``dt``; the other trials are trial 0 with a translation
    moved by 1e-4, so most pairs' plain residual lies within a few ulps to a
    few parts in 1e4 of thr2."""
    src, _, valid, R, t, s = sim3_trials(rng, n, T)
    src = src.astype(dt)
    R, t, s = (np.repeat(x[:1], T, 0).astype(dt) for x in (R, t, s))
    t = np.concatenate([t[:1], (t[1:] + rng.normal(size=(T - 1, 3)) * 1e-4).astype(dt)])
    v = rng.normal(size=(n, 3))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    pred = s[0].astype(np.float64) * (src.astype(np.float64) @ R[0].astype(np.float64).T) + t[0]
    dst = (pred + np.sqrt(thr2) * v).astype(dt)
    for _ in range(4):
        k = rng.integers(-1, 2, size=(n, 3))
        dst = np.where(k > 0, np.nextafter(dst, dt(np.inf)), np.where(k < 0, np.nextafter(dst, dt(-np.inf)), dst))
    return src, dst, valid, R, t, s


def plain_counts(*args, thr2=16.0):
    return kernels.ransac_counts_plain(*[torch.tensor(a) for a in args], thr2).numpy()


@pytest.mark.parametrize("n,T,none_valid", [(1500, 300, False), (279, 1000, False), (5003, 333, False),
                                            (1, 1, False), (1500, 300, True)])
def test_emulated_count_kernel_equals_plain_and_jax_exact(n, T, none_valid):
    """Ragged point chunks (1500 = 1024 + 476, 279, 5003) and trial groups
    (300 = 9 x 32 + 12, 1000, 333), one point and one trial, and no valid
    point (an empty list: every count 0): on the listed walk and on the
    grid of every chunk, at 1 to 4 trial groups a block (the fill rule at
    528, 3 and 1 resident blocks), the partial counts sum to the plain
    counts exactly, and to JAX's exact form."""
    rng = np.random.default_rng(n + T)
    src, dst, valid, R, t, s = sim3_trials(rng, n, T)
    if none_valid:
        valid = np.zeros(n, bool)
    plain = plain_counts(src, dst, valid, R, t, s)
    np.testing.assert_array_equal(plain, jax_exact_counts(src, dst, valid, R, t, s, 16.0))
    if (n, T, none_valid) == (1500, 300, False):  # JAX's float32 quadratic-form kernel, re-ranked for it
        approx = np.asarray(jpk.ransac_counts(*(jnp.asarray(a) for a in (src, dst, valid, R, t, s)),
                                              thr2=16.0, interpret=True))
        assert np.abs(plain - approx).max() <= 2
    for per_thread, blocks in ((4, 528), (4, 3), (2, 528), (2, 1)):
        got = emulate_count_kernel(src, dst, valid, R, t, s, 16.0, per_thread, blocks, seed=T)
        np.testing.assert_array_equal(got, plain)
    if none_valid:
        assert (got == 0).all()
    elif n >= 279:
        assert 0 < got.max() < n  # the threshold cuts


@pytest.mark.parametrize("dt", [np.float32, np.float64])
def test_emulated_count_kernel_on_a_window_inside_a_long_masked_row(dt):
    """A 180 s-style window (1,800 contiguous valid points at 10 Hz, across
    chunk edges) inside a 20,000-point masked row, on both of K5's shapes:
    only the chunks that hold a valid point are listed (the grid's other
    blocks stop after their loads), the warps of their masked points skip,
    the pairs computed are within a warp's points at each edge of the valid
    ones, and the counts
    equal the plain ones (and, in float64, JAX's exact form), also with a
    window of one point at the row's very end."""
    rng = np.random.default_rng(11)
    n, T = 20_000, 70
    src, dst, _, R, t, s = (x.astype(dt) if x.dtype != bool else x for x in sim3_trials(rng, n, T))
    for start, length in ((7_777, 1_800), (n - 1, 1)):
        valid = window_mask(n, start, length)
        plain = plain_counts(src, dst, valid, R, t, s)
        for per_thread in (4, 2):  # the listed walk and the grid of every chunk
            stats = {}
            got = emulate_count_kernel(src, dst, valid, R, t, s, 16.0, per_thread, stats=stats)
            np.testing.assert_array_equal(got, plain)
            warp_points = 32 * per_thread  # a warp's points: a partial one at each edge
            assert length * T <= stats["computed"] <= (length + 2 * warp_points) * T
        if dt == np.float64:
            np.testing.assert_array_equal(got, jax_exact_counts(src, dst, valid, R, t, s, 16.0))
    for per_thread in (4, 2):
        assert (emulate_count_kernel(src, dst, np.zeros(n, bool), R, t, s, 16.0, per_thread) == 0).all()


@pytest.mark.parametrize("dt", [np.float32, np.float64])
def test_emulated_count_kernel_recounts_pairs_at_the_threshold(dt):
    """Adversarial pairs (``near_threshold``): many plain residuals within a
    few ulps of thr2, where the contracted residual rounds to the other
    side now and then; the band leaves them open, the plain order recounts
    them, and the counts equal the plain ones exactly."""
    rng = np.random.default_rng(12 if dt == np.float32 else 13)
    src, dst, valid, R, t, s = near_threshold(rng, 1500, 64, dt)
    stats = {}
    got = emulate_count_kernel(src, dst, valid, R, t, s, 16.0, stats=stats)
    plain = plain_counts(src, dst, valid, R, t, s)
    np.testing.assert_array_equal(got, plain)
    r2 = plain_res2(R.reshape(-1, 9)[:, None], s[:, None], t[:, None], src[None], dst[None], dt)
    fast = fast_res2((s[:, None] * R.reshape(-1, 9)).astype(dt)[:, None], t[:, None], src[None], dst[None], dt)
    ulp = np.spacing(dt(16.0))
    near = valid[None] & (np.abs(r2 - dt(16.0)) <= 4 * ulp)
    assert near.sum() > 50  # pairs within 4 ulps of thr2
    assert ((fast < 16.0) != (r2 < 16.0)).any()  # the contracted residual alone would miscount
    assert stats["recounted"] >= near.sum()


@pytest.mark.parametrize("dt", [np.float32, np.float64])
def test_emulated_count_kernel_recounts_unsafe_blocks(dt):
    """Where the band's bound does not hold (a valid point with a NaN or an
    infinite coordinate in its block, a trial with an infinite translation
    or a scale past 2^60 in float32, 2^500 in float64),
    the trial and block are flagged unsafe and every pair is recounted in
    the plain order: the counts equal the plain ones, NaNs and infinities
    never counting as hits."""
    rng = np.random.default_rng(14)
    n, T = 1500, 40
    src, dst, valid, R, t, s = (x.astype(dt) if x.dtype != bool else x for x in sim3_trials(rng, n, T))
    src[3, 1], dst[700, 2], src[1400, 0] = np.nan, np.inf, -np.inf  # in three chunks of 128 x 2 points
    valid[[3, 700, 1400]] = True
    t[5, 0], s[6], s[7] = np.inf, dt(2.0**61 if dt == np.float32 else 2.0**501), dt(np.nan)
    stats = {}
    got = emulate_count_kernel(src, dst, valid, R, t, s, 16.0, per_thread=2, stats=stats)
    np.testing.assert_array_equal(got, plain_counts(src, dst, valid, R, t, s))
    assert stats["recounted"] >= 3 * 256 * T  # the poisoned blocks, every trial
    _, _, unsafe = count_band(R.reshape(T, 9), s, t, np.abs(src[256:512]).max(0), np.abs(dst[256:512]).max(0),
                              16.0, dt)
    assert unsafe[[5, 6, 7]].all() and not unsafe[:5].any()


def _exact(x):
    from fractions import Fraction

    return np.vectorize(Fraction, otypes=[object])(np.asarray(x, np.float64))


@pytest.mark.parametrize("dt", [np.float32, np.float64])
@pytest.mark.parametrize("kind", ["random", "adversarial"])
def test_count_band_covers_fast_against_plain(dt, kind):
    """The band's derivation (csrc/ransac_counts.cu), in exact rationals on
    random and adversarial pairs: |e'_j - e_j| <= gamma_10 M_j + 16 eta for
    each coordinate (M_j from the pair's own magnitudes, which the block's
    bound), each rounded sum of squares within (1 +- gamma_3) S +- 4 eta of
    its exact S, and every pair the band decides decided as the plain order
    decides it: res2' < lo gives plain < thr2, res2' >= hi gives plain >= thr2."""
    from fractions import Fraction

    rng = np.random.default_rng(21 if kind == "random" else 22)
    n, T = 60, 12
    if kind == "random":
        src, dst, valid, R, t, s = (x.astype(dt) if x.dtype != bool else x for x in sim3_trials(rng, n, T))
    else:
        src, dst, valid, R, t, s = near_threshold(rng, n, T, dt)
    Rf = R.reshape(T, 9)
    u, eta = Fraction(BAND_UNIT[dt]), Fraction(BAND_ETA[dt])
    g10, g3 = 10 * u / (1 - 10 * u), 3 * u / (1 - 3 * u)
    a = (s[:, None] * Rf).astype(dt)
    lo, hi, unsafe = count_band(Rf, s, t, np.abs(src).max(0), np.abs(dst).max(0), 16.0, dt)
    assert not unsafe.any()
    fast = fast_res2(a[:, None], t[:, None], src[None], dst[None], dt)
    plain = plain_res2(Rf[:, None], s[:, None], t[:, None], src[None], dst[None], dt)
    thr = Fraction(float(dt(16.0)))
    decided = 0
    for k in range(T):
        Rk, sk, tk, ak = (_exact(x) for x in (Rf[k], s[k], t[k], a[k]))
        for i in range(n):
            p, d = _exact(src[i]), _exact(dst[i])
            # The roundings of each order, step by step, as the emulations take them.
            pe = [(sk * ((p[0] * Rk[3 * j] + p[1] * Rk[3 * j + 1]) + p[2] * Rk[3 * j + 2]) + tk[j]) - d[j]
                  for j in range(3)]
            e_plain = [Fraction(float(v)) for v in plain_e(Rf[k], s[k], t[k], src[i], dst[i], dt)]
            e_fast = [Fraction(float(v)) for v in fast_e(a[k], t[k], src[i], dst[i], dt)]
            for j in range(3):
                m = abs(sk) * sum(abs(Rk[3 * j + c]) * abs(p[c]) for c in range(3)) + abs(tk[j]) + abs(d[j])
                assert abs(e_fast[j] - e_plain[j]) <= g10 * m + 16 * eta
                assert abs(e_plain[j] - pe[j]) <= 6 * u / (1 - 6 * u) * m + 8 * eta
            for e, r2 in ((e_plain, plain[k, i]), (e_fast, fast[k, i])):
                S = sum(x * x for x in e)
                assert (1 - g3) * S - 4 * eta <= Fraction(float(r2)) <= (1 + g3) * S + 4 * eta
            if fast[k, i] < lo[k]:
                assert Fraction(float(plain[k, i])) < thr
                decided += 1
            elif fast[k, i] >= hi[k]:
                assert Fraction(float(plain[k, i])) >= thr
                decided += 1
    if kind == "random":
        assert decided >= 0.9 * n * T  # the band decides almost every pair
    else:
        assert decided < n * T  # and leaves the adversarial ones near thr2 open


def plain_e(R, s, tt, p, d, dt):
    """The plain order's three residual coordinates of one pair, in ``dt``."""
    return [dt(dt(dt(s * dt(dt(dt(p[0] * R[3 * j]) + dt(p[1] * R[3 * j + 1])) + dt(p[2] * R[3 * j + 2])))
                     + tt[j]) - d[j]) for j in range(3)]


def fast_e(a, tt, p, d, dt):
    """The contracted residual's three coordinates of one pair, in ``dt``."""
    return [kernel_fma(a[3 * j], p[0], kernel_fma(a[3 * j + 1], p[1], kernel_fma(
        a[3 * j + 2], p[2], dt(tt[j] - d[j]), dt), dt), dt)[()] for j in range(3)]


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
    order, nkept, cand3, ends = (x.numpy() for x in kernels.nn_grid_operands(traj, cands, mask))
    a = traj.numpy()
    out = np.full(len(a), np.inf)
    for b in range(int(ends[-1])):
        i = int(np.searchsorted(ends, b, side="right"))
        k0 = (b - (ends[i - 1] if i else 0)) * kernels.RUN_TILES
        rows = slice(i * kernels.TILE_N, min(len(a), (i + 1) * kernels.TILE_N))
        q = a[rows]
        for k in range(k0, min(nkept[i], k0 + kernels.RUN_TILES)):
            blk = cand3[order[i, k]]  # (3, TILE_M), +inf where masked
            out[rows] = np.fmin(out[rows], np.fmin.reduce(kernel_d2(q, blk), axis=1))
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
    np.testing.assert_array_equal(got, kernel_min_dist2(traj, cands, mask))
    np.testing.assert_allclose(got, kernels.nn_min_dist2_plain(traj, cands, mask).numpy(), rtol=1e-14)
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
# The kernel cannot run here, so its three-level pruning is emulated in
# NumPy with the plain version's float64 expressions, on the boxes its first
# two steps write (segments, tiles of 32 segments, groups of 32 tiles), one
# query tile at a time as a warp (or ``split`` warps) takes it: thr seeded
# with the groups' upper bounds (none at one group); pass A visiting the
# warp's groups nearest first while one may lower thr (lb < thr, strictly),
# folding a visited group's tile upper bounds, then the segments of up to
# ``batch`` of its tiles that may still lower thr at once (the lowest
# first) and testing the tiles again; with several warps a query tile, each
# taking the groups g = j mod split and folding its thr into the shared one
# after each group in an order drawn at random (the warps race); pass B
# against the slackened bound (lb <= bound), groups and tiles ascending,
# a word of kept tiles a group written out by the prefix of its bits, the
# tile bounds of pass A's last group reused, and every tile listed without
# a box read once a bound is +inf. The lists must equal those of
# ``kernels.tile_keep_mask`` bit for bit: that is what proves the pruning
# exact where no card is.


def _sq3(v):
    return (v[..., 0] * v[..., 0] + v[..., 1] * v[..., 1]) + v[..., 2] * v[..., 2]


def _lb(qlo, qhi, clo, chi):
    return _sq3(np.maximum(np.maximum(qlo - chi, clo - qhi), 0.0))


def _ub(qlo, qhi, clo, chi):
    return _sq3(np.maximum(qhi - clo, chi - qlo))


def _outer_box(lo, hi, per):
    """The boxes of consecutive runs of ``per`` boxes (the last run padded
    with empty boxes): (lo, hi), each (count / per, 3)."""
    pad = -len(lo) % per
    lo = np.concatenate([lo, np.full((pad, 3), np.inf)]).reshape(-1, per, 3).min(1)
    hi = np.concatenate([hi, np.full((pad, 3), -np.inf)]).reshape(-1, per, 3).max(1)
    return lo, hi


def keep_boxes(traj, cands, mask):
    """The boxes the kernel's first two steps write for one row: query and
    candidate segments, candidate tiles and groups, each (lo, hi) of
    (count, 3) float64 (an empty box is +inf / -inf)."""
    tp, cp, vm = (x.numpy() for x in kernels.bounds_operands(traj, cands, mask))
    tb = tp.reshape(-1, kernels.SUB, 3)
    cb, v = cp.reshape(-1, kernels.SUB, 3), vm.reshape(-1, kernels.SUB, 1)
    seg = (np.where(v, cb, np.inf).min(1), np.where(v, cb, -np.inf).max(1))
    tile = _outer_box(*seg, kernels.TILE_M // kernels.SUB)
    return {"query": (tb.min(1), tb.max(1)), "seg": seg, "tile": tile,
            "group": _outer_box(*tile, kernels.GROUP_TILES)}


def emulate_keep_walk(boxes, split=1, batch=2, seed=0):
    """(keep mask, segment boxes read) of the kernel's order of work on one
    row's ``boxes`` (``keep_boxes``), with ``split`` warps a query tile and
    ``batch`` tiles' segments read at once."""
    per_q, per_c, per_g = kernels.TILE_N // kernels.SUB, kernels.TILE_M // kernels.SUB, kernels.GROUP_TILES
    t_lo, t_hi = boxes["query"]
    c_lo, c_hi = boxes["seg"]
    tile_lo, tile_hi = boxes["tile"]
    g_lo, g_hi = boxes["group"]
    n_tiles, m_tiles, groups = len(t_lo) // per_q, len(tile_lo), len(g_lo)
    rng = np.random.default_rng(seed)
    keep = np.zeros((n_tiles, m_tiles), bool)
    read = 0

    def tile_bounds(q, g, bound_fn):
        t = np.arange(g * per_g, (g + 1) * per_g)
        lo = np.where(t[:, None] < m_tiles, tile_lo[np.minimum(t, m_tiles - 1)], np.inf)
        hi = np.where(t[:, None] < m_tiles, tile_hi[np.minimum(t, m_tiles - 1)], -np.inf)
        return bound_fn(q[0], q[1], lo[None], hi[None])  # (per_q, 32): a lane a tile

    def segment_bounds(q, g, lane, bound_fn):
        nonlocal read
        read += per_c
        s = slice((g * per_g + lane) * per_c, (g * per_g + lane + 1) * per_c)
        return bound_fn(q[0], q[1], c_lo[s][None], c_hi[s][None])  # (per_q, 32): a lane a segment

    def group_lb(q, g):
        return np.zeros(per_q) if groups == 1 else _lb(q[0][:, 0], q[1][:, 0], g_lo[g], g_hi[g])

    def pass_a(q, part, seed_thr, shared, state):
        thr = seed_thr.copy()
        for g0 in range(0, groups, 32):
            mine = [g for g in range(g0, min(g0 + 32, groups)) if g % split == part]
            lbg = {g: group_lb(q, g) for g in mine}
            done = set()
            while True:
                cand = [g for g in mine if g not in done and (lbg[g] < thr).any()]
                if not cand:
                    break
                pick = min(cand, key=lambda g: (lbg[g].min(), g))  # nearest; the lowest lane of a tie
                done.add(pick)
                lbt = tile_bounds(q, pick, _lb)
                thr = np.minimum(thr, tile_bounds(q, pick, _ub).min(1))
                state.update(cached=pick, lbt=lbt)
                seen = set()
                while True:
                    near = [t for t in range(per_g) if t not in seen and (lbt[:, t] < thr).any()]
                    if not near:
                        break
                    seen.update(near[:batch])
                    best = np.stack([segment_bounds(q, pick, t, _ub).min(1) for t in near[:batch]]).min(0)
                    thr = np.minimum(thr, best)
                if split > 1:  # atomicMin on the shared thr, which returns what it held
                    old = shared.copy()
                    shared[:] = np.minimum(shared, thr)
                    thr = np.minimum(thr, old)
                yield
        shared[:] = np.minimum(shared, thr)

    for i in range(n_tiles):
        q = (t_lo[i * per_q : (i + 1) * per_q][:, None], t_hi[i * per_q : (i + 1) * per_q][:, None])
        seed_thr = np.full(per_q, np.inf)
        if groups > 1:
            seed_thr = _ub(q[0], q[1], g_lo[None], g_hi[None]).min(1)
        shared = seed_thr.copy() if split > 1 else np.full(per_q, np.inf)
        states = [{"cached": -1} for _ in range(split)]
        running = [pass_a(q, j, seed_thr, shared, states[j]) for j in range(split)]
        while running:  # the warps' group visits, interleaved at random
            k = int(rng.integers(len(running)))
            try:
                next(running[k])
            except StopIteration:
                running.pop(k)
        thr = shared
        bound = thr + 1e-5 * (thr + 1.0)
        if np.isinf(bound).any():  # every segment passes for that query segment
            keep[i] = True
            continue
        words = {}
        for part, state in enumerate(states):
            for g in range(part, groups, split):
                if not (group_lb(q, g) <= bound).any():
                    words[g] = 0
                    continue
                lbt = state["lbt"] if g == state["cached"] else tile_bounds(q, g, _lb)
                near = [t for t in range(per_g) if (lbt[:, t] <= bound).any()]
                word = 0
                for b in range(0, len(near), batch):
                    for t in near[b : b + batch]:
                        if (segment_bounds(q, g, t, _lb) <= bound[:, None]).any():
                            word |= 1 << t
                words[g] = word
        out, kept = np.full(m_tiles, -1), 0
        for g in range(groups):  # a lane a word: its bits at the prefix of the counts before it
            for t in range(per_g):
                if words[g] >> t & 1:
                    out[kept + bin(words[g] & ((1 << t) - 1)).count("1")] = g * per_g + t
            kept += bin(words[g]).count("1")
        assert (np.diff(out[:kept]) > 0).all()  # ascending
        keep[i, out[:kept]] = True
    return keep, read


def emulate_keep_kernel(traj, cands, mask, split=1, batch=2, seed=0):
    """(keep mask, segment boxes read) of the kernel on one row's operands."""
    return emulate_keep_walk(keep_boxes(traj, cands, mask), split, batch, seed)


def track(rng, n, offset, kind):
    """float64 points: a drive (steady motion plus a random walk, the main
    path's kind of track) or uniform scatter, in a local frame or at UTM
    magnitudes."""
    if kind == "walk":
        return np.cumsum(rng.normal(size=(n, 3)) * 0.3 + np.array([0.8, 0.1, 0.0]), axis=0) + offset
    return rng.uniform(-40.0, 40.0, size=(n, 3)) + offset


KEEP_MASKS = ("random", "all-masked", "part-masked", "group-masked")
GROUP_M = kernels.GROUP_TILES * kernels.TILE_M  # candidates a group


@pytest.mark.parametrize("split,batch", [(1, 2), (2, 3), (8, 2)])
@pytest.mark.parametrize("masking", KEEP_MASKS)
@pytest.mark.parametrize("offset", [0.0, 5.4e6])
@pytest.mark.parametrize("kind,n,m", [("walk", 1500, 5000), ("walk", 700, 1025), ("walk", 130, 7),
                                      ("scatter", 900, 5000), ("walk", 700, 70_000), ("scatter", 300, 40_000),
                                      ("walk", 200, 1_100_000)])
def test_emulated_keep_kernel_equals_plain_mask(kind, n, m, offset, masking, split, batch):
    """Both regimes: rows of one group (m_tiles <= 32: a warp a query tile,
    a lane a tile), of two or three groups with a partial last one (40
    and 69 tiles) and of 34 groups (1,075 tiles: two chunks of 32 groups'
    lanes), every mask kind (a whole first group masked, which at one
    group is every candidate), one, two and eight warps a query tile."""
    rng = np.random.default_rng(n + m + split)
    traj, cands = track(rng, n, offset, kind), track(rng, m, offset + 0.3, kind)
    mask = rng.uniform(size=m) > 0.1
    if masking == "all-masked":
        mask = np.zeros(m, bool)
    elif masking == "part-masked":  # whole tiles and runs of segments masked out, one tile left with a single fix
        mask[: min(m, kernels.TILE_M)] = False
        mask[min(m - 1, 3)] = True
        mask[m // 2 : m // 2 + 3 * kernels.SUB] = False
    elif masking == "group-masked":
        mask[:GROUP_M] = False
    args = [torch.tensor(a) for a in (traj, cands, mask)]
    want = kernels.tile_keep_mask(*kernels.bounds_operands(*args)).numpy()
    got, read = emulate_keep_kernel(*args, split, batch, seed=n + split)
    np.testing.assert_array_equal(got, want)
    n_tiles, m_tiles = want.shape
    assert (m_tiles > kernels.GROUP_TILES) == (m > GROUP_M)
    if masking == "all-masked" or (masking == "group-masked" and m <= GROUP_M):
        assert want.all() and read == 0  # no finite upper bound: every tile kept, no box read
    elif kind == "walk" and masking == "random" and m >= 5000:
        # The levels bite: under half of the first version's two reads of
        # every segment box per query tile.
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
    (traj + 3 n y, cand + 3072 m_tiles y, order + n_tiles m_tiles y,
    nkept + n_tiles y, out + n y) and does the single-row tile's work."""
    B, n, _ = traj.shape
    order, nkept, cand3 = kernels.keep_lists(traj, cands, mask)
    n_tiles, m_tiles = order.shape[1:]
    flat = {k: v.reshape(-1).numpy() for k, v in
            dict(traj=traj, cand=cand3, order=order, nkept=nkept).items()}
    out = np.full(B * n, np.nan)
    for y in range(B):
        t = flat["traj"][3 * n * y : 3 * n * (y + 1)].reshape(n, 3)
        c3 = flat["cand"][3 * kernels.TILE_M * m_tiles * y:][: 3 * kernels.TILE_M * m_tiles]
        o = flat["order"][n_tiles * m_tiles * y:][: n_tiles * m_tiles].reshape(n_tiles, m_tiles)
        k = flat["nkept"][n_tiles * y:][:n_tiles]
        for i in range(n_tiles):
            q = t[i * kernels.TILE_N : (i + 1) * kernels.TILE_N]
            best = np.full(len(q), np.inf)
            for kk in range(k[i]):
                blk = c3.reshape(m_tiles, 3, kernels.TILE_M)[o[i, kk]]
                best = np.fmin(best, np.fmin.reduce(kernel_d2(q, blk), axis=1))
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
    order, nkept, cand3 = kernels.keep_lists(traj, cands, mask)
    got = kernels.nn_min_dist2(traj, cands, mask)
    assert torch.equal(got, kernels.nn_resident(traj, cands, mask))
    emulated = emulate_batched_nn_kernel(traj, cands, mask)
    np.testing.assert_array_equal(emulated, kernel_min_dist2(traj, cands, mask))
    np.testing.assert_allclose(emulated, got.numpy(), rtol=1e-14)
    for r in range(len(ns)):
        o1, k1, c1 = kernels.keep_lists(traj[r], cands[r], mask[r])
        assert torch.equal(order[r], o1) and torch.equal(nkept[r], k1) and torch.equal(cand3[r], c1)
        assert torch.equal(got[r], kernels.nn_min_dist2_plain(traj[r], cands[r], mask[r]))
    assert torch.isinf(got[-1]).all()  # every candidate of the last row masked
    # K4's operands of the batch: each row's own, and ends each row's runs
    # after the rows before it (one work list over all rows).
    o, k, c, ends = kernels.nn_grid_operands(traj, cands, mask)
    assert torch.equal(o, order) and torch.equal(k, nkept) and torch.equal(c, cand3)
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
    order, nkept, cand3, ends = kernels.nn_grid_operands(traj, cands, mask)
    n_tiles, m_tiles = order.shape[1:]
    flat = {k: v.reshape(-1).numpy() for k, v in
            dict(traj=traj, cand=cand3, order=order, nkept=nkept, ends=ends).items()}
    e = flat["ends"]
    out = np.full(B * n, np.inf)
    bits = out.view(np.int64)
    tile_elems = 3 * kernels.TILE_M
    for b in range(int(e[-1])):
        lo, hi = 0, len(e) - 1
        while lo < hi:
            mid = (lo + hi) // 2
            lo, hi = (lo, mid) if e[mid] > b else (mid + 1, hi)
        k0 = (b - (e[lo - 1] if lo else 0)) * kernels.RUN_TILES
        row, i = divmod(lo, n_tiles)
        t = flat["traj"][3 * n * row:][: 3 * n].reshape(n, 3)
        c3 = flat["cand"][tile_elems * m_tiles * row:][: tile_elems * m_tiles].reshape(m_tiles, 3, -1)
        o = flat["order"][n_tiles * m_tiles * row:][: n_tiles * m_tiles].reshape(n_tiles, m_tiles)
        kept = flat["nkept"][n_tiles * row + i]
        assert k0 < kept  # no block without work
        q = t[i * kernels.TILE_N : (i + 1) * kernels.TILE_N]
        best = np.full(len(q), np.inf)
        for k in range(k0, min(kept, k0 + kernels.RUN_TILES)):
            best = np.fmin(best, np.fmin.reduce(kernel_d2(q, c3[o[i, k]]), axis=1))
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
        np.testing.assert_array_equal(got[r], kernel_min_dist2(traj[r], cands[r], mask[r]))
        np.testing.assert_allclose(got[r], kernels.nn_min_dist2_plain(traj[r], cands[r], mask[r]).numpy(),
                                   rtol=1e-14)
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
    box_stride * row with box_stride = 6 (n_sub + m_sub + m_tiles + groups),
    the query segments' boxes (6, n_sub), the candidate segments' (6,
    m_sub), the candidate tiles' (6, m_tiles) and the groups' (6, groups),
    lo then hi per axis, written by the box steps into one flat buffer and
    read back through the same offsets, as ``keep_boxes`` dicts (the keep
    step's operands)."""
    B = traj.shape[0]
    rows = [keep_boxes(traj[y], cands[y], mask[y]) for y in range(B)]
    names = ("query", "seg", "tile", "group")
    counts = [len(rows[0][k][0]) for k in names]
    per_c, m_tiles = kernels.TILE_M // kernels.SUB, counts[2]
    assert counts[1] == per_c * m_tiles and counts[3] == -(-m_tiles // kernels.GROUP_TILES)
    stride = 6 * sum(counts)
    scratch = np.full(B * stride, np.nan)
    for y, row in enumerate(rows):
        scratch[stride * y : stride * (y + 1)] = np.concatenate(
            [np.concatenate(row[k], 1).T.ravel() for k in names])
    assert not np.isnan(scratch).any()
    out = []
    for y in range(B):
        s, at, row = scratch[stride * y :], 0, {}
        for k, c in zip(names, counts):
            box = s[at : at + 6 * c].reshape(6, c)
            row[k] = (box[:3].T, box[3:].T)
            at += 6 * c
        out.append(row)
    return out


@pytest.mark.parametrize("ms,split", [((5000, 1025, 7), 1), ((40_000, 33_000, 7), 1), ((40_000, 33_000, 7), 2)])
def test_batched_keep_kernel_reads_its_rows_boxes(ms, split):
    """Each row's boxes, written and read through the batch grid's offsets,
    are the row's own (segments, tiles, and groups where a row has two or
    more), the kernel's walk on them gives the row's plain mask, and the
    batched plain mask equals the single-row mask on every row."""
    rng = np.random.default_rng(3)
    traj, cands, mask = batch_of(rng, (700, 300, 130), ms)
    want = kernels.tile_keep_mask(*kernels.bounds_operands(traj, cands, mask))
    for y, boxes in enumerate(emulate_batched_keep_boxes(traj, cands, mask)):
        tp, cp, vm = (x.numpy() for x in kernels.bounds_operands(traj[y], cands[y], mask[y]))
        tb = tp.reshape(-1, kernels.SUB, 3)
        np.testing.assert_array_equal(boxes["query"][0], tb.min(1))
        np.testing.assert_array_equal(boxes["query"][1], tb.max(1))
        cb, v = cp.reshape(-1, kernels.SUB, 3), vm.reshape(-1, kernels.SUB, 1)
        c_lo, c_hi = np.where(v, cb, np.inf).min(1), np.where(v, cb, -np.inf).max(1)
        np.testing.assert_array_equal(boxes["seg"][0], c_lo)
        np.testing.assert_array_equal(boxes["seg"][1], c_hi)
        per_c = kernels.TILE_M // kernels.SUB
        np.testing.assert_array_equal(boxes["tile"][0], c_lo.reshape(-1, per_c, 3).min(1))
        tiles = len(boxes["tile"][0])
        for g in range(len(boxes["group"][0])):
            t = slice(g * kernels.GROUP_TILES, (g + 1) * kernels.GROUP_TILES)
            np.testing.assert_array_equal(boxes["group"][1][g], boxes["tile"][1][t].max(0))
        assert len(boxes["group"][0]) == -(-tiles // kernels.GROUP_TILES)
        single = kernels.tile_keep_mask(*kernels.bounds_operands(traj[y], cands[y], mask[y]))
        assert torch.equal(want[y], single)
        got, _ = emulate_keep_walk(boxes, split=split, seed=y)
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
