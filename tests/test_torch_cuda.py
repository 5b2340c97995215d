"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA device and skips without one. The file imports
no JAX (the machine with the card has none), so it runs there without the
suite's conftest:

    python -m pytest --noconftest -q tests/test_torch_cuda.py

Tolerances: relative to (max |plain| + 1) per leaf, 1e-4 in float32 and
1e-10 in float64 (the kernels associate or sum in another order; K2 is
also held to K1 on the same input); NN 1e-5 / 1e-12 relative, and K4 equal
to K3 bit for bit (the same pairs, the same arithmetic: both scan a tile
with csrc/nn_tile.cuh); counts equal to the plain version's (the same
elementwise order, uncontracted) and from run to run, the re-ranked winner
identical; seq-04 on the card within 1e-6 m of the golden trajectory; the
robust fusion, the ground-truth evaluation and the device offset estimator
on the card against the same functions on CPU tensors: accept masks equal,
positions ≤1e-6 m, statistics ≤1e-9 relative, offsets ≤1e-9 s; robust
chunked against in-core on the card ≤1e-6 m, quaternions ≤1e-8, the
bounds of the JAX package's own chunked tests; the chunk streams
(``utils.streaming``) replayed against eager dispatch bit for bit.
"""

import os
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402
from gps_optimize_slam_tpu_torch.ops import kernels, scan  # noqa: E402
from gps_optimize_slam_tpu_torch.ops.ransac import select_winner  # noqa: E402
from gps_optimize_slam_tpu_torch.ops.umeyama import umeyama_sim3  # noqa: E402

pytestmark = pytest.mark.cuda
TOL = {torch.float32: 1e-4, torch.float64: 1e-10}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("op", list(scan.OPS))
def test_scan_kernel_matches_plain(cuda, op, dtype):
    gen = torch.Generator().manual_seed(0)
    before = scan.scan_block.launches[op]
    for n in (1, 271, 4661):
        x = chip_smoke.scan_inputs(op, n, gen, dtype, cuda)
        for reverse in (False, True):
            got = scan.associative_scan(op, x, reverse)
            torch.cuda.synchronize()
            assert chip_smoke.rel_err(got, scan.scan_plain(op, x, reverse)) <= TOL[dtype]
    assert scan.scan_block.launches[op] == before + 6


def last_block_length(op, dtype):
    """The last n the routing gives K1 (the same for every combine and
    dtype on this card)."""
    L = len(scan.OPS[op][2])
    size = torch.tensor([], dtype=dtype).element_size()
    last = scan.BLOCK_MAX_ELEMENTS
    assert scan.scan_route(L, last, size) == "block" and scan.scan_route(L, last + 1, size) == "tiled"
    return last


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("op", list(scan.OPS))
def test_lookback_scan_matches_plain_across_tiles(cuda, op, dtype):
    """K1's single-pass look-back at one tile, two tiles, a ragged tail of
    several tiles and the last length the routing gives it (32 to 256
    tiles: several look-back windows of 32), both directions; the long
    case is repeated, since which predecessors have published their prefix
    changes from run to run."""
    gen = torch.Generator().manual_seed(4)
    tile = scan.block_tile(op, dtype)
    last = last_block_length(op, dtype)
    for n in (tile, tile + 1, 2 * tile, 7 * tile + 3, last):
        x = chip_smoke.scan_inputs(op, n, gen, dtype, cuda)
        for reverse in (False, True):
            want = scan.scan_plain(op, x, reverse)
            for _ in range(3 if n == last else 1):
                got = scan.scan_block(op, x, reverse)
                torch.cuda.synchronize()
                err = chip_smoke.rel_err(got, want)
                assert err <= TOL[dtype], f"{op} n={n} reverse={reverse}: rel err {err:.3e}"


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("op", list(scan.OPS))
def test_tiled_scan_kernel_matches_plain_and_block_scan(cuda, op, dtype):
    """K2 at a ragged length beyond K1's longest (a partial last tile; the
    router sends it there), at three tiles and
    one element (fewer tiles than persistent blocks, odd n, so rows are only
    element-aligned) and at 1,048,577 (more tiles than blocks for every
    combine: each block scans several in ticket order), both directions;
    the long case is repeated, since which predecessors have published
    their prefix changes from run to run."""
    gen = torch.Generator().manual_seed(1)
    n_routed = chip_smoke.TILED_N + 777
    before = scan.scan_tiled.launches[op]
    calls = 0
    for n in (3 * scan.tiled_tile(op, dtype) + 1, n_routed, 1_048_577):
        x = chip_smoke.scan_inputs(op, n, gen, dtype, cuda)
        for reverse in (False, True):
            want = scan.scan_plain(op, x, reverse)
            k1 = scan.scan_block(op, x, reverse)
            for _ in range(3 if n > n_routed else 1):
                got = scan.associative_scan(op, x, reverse) if n == n_routed else scan.scan_tiled(op, x, reverse)
                calls += 1
                torch.cuda.synchronize()
                err = max(chip_smoke.rel_err(got, want), chip_smoke.rel_err(got, k1))
                assert err <= TOL[dtype], f"{op} n={n} reverse={reverse}: rel err {err:.3e}"
    assert scan.scan_route(x.shape[0], n_routed, x.element_size()) == "tiled"
    assert scan.scan_tiled.launches[op] == before + calls
    small = x[:, :5].contiguous()  # one partial tile
    torch.testing.assert_close(scan.scan_tiled(op, small), scan.scan_plain(op, small),
                               rtol=TOL[dtype], atol=TOL[dtype])


def walk(gen, n, dtype, device, offset=0.0):
    steps = torch.randn(n, 3, generator=gen, dtype=torch.float64)
    return (torch.cumsum(steps, 0) + offset).to(dtype=dtype, device=device)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_nn_kernel_matches_plain(cuda, dtype):
    """K3 against the plain version and bit for bit against K4: seq-02's
    length, one candidate tile, fewer queries than a block takes, a ragged
    last block, more than 256 query tiles (32 queries a block),
    16,384 x 262,144 and, in float64, UTM magnitudes."""
    gen = torch.Generator().manual_seed(1)
    cases = [(4661, 4661, 0.0), (300, 777, 0.0), (5, 1, 0.0), (1131, 3000, 0.0), (33_000, 40_000, 0.0),
             (16_384, 262_144, 0.0)]
    if dtype == torch.float64:
        cases.append((4661, 4661, 5.4e6))
    for n, m, offset in cases:
        traj, cands = walk(gen, n, dtype, cuda, offset), walk(gen, m, dtype, cuda, offset + 0.3)
        mask = (torch.rand(m, generator=gen) > 0.1).to(cuda)
        before = kernels.nn_resident.launches
        got = kernels.nn_min_dist2(traj, cands, mask)
        assert kernels.nn_resident.launches == before + 1
        torch.cuda.synchronize()
        want = kernels.nn_min_dist2_plain(traj, cands, mask, block=128)
        torch.testing.assert_close(got, want, rtol=1e-5 if dtype == torch.float32 else 1e-12, atol=0.0)
        assert torch.equal(got, kernels.nn_grid(traj, cands, mask)), (n, m)
        none = kernels.nn_min_dist2(traj, cands, torch.zeros_like(mask))
        assert none.shape == (n,) and torch.isinf(none).all()
    assert kernels.nn_resident(traj[:0], cands, mask).shape == (0,)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_counts_kernel_matches_plain_and_keeps_the_winner(cuda, dtype):
    """K5's counts equal the plain version's and do not change from run to
    run: the main path's size, seq-04's, ragged point and trial chunks
    (5003 = 19 x 256 + 139 points, 333 = 10 x 32 + 13 trials), one point
    and one trial, and no valid point."""
    gen = torch.Generator().manual_seed(2)
    for n, trials, none_valid in ((4661, 1000, False), (279, 1000, False), (5003, 333, False), (4, 1, False),
                                  (4661, 1000, True)):
        src = walk(gen, n, torch.float64, cuda) * 2.0
        dst = 0.987 * src + 2.0 * torch.randn(n, 3, generator=gen, dtype=torch.float64).to(cuda)
        src, dst = src.to(dtype), dst.to(dtype)
        valid = (torch.rand(n, generator=gen) > (1.0 if none_valid else 0.05)).to(cuda)
        draws = torch.randint(0, n, (trials, 4), generator=gen).to(cuda)
        fits = umeyama_sim3(src[draws], dst[draws])
        args = (src, dst, valid, fits.R.contiguous(), fits.t.contiguous(), fits.scale.contiguous(), 16.0)
        before = kernels.ransac_counts.launches
        got, again = kernels.ransac_counts(*args), kernels.ransac_counts(*args)
        assert kernels.ransac_counts.launches == before + 2
        torch.cuda.synchronize()
        want = kernels.ransac_counts_plain(*args)
        assert got.dtype == torch.int32 and torch.equal(got, want), (n, trials)
        assert torch.equal(got, again)
        assert none_valid == (int(got.max()) == 0)
        assert int(select_winner(src, dst, valid, fits, got, 16.0)) == int(
            select_winner(src, dst, valid, fits, want, 16.0)
        )


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_counts_kernel_on_windows_at_the_threshold_and_all_masked(cuda, dtype):
    """K5's new order of work against the plain counts: a 180 s-style Sim(3)
    window (1,800 contiguous valid points) inside rows of 200,000 and a
    window of one point at a row's end (only the chunks holding a valid
    point are listed; the batch's rows equal each row alone), an adversarial
    batch whose pairs sit within a few ulps to 1e-4 of thr2
    (``chip_smoke.near_threshold_counts``: many recounted in the plain
    order), and a batch with no valid point (an empty list: zeros), on both
    of K5's shapes (the grid of every chunk, the listed walk), twice over."""
    gen = torch.Generator().manual_seed(9)
    B, n, trials = 3, 200_000, 333
    src = torch.stack([walk(gen, n, torch.float64, cuda) * 2.0 for _ in range(B)])
    dst = 0.987 * src + 2.0 * torch.randn(B, n, 3, generator=gen, dtype=torch.float64).to(cuda)
    src, dst = src.to(dtype), dst.to(dtype)
    valid = torch.zeros(B, n, dtype=torch.bool, device=cuda)
    valid[0, 70_001:71_801] = True
    valid[1, n - 1] = True
    valid[2, :1_800] = True
    draws = torch.randint(0, 1_800, (B, trials, 4), generator=gen).to(cuda) + torch.tensor(
        [70_001, n - 1_800, 0], device=cuda)[:, None, None]
    pick = torch.arange(B, device=cuda)[:, None, None]
    fits = umeyama_sim3(src[pick, draws], dst[pick, draws])
    window = (src, dst, valid, fits.R.contiguous(), fits.t.contiguous(), fits.scale.contiguous(), 16.0)
    adversarial = chip_smoke.near_threshold_counts(gen, 4, 4661, 128, dtype, cuda)
    none = (*window[:2], torch.zeros_like(valid), *window[3:])
    for args in (window, adversarial, none):
        want = kernels.ransac_counts_plain(*args)
        for per_thread in kernels.COUNT_PER_THREADS:  # the grid of every chunk and the listed walk
            got = kernels.counts_launch(*args, per_thread=per_thread)
            again = kernels.counts_launch(*args, per_thread=per_thread)
            torch.cuda.synchronize()
            assert torch.equal(got, want) and torch.equal(got, again), per_thread
    got = kernels.ransac_counts(*window)
    for r in range(B):
        assert torch.equal(got[r], kernels.ransac_counts(*(a[r].contiguous() for a in window[:6]), 16.0))
    assert int(kernels.ransac_counts(*none).abs().max()) == 0
    recounted = torch.zeros(1, dtype=torch.int64, device=cuda)
    kernels.counts_launch(*adversarial, recounted=recounted)
    if dtype == torch.float32:  # float64's band is a few ulps of float64 wide
        assert int(recounted) > 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_filter_runs_tile_matches_plain(cuda, dtype):
    """K1's work-efficient filter tile (items a thread, the ladder over the
    thread totals, the carry once a warp), which launches of 65,536
    float32 or 32,769 float64 elements or more take (fewer keep the ladder
    tile): a single row at K1's longest, both directions, and a
    batch grid of ragged rows past the threshold (each row within TOL of
    the plain ladder and of the row scanned alone, which takes the ladder
    tile), to TOL."""
    gen = torch.Generator().manual_seed(10)
    least = {torch.float32: 65_536, torch.float64: 32_769}[dtype]
    runs = scan.block_tile("filter", dtype, 1 << 20)
    assert runs != 256 and scan.block_tile("filter", dtype, 4661) == 256
    assert scan.block_tile("filter", dtype, least - 1) == 256 and scan.block_tile("filter", dtype, least) == runs
    assert scan.block_tile("filter", dtype, scan.BLOCK_MAX_ELEMENTS) == runs  # K1's longest row
    x = chip_smoke.scan_inputs("filter", scan.BLOCK_MAX_ELEMENTS, gen, dtype, cuda)
    for reverse in (False, True):
        err = chip_smoke.rel_err(scan.scan_block("filter", x, reverse), scan.scan_plain("filter", x, reverse))
        assert err <= TOL[dtype], (reverse, err)
    shapes = (5 * runs + 7, runs, 2 * runs - 1, 1, 3 * runs, 17, 4 * runs + 1)
    ns = [shapes[r % len(shapes)] for r in range(-(-least // shapes[0]))]
    assert scan.block_tile("filter", dtype, max(ns), len(ns)) == runs
    x = chip_smoke.batched_scan_inputs("filter", ns, gen, dtype, cuda)
    for reverse in (False, True):
        got = scan.scan_block("filter", x, reverse)
        want = scan.scan_plain("filter", x, reverse)
        assert chip_smoke.rel_err(got.reshape(-1, x.shape[-1]), want.reshape(-1, x.shape[-1])) <= TOL[dtype]
        for r in range(len(shapes)):
            alone = scan.scan_block("filter", x[:, r].contiguous(), reverse)
            assert chip_smoke.rel_err(got[:, r], alone) <= TOL[dtype], (r, reverse)


def test_nn_route_rule_edges(cuda):
    """One candidate below ``GRID_MIN_CANDIDATES`` launches K3, that many
    K4 (2,000 queries: 16 query tiles), and the two agree bit for bit with
    each other and with the plain version to its tolerance; one query tile
    past ``GRID_MAX_QUERY_TILES`` launches K3 again."""
    gen = torch.Generator().manual_seed(6)
    edge = kernels.GRID_MIN_CANDIDATES
    traj, cands = walk(gen, 2000, torch.float64, cuda), walk(gen, edge, torch.float64, cuda, offset=0.3)
    mask = (torch.rand(edge, generator=gen) > 0.1).to(cuda)
    k3, k4 = kernels.nn_resident.launches, kernels.nn_grid.launches
    below = kernels.nn_min_dist2(traj, cands[:-1].contiguous(), mask[:-1].contiguous())
    assert (kernels.nn_resident.launches, kernels.nn_grid.launches) == (k3 + 1, k4)
    at = kernels.nn_min_dist2(traj, cands, mask)
    assert (kernels.nn_resident.launches, kernels.nn_grid.launches) == (k3 + 1, k4 + 1)
    assert torch.equal(at, kernels.nn_resident(traj, cands, mask))
    want = kernels.nn_min_dist2_plain(traj, cands, mask, block=128)
    torch.testing.assert_close(at, want, rtol=1e-12, atol=0.0)
    assert bool((below >= at).all())  # one candidate fewer: nothing nearer
    few = kernels.GRID_MAX_QUERY_TILES * kernels.TILE_N
    many = walk(gen, few + 1, torch.float64, cuda)
    k3, k4 = kernels.nn_resident.launches, kernels.nn_grid.launches
    at_edge = kernels.nn_min_dist2(many[:few].contiguous(), cands, mask)
    past = kernels.nn_min_dist2(many, cands, mask)
    assert (kernels.nn_resident.launches, kernels.nn_grid.launches) == (k3 + 1, k4 + 1)
    assert torch.equal(past[:few], at_edge)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_nn_kernel_block_sizes_equal_each_other_k4_and_plain(cuda, dtype):
    """K3's launch alone at every block size it has (``RESIDENT_BLOCKS``)
    gives the minima of the wrapper's launch and of K4 bit for bit, at the
    main path's 37 query tiles, past each tier's edge of
    ``resident_block``, at a ragged last block and at a batch of ragged
    rows with an all-masked one; the wrapper takes the block size the rule
    names; against the plain version on every 64th query."""
    gen = torch.Generator().manual_seed(15)
    edges = (kernels.SMALL_GRID_TILES, kernels.LARGE_GRID_TILES)
    cases = [((4661,), (4661,)), ((edges[0] * 128 + 1,), (9000,)), ((edges[1] * 128 + 77,), (20_000,)),
             ((1131,), (3000,)), ((300, 4661, 129, 2000), (1500, 4661, 1025, 700))]
    for ns, ms in cases:
        traj, cands, mask = chip_smoke.ragged_walks(gen, ns, ms, dtype, cuda)
        if len(ns) == 1:
            traj, cands, mask = traj[0], cands[0], mask[0]
        operands = kernels.keep_lists(traj, cands, mask)
        tiles = len(ns) * operands[0].shape[-2]
        assert kernels.resident_block(tiles) == (16 if tiles <= edges[0] else 32 if tiles <= edges[1] else 64)
        got = kernels.nn_resident(traj, cands, mask)
        for block in kernels.RESIDENT_BLOCKS:
            before = kernels.nn_resident.launches
            out = kernels.resident_launch(traj, operands, block)
            assert kernels.nn_resident.launches == before + 1
            torch.cuda.synchronize()
            assert torch.equal(out, got), (ns, block)
        assert torch.equal(kernels.nn_grid(traj, cands, mask), got), ns
        idx = torch.arange(0, traj.shape[-2], 64, device=cuda)
        want = kernels.nn_min_dist2_plain(traj[..., idx, :].contiguous(), cands, mask, block=64)
        torch.testing.assert_close(got[..., idx], want, rtol=1e-5 if dtype == torch.float32 else 1e-12, atol=0.0)
    with pytest.raises(RuntimeError):
        kernels.resident_launch(traj, operands, 48)  # no such block size


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("case", ["long_logs", "win"])
def test_nn_kernels_agree_bit_for_bit_at_the_long_row_and_win_shapes(cuda, dtype, case):
    """K3's batch grid (its block size for thousands of query tiles at the
    long rows) and K4's at phase 1's two batched shapes: four ragged rows
    of 524,288 to 300,000 random-walk poses with the last all masked, and
    4 x 700 queries against 524,288 shuffled candidates; against the plain
    version on every 512th query."""
    gen = torch.Generator().manual_seed(16)
    if case == "long_logs":
        traj, cands, mask = chip_smoke.ragged_walks(gen, chip_smoke.LONG_LOG_LENGTHS, chip_smoke.LONG_LOG_LENGTHS,
                                                    dtype, cuda)
    else:
        B, n, m = chip_smoke.GRID_BATCH_WIN
        traj = torch.stack([walk(gen, n, dtype, cuda) for _ in range(B)])
        cands = torch.stack([walk(gen, m, dtype, cuda, offset=0.3)[torch.randperm(m, generator=gen).to(cuda)]
                             for _ in range(B)]).contiguous()
        mask = (torch.rand(B, m, generator=gen) > 0.1).to(cuda)
    k3 = kernels.nn_resident(traj, cands, mask)
    k4 = kernels.nn_grid(traj, cands, mask)
    torch.cuda.synchronize()
    assert torch.equal(k3, k4)
    idx = torch.arange(0, traj.shape[1], 512, device=cuda)
    want = kernels.nn_min_dist2_plain(traj[:, idx].contiguous(), cands, mask, block=16)
    torch.testing.assert_close(k3[:, idx], want, rtol=1e-5 if dtype == torch.float32 else 1e-12, atol=0.0)
    if case == "long_logs":
        assert torch.isposinf(k3[-1]).all()


def nan_of(dtype, negative: bool):
    """A quiet NaN with a payload, its sign bit set if ``negative``."""
    bits = {torch.float32: (0x7FC00001, torch.int32), torch.float64: (0x7FF8000000000001, torch.int64)}
    value, itype = bits[dtype]
    width = 32 if dtype == torch.float32 else 64
    if negative:
        value |= 1 << (width - 1)
        value -= 1 << width  # as a signed integer
    return torch.tensor([value], dtype=itype).view(dtype)[0]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_nan_candidates_never_win(cuda, dtype):
    """Valid candidates with a NaN coordinate, its sign bit set or not,
    change no minimum (a NaN distance never wins): K3 at every block
    size and K4 give bit for bit what they give with those candidates
    masked out (each sits in a segment of valid finite candidates, so the
    keep lists still hold every query's nearest tile), and +inf, not NaN,
    where the NaN candidates are the only valid ones."""
    gen = torch.Generator().manual_seed(17)
    traj, cands = walk(gen, 4661, dtype, cuda), walk(gen, 9000, dtype, cuda, offset=0.3)
    mask = torch.ones(9000, dtype=torch.bool, device=cuda)
    nans = torch.arange(5, 9000, 97, device=cuda)
    for k, i in enumerate(nans.tolist()):
        cands[i, k % 3] = nan_of(dtype, negative=k % 2 == 0)
    bits = chip_smoke.same_bits(cands)[torch.isnan(cands)]
    assert len(bits) == len(nans) and bool((bits < 0).any()) and bool((bits > 0).any())  # both signs
    clean = mask.clone()
    clean[nans] = False
    want = kernels.nn_resident(traj, cands, clean)
    operands = kernels.keep_lists(traj, cands, mask)
    for block in kernels.RESIDENT_BLOCKS:
        got = kernels.resident_launch(traj, operands, block)
        torch.cuda.synchronize()
        assert torch.equal(chip_smoke.same_bits(got), chip_smoke.same_bits(want)), block
    assert torch.equal(chip_smoke.same_bits(kernels.nn_grid(traj, cands, mask)), chip_smoke.same_bits(want))
    assert torch.isfinite(want).all()
    only = torch.zeros_like(mask)
    only[nans] = True
    for got in (kernels.nn_resident(traj, cands, only), kernels.nn_grid(traj, cands, only)):
        assert torch.isposinf(got).all()


def plain_keep_lists(traj, cands, mask):
    return kernels.keep_lists_plain(kernels.tile_keep_mask(*kernels.bounds_operands(traj, cands, mask)))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_keep_list_kernel_equals_plain_lists(cuda, dtype):
    """The keep-list kernel's lists equal the plain mask's compaction
    exactly (the same float64 bounds in the same order; its group- and
    tile-level tests are exact), and its packed candidates equal the plain
    packing bit for bit, at every number of warps a query tile, each taken
    by the shapes that choose it (the last entry of a case): one group a
    row or many query tiles take one warp (a ragged last block of query
    tiles at 529 and 1,058 of them), 700 x 70,000 shuffled takes two (6
    query tiles, three groups, the last partial, every tile kept; a ragged
    last block), 4,661 x 100,000 four (37 query tiles, 4 groups; a ragged
    last block) and 2,000 x 1,000,000 eight (16 query tiles, 31 groups);
    1,100,000 candidates (34 groups, two chunks of 32 groups' lanes) at
    eight warps (700 queries) and at one (140,000 queries).
    Cases: seq-02's length, ragged shapes, one candidate tile, UTM
    magnitudes, shuffled candidates, non-finite coordinates, whole tiles
    and runs of segments masked out, a whole group of 32 tiles masked out,
    and each with every candidate masked (no finite upper bound, so every
    tile is kept, as in the JAX mask)."""
    gen = torch.Generator().manual_seed(5)
    cases = [(4661, 4661, 0.0, False, 1), (300, 777, 0.0, False, 1), (5, 1, 0.0, False, 1),
             (2000, 9000, 5.4e6, False, 1), (700, 9000, 0.0, True, 1), (67_700, 3000, 0.0, False, 1),
             (135_300, 5000, 0.0, False, 1), (2000, 1_000_000, 0.0, False, 8), (700, 70_000, 0.0, True, 2),
             (4661, 100_000, 0.0, False, 4), (700, 1_100_000, 0.0, False, 8), (140_000, 1_100_000, 0.0, False, 1),
             (2000, 9000, 0.0, False, 1), (1000, 3000, 0.0, False, 1)]
    for k, (n, m, offset, shuffle, split) in enumerate(cases):
        assert kernels.keep_split(1, *kernels._tiles(n, m)) == split, (n, m)
        traj, cands = walk(gen, n, dtype, cuda, offset), walk(gen, m, dtype, cuda, offset + 0.3)
        if shuffle:
            cands = cands[torch.randperm(m, generator=gen).to(cuda)].contiguous()
        mask = (torch.rand(m, generator=gen) > 0.1).to(cuda)
        if m == 100_000:  # the first group, 32 tiles, masked out
            mask[: kernels.GROUP_TILES * kernels.TILE_M] = False
        if k == len(cases) - 2:  # part-masked tiles
            mask[:1024] = False
            mask[3000:3100] = False
            mask[8192:] = False
            mask[8500] = True
        if k == len(cases) - 1:
            traj[7, 1] = float("nan")
            traj[200, 0] = float("inf")
            cands[11, 2] = float("-inf")
            cands[2999, 0] = float("nan")
        for mk in (mask, torch.zeros_like(mask)):
            want_order, want_nkept = plain_keep_lists(traj, cands, mk)
            before = kernels.keep_lists.launches
            order, nkept, cand3 = kernels.keep_lists(traj, cands, mk)
            assert kernels.keep_lists.launches == before + 1
            assert torch.equal(nkept, want_nkept), (n, m)
            cols = torch.arange(order.shape[1], device=cuda)[None] < nkept[:, None]
            assert torch.equal(torch.where(cols, order, -1), torch.where(cols, want_order, -1)), (n, m)
            assert torch.equal(chip_smoke.same_bits(cand3),
                               chip_smoke.same_bits(kernels.pack_candidates_plain(cands, mk, order.shape[1])))
    assert {c[-1] for c in cases} == {1, 2, 4, 8}


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_grid_nn_kernel_equals_resident_kernel_and_plain(cuda, dtype):
    gen = torch.Generator().manual_seed(3)
    m = 300_000  # a ragged last candidate tile (m_pad 300,032)
    traj, cands = walk(gen, 16_384, dtype, cuda), walk(gen, m, dtype, cuda, offset=0.3)
    mask = (torch.rand(m, generator=gen) > 0.1).to(cuda)
    before = kernels.nn_grid.launches
    got = kernels.nn_grid(traj, cands, mask)
    assert kernels.nn_grid.launches == before + 1
    k3 = kernels.nn_resident(traj, cands, mask)
    torch.cuda.synchronize()
    assert torch.equal(got, k3)
    want = kernels.nn_min_dist2_plain(traj, cands, mask)
    torch.testing.assert_close(got, want, rtol=1e-5 if dtype == torch.float32 else 1e-12, atol=0.0)
    assert torch.isinf(kernels.nn_grid(traj, cands, torch.zeros_like(mask))).all()
    # Shuffled candidates: every tile kept, each query tile's list spread
    # over many K4 blocks.
    t, c = walk(gen, 700, dtype, cuda), walk(gen, m, dtype, cuda, offset=0.3)
    c = c[torch.randperm(m, generator=gen).to(cuda)].contiguous()
    assert torch.equal(kernels.nn_grid(t, c, mask), kernels.nn_resident(t, c, mask))
    for n, m in ((5, 1), (300, 777)):
        t, c = walk(gen, n, dtype, cuda), walk(gen, m, dtype, cuda, offset=0.3)
        mk = (torch.rand(m, generator=gen) > 0.1).to(cuda)
        assert torch.equal(kernels.nn_grid(t, c, mk), kernels.nn_resident(t, c, mk))


def test_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    x = torch.zeros(2, 10, dtype=torch.float64, device=cuda)
    for fn in (scan.associative_scan, scan.scan_block, scan.scan_tiled):
        with pytest.raises(ValueError):
            fn("add2", x[:, ::2])  # not contiguous
        with pytest.raises(TypeError):
            fn("add2", x.to(torch.float16))
    traj = torch.zeros(10, 3, device=cuda)
    ones = torch.ones(10, dtype=torch.bool, device=cuda)
    for fn in (kernels.nn_min_dist2, kernels.nn_resident, kernels.nn_grid):
        with pytest.raises(TypeError):
            fn(traj, traj.double(), ones)
        with pytest.raises(ValueError):
            fn(traj.T.contiguous().T, traj, ones)
        with pytest.raises(ValueError):
            fn(traj, traj.cpu(), ones)  # another device


def test_seq04_golden_on_the_card(cuda):
    chip_smoke.phase2(cuda)


def robust_case(n):
    """``n`` poses of seq-04 replicas with dirty GNSS (1 % gross outliers, an
    8 s outage) and an independent reference track."""
    import numpy as np

    from gps_optimize_slam_tpu_torch import pipeline

    slam, gt, gp = chip_smoke.replica_sequence(n)
    bad, valid, outlier = chip_smoke.faulty_gnss(gt, gp, slam["timestamps"], seed=6, fraction=0.01)
    tt, tp = chip_smoke.independent_track(gt, gp, int(0.85 * len(gt)), seed=9)

    def data(t, p, v):
        return pipeline.GPSData(timestamps=t, positions=p, valid=v, frame="enu", utm_zone=32, utm_south=False)

    return slam, gt, data(gt, bad, valid), data(tt, tp, np.ones(len(tt), bool)), outlier


@pytest.mark.parametrize("gate", ["parallel", "sequential"])
def test_robust_fusion_and_ground_truth_on_the_card_match_the_cpu(cuda, gate):
    import numpy as np

    from gps_optimize_slam_tpu_torch import pipeline

    slam, gt, gps, track, outlier = robust_case(1500)
    draws = torch.randint(0, 1000, (1000, 4), generator=torch.Generator().manual_seed(0))
    chip_smoke.reset_launch_counts()
    got, want = (pipeline.fuse_arrays(slam, gps, device=dev, sim3_draws=draws, gt=track, robust=True,
                                      robust_iterations=12, robust_gate_mode=gate) for dev in (cuda, "cpu"))
    n = chip_smoke.launch_counts()
    np.testing.assert_array_equal(got.robust_accepted, want.robust_accepted)
    assert not got.robust_accepted[chip_smoke.poses_at_fixes(slam["timestamps"], gt, outlier)].any()
    assert np.abs(got.corrected_pos - want.corrected_pos).max() <= 1e-6
    assert chip_smoke.eval_rel(got.gt_evaluation, want.gt_evaluation) <= 1e-9
    assert chip_smoke.eval_rel(got.evaluation, want.evaluation) <= 1e-9
    passes = n["scan_block/quat_chain"] - 2
    assert 1 <= passes < 12 and n["nn_resident"] == 6 and n["nn_keep"] == 6
    assert n["scan_block/filter"] == 2 + (passes if gate == "parallel" else 0)


def test_robust_chunked_on_the_card_matches_in_core(cuda):
    """70,000-pose chunks: every scan of the gate passes and of the fusion
    is past K1's longest, so the run launches K2 and no K1."""
    import numpy as np

    from gps_optimize_slam_tpu_torch.config import FusionConfig
    from gps_optimize_slam_tpu_torch.models import fusion, fusion_chunked, robust

    slam, gt, gps, _, _ = robust_case(150_000)
    st, sp, sq = slam["timestamps"], slam["positions"], slam["quaternions"]
    cfg = FusionConfig(gps_sorted=True)
    chip_smoke.reset_launch_counts()
    res = fusion_chunked.fuse_core_chunked(st, sp, sq, gt, gps.positions, gps.valid, config=cfg,
                                           chunk_size=70_000, robust=True, robust_iterations=12, device=cuda)
    n = chip_smoke.launch_counts()
    assert not any(v for k, v in n.items() if k.startswith("scan_block/"))
    assert n["scan_tiled/filter"] == n["scan_tiled/quat_chain"] >= 6 and n["scan_tiled/rts"] == 3

    def dev(a, dt=torch.float64):
        return torch.as_tensor(a, device=cuda).to(dt)

    ref = fusion.fuse_core(dev(st), dev(sp), dev(sq), dev(gt), dev(gps.positions), dev(gps.valid, torch.bool), cfg)
    want = robust.fuse_robust(dev(st), dev(sp), dev(sq), ref.sim3_pos, ref.sim3_quat, ref.aligned_gps,
                              ref.gps_valid, n_iterations=12, gate_mode="parallel")
    assert want.gate_converged and res.ok
    np.testing.assert_array_equal(res.robust_accepted, want.accepted.cpu().numpy())
    assert np.abs(res.corrected_pos - want.positions.cpu().numpy()).max() <= 1e-6
    assert np.abs(res.corrected_quat - want.quaternions.cpu().numpy()).max() <= 1e-8


def test_offset_estimator_and_adaptive_ransac_on_the_card(cuda):
    from gps_optimize_slam_tpu_torch.config import Sim3RansacConfig
    from gps_optimize_slam_tpu_torch.ops import alignment, ransac

    slam, gt, gp = chip_smoke.replica_sequence(1500)
    args = [slam["timestamps"], slam["positions"], gt + 1.7, gp]
    got, want = (float(alignment.estimate_time_offset_xcorr_device(
        *(torch.as_tensor(a, dtype=torch.float64, device=dev) for a in args))) for dev in (cuda, "cpu"))
    assert abs(got - want) <= 1e-9 and -2.6 < got < -1.6  # the unshifted estimate is -0.7 s on this data

    src = torch.as_tensor(slam["positions"], dtype=torch.float64, device=cuda)
    R = torch.tensor([[0.8, -0.6, 0.0], [0.6, 0.8, 0.0], [0.0, 0.0, 1.0]], dtype=torch.float64, device=cuda)
    dst = 0.98 * src @ R.T + 5.0
    gen = torch.Generator().manual_seed(1)
    dst = dst + 0.05 * torch.randn(dst.shape, generator=gen, dtype=torch.float64).to(cuda)
    hit = torch.randperm(len(dst), generator=gen)[:600].to(cuda)  # 40 % gross outliers
    dst[hit] += 100.0 * torch.randn((600, 3), generator=gen, dtype=torch.float64).to(cuda)
    before = kernels.ransac_counts.launches
    res = ransac.sim3_ransac(src, dst, cfg=Sim3RansacConfig(stop_probability=0.9999), seed=0)
    chunks = kernels.ransac_counts.launches - before
    fixed = ransac.sim3_ransac(src, dst, cfg=Sim3RansacConfig(), seed=0)
    assert 1 <= chunks < 8 and bool(res.ok)
    assert not res.inlier_mask[hit].any() and int(res.num_inliers) >= 880
    assert torch.equal(res.inlier_mask, fixed.inlier_mask)
    assert (res.sim3.R - fixed.sim3.R).abs().max() <= 1e-12  # the same inliers, the same refit


# --- The batch grids: each batched kernel against its batched plain version
# and, row by row, against the single-row kernel (K1 within today's
# tolerances: its look-back folds whatever its predecessors have published,
# so even two single-row calls agree only to them in the float64 filter;
# the keep lists, K3 and K5 bit for bit). Ragged rows (padded as pad_batch
# pads), B = 1 and an all-masked row.


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("op", list(scan.OPS))
def test_batched_scan_kernel_matches_plain_and_each_row(cuda, op, dtype):
    """K1's batch grid: one launch over B rows, at one tile, a ragged tail
    of several tiles, seq-02's length, B = 1, 11 and 64."""
    gen = torch.Generator().manual_seed(7)
    for B, n in ((1, 271), (11, 2049), (11, 4661), (64, 300)):
        x = torch.stack([chip_smoke.scan_inputs(op, n, gen, dtype, cuda) for _ in range(B)], 1).contiguous()
        for reverse in (False, True):
            before = scan.scan_block.launches[op]
            got = scan.associative_scan(op, x, reverse)
            assert scan.scan_block.launches[op] == before + 1
            torch.cuda.synchronize()
            assert chip_smoke.rel_err(got, scan.scan_plain(op, x, reverse)) <= TOL[dtype], (B, n)
            for r in range(B):
                alone = scan.scan_block(op, x[:, r].contiguous(), reverse)
                assert chip_smoke.rel_err(got[:, r], alone) <= TOL[dtype], (B, n, r)


# K1's cluster tile at a row of 4,661 (csrc/scan_cluster.cuh ClusterTile;
# the CPU emulation runs the same geometry, tests/test_torch_scan.py
# CLUSTER_TILE): elements a tile and blocks a cluster.
CLUSTER_AT_4661 = {"quat_chain": (512, 10), "rts": (512, 10), "mobius": (512, 10), "affine3": (1024, 5),
                   "add2": (1024, 5), "max3": (1024, 5), "min3": (1024, 5)}


def batched_path_cases(op, dtype):
    """(B, n, cluster wanted) for each of K1's batch paths: on the cluster
    path one block a row, two, the largest cluster, the fleet; past it the
    look-back path (its ladder tile, and for rts and quat_chain their runs
    tile past its crossover); the filter always the look-back path."""
    if op == "filter":
        return [(3, 300, False), (11, 4661, False), (2, 40_000, False)]
    tile = scan.block_tile(op, dtype, 1, 2)
    cases = [(3, tile, True), (3, tile + 1, True), (3, 8 * tile, True), (3, 8 * tile + 1, True), (64, 4661, True)]
    last = next(n for n in range(tile, 1 << 20, tile) if not scan.block_cluster(op, dtype, n + 1, 2))
    cases += [(3, last, True), (2, last + 1, False)]
    if op in ("rts", "quat_chain"):  # their runs tile past 2^15 elements a launch
        cases.append((4, 300_000, False))
    return cases


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("op", list(scan.OPS))
def test_batched_scan_paths_match_plain_and_each_row(cuda, op, dtype):
    """K1's batch grid on each of its paths (``batched_path_cases``), both
    directions: against the plain scan and, row by row (all rows of a small
    batch, the first and last of a large one), against K1 on that row
    alone; the cluster path twice on the same leaves bit for bit (its fold
    order is fixed by the ranks), with no scratch; the cluster tile at a
    row of 4,661 as the CPU emulation takes it."""
    from gps_optimize_slam_tpu_torch.ops import _build

    gen = torch.Generator().manual_seed(17)
    if op in CLUSTER_AT_4661:
        assert (scan.block_tile(op, dtype, 4661, 64), scan.block_cluster(op, dtype, 4661, 64)) == CLUSTER_AT_4661[op]
    for B, n, on_cluster in batched_path_cases(op, dtype):
        assert (scan.block_cluster(op, dtype, n, B) > 0) == on_cluster, (B, n)
        assert scan.block_cluster(op, dtype, n, 1) == 0  # a single row keeps the look-back path
        if on_cluster:
            assert _build.library().gps_scan_scratch_bytes(scan.OPS[op][0], int(dtype == torch.float64), n, B) == 0
        x = torch.stack([chip_smoke.scan_inputs(op, n, gen, dtype, cuda) for _ in range(B)], 1).contiguous()
        for reverse in (False, True):
            got = scan.scan_block(op, x, reverse)
            torch.cuda.synchronize()
            err = chip_smoke.rel_err(got.reshape(-1, n), scan.scan_plain(op, x, reverse).reshape(-1, n))
            assert err <= TOL[dtype], (B, n, reverse, err)
            for r in (range(B) if B <= 4 else (0, B - 1)):
                alone = scan.scan_block(op, x[:, r].contiguous(), reverse)
                assert chip_smoke.rel_err(got[:, r], alone) <= TOL[dtype], (B, n, r)
            if on_cluster:
                assert torch.equal(scan.scan_block(op, x, reverse), got)


def test_cluster_launch_replays_in_captured_programs(cuda):
    """K1's cluster launch inside a CUDA graph: the fleet's quat_chain scan
    captured with ``torch.cuda.graph`` and replayed equals the eager call
    bit for bit; and a batched fusion whose batched scans take the cluster
    path (recorded from its eager call), replayed by ``utils.graphs``,
    equals eager dispatch within the batched rows' bound."""
    from gps_optimize_slam_tpu_torch.utils import graphs

    gen = torch.Generator().manual_seed(18)
    x = torch.stack([chip_smoke.scan_inputs("quat_chain", 4661, gen, torch.float32, cuda) for _ in range(64)], 1)
    x = x.contiguous()
    assert scan.block_cluster("quat_chain", torch.float32, 4661, 64) > 0
    eager = scan.scan_block("quat_chain", x)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        scan.scan_block("quat_chain", x)
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        out = scan.scan_block("quat_chain", x)
    g.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, eager)

    call = entry_point("fuse_batch", cuda)
    calls = []
    with graphs.eager(), chip_smoke.recording(scan, "scan_block", calls):
        want = call()
    batched = [(op, t.dtype, t.shape[-1], t.shape[1]) for op, t, *_ in calls if t.ndim == 3]
    assert batched and any(scan.block_cluster(*c) > 0 for c in batched)
    graphs.clear()
    graphs.reset_stats()
    results = [call() for _ in range(3)]  # eager, capture, replay
    torch.cuda.synchronize()
    assert graphs.stats()["replays"] >= 2
    for res in results:
        same_result(res, want, 1e-12)


def test_a_refused_cluster_launch_raises_without_falling_back(cuda, monkeypatch):
    """A batched K1 call on the cluster path whose launch the card refuses
    (the C entry point returns cudaErrorInvalidConfiguration, as it does
    where a cluster does not fit) raises, and launches nothing in its
    place: no look-back launch, no K2, no plain version."""
    from gps_optimize_slam_tpu_torch.ops import _build

    lib = _build.library()
    gen = torch.Generator().manual_seed(19)
    x = torch.stack([chip_smoke.scan_inputs("rts", 4661, gen, torch.float64, cuda) for _ in range(3)], 1)
    assert scan.block_cluster("rts", torch.float64, 4661, 3) > 0

    class Refusing(_FailingLaunch):
        def __getattr__(self, name):
            if name == "gps_scan":
                return lambda *args: 9  # cudaErrorInvalidConfiguration
            return getattr(self._lib, name)

    monkeypatch.setattr(_build, "library", lambda: Refusing(lib, "gps_scan"))
    before = (dict(scan.scan_block.launches), dict(scan.scan_tiled.launches))
    with pytest.raises(RuntimeError, match="CUDA error 9"):
        scan.associative_scan("rts", x.contiguous(), True)
    assert (scan.scan_block.launches, scan.scan_tiled.launches) == before


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_batched_keep_lists_and_nn_kernel_match_plain_and_each_row(cuda, dtype):
    """The keep lists and K3 with a batch grid: ragged rows with an
    all-masked one; B = 1; 8 rows of seq-02's length (296 query tiles, so
    the batch takes K3's 32-query blocks while each row alone takes the
    16-query ones), 32 such rows (1,184 query tiles: the 64-query blocks),
    the fleet bucket (64 such rows: one group a row, a warp a query tile),
    2 x 131,072 coherent rows in float64 (four groups a row, its last row
    ragged; 2,048 query tiles, a warp each; the plain minima on every 64th
    query), 2,000 and 1,500 queries against 100,000 and 70,000 candidates
    in float64 (32 query tiles of four warps each; the second row, every
    candidate masked, lists every tile) and, in float64, UTM magnitudes.
    The last entry of a case is the warps a query tile it takes."""
    gen = torch.Generator().manual_seed(8)
    cases = [((300, 150, 1, 300), (1500, 700, 1025, 9), 0.0, 1), ((5,), (1,), 0.0, 1),
             ((4661,) * 8, (4661,) * 8, 0.0, 1), ((4661,) * 32, (4661,) * 32, 0.0, 1),
             ((4661,) * 64, (4661,) * 64, 0.0, 1)]
    if dtype == torch.float64:
        cases += [((4661, 2000, 3000), (4661, 4661, 900), 5.4e6, 1), ((131_072, 120_000), (131_072, 120_000), 0.0, 1),
                  ((2000, 1500), (100_000, 70_000), 0.0, 4)]
    for ns, ms, offset, split in cases:
        traj, cands, mask = chip_smoke.ragged_walks(gen, ns, ms, dtype, cuda, offset)
        assert kernels.keep_split(len(ns), *kernels._tiles(max(ns), max(ms))) == split, (ns, ms)
        before = (kernels.keep_lists.launches, kernels.nn_resident.launches)
        order, nkept, cand3 = kernels.keep_lists(traj, cands, mask)
        got = kernels.nn_min_dist2(traj, cands, mask)
        assert (kernels.keep_lists.launches, kernels.nn_resident.launches) == (before[0] + 2, before[1] + 1)
        torch.cuda.synchronize()
        every = 64 if max(ns) > 100_000 else 1
        idx = torch.arange(0, traj.shape[1], every, device=cuda)
        want = kernels.nn_min_dist2_plain(traj[:, idx].contiguous(), cands, mask, block=256)
        torch.testing.assert_close(got[:, idx], want, rtol=1e-5 if dtype == torch.float32 else 1e-12, atol=0.0)
        want_order, want_nkept = plain_keep_lists(traj, cands, mask)
        cols = torch.arange(order.shape[-1], device=cuda) < nkept[..., None]
        assert torch.equal(nkept, want_nkept)
        assert torch.equal(torch.where(cols, order, -1), torch.where(cols, want_order, -1))
        assert torch.equal(chip_smoke.same_bits(cand3), chip_smoke.same_bits(kernels.pack_candidates_plain(cands, mask, order.shape[-1])))
        for r in range(len(ns)):
            o1, k1, c1 = kernels.keep_lists(traj[r], cands[r], mask[r])
            c = torch.arange(o1.shape[-1], device=cuda) < k1[:, None]
            assert torch.equal(k1, nkept[r]) and torch.equal(torch.where(c, o1, -1), torch.where(c, order[r], -1))
            assert torch.equal(chip_smoke.same_bits(c1), chip_smoke.same_bits(cand3[r]))
            assert torch.equal(kernels.nn_resident(traj[r], cands[r], mask[r]), got[r]), (ns, r)
        if len(ns) > 1:
            assert torch.isinf(got[-1]).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_batched_counts_kernel_matches_plain_and_each_row(cuda, dtype):
    """K5's batch grid: 11 ragged rows (points padded and masked out) with a
    row of no valid point, B = 1, and 64 rows of seq-02's length."""
    gen = torch.Generator().manual_seed(9)
    for B, n, trials in ((11, 1500, 333), (1, 279, 1000), (64, 4661, 128)):
        src = torch.stack([walk(gen, n, torch.float64, cuda) * 2.0 for _ in range(B)])
        dst = 0.987 * src + 2.0 * torch.randn(B, n, 3, generator=gen, dtype=torch.float64).to(cuda)
        src, dst = src.to(dtype), dst.to(dtype)
        valid = (torch.rand(B, n, generator=gen) > 0.05).to(cuda)
        for r in range(B):
            valid[r, n - 37 * r:] = False  # ragged rows
        if B > 1:
            valid[1] = False
        draws = torch.randint(0, n, (B, trials, 4), generator=gen).to(cuda)
        pick = torch.arange(B, device=cuda)[:, None, None]
        fits = umeyama_sim3(src[pick, draws], dst[pick, draws])
        args = (src, dst, valid, fits.R.contiguous(), fits.t.contiguous(), fits.scale.contiguous(), 16.0)
        before = kernels.ransac_counts.launches
        got = kernels.ransac_counts(*args)
        assert kernels.ransac_counts.launches == before + 1 and got.shape == (B, trials)
        torch.cuda.synchronize()
        assert torch.equal(got, kernels.ransac_counts_plain(*args))
        for r in range(B):
            assert torch.equal(got[r], kernels.ransac_counts(*(a[r].contiguous() for a in args[:6]), 16.0))
        if B > 1:
            assert int(got[1].max()) == 0


def test_fuse_batch_on_the_card_matches_the_cpu_and_each_row(cuda):
    """Three KITTI-length replica sequences fused as one batch on the card,
    float64: within 1e-6 m of the same batch on CPU tensors and within 1e-9
    m of each row's single-row fusion on the card, masks equal, one launch
    of each kernel a batch."""
    from gps_optimize_slam_tpu_torch.config import FusionConfig
    from gps_optimize_slam_tpu_torch.models import fusion
    from gps_optimize_slam_tpu_torch.parallel import batch as pbatch
    from gps_optimize_slam_tpu_torch.parallel import mesh

    seqs = [chip_smoke.replica_sequence(n, seed=s) for n, s in ((1101, 1), (801, 2), (1201, 3))]
    b = pbatch.pad_batch([s for s, _, _ in seqs], [t for _, t, _ in seqs], [p for _, _, p in seqs])
    cfg = FusionConfig()
    chip_smoke.reset_launch_counts()
    out = mesh.fuse_batch(b, config=cfg, device=cuda)
    mesh.evaluate_batch(b, out)
    torch.cuda.synchronize()
    counts = chip_smoke.launch_counts()
    assert counts["ransac_counts"] == 1 and counts["nn_resident"] == 3 and counts["nn_keep"] == 3
    cpu = mesh.fuse_batch(b, config=cfg.replace(platform="gpu"), device="cpu")
    assert float((out.corrected_pos.cpu() - cpu.corrected_pos).abs().max()) <= 1e-6
    assert torch.equal(out.sim3_inliers.cpu(), cpu.sim3_inliers)
    for i, (slam, gt, gp) in enumerate(seqs):
        t = [torch.as_tensor(a, device=cuda) for a in (slam["timestamps"], slam["positions"], slam["quaternions"],
                                                      gt, gp, torch.ones(len(gt), dtype=torch.bool))]
        single = fusion.fuse_core(*t, cfg.replace(gps_sorted=True), seed=i)
        n = len(slam["timestamps"])
        assert float((out.corrected_pos[i, :n] - single.corrected_pos).abs().max()) <= 1e-9
        assert torch.equal(out.sim3_inliers[i, :n], single.sim3_inliers)


def test_refine_on_the_card_matches_the_cpu_and_resumes_bit_for_bit(cuda, tmp_path):
    """``fuse_arrays`` + ``refine_pose_graph`` on a 1,200-pose shuttle
    (``chip_smoke.shuttle_sequence``) on the card against the same on CPU
    tensors: positions ≤1e-6 m, quaternions ≤1e-8, cost history ≤1e-9
    relative, the closures equal; a refinement stopped after 5 of 10 steps
    and resumed from its checkpoint equals the uninterrupted one bit for
    bit."""
    from gps_optimize_slam_tpu_torch import pipeline

    slam, gt, gp = chip_smoke.shuttle_sequence(1200)
    gps = chip_smoke.shuttle_gps(gt, gp)
    res = pipeline.fuse_arrays(slam, gps, device=cuda)
    res_cpu = pipeline.fuse_arrays(slam, gps, device="cpu")
    gn, info = pipeline.refine_pose_graph(res, **chip_smoke.REFINE, checkpoint_dir=str(tmp_path / "whole"))
    gn_cpu, info_cpu = pipeline.refine_pose_graph(res_cpu, **chip_smoke.REFINE)
    assert info["n_loops"] > 0 and gn.state.positions.device.type == cuda.type
    gaps = chip_smoke.refine_gaps(gn, info, gn_cpu, info_cpu)
    assert gaps["positions_m"] <= 1e-6 and gaps["quaternions"] <= 1e-8, gaps
    assert gaps["cost_history_rel"] <= 1e-9 and gaps["loop_ij_equal"], gaps
    stopped = str(tmp_path / "stopped")
    pipeline.refine_pose_graph(res, **{**chip_smoke.REFINE, "iterations": 5}, checkpoint_dir=stopped)
    resumed, _ = pipeline.refine_pose_graph(res, **chip_smoke.REFINE, checkpoint_dir=stopped)
    assert all(torch.equal(a, b) for a, b in zip(resumed.state, gn.state))
    assert torch.equal(resumed.cost_history, gn.cost_history)


def test_pose_graph_pieces_on_the_card_match_the_cpu(cuda):
    """``propose_loop_closures`` (every slot of ``loop_ij`` equal: the ties of
    ``min`` and of the stable sort on the card), the residuals and one
    Hessian-vector product (≤1e-12 relative) on the card against CPU
    tensors."""
    from gps_optimize_slam_tpu_torch.models import pose_graph
    from gps_optimize_slam_tpu_torch.ops import quaternion as quat

    gen = torch.Generator().manual_seed(3)
    n = 2000
    ang = torch.linspace(0, 6 * 3.141592653589793, n, dtype=torch.float64)
    pos = torch.stack([torch.cos(ang) * 40, torch.sin(ang) * 40, torch.zeros(n, dtype=torch.float64)], -1)
    pos = pos + 0.3 * torch.randn(n, 3, generator=gen, dtype=torch.float64)
    q = quat.normalize(torch.randn(n, 4, generator=gen, dtype=torch.float64))
    times = torch.arange(n, dtype=torch.float64) * 0.1
    for radius, max_loops in ((2.0, 64), (0.5, 200)):
        got = pose_graph.propose_loop_closures(pos.to(cuda), times.to(cuda), q.to(cuda), radius=radius,
                                               max_loops=max_loops)
        want = pose_graph.propose_loop_closures(pos, times, q, radius=radius, max_loops=max_loops)
        assert torch.equal(got[0].cpu(), want[0]) and torch.equal(got[3].cpu(), want[3])
        assert 0 < int(want[3].sum()) < max_loops
    # The data from the trajectory, the state off it: every residual is of
    # the order of the offsets, none a rounding of zero.
    data = pose_graph.build_data_from_fusion(pos, q, pos, torch.rand(n, generator=gen) < 0.5, *want)
    state = pose_graph.PoseGraphState(pos + 0.05 * torch.randn(n, 3, generator=gen, dtype=torch.float64),
                                      quat.normalize(q + 0.01 * torch.randn(n, 4, generator=gen, dtype=torch.float64)))
    v = torch.randn(n, 6, generator=gen, dtype=torch.float64)
    to = lambda x: x.to(cuda) if torch.is_tensor(x) else x  # noqa: E731
    data_c, state_c = pose_graph.PoseGraphData(*(to(x) for x in data)), pose_graph.PoseGraphState(*(to(x) for x in state))
    r, rc = pose_graph.residuals(state, data), pose_graph.residuals(state_c, data_c).cpu()
    assert float((r - rc).abs().max() / r.abs().max()) <= 1e-12
    grad, hvp = pose_graph._normal_equations(state, data, 1e-6)
    grad_c, hvp_c = pose_graph._normal_equations(state_c, data_c, 1e-6)
    assert float((grad - grad_c.cpu()).abs().max() / grad.abs().max()) <= 1e-12
    hv = hvp(v)
    assert float((hv - hvp_c(v.to(cuda)).cpu()).abs().max() / hv.abs().max()) <= 1e-12


def pose_graph_case(n, n_loop, dtype, device, seed=0):
    """A pose graph of ``n`` poses along a drifting track, its state off its
    measurements by centimetres and degrees, GNSS on three poses of four,
    and ``n_loop`` closures between random poses (i > j among them, every
    fifth invalid; at n = 1 the pose closed on itself), as
    ``pose_graph._linearise`` takes them."""
    from gps_optimize_slam_tpu_torch.models import pose_graph
    from gps_optimize_slam_tpu_torch.ops import quaternion as quat

    gen = torch.Generator().manual_seed(seed)
    rnd = lambda *shape: torch.randn(*shape, generator=gen, dtype=torch.float64)  # noqa: E731
    ident = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=torch.float64)
    pos = torch.cumsum(torch.tensor([1.0, 0.2, 0.0]) + 0.3 * rnd(n, 3), 0)
    q = quat.normalize(ident + 0.2 * rnd(n, 4))
    qi = quat.conj(q[:-1])
    ij = torch.randint(0, n, (n_loop, 2), generator=gen)
    li, lj = ij[:, 0], ij[:, 1]
    data = pose_graph.PoseGraphData(
        odo_dp=quat.rotate(qi, pos[1:] - pos[:-1]) + 0.02 * rnd(n - 1, 3),
        odo_dq=quat.normalize(quat.mul(qi, q[1:]) + 0.01 * rnd(n - 1, 4)),
        gps=pos + 0.05 * rnd(n, 3), gps_valid=torch.arange(n) % 4 != 3, loop_ij=ij,
        loop_dp=quat.rotate(quat.conj(q[li]), pos[lj] - pos[li]) + 0.02 * rnd(n_loop, 3),
        loop_dq=quat.normalize(quat.mul(quat.conj(q[li]), q[lj]) + 0.01 * rnd(n_loop, 4)),
        loop_valid=torch.arange(n_loop) % 5 != 4)
    state = pose_graph.PoseGraphState(pos + 0.05 * rnd(n, 3), quat.normalize(q + 0.02 * rnd(n, 4)))

    def to(x):
        x = x.to(device)
        return x.to(dtype) if x.is_floating_point() else x

    return (pose_graph.PoseGraphState(*map(to, state)),
            pose_graph.PoseGraphData(*(to(x) if torch.is_tensor(x) else x for x in data)))


def pose_cg_args(state, data):
    """``pose_graph._linearise`` at ``state``: ``kernels.pose_cg``'s operands
    but the iterations."""
    from gps_optimize_slam_tpu_torch.models import pose_graph

    lin = pose_graph._linearise(state, data)
    return (lin.blocks, lin.r0, lin.r_gps, data.gps_valid, data.w_gps, data.loop_ij, 1e-6)


def pose_cg_on_the_card_and_plain(args, maxiter):
    """Two launches of ``kernels.pose_cg`` (asserted bit-equal, counts
    included) and ``pose_cg_plain`` on CPU copies of the operands."""
    got, count = kernels.pose_cg(*args, maxiter)
    again, count_again = kernels.pose_cg(*args, maxiter)
    torch.cuda.synchronize()
    assert torch.equal(got, again) and torch.equal(count, count_again)
    assert got.device.type == "cuda" and count.dtype == torch.int32
    cpu = [a.cpu() if torch.is_tensor(a) else a for a in args]
    want, want_count = kernels.pose_cg_plain(*cpu, maxiter)
    return got.cpu(), int(count), want, int(want_count)


# (N, L) at the boundaries of the cluster's size (``pose_cg.cu``: at least 32
# poses a block, at most 16 blocks): one pose, two (one block), 33 (two
# blocks), 517 (16 blocks of 32 or 33 poses); and 16 blocks whose poses
# outgrow their shared memory and live in the global scratch (12,000 in
# float64, 25,000 in float32).
POSE_CG_SHAPES = [(1, 2), (2, 2), (33, 32), (517, 32), (12_000, 32), (25_000, 32)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n,n_loop", POSE_CG_SHAPES)
def test_pose_cg_kernel_matches_plain(cuda, n, n_loop, dtype):
    """``pose_cg`` against ``pose_cg_plain`` on the same blocks (closures
    across the blocks' pose ranges, i > j, invalid ones, a pose closed on
    itself): after 5 iterations δ within TOL; after 50 δ within TOL where
    the float64 solve converged (n ≤ 2; one pose converges within 5); the
    same count of active iterations. Not compared: δ run on to 50
    iterations unconverged (these random graphs move it by up to 1e-3 under
    another order of summation, whichever code sums: the CPU's dense CG
    shows it too), and the count of a float32 solve that converges (its
    stop, γ ≤ 1e-20·b·b, lies below float32's rounding of γ, so whether and
    when an iteration meets it is the rounding's: at n = 2 the kernel ran
    all 50 where the plain version stopped). Two launches are bit-equal."""
    state, data = pose_graph_case(n, n_loop, dtype, cuda)
    args = pose_cg_args(state, data)
    for maxiter in (5, 50):
        got, count, want, want_count = pose_cg_on_the_card_and_plain(args, maxiter)
        converged = n == 1 or (n == 2 and maxiter == 50)
        if dtype == torch.float64 or not converged:
            assert count == want_count and (count < maxiter) == converged
        if maxiter == 5 or (converged and dtype == torch.float64):
            assert chip_smoke.rel_err(got, want) <= TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_pose_cg_kernel_at_the_cells_shape(cuda, dtype):
    """The refine cell's own step: the 4,541-pose shuttle fused on the
    card, its 32 closures proposed, linearised at the fused trajectory.
    float64: δ within TOL of the plain version after 5 and 50 iterations
    (all 50 active on both); float32 after 5. Two launches bit-equal."""
    from gps_optimize_slam_tpu_torch import pipeline
    from gps_optimize_slam_tpu_torch.models import pose_graph

    slam, gt, gp = chip_smoke.shuttle_sequence(chip_smoke.SHUTTLE_N)
    res = pipeline.fuse_arrays(slam, chip_smoke.shuttle_gps(gt, gp), dtype=dtype, device=cuda)
    o = res.outputs
    times = torch.as_tensor(slam["timestamps"], dtype=dtype, device=cuda)
    loops = pose_graph.propose_loop_closures(o.corrected_pos, times, o.sim3_quat)
    assert int(loops[3].sum()) == 32
    data = pose_graph.build_data_from_fusion(o.sim3_pos, o.sim3_quat, o.aligned_gps, o.gps_valid, *loops)
    args = pose_cg_args(pose_graph.PoseGraphState(o.corrected_pos, o.corrected_quat), data)
    assert args[0].shape == (chip_smoke.SHUTTLE_N - 1 + 32, 6, 12)
    for maxiter in (5, 50) if dtype == torch.float64 else (5,):
        got, count, want, want_count = pose_cg_on_the_card_and_plain(args, maxiter)
        assert count == want_count == maxiter and chip_smoke.rel_err(got, want) <= TOL[dtype]


def test_each_gauss_newton_step_launches_pose_cg_once_and_counts_its_iterations(cuda, tracer, monkeypatch):
    """A solve of 4 steps makes 4 ``pose_cg`` launches (eager, captured and
    replayed alike); traced, a one-step solve's ``cg.iters_active`` equals
    the plain version's count on the same operands (a graph whose CG
    converges before 50 iterations); a CUDA tensor never takes the plain
    path."""
    from gps_optimize_slam_tpu_torch.models import pose_graph
    from gps_optimize_slam_tpu_torch.utils import graphs

    state, data = pose_graph_case(2, 2, torch.float64, cuda)
    cpu = [a.cpu() if torch.is_tensor(a) else a for a in pose_cg_args(state, data)]
    _, want = kernels.pose_cg_plain(*cpu, 50)
    graphs.clear()
    before = kernels.pose_cg.launches
    monkeypatch.setattr(kernels, "pose_cg_plain", None)  # any call of the plain version fails
    pose_graph.solve_pose_graph(state, data, iterations=4)
    torch.cuda.synchronize()
    assert kernels.pose_cg.launches == before + 4
    tracer.enable()
    pose_graph.solve_pose_graph(state, data, iterations=1)
    rec = tracer.records()
    tracer.disable()
    graphs.clear()
    assert 0 < int(want) < 50 and rec["device_counts"] == {"cg.iters_active": float(want)}
    assert kernels.pose_cg.launches == before + 5


def test_pose_cg_refuses_what_the_kernel_does_not_take(cuda, monkeypatch):
    """Shapes, dtypes and devices the kernel does not take raise, and a
    launch the card refuses (the C entry point returns
    cudaErrorInvalidConfiguration, as where no cluster fits) raises, with
    nothing run in its place: no launch counted, no plain version."""
    from gps_optimize_slam_tpu_torch.ops import _build

    state, data = pose_graph_case(33, 4, torch.float64, cuda)
    args = list(pose_cg_args(state, data))
    for k, bad in ((0, args[0][:-1]), (2, args[2][:-1]), (5, args[5][:, :1])):
        with pytest.raises(ValueError):
            kernels.pose_cg(*args[:k], bad, *args[k + 1:], 5)
    with pytest.raises(TypeError):
        kernels.pose_cg(args[0].float(), *args[1:], 5)
    with pytest.raises(ValueError):
        kernels.pose_cg(*args[:3], args[3].cpu(), *args[4:], 5)
    with pytest.raises(ValueError):
        kernels.pose_cg(*args, -1)
    lib = _build.library()

    class Refusing(_FailingLaunch):
        def __getattr__(self, name):
            if name == "gps_pose_cg":
                return lambda *a: 9  # cudaErrorInvalidConfiguration
            return getattr(self._lib, name)

    monkeypatch.setattr(_build, "library", lambda: Refusing(lib, "gps_pose_cg"))
    monkeypatch.setattr(kernels, "pose_cg_plain", None)
    before = kernels.pose_cg.launches
    with pytest.raises(RuntimeError, match="CUDA error 9"):
        kernels.pose_cg(*args, 5)
    assert kernels.pose_cg.launches == before


def seqpar_case(n, device, seed=5):
    """A replica sequence with a start without GNSS and an outage, its GNSS
    interpolated onto the poses: the seven seqpar inputs on ``device``."""
    import numpy as np

    slam, gt, gp = chip_smoke.replica_sequence(n, seed=seed)
    st = slam["timestamps"]
    aligned = np.stack([np.interp(st, gt, gp[:, k]) for k in range(3)], -1)
    valid = (st > st[0] + 20) & (np.abs(st - st[n // 2]) > 8)
    return [torch.as_tensor(a, device=device) for a in (st, slam["positions"], slam["quaternions"],
                                                        slam["positions"], slam["quaternions"], aligned, valid)]


@pytest.mark.parametrize("rts_mode", ["outage", "full"])
@pytest.mark.parametrize("n", [1500, 1501])
def test_seqpar_on_one_card_matches_one_device(cuda, n, rts_mode):
    """``fuse_ekf_rts_seqparallel`` on four blocks of one card, with every
    host synchronisation an error (``set_sync_debug_mode("error")``),
    against ``fuse_ekf_rts_parallel`` on the card (≤1e-8 m, quaternions
    ≤1e-10, the JAX package's bounds) and on CPU tensors; each block's scan
    and the totals' scan launch K1: the filter's 3 scans and the controls'
    forward (max3) and backward (min3) scans × (4 blocks + 1)."""
    from gps_optimize_slam_tpu_torch.ops import kalman_parallel
    from gps_optimize_slam_tpu_torch.parallel import seqpar
    from gps_optimize_slam_tpu_torch.parallel.mesh import make_mesh

    args = seqpar_case(n, cuda)
    mesh = make_mesh(devices=["cuda:0"] * 4)
    chip_smoke.reset_launch_counts()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = seqpar.fuse_ekf_rts_seqparallel(mesh, *args, rts_mode=rts_mode)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    counts = chip_smoke.launch_counts()
    assert {k: v for k, v in counts.items() if v} == {
        f"scan_block/{op}": 5 for op in ("quat_chain", "filter", "rts", "max3", "min3")}
    one = kalman_parallel.fuse_ekf_rts_parallel(*args, rts_mode=rts_mode)
    cpu = kalman_parallel.fuse_ekf_rts_parallel(*(a.cpu() for a in args), rts_mode=rts_mode)
    for ref in (one, cpu):
        assert float((got[0].cpu() - ref[0].cpu()).abs().max()) <= 1e-8
        assert float((got[1].cpu() - ref[1].cpu()).abs().max()) <= 1e-10


def two_cards():
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    return torch.device("cuda", 0), torch.device("cuda", 1)


@pytest.mark.parametrize("rts_mode", ["outage", "full"])
def test_seqpar_over_two_cards_matches_one_card(cuda, rts_mode):
    """Four blocks over cuda:0 and cuda:1 (blocks 1 and 3 on the second
    card: every edge crosses cards), the halos, totals and prefixes copied
    between the cards without a host synchronisation, against the same
    four blocks on one card and the single-device filter, ≤1e-8 m; the
    per-block outputs lie on their cards."""
    from gps_optimize_slam_tpu_torch.ops import kalman_parallel
    from gps_optimize_slam_tpu_torch.parallel import seqpar
    from gps_optimize_slam_tpu_torch.parallel.mesh import make_mesh

    first, second = two_cards()
    args = seqpar_case(20_001, first)
    one_card = seqpar.fuse_ekf_rts_seqparallel(make_mesh(devices=[first] * 4), *args, rts_mode=rts_mode)
    mesh = make_mesh(devices=[first, second, first, second])
    torch.cuda.set_sync_debug_mode("error")
    try:
        blocks = seqpar.fuse_ekf_rts_seqparallel(mesh, *args, rts_mode=rts_mode, gather=False)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert [b.device for b in blocks[0]] == list(mesh.devices)
    got = [torch.cat([b.to(first) for b in xs]) for xs in blocks]
    one = kalman_parallel.fuse_ekf_rts_parallel(*args, rts_mode=rts_mode)
    for ref in (one_card, one):
        assert float((got[0] - ref[0]).abs().max()) <= 1e-8
        assert float((got[1] - ref[1]).abs().max()) <= 1e-10


def test_mesh_shards_over_two_cards_match_one_card(cuda):
    """Five replica sequences on two shards, one a card, issued from a host
    thread a card, against the same two shards on one card and the
    unsharded batch, ≤1e-9 m."""
    from gps_optimize_slam_tpu_torch.config import FusionConfig
    from gps_optimize_slam_tpu_torch.parallel import batch as pbatch
    from gps_optimize_slam_tpu_torch.parallel import mesh

    first, second = two_cards()
    seqs = [chip_smoke.replica_sequence(n, seed=s) for s, n in enumerate((601, 701, 801, 651, 751))]
    b = pbatch.pad_batch([s for s, _, _ in seqs], [t for _, t, _ in seqs], [p for _, _, p in seqs])
    cfg = FusionConfig()
    want = mesh.fuse_batch(b, config=cfg, device=first)
    one_card = mesh.fuse_batch(b, config=cfg, mesh=mesh.make_mesh(devices=[first] * 2))
    got = mesh.fuse_batch(b, config=cfg, mesh=mesh.make_mesh(devices=[first, second]))
    torch.cuda.synchronize()
    assert got.corrected_pos.device == first and bool(got.ok.all())
    for ref in (one_card, want):
        assert float((got.corrected_pos - ref.corrected_pos).abs().max()) <= 1e-9
        assert torch.equal(got.sim3_inliers, ref.sim3_inliers)


def test_fuse_batch_on_a_mesh_of_one_card_matches_the_unsharded_batch(cuda):
    """Five replica sequences over three shards of one card (padded to six
    rows) against the unsharded batch on the card, ≤1e-9 m; each shard
    launches each kernel once."""
    from gps_optimize_slam_tpu_torch.config import FusionConfig
    from gps_optimize_slam_tpu_torch.parallel import batch as pbatch
    from gps_optimize_slam_tpu_torch.parallel import mesh

    seqs = [chip_smoke.replica_sequence(n, seed=s) for s, n in enumerate((601, 701, 801, 651, 751))]
    b = pbatch.pad_batch([s for s, _, _ in seqs], [t for _, t, _ in seqs], [p for _, _, p in seqs])
    cfg = FusionConfig()
    want = mesh.fuse_batch(b, config=cfg, device=cuda)
    chip_smoke.reset_launch_counts()
    got = mesh.fuse_batch(b, config=cfg, mesh=mesh.make_mesh(devices=["cuda:0"] * 3))
    torch.cuda.synchronize()
    counts = chip_smoke.launch_counts()
    assert counts["ransac_counts"] == 3 and counts["scan_block/filter"] == 3
    assert got.corrected_pos.device == want.corrected_pos.device and got.corrected_pos.shape[0] == 5
    assert float((got.corrected_pos - want.corrected_pos).abs().max()) <= 1e-9
    assert torch.equal(got.sim3_inliers, want.sim3_inliers) and bool(got.ok.all())


def test_kernels_launch_on_their_tensors_card_when_another_is_current(cuda):
    """A scan and an NN call on cuda:1 while cuda:0 is current: each wrapper
    launches on its tensors' card and stream (two cards needed). The NN
    call equals the same kernel's on cuda:0 bit for bit, and the plain
    version within the file's float64 NN bound (K3 sums in another order)."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    gen = torch.Generator().manual_seed(9)
    other = torch.device("cuda", 1)
    with torch.cuda.device(0):
        for op, n in (("filter", 4661), ("filter", 262_145), ("add2", 262_145)):
            x = chip_smoke.scan_inputs(op, n, gen, torch.float64, other)
            got = scan.associative_scan(op, x)
            torch.cuda.synchronize(other)
            assert got.device == other
            assert chip_smoke.rel_err(got, scan.scan_plain(op, x)) <= TOL[torch.float64]
        traj = walk(gen, 4661, torch.float64, other)
        mask = torch.rand(4661, generator=gen).to(other) > 0.1
        got = kernels.nn_min_dist2(traj, traj, mask)
        torch.cuda.synchronize(other)
        assert got.device == other
        home = torch.device("cuda", 0)
        assert torch.equal(got.to(home), kernels.nn_min_dist2(traj.to(home), traj.to(home), mask.to(home)))
        torch.testing.assert_close(got, kernels.nn_min_dist2_plain(traj, traj, mask, block=128), rtol=1e-12, atol=0.0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("op", list(scan.OPS))
def test_batched_tiled_scan_kernel_matches_plain_and_each_row(cuda, op, dtype):
    """K2's batch grid: one launch over B rows, ragged rows past K1's route
    (a row of 2,001 elements among rows of 70,001), B = 1, and 3 rows of
    5,000 (fewer tiles than persistent blocks), both directions; against
    the batched plain version, and row by row against K2 on that row alone
    (and, forward, on its real elements alone), bit for bit where the
    combine is exact."""
    gen = torch.Generator().manual_seed(12)
    for ns in ((70_001, 50_001, 30_001, 2_001), (70_001,), (5_000,) * 3):
        x = chip_smoke.identity_padded_rows(op, ns, gen, dtype, cuda)
        for reverse in (False, True):
            before = dict(scan.scan_tiled.launches)
            got = scan.scan_tiled(op, x, reverse)
            assert scan.scan_tiled.launches[op] == before[op] + 1
            torch.cuda.synchronize()
            assert chip_smoke.rel_err(got.flatten(1), scan.scan_plain(op, x, reverse).flatten(1)) <= TOL[dtype], ns
            for r, k in enumerate(ns):
                alone = scan.scan_tiled(op, x[:, r].contiguous(), reverse)
                pairs = [(got[:, r], alone)]
                if not reverse:
                    pairs.append((got[:, r, :k], scan.scan_tiled(op, x[:, r, :k].contiguous(), False)))
                for a, b in pairs:
                    if op in chip_smoke.EXACT_COMBINES:
                        assert torch.equal(a, b), (ns, r, reverse)
                    assert chip_smoke.rel_err(a, b) <= TOL[dtype], (ns, r, reverse)


def test_tiled_grid_layout_fits_and_spills_nothing(cuda):
    """K2's batch grid for every combine and dtype: a block of its compute
    warps (4 to 8) plus a producer warp fits the card at least once an SM,
    its ring of two or more stages within a block's shared memory, and no
    instantiation spills (``-Xptxas -v``, where this run compiled the
    library)."""
    from gps_optimize_slam_tpu_torch.ops import _build

    layouts = chip_smoke.tiled_grid_layouts()
    for key, layout in layouts.items():
        assert 4 <= layout["warps"] <= 8 and layout["stages"] >= 2, key
        assert layout["tile"] == 32 * layout["warps"] * layout["items"], key
        assert layout["blocks_per_sm"] >= 1 and layout["smem_bytes"] <= 227 * 1024, key
        if _build.BUILD_INFO.get("log"):
            registers, spilled = layout["registers_and_spills"]
            assert registers <= 255 and spilled == 0, (key, registers, spilled)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_batched_grid_nn_kernel_equals_resident_kernel(cuda, dtype):
    """K4's batch grid bit for bit against K3's batch grid: ragged rows with
    an all-masked one, B = 1, and 4 rows of 700 queries against 300,000
    shuffled candidates (every tile kept, each list over many blocks);
    against the plain version on every 64th query."""
    gen = torch.Generator().manual_seed(13)
    cases = [chip_smoke.ragged_walks(gen, ns, ms, dtype, cuda)
             for ns, ms in (((300, 150, 1, 300), (1500, 700, 1025, 9)), ((5,), (1,)))]
    m = 300_000
    traj = torch.stack([walk(gen, 700, dtype, cuda) for _ in range(4)])
    cands = torch.stack([walk(gen, m, dtype, cuda, offset=0.3)[torch.randperm(m, generator=gen).to(cuda)]
                         for _ in range(4)]).contiguous()
    mask = (torch.rand(4, m, generator=gen) > 0.1).to(cuda)
    mask[1] = False
    cases.append((traj, cands, mask))
    for traj, cands, mask in cases:
        k3 = kernels.nn_resident(traj, cands, mask)
        before = kernels.nn_grid.launches
        got = kernels.nn_grid(traj, cands, mask)
        torch.cuda.synchronize()
        assert kernels.nn_grid.launches == before + 1
        assert torch.equal(got, k3)
        idx = torch.arange(0, traj.shape[1], 64, device=cuda)
        want = kernels.nn_min_dist2_plain(traj[:, idx].contiguous(), cands, mask, block=64)
        torch.testing.assert_close(k3[:, idx], want, rtol=1e-5 if dtype == torch.float32 else 1e-12, atol=0.0)
        if traj.shape[0] > 1:
            assert torch.isinf(k3[1] if traj.shape[1] == 700 else k3[-1]).all()


def test_batched_routes_pick_each_kernel(cuda):
    """A batch of rts, mobius or affine3 rows of at least
    ``BATCH_TILED_MIN_ROW`` elements and ``BATCH_TILED_MIN_ELEMENTS`` in all
    launches K2's grid, a batch of fewer elements or of another combine K1's;
    a few query tiles against ``GRID_MIN_CANDIDATES`` candidates launch K4's
    grid, many K3's; each batched call once."""
    gen = torch.Generator().manual_seed(14)
    n = scan.BATCH_TILED_MIN_ROW
    most = -(-scan.BATCH_TILED_MIN_ELEMENTS // n)
    for op, B, kernel in (("affine3", most, scan.scan_tiled), ("affine3", most - 1, scan.scan_block),
                          ("add2", most, scan.scan_block)):
        x = torch.stack([chip_smoke.scan_inputs(op, n, gen, torch.float64, cuda) for _ in range(B)], 1)
        before = (dict(scan.scan_block.launches), dict(scan.scan_tiled.launches))
        scan.associative_scan(op, x.contiguous())
        after = (scan.scan_block.launches, scan.scan_tiled.launches)
        moved = {k.__name__: after[i][op] - before[i][op] for i, k in enumerate((scan.scan_block, scan.scan_tiled))}
        assert moved == {"scan_block": int(kernel is scan.scan_block), "scan_tiled": int(kernel is scan.scan_tiled)}
    m = kernels.GRID_MIN_CANDIDATES
    cands = torch.stack([walk(gen, m, torch.float64, cuda, offset=0.3) for _ in range(2)]).contiguous()
    mask = (torch.rand(2, m, generator=gen) > 0.1).to(cuda)
    for n_q, grid in ((700, True), (kernels.GRID_MAX_QUERY_TILES * kernels.TILE_N, False)):
        traj = torch.stack([walk(gen, n_q, torch.float64, cuda) for _ in range(2)])
        before = (kernels.nn_resident.launches, kernels.nn_grid.launches)
        got = kernels.nn_min_dist2(traj, cands, mask)
        assert (kernels.nn_resident.launches - before[0], kernels.nn_grid.launches - before[1]) == (
            (0, 1) if grid else (1, 0))
        assert torch.equal(got, kernels.nn_resident(traj, cands, mask) if grid else kernels.nn_grid(traj, cands, mask))


class _FailingLaunch:
    """The kernels' library with one entry point that reports a failed
    launch (cudaErrorLaunchFailure)."""

    def __init__(self, lib, name):
        self._lib, self._name = lib, name

    def __getattr__(self, name):
        if name == self._name:
            return lambda *args: 719
        return getattr(self._lib, name)


def test_a_failed_batched_launch_raises_without_falling_back(cuda, monkeypatch):
    """A batched K2 or K4 call whose launch fails raises, and launches
    nothing else: no K1, K3 or plain version in its place."""
    from gps_optimize_slam_tpu_torch.ops import _build

    lib = _build.library()
    gen = torch.Generator().manual_seed(15)
    x = torch.stack([chip_smoke.scan_inputs("mobius", scan.BATCH_TILED_MIN_ROW, gen, torch.float64, cuda)
                     for _ in range(8)], 1)
    assert scan.scan_route(4, x.shape[-1], 8, x.shape[1], "mobius") == "tiled"
    traj = torch.stack([walk(gen, 700, torch.float64, cuda) for _ in range(2)])
    cands = torch.stack([walk(gen, kernels.GRID_MIN_CANDIDATES, torch.float64, cuda) for _ in range(2)])
    mask = torch.ones(cands.shape[:2], dtype=torch.bool, device=cuda)
    for entry, call in (("gps_scan_tiled", lambda: scan.associative_scan("mobius", x.contiguous())),
                        ("gps_nn_grid", lambda: kernels.nn_min_dist2(traj, cands.contiguous(), mask))):
        monkeypatch.setattr(_build, "library", lambda e=entry: _FailingLaunch(lib, e))
        before = (dict(scan.scan_block.launches), dict(scan.scan_tiled.launches), kernels.nn_resident.launches,
                  kernels.nn_grid.launches)
        with pytest.raises(RuntimeError, match="CUDA error 719"):
            call()
        assert (scan.scan_block.launches, scan.scan_tiled.launches, kernels.nn_resident.launches,
                kernels.nn_grid.launches) == before


# The captured programs (``utils.graphs``): graph against eager dispatch on
# the same card, float64, ≤1e-9 m (the bound of the batched rows) with
# masks and ``ok`` flags equal; statistics ≤1e-9 relative; offsets equal.


def graph_inputs(n, device, seed=3):
    """One replica sequence of ``n`` poses on ``device`` (float64): slam
    times, positions, quaternions, GNSS times, positions and validity."""
    import numpy as np

    slam, gt, gp = chip_smoke.replica_sequence(n, seed=seed)
    return [torch.as_tensor(a, device=device) for a in (slam["timestamps"], slam["positions"],
                                                        slam["quaternions"], gt, gp, np.ones(len(gt), bool))]


def graph_batch(ns=(601, 701, 801)):
    from gps_optimize_slam_tpu_torch.parallel import batch as pbatch

    seqs = [chip_smoke.replica_sequence(n, seed=s) for s, n in enumerate(ns)]
    return pbatch.pad_batch([s for s, _, _ in seqs], [t for _, t, _ in seqs], [p for _, _, p in seqs])


def entry_point(name, device):
    """A callable for each entry point that ``utils.graphs`` captures on a
    card, and how its result reads as (positions, masks) to compare."""
    from gps_optimize_slam_tpu_torch.config import FusionConfig
    from gps_optimize_slam_tpu_torch.models import fusion
    from gps_optimize_slam_tpu_torch.parallel import mesh, seqpar

    cfg = FusionConfig(gps_sorted=True)
    if name in ("fuse_core", "fuse_core_short_gnss", "evaluate", "evaluate_vs_track"):
        t = graph_inputs(200 if name == "fuse_core_short_gnss" else 1101, device)  # 200 poses: a dense spline
        if name.startswith("fuse_core"):
            return lambda: fusion.fuse_core(*t, cfg, seed=2)
        out = fusion.fuse_core(*t, cfg, seed=2)
        if name == "evaluate":
            return lambda: fusion.evaluate(t[0], t[1], out)
        track = graph_inputs(1101, device, seed=9)
        return lambda: fusion.evaluate_vs_track(t[0], t[1], out, track[3], track[4], track[5], cfg)[0]
    b = graph_batch()
    if name == "fuse_batch":
        return lambda: mesh.fuse_batch(b, device=device)
    if name == "mesh_shards":
        return lambda: mesh.fuse_batch(b, mesh=mesh.make_mesh(devices=[device] * 3))
    if name == "evaluate_batch":
        out = mesh.fuse_batch(b, device=device)
        return lambda: mesh.evaluate_batch(b, out)
    if name == "estimate_offsets_batch":
        return lambda: torch.as_tensor(mesh.estimate_offsets_batch(b, device=device))
    args = seqpar_case(4001, device)
    return lambda: seqpar.fuse_ekf_rts_seqparallel(mesh.make_mesh(devices=[device] * 4), *args)


def same_result(got, want, bound):
    """Every tensor leaf of two results within ``bound`` (relative to the
    leaf's magnitude + 1), booleans and integers equal."""
    import torch.utils._pytree as pytree

    for a, b in zip(pytree.tree_leaves(got), pytree.tree_leaves(want), strict=True):
        a, b = torch.as_tensor(a), torch.as_tensor(b)
        if a.dtype in (torch.bool, torch.int32, torch.int64):
            assert torch.equal(a, b)
        else:
            assert chip_smoke.rel_err(a.double().reshape(1, -1), b.double().reshape(1, -1)) <= bound


ENTRY_POINTS = ["fuse_core", "fuse_core_short_gnss", "evaluate", "evaluate_vs_track", "fuse_batch", "mesh_shards",
                "evaluate_batch", "estimate_offsets_batch", "seqpar"]


@pytest.mark.parametrize("name", ENTRY_POINTS)
def test_replayed_programs_equal_eager_dispatch(cuda, name):
    """Each entry point's first call runs eagerly, its second captures and
    replays, its third replays; all equal the same call under
    ``graphs.eager()``: every float leaf within 1e-12 of its magnitude
    (positions of a few kilometres: ≤1e-9 m, the batched rows' bound),
    masks, counts and ``ok`` flags equal."""
    from gps_optimize_slam_tpu_torch.utils import graphs

    call = entry_point(name, cuda)
    with graphs.eager():
        want = call()
    graphs.clear()  # an earlier test may hold a program of the same key
    graphs.reset_stats()
    first = call()
    assert graphs.stats()["first_calls"] >= 1
    if name not in ("mesh_shards", "seqpar"):  # their shards (blocks) repeat a key within one call
        assert graphs.stats()["captures"] == 0
    second = call()
    got = call()
    torch.cuda.synchronize()
    st = graphs.stats()
    assert st["captures"] >= 1 and st["replays"] >= 2 and st["pool_bytes"] > 0
    for res in (first, second, got):
        same_result(res, want, 1e-12)


def test_programs_of_many_long_shapes_share_one_pool(cuda):
    """Twelve logs of distinct lengths (30,000-41,000 poses), each fused
    twice (the second call captures), with nothing cleared between: the
    programs share the device's pool, which grows by their held outputs and
    not by a working set a program. It stays within three times the pool
    of the longest log's program alone plus the held outputs (a pool a
    program took about ten times that pool), and the last replay equals
    eager dispatch."""
    from gps_optimize_slam_tpu_torch.config import FusionConfig
    from gps_optimize_slam_tpu_torch.models import fusion
    from gps_optimize_slam_tpu_torch.utils import graphs

    cfg = FusionConfig(gps_sorted=True)
    lengths = [30_000 + 1_000 * k for k in range(12)]
    graphs.clear()
    torch.cuda.empty_cache()
    graphs.reset_stats()
    for n in lengths:
        t = graph_inputs(n, cuda, seed=n)
        fusion.fuse_core(*t, cfg, seed=2)
        got = fusion.fuse_core(*t, cfg, seed=2)
    torch.cuda.synchronize()
    shared = graphs.stats()
    assert shared["captures"] == 12 and shared["programs"] == 12
    with graphs.eager():
        same_result(got, fusion.fuse_core(*t, cfg, seed=2), 1e-12)
    graphs.clear()
    torch.cuda.empty_cache()
    fusion.fuse_core(*t, cfg, seed=2)
    fusion.fuse_core(*t, cfg, seed=2)
    alone = graphs.stats()["pool_bytes"]
    assert 0 < shared["pool_bytes"] <= 3 * alone + shared["output_bytes"], (shared, alone)


def test_a_replay_leaves_earlier_results_unchanged(cuda):
    """Two replays of one program on other inputs: the first result keeps
    its values (each replay hands out clones of the graph's outputs)."""
    from gps_optimize_slam_tpu_torch.config import FusionConfig
    from gps_optimize_slam_tpu_torch.models import fusion

    t = graph_inputs(1101, cuda)
    cfg = FusionConfig(gps_sorted=True)
    fusion.fuse_core(*t, cfg, seed=2)
    a = fusion.fuse_core(*t, cfg, seed=2)  # captured and replayed
    kept = a.corrected_pos.clone()
    b = fusion.fuse_core(t[0], t[1] + 3.0, *t[2:], cfg, seed=2)
    torch.cuda.synchronize()
    assert torch.equal(a.corrected_pos, kept) and not torch.equal(b.corrected_pos, kept)
    assert b.corrected_pos.data_ptr() != a.corrected_pos.data_ptr()


def test_replays_count_the_launches_of_eager_dispatch(cuda):
    """N replays add N times the launches of one eager call, kernel by
    kernel: the counts read the same for graph and eager runs."""
    from gps_optimize_slam_tpu_torch.config import FusionConfig
    from gps_optimize_slam_tpu_torch.models import fusion
    from gps_optimize_slam_tpu_torch.utils import graphs

    t = graph_inputs(1101, cuda)
    cfg = FusionConfig(gps_sorted=True)

    def run():
        out = fusion.fuse_core(*t, cfg, seed=2)
        return fusion.evaluate(t[0], t[1], out)

    run()
    chip_smoke.reset_launch_counts()
    with graphs.eager():
        run()
    torch.cuda.synchronize()
    eager = chip_smoke.launch_counts()
    chip_smoke.reset_launch_counts()
    for _ in range(3):
        run()
    torch.cuda.synchronize()
    assert chip_smoke.launch_counts() == {k: 3 * v for k, v in eager.items()}
    assert eager["ransac_counts"] == 1 and eager["nn_resident"] == 3 and eager["nn_keep"] == 3


def test_a_replay_passes_with_every_host_synchronisation_an_error(cuda):
    """``fuse_core`` (its seeded uniforms drawn before the program) and
    ``evaluate`` replayed under ``set_sync_debug_mode("error")``: nothing
    is read back."""
    from gps_optimize_slam_tpu_torch.config import FusionConfig
    from gps_optimize_slam_tpu_torch.models import fusion

    t = graph_inputs(1101, cuda)
    cfg = FusionConfig(gps_sorted=True)
    for _ in range(2):  # the first call runs eagerly, the second captures
        fusion.evaluate(t[0], t[1], fusion.fuse_core(*t, cfg, seed=2))
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = fusion.fuse_core(*t, cfg, seed=2)
        ev = fusion.evaluate(t[0], t[1], out)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert bool(torch.isfinite(out.corrected_pos).all()) and ev.nn_ekf.rmse.shape == ()


def test_shards_on_two_cards_replay_in_flight_together(cuda, monkeypatch):
    """Two shards, one a card, each replaying its program from a host
    thread of its card: both shards' calls wait at a barrier of two, so the
    run ends only if both are issued before either finishes; the rows equal
    the unsharded batch's ≤1e-9 m."""
    import threading

    from gps_optimize_slam_tpu_torch.parallel import mesh

    first, second = two_cards()
    b = graph_batch((601, 701, 801, 651))
    m = mesh.make_mesh(devices=[first, second])
    want = mesh.fuse_batch(b, device=first)
    for _ in range(2):  # eager, then each shard's program captured on its card
        mesh.fuse_batch(b, mesh=m)
    barrier = threading.Barrier(2, timeout=60)
    original = mesh.fuse_batch

    def waiting(batch, *args, **kw):
        if kw.get("mesh") is None:  # a shard's own call
            barrier.wait()
        return original(batch, *args, **kw)

    monkeypatch.setattr(mesh, "fuse_batch", waiting)
    got = original(b, mesh=m)
    torch.cuda.synchronize()
    assert float((got.corrected_pos - want.corrected_pos).abs().max()) <= 1e-9
    assert torch.equal(got.sim3_inliers, want.sim3_inliers) and bool(got.ok.all())


# The programs of the pose graph, the robust gate and the chunked streams
# (``utils.graphs``): replays against eager dispatch on the same card,
# float64: ≤1e-9 m (the refine with closures ≤1e-6 m, as the card is held
# to the CPU: a refinement with closures can move far under a tiny change
# of its start), masks, counts and flags equal.


def refine_case(device, n=900):
    from gps_optimize_slam_tpu_torch import pipeline

    slam, gt, gp = chip_smoke.shuttle_sequence(n)
    return pipeline.fuse_arrays(slam, chip_smoke.shuttle_gps(gt, gp), dtype=torch.float64, device=device)


def program_entry_point(name, device):
    """A callable for each path whose programs this slice captures, and how
    far its result may be from eager dispatch."""
    import numpy as np

    from gps_optimize_slam_tpu_torch import pipeline
    from gps_optimize_slam_tpu_torch.config import FusionConfig
    from gps_optimize_slam_tpu_torch.models import fusion, fusion_chunked, robust

    if name.startswith("refine"):
        res = refine_case(device)
        kw = dict(iterations=3, cg_iters=50, propose_loops=name == "refine_loops", loop_radius=5.0,
                  loop_min_time_gap=30.0, max_loops=32)
        return (lambda: pipeline.refine_pose_graph(res, **kw)[0]), (1e-6 if name == "refine_loops" else 1e-9)
    if name.startswith("robust"):
        slam, gt, gps, _, _ = robust_case(1101)
        t = [torch.as_tensor(a, dtype=torch.float64, device=device)
             for a in (slam["timestamps"], slam["positions"], slam["quaternions"], gt, gps.positions)]
        cfg = FusionConfig(gps_sorted=True)
        out = fusion.fuse_core(*t, torch.as_tensor(gps.valid, device=device), cfg, seed=2)
        gate = name.split("_")[1]
        return (lambda: robust.fuse_robust(t[0], t[1], t[2], out.sim3_pos, out.sim3_quat, out.aligned_gps,
                                           out.gps_valid, n_iterations=12, gate_mode=gate)), 1e-9
    slam, gt, gp = chip_smoke.outage_sequence(70_000)
    st, sp, sq = slam["timestamps"], slam["positions"], slam["quaternions"]
    cfg = FusionConfig(gps_sorted=True)

    def fuse(**kw):
        return fusion_chunked.fuse_core_chunked(st, sp, sq, gt, gp, np.ones(len(gt), bool), config=cfg,
                                                chunk_size=16_384, dtype=torch.float64, device=device, **kw)

    if name == "chunked_fuse":
        return fuse, 1e-9
    if name == "chunked_robust":
        return (lambda: fuse(robust=True, robust_iterations=6)), 1e-9
    res = fuse()
    return (lambda: fusion_chunked.evaluate_chunked(st, sp, sq, res, chunk_size=16_384, dtype=torch.float64,
                                                    device=device)), 1e-9


def leaves_within(got, want, bound):
    """Every float leaf (tensors, arrays, floats) within ``bound`` in absolute
    terms, booleans and integers equal."""
    import numpy as np
    import torch.utils._pytree as pytree

    for a, b in zip(pytree.tree_leaves(got), pytree.tree_leaves(want), strict=True):
        if a is None or b is None:
            assert a is None and b is None
            continue
        a, b = np.asarray(torch.as_tensor(a).cpu()), np.asarray(torch.as_tensor(b).cpu())
        if a.dtype.kind in "biu":
            np.testing.assert_array_equal(a, b)
        else:
            same = (a == b) | (np.isnan(a) & np.isnan(b))
            assert np.where(same, 0.0, np.abs(a - b)).max(initial=0.0) <= bound


@pytest.mark.parametrize("name", ["refine", "refine_loops", "robust_parallel", "robust_sequential", "chunked_fuse",
                                  "chunked_robust", "chunked_evaluate"])
def test_new_programs_replay_equal_eager_dispatch(cuda, name):
    """Each path's first call runs its programs' keys eagerly (a refine
    step's key and a full chunk's recur within one call, so they capture
    there), later calls replay; all equal the same call under
    ``graphs.eager()``."""
    from gps_optimize_slam_tpu_torch.utils import graphs

    call, bound = program_entry_point(name, cuda)
    with graphs.eager():
        want = call()
    graphs.clear()
    graphs.reset_stats()
    first, second, got = call(), call(), call()
    torch.cuda.synchronize()
    st = graphs.stats()
    assert st["captures"] >= 1 and st["replays"] >= 2, st
    for res in (first, second, got):
        leaves_within(res, want, bound)


def test_grid_nn_kernel_reads_its_count_on_the_device(cuda):
    """K4 with the grid sized from the card and the work list's length read
    on the device equals K3 bit for bit, also with its grid capped at three
    blocks (each drawing many items): a random walk, shuffled candidates
    (long lists, every block walking several items), a batch of rows with
    an all-masked one; and a CUDA graph holds the launch."""
    from gps_optimize_slam_tpu_torch.utils import graphs

    gen = torch.Generator().manual_seed(21)
    for dtype in (torch.float32, torch.float64):
        cases = []
        t, c = walk(gen, 16_384, dtype, cuda), walk(gen, 300_000, dtype, cuda, offset=0.3)
        cases.append((t, c, (torch.rand(300_000, generator=gen) > 0.1).to(cuda)))
        t, c = walk(gen, 700, dtype, cuda), walk(gen, 524_288, dtype, cuda, offset=0.3)
        c = c[torch.randperm(524_288, generator=gen).to(cuda)].contiguous()
        cases.append((t, c, (torch.rand(524_288, generator=gen) > 0.1).to(cuda)))
        t = torch.stack([walk(gen, 700, dtype, cuda) for _ in range(3)])
        c = torch.stack([walk(gen, 100_000, dtype, cuda, offset=0.3)[torch.randperm(100_000, generator=gen).to(cuda)]
                         for _ in range(3)]).contiguous()
        mask = (torch.rand(3, 100_000, generator=gen) > 0.1).to(cuda)
        mask[1] = False
        cases.append((t, c, mask))
        for traj, cands, mask in cases:
            operands = kernels.nn_grid_operands(traj, cands, mask)
            device_count = kernels.grid_launch(traj, operands)
            capped = kernels.grid_launch(traj, operands, 3)
            k3 = kernels.nn_resident(traj, cands, mask)
            graphs.run(kernels.nn_grid, traj, cands, mask)
            graphs.run(kernels.nn_grid, traj, cands, mask)  # captured and replayed
            replayed = graphs.run(kernels.nn_grid, traj, cands, mask)
            torch.cuda.synchronize()
            assert torch.equal(device_count, k3) and torch.equal(capped, k3) and torch.equal(replayed, k3)


def recorded_program_calls(device, monkeypatch):
    """(name, fn, args) of the first call of each program that the refine
    (with closures), both robust gates, the chunked robust fusion and
    evaluation and a subsampled streamed Sim(3) hand to ``graphs.run`` on
    the card, run eagerly to record them."""
    import numpy as np

    from gps_optimize_slam_tpu_torch import pipeline
    from gps_optimize_slam_tpu_torch.config import Sim3RansacConfig
    from gps_optimize_slam_tpu_torch.ops import alignment_chunked
    from gps_optimize_slam_tpu_torch.utils import graphs

    seen = {}

    def record(fn, *args, **kwargs):
        assert not kwargs
        seen.setdefault(fn.__name__, (fn, args))
        return fn(*args)

    monkeypatch.setattr(graphs, "run", record)
    res = refine_case(device, 600)
    pipeline.refine_pose_graph(res, iterations=1, loop_radius=5.0, loop_min_time_gap=30.0)
    for name in ("robust_parallel", "robust_sequential", "chunked_robust", "chunked_evaluate"):
        program_entry_point(name, device)[0]()
    rng = np.random.default_rng(5)
    src = rng.normal(size=(2000, 3)) * 30
    alignment_chunked.sim3_ransac_streaming(src, 1.3 * src + 5.0, np.ones(2000, bool), cfg=Sim3RansacConfig(),
                                            max_ransac_points=256, chunk_size=300, device=device)
    monkeypatch.undo()
    return seen


def test_new_program_replays_pass_with_every_host_synchronisation_an_error(cuda, monkeypatch):
    """Each program of this slice, on the inputs its path gave it: eager,
    captured, and then replayed under ``set_sync_debug_mode("error")``:
    nothing is read back inside a replay."""
    from gps_optimize_slam_tpu_torch.utils import graphs

    seen = recorded_program_calls(cuda, monkeypatch)
    assert {"_gn_step", "_propose_loop_closures", "_fuse_robust_parallel", "_final_fusion", "forward_chunk",
            "_backward_chunk", "_gate_chunk", "_align_chunk", "_nn_block", "transform_trajectory",
            "paired_errors", "_moments_pass1", "_moments_pass2", "_refit"} <= set(seen)
    for name, (fn, args) in seen.items():
        graphs.run(fn, *args)
        graphs.run(fn, *args)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            graphs.run(fn, *args)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()


def test_a_failed_capture_of_a_new_program_raises(cuda, monkeypatch):
    """A gate pass that reads a device value on the host inside the robust
    parallel program: its first call runs eagerly, the capture of its
    second raises (a synchronisation inside a capture), nothing falls back,
    and no program is kept for the key; the same inputs then run eagerly."""
    from gps_optimize_slam_tpu_torch.models import robust
    from gps_optimize_slam_tpu_torch.utils import graphs

    call, _ = program_entry_point("robust_parallel", cuda)
    real = robust._parallel_nis

    def reading(*args):
        accepted, nis = real(*args)
        float(nis.sum())  # the host read
        return accepted, nis

    monkeypatch.setattr(robust, "_parallel_nis", reading)
    graphs.clear()
    graphs.reset_stats()
    call()
    with pytest.raises(RuntimeError):
        call()
    torch.cuda.synchronize()
    assert graphs.stats()["programs"] == 0 and graphs.stats()["captures"] == 0
    monkeypatch.undo()
    with graphs.eager():
        assert call().gate_converged


# The chunk streams (``utils.streaming``): pinned staging on the card's
# upload stream, read-back on its download stream after the chunk's own
# event. A launch that holds the card (``torch.cuda._sleep``, ~0.1 s a
# chunk) shows what each host call waits for.

SLEEP_CYCLES = 200_000_000


def test_drain_and_stage_return_while_a_chunk_runs(cuda):
    """(a) ``drain(i-1)``'s ``numpy()`` returns while chunk i's work is not
    done; (b) ``stage(i+1)`` (``to_device``) returns while chunk i runs;
    every chunk's values come through, in order."""
    import numpy as np

    from gps_optimize_slam_tpu_torch.utils import streaming

    handles, ran_during_stage, ran_during_drain, drained = [], [], [], []

    def stage(i):
        out = streaming.to_device((np.full(1000, float(i)),), cuda)
        if handles:  # chunk i-1 was launched: is it still running?
            ran_during_stage.append(not handles[-1].ready.query())
        return out

    def launch(i, staged):
        torch.cuda._sleep(SLEEP_CYCLES)
        handles.append(streaming.fetch((staged[0] * 2,)))
        return handles[-1]

    def drain(i, fetched):
        (x,) = fetched.numpy()
        if i + 1 < len(handles):
            ran_during_drain.append(not handles[i + 1].ready.query())
        drained.append(float(x[0]))

    torch.cuda.synchronize()
    streaming.stream_chunks(range(4), stage, launch, drain)
    torch.cuda.synchronize()
    assert drained == [0.0, 2.0, 4.0, 6.0]
    assert ran_during_stage == [True] * 3 and ran_during_drain == [True] * 3
    # The download of chunk i-1 started before chunk i's work was done.
    for prev, nxt in zip(handles, handles[1:]):
        assert prev.started.elapsed_time(nxt.ready) > 0 and prev.copied.elapsed_time(nxt.ready) > 0


def test_to_device_and_fetch_on_the_card(cuda):
    """``to_device`` gives the values, dtypes and shapes of its host inputs
    (a NumPy array, a non-contiguous view, a bool mask, a pinned
    ``host_buffer``, a 0-d array); ``fetch`` of non-contiguous and bool
    tensors gives ``.cpu()``'s values into pinned host tensors; a tensor
    already on the card is refused."""
    import numpy as np

    from gps_optimize_slam_tpu_torch.utils import streaming

    rng = np.random.default_rng(3)
    a = rng.normal(size=(50, 6))
    mask = rng.uniform(size=50) > 0.5
    buf = streaming.host_buffer((50, 3), np.float32, cuda)
    buf.numpy()[:] = a[:, :3]
    assert buf.is_pinned()
    inputs = (a, a[:, ::2], mask, buf, np.asarray(2.5))
    got = streaming.to_device(inputs, cuda)
    for g, x in zip(got, inputs):
        x = x.numpy() if isinstance(x, torch.Tensor) else x
        assert g.is_cuda and g.shape == x.shape and g.dtype == torch.from_numpy(np.asarray(x)).dtype
        np.testing.assert_array_equal(g.cpu().numpy(), x)
    t = got[0].T  # non-contiguous
    fetched = streaming.fetch((t, got[2], got[4]))
    assert all(h.is_pinned() for h in fetched.hosts) and fetched.nbytes == t.numel() * 8 + 50 + 8
    for h, want in zip(fetched.numpy(), (t, got[2], got[4])):
        np.testing.assert_array_equal(h, want.cpu().numpy())
    with pytest.raises(ValueError, match="host data"):
        streaming.to_device((got[0],), cuda)


def chunked_stream_calls(device):
    """The chunk streams of this slice at 70,000 poses, 16,384-pose chunks
    (five chunks a stream) and a three-bucket sweep of replica sequences,
    float64: callables of the chunked fusion, its evaluation, the robust
    chunked fusion and ``fuse_buckets``."""
    import numpy as np

    from gps_optimize_slam_tpu_torch.config import FusionConfig
    from gps_optimize_slam_tpu_torch.models import fusion_chunked
    from gps_optimize_slam_tpu_torch.parallel import batch as pbatch
    from gps_optimize_slam_tpu_torch.parallel import mesh

    slam, gt, gps, _, _ = robust_case(70_000)
    st, sp, sq = slam["timestamps"], slam["positions"], slam["quaternions"]
    cfg = FusionConfig(gps_sorted=True)

    def fuse(**kw):
        return fusion_chunked.fuse_core_chunked(st, sp, sq, gt, gps.positions, gps.valid, config=cfg,
                                                chunk_size=16_384, dtype=torch.float64, device=device, **kw)

    res = fuse()
    seqs = [chip_smoke.replica_sequence(n, seed=s) for n, s in ((1101, 1), (2801, 2), (1201, 3), (5001, 4))]
    buckets = pbatch.bucket_by_length([s for s, _, _ in seqs], [t for _, t, _ in seqs], [p for _, _, p in seqs],
                                      max_waste=1.5)
    return {
        "chunked_fuse": fuse,
        "chunked_evaluate": lambda: fusion_chunked.evaluate_chunked(st, sp, sq, res, chunk_size=16_384,
                                                                    dtype=torch.float64, device=device),
        "chunked_robust": lambda: fuse(robust=True, robust_iterations=8),
        "fuse_buckets": lambda: mesh.fuse_buckets(buckets, config=FusionConfig(), device=device,
                                                  dtype=torch.float64),
    }, len(buckets)


@pytest.mark.parametrize("name", ["chunked_fuse", "chunked_evaluate", "chunked_robust", "fuse_buckets"])
def test_chunk_streams_replayed_equal_eager_and_never_copy_pageable(cuda, name, monkeypatch):
    """Each chunk stream, its programs replayed, equals the same call under
    ``graphs.eager()`` bit for bit (the same kernels on the same inputs),
    and the calls stage through ``to_device`` and read back through
    ``fetch`` only: ``torch.as_tensor`` onto a card and ``Tensor.cpu`` of a
    card's tensor raise inside them."""
    from gps_optimize_slam_tpu_torch.utils import graphs

    calls, n_buckets = chunked_stream_calls(cuda)
    assert n_buckets >= 2
    call = calls[name]
    with graphs.eager():
        want = call()
    real_as_tensor, real_cpu = torch.as_tensor, torch.Tensor.cpu

    def as_tensor(data, *args, **kwargs):
        device = kwargs.get("device", args[1] if len(args) > 1 else None)
        if device is not None and torch.device(device).type == "cuda":
            raise AssertionError("a pageable torch.as_tensor onto the card")
        return real_as_tensor(data, *args, **kwargs)

    def cpu(self, *args, **kwargs):
        if self.is_cuda:
            raise AssertionError("a .cpu() read-back on a chunk stream")
        return real_cpu(self, *args, **kwargs)

    monkeypatch.setattr(torch, "as_tensor", as_tensor)
    monkeypatch.setattr(torch.Tensor, "cpu", cpu)
    graphs.clear()
    first, second, got = call(), call(), call()
    torch.cuda.synchronize()
    monkeypatch.undo()
    for res in (first, second, got):
        leaves_within(res, want, 0.0)


def test_chunked_fusion_on_the_card_matches_in_core(cuda):
    """The chunked fusion at 70,000 poses in 16,384-pose chunks against
    ``fusion.fuse_core`` on the same arrays and seed on the card: ≤1e-6 m,
    quaternions ≤1e-8, scale ≤1e-9 relative (the JAX package's bounds for
    chunked against in-core)."""
    import numpy as np

    from gps_optimize_slam_tpu_torch.config import FusionConfig
    from gps_optimize_slam_tpu_torch.models import fusion

    calls, _ = chunked_stream_calls(cuda)
    res = calls["chunked_fuse"]()
    slam, gt, gps, _, _ = robust_case(70_000)
    t = [torch.as_tensor(a, device=cuda) for a in (slam["timestamps"], slam["positions"], slam["quaternions"], gt,
                                                  gps.positions, gps.valid)]
    ref = fusion.fuse_core(*t, FusionConfig(gps_sorted=True), seed=0)
    assert res.ok and bool(ref.ok)
    assert np.abs(res.corrected_pos - ref.corrected_pos.cpu().numpy()).max() <= 1e-6
    assert np.abs(res.corrected_quat - ref.corrected_quat.cpu().numpy()).max() <= 1e-8
    assert abs(float(res.sim3.scale) - float(ref.sim3.scale)) <= 1e-9 * abs(float(ref.sim3.scale))


# The tracer (``utils.profiling``) on the card: device marks captured into a
# program run on every replay; each program's kernel nodes are counted at
# capture.


@pytest.fixture
def tracer(monkeypatch):
    """The tracer's state fresh for one test, as in tests/test_torch_profiling.py
    (this file imports no other test module)."""
    from gps_optimize_slam_tpu_torch.utils import profiling

    monkeypatch.setattr(profiling, "_ON", False)
    for name in ("_SPANS", "_MARKS"):
        monkeypatch.setattr(profiling, name, [])
    for name in ("_COUNTS", "_COUNTER_SLOTS", "_RINGS"):
        monkeypatch.setattr(profiling, name, {})
    monkeypatch.setattr(profiling, "_LOST", {"dropped": 0, "unpaired": 0})
    yield profiling


def kept_graphs(monkeypatch):
    """Programs captured from here on keep their ``cudaGraph_t``
    (``CUDAGraph(keep_graph=True)``: instantiated at the first replay), so
    that its nodes can be read back."""
    real = torch.cuda.CUDAGraph
    monkeypatch.setattr(torch.cuda, "CUDAGraph", lambda: real(keep_graph=True))


def raw_kernel_nodes(program) -> int:
    """The kernel nodes of a held program's graph, read from the graph."""
    from gps_optimize_slam_tpu_torch.ops import _build

    return int(_build.library().gps_graph_kernel_nodes(program.graph.raw_cuda_graph()))


def held_programs(device) -> dict:
    from gps_optimize_slam_tpu_torch.utils import graphs

    index = device.index if device.index is not None else torch.cuda.current_device()
    dev = graphs._DEVICES.get(torch.device("cuda", index))
    return {} if dev is None else dict(dev.programs)


def test_a_traced_program_writes_its_marks_on_every_replay(cuda, tracer, monkeypatch):
    """A program with a device span and a device counter, called five
    times with the tracer on (eager, captured and replayed, three replays):
    its marks come back from every call, each replay's inside that replay's
    own marks, all within the host's clock around the calls; the counter
    holds every call's sum; ``graph.kernels`` four times the graph's kernel
    nodes. Each capture, traced or not, counted its kernel nodes right (the
    graph read back); the traced graph holds the untraced one's two, its
    two marks and the counter's own."""
    import time

    from gps_optimize_slam_tpu_torch.utils import graphs, profiling

    def marked(x):
        with profiling.device_span("body", x.device):
            y = x * 2.0 + 1.0
        if profiling.enabled():
            profiling.count_device("positive", (y > 0).sum())
        return y

    kept_graphs(monkeypatch)
    x = torch.arange(1000, dtype=torch.float64, device=cuda)
    graphs.clear()
    for _ in range(2):
        graphs.run(marked, x)
    (untraced,) = held_programs(cuda).values()
    tracer.enable()
    tracer.reset()
    t0 = time.time_ns()
    outs = [graphs.run(marked, x + k) for k in range(5)]
    torch.cuda.synchronize()
    t1 = time.time_ns()
    rec = tracer.records()
    tracer.disable()
    traced = next(p for p in held_programs(cuda).values() if p is not untraced)
    counts = (untraced.kernels, raw_kernel_nodes(untraced), traced.kernels, raw_kernel_nodes(traced))
    graphs.clear()
    for k, y in enumerate(outs):
        assert torch.equal(y, (x + k) * 2.0 + 1.0)
    body = sorted(m for m in rec["marks"] if m[0] == "body")
    replays = sorted(m for m in rec["marks"] if m[0] == "graphs.replay")
    assert len(body) == 5 and len(replays) == 4 and rec["dropped"] == 0 and rec["unpaired"] == 0
    for r, b in zip(replays, body[1:]):
        assert r[2] <= b[2] <= b[3] <= r[3]
    assert all(t0 - 50_000 <= m[2] <= m[3] <= t1 + 50_000 for m in rec["marks"])
    assert rec["device_counts"] == {"positive": 5000.0}
    assert counts[0] == counts[1] == 2 and counts[2] == counts[3] >= 2 + 2 + 3  # mul, add; 2 marks; gt, sum, add_
    assert rec["counts"]["graph.kernels:marked"] == 4 * counts[2]


def test_evaluation_records_its_spans_and_nn_counters_only_when_traced(cuda, tracer):
    """``mesh.evaluate_batch`` on a staged batch of two long rows (the keep
    lists and K3 by the route), three calls with the tracer on (eager,
    captured, replayed): each records ``eval.nn_slam``, ``eval.nn_sim3``,
    ``eval.nn_ekf`` and ``eval.ate`` in order, a replay's inside its
    ``graphs.replay`` marks; ``nn.tiles_kept`` holds three calls' sums of
    every NN call's ``nkept`` (the keep lists rebuilt untraced) and
    ``nn.tiles_total`` three calls' B × n_tiles × m_tiles of each; the
    statistics equal the untraced ones bit for bit. Off, three more calls
    record nothing."""
    import numpy as np

    from gps_optimize_slam_tpu_torch.ops import metrics
    from gps_optimize_slam_tpu_torch.parallel import batch as pbatch
    from gps_optimize_slam_tpu_torch.parallel import mesh
    from gps_optimize_slam_tpu_torch.utils import graphs
    from portbench.traffic.kinds import resampled

    rng = np.random.default_rng(7)
    drives = [resampled.resampled_sequence(n, 100.0, 2, rng, 0.02) for n in (30_000, 26_000)]
    b = pbatch.pad_batch([d[0] for d in drives], [d[1] for d in drives], [d[2] for d in drives])
    staged = mesh.stage_batch(b, device=cuda)
    out = mesh.fuse_batch(staged)
    graphs.clear()
    want = mesh.evaluate_batch(staged, out)
    st, sp = staged.args[:2]
    gate = metrics.eval_mask(st, out.gps_valid)
    cands = torch.nan_to_num(out.aligned_gps, nan=0.0)
    kept = sum(float(kernels.keep_lists(traj.contiguous(), cands, gate)[1].sum())
               for traj in (sp, out.sim3_pos, out.corrected_pos))
    n_tiles, m_tiles = kernels._tiles(st.shape[1], st.shape[1])
    tracer.enable()
    tracer.reset()
    got = [mesh.evaluate_batch(staged, out) for _ in range(3)]
    rec = tracer.records()
    tracer.disable()
    for ev in got:
        for a, w in zip(torch.utils._pytree.tree_leaves(ev), torch.utils._pytree.tree_leaves(want)):
            assert torch.equal(a, w)
    names = ["eval.nn_slam", "eval.nn_sim3", "eval.nn_ekf", "eval.ate"]
    marks = sorted((m for m in rec["marks"] if m[0].startswith("eval.")), key=lambda m: m[2])
    replays = sorted(m for m in rec["marks"] if m[0] == "graphs.replay")
    assert [m[0] for m in marks] == names * 3 and len(replays) == 2 and rec["dropped"] == rec["unpaired"] == 0
    for r, call in zip(replays, (marks[4:8], marks[8:])):
        assert all(r[2] <= m[2] <= m[3] <= r[3] for m in call)
    assert 0 < kept < 3 * 2 * n_tiles * m_tiles
    assert rec["device_counts"] == {"nn.tiles_kept": 3 * kept}
    assert rec["counts"]["nn.tiles_total"] == 3 * 3 * 2 * n_tiles * m_tiles
    tracer.reset()
    for _ in range(3):
        mesh.evaluate_batch(staged, out)
    rec = tracer.records()
    graphs.clear()
    assert rec["marks"] == [] and rec["counts"] == {} and rec["device_counts"] == {"nn.tiles_kept": 0.0}


def test_cell_programs_untraced_hold_no_trace_nodes(cuda, tracer, monkeypatch):
    """The benchmark's four bucket programs (``batch-kitti22``) and its
    Gauss-Newton step (``refine-kitti00``), captured with the tracer off and
    on: each capture's kernel count equals its graph's kernel nodes read
    back, and an untraced program holds exactly the traced one's nodes less
    its marks (the fusion's five stages: 10; the step's linearisation and
    CG: 4) and the step's counter (``cg.iters_active``: the nodes of a
    program that only adds the CG kernel's int32 count into a counter)."""
    from gps_optimize_slam_tpu_torch.utils import graphs, profiling
    from portbench import harness

    def flow(name):
        cell = harness.cell(name)
        return harness.flow_class(cell["flow"])(cell, harness.config(cell["config"]), 7, [cuda], harness.Spans())

    def count_active(active):
        profiling.count_device("active", active)

    kept_graphs(monkeypatch)
    graphs.clear()
    tracer.enable()
    active = torch.tensor(50, dtype=torch.int32, device=cuda)
    graphs.run(count_active, active)
    graphs.run(count_active, active)
    (counter,) = held_programs(cuda).values()
    assert counter.kernels == raw_kernel_nodes(counter) == 1
    tracer.disable()
    batch, refine = flow("batch-kitti22"), flow("refine-kitti00")
    nodes = {}
    for traced in (False, True):
        graphs.clear()
        if traced:
            tracer.enable()
        batch.request(0)
        batch.request(1)  # captures the bucket programs
        refine.request(0)  # its second step captures the step
        torch.cuda.synchronize()
        tracer.disable()
        for key, program in held_programs(cuda).items():
            if program.name in ("_fuse_core", "_gn_step"):
                assert program.kernels == raw_kernel_nodes(program) > 0, program.name
                nodes.setdefault(traced, {})[(program.name, key[3])] = program.kernels
    graphs.clear()
    assert sorted(name for name, _ in nodes[False]) == ["_fuse_core"] * 4 + ["_gn_step"]
    assert nodes[False].keys() == nodes[True].keys()
    for (name, shapes), n in nodes[False].items():
        assert nodes[True][(name, shapes)] - n == (10 if name == "_fuse_core" else 4 + counter.kernels), name
