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
bounds of the JAX package's own chunked tests.
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
    tile = scan.block_tile(op)
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
    last block, more than 256 query tiles (the larger block size),
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


def plain_keep_lists(traj, cands, mask):
    return kernels.keep_lists_plain(kernels.tile_keep_mask(*kernels.bounds_operands(traj, cands, mask)))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_keep_list_kernel_equals_plain_lists(cuda, dtype):
    """The keep-list kernel's lists equal the plain mask's compaction
    exactly (the same float64 bounds in the same order; its tile-level test
    is exact), and its packed candidates equal the plain packing bit for
    bit. Cases: seq-02's length, ragged shapes, one candidate tile, UTM
    magnitudes, shuffled candidates (every tile kept), two and four query
    tiles a block with a ragged last block (529 and 1,058 query tiles),
    more candidate tiles than the kernel holds boxes of in shared memory
    (977), non-finite coordinates, whole tiles and runs of segments masked
    out, and each with every candidate masked (no finite upper bound, so
    every tile is kept, as in the JAX mask)."""
    gen = torch.Generator().manual_seed(5)
    cases = [(4661, 4661, 0.0, False), (300, 777, 0.0, False), (5, 1, 0.0, False),
             (2000, 9000, 5.4e6, False), (700, 9000, 0.0, True), (67_700, 3000, 0.0, False),
             (135_300, 5000, 0.0, False), (2000, 1_000_000, 0.0, False), (2000, 9000, 0.0, False),
             (1000, 3000, 0.0, False)]
    for k, (n, m, offset, shuffle) in enumerate(cases):
        traj, cands = walk(gen, n, dtype, cuda, offset), walk(gen, m, dtype, cuda, offset + 0.3)
        if shuffle:
            cands = cands[torch.randperm(m, generator=gen).to(cuda)].contiguous()
        mask = (torch.rand(m, generator=gen) > 0.1).to(cuda)
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
            before = kernels.keep_lists.launches
            order, nkept, cand4 = kernels.keep_lists(traj, cands, mk)
            assert kernels.keep_lists.launches == before + 1
            want_order, want_nkept = plain_keep_lists(traj, cands, mk)
            assert torch.equal(nkept, want_nkept), (n, m)
            cols = torch.arange(order.shape[1], device=cuda)[None] < nkept[:, None]
            assert torch.equal(torch.where(cols, order, -1), torch.where(cols, want_order, -1)), (n, m)
            assert torch.equal(chip_smoke.same_bits(cand4), chip_smoke.same_bits(kernels.pack_candidates_plain(cands, mk, order.shape[1])))


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


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_batched_keep_lists_and_nn_kernel_match_plain_and_each_row(cuda, dtype):
    """The keep lists and K3 with a batch grid: ragged rows with an
    all-masked one; B = 1; 8 rows of seq-02's length (296 query tiles, so
    the batch takes K3's 32-query blocks while each row alone takes the
    16-query ones) and, in float64, UTM magnitudes."""
    gen = torch.Generator().manual_seed(8)
    cases = [((300, 150, 1, 300), (1500, 700, 1025, 9), 0.0), ((5,), (1,), 0.0), ((4661,) * 8, (4661,) * 8, 0.0)]
    if dtype == torch.float64:
        cases.append(((4661, 2000, 3000), (4661, 4661, 900), 5.4e6))
    for ns, ms, offset in cases:
        traj, cands, mask = chip_smoke.ragged_walks(gen, ns, ms, dtype, cuda, offset)
        before = (kernels.keep_lists.launches, kernels.nn_resident.launches)
        order, nkept, cand4 = kernels.keep_lists(traj, cands, mask)
        got = kernels.nn_min_dist2(traj, cands, mask)
        assert (kernels.keep_lists.launches, kernels.nn_resident.launches) == (before[0] + 2, before[1] + 1)
        torch.cuda.synchronize()
        want = kernels.nn_min_dist2_plain(traj, cands, mask, block=256)
        torch.testing.assert_close(got, want, rtol=1e-5 if dtype == torch.float32 else 1e-12, atol=0.0)
        want_order, want_nkept = plain_keep_lists(traj, cands, mask)
        assert torch.equal(nkept, want_nkept)
        cols = torch.arange(order.shape[-1], device=cuda) < nkept[..., None]
        assert torch.equal(torch.where(cols, order, -1), torch.where(cols, want_order, -1))
        assert torch.equal(chip_smoke.same_bits(cand4), chip_smoke.same_bits(kernels.pack_candidates_plain(cands, mask, order.shape[-1])))
        for r in range(len(ns)):
            o1, k1, c1 = kernels.keep_lists(traj[r], cands[r], mask[r])
            c = torch.arange(o1.shape[-1], device=cuda) < k1[:, None]
            assert torch.equal(k1, nkept[r]) and torch.equal(torch.where(c, o1, -1), torch.where(c, order[r], -1))
            assert torch.equal(chip_smoke.same_bits(c1), chip_smoke.same_bits(cand4[r]))
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
    """A batch of rows past K1's route of at most
    ``BATCH_TILED_MAX_ELEMENTS`` elements launches K2's grid, a larger one
    K1's; a few query tiles against ``GRID_MIN_CANDIDATES`` candidates
    launch K4's grid, many K3's; each batched call once."""
    gen = torch.Generator().manual_seed(14)
    n = scan.BLOCK_MAX_ELEMENTS + 1
    most = scan.BATCH_TILED_MAX_ELEMENTS // n
    for B, kernel in ((most, scan.scan_tiled), (most + 1, scan.scan_block)):
        x = torch.stack([chip_smoke.scan_inputs("add2", n, gen, torch.float64, cuda) for _ in range(B)], 1)
        before = (dict(scan.scan_block.launches), dict(scan.scan_tiled.launches))
        scan.associative_scan("add2", x.contiguous())
        after = (scan.scan_block.launches, scan.scan_tiled.launches)
        moved = {k.__name__: after[i]["add2"] - before[i]["add2"] for i, k in enumerate((scan.scan_block, scan.scan_tiled))}
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
    x = torch.stack([chip_smoke.scan_inputs("filter", 70_001, gen, torch.float64, cuda) for _ in range(2)], 1)
    traj = torch.stack([walk(gen, 700, torch.float64, cuda) for _ in range(2)])
    cands = torch.stack([walk(gen, kernels.GRID_MIN_CANDIDATES, torch.float64, cuda) for _ in range(2)])
    mask = torch.ones(cands.shape[:2], dtype=torch.bool, device=cuda)
    for entry, call in (("gps_scan_tiled", lambda: scan.associative_scan("filter", x.contiguous())),
                        ("gps_nn_grid", lambda: kernels.nn_min_dist2(traj, cands.contiguous(), mask))):
        monkeypatch.setattr(_build, "library", lambda e=entry: _FailingLaunch(lib, e))
        before = (dict(scan.scan_block.launches), dict(scan.scan_tiled.launches), kernels.nn_resident.launches,
                  kernels.nn_grid.launches)
        with pytest.raises(RuntimeError, match="CUDA error 719"):
            call()
        assert (scan.scan_block.launches, scan.scan_tiled.launches, kernels.nn_resident.launches,
                kernels.nn_grid.launches) == before
