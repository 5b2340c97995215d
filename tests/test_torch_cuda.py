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
    K4, and the two agree bit for bit with each other and with the plain
    version to its tolerance."""
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
