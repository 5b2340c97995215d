"""The compiled programs of the pose graph, the robust gate and the chunked
streams (``utils.graphs`` on a card), on the CPU, where no graph is
captured.

* Capture safety: every body these paths hand to ``graphs.run`` runs under
  ``FakeTensorMode``, which raises on any read of a tensor's value on the
  host (a read would synchronise, and a synchronisation inside a capture
  raises): one Gauss-Newton step (``torch.func``'s pullbacks run under it),
  the loop-closure proposal, the robust parallel fusion and the sequential
  gate's final fusion, and each chunk body of the chunked filter, gate,
  alignment, streamed Sim(3), transform, NN and ATE, each as its entry
  point calls it.
* The robust parallel program (its ``while_loop`` run as masked passes)
  against the JAX package's ``_fuse_robust`` in float64, at the bounds of
  tests/test_torch_robust.py (masks equal, NIS ≤1e-9 relative, positions
  ≤1e-8 m, quaternions ≤1e-10): one case that converges before the cap and
  one that the cap cuts.
* ``_gn_step`` in a loop equals ``solve_pose_graph`` bit for bit; the
  lifted chunk bodies equal the closures they replace bit for bit (the
  streamed Sim(3)'s accumulators, the NN running minimum).
* Keys: every step of a solve and of each checkpoint round has one key, and
  so does every full chunk of each chunk body.
* K4's ticket walk (a grid of resident blocks drawing the items of a work
  list whose length they read on the device) emulated: the exact minimum,
  equal to the one-block-an-item walk, with the wrapper's grid bound never
  below the list's length.
"""

import numpy as np
import pytest
import torch

from gps_optimize_slam_tpu.models import robust as jrobust
from gps_optimize_slam_tpu_torch.config import EKFConfig, RTSDecisionConfig, Sim3RansacConfig
from gps_optimize_slam_tpu_torch.models import fusion_chunked, pose_graph, robust
from gps_optimize_slam_tpu_torch.ops import alignment_chunked, kalman_chunked, kernels, metrics
from gps_optimize_slam_tpu_torch.ops import quaternion as quat
from gps_optimize_slam_tpu_torch.ops.umeyama import umeyama_sim3_from_moments
from gps_optimize_slam_tpu_torch.utils import graphs
from tests.test_fusion_chunked import _scenario as fusion_scenario
from tests.test_torch_graphs import under_fake_mode
from tests.test_torch_kernels import emulate_grid_kernel, kernel_d2, kernel_min_dist2, walk
from tests.test_torch_robust import PASSES, jarr, scenario, tens


def recorded_runs(monkeypatch, fake: bool = True):
    """Patch ``graphs.run`` to record (function name, key) of each call and,
    with ``fake``, run the body under fake mode first (any host read
    raises), then for real."""
    calls = []

    def run(fn, *args, **kwargs):
        calls.append((fn.__name__, graphs.key_of(fn, *args, **kwargs)))
        if fake:
            under_fake_mode(lambda *a: fn(*a, **kwargs), *args)
        return fn(*args, **kwargs)

    monkeypatch.setattr(graphs, "run", run)
    return calls


def keys_of(calls, name):
    return [k for n, k in calls if n == name]


def pose_graph_problem(n=60, seed=0, loops=True):
    """A noisy chain with GNSS priors on most poses and, with ``loops``,
    the closures the proposal finds on a path that returns to its start."""
    rng = np.random.default_rng(seed)
    s = np.linspace(0.0, 2 * np.pi, n)
    gt_pos = np.stack([20 * np.cos(s), 20 * np.sin(s), 0.1 * s], -1)
    yaw = s + np.pi / 2
    gt_quat = np.stack([np.zeros(n), np.zeros(n), np.sin(yaw / 2), np.cos(yaw / 2)], -1)
    pos = torch.tensor(gt_pos + rng.normal(size=gt_pos.shape) * 0.3)
    q = quat.normalize(torch.tensor(gt_quat + rng.normal(size=gt_quat.shape) * 0.01))
    valid = torch.tensor(rng.uniform(size=n) > 0.2)
    kw = {}
    if loops:
        times = torch.tensor(np.arange(n) * 1.0)
        loop_ij, loop_dp, loop_dq, loop_valid = pose_graph.propose_loop_closures(
            torch.tensor(gt_pos), times, torch.tensor(gt_quat), radius=8.0, min_time_gap=30.0, max_loops=4)
        assert bool(loop_valid.any())
        kw = dict(loop_ij=loop_ij, loop_dp=loop_dp, loop_dq=loop_dq, loop_valid=loop_valid)
    data = pose_graph.build_data_from_fusion(torch.tensor(gt_pos), torch.tensor(gt_quat),
                                             torch.tensor(gt_pos) + 0.05, valid, **kw)
    return pose_graph.PoseGraphState(pos, q), data


def test_gn_step_in_a_loop_equals_solve_pose_graph(monkeypatch):
    """Each step of ``solve_pose_graph`` goes through ``graphs.run`` with
    one key and reads nothing on the host; stepping by hand gives the
    solve's states and cost history bit for bit."""
    init, data = pose_graph_problem()
    calls = recorded_runs(monkeypatch)
    res = pose_graph.solve_pose_graph(init, data, iterations=4, cg_iters=20)
    steps = keys_of(calls, "_gn_step")
    assert len(steps) == 4 and len(set(steps)) == 1
    state, cost = init, pose_graph._cost(init, data)
    costs = [cost]
    for _ in range(4):
        state, cost = pose_graph._gn_step(state, data, 20, 1e-6, cost)
        costs.append(cost)
    assert torch.equal(res.state.positions, state.positions)
    assert torch.equal(res.state.quaternions, quat.normalize(state.quaternions))
    assert torch.equal(res.cost_history, torch.stack(costs))
    assert float(res.final_cost) < float(res.cost_history[0])


def test_checkpoint_rounds_replay_one_key(monkeypatch, tmp_path):
    """Three rounds of two steps, then a resumed run: every step of every
    round has the key of the first."""
    init, data = pose_graph_problem(loops=False)
    calls = recorded_runs(monkeypatch, fake=False)
    whole = pose_graph.solve_pose_graph_checkpointed(init, data, iterations=6, cg_iters=20, checkpoint_every=2,
                                                    checkpoint_dir=str(tmp_path / "a"))
    pose_graph.solve_pose_graph_checkpointed(init, data, iterations=2, cg_iters=20, checkpoint_every=2,
                                             checkpoint_dir=str(tmp_path / "b"))
    resumed = pose_graph.solve_pose_graph_checkpointed(init, data, iterations=6, cg_iters=20, checkpoint_every=2,
                                                      checkpoint_dir=str(tmp_path / "b"))
    steps = keys_of(calls, "_gn_step")
    assert len(steps) == 12 and len(set(steps)) == 1
    assert torch.equal(whole.state.positions, resumed.state.positions)
    assert torch.equal(whole.cost_history, resumed.cost_history)


def test_loop_proposal_program_reads_no_value_on_the_host(monkeypatch):
    calls = recorded_runs(monkeypatch)
    pose_graph_problem(loops=True)
    assert [n for n, _ in calls] == ["_propose_loop_closures"]


def robust_program(arrays, n_iterations, scan="auto"):
    return robust._fuse_robust_parallel(*tens(arrays), EKFConfig(), RTSDecisionConfig(), robust.CHI2_3DOF_95,
                                        n_iterations, scan)


@pytest.mark.parametrize("n_iterations", [2, PASSES])
def test_masked_passes_equal_jax_fuse_robust(n_iterations, monkeypatch):
    """As a capture runs it (``graphs.capturing()``: every pass, masked).
    The scenario's adjacent outliers need more than two passes: at two the
    cap cuts the gate (``changed`` stays set, as JAX's ``gate_converged``
    is False), at eight it converges before the cap (the passes after the
    fixed point keep its mask and NIS)."""
    arrays = scenario()
    want = jrobust._fuse_robust(*jarr(arrays), n_iterations=n_iterations, platform="cpu", gate_mode="parallel")
    calls = []
    real = robust._parallel_nis
    monkeypatch.setattr(robust, "_parallel_nis", lambda *a: calls.append(1) or real(*a))
    monkeypatch.setattr(graphs, "capturing", lambda: True)
    pos, q, accepted, nis, changed = robust_program(arrays, n_iterations)
    assert len(calls) == n_iterations
    assert bool(changed) == (not bool(np.asarray(want.gate_converged))) == (n_iterations == 2)
    np.testing.assert_array_equal(accepted.numpy(), np.asarray(want.accepted))
    np.testing.assert_allclose(nis.numpy(), np.asarray(want.nis), rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(pos.numpy(), np.asarray(want.positions), atol=1e-8, rtol=0)
    np.testing.assert_allclose(q.numpy(), np.asarray(want.quaternions), atol=1e-10, rtol=0)


def test_masked_passes_equal_the_early_stop(monkeypatch):
    """Eagerly the loop stops at the fixed point (a host read a pass); the
    masked passes a capture runs, at the cap and at twice it, give every
    output of the early stop bit for bit."""
    arrays = scenario()
    early = robust_program(arrays, PASSES)
    monkeypatch.setattr(graphs, "capturing", lambda: True)
    for n in (PASSES, 2 * PASSES):
        masked = robust_program(arrays, n)
        assert not bool(masked[4])
        for x, y in zip(masked, early):
            assert torch.equal(x, y)


@pytest.mark.parametrize("gate", ["parallel", "sequential"])
def test_robust_programs_read_no_value_on_the_host(monkeypatch, gate):
    """As a capture runs them (``graphs.capturing()``); ``scan="parallel"``:
    the associative filters the card's "auto" takes."""
    calls = recorded_runs(monkeypatch)
    monkeypatch.setattr(graphs, "capturing", lambda: True)
    res = robust.fuse_robust(*tens(scenario()), gate_mode=gate, scan="parallel", n_iterations=PASSES)
    assert [n for n, _ in calls] == ["_fuse_robust_parallel" if gate == "parallel" else "_final_fusion"]
    assert res.gate_converged is True


def chunked_fusion(monkeypatch, fake=True, **kw):
    (st, sp, sq), (gt, gp, gv) = fusion_scenario(n=600)
    calls = recorded_runs(monkeypatch, fake)
    res = fusion_chunked.fuse_core_chunked(st, sp, sq, gt, gp, gv, chunk_size=128, halo=24, device="cpu", **kw)
    fusion_chunked.evaluate_chunked(st, sp, sq, res, chunk_size=128, device="cpu")
    return calls, res


@pytest.mark.parametrize("robust_gate", [False, True])
def test_chunk_bodies_read_no_value_on_the_host_and_full_chunks_share_a_key(monkeypatch, robust_gate):
    """600 poses in 128-pose chunks: every body of the chunked fusion and
    evaluation runs under fake mode, and its full chunks (the filter's,
    the gate's and the alignment's are padded to the chunk shape, so all
    of theirs) share one key; a ragged last transform or ATE chunk is a
    key of its own."""
    calls, res = chunked_fusion(monkeypatch, robust=robust_gate, robust_iterations=3)
    names = {n for n, _ in calls}
    body = {"forward_chunk", "_backward_chunk", "_align_chunk", "transform_trajectory", "_nn_block",
            "paired_errors"} | ({"_gate_chunk"} if robust_gate else set())
    assert names == body
    for name in ("forward_chunk", "_backward_chunk", "_align_chunk", "_gate_chunk", "_nn_block"):
        if name in names:
            assert len(keys_of(calls, name)) >= 4 and len(set(keys_of(calls, name))) == 1, name
    # 600 = 4 x 128 + 88: the ATE chunks of two trajectories, four full and one ragged a trajectory.
    ate = keys_of(calls, "paired_errors")
    assert len(ate) == 10 and len(set(ate)) == 2
    assert res.ok and np.isfinite(res.corrected_pos).all()


def test_streamed_sim3_passes_equal_the_closures_they_replace(monkeypatch):
    """The subsampled fit's two moment passes and its refit, each a program
    reading no host value and one key for its full chunks, equal bit for
    bit the accumulator closures they replace (written out here)."""
    rng = np.random.default_rng(5)
    n = 2000
    src = rng.normal(size=(n, 3)) * 30
    R_true = np.array([[0.36, 0.48, -0.8], [-0.8, 0.6, 0.0], [0.48, 0.64, 0.6]])
    dst = 1.3 * src @ R_true.T + np.array([5.0, -2.0, 1.0]) + rng.normal(size=(n, 3)) * 0.01
    dst[::37] += 50.0
    mask = np.ones(n, bool)
    calls = recorded_runs(monkeypatch)
    got = alignment_chunked.sim3_ransac_streaming(src, dst, mask, cfg=Sim3RansacConfig(), max_ransac_points=256,
                                                  chunk_size=300, seed=3, device="cpu")
    assert got.subsampled and bool(got.sim3.ok)
    for name, count in (("_moments_pass1", 7), ("_moments_pass2", 7), ("_refit", 1)):
        keys = keys_of(calls, name)
        assert len(keys) == count and len(set(keys)) == min(count, 2), name  # six full chunks, a ragged one

    # The closures as they were, on the fit's own model.
    sub = np.arange(n)[:: -(-n // 256)]
    res = alignment_chunked.ransac.sim3_ransac(torch.tensor(src[sub]), torch.tensor(dst[sub]),
                                               cfg=Sim3RansacConfig(), seed=3)
    R, t, s = res.sim3.R, res.sim3.t, res.sim3.scale
    thr2 = float(Sim3RansacConfig().residual_threshold) ** 2
    f64 = torch.float64
    acc = {"w": torch.zeros((), dtype=f64), "s": torch.zeros(3, dtype=f64), "d": torch.zeros(3, dtype=f64)}
    ws = []
    for a in range(0, n, 300):
        sc, dc = torch.tensor(src[a : a + 300]), torch.tensor(dst[a : a + 300])
        w = torch.sum((s * (sc @ R.T) + t - dc) ** 2, dim=-1) < thr2
        wf = w.to(f64)
        acc["w"] = acc["w"] + torch.sum(wf)
        acc["s"] = acc["s"] + wf @ sc.to(f64)
        acc["d"] = acc["d"] + wf @ dc.to(f64)
        ws.append(wf)
    mu_s = acc["s"] / torch.clamp(acc["w"], min=1.0)
    mu_d = acc["d"] / torch.clamp(acc["w"], min=1.0)
    H, v = torch.zeros((3, 3), dtype=f64), torch.zeros((), dtype=f64)
    for a, wf in zip(range(0, n, 300), ws):
        sc, dc = torch.tensor(src[a : a + 300]) - mu_s, torch.tensor(dst[a : a + 300]) - mu_d
        H = H + (wf[:, None] * sc).T @ dc
        v = v + torch.sum(wf * torch.sum(sc**2, dim=-1))
    want = umeyama_sim3_from_moments(acc["w"], mu_s, mu_d, tuple(tuple(H[i, j] for i in range(3))
                                                                  for j in range(3)), v)
    assert got.num_inliers == int(acc["w"])
    assert torch.equal(got.sim3.R, want.R) and torch.equal(got.sim3.t, want.t)
    assert torch.equal(got.sim3.scale, want.scale)


def test_nn_blocks_equal_the_running_minimum_closure(monkeypatch):
    """The streamed NN metric with its block fold a program equals the fold
    written out (the closure it replaces) bit for bit: 300 queries against
    700 candidates in blocks of 128."""
    rng = np.random.default_rng(4)
    traj = np.cumsum(rng.normal(size=(300, 3)), 0)
    cands = np.cumsum(rng.normal(size=(700, 3)), 0)
    cmask, tmask = rng.uniform(size=700) > 0.2, rng.uniform(size=300) > 0.1
    calls = recorded_runs(monkeypatch)
    got = fusion_chunked.nn_errors_streamed(lambda a, b: traj[a:b], 300, cands, cmask, tmask, chunk_size=128,
                                            device="cpu")
    assert len(set(keys_of(calls, "_nn_block"))) == 1 and len(keys_of(calls, "_nn_block")) == 3 * 6
    def pad_rows(x, size):
        return np.concatenate([x, np.zeros((size - len(x), 3))])

    want = np.full(300, np.inf)
    for a in range(0, 300, 128):
        q = pad_rows(traj[a : a + 128], 128)
        qm = np.zeros(128, bool)
        qm[: len(traj[a : a + 128])] = tmask[a : a + 128]
        running = torch.full((128,), float("inf"), dtype=torch.float64)
        for c in range(0, 700, 128):
            cm = np.zeros(128, bool)
            cm[: len(cands[c : c + 128])] = cmask[c : c + 128]
            e = metrics.nn_errors_auto(torch.tensor(q), torch.tensor(pad_rows(cands[c : c + 128], 128)),
                                       torch.tensor(qm), torch.tensor(cm))
            running = torch.minimum(running, e)
        want[a : a + 128] = running[: len(traj[a : a + 128])].numpy()
    np.testing.assert_array_equal(got, want)


def emulate_ticket_grid_kernel(traj, cands, mask, blocks, rng):
    """K4 as csrc/nn_grid.cu walks it with no host read: the wrapper sizes
    the grid from the card (``blocks``) and the most items the lists could
    hold; each block reads the list's length (the last entry of ``ends``)
    and draws tickets from a counter zeroed before the launch until a
    ticket passes the length. Resident blocks draw in an order the card
    decides (here at random), each folding its items' minima into an
    output prefilled with +inf."""
    order, nkept, cand3, ends = (x.numpy() for x in kernels.nn_grid_operands(traj, cands, mask))
    bound = ends.size * -(-order.shape[-1] // kernels.RUN_TILES)  # grid_launch's most items
    grid = min(bound, blocks)
    length = int(ends[-1])  # read by every block on the device
    assert length <= bound
    counter, live, done = 0, list(range(grid)), []
    a = traj.numpy()
    out = np.full(len(a), np.inf)
    while live:
        blk = live[rng.integers(len(live))]
        b, counter = counter, counter + 1  # atomicAdd(ticket, 1)
        if b >= length:
            live.remove(blk)
            continue
        done.append(b)
        i = int(np.searchsorted(ends, b, side="right"))
        k0 = (b - (ends[i - 1] if i else 0)) * kernels.RUN_TILES
        rows = slice(i * kernels.TILE_N, min(len(a), (i + 1) * kernels.TILE_N))
        q = a[rows]
        for k in range(k0, min(nkept[i], k0 + kernels.RUN_TILES)):
            d = kernel_d2(q, cand3[order[i, k]])  # (3, TILE_M) tile, +inf where masked
            out[rows] = np.fmin(out[rows], np.fmin.reduce(d, axis=1))
    assert sorted(done) == list(range(length))  # every item once
    return out


@pytest.mark.parametrize("blocks", [1, 3, 396, 10_000])
@pytest.mark.parametrize("n,m,shuffle", [(2000, 3000, False), (700, 9000, True)])
def test_ticket_grid_walk_gives_the_exact_minimum(n, m, shuffle, blocks):
    """Fewer blocks than items (each block draws several), one block, the
    card's 132 SMs x 3 float64 blocks, and more blocks than items: the
    minimum equals the one-block-an-item walk and the brute force with the
    kernels' arithmetic exactly, the plain version to its rounding."""
    rng = np.random.default_rng(n + m + blocks)
    traj = torch.tensor(walk(rng, n, 1.0))
    c = walk(rng, m, 1.0, offset=2.0)
    cands = torch.tensor(c[rng.permutation(m)] if shuffle else c)
    mask = torch.tensor(rng.uniform(size=m) > 0.1)
    got = emulate_ticket_grid_kernel(traj, cands, mask, blocks, rng)
    np.testing.assert_array_equal(got, emulate_grid_kernel(traj, cands, mask)[0])
    np.testing.assert_array_equal(got, kernel_min_dist2(traj, cands, mask))
    np.testing.assert_allclose(got, kernels.nn_min_dist2_plain(traj, cands, mask).numpy(), rtol=1e-14)


def test_forward_chunks_of_the_chunked_filter_share_one_key(monkeypatch):
    """``fuse_ekf_rts_chunked`` over 5 chunks of 32 steps (the last padded):
    one forward and one backward key, five calls each."""
    arrays = scenario(n=150, outliers=[])
    calls = recorded_runs(monkeypatch, fake=False)
    kalman_chunked.fuse_ekf_rts_chunked(*arrays[:3], arrays[3][0], arrays[4][0], *arrays[5:], chunk_size=32,
                                        device="cpu")
    for name in ("forward_chunk", "_backward_chunk"):
        keys = keys_of(calls, name)
        assert len(keys) == 5 and len(set(keys)) == 1, name


def test_a_mesh_scan_fn_runs_the_chunk_body_as_called(monkeypatch):
    """With a ``scan_fn`` the chunk body is not a program of its own (its
    scans' blocks run theirs): ``run_chunk`` calls it directly."""
    calls = recorded_runs(monkeypatch, fake=False)
    seen = []
    out = kalman_chunked.run_chunk(lambda *a: seen.append(a) or "called", 1, 2, scan_fn="mesh scan")
    assert out == "called" and seen == [(1, 2, "mesh scan")] and not calls

    def body(x, scan_fn):
        return x + 1

    assert torch.equal(kalman_chunked.run_chunk(body, torch.zeros(3)), torch.ones(3))
    assert [n for n, _ in calls] == ["body"]
