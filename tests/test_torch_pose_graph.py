"""The port's pose graph (``models.pose_graph``, ``pipeline.refine_pose_graph``)
on the CPU in float64: the JAX package's own pose-graph tests
(tests/test_extensions.py) run on the port, and the same inputs from a seed
go through both packages.

Tolerances, against the JAX package: ``exp_map``/``log_map`` and their jvps
≤1e-12 (the same formulas; at the guard points ω = 0 and w = 1.0 the
derivatives are equal, the clip's 0.5 included); residuals and one
Hessian-vector product ≤1e-10 relative; ``solve_pose_graph`` and the
refinement of seq-04: state ≤1e-8 m, quaternions ≤1e-10, cost history
≤1e-9 relative (the products and CG's dot products sum in another order);
``propose_loop_closures``: ``loop_ij`` equal in every row, invalid rows
included, the measurements ≤1e-12. The port against itself: a resumed
checkpointed solve equals the uninterrupted one bit for bit.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

from gps_optimize_slam_tpu import pipeline as jpipeline
from gps_optimize_slam_tpu.models import fusion as jfusion
from gps_optimize_slam_tpu.models import pose_graph as jpg
from gps_optimize_slam_tpu.ops import quaternion as jquat
from gps_optimize_slam_tpu.ops.umeyama import Sim3 as JSim3
from gps_optimize_slam_tpu_torch import pipeline
from gps_optimize_slam_tpu_torch.models import fusion
from gps_optimize_slam_tpu_torch.models import pose_graph
from gps_optimize_slam_tpu_torch.ops import quaternion as quat
from gps_optimize_slam_tpu_torch.ops import se3
from gps_optimize_slam_tpu_torch.ops.umeyama import Sim3
from tests.test_extensions import integrate_odometry, make_drifting_graph
from tests.test_torch_profiling import tracer  # noqa: F401

GOLDEN = "tests/golden/seq04_golden.npz"


def T(a, dtype=torch.float64):
    return torch.as_tensor(np.asarray(a)).to(dtype)


def rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


def drifting_problem(n=60, seed=0, drift=0.02, gps_every=4, loops=None):
    """The drifting loop of the JAX tests: (state, data) in the port, built
    from numpy, with the measured (noisy) odometry."""
    gt_pos, gt_quat, dp, dq = make_drifting_graph(n=n, seed=seed, drift=drift)
    init_pos, init_quat = integrate_odometry(gt_pos[0], gt_quat[0], dp, dq)
    gps_valid = np.zeros(n, bool)
    gps_valid[::gps_every] = True
    data = pose_graph.build_data_from_fusion(T(init_pos), T(init_quat), T(gt_pos), torch.as_tensor(gps_valid),
                                             **(loops or {}))
    data = data._replace(odo_dp=T(dp), odo_dq=T(dq))
    return pose_graph.PoseGraphState(T(init_pos), T(init_quat)), data, gt_pos, gt_quat


# The JAX package's pose-graph tests (tests/test_extensions.py), on the port.


def test_pose_graph_gps_priors_remove_drift():
    init, data, gt_pos, _ = drifting_problem()
    drift_err = np.linalg.norm(init.positions.numpy() - gt_pos, axis=1).max()
    assert drift_err > 0.1  # odometry alone drifts
    res = pose_graph.solve_pose_graph(init, data, iterations=8)
    costs = res.cost_history.numpy()
    assert costs[-1] < costs[0] * 0.1
    final_err = np.linalg.norm(res.state.positions.numpy() - gt_pos, axis=1)
    assert final_err.max() < drift_err * 0.5
    assert final_err.mean() < 0.15


def test_pose_graph_loop_closure():
    gt_pos, gt_quat, _, _ = make_drifting_graph(seed=3, drift=0.05)
    n = len(gt_pos)
    # One loop closure: the last pose sees the first (true relative).
    ldp, ldq = se3.relative_pose(T(gt_pos[n - 1]), T(gt_quat[n - 1]), T(gt_pos[0]), T(gt_quat[0]))
    loops = dict(loop_ij=torch.tensor([[n - 1, 0]]), loop_dp=ldp[None], loop_dq=ldq[None],
                 loop_valid=torch.tensor([True]))
    init, data, gt_pos, _ = drifting_problem(seed=3, drift=0.05, gps_every=n + 1, loops=loops)  # anchor pose 0 only
    init_gap = np.linalg.norm(init.positions.numpy()[-1] - gt_pos[-1])
    res = pose_graph.solve_pose_graph(init, data, iterations=10)
    p = res.state.positions.numpy()
    final_gap = np.linalg.norm(p[-1] - p[0] - (gt_pos[-1] - gt_pos[0]))
    assert final_gap < init_gap * 0.2
    assert float(res.final_cost) < float(res.cost_history[0]) * 0.2


def test_pose_graph_exact_inputs_zero_cost():
    gt_pos, gt_quat, _, _ = make_drifting_graph(drift=0.0)
    data = pose_graph.build_data_from_fusion(T(gt_pos), T(gt_quat), T(gt_pos), torch.ones(len(gt_pos), dtype=torch.bool))
    res = pose_graph.solve_pose_graph(pose_graph.PoseGraphState(T(gt_pos), T(gt_quat)), data, iterations=2)
    assert float(res.final_cost) < 1e-12


def test_quaternion_exp_log_roundtrip():
    rng = np.random.default_rng(5)
    w = rng.normal(size=(64, 3))
    q = quat.exp_map(T(w)).numpy()
    dots = np.abs(np.sum(q * Rotation.from_rotvec(w).as_quat(), axis=-1))  # scipy's rotvec convention
    np.testing.assert_allclose(dots, 1.0, atol=1e-12)
    w2 = quat.log_map(T(q)).numpy()
    small = np.linalg.norm(w, axis=1) < np.pi  # log∘exp is the identity for |w| < π
    np.testing.assert_allclose(w2[small], w[small], atol=1e-9)
    z = quat.log_map(quat.exp_map(torch.zeros((1, 3), dtype=torch.float64)))
    np.testing.assert_allclose(z.numpy(), 0.0, atol=1e-12)


def test_propose_loop_closures_finds_revisit():
    """A loop that comes back to its start yields exactly one (suppressed)
    closure pairing the revisit with the first pass."""
    n = 120
    ang = np.linspace(0, 2 * np.pi, n)
    pos = np.stack([np.cos(ang) * 20 - 20, np.sin(ang) * 20, np.zeros(n)], -1)
    quats = Rotation.from_euler("z", (ang + np.pi / 2)[:, None]).as_quat()
    loop_ij, loop_dp, _, loop_valid = pose_graph.propose_loop_closures(
        T(pos), T(np.arange(n) * 1.0), T(quats), radius=3.0, min_time_gap=30.0, max_loops=8)
    lv = loop_valid.numpy()
    ij = loop_ij.numpy()[lv]
    assert lv.sum() == 1, ij
    i, j = ij[0]
    assert j >= n - 3 and i <= 2
    assert np.linalg.norm(loop_dp.numpy()[lv][0]) < 3.0


def test_propose_loop_closures_no_false_positives():
    n = 80
    pos = np.stack([np.arange(n) * 2.0, np.zeros(n), np.zeros(n)], -1)
    _, _, _, loop_valid = pose_graph.propose_loop_closures(
        T(pos), T(np.arange(n) * 1.0), T(np.tile([0.0, 0.0, 0.0, 1.0], (n, 1))), radius=5.0, min_time_gap=10.0,
        max_loops=8)
    assert not loop_valid.any()


def test_proposed_closures_close_a_drifting_loop():
    """Closures proposed from the drifted estimate, measured from the true
    local geometry (as ``refine_pose_graph`` reads them from the Sim3
    trajectory), pull a drifting loop back together."""
    gt_pos, gt_quat, dp, dq = make_drifting_graph(n=60, seed=7, drift=0.05)
    init_pos, init_quat = integrate_odometry(gt_pos[0], gt_quat[0], dp, dq)
    n = len(gt_pos)
    loop_ij, _, _, loop_valid = pose_graph.propose_loop_closures(
        T(init_pos), T(np.arange(n) * 1.0), T(init_quat), radius=8.0, min_time_gap=20.0, max_loops=4)
    assert loop_valid.any()
    i_sel, j_sel = loop_ij[:, 0], loop_ij[:, 1]
    qinv = quat.conj(quat.normalize(T(gt_quat)[i_sel]))
    loops = dict(loop_ij=loop_ij, loop_dp=quat.rotate(qinv, T(gt_pos)[j_sel] - T(gt_pos)[i_sel]),
                 loop_dq=quat.mul(qinv, quat.normalize(T(gt_quat)[j_sel])), loop_valid=loop_valid)
    init, data, _, _ = drifting_problem(seed=7, drift=0.05, gps_every=n + 1, loops=loops)
    res = pose_graph.solve_pose_graph(init, data, iterations=10)
    p = res.state.positions.numpy()
    init_gap = np.linalg.norm(init_pos[-1] - init_pos[0] - (gt_pos[-1] - gt_pos[0]))
    final_gap = np.linalg.norm(p[-1] - p[0] - (gt_pos[-1] - gt_pos[0]))
    assert final_gap < init_gap * 0.25, (final_gap, init_gap)


def test_pose_graph_checkpoint_resume(tmp_path):
    """Killed after 4 of 6 iterations and resumed, the checkpointed solve
    equals the uninterrupted checkpointed one bit for bit, and the plain
    solve to the JAX package's own bound."""
    init, data, _, _ = drifting_problem(n=40, seed=2)
    ref = pose_graph.solve_pose_graph(init, data, iterations=6)
    whole = pose_graph.solve_pose_graph_checkpointed(init, data, iterations=6, checkpoint_every=2,
                                                     checkpoint_dir=str(tmp_path / "whole"))
    ckdir = str(tmp_path / "pg_ckpt")
    partial = pose_graph.solve_pose_graph_checkpointed(init, data, iterations=4, checkpoint_every=2,
                                                       checkpoint_dir=ckdir)
    assert partial.cost_history.shape == (5,)
    res = pose_graph.solve_pose_graph_checkpointed(init, data, iterations=6, checkpoint_every=2, checkpoint_dir=ckdir)
    for a, b in zip(res.state, whole.state):
        assert torch.equal(a, b)
    assert torch.equal(res.cost_history, whole.cost_history) and res.cost_history.shape == (7,)
    np.testing.assert_allclose(res.state.positions.numpy(), ref.state.positions.numpy(), atol=1e-12)
    np.testing.assert_allclose(res.cost_history.numpy(), ref.cost_history.numpy(), rtol=1e-12)
    # A finished run restores at once: no Gauss-Newton step runs.
    again = pose_graph.solve_pose_graph_checkpointed(init, data, iterations=6, checkpoint_every=2,
                                                     checkpoint_dir=ckdir)
    assert torch.equal(again.state.positions, res.state.positions)


@pytest.mark.parametrize("metadata_file", ["one_round_behind", "missing"])
def test_pose_graph_resume_survives_a_kill_between_the_two_renames(metadata_file, tmp_path):
    """A run killed after the state rename of its second round and before the
    metadata rename leaves round 2's state beside round 1's ``metadata.json``:
    the resume continues from round 2 with round 2's cost history. Without a
    ``metadata.json`` (killed in its first round) no checkpoint counts and the
    run starts over. Either way, the result equals the uninterrupted run's bit
    for bit."""
    init, data, _, _ = drifting_problem(n=40, seed=2)
    kw = dict(checkpoint_every=2, cg_iters=20)
    whole = pose_graph.solve_pose_graph_checkpointed(init, data, iterations=6, checkpoint_dir=str(tmp_path / "w"),
                                                     **kw)
    ckdir = tmp_path / "ck"
    pose_graph.solve_pose_graph_checkpointed(init, data, iterations=2, checkpoint_dir=str(ckdir), **kw)
    round1 = (ckdir / "metadata.json").read_text()
    pose_graph.solve_pose_graph_checkpointed(init, data, iterations=4, checkpoint_dir=str(ckdir), **kw)
    if metadata_file == "missing":
        (ckdir / "metadata.json").unlink()
    else:
        (ckdir / "metadata.json").write_text(round1)
    res = pose_graph.solve_pose_graph_checkpointed(init, data, iterations=6, checkpoint_dir=str(ckdir), **kw)
    for a, b in zip(res.state, whole.state):
        assert torch.equal(a, b)
    assert torch.equal(res.cost_history, whole.cost_history) and res.cost_history.shape == (7,)
    assert sorted(p.name for p in ckdir.iterdir()) == ["metadata.json", "state"]


# The same inputs through both packages.


def guard_points():
    """Rotation vectors at ω = 0, in the Taylor band, and general; unit
    quaternions with w = 1.0 exactly (|v| < 1e-8), w near −1, and general."""
    rng = np.random.default_rng(11)
    omega = np.concatenate([np.zeros((2, 3)), rng.normal(size=(3, 3)) * 1e-7, rng.normal(size=(8, 3))])
    q = np.asarray(jquat.exp_map(jnp.asarray(omega)))
    q = np.concatenate([q, [[3e-9, -1e-9, 2e-9, 1.0], [1e-3, 0.0, 0.0, -np.sqrt(1 - 1e-6)]]])
    return omega, q


@pytest.mark.parametrize("fn", ["exp_map", "log_map"])
def test_exp_log_maps_and_their_jvps_match_jax(fn):
    omega, q = guard_points()
    x = omega if fn == "exp_map" else q
    assert fn == "exp_map" or (q[:, 3] == 1.0).sum() >= 3  # the clip's tie is exercised
    rng = np.random.default_rng(12)
    t = rng.normal(size=x.shape)
    jf, tf = getattr(jquat, fn), getattr(quat, fn)
    want, want_t = jax.jvp(jf, (jnp.asarray(x),), (jnp.asarray(t),))
    got, got_t = torch.func.jvp(tf, (T(x),), (T(t),))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-12)
    np.testing.assert_allclose(got_t.numpy(), np.asarray(want_t), rtol=0, atol=1e-12)
    assert np.isfinite(got_t.numpy()).all()
    # Reverse mode at the same points: the pose graph's pullbacks.
    _, jpull = jax.vjp(jf, jnp.asarray(x))
    _, tpull = torch.func.vjp(tf, T(x))
    u = rng.normal(size=np.asarray(want).shape)
    np.testing.assert_allclose(tpull(T(u))[0].numpy(), np.asarray(jpull(jnp.asarray(u))[0]), rtol=0, atol=1e-12)


def test_log_map_clip_has_jax_derivative_at_the_identity():
    """Trap: ``jnp.clip``'s derivative at w = 1 is 0.5 (ties split), and
    ``torch.clamp``'s is 1; the port's log map must give JAX's. Near the
    identity log(q) ≈ 2v/w, so a tangent along w at w = 1.0 moves it by
    −2v · 0.5, where the clamp would give −2v."""
    t = np.array([[0.0, 0.0, 0.0, 1.0]])
    assert jax.jvp(lambda x: jnp.clip(x, -1.0, 1.0), (jnp.ones(()),), (jnp.ones(()),))[1].item() == 0.5
    assert torch.func.jvp(lambda x: torch.clamp(x, -1.0, 1.0), (torch.ones(()),), (torch.ones(()),))[1].item() == 1.0
    v = np.array([[2e-9, 0.0, 0.0, 1.0]])
    got = torch.func.jvp(quat.log_map, (T(v),), (T(t),))[1].numpy()
    want = np.asarray(jax.jvp(jquat.log_map, (jnp.asarray(v),), (jnp.asarray(t),))[1])
    assert got[0, 0] == want[0, 0] == -2e-9


def both_problems(n=60, seed=7, drift=0.05):
    """The drifting loop with proposed closures, as the JAX package builds
    it (numpy), and the same arrays in the port via ``from_numpy``."""
    gt_pos, gt_quat, dp, dq = make_drifting_graph(n=n, seed=seed, drift=drift)
    init_pos, init_quat = integrate_odometry(gt_pos[0], gt_quat[0], dp, dq)
    loop_ij, _, _, loop_valid = jpg.propose_loop_closures(
        jnp.asarray(init_pos), jnp.asarray(np.arange(n) * 1.0), jnp.asarray(init_quat),
        radius=8.0, min_time_gap=20.0, max_loops=4)
    i_sel, j_sel = loop_ij[:, 0], loop_ij[:, 1]
    qinv = jquat.conj(jquat.normalize(jnp.asarray(gt_quat)[i_sel]))
    gps_valid = np.zeros(n, bool)
    gps_valid[::6] = True
    jdata = jpg.build_data_from_fusion(
        jnp.asarray(init_pos), jnp.asarray(init_quat), jnp.asarray(gt_pos), jnp.asarray(gps_valid),
        loop_ij=loop_ij, loop_dp=jquat.rotate(qinv, jnp.asarray(gt_pos)[j_sel] - jnp.asarray(gt_pos)[i_sel]),
        loop_dq=jquat.mul(qinv, jquat.normalize(jnp.asarray(gt_quat)[j_sel])), loop_valid=loop_valid,
    )._replace(odo_dp=jnp.asarray(dp), odo_dq=jnp.asarray(dq))
    jinit = jpg.PoseGraphState(jnp.asarray(init_pos), jnp.asarray(init_quat))
    tdata = pose_graph.PoseGraphData.from_numpy(jax.tree.map(np.asarray, jdata), device="cpu")
    tinit = pose_graph.PoseGraphState.from_numpy(jax.tree.map(np.asarray, jinit), device="cpu")
    assert bool(np.asarray(loop_valid).any())
    return jinit, jdata, tinit, tdata


def test_from_numpy_goes_to_the_card_and_raises_without_one(monkeypatch):
    """``from_numpy`` places the state on the card unless the caller names
    another device, so numpy → ``from_numpy`` → ``solve_pose_graph`` never
    runs on the CPU unasked."""
    jinit, jdata, _, _ = both_problems()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for cls, arrays in ((pose_graph.PoseGraphData, jdata), (pose_graph.PoseGraphState, jinit)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cls.from_numpy(jax.tree.map(np.asarray, arrays))
        got = cls.from_numpy(jax.tree.map(np.asarray, arrays), device="cpu", dtype=torch.float32)
        assert all(v.device.type == "cpu" for v in got if isinstance(v, torch.Tensor))
        assert got[0].dtype == torch.float32


def test_residuals_and_one_hessian_vector_product_match_jax():
    jinit, jdata, tinit, tdata = both_problems()
    assert rel(pose_graph.residuals(tinit, tdata).numpy(), jpg.residuals(jinit, jdata)) <= 1e-10
    n = tinit.positions.shape[0]
    v = np.random.default_rng(3).normal(size=(n, 6))

    @jax.jit
    def jax_products(v):
        """JAX's solve_pose_graph linearisation: (Jᵀr, (JᵀJ + λI)v)."""

        def r_of_delta(delta):
            return jpg.residuals(jpg._retract(jinit, delta), jdata)

        delta0 = jnp.zeros((n, 6))
        r0, pullback = jax.vjp(r_of_delta, delta0)
        _, jv = jax.jvp(r_of_delta, (delta0,), (v,))
        return pullback(r0)[0], pullback(jv)[0] + 1e-6 * v

    want_grad, want_hv = jax_products(jnp.asarray(v))
    grad, hvp = pose_graph._normal_equations(tinit, tdata, 1e-6)
    assert rel(grad.numpy(), want_grad) <= 1e-10
    assert rel(hvp(T(v)).numpy(), want_hv) <= 1e-10
    assert torch.equal(hvp(torch.zeros((n, 6), dtype=torch.float64)), torch.zeros((n, 6), dtype=torch.float64))


def test_solve_pose_graph_matches_jax():
    jinit, jdata, tinit, tdata = both_problems()
    want = jpg.solve_pose_graph(jinit, jdata, iterations=10)
    got = pose_graph.solve_pose_graph(tinit, tdata, iterations=10)
    assert np.abs(got.state.positions.numpy() - np.asarray(want.state.positions)).max() <= 1e-8
    assert np.abs(got.state.quaternions.numpy() - np.asarray(want.state.quaternions)).max() <= 1e-10
    assert rel(got.cost_history.numpy(), want.cost_history) <= 1e-9
    assert got.cost_history.shape == (11,) and float(got.final_cost) == float(got.cost_history[-1])


def test_checkpointed_solve_after_a_resume_matches_jax(tmp_path):
    jinit, jdata, tinit, tdata = both_problems(n=40, seed=2, drift=0.02)
    kw = dict(checkpoint_every=2, iterations=4)
    jpg.solve_pose_graph_checkpointed(jinit, jdata, checkpoint_dir=str(tmp_path / "jax"), **kw)
    pose_graph.solve_pose_graph_checkpointed(tinit, tdata, checkpoint_dir=str(tmp_path / "port"), **kw)
    kw["iterations"] = 6
    want = jpg.solve_pose_graph_checkpointed(jinit, jdata, checkpoint_dir=str(tmp_path / "jax"), **kw)
    got = pose_graph.solve_pose_graph_checkpointed(tinit, tdata, checkpoint_dir=str(tmp_path / "port"), **kw)
    assert np.abs(got.state.positions.numpy() - np.asarray(want.state.positions)).max() <= 1e-8
    assert rel(got.cost_history.numpy(), want.cost_history) <= 1e-9 and got.cost_history.shape == (7,)


def test_propose_loop_closures_matches_jax_in_every_row():
    """Every slot of ``loop_ij`` equal, the invalid ones too: each is a −inf
    tie, which ``jax.lax.top_k`` orders by index and ``torch.topk`` does not
    (on [-inf, 1, -inf, 1, -inf], k = 4: JAX [1, 3, 0, 2], torch.topk
    [1, 3, 0, 4])."""
    rng = np.random.default_rng(21)
    n = 300
    ang = np.linspace(0, 4 * np.pi, n)  # two laps: revisits, and most poses none
    pos = np.stack([np.cos(ang) * 30, np.sin(ang) * 30, np.zeros(n)], -1) + rng.normal(size=(n, 3)) * 0.5
    times = np.arange(n) * 0.5
    quats = Rotation.from_euler("z", (ang + np.pi / 2)[:, None]).as_quat()
    for radius, max_loops in ((3.0, 32), (1.0, 64), (50.0, 8)):
        want = jpg.propose_loop_closures(jnp.asarray(pos), jnp.asarray(times), jnp.asarray(quats),
                                         radius=radius, min_time_gap=30.0, max_loops=max_loops)
        got = pose_graph.propose_loop_closures(T(pos), T(times), T(quats), radius=radius, min_time_gap=30.0,
                                               max_loops=max_loops)
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
        np.testing.assert_array_equal(got[3].numpy(), np.asarray(want[3]))
        for g, w in zip(got[1:3], want[1:3]):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-12)
        n_valid = int(got[3].sum())
        assert 0 < n_valid < max_loops or radius == 50.0
    score = torch.tensor([-float("inf"), 1.0, -float("inf"), 1.0, -float("inf")])
    assert torch.sort(score, descending=True, stable=True)[1][:4].tolist() == [1, 3, 0, 2]


def golden_result(port: bool):
    """A fusion result made of the seq-04 golden outputs, for either package
    (``refine_pose_graph`` reads its ``outputs`` and ``slam`` only)."""
    g = np.load(GOLDEN)
    slam = {"timestamps": g["slam_times"], "positions": g["slam_pos"], "quaternions": g["slam_quat"]}
    leaves = dict(corrected_pos=g["corrected_pos"], corrected_quat=g["corrected_quat"], sim3_pos=g["sim3_pos"],
                  sim3_quat=g["sim3_quat"], sim3_inliers=np.zeros(len(g["slam_times"]), bool),
                  aligned_gps=g["aligned_gps"], gps_valid=g["valid_mask"].astype(bool), ok=np.array(True))
    sim3 = (g["sim3_R"], g["sim3_t"], g["sim3_scale"], np.array(True))
    if port:
        out = fusion.FusionOutputs(**{k: torch.as_tensor(v) for k, v in leaves.items()},
                                   sim3=Sim3(*(torch.as_tensor(v) for v in sim3)))
    else:
        out = jfusion.FusionOutputs(**{k: jnp.asarray(v) for k, v in leaves.items()},
                                    sim3=JSim3(*(jnp.asarray(v) for v in sim3)))
    return types.SimpleNamespace(slam=slam, outputs=out)


@pytest.mark.parametrize("checkpointed", [False, True])
def test_refine_pose_graph_on_seq04_matches_jax(checkpointed, tmp_path):
    """The slice as a whole: seq-04's golden fusion refined by both packages
    with the command's defaults (seq-04 does not revisit itself: no
    closure), the port also checkpointed to a directory."""
    want, want_info = jpipeline.refine_pose_graph(golden_result(False))
    got, got_info = pipeline.refine_pose_graph(
        golden_result(True), checkpoint_dir=str(tmp_path / "ck") if checkpointed else None)
    assert got_info == want_info == {"n_loops": 0, "loop_ij": []}
    assert np.abs(got.state.positions.numpy() - np.asarray(want.state.positions)).max() <= 1e-8
    assert np.abs(got.state.quaternions.numpy() - np.asarray(want.state.quaternions)).max() <= 1e-10
    assert rel(got.cost_history.numpy(), want.cost_history) <= 1e-9 and got.cost_history.shape == (11,)
    assert float(got.final_cost) <= float(got.cost_history[0])


def test_refine_pose_graph_builds_jaxs_loop_factors_on_seq04():
    """With a 2 s gap and a 40 m radius seq-04's own neighbours are proposed:
    the pairs and the factors read from the Sim3 trajectory equal JAX's
    (the starting cost includes every loop residual, ≤1e-12 relative). The
    step is not compared: with these closures five Gauss-Newton steps move
    poses by 6.5e-6 m under a 1e-15 relative change of their start
    (``tools/torch_pose_graph_probe.py --sensitivity``), so a comparison of
    steps would measure the problem's conditioning, not the port."""
    kw = dict(iterations=1, cg_iters=5, loop_min_time_gap=2.0, loop_radius=40.0, max_loops=6)
    want, want_info = jpipeline.refine_pose_graph(golden_result(False), **kw)
    got, got_info = pipeline.refine_pose_graph(golden_result(True), **kw)
    assert got_info == want_info and got_info["n_loops"] == 3
    assert rel(got.cost_history[0].numpy(), want.cost_history[0]) <= 1e-12
    no_loops, _ = pipeline.refine_pose_graph(golden_result(True), **{**kw, "propose_loops": False})
    assert float(got.cost_history[0]) > float(no_loops.cost_history[0])


def test_refine_pose_graph_runs_on_the_results_device_and_dtype():
    """The solve runs on the device and in the dtype of the fusion's tensors
    (the fusion's entry points chose them: the card unless told the CPU)."""
    res = golden_result(True)
    res.outputs = res.outputs._replace(**{k: v.float() for k, v in res.outputs._asdict().items()
                                          if k != "sim3" and v.is_floating_point()})
    gn, info = pipeline.refine_pose_graph(res, iterations=1, cg_iters=5)
    assert gn.state.positions.dtype == torch.float32 and gn.state.positions.device.type == "cpu"
    assert info == {"n_loops": 0, "loop_ij": []} and bool(torch.isfinite(gn.state.positions).all())


def plain_cg_active_iterations(hvp, b, maxiter, tol=1e-10) -> int:
    """The iterations of ``pose_graph._cg``'s recurrence that run before
    γ = r·r falls to tol²·b·b, counted by a plain loop that stops there."""
    atol2 = torch.clamp(tol * tol * torch.sum(b * b), min=0.0)
    x = torch.zeros_like(b)
    r = b - hvp(x)
    p, gamma = r, torch.sum(r * r)
    for k in range(maxiter):
        if not gamma > atol2:
            return k
        ap = hvp(p)
        alpha = gamma / torch.sum(p * ap)
        x, r_new = x + alpha * p, r - alpha * ap
        gamma_new = torch.sum(r_new * r_new)
        p, r, gamma = r_new + (gamma_new / gamma) * p, r_new, gamma_new
    return maxiter


def test_traced_solve_is_bit_equal_and_counts_the_active_cg_iterations(tracer):  # noqa: F811
    """The tracer on: the solve's states and costs equal the untraced ones
    bit for bit; each step records its linearisation and CG device spans;
    ``cg.iters_active`` is the count of a plain loop over the same CG at
    each step's state, and ``cg.iters_run`` the iterations issued."""
    init, data, _, _ = drifting_problem(n=4)
    off = pose_graph.solve_pose_graph(init, data, iterations=3)
    tracer.enable()
    on = pose_graph.solve_pose_graph(init, data, iterations=3)
    rec = tracer.records()
    tracer.disable()
    for a, b in ((on.state.positions, off.state.positions), (on.state.quaternions, off.state.quaternions),
                 (on.cost_history, off.cost_history)):
        assert torch.equal(a, b)
    state, cost, active = init, pose_graph._cost(init, data), 0
    for _ in range(3):
        grad, hvp = pose_graph._normal_equations(state, data, 1e-6)
        active += plain_cg_active_iterations(hvp, -grad, 50)
        state, cost = pose_graph._gn_step(state, data, 50, 1e-6, cost)
    assert 0 < active < 150  # the case holds converged iterations
    assert rec["device_counts"] == {"cg.iters_active": float(active)} and rec["counts"] == {"cg.iters_run": 150}
    marks = sorted(rec["marks"], key=lambda m: m[2])
    assert [m[0] for m in marks] == ["gn.linearise", "gn.cg"] * 3
    assert all(a[3] <= b[2] for a, b in zip(marks, marks[1:]))
