"""Pose-graph nonlinear least squares: Gauss-Newton with GNSS unary priors and
loop closures (port of ``gps_optimize_slam_tpu.models.pose_graph``).

The global alternative to filtering: all poses are optimised jointly over

* odometry (binary) factors from the SLAM relative poses,
* GNSS unary position priors (masked),
* loop-closure (binary) factors between arbitrary pose pairs (masked),

minimising the weighted squared residual norm. Each Gauss-Newton step takes
every binary factor's residual and its 6 × 12 Jacobian block against the
tangent steps of its two poses, once (``torch.func``: ``vmap`` over the
factors of ``jacrev`` of one pair's residual); the GNSS rows stay implicit
(w_gps on the positions of the valid poses). The normal equations
(JᵀJ + λI)δ = −Jᵀr are then solved by conjugate gradients over those
blocks with no matrix assembled: on a card in one launch of
``ops.kernels.pose_cg`` (``csrc/pose_cg.cu``, every iteration inside it), on
the CPU by its plain version. Rotations live on SO(3): the state is updated
through a tangent retraction (the quaternion exp map), orientation
residuals go through the log map.

Everything has a fixed shape (loop closures are a padded (max_loops, 2)
index array with a validity mask), and the solve makes no host sync: the
cost safeguard and the conjugate-gradient stopping rule are selections on
the device. On a card one Gauss-Newton step (the blocks, the CG launch, the
retraction and the safeguard) is one captured program (``utils.graphs``) a
shape and static setting, as the JAX package jits its whole solve: a step is
a pure function of its tensors, so every step of a solve and of each
checkpoint round replays it. The proposal of loop closures is a program of
its own.
"""

from __future__ import annotations

import os
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch.func import jacrev, vmap

from gps_optimize_slam_tpu_torch.ops import kernels
from gps_optimize_slam_tpu_torch.ops import quaternion as quat
from gps_optimize_slam_tpu_torch.ops import se3
from gps_optimize_slam_tpu_torch.utils import checkpoint as ckpt
from gps_optimize_slam_tpu_torch.utils import graphs, profiling
from gps_optimize_slam_tpu_torch.utils.device import resolve_device


class PoseGraphData(NamedTuple):
    """Factor-graph inputs (all fixed shapes)."""

    odo_dp: torch.Tensor  # (N-1,3) SLAM relative translations (local frame)
    odo_dq: torch.Tensor  # (N-1,4) SLAM relative rotations
    gps: torch.Tensor  # (N,3) GNSS position priors (arbitrary where invalid)
    gps_valid: torch.Tensor  # (N,) bool
    loop_ij: torch.Tensor  # (L,2) int64 loop-closure pose pairs
    loop_dp: torch.Tensor  # (L,3) measured relative translation i→j
    loop_dq: torch.Tensor  # (L,4) measured relative rotation
    loop_valid: torch.Tensor  # (L,) bool
    w_odo_p: float = 10.0  # weight (1/σ) translation odometry
    w_odo_q: float = 20.0  # weight rotation odometry
    w_gps: float = 2.0  # weight GNSS prior
    w_loop_p: float = 10.0
    w_loop_q: float = 20.0

    @classmethod
    def from_numpy(cls, arrays, device=None, dtype: torch.dtype = torch.float64) -> "PoseGraphData":
        """From a NamedTuple or dict of NumPy arrays with these fields (the JAX
        package's ``PoseGraphData`` converted leaf by leaf): floating arrays
        in ``dtype``, masks as bool, pairs as int64, weights as floats. The
        tensors go to the card unless ``device`` names another; without a
        card, ``device=None`` raises."""
        device = resolve_device(device)
        d = arrays._asdict() if hasattr(arrays, "_asdict") else dict(arrays)
        out = {}
        for k, v in d.items():
            if k.startswith("w_"):
                out[k] = float(v)
            elif k in ("gps_valid", "loop_valid"):
                out[k] = torch.as_tensor(np.array(v), device=device).bool()
            elif k == "loop_ij":
                out[k] = torch.as_tensor(np.array(v), device=device).long()
            else:
                out[k] = torch.as_tensor(np.array(v), device=device).to(dtype)
        return cls(**out)


class PoseGraphState(NamedTuple):
    positions: torch.Tensor  # (N,3)
    quaternions: torch.Tensor  # (N,4)

    @classmethod
    def from_numpy(cls, arrays, device=None, dtype: torch.dtype = torch.float64) -> "PoseGraphState":
        """From a NamedTuple or dict of NumPy arrays (the JAX package's
        ``PoseGraphState`` converted leaf by leaf), on the card unless
        ``device`` names another."""
        device = resolve_device(device)
        d = arrays._asdict() if hasattr(arrays, "_asdict") else dict(arrays)
        return cls(*(torch.as_tensor(np.array(d[k]), device=device).to(dtype) for k in cls._fields))


def _retract(state: PoseGraphState, delta: torch.Tensor) -> PoseGraphState:
    """Apply a tangent update δ = (N,6): [δp, δθ] with right-multiplied
    SO(3) increments (or one pose's: (3,), (4,) and δ (6,))."""
    return PoseGraphState(
        positions=state.positions + delta[..., :3],
        quaternions=quat.normalize(quat.mul(state.quaternions, quat.exp_map(delta[..., 3:]))),
    )


def _relative_residual(p_i, q_i, p_j, q_j, meas_dp, meas_dq, w_p, w_q):
    """Weighted SE(3) residual of pose_i→pose_j against a measurement."""
    q_i_inv = quat.conj(quat.normalize(q_i))
    dp_est = quat.rotate(q_i_inv, p_j - p_i)
    dq_est = quat.mul(q_i_inv, quat.normalize(q_j))
    r_p = (dp_est - meas_dp) * w_p
    # log(meas⁻¹ ∘ est): rotation error in the tangent space.
    r_q = quat.log_map(quat.mul(quat.conj(meas_dq), dq_est)) * w_q
    return torch.cat([r_p, r_q], dim=-1)


def residuals(state: PoseGraphState, data: PoseGraphData) -> torch.Tensor:
    """All weighted residuals, flattened (fixed shape; invalid rows zero)."""
    p, q = state.positions, state.quaternions
    r_odo = _relative_residual(p[:-1], q[:-1], p[1:], q[1:], data.odo_dp, data.odo_dq,
                               data.w_odo_p, data.w_odo_q)
    r_gps = (p - data.gps) * data.w_gps
    r_gps = torch.where(data.gps_valid[:, None], r_gps, torch.zeros_like(r_gps))
    i, j = data.loop_ij[:, 0], data.loop_ij[:, 1]
    r_loop = _relative_residual(p[i], q[i], p[j], q[j], data.loop_dp, data.loop_dq,
                                data.w_loop_p, data.w_loop_q)
    r_loop = torch.where(data.loop_valid[:, None], r_loop, torch.zeros_like(r_loop))
    return torch.cat([r_odo.reshape(-1), r_gps.reshape(-1), r_loop.reshape(-1)])


class GNResult(NamedTuple):
    state: PoseGraphState
    cost_history: torch.Tensor  # (iterations+1,) 0.5·‖r‖² before each step and after the last
    final_cost: torch.Tensor


def _cost(state: PoseGraphState, data: PoseGraphData) -> torch.Tensor:
    r = residuals(state, data)
    return 0.5 * torch.sum(r * r)


class Linearisation(NamedTuple):
    """A Gauss-Newton step's linearisation at δ = 0: the M = (N−1) + L binary
    factors (odometry (k, k+1), then the closures of ``loop_ij``), each
    factor's residual and its Jacobian block against the tangent steps of
    its two poses (columns 0-5 pose i, 6-11 pose j), an invalid closure's
    zero; and the masked GNSS residual, whose Jacobian is w_gps on the
    positions of the valid poses."""

    blocks: torch.Tensor  # (M, 6, 12)
    r0: torch.Tensor  # (M, 6)
    r_gps: torch.Tensor  # (N, 3)


def _pair_residual(d, p_i, q_i, p_j, q_j, meas_dp, meas_dq, w_p, w_q):
    """One binary factor's residual at the tangent steps d (12,) of its two
    poses (``residuals`` ∘ ``_retract`` for one pose pair), twice: the
    Jacobian's function and its value."""
    a = _retract(PoseGraphState(p_i, q_i), d[:6])
    b = _retract(PoseGraphState(p_j, q_j), d[6:])
    r = _relative_residual(a.positions, a.quaternions, b.positions, b.quaternions, meas_dp, meas_dq, w_p, w_q)
    return r, r


_pair_jacobians = vmap(jacrev(_pair_residual, has_aux=True), in_dims=(None, 0, 0, 0, 0, 0, 0, 0, 0))


def _linearise(state: PoseGraphState, data: PoseGraphData) -> Linearisation:
    """Every factor's residual and Jacobian block at ``state``, in one
    batched forward and backward over the factors."""
    p, q = state.positions, state.quaternions
    n, dev = p.shape[0], p.device
    like = dict(dtype=p.dtype, device=dev)
    odo = torch.arange(n - 1, device=dev)
    pi = torch.cat([odo, data.loop_ij[:, 0]])
    pj = torch.cat([odo + 1, data.loop_ij[:, 1]])
    n_loop = data.loop_ij.shape[0]
    w_p = torch.cat([torch.full((n - 1,), data.w_odo_p, **like), torch.full((n_loop,), data.w_loop_p, **like)])
    w_q = torch.cat([torch.full((n - 1,), data.w_odo_q, **like), torch.full((n_loop,), data.w_loop_q, **like)])
    blocks, r0 = _pair_jacobians(torch.zeros(12, **like), p[pi], q[pi], p[pj], q[pj],
                                 torch.cat([data.odo_dp, data.loop_dp]), torch.cat([data.odo_dq, data.loop_dq]),
                                 w_p, w_q)
    valid = torch.cat([torch.ones(n - 1, dtype=torch.bool, device=dev), data.loop_valid])
    blocks = torch.where(valid[:, None, None], blocks, torch.zeros_like(blocks))
    r0 = torch.where(valid[:, None], r0, torch.zeros_like(r0))
    r_gps = (p - data.gps) * data.w_gps
    r_gps = torch.where(data.gps_valid[:, None], r_gps, torch.zeros_like(r_gps))
    return Linearisation(blocks.contiguous(), r0.contiguous(), r_gps)


def _normal_equations(state: PoseGraphState, data: PoseGraphData, damping: float):
    """The Gauss-Newton linearisation at ``state`` in the tangent space:
    (Jᵀr, v ↦ (JᵀJ + λI)v), the products over the factors' blocks
    (``kernels.pose_products``, the plain version's own)."""
    lin = _linearise(state, data)
    jt, hvp = kernels.pose_products(lin.blocks, data.loop_ij, data.gps_valid, data.w_gps, damping)
    return jt(lin.r0, lin.r_gps), hvp


def _gn_step(state: PoseGraphState, data: PoseGraphData, cg_iters: int, damping: float, c_old: torch.Tensor):
    """One Gauss-Newton step: take the factors' blocks, solve
    (JᵀJ + λI)δ = −Jᵀr by CG over them (``kernels.pose_cg``: one launch on a
    card), retract, and keep the step only if the cost falls. Returns
    (state, its cost).

    The program :func:`solve_pose_graph` replays on a card. Traced, the
    blocks and the CG solve lie between device marks (``gn.linearise``,
    ``gn.cg``), and the solve's active iterations (those that ran before
    the residual met the tolerance) are added to the device counter
    ``cg.iters_active``."""
    device = state.positions.device
    with profiling.device_span("gn.linearise", device):
        lin = _linearise(state, data)
    with profiling.device_span("gn.cg", device):
        delta, active = kernels.pose_cg(lin.blocks, lin.r0, lin.r_gps, data.gps_valid, data.w_gps, data.loop_ij,
                                        damping, cg_iters, tol=1e-10)
    profiling.count_device("cg.iters_active", active)
    new_state = _retract(state, delta)
    c_new = _cost(new_state, data)
    improved = c_new < c_old
    kept = PoseGraphState(*(torch.where(improved, a, b) for a, b in zip(new_state, state)))
    return kept, torch.where(improved, c_new, c_old)


def solve_pose_graph(
    init: PoseGraphState,
    data: PoseGraphData,
    iterations: int = 10,
    cg_iters: int = 50,
    damping: float = 1e-6,
) -> GNResult:
    """Gauss-Newton with CG normal-equation solves, on the device of ``init``
    (no host sync until the caller reads the result).

    Each iteration linearises the residual around the current state in the
    tangent space (δ ∈ R^{N×6}) as per-factor Jacobian blocks, solves
    (JᵀJ + λI)δ = −Jᵀr by conjugate gradients over them, and retracts: one
    :func:`_gn_step`, a captured program on a card (``utils.graphs``).
    Traced, each step adds its ``cg_iters`` to the host counter
    ``cg.iters_run``."""
    state = init
    cost = _cost(init, data)
    costs = [cost]
    for _ in range(iterations):
        state, cost = graphs.run(_gn_step, state, data, cg_iters, damping, cost)
        profiling.count("cg.iters_run", cg_iters)
        costs.append(cost)
    history = torch.stack(costs)
    return GNResult(
        state=PoseGraphState(state.positions, quat.normalize(state.quaternions)),
        cost_history=history,
        final_cost=history[-1],
    )


def solve_pose_graph_checkpointed(
    init: PoseGraphState,
    data: PoseGraphData,
    iterations: int = 10,
    cg_iters: int = 50,
    damping: float = 1e-6,
    checkpoint_dir: Optional[str] = None,
    checkpoint_every: int = 5,
    resume: bool = True,
) -> GNResult:
    """``solve_pose_graph`` with periodic checkpoints and resume
    (``utils.checkpoint``).

    The solve runs in rounds of ``checkpoint_every`` Gauss-Newton iterations,
    each round one ``solve_pose_graph`` call carrying the state, and persists
    (state, cost history, iterations done) after every round. If
    ``checkpoint_dir`` holds a checkpoint and ``resume`` is True, the run
    continues from it; a finished run restores at once. A run interrupted and
    resumed gives the uninterrupted run's result exactly: a round is a pure
    function of the carried state. A checkpoint counts once its metadata
    file is written (the last write of a round)."""
    if checkpoint_dir is None:
        return solve_pose_graph(init, data, iterations=iterations, cg_iters=cg_iters, damping=damping)

    state, costs, start = init, [], 0
    if resume and os.path.exists(os.path.join(checkpoint_dir, "metadata.json")):
        state, meta = ckpt.restore_checkpoint(checkpoint_dir, init)
        costs = list(meta["costs"])
        start = int(meta["iterations_done"])

    while start < iterations:
        step = min(checkpoint_every, iterations - start)
        res = solve_pose_graph(state, data, iterations=step, cg_iters=cg_iters, damping=damping)
        state = res.state
        hist = res.cost_history.cpu().tolist()
        costs = (costs or hist[:1]) + hist[1:]
        start += step
        ckpt.save_checkpoint(checkpoint_dir, state, metadata={"iterations_done": start, "costs": costs})

    history = torch.tensor(costs, dtype=torch.float64, device=init.positions.device)
    return GNResult(state=state, cost_history=history, final_cost=history[-1])


def propose_loop_closures(
    positions: torch.Tensor,
    times: torch.Tensor,
    quaternions: torch.Tensor,
    radius: float = 5.0,
    min_time_gap: float = 30.0,
    max_loops: int = 32,
    suppression_radius: int = 25,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Proximity-based loop-closure proposal over a trajectory.

    For every pose j, finds the nearest pose i at least ``min_time_gap``
    seconds earlier; candidate revisits are pairs closer than ``radius``
    metres. Candidates that are not the locally best revisit within
    ``suppression_radius`` poses are suppressed (one closure per revisit,
    not a chain of near-duplicates), and the ``max_loops`` closest survivors
    are kept. The measured relative pose is read from the trajectory passed
    in.

    Returns ``(loop_ij (max_loops, 2) int64, loop_dp (max_loops, 3), loop_dq
    (max_loops, 4), loop_valid (max_loops,))`` for ``PoseGraphData``. Ties
    go as in the JAX package: ``argmin`` to the first index, and among equal
    scores (every invalid slot is a −inf tie) the lower index first, which
    ``jax.lax.top_k`` does and ``torch.topk`` does not, so the top k come
    from a stable descending sort. The (N, N) distance matrix and its
    (N, N, 3) differences are held in device memory (495 MB at 4,541 poses
    in float64). One captured program on a card (``utils.graphs``)."""
    n = positions.shape[0]
    if max_loops > n:
        raise ValueError(f"max_loops ({max_loops}) exceeds the number of poses ({n})")
    return graphs.run(_propose_loop_closures, positions, times, quaternions, radius, min_time_gap, max_loops,
                      suppression_radius)


def _propose_loop_closures(positions, times, quaternions, radius, min_time_gap, max_loops, suppression_radius):
    """The program of :func:`propose_loop_closures`."""
    n = positions.shape[0]
    inf = torch.full((), float("inf"), dtype=positions.dtype, device=positions.device)
    d2 = torch.sum((positions[:, None, :] - positions[None, :, :]) ** 2, dim=-1)
    earlier = (times[None, :] - times[:, None]) > min_time_gap  # [i, j]
    d2m = torch.where(earlier, d2, inf)
    del d2
    best_d2, best_i = torch.min(d2m, dim=0)  # nearest sufficiently old pose of each j
    del d2m

    # Non-minimum suppression: j survives only where best_d2 is the minimum
    # over its ±suppression_radius neighbourhood. The shifted copies are
    # padded with +inf at the ends, so the neighbourhood never wraps.
    idx = torch.arange(n, device=positions.device)
    neigh_min = best_d2
    for s in range(1, suppression_radius + 1):
        later = torch.roll(torch.where(idx < n - s, best_d2, inf), s)
        before = torch.roll(torch.where(idx >= s, best_d2, inf), -s)
        neigh_min = torch.minimum(neigh_min, torch.minimum(later, before))
    is_local_best = best_d2 <= neigh_min
    score = torch.where(is_local_best & (best_d2 < radius * radius), best_d2, inf)
    top_score, order = torch.sort(-score, descending=True, stable=True)
    top_score, j_sel = top_score[:max_loops], order[:max_loops]
    loop_valid = torch.isfinite(-top_score)
    i_sel = best_i[j_sel]
    loop_ij = torch.stack([i_sel, j_sel], dim=-1)

    q_i_inv = quat.conj(quat.normalize(quaternions[i_sel]))
    q_j = quat.normalize(quaternions[j_sel])
    loop_dp = quat.rotate(q_i_inv, positions[j_sel] - positions[i_sel])
    loop_dq = quat.mul(q_i_inv, q_j)
    v = loop_valid[:, None]
    loop_dp = torch.where(v, loop_dp, torch.zeros_like(loop_dp))
    loop_dq = torch.where(v, loop_dq, quat.identity_like(loop_dq))
    return loop_ij, loop_dp, loop_dq, loop_valid


def build_data_from_fusion(
    slam_pos: torch.Tensor,
    slam_quat: torch.Tensor,
    aligned_gps: torch.Tensor,
    gps_valid: torch.Tensor,
    loop_ij: Optional[torch.Tensor] = None,
    loop_dp: Optional[torch.Tensor] = None,
    loop_dq: Optional[torch.Tensor] = None,
    loop_valid: Optional[torch.Tensor] = None,
    **weights,
) -> PoseGraphData:
    """Assemble factors from the fusion's inputs: odometry from the SLAM
    stream, unary priors from the aligned GNSS (NaN rows zeroed; they are
    masked), and no loop closure unless given."""
    dp, dq = se3.relative_poses_along(slam_pos, slam_quat)
    if loop_ij is None:
        like = dict(dtype=slam_pos.dtype, device=slam_pos.device)
        loop_ij = torch.zeros((1, 2), dtype=torch.long, device=slam_pos.device)
        loop_dp = torch.zeros((1, 3), **like)
        loop_dq = quat.identity_like(torch.zeros((1, 4), **like))
        loop_valid = torch.zeros((1,), dtype=torch.bool, device=slam_pos.device)
    return PoseGraphData(
        odo_dp=dp,
        odo_dq=dq,
        gps=torch.nan_to_num(aligned_gps, nan=0.0),
        gps_valid=gps_valid,
        loop_ij=loop_ij,
        loop_dp=loop_dp,
        loop_dq=loop_dq,
        loop_valid=loop_valid,
        **weights,
    )
