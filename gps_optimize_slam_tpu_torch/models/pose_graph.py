"""Pose-graph nonlinear least squares: Gauss-Newton with GNSS unary priors and
loop closures (port of ``gps_optimize_slam_tpu.models.pose_graph``).

The global alternative to filtering: all poses are optimised jointly over

* odometry (binary) factors from the SLAM relative poses,
* GNSS unary position priors (masked),
* loop-closure (binary) factors between arbitrary pose pairs (masked),

minimising the weighted squared residual norm. The normal equations
(JᵀJ + λI)δ = −Jᵀr are solved matrix-free, so each Gauss-Newton step is
conjugate gradients on Hessian-vector products and no matrix is assembled:
Jᵀu is the pullback of ``torch.func.vjp``, and Jv the pullback of that
pullback (it is linear in u, so its vjp is J), both built once a step. The
JAX package takes Jv from ``jax.jvp``; ``torch.func.jvp`` gives the same
products several times slower (``tools/torch_pose_graph_probe.py`` times
both): under forward mode every op with a constant operand (a measurement,
a weight, a literal) builds a zero tangent whose shape is worked out in
Python. Rotations live on SO(3): the
state is updated through a tangent retraction (the quaternion exp map),
orientation residuals go through the log map.

Everything has a fixed shape (loop closures are a padded (max_loops, 2)
index array with a validity mask), and the solve makes no host sync: the
cost safeguard and the conjugate-gradient stopping rule are selections on
the device. On a card one Gauss-Newton step (the linearisation, both
pullbacks, the CG iterations, the retraction and the safeguard) is one
captured program (``utils.graphs``) a shape and static setting, as the JAX
package jits its whole solve: a step is a pure function of its tensors, so
every step of a solve and of each checkpoint round replays it. The
proposal of loop closures is a program of its own.
"""

from __future__ import annotations

import os
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch.func import vjp

from gps_optimize_slam_tpu_torch.ops import quaternion as quat
from gps_optimize_slam_tpu_torch.ops import se3
from gps_optimize_slam_tpu_torch.utils import checkpoint as ckpt
from gps_optimize_slam_tpu_torch.utils import graphs
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
    SO(3) increments."""
    return PoseGraphState(
        positions=state.positions + delta[:, :3],
        quaternions=quat.normalize(quat.mul(state.quaternions, quat.exp_map(delta[:, 3:]))),
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


def _vdot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.sum(a * b)


def _cg(hvp, b: torch.Tensor, maxiter: int, tol: float) -> torch.Tensor:
    """Conjugate gradients from x0 = 0, the recurrence of JAX's
    ``jax.scipy.sparse.linalg.cg`` (``_cg_solve``, no preconditioner):
    r0 = b − A(x0), stop once γ = r·r ≤ tol²·b·b or after ``maxiter``
    iterations. The while loop runs as ``maxiter`` iterations in which a
    finished solve keeps its values (a selection on the device, not a
    multiply by a mask: α may be 0/0 in a finished step), so the result is
    the while loop's with no host sync."""
    atol2 = torch.clamp(tol * tol * _vdot(b, b), min=0.0)
    x = torch.zeros_like(b)
    r = b - hvp(x)
    p = r
    gamma = _vdot(r, r)
    for _ in range(maxiter):
        active = gamma > atol2
        ap = hvp(p)
        alpha = gamma / _vdot(p, ap)
        x_new = x + alpha * p
        r_new = r - alpha * ap
        gamma_new = _vdot(r_new, r_new)
        p_new = r_new + (gamma_new / gamma) * p
        x = torch.where(active, x_new, x)
        r = torch.where(active, r_new, r)
        p = torch.where(active, p_new, p)
        gamma = torch.where(active, gamma_new, gamma)
    return x


def _linearisation(state: PoseGraphState, data: PoseGraphData):
    """The residual at ``state`` and its Jacobian in the tangent space
    (δ ∈ R^{N×6}), matrix-free: (r0, u ↦ Jᵀu, v ↦ Jv)."""
    n = state.positions.shape[0]

    def r_of_delta(delta):
        return residuals(_retract(state, delta), data)

    delta0 = torch.zeros((n, 6), dtype=state.positions.dtype, device=state.positions.device)
    r0, pullback = vjp(r_of_delta, delta0)  # u ↦ Jᵀu
    # v ↦ Jv as the pullback's own pullback: the pullback is linear in u, so
    # its vjp (at any u) is J. Both are built once a step and serve every CG
    # iteration; see the module docstring for why not torch.func.jvp.
    _, push = vjp(lambda u: pullback(u)[0], torch.zeros_like(r0))
    return r0, lambda u: pullback(u)[0], lambda v: push(v)[0]


def _normal_equations(state: PoseGraphState, data: PoseGraphData, damping: float):
    """The Gauss-Newton linearisation at ``state`` in the tangent space:
    (Jᵀr, v ↦ (JᵀJ + λI)v), the products matrix-free."""
    r0, jt, j = _linearisation(state, data)

    def hvp(v):
        return jt(j(v)) + damping * v

    return jt(r0), hvp


def _gn_step(state: PoseGraphState, data: PoseGraphData, cg_iters: int, damping: float, c_old: torch.Tensor):
    """One Gauss-Newton step: solve (JᵀJ + λI)δ = −Jᵀr by CG, retract, and
    keep the step only if the cost falls. Returns (state, its cost).

    The program :func:`solve_pose_graph` replays on a card. It is the
    smallest one: the pullbacks hold tensors the step's own linearisation
    saved, so a graph of one CG iteration would read a finished step's
    addresses."""
    grad, hvp = _normal_equations(state, data, damping)
    delta = _cg(hvp, -grad, maxiter=cg_iters, tol=1e-10)
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
    """Gauss-Newton with matrix-free CG normal-equation solves, on the device
    of ``init`` (no host sync until the caller reads the result).

    Each iteration linearises the residual around the current state in the
    tangent space (δ ∈ R^{N×6}), solves (JᵀJ + λI)δ = −Jᵀr by conjugate
    gradients on Hessian-vector products, and retracts: one
    :func:`_gn_step`, a captured program on a card (``utils.graphs``)."""
    state = init
    cost = _cost(init, data)
    costs = [cost]
    for _ in range(iterations):
        state, cost = graphs.run(_gn_step, state, data, cg_iters, damping, cost)
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
