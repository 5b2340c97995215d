"""Plain reference of the pose-graph refinement after a fusion: loop
closures proposed by proximity, then Gauss-Newton over odometry, GNSS and
closure factors, each step's normal equations solved by conjugate
gradients. NumPy, SciPy's sparse matrices and plain PyTorch on the CPU; it
imports nothing of the program under test.

The factors follow the ``refine-graph`` command's recipe: odometry and
closure measurements from the Sim(3)-aligned trajectory (a pose's relative
translation in the earlier pose's frame and the relative rotation), unary
GNSS priors from the aligned track where valid, each residual weighted by
its configured weight, orientation errors through the rotation log. The
state moves on the tangent space (a position step and a right-multiplied
rotation vector a pose). Where the program differentiates the whole
residual with pullbacks and never forms the Jacobian, this reference takes
each factor's 6 x 12 (or 3 x 6) Jacobian by automatic differentiation and
assembles the sparse matrix; the conjugate-gradient recurrence (from zero,
stopping once the residual's square falls to ``1e-20`` of the right-hand
side's, at most ``cg_iters`` iterations) and the step's acceptance only
where the cost falls are the recipe's.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import torch
from torch.func import jacrev, vmap

from portbench.reference.fusion import qconj, qmul


def qnorm(q):
    return q / torch.sqrt(torch.sum(q * q, -1, keepdim=True))


def qrotate(q, v):
    u, w = q[..., :3], q[..., 3:4]
    uv = torch.linalg.cross(u, v)
    return v + 2.0 * (w * uv + torch.linalg.cross(u, uv))


def qexp(omega):
    """Rotation vector → unit quaternion, by its series near zero (so that
    its derivative at exactly zero is finite)."""
    th2 = torch.sum(omega * omega, -1, keepdim=True)
    small = th2 < 1e-12
    th = torch.sqrt(torch.where(small, torch.ones_like(th2), th2))
    k = torch.where(small, 0.5 - th2 / 48.0, torch.sin(th / 2) / th)
    w = torch.where(small, 1.0 - th2 / 8.0, torch.cos(th / 2))
    return torch.cat([omega * k, w], -1)


def qlog(q):
    """Unit quaternion → rotation vector of the shorter rotation."""
    q = torch.where(q[..., 3:4] < 0, -q, q)
    v, w = q[..., :3], q[..., 3:4]
    n2 = torch.sum(v * v, -1, keepdim=True)
    small = n2 < 1e-18
    n = torch.sqrt(torch.where(small, torch.ones_like(n2), n2))
    return v * torch.where(small, 2.0 / w, 2.0 * torch.atan2(n, w) / n)


def relative(pi, qi, pj, qj):
    qi_inv = qconj(qnorm(qi))
    return qrotate(qi_inv, pj - pi), qmul(qi_inv, qnorm(qj))


def pair_residual(d, pi, qi, pj, qj, mdp, mdq, wp: float, wq: float):
    """The weighted 6-residual of a pose pair after tangent steps ``d``
    (12: the first pose's position and rotation steps, then the second's)."""
    pi2, qi2 = pi + d[0:3], qnorm(qmul(qi, qexp(d[3:6])))
    pj2, qj2 = pj + d[6:9], qnorm(qmul(qj, qexp(d[9:12])))
    dp, dq = relative(pi2, qi2, pj2, qj2)
    return torch.cat([(dp - mdp) * wp, qlog(qmul(qconj(mdq), dq)) * wq])


def propose(pos: np.ndarray, times: np.ndarray, quat: np.ndarray, radius: float, min_gap: float, max_loops: int,
            suppression: int) -> np.ndarray:
    """(L, 2) pose pairs (i, j) of the valid proposed closures: for every
    pose j its nearest pose i more than ``min_gap`` seconds earlier; pairs
    closer than ``radius`` that are the nearest within ``suppression``
    poses either side; the ``max_loops`` closest, ties to the lower j."""
    n = len(pos)
    best_d2 = np.full(n, np.inf)
    best_i = np.zeros(n, np.int64)
    for j0 in range(0, n, 512):
        pj, tj = pos[j0 : j0 + 512], times[j0 : j0 + 512]
        d2 = ((pos[:, None, :] - pj[None, :, :]) ** 2).sum(-1)  # [i, j]
        d2 = np.where(tj[None, :] - times[:, None] > min_gap, d2, np.inf)
        best_i[j0 : j0 + 512] = np.argmin(d2, axis=0)
        best_d2[j0 : j0 + 512] = d2[best_i[j0 : j0 + 512], np.arange(d2.shape[1])]
    padded = np.concatenate([np.full(suppression, np.inf), best_d2, np.full(suppression, np.inf)])
    windows = np.lib.stride_tricks.sliding_window_view(padded, 2 * suppression + 1)
    local = best_d2 <= windows.min(1)
    score = np.where(local & (best_d2 < radius * radius), best_d2, np.inf)
    j = np.argsort(score, kind="stable")[:max_loops]
    j = j[np.isfinite(score[j])]
    return np.stack([best_i[j], j], -1)


def refine(slam: dict, fused: dict, rcfg: dict, dtype=torch.float64) -> dict:
    """The refinement of one fused drive (``fused``: the reference's own
    fusion outputs): refined positions and orientations, the cost before
    each step and after the last, and the closures' pose pairs."""
    T = lambda a: torch.as_tensor(np.asarray(a), dtype=dtype)  # noqa: E731
    w = rcfg["weights"]
    times = np.asarray(slam["timestamps"], np.float64)
    loops = propose(np.asarray(fused["pos"], np.float64), times, fused["sim3_quat"], rcfg["loop_radius"],
                    rcfg["loop_min_time_gap"], rcfg["max_loops"], rcfg["suppression_radius"])
    sp3, sq3 = T(fused["sim3_pos"]), T(fused["sim3_quat"])
    n = len(sp3)
    odo_dp, odo_dq = relative(sp3[:-1], sq3[:-1], sp3[1:], sq3[1:])
    li, lj = torch.as_tensor(loops[:, 0]), torch.as_tensor(loops[:, 1])
    loop_dp, loop_dq = relative(sp3[li], sq3[li], sp3[lj], sq3[lj])
    gps_valid = np.asarray(fused["valid"], bool)
    gps = T(np.nan_to_num(fused["aligned"]))[gps_valid]
    g_idx = np.flatnonzero(gps_valid)
    pairs_i = np.concatenate([np.arange(n - 1), loops[:, 0]])
    pairs_j = np.concatenate([np.arange(1, n), loops[:, 1]])
    meas_dp, meas_dq = torch.cat([odo_dp, loop_dp]), torch.cat([odo_dq, loop_dq])
    wp = torch.cat([torch.full((n - 1,), w["w_odo_p"]), torch.full((len(loops),), w["w_loop_p"])]).to(dtype)
    wq = torch.cat([torch.full((n - 1,), w["w_odo_q"]), torch.full((len(loops),), w["w_loop_q"])]).to(dtype)

    def res_pairs(d, pi, qi, pj, qj, mdp, mdq, a, b):
        return pair_residual(d, pi, qi, pj, qj, mdp, mdq, a, b)

    jac_pairs = vmap(jacrev(res_pairs), in_dims=(None, 0, 0, 0, 0, 0, 0, 0, 0))
    val_pairs = vmap(res_pairs, in_dims=(None, 0, 0, 0, 0, 0, 0, 0, 0))
    n_pair = len(pairs_i)
    # Sparse structure: pair k's 6 rows against poses i and j's 6 columns,
    # then each valid GNSS prior's 3 rows against its pose's positions.
    rows_p = np.repeat(np.arange(6 * n_pair).reshape(n_pair, 6, 1), 12, axis=2)
    cols_p = np.concatenate([6 * pairs_i[:, None] + np.arange(6), 6 * pairs_j[:, None] + np.arange(6)], 1)
    cols_p = np.broadcast_to(cols_p[:, None, :], (n_pair, 6, 12))
    n_g = len(g_idx)
    rows_g = 6 * n_pair + np.arange(3 * n_g)
    cols_g = (6 * g_idx[:, None] + np.arange(3)).reshape(-1)
    np_dt = np.float64 if dtype == torch.float64 else np.float32

    def residual(p, q):
        r_pair = val_pairs(torch.zeros(12, dtype=dtype), p[pairs_i], q[pairs_i], p[pairs_j], q[pairs_j], meas_dp,
                           meas_dq, wp, wq)
        return torch.cat([r_pair.reshape(-1), ((p[g_idx] - gps) * w["w_gps"]).reshape(-1)])

    def cost(p, q):
        r = residual(p, q)
        return 0.5 * float(torch.sum(r * r))

    p, q = T(fused["pos"]), T(fused["quat"])
    c = cost(p, q)
    history = [c]
    for _ in range(int(rcfg["iterations"])):
        Jp = jac_pairs(torch.zeros(12, dtype=dtype), p[pairs_i], q[pairs_i], p[pairs_j], q[pairs_j], meas_dp,
                       meas_dq, wp, wq)
        vals = np.concatenate([Jp.numpy().reshape(-1), np.full(3 * n_g, w["w_gps"], np_dt)])
        J = sp.csr_matrix((vals, (np.concatenate([rows_p.reshape(-1), rows_g]),
                                  np.concatenate([cols_p.reshape(-1), cols_g]))), shape=(6 * n_pair + 3 * n_g, 6 * n))
        r0 = residual(p, q).numpy()
        b = -(J.T @ r0)
        x = conjugate_gradients(lambda v: J.T @ (J @ v) + np_dt(rcfg["damping"]) * v, b, int(rcfg["cg_iters"]),
                                1e-10)
        d = torch.as_tensor(x.reshape(n, 6))
        p2, q2 = p + d[:, :3], qnorm(qmul(q, qexp(d[:, 3:])))
        c2 = cost(p2, q2)
        if c2 < c:
            p, q, c = p2, q2, c2
        history.append(c)
    return {"pos": p.numpy(), "quat": qnorm(q).numpy(), "cost": np.asarray(history), "loop_ij": loops}


def conjugate_gradients(A, b: np.ndarray, maxiter: int, tol: float) -> np.ndarray:
    """CG from zero: at most ``maxiter`` iterations, stopping once the
    residual's square is at most ``tol²`` times b·b."""
    atol2 = max(tol * tol * float(b @ b), 0.0)
    x = np.zeros_like(b)
    r = b.copy()
    p = r.copy()
    gamma = float(r @ r)
    for _ in range(maxiter):
        if not gamma > atol2:
            break
        ap = A(p)
        alpha = gamma / float(p @ ap)
        x = x + alpha * p
        r = r - alpha * ap
        gamma_new = float(r @ r)
        p = r + (gamma_new / gamma) * p
        gamma = gamma_new
    return x
