"""The ``fleet`` kind of traffic mix: one drive at each of the mix's
``lengths``, each ``replica_sequence``, ``noise_m`` of fresh GNSS noise."""

from __future__ import annotations

import numpy as np

from portbench.traffic import generate


def drives(params: dict, rng: np.random.Generator) -> list:
    noise = float(params["noise_m"])
    return [replica_sequence(int(n), rng, noise) for n in params["lengths"]]


def replica_sequence(n: int, rng: np.random.Generator, noise_m: float = 0.02):
    """A sequence of ``n`` poses: time-shifted replicas of seq-04 (real GNSS
    noise and timing), ``noise_m`` of fresh noise a GNSS fix from ``rng``.
    The SLAM replicas are shifted by the stream's end-start vector and the
    GNSS replicas by the golden Sim(3)'s image of that shift, so all
    replicas share one Sim(3) and no residual sits near the RANSAC
    threshold."""
    g = generate.golden()
    st0, sp0, sq0 = g["slam_times"], g["slam_pos"], g["slam_quat"]
    gt0, gp0 = g["gps_times"], g["gps_utm"] - g["gps_utm"][0]
    n0 = len(st0)
    period = max(st0[-1] - st0[0], gt0[-1] - gt0[0]) + 2.0
    dstep_s = (sp0[-1] - sp0[0]) * (1.0 + 1.0 / n0)
    dstep_g = float(g["sim3_scale"]) * g["sim3_R"] @ dstep_s
    reps = -(-n // n0)
    ks = np.arange(reps)
    st = np.concatenate([st0 + k * period for k in ks])[:n]
    sp = np.concatenate([sp0 + k * dstep_s for k in ks])[:n]
    sq = np.tile(sq0, (reps, 1))[:n]
    gt = np.concatenate([gt0 + k * period for k in ks])
    gp = np.concatenate([gp0 + k * dstep_g + rng.normal(size=gp0.shape) * noise_m for k in ks])
    keep = gt <= st[-1] + 2.0
    return {"timestamps": st, "positions": sp, "quaternions": sq}, gt[keep], gp[keep]
