"""The ``resampled`` kind of traffic mix: ``logs`` logs of ``poses`` poses,
their odometry at ``rate_hz``, each ``resampled_sequence``, ``noise_m`` of
fresh GNSS noise, no GNSS in every ``outage_every``-th replica.

A log at a higher rate is seq-04's drive at its own speed sampled more
often: its SLAM poses resampled on a 1 / ``rate_hz`` grid over its own time
span (positions linear between neighbours, orientations by slerp), and its
GNSS fixes at their real times (~10 Hz). Re-timing the 10-Hz poses would
drive the car ten times faster and turn it faster than the RTS stage's
sharp-turn gate allows.
"""

from __future__ import annotations

import functools

import numpy as np

from portbench.traffic import generate


def drives(params: dict, rng: np.random.Generator) -> list:
    n, rate = int(params["poses"]), float(params["rate_hz"])
    every, noise = int(params["outage_every"]), float(params["noise_m"])
    return [resampled_sequence(n, rate, every, rng, noise) for _ in range(int(params["logs"]))]


def pose_at(t: np.ndarray):
    """seq-04's SLAM pose at times ``t`` inside its span: positions linear
    between the two neighbouring poses, orientations (xyzw) by slerp
    between them, the shorter way. At a pose's own time, that pose."""
    g = generate.golden()
    st0, sp0, sq0 = g["slam_times"], g["slam_pos"], g["slam_quat"]
    t = np.asarray(t, np.float64)
    j = np.clip(np.searchsorted(st0, t, side="right") - 1, 0, len(st0) - 2)
    u = (t - st0[j]) / (st0[j + 1] - st0[j])
    pos = sp0[j] + u[:, None] * (sp0[j + 1] - sp0[j])
    q0, q1 = sq0[j], sq0[j + 1]
    dot = np.sum(q0 * q1, -1)
    q1 = np.where(dot[:, None] < 0, -q1, q1)
    theta = np.arccos(np.clip(np.abs(dot), 0.0, 1.0))
    s = np.sin(theta)
    small = s < 1e-12
    safe = np.where(small, 1.0, s)
    w0 = np.where(small, 1.0 - u, np.sin((1.0 - u) * theta) / safe)
    w1 = np.where(small, u, np.sin(u * theta) / safe)
    quat = w0[:, None] * q0 + w1[:, None] * q1
    return pos, quat / np.linalg.norm(quat, axis=-1, keepdims=True)


@functools.lru_cache(maxsize=4)
def replica(rate_hz: float):
    """One replica of seq-04's SLAM at ``rate_hz``: times on the grid
    t₀ + k / ``rate_hz`` up to its last pose's time, positions and
    orientations there (``pose_at``). 2,811 poses at 100 Hz."""
    st0 = generate.golden()["slam_times"]
    t = st0[0] + np.arange(int(np.floor((st0[-1] - st0[0]) * rate_hz + 1e-9)) + 1) / rate_hz
    pos, quat = pose_at(t)
    return t, pos, quat


@functools.lru_cache(maxsize=4)
def _slam(n: int, rate_hz: float) -> dict:
    """The SLAM stream of ``n`` poses (the same arrays for every log of a
    length and rate: nothing writes them)."""
    g = generate.golden()
    rt, rp, rq = replica(rate_hz)
    period, dstep_s, _ = chain(rate_hz)
    reps = -(-n // len(rt))
    ks = np.arange(reps)
    return {"timestamps": np.concatenate([rt + k * period for k in ks])[:n],
            "positions": np.concatenate([rp + k * dstep_s for k in ks])[:n],
            "quaternions": np.tile(rq, (reps, 1))[:n]}


def chain(rate_hz: float):
    """(period s, SLAM shift, GNSS shift) from one replica to the next, as
    ``fleet.replica_sequence`` chains them: the period is the longer
    stream's span and 2 s, the SLAM shift the replica's end-start vector
    and one mean step, the GNSS shift the golden Sim(3)'s image of it."""
    g = generate.golden()
    st0, gt0 = g["slam_times"], g["gps_times"]
    _, rp, _ = replica(rate_hz)
    period = max(st0[-1] - st0[0], gt0[-1] - gt0[0]) + 2.0
    dstep_s = (rp[-1] - rp[0]) * (1.0 + 1.0 / len(rp))
    return period, dstep_s, float(g["sim3_scale"]) * g["sim3_R"] @ dstep_s


def resampled_sequence(n: int, rate_hz: float, outage_every: int, rng: np.random.Generator, noise_m: float = 0.02):
    """A log of ``n`` poses at ``rate_hz``: replicas of the resampled seq-04
    chained (``chain``), so one Sim(3) fits every replica and no residual
    sits near the RANSAC threshold; each replica's GNSS at seq-04's real
    fix times, ``noise_m`` of fresh noise a fix from ``rng`` (drawn for
    every replica), none in replicas ``outage_every`` - 1, 2·``outage_every``
    - 1, ... (the first outage the ``outage_every``-th replica)."""
    g = generate.golden()
    slam = _slam(n, float(rate_hz))
    gt0, gp0 = g["gps_times"], g["gps_utm"] - g["gps_utm"][0]
    period, _, dstep_g = chain(float(rate_hz))
    reps = -(-n // len(replica(float(rate_hz))[0]))
    noise = rng.normal(size=(reps, *gp0.shape)) * noise_m
    ks = [k for k in range(reps) if (k + 1) % outage_every]
    gt = np.concatenate([gt0 + k * period for k in ks])
    gp = np.concatenate([gp0 + k * dstep_g + noise[k] for k in ks])
    keep = gt <= slam["timestamps"][-1] + 2.0
    return slam, gt[keep], gp[keep]
