"""The one traffic generator of the benchmark: it reads a mix's parameters
(``traffic/<name>.json``) and a seed, and makes the host arrays of each
request variant. Every stream is real-derived: replicas of the KITTI
odometry seq-04 SLAM trajectory and its GNSS fixes (``data/seq04_golden.npz``,
the reference implementation's own arrays), with fresh GNSS noise drawn from
the seed.

Kinds of mix:

* ``fleet``: one drive at each of the given ``lengths``
  (``replica_sequence`` each);
* ``shuttle``: one drive of ``poses`` poses, legs over one road
  alternately forward and backward, leg ``outage_leg`` without GNSS
  (``shuttle_sequence``).

Every variant of a mix has the same shapes; variants differ in their noise.
A drive is ``(slam, gps_times, gps_positions)``: ``slam`` a dict of
``timestamps`` (N,), ``positions`` (N, 3), ``quaternions`` (N, 4) xyzw; the
GNSS in a local frame (UTM minus the golden track's first fix), float64.
"""

from __future__ import annotations

import functools
import json
import os

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(os.path.dirname(HERE), "data", "seq04_golden.npz")


@functools.lru_cache(maxsize=1)
def golden():
    """The seq-04 arrays: SLAM times, positions and quaternions, GNSS times
    and UTM positions, and the reference's Sim(3) scale and rotation."""
    g = np.load(GOLDEN)
    return {k: g[k] for k in ("slam_times", "slam_pos", "slam_quat", "gps_times", "gps_utm", "sim3_scale", "sim3_R")}


def replica_sequence(n: int, rng: np.random.Generator, noise_m: float = 0.02):
    """A sequence of ``n`` poses: time-shifted replicas of seq-04 (real GNSS
    noise and timing), ``noise_m`` of fresh noise a GNSS fix from ``rng``.
    The SLAM replicas are shifted by the stream's end-start vector and the
    GNSS replicas by the golden Sim(3)'s image of that shift, so all
    replicas share one Sim(3) and no residual sits near the RANSAC
    threshold."""
    g = golden()
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


def shuttle_sequence(n: int, rng: np.random.Generator, noise_m: float, outage_leg: int):
    """``n`` poses of seq-04 legs, alternately forward and backward over the
    same road. A backward leg is the forward leg's SLAM and GNSS arrays in
    reverse time order, re-timed to follow on; every leg reuses the same
    SLAM coordinates, so one Sim(3) fits them all. Leg ``outage_leg`` has
    no GNSS. A return leg passes its forward twins within centimetres and
    more than 30 s later: revisits a loop-closure proposal finds."""
    g = golden()
    st0, sp0, sq0 = g["slam_times"], g["slam_pos"], g["slam_quat"]
    gt0, gp0 = g["gps_times"], g["gps_utm"] - g["gps_utm"][0]
    start, end = min(st0[0], gt0[0]), max(st0[-1], gt0[-1])
    period = end - start + 2.0
    st, sp, sq, gt, gp = [], [], [], [], []
    for k in range(-(-n // len(st0))):
        back = k % 2 == 1
        remap = (lambda t: end - t[::-1]) if back else (lambda t: t - start)
        flip = (lambda a: a[::-1]) if back else (lambda a: a)
        st.append(remap(st0) + k * period)
        sp.append(flip(sp0))
        sq.append(flip(sq0))
        if k != outage_leg:
            gt.append(remap(gt0) + k * period)
            gp.append(flip(gp0) + rng.normal(size=gp0.shape) * noise_m)
    st, sp, sq = (np.concatenate(a)[:n] for a in (st, sp, sq))
    gt, gp = np.concatenate(gt), np.concatenate(gp)
    keep = gt <= st[-1] + 2.0
    return {"timestamps": st, "positions": sp, "quaternions": sq}, gt[keep], gp[keep]


def load(name: str) -> dict:
    """The parameters of the mix ``traffic/<name>.json``."""
    with open(os.path.join(HERE, f"{name}.json")) as f:
        return json.load(f)


def drives(params: dict, rng: np.random.Generator) -> list:
    """One request's drives under the mix ``params``, noise from ``rng``."""
    kind, noise = params["kind"], float(params["noise_m"])
    if kind == "fleet":
        return [replica_sequence(int(n), rng, noise) for n in params["lengths"]]
    if kind == "shuttle":
        return [shuttle_sequence(int(params["poses"]), rng, noise, int(params["outage_leg"]))]
    raise ValueError(f"unknown kind of traffic mix: {kind!r}")


def requests(params: dict, seed: int) -> list:
    """``params["variants"]`` requests, each a list of drives, from ``seed``
    (any non-negative whole number), and one RANSAC seed a drive (below
    2**31): ``[(drives, seeds)]``."""
    root = np.random.default_rng(int(seed))
    out = []
    for _ in range(int(params["variants"])):
        rng = np.random.default_rng(root.integers(0, 2**63 - 1))
        ds = drives(params, rng)
        out.append((ds, [int(s) for s in rng.integers(0, 2**31 - 1, size=len(ds))]))
    return out


def real_poses(request) -> int:
    """The real (unpadded) SLAM poses of a request."""
    return sum(len(slam["timestamps"]) for slam, _, _ in request[0])
