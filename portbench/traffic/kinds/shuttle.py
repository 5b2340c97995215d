"""The ``shuttle`` kind of traffic mix: one drive of ``poses`` poses, legs
over one road alternately forward and backward, leg ``outage_leg`` without
GNSS (``shuttle_sequence``), ``noise_m`` of fresh GNSS noise."""

from __future__ import annotations

import numpy as np

from portbench.traffic import generate


def drives(params: dict, rng: np.random.Generator) -> list:
    return [shuttle_sequence(int(params["poses"]), rng, float(params["noise_m"]), int(params["outage_leg"]))]


def shuttle_sequence(n: int, rng: np.random.Generator, noise_m: float, outage_leg: int):
    """``n`` poses of seq-04 legs, alternately forward and backward over the
    same road. A backward leg is the forward leg's SLAM and GNSS arrays in
    reverse time order, re-timed to follow on; every leg reuses the same
    SLAM coordinates, so one Sim(3) fits them all. Leg ``outage_leg`` has
    no GNSS. A return leg passes its forward twins within centimetres and
    more than 30 s later: revisits a loop-closure proposal finds."""
    g = generate.golden()
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
