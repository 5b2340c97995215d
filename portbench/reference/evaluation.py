"""Plain reference of the error report a request computes for each drive
(the system's reference recipe, ``EKFGPSSLAM.py:1021-1031``, and the paired
ATE beside it): the distance of each pose of the raw SLAM, Sim(3)-aligned and
EKF/RTS trajectories to its nearest GNSS position on the SLAM times, and the
distance of each Sim(3)-aligned and fused pose to the GNSS position at its
own time; each summarised by mean, median, RMSE, max and count. NumPy and
SciPy on the host; it imports nothing of the program under test.

It works from the reference's own fusion of the drive
(``portbench.checks.reference_drive``), computed another way than the
program computes it:

* the gate: a pose counts where its GNSS position is valid and its time is
  later than the drive's first time + ``skip_seconds``; the same gate picks
  the queries and the candidates of a nearest-neighbour search;
* nearest neighbours: an exact k-d tree (``scipy.spatial.cKDTree``) over the
  gated GNSS positions, where the program prunes tiles by boxes and scans
  what is kept;
* the median: the mean of the two middle order statistics of the sorted
  distances; no gated pose: mean and RMSE 0, median +inf, max −inf (the
  program's conventions).

``dtype`` is the precision the distances and statistics are taken in
(float64, or float32 for the control; the tree's own arithmetic is
float64 on the coordinates rounded to ``dtype``).
"""

from __future__ import annotations

import numpy as np
from scipy.spatial import cKDTree

EVALUATIONS = ("nn_slam", "nn_sim3", "nn_ekf", "ate_sim3", "ate_ekf")
STATS = ("mean", "median", "rmse", "max", "count")


def gate(slam_t, valid, skip_seconds: float = 5.0) -> np.ndarray:
    """Valid and strictly later than the first time + ``skip_seconds``."""
    t = np.asarray(slam_t, np.float64)
    return np.asarray(valid, bool) & (t > t[0] + skip_seconds)


def stats(errors, dtype=np.float64) -> dict:
    """Mean, median, RMSE, max and count of ``errors``, in ``dtype``."""
    e = np.asarray(errors, dtype)
    n = len(e)
    if n == 0:
        return {"mean": 0.0, "median": float("inf"), "rmse": 0.0, "max": float("-inf"), "count": 0}
    s = np.sort(e)
    return {"mean": float(e.sum(dtype=dtype) / dtype(n)), "median": float((s[(n - 1) // 2] + s[n // 2]) / dtype(2)),
            "rmse": float(np.sqrt((e * e).sum(dtype=dtype) / dtype(n))), "max": float(s[-1]), "count": n}


def evaluate(slam: dict, fused: dict, dtype=np.float64, skip_seconds: float = 5.0) -> dict:
    """``{evaluation: {stat: value}}`` of one drive: ``slam`` its SLAM
    stream (``timestamps``, ``positions``), ``fused`` the reference's
    fusion of it (``aligned``, ``valid``, ``sim3_pos``, ``pos``), each
    evaluation of ``EVALUATIONS`` with the stats of ``STATS``."""
    dtype = np.dtype(dtype).type
    g = gate(slam["timestamps"], fused["valid"], skip_seconds)
    track = np.asarray(fused["aligned"], dtype)[g]
    trajs = {"slam": slam["positions"], "sim3": fused["sim3_pos"], "ekf": fused["pos"]}
    out = {}
    if len(track):
        tree = cKDTree(track.astype(np.float64))
    for name, traj in trajs.items():
        q = np.asarray(traj, dtype)[g]
        d = tree.query(q.astype(np.float64), k=1, eps=0.0, workers=-1)[0] if len(track) else np.zeros(0)
        out[f"nn_{name}"] = stats(d.astype(dtype), dtype)
    for name in ("sim3", "ekf"):
        diff = np.asarray(trajs[name], dtype)[g] - track
        out[f"ate_{name}"] = stats(np.sqrt((diff * diff).sum(-1, dtype=dtype)), dtype)
    return {k: out[k] for k in EVALUATIONS}
