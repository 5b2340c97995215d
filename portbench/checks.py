"""The numbers that decide ``correct``: each the widest gap between what a
request's timed path returned and what the plain reference computes from
the same inputs. A drive's outputs are a dict of host arrays: ``aligned``
(N, 3) with NaN where not valid, ``valid``, ``inliers`` (N,) bool,
``sim3_pos`` (N, 3), ``pos`` (N, 3), ``quat`` (N, 4).

* ``aligned_m``: the GNSS positions on the SLAM times, metres, where both
  sides call them valid; ``valid_diff`` and ``inlier_diff``: poses whose
  GNSS validity or Sim(3) inlier flag differs;
* ``sim3_m``: the Sim(3)-aligned trajectory, metres (the scale, rotation
  and translation together);
* ``fused_m`` and ``fused_quat``: the EKF/RTS positions, metres, and
  orientations (sign-free);
* ``drives_diff``: drives of the request with no outputs.
"""

from __future__ import annotations

import numpy as np

from portbench.reference import fusion as ref

def reference_drive(slam: dict, gps_t, gps_p, cfg: dict, dtype) -> dict:
    """The reference's outputs of one drive in the layout above."""
    f = ref.fuse(slam, gps_t, gps_p, cfg["fusion"], dtype)
    return {"aligned": f.aligned, "valid": f.valid, "inliers": f.inliers, "sim3_pos": f.sim3_pos, "pos": f.pos,
            "quat": f.quat, "sim3_quat": f.sim3_quat}


def quat_gap(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.minimum(np.abs(a - b).max(-1), np.abs(a + b).max(-1)).max())


def drive_gaps(got: dict, want: dict) -> dict:
    both = np.asarray(got["valid"], bool) & np.asarray(want["valid"], bool)
    ga, wa = np.asarray(got["aligned"], np.float64)[both], np.asarray(want["aligned"], np.float64)[both]
    out = {
        "aligned_m": float(np.abs(ga - wa).max()) if both.any() else 0.0,
        "valid_diff": int((np.asarray(got["valid"], bool) != np.asarray(want["valid"], bool)).sum()),
        "inlier_diff": int((np.asarray(got["inliers"], bool) != np.asarray(want["inliers"], bool)).sum()),
        "sim3_m": float(np.abs(np.asarray(got["sim3_pos"], np.float64) - want["sim3_pos"]).max()),
        "fused_m": float(np.abs(np.asarray(got["pos"], np.float64) - want["pos"]).max()),
        "fused_quat": quat_gap(got["quat"], want["quat"]),
    }
    for k, v in out.items():  # a NaN gap is no agreement
        if v != v:
            out[k] = float("inf")
    return out


def worst(gaps: list, missing: int = 0) -> dict:
    """The largest of each number over drives, and ``drives_diff``: the
    drives of the request that came back without outputs."""
    return {**{k: max(g[k] for g in gaps) for k in gaps[0]}, "drives_diff": missing}


def refine_gaps(got: dict, want: dict) -> dict:
    """The refinement's numbers: ``refined_m`` and ``refined_quat``, the
    refined positions (metres) and orientations (sign-free);
    ``closure_diff``, closures proposed on one side only; ``cost_rel``, the
    cost history, relative."""
    a = {tuple(x) for x in np.asarray(got["loop_ij"]).reshape(-1, 2).tolist()}
    b = {tuple(x) for x in np.asarray(want["loop_ij"]).reshape(-1, 2).tolist()}
    gc, wc = np.asarray(got["cost"], np.float64), np.asarray(want["cost"], np.float64)
    out = {"refined_m": float(np.abs(np.asarray(got["refined_pos"], np.float64) - want["pos"]).max()),
           "refined_quat": quat_gap(got["refined_quat"], want["quat"]),
           "closure_diff": len(a ^ b),
           "cost_rel": float((np.abs(gc - wc) / np.abs(wc)).max()) if gc.shape == wc.shape else float("inf")}
    return {k: (float("inf") if v != v else v) for k, v in out.items()}
