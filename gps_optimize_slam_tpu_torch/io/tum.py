"""TUM-format trajectory files (``ts x y z qx qy qz qw``).

Replaces load_slam_trajectory (reference: EKFGPSSLAM.py:110-125) and the
TUM export block (EKFGPSSLAM.py:1086-1105)."""

from __future__ import annotations

from typing import Dict

import numpy as np


def read_tum(path: str) -> Dict[str, np.ndarray]:
    """Load and validate a TUM trajectory file.

    Returns {'timestamps': (N,), 'positions': (N,3), 'quaternions': (N,4)}.
    """
    from gps_optimize_slam_tpu_torch.io.native import loadtxt

    try:
        data = loadtxt(path)
    except (FileNotFoundError, ValueError) as e:
        if isinstance(e, FileNotFoundError) or "cannot open" in str(e):
            raise ValueError(f"SLAM trajectory file not found: {path}")
        raise
    if data.ndim == 1:
        data = data.reshape(1, -1)
    if data.shape[1] != 8:
        raise ValueError(
            f"TUM file must have 8 columns (ts x y z qx qy qz qw), got "
            f"{data.shape[1]}: {path}"
        )
    return {
        "timestamps": data[:, 0].astype(float),
        "positions": data[:, 1:4].astype(float),
        "quaternions": data[:, 4:8].astype(float),
    }


def write_tum(
    path: str,
    timestamps: np.ndarray,
    positions: np.ndarray,
    quaternions: np.ndarray,
    header: str = "timestamp x y z qx qy qz qw",
    position_fmt: str = "%.6f",
) -> None:
    """Write a TUM trajectory (same numeric formats as the reference
    exporter, EKFGPSSLAM.py:1092). Unlike the reference — which writes a BARE
    header line its own loader cannot re-read — the header is '#'-prefixed
    (standard TUM convention), so exports round-trip through read_tum."""
    out = np.column_stack([timestamps, positions, quaternions])
    np.savetxt(
        path,
        out,
        fmt=["%.6f"] + [position_fmt] * 3 + ["%.8f"] * 4,
        header=header,
        comments="# ",
    )


def write_wgs84(
    path: str,
    timestamps: np.ndarray,
    lonlatalt: np.ndarray,
    quaternions: np.ndarray,
) -> None:
    """WGS84 export ``ts lon lat alt qx qy qz qw``
    (reference: EKFGPSSLAM.py:1096-1102)."""
    out = np.column_stack([timestamps, lonlatalt, quaternions])
    np.savetxt(
        path,
        out,
        fmt=["%.6f", "%.8f", "%.8f", "%.3f"] + ["%.8f"] * 4,
        header="timestamp lon lat alt qx qy qz qw (WGS84)",
        comments="# ",
    )
