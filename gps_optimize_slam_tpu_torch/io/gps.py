"""GNSS fix files (``ts lat lon alt ...``).

Replaces load_gps_data's parsing/validation stage (reference:
EKFGPSSLAM.py:249-264): space→comma delimiter fallback, ≥4 column check,
lat/lon range + exact-zero gating (quirk Q12). Projection and outlier
filtering happen downstream (pipeline)."""

from __future__ import annotations

from typing import Dict

import numpy as np


def read_gps_fixes(path: str, lon_first: bool = False) -> Dict[str, np.ndarray]:
    """Load raw GNSS fixes.

    ``lon_first`` handles ground-truth files with ``ts lon lat alt`` column
    order (like the shipped ``5.1Kitti04gps`` whose header is lon-first —
    quirk Q4: fed raw to a lat-first parser it projects into garbage).

    Returns {'timestamps', 'lats', 'lons', 'alts', 'valid'} — ``valid``
    flags rows passing |lat|≤90, |lon|≤180, lat≠0, lon≠0.
    """
    from gps_optimize_slam_tpu_torch.io.native import loadtxt

    try:
        # The native parser accepts both space- and comma-delimited tables
        # (the reference's two-delimiter fallback, EKFGPSSLAM.py:252-253).
        data = loadtxt(path)
    except (FileNotFoundError, ValueError) as e:
        if isinstance(e, FileNotFoundError) or "cannot open" in str(e):
            raise ValueError(f"GPS file not found: {path}")
        raise
    if data.ndim == 1:
        data = data.reshape(1, -1)
    if data.shape[1] < 4:
        raise ValueError(
            f"GPS file needs ≥4 columns (ts lat lon alt ...), got "
            f"{data.shape[1]}: {path}"
        )
    ts = data[:, 0].astype(float)
    if lon_first:
        lons, lats = data[:, 1].astype(float), data[:, 2].astype(float)
    else:
        lats, lons = data[:, 1].astype(float), data[:, 2].astype(float)
    alts = data[:, 3].astype(float)
    valid = (
        (np.abs(lats) <= 90)
        & (np.abs(lons) <= 180)
        & (lats != 0)
        & (lons != 0)
    )
    return {"timestamps": ts, "lats": lats, "lons": lons, "alts": alts, "valid": valid}
