"""KITTI oxts GNSS extraction (port of ``gps_optimize_slam_tpu.io.oxts``;
NumPy, on the host).

Replaces the reference's GPSmerge.py: parses the oxts ``timestamps.txt``
datetime strings, rebases them with a user time offset, joins the per-frame
``data/%010d.txt`` rows keeping lat/lon/alt plus the numsats/velmode quality
columns (oxts columns 25 and 27), and returns (or writes)
``ts lat lon alt numsats velmode`` rows.

Offset semantics: the reference adds the offset at every step, not once
(GPSmerge.py:29-34): a cumulative drift of +offset a frame (quirk Q3).
``cumulative_offset=True``, the default, reproduces it for parity with the
reference's files; False applies the offset once.
"""

from __future__ import annotations

import os
from datetime import datetime
from typing import Dict, Optional

import numpy as np

from gps_optimize_slam_tpu_torch.io import native


def parse_oxts_timestamps(timestamp_path: str, time_offset: float, cumulative_offset: bool = True) -> np.ndarray:
    """Parse oxts timestamps.txt and rebase to the user offset."""
    raw = []
    with open(timestamp_path) as f:
        for line in f:
            s = line.strip()
            if not s:
                continue
            t = datetime.strptime(s[:26], "%Y-%m-%d %H:%M:%S.%f")  # truncated to microseconds
            raw.append((t - datetime(1970, 1, 1)).total_seconds())
    raw = np.asarray(raw)
    if len(raw) == 0:
        return raw
    diffs = np.diff(raw)
    if cumulative_offset:
        # The reference's semantics: ts[i] = ts[i-1] + diff + offset.
        return time_offset + np.concatenate([[0.0], np.cumsum(diffs + time_offset)])
    return time_offset + np.concatenate([[0.0], np.cumsum(diffs)])


def _scan_frames(data_dir: str, times: np.ndarray):
    """(rows (n, 5): lat lon alt numsats velmode, their frames' times), one
    np.loadtxt a frame file; what ``native.oxts_scan`` does in one call."""
    rows, kept_times = [], []
    for idx, t in enumerate(times):
        f = os.path.join(data_dir, f"{idx:010d}.txt")
        if not os.path.exists(f):
            continue
        d = np.loadtxt(f)
        if d.ndim == 1:
            d = d[None, :]
        for r in d:
            rows.append((r[0], r[1], r[2], int(r[25]), int(r[27])))
            kept_times.append(t)
    if not rows:
        raise ValueError(f"no oxts data rows found under {data_dir}")
    return np.asarray(rows, dtype=float), np.asarray(kept_times)


def extract_oxts(
    oxts_folder: str,
    time_offset: float = 0.0,
    cumulative_offset: bool = True,
    output_file: Optional[str] = None,
) -> Dict[str, np.ndarray]:
    """Extract GNSS fixes from a KITTI oxts folder.

    Returns {'timestamps', 'lats', 'lons', 'alts', 'numsats', 'velmode'};
    writes the reference-format combined file if ``output_file`` is given.
    The frame files are read by the native scanner when the shared library
    is there and reads them all, else one by one."""
    ts_path = os.path.join(oxts_folder, "timestamps.txt")
    data_dir = os.path.join(oxts_folder, "data")
    if not os.path.exists(ts_path):
        raise ValueError(f"timestamps file not found: {ts_path}")
    if not os.path.isdir(data_dir):
        raise ValueError(f"oxts data folder not found: {data_dir}")

    times = parse_oxts_timestamps(ts_path, time_offset, cumulative_offset)
    try:
        native_rows = native.oxts_scan(data_dir, len(times))
    except ValueError:
        native_rows = None  # a file the scanner refuses: read them one by one
    if native_rows is not None and len(native_rows):
        arr = native_rows[:, 1:]
        kept_times = times[native_rows[:, 0].astype(int)]
    else:
        arr, kept_times = _scan_frames(data_dir, times)
    out = {
        "timestamps": np.asarray(kept_times),
        "lats": arr[:, 0],
        "lons": arr[:, 1],
        "alts": arr[:, 2],
        "numsats": arr[:, 3].astype(int),
        "velmode": arr[:, 4].astype(int),
    }
    if output_file:
        with open(output_file, "w") as f:
            for t, la, lo, al, ns, vm in zip(
                out["timestamps"], out["lats"], out["lons"], out["alts"], out["numsats"], out["velmode"]
            ):
                f.write(f"{t:.18e} {la} {lo} {al} {ns} {vm}\n")
    return out
