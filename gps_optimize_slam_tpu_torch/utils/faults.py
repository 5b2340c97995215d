"""GNSS fault injection — first-class test/benchmark fixtures.

The reference handles naturally gappy/noisy GPS (outage detection,
dead-reckoning, RTS recovery, RANSAC gating) but has no way to *produce*
faulty data on demand (SURVEY §5). These injectors synthesise the failure
modes the fusion stack must survive, for tests, robustness benchmarks
(BASELINE config 4), and regression fixtures.

All functions are pure NumPy (host-side fixture generation) and take an
explicit seed.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np


def inject_outages(
    valid: np.ndarray,
    spans: Sequence[Tuple[float, float]],
    times: np.ndarray,
) -> np.ndarray:
    """Mark GPS samples inside [start, end) time spans as unavailable."""
    valid = valid.copy()
    for start, end in spans:
        valid &= ~((times >= start) & (times < end))
    return valid


def inject_random_outages(
    valid: np.ndarray,
    times: np.ndarray,
    n_outages: int,
    duration_range: Tuple[float, float] = (2.0, 8.0),
    seed: int = 0,
) -> np.ndarray:
    """Drop ``n_outages`` random spans of GPS coverage."""
    rng = np.random.default_rng(seed)
    t0, t1 = float(times[0]), float(times[-1])
    spans = []
    for _ in range(n_outages):
        d = rng.uniform(*duration_range)
        s = rng.uniform(t0, max(t0, t1 - d))
        spans.append((s, s + d))
    return inject_outages(valid, spans, times)


def inject_gross_outliers(
    positions: np.ndarray,
    fraction: float = 0.05,
    magnitude: float = 50.0,
    seed: int = 0,
) -> Tuple[np.ndarray, np.ndarray]:
    """Teleport a fraction of fixes by ~magnitude metres (multipath-style).

    Returns (corrupted positions, outlier mask)."""
    rng = np.random.default_rng(seed)
    n = len(positions)
    k = max(1, int(round(n * fraction)))
    idx = rng.choice(n, k, replace=False)
    out = positions.copy()
    out[idx] += rng.normal(size=(k, 3)) * magnitude + np.sign(
        rng.normal(size=(k, 3))
    ) * magnitude * 0.5
    mask = np.zeros(n, bool)
    mask[idx] = True
    return out, mask


def inject_noise(
    positions: np.ndarray, sigma: float = 0.5, seed: int = 0
) -> np.ndarray:
    """Add isotropic Gaussian noise (urban-canyon degradation)."""
    rng = np.random.default_rng(seed)
    return positions + rng.normal(size=positions.shape) * sigma


def inject_bias_ramp(
    positions: np.ndarray,
    times: np.ndarray,
    ramp_per_sec: Sequence[float] = (0.05, 0.0, 0.0),
    start_time: Optional[float] = None,
) -> np.ndarray:
    """Slowly drifting bias (ionospheric-style error) from start_time on."""
    t0 = float(times[0]) if start_time is None else start_time
    dt = np.maximum(0.0, times - t0)
    return positions + dt[:, None] * np.asarray(ramp_per_sec)[None, :]
