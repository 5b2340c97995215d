"""Geodetic transforms on tensors (port of ``gps_optimize_slam_tpu.ops.geodesy``).

* ``utm_forward`` / ``utm_inverse``: transverse Mercator by the 6th-order
  Krüger series (Karney 2011), as the JAX package computes it.
* ``wgs84_to_ecef`` / ``ecef_to_enu`` / ``wgs84_to_enu``: the local
  East/North/Up frame, whose small coordinates keep float32 usable on the card.
* ``utm_zone_from_lonlat``: zone/hemisphere pick (reference
  EKFGPSSLAM.py:127-134).

Callers run these in float64 on the CPU whatever the working dtype and device
(``pipeline.load_and_project_gps``): ECEF/UTM intermediates are ~6.4e6 m, and
a float32 projection loses ~0.5 m before the fusion starts. Angles are in
degrees at the API boundary, radians inside.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

# WGS84 ellipsoid.
WGS84_A = 6378137.0
WGS84_F = 1.0 / 298.257223563
WGS84_E2 = WGS84_F * (2.0 - WGS84_F)
WGS84_E = WGS84_E2**0.5
WGS84_B = WGS84_A * (1.0 - WGS84_F)

UTM_K0 = 0.9996
UTM_FALSE_EASTING = 500000.0
UTM_FALSE_NORTHING_SOUTH = 10000000.0

# Third flattening n = f / (2 - f) and the rectifying radius
# A = a/(1+n) (1 + n²/4 + n⁴/64 + n⁶/256).
_N = WGS84_F / (2.0 - WGS84_F)
_A_RECT = (
    WGS84_A
    / (1.0 + _N)
    * (1.0 + _N**2 / 4.0 + _N**4 / 64.0 + _N**6 / 256.0)
)

# Krüger series coefficients (Karney 2011, eqs. 35/36), 6th order in n.
_ALPHA = (
    _N / 2.0 - 2.0 * _N**2 / 3.0 + 5.0 * _N**3 / 16.0 + 41.0 * _N**4 / 180.0
    - 127.0 * _N**5 / 288.0 + 7891.0 * _N**6 / 37800.0,
    13.0 * _N**2 / 48.0 - 3.0 * _N**3 / 5.0 + 557.0 * _N**4 / 1440.0
    + 281.0 * _N**5 / 630.0 - 1983433.0 * _N**6 / 1935360.0,
    61.0 * _N**3 / 240.0 - 103.0 * _N**4 / 140.0 + 15061.0 * _N**5 / 26880.0
    + 167603.0 * _N**6 / 181440.0,
    49561.0 * _N**4 / 161280.0 - 179.0 * _N**5 / 168.0
    + 6601661.0 * _N**6 / 7257600.0,
    34729.0 * _N**5 / 80640.0 - 3418889.0 * _N**6 / 1995840.0,
    212378941.0 * _N**6 / 319334400.0,
)
_BETA = (
    _N / 2.0 - 2.0 * _N**2 / 3.0 + 37.0 * _N**3 / 96.0 - _N**4 / 360.0
    - 81.0 * _N**5 / 512.0 + 96199.0 * _N**6 / 604800.0,
    _N**2 / 48.0 + _N**3 / 15.0 - 437.0 * _N**4 / 1440.0 + 46.0 * _N**5 / 105.0
    - 1118711.0 * _N**6 / 3870720.0,
    17.0 * _N**3 / 480.0 - 37.0 * _N**4 / 840.0 - 209.0 * _N**5 / 4480.0
    + 5569.0 * _N**6 / 90720.0,
    4397.0 * _N**4 / 161280.0 - 11.0 * _N**5 / 504.0
    - 830251.0 * _N**6 / 7257600.0,
    4583.0 * _N**5 / 161280.0 - 108847.0 * _N**6 / 3991680.0,
    20648693.0 * _N**6 / 638668800.0,
)


def utm_zone_from_lonlat(lons, lats) -> Tuple[int, bool]:
    """UTM zone + southern-hemisphere flag from mean lon/lat (reference
    auto_utm_projection, EKFGPSSLAM.py:127-134). Host-side, NumPy in."""
    import numpy as np

    lons = np.asarray(lons)
    lats = np.asarray(lats)
    if lons.size == 0 or lats.size == 0:
        raise ValueError("empty lon/lat arrays — cannot determine UTM zone")
    zone = int((float(np.mean(lons)) + 180.0) // 6.0 + 1.0)
    south = bool(np.mean(lats) < 0.0)
    return zone, south


def utm_central_meridian_deg(zone: int) -> float:
    return float(zone) * 6.0 - 183.0


def utm_forward(
    lon_deg: torch.Tensor, lat_deg: torch.Tensor, zone: int, south: bool = False
) -> Tuple[torch.Tensor, torch.Tensor]:
    """WGS84 geodetic → UTM easting/northing (metres), Krüger series."""
    lat = torch.deg2rad(lat_deg)
    lon0 = math.radians(utm_central_meridian_deg(zone))
    lam = torch.deg2rad(lon_deg) - lon0
    lam = torch.atan2(torch.sin(lam), torch.cos(lam))  # wrap to (-pi, pi]

    s_lat = torch.sin(lat)
    tau = torch.tan(lat)
    sigma = torch.sinh(WGS84_E * torch.atanh(WGS84_E * s_lat))
    taup = tau * torch.sqrt(1.0 + sigma**2) - sigma * torch.sqrt(1.0 + tau**2)

    xi_p = torch.atan2(taup, torch.cos(lam))
    eta_p = torch.asinh(torch.sin(lam) / torch.sqrt(taup**2 + torch.cos(lam) ** 2))

    xi = xi_p
    eta = eta_p
    for j, a in enumerate(_ALPHA, start=1):
        xi = xi + a * torch.sin(2.0 * j * xi_p) * torch.cosh(2.0 * j * eta_p)
        eta = eta + a * torch.cos(2.0 * j * xi_p) * torch.sinh(2.0 * j * eta_p)

    x = UTM_K0 * _A_RECT * eta + UTM_FALSE_EASTING
    y = UTM_K0 * _A_RECT * xi
    if south:
        y = y + UTM_FALSE_NORTHING_SOUTH
    return x, y


def utm_inverse(
    x: torch.Tensor,
    y: torch.Tensor,
    zone: int,
    south: bool = False,
    newton_iters: int = 3,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """UTM easting/northing → WGS84 lon/lat (degrees), Krüger inverse series
    with a fixed-count Newton step for the conformal latitude."""
    y_adj = y - (UTM_FALSE_NORTHING_SOUTH if south else 0.0)
    xi = y_adj / (UTM_K0 * _A_RECT)
    eta = (x - UTM_FALSE_EASTING) / (UTM_K0 * _A_RECT)

    xi_p = xi
    eta_p = eta
    for j, b in enumerate(_BETA, start=1):
        xi_p = xi_p - b * torch.sin(2.0 * j * xi) * torch.cosh(2.0 * j * eta)
        eta_p = eta_p - b * torch.cos(2.0 * j * xi) * torch.sinh(2.0 * j * eta)

    taup = torch.sin(xi_p) / torch.sqrt(torch.sinh(eta_p) ** 2 + torch.cos(xi_p) ** 2)
    lam = torch.atan2(torch.sinh(eta_p), torch.cos(xi_p))

    # Invert tau'(tau) by Newton: tau' = tau √(1+σ²) − σ √(1+τ²).
    tau = taup / (1.0 - WGS84_E2)
    for _ in range(newton_iters):
        sigma = torch.sinh(
            WGS84_E * torch.atanh(WGS84_E * tau / torch.sqrt(1.0 + tau**2))
        )
        f = tau * torch.sqrt(1.0 + sigma**2) - sigma * torch.sqrt(1.0 + tau**2) - taup
        dtau = (
            (torch.sqrt((1.0 + sigma**2) * (1.0 + tau**2)) - sigma * tau)
            * (1.0 - WGS84_E2)
            * torch.sqrt(1.0 + tau**2)
            / (1.0 + (1.0 - WGS84_E2) * tau**2)
        )
        tau = tau - f / dtau

    lat = torch.atan(tau)
    lon = torch.rad2deg(lam) + utm_central_meridian_deg(zone)
    return lon, torch.rad2deg(lat)


def wgs84_to_ecef(
    lon_deg: torch.Tensor, lat_deg: torch.Tensor, alt: torch.Tensor
) -> torch.Tensor:
    """Geodetic lon/lat/alt → ECEF xyz (metres), stacked on the last axis."""
    lon = torch.deg2rad(lon_deg)
    lat = torch.deg2rad(lat_deg)
    s, c = torch.sin(lat), torch.cos(lat)
    n_rad = WGS84_A / torch.sqrt(1.0 - WGS84_E2 * s * s)
    x = (n_rad + alt) * c * torch.cos(lon)
    y = (n_rad + alt) * c * torch.sin(lon)
    z = (n_rad * (1.0 - WGS84_E2) + alt) * s
    return torch.stack([x, y, z], dim=-1)


def ecef_to_enu(
    ecef: torch.Tensor, ref_lon_deg, ref_lat_deg, ref_ecef: torch.Tensor
) -> torch.Tensor:
    """ECEF xyz → local East/North/Up about a reference point."""
    lon = torch.deg2rad(torch.as_tensor(ref_lon_deg, dtype=ecef.dtype))
    lat = torch.deg2rad(torch.as_tensor(ref_lat_deg, dtype=ecef.dtype))
    sl, cl = torch.sin(lon), torch.cos(lon)
    sp, cp = torch.sin(lat), torch.cos(lat)
    zero = torch.zeros_like(sl)
    rot = torch.stack(
        [
            torch.stack([-sl, cl, zero]),
            torch.stack([-sp * cl, -sp * sl, cp]),
            torch.stack([cp * cl, cp * sl, sp]),
        ]
    ).to(ecef.device)
    return (ecef - ref_ecef) @ rot.T


def wgs84_to_enu(
    lon_deg: torch.Tensor,
    lat_deg: torch.Tensor,
    alt: torch.Tensor,
    ref_lon_deg,
    ref_lat_deg,
    ref_alt,
) -> torch.Tensor:
    """Geodetic → local ENU about (ref_lon, ref_lat, ref_alt) in one call."""
    ref = lambda v: torch.as_tensor(v, dtype=lon_deg.dtype, device=lon_deg.device)  # noqa: E731
    ecef = wgs84_to_ecef(lon_deg, lat_deg, alt)
    ref_ecef = wgs84_to_ecef(ref(ref_lon_deg), ref(ref_lat_deg), ref(ref_alt))
    return ecef_to_enu(ecef, ref_lon_deg, ref_lat_deg, ref_ecef)
