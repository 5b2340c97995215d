"""The port's elementwise geometry against the JAX package, CPU float64.

Tolerances: ≤1e-12 relative (same formulas, same operation order; the
difference is the two libraries' rounding of transcendentals and sums);
the geodesy round trip ≤1e-8 m, as ``tests/test_geodesy.py`` holds JAX.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch
from scipy.spatial.transform import Rotation

from gps_optimize_slam_tpu.ops import geodesy as jgeo
from gps_optimize_slam_tpu.ops import linalg3 as jlin
from gps_optimize_slam_tpu.ops import quaternion as jq
from gps_optimize_slam_tpu.ops import se3 as jse3
from gps_optimize_slam_tpu.ops import umeyama as jum
from gps_optimize_slam_tpu_torch.ops import geodesy as tgeo
from gps_optimize_slam_tpu_torch.ops import linalg3 as tlin
from gps_optimize_slam_tpu_torch.ops import quaternion as tq
from gps_optimize_slam_tpu_torch.ops import se3 as tse3
from gps_optimize_slam_tpu_torch.ops import umeyama as tum

RTOL = 1e-12


def close(got, want, rtol=RTOL, atol=0.0):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=rtol, atol=atol)


def t(x):
    return torch.tensor(np.asarray(x), dtype=torch.float64)


def quats(rng, n, zero_rows=()):
    q = rng.normal(size=(n, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    for i in zero_rows:
        q[i] = 0.0
    return q


def test_quaternion_ops_match_jax():
    rng = np.random.default_rng(0)
    q1, q2 = quats(rng, 64, zero_rows=(5,)), quats(rng, 64)
    q1[9] *= 1e-10  # below the 1e-9 normalisation floor
    v = rng.normal(size=(64, 3)) * 10
    close(tq.normalize(t(q1)), jq.normalize(jnp.asarray(q1)))
    close(tq.mul(t(q1), t(q2)), jq.mul(jnp.asarray(q1), jnp.asarray(q2)), atol=1e-15)
    close(tq.rotate(t(q2), t(v)), jq.rotate(jnp.asarray(q2), jnp.asarray(v)), atol=1e-13)
    close(tq.yaw(t(q2)), jq.yaw(jnp.asarray(q2)))
    close(tq.wrap_angle(t(v[:, 0])), jq.wrap_angle(jnp.asarray(v[:, 0])))
    for w in (0.0, 0.3, 1.0, 1.7):
        close(tq.nlerp(t(q1), t(q2), w), jq.nlerp(jnp.asarray(q1), jnp.asarray(q2), w), atol=1e-15)
    m = np.asarray(jq.to_matrix(jnp.asarray(q2)))
    close(tq.from_matrix(t(m)), jq.from_matrix(jnp.asarray(m)), atol=1e-15)


def test_quaternion_inverse_and_matrix_match_jax_and_scipy():
    """``inv`` (non-unit quaternions too) and ``to_matrix`` against the JAX
    package; ``to_matrix`` also against scipy's Rotation, as
    ``tests/test_quaternion.py::test_to_matrix_matches_scipy`` holds JAX."""
    rng = np.random.default_rng(11)
    q = quats(rng, 64)
    scaled = q * rng.uniform(0.1, 10.0, size=(64, 1))
    close(tq.inv(t(scaled)), jq.inv(jnp.asarray(scaled)))
    close(tq.mul(t(scaled), tq.inv(t(scaled))), np.tile([0.0, 0.0, 0.0, 1.0], (64, 1)), atol=1e-15)
    got = tq.to_matrix(t(q))
    assert got.shape == (64, 3, 3)
    close(got, jq.to_matrix(jnp.asarray(q)), atol=1e-15)
    close(got, Rotation.from_quat(q).as_matrix(), atol=1e-12)
    close(tq.to_matrix(t(q.reshape(4, 16, 4))), jq.to_matrix(jnp.asarray(q.reshape(4, 16, 4))), atol=1e-15)


def test_se3_ops_match_jax_including_zero_norm():
    rng = np.random.default_rng(1)
    n = 50
    pos = np.cumsum(rng.normal(size=(n, 3)), axis=0)
    q = quats(rng, n, zero_rows=(0, 17, 18))
    dp, dq = tse3.relative_poses_along(t(pos), t(q))
    jdp, jdq = jse3.relative_poses_along(jnp.asarray(pos), jnp.asarray(q))
    close(dp, jdp, atol=1e-13)
    close(dq, jdq, atol=1e-15)
    np.testing.assert_array_equal(dp.numpy()[16:19], 0.0)  # degenerate → no motion
    np.testing.assert_array_equal(dq.numpy()[17], [0.0, 0.0, 0.0, 1.0])
    p2, q2 = tse3.compose(t(pos[3]), t(q[3]), dp[3], dq[3])
    jp2, jq2 = jse3.compose(jnp.asarray(pos[3]), jnp.asarray(q[3]), jdp[3], jdq[3])
    close(p2, jp2, atol=1e-13)
    close(q2, jq2, atol=1e-15)
    R = np.asarray(jq.to_matrix(jnp.asarray(quats(rng, 1)[0])))
    tp, tqq = tse3.transform_trajectory(t(pos), t(q), t(R), t([1.0, -2.0, 3.0]), 0.987)
    jp, jqq = jse3.transform_trajectory(
        jnp.asarray(pos), jnp.asarray(q), jnp.asarray(R), jnp.asarray([1.0, -2.0, 3.0]), 0.987
    )
    close(tp, jp, atol=1e-12)
    close(tqq, jqq, atol=1e-15)


@pytest.mark.parametrize("south", [False, True])
def test_utm_forward_inverse_match_jax(south):
    rng = np.random.default_rng(2)
    zone = 32
    lat = (-1 if south else 1) * (49.03 + rng.uniform(-2, 2, 200))
    lon = 9.0 + rng.uniform(-3, 3, 200)
    x, y = tgeo.utm_forward(t(lon), t(lat), zone, south)
    jx, jy = jgeo.utm_forward(jnp.asarray(lon), jnp.asarray(lat), zone, south)
    close(x, jx)
    close(y, jy)
    lo, la = tgeo.utm_inverse(x, y, zone, south)
    jlo, jla = jgeo.utm_inverse(jx, jy, zone, south)
    close(lo, jlo)
    close(la, jla)
    # Round trip through the port alone, in metres.
    x2, y2 = tgeo.utm_forward(lo, la, zone, south)
    assert float((x2 - x).abs().max()) <= 1e-8
    assert float((y2 - y).abs().max()) <= 1e-8
    assert tgeo.utm_zone_from_lonlat(lon, lat) == jgeo.utm_zone_from_lonlat(lon, lat)


def test_wgs84_to_enu_matches_jax():
    rng = np.random.default_rng(3)
    lon = 8.39 + rng.normal(size=100) * 1e-2
    lat = 49.03 + rng.normal(size=100) * 1e-2
    alt = 110 + rng.normal(size=100)
    got = tgeo.wgs84_to_enu(t(lon), t(lat), t(alt), 8.39, 49.03, 112.0)
    want = jgeo.wgs84_to_enu(jnp.asarray(lon), jnp.asarray(lat), jnp.asarray(alt), 8.39, 49.03, 112.0)
    close(got, want, rtol=1e-9, atol=1e-7)


def matrices(rng):
    H = rng.normal(size=(200, 3, 3))
    H[0] = 0.0  # zero matrix
    H[1] = np.diag([3.0, 2.0, 1.0])
    H[2] = np.outer([1.0, 2.0, 3.0], [0.5, -1.0, 2.0])  # rank one
    H[3:50, :, 2] *= 1e-5  # near-planar clouds: σ₁/σ₃ ~ 1e5 (KITTI-like)
    return H


def test_svd3x3_matches_jax_jacobi():
    H = matrices(np.random.default_rng(4))
    U, S, Vt = tlin.svd3x3(t(H))
    jU, jS, jVt = jlin.svd3x3(jnp.asarray(H))
    close(S, jS, atol=1e-13)
    close(U, jU, atol=1e-12)
    # The rank-one matrix's two null-space directions of V are not unique
    # (rounding picks them); every other V must match.
    unique = np.arange(len(H)) != 2
    close(Vt[unique], np.asarray(jVt)[unique], atol=1e-12)
    recon = U @ torch.diag_embed(S) @ Vt
    close(recon, H, atol=1e-12)
    close(Vt[2] @ Vt[2].T, np.eye(3), atol=1e-12)
    close(tlin.inv3x3(t(H[3:])), jlin.inv3x3(jnp.asarray(H[3:])), rtol=1e-9)


@pytest.mark.parametrize("weights", ["none", "mask", "float"])
@pytest.mark.parametrize("planar", [False, True])
def test_umeyama_matches_jax(weights, planar):
    rng = np.random.default_rng(5)
    n = 120
    src = rng.normal(size=(n, 3)) * 20
    if planar:
        src[:, 2] *= 1e-3
    q = quats(rng, 1)[0]
    R = np.asarray(jq.to_matrix(jnp.asarray(q)))
    dst = 0.987 * src @ R.T + rng.normal(size=3) * 50 + rng.normal(size=(n, 3)) * 0.1
    w = None
    if weights == "mask":
        w = rng.uniform(size=n) > 0.3
    elif weights == "float":
        w = rng.uniform(size=n)
    got = tum.umeyama_sim3(t(src), t(dst), None if w is None else torch.from_numpy(w))
    want = jum.umeyama_sim3(jnp.asarray(src), jnp.asarray(dst), None if w is None else jnp.asarray(w))
    close(got.R, want.R, atol=1e-12)
    close(got.t, want.t, atol=1e-9)
    close(got.scale, want.scale)
    assert bool(got.ok) == bool(want.ok)


def test_umeyama_batched_trials_match_single_fits():
    rng = np.random.default_rng(6)
    src = rng.normal(size=(32, 4, 3))
    dst = rng.normal(size=(32, 4, 3))
    src[3] = src[3, :1]  # degenerate (all points equal)
    batched = tum.umeyama_sim3(t(src), t(dst))
    for i in (0, 3, 31):
        one = jum.umeyama_sim3(jnp.asarray(src[i]), jnp.asarray(dst[i]))
        close(batched.R[i], one.R, atol=1e-12)
        close(batched.t[i], one.t, atol=1e-11)
        close(batched.scale[i], one.scale)


@pytest.mark.parametrize("weights", ["none", "mask"])
def test_sim3_residuals_and_batched_umeyama_match_jax(weights):
    """``umeyama_sim3_batched`` takes the JAX argument contract (rows of
    src and dst, one weight vector shared by every row) and each row equals
    JAX's ``vmap``; ``sim3_residuals`` of each row's fit equals JAX's."""
    rng = np.random.default_rng(12)
    B, n = 5, 90
    src = rng.normal(size=(B, n, 3)) * 20
    R = np.asarray(jq.to_matrix(jnp.asarray(quats(rng, B))))
    dst = 0.97 * np.einsum("bij,bnj->bni", R, src) + rng.normal(size=(B, 1, 3)) * 30
    dst += rng.normal(size=(B, n, 3)) * 0.2
    w = None if weights == "none" else rng.uniform(size=n) > 0.3
    got = tum.umeyama_sim3_batched(t(src), t(dst), None if w is None else torch.from_numpy(w))
    want = jum.umeyama_sim3_batched(jnp.asarray(src), jnp.asarray(dst), None if w is None else jnp.asarray(w))
    assert got.R.shape == (B, 3, 3) and got.ok.shape == (B,)
    close(got.R, want.R, atol=1e-12)
    close(got.t, want.t, atol=1e-9)
    close(got.scale, want.scale)
    np.testing.assert_array_equal(got.ok.numpy(), np.asarray(want.ok))
    for b in range(B):
        one = tum.Sim3(*(x[b] for x in got))
        jone = jum.Sim3(*(x[b] for x in want))
        res = tum.sim3_residuals(t(src[b]), t(dst[b]), one)
        assert res.shape == (n,)
        close(res, jum.sim3_residuals(jnp.asarray(src[b]), jnp.asarray(dst[b]), jone), atol=1e-12)
