"""The χ²-gated robust fusion of the port (``models.robust``, in core and
out of core) and its fault injectors against the JAX package, CPU float64.

Inputs come from numpy seeds (``tests.test_extensions.setup_fusion_inputs``
plus an outage), 160 poses, so JAX's associative programs stay small.

Tolerances: the injectors equal JAX's exactly; a gate pass against JAX's
same pass: accept masks equal, NIS ≤1e-9 relative; ``fuse_robust`` against
JAX's: masks equal, positions ≤1e-8 m; the sequential gate against the
parallel one at the fixed point: masks equal, positions ≤1e-9 m (the JAX
bound, tests/test_robust_chunked.py:40); chunked against the port's in-core
parallel gate: positions ≤1e-10 m, quaternions ≤1e-12, NIS rtol 1e-6
(tests/test_robust_chunked.py:74-76), and against JAX's chunked run ≤1e-8 m.
"""

import logging

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gps_optimize_slam_tpu.config import EKFConfig as JEKFConfig
from gps_optimize_slam_tpu.models import robust as jrobust
from gps_optimize_slam_tpu.ops import kalman as jkalman
from gps_optimize_slam_tpu.utils import faults as jfaults
from gps_optimize_slam_tpu_torch.config import EKFConfig, FusionConfig, RTSDecisionConfig
from gps_optimize_slam_tpu_torch.models import fusion_chunked, robust
from gps_optimize_slam_tpu_torch.ops import kalman, kalman_parallel
from gps_optimize_slam_tpu_torch.utils import faults
from gps_optimize_slam_tpu_torch.utils.logging import LOGGER_NAME
from tests.test_extensions import setup_fusion_inputs
from tests.test_fusion_chunked import _scenario

OUTLIERS = [
    (40, np.array([30.0, -20.0, 5.0])),
    (47, np.array([25.0, 10.0, 0.0])),  # last step of a 48-step chunk
    (48, np.array([-15.0, 30.0, 2.0])),  # first step of the next
    (96, np.array([0.0, 50.0, 0.0])),  # the pose after the outage
    (120, np.array([0.0, -40.0, 8.0])),
]
OUTLIER_IDX = [i for i, _ in OUTLIERS]
PASSES = 8  # the adjacent outliers at 47 and 48 mask each other for more than the default two passes


def scenario(n=160, seed=2, outliers=OUTLIERS):
    """160 poses with gross outliers and an outage over a 48-step chunk
    boundary (NaN rows in the aligned GNSS, as the alignment leaves them)."""
    t, pos, quats, s3p, s3q, gps, valid = setup_fusion_inputs(n=n, seed=seed, outliers=outliers)
    valid[70:95] = False
    gps = np.where(valid[:, None], gps, np.nan)
    return t, pos, quats, s3p, s3q, gps, valid


def tens(arrays):
    return tuple(torch.tensor(a) for a in arrays)


def jarr(arrays):
    return tuple(jnp.asarray(a) for a in arrays)


def nis_close(got, want, rtol=1e-9):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=1e-12)


@pytest.mark.parametrize("injector", ["outages", "random_outages", "gross_outliers", "noise", "bias_ramp"])
def test_fault_injectors_equal_jax(injector):
    rng = np.random.default_rng(3)
    times = np.cumsum(rng.uniform(0.05, 0.15, 200))
    pos = rng.normal(size=(200, 3)) * 10.0
    valid = rng.uniform(size=200) > 0.1
    calls = {
        "outages": lambda m: m.inject_outages(valid, [(2.0, 4.5), (11.0, 12.0)], times),
        "random_outages": lambda m: m.inject_random_outages(valid, times, 3, seed=5),
        "gross_outliers": lambda m: m.inject_gross_outliers(pos, fraction=0.07, magnitude=40.0, seed=5),
        "noise": lambda m: m.inject_noise(pos, sigma=0.4, seed=5),
        "bias_ramp": lambda m: m.inject_bias_ramp(pos, times, (0.05, -0.02, 0.0), start_time=6.0),
    }
    got, want = calls[injector](faults), calls[injector](jfaults)
    for g, w in zip(got if isinstance(got, tuple) else (got,), want if isinstance(want, tuple) else (want,)):
        np.testing.assert_array_equal(g, w)
    assert not np.array_equal(np.asarray(got[0] if isinstance(got, tuple) else got),
                              valid if "outages" in injector else pos)


@pytest.mark.parametrize("gate", ["parallel", "sequential"])
def test_gate_pass_matches_jax_pass_for_pass(gate):
    """Two passes, the second updating with the first's accept mask, each
    against JAX's same pass."""
    t, pos, quats, s3p, s3q, gps, valid = scenario()
    avail = valid & ~np.isnan(gps).any(-1)
    jparams = jkalman.ekf_params(JEKFConfig(), dtype=jnp.float64)
    params = kalman.ekf_params(EKFConfig(), dtype=torch.float64, device="cpu")
    jfn = jrobust._parallel_nis if gate == "parallel" else jrobust._gated_availability
    fn = robust._parallel_nis if gate == "parallel" else robust._gated_availability
    update = avail
    for _ in range(2):
        want_acc, want_nis = jfn(*jarr((t, pos, quats, s3p[0], s3q[0], gps, avail, update)), jparams,
                                 robust.CHI2_3DOF_95, platform="cpu")
        got_acc, got_nis = fn(*tens((t, pos, quats, s3p[0], s3q[0], gps, avail, update)), params,
                              robust.CHI2_3DOF_95)
        np.testing.assert_array_equal(got_acc.numpy(), np.asarray(want_acc))
        nis_close(got_nis.numpy(), want_nis)
        assert not got_acc.numpy()[OUTLIER_IDX].any() and float(got_nis[0]) == 0.0
        update = got_acc.numpy()
    assert not np.array_equal(update, avail)  # the second pass did update with another mask


@pytest.mark.parametrize("gate", ["parallel", "sequential"])
def test_fuse_robust_matches_jax(gate):
    arrays = scenario()
    want = jrobust.fuse_robust(*jarr(arrays), gate_mode=gate, n_iterations=PASSES)
    got = robust.fuse_robust(*tens(arrays), gate_mode=gate, n_iterations=PASSES)
    assert got.gate_converged and bool(np.asarray(want.gate_converged))
    np.testing.assert_array_equal(got.accepted.numpy(), np.asarray(want.accepted))
    nis_close(got.nis.numpy(), want.nis)
    np.testing.assert_allclose(got.positions.numpy(), np.asarray(want.positions), atol=1e-8, rtol=0)
    np.testing.assert_allclose(got.quaternions.numpy(), np.asarray(want.quaternions), atol=1e-10, rtol=0)


@pytest.mark.parametrize("scan", ["auto", "parallel"])
def test_sequential_and_parallel_gates_share_the_fixed_point(scan):
    """``scan="parallel"`` takes the associative fusion on CPU tensors, the
    one the card takes under "auto"."""
    arrays = tens(scenario())
    seq = robust.fuse_robust(*arrays, gate_mode="sequential", scan=scan, n_iterations=PASSES)
    par = robust.fuse_robust(*arrays, gate_mode="parallel", scan=scan, n_iterations=PASSES)
    assert seq.gate_converged and par.gate_converged
    assert torch.equal(seq.accepted, par.accepted)
    np.testing.assert_allclose(seq.positions.numpy(), par.positions.numpy(), atol=1e-9, rtol=0)
    # The raw scores differ mid-sequence (the sequential gate folds this
    # pass's accepts in at once); the decisions they induce do not.
    assert torch.equal(seq.nis <= robust.CHI2_3DOF_95, par.nis <= robust.CHI2_3DOF_95)
    assert not par.accepted.numpy()[OUTLIER_IDX].any()


def test_gate_protects_the_trajectory_and_clean_data_passes():
    t, pos, quats, s3p, s3q, gps, valid = setup_fusion_inputs(
        outliers=[(40, np.array([30.0, -20.0, 5.0])), (90, np.array([0.0, 50.0, 0.0]))])
    arrays = tens((t, pos, quats, s3p, s3q, gps, valid))
    res = robust.fuse_robust(*arrays)
    acc = res.accepted.numpy()
    assert not acc[40] and not acc[90] and acc.sum() >= 140
    err = np.linalg.norm(res.positions.numpy() - pos, axis=1)
    ungated, _ = kalman_parallel.fuse_ekf_rts_parallel(*arrays, EKFConfig(), RTSDecisionConfig())
    assert err.max() < 0.5 and np.linalg.norm(ungated.numpy() - pos, axis=1).max() > 5 * err.max()
    clean = tens(setup_fusion_inputs())
    res = robust.fuse_robust(*clean)
    plain, _ = kalman.fuse_ekf_rts(*clean, EKFConfig(), RTSDecisionConfig())
    assert res.accepted.all()
    np.testing.assert_allclose(res.positions.numpy(), plain.numpy(), atol=1e-10, rtol=0)


def test_gate_fixed_point_flag_and_truncation_warning(caplog):
    """Too few passes to verify the fixed point: ``gate_converged=False``
    and a warning naming the knob; enough passes: converged, silent, and the
    early exit leaves the capped run's output (tests/test_extensions.py:314)."""
    arrays = tens(setup_fusion_inputs(
        outliers=[(40, np.array([30.0, -20.0, 5.0])), (41, np.array([28.0, -22.0, 4.0])),
                  (90, np.array([0.0, 50.0, 0.0]))]))
    with caplog.at_level(logging.WARNING, logger=LOGGER_NAME):
        res1 = robust.fuse_robust(*arrays, n_iterations=1, gate_mode="parallel")
    assert res1.gate_converged is False
    assert any("fixed point" in r.message and "n_iterations=1" in r.getMessage() for r in caplog.records)
    caplog.clear()
    with caplog.at_level(logging.WARNING, logger=LOGGER_NAME):
        res8 = robust.fuse_robust(*arrays, n_iterations=8, gate_mode="parallel")
    assert res8.gate_converged is True and not caplog.records
    assert not res8.accepted.numpy()[[40, 41, 90]].any()
    res2 = robust.fuse_robust(*arrays, n_iterations=2, gate_mode="parallel")
    assert torch.equal(res8.accepted, res2.accepted) and torch.equal(res8.positions, res2.positions)


@pytest.mark.parametrize("gate", ["parallel", "sequential"])
def test_zero_iterations_gate_nothing_like_jax(gate, caplog):
    arrays = scenario()
    want = jrobust.fuse_robust(*jarr(arrays), n_iterations=0, gate_mode=gate)
    with caplog.at_level(logging.WARNING, logger=LOGGER_NAME):
        got = robust.fuse_robust(*tens(arrays), n_iterations=0, gate_mode=gate)
    assert got.gate_converged is False and not bool(np.asarray(want.gate_converged))
    assert caplog.records
    valid, gps = arrays[6], arrays[5]
    np.testing.assert_array_equal(got.accepted.numpy(), valid & ~np.isnan(gps).any(-1))
    np.testing.assert_array_equal(got.accepted.numpy(), np.asarray(want.accepted))
    assert not got.nis.any()
    np.testing.assert_allclose(got.positions.numpy(), np.asarray(want.positions), atol=1e-8, rtol=0)


def test_unknown_gate_mode_raises():
    with pytest.raises(ValueError, match="gate_mode"):
        robust.fuse_robust(*tens(scenario()), gate_mode="both")


@pytest.mark.parametrize("chunk_size", [48, 159, 1000])
def test_fuse_robust_chunked_matches_in_core_parallel_gate(chunk_size):
    """159 steps in chunks of 48 leave a ragged last chunk of 15; 159 is one
    exact chunk, 1000 one padded chunk."""
    t, pos, quats, s3p, s3q, gps, valid = scenario()
    ref = robust.fuse_robust(*tens((t, pos, quats, s3p, s3q, gps, valid)), gate_mode="parallel", scan="parallel",
                             n_iterations=PASSES)
    assert ref.gate_converged
    cp, cq, acc, nis = robust.fuse_robust_chunked(
        t, pos, quats, s3p[0], s3q[0], gps, valid, n_iterations=PASSES, chunk_size=chunk_size, device="cpu")
    np.testing.assert_array_equal(acc, ref.accepted.numpy())
    np.testing.assert_allclose(cp, ref.positions.numpy(), atol=1e-10, rtol=0)
    np.testing.assert_allclose(cq, ref.quaternions.numpy(), atol=1e-12, rtol=0)
    np.testing.assert_allclose(nis, ref.nis.numpy(), rtol=1e-6, atol=1e-9)
    assert not acc[OUTLIER_IDX].any() and nis[0] == 0.0


def test_fuse_robust_chunked_matches_jax_chunked():
    t, pos, quats, s3p, s3q, gps, valid = scenario()
    want = jrobust.fuse_robust_chunked(t, pos, quats, s3p[0], s3q[0], gps, valid, n_iterations=PASSES,
                                       chunk_size=48)
    got = robust.fuse_robust_chunked(t, pos, quats, s3p[0], s3q[0], gps, valid, n_iterations=PASSES,
                                     chunk_size=48, device="cpu")
    np.testing.assert_array_equal(got[2], want[2])
    np.testing.assert_allclose(got[0], want[0], atol=1e-8, rtol=0)
    np.testing.assert_allclose(got[1], want[1], atol=1e-10, rtol=0)
    nis_close(got[3], want[3])


def test_gated_availability_chunked_is_one_parallel_pass():
    t, pos, quats, s3p, s3q, gps, valid = scenario()
    avail = valid & ~np.isnan(gps).any(-1)
    update = avail.copy()
    update[[40, 96]] = False
    params = kalman.ekf_params(EKFConfig(), dtype=torch.float64, device="cpu")
    want_acc, want_nis = robust._parallel_nis(
        *tens((t, pos, quats, s3p[0], s3q[0], gps, avail, update)), params, robust.CHI2_3DOF_95)
    acc, nis = robust.gated_availability_chunked(
        t, pos, quats, s3p[0], s3q[0], gps, avail, update, chunk_size=50, device="cpu")
    np.testing.assert_array_equal(acc, want_acc.numpy())
    np.testing.assert_allclose(nis, want_nis.numpy(), rtol=1e-9, atol=1e-12)


def test_chunked_gate_truncation_warns(caplog):
    t, pos, quats, s3p, s3q, gps, valid = scenario()
    with caplog.at_level(logging.WARNING, logger=LOGGER_NAME):
        robust.fuse_robust_chunked(t, pos, quats, s3p[0], s3q[0], gps, valid, n_iterations=1,
                                   chunk_size=64, device="cpu")
    assert any("fixed point" in r.message for r in caplog.records)


def test_fuse_core_chunked_robust_gates_injected_outliers():
    """``fuse_core_chunked(robust=True)`` from raw GNSS with gross outliers
    small enough to pass the polynomial pre-gate's 10 m: the χ² gate drops
    them, the result records the mask, and a tighter gate drops more."""
    (st, sp, sq), (gt, gp, gv) = _scenario(seed=1)
    hit = np.arange(60, len(gt), 45)
    gp = gp.copy()
    gp[hit] += np.array([6.0, -5.0, 1.0])
    cfg = FusionConfig()
    plain = fusion_chunked.fuse_core_chunked(st, sp, sq, gt, gp, gv, config=cfg, chunk_size=159, halo=24,
                                             device="cpu")
    got = fusion_chunked.fuse_core_chunked(st, sp, sq, gt, gp, gv, config=cfg, chunk_size=159, halo=24,
                                           robust=True, robust_iterations=6, device="cpu")
    assert plain.robust_accepted is None and got.ok
    acc = got.robust_accepted
    rejected = got.gps_valid & ~acc
    assert acc.dtype == bool and not (acc & ~got.gps_valid).any() and 5 <= rejected.sum() <= 80
    # A pose beside every valid hit fix is rejected (the spline spreads a
    # hit over its neighbours), and the gated trajectory moved there.
    near = np.abs(st[rejected][None, :] - gt[hit][gv[hit]][:, None]).min(1)
    assert near.max() < 0.15
    moved = np.linalg.norm(got.corrected_pos - plain.corrected_pos, axis=1)
    assert moved[rejected].max() > 0.5
    tight = fusion_chunked.fuse_core_chunked(st, sp, sq, gt, gp, gv, config=cfg, chunk_size=159, halo=24,
                                             robust=True, robust_gate_chi2=1.0, robust_iterations=6,
                                             device="cpu")
    assert tight.robust_accepted.sum() < acc.sum()
