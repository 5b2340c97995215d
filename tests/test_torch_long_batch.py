"""A bucket of long logs through the port's batched entry points, on the
routes that send batched rows to K2's and K4's batch grids, against the
JAX package.

Three ragged float64 rows (2,000, 2,600 and 3,100 poses: time-shifted
replicas of the seq-04 golden arrays, ``chip_smoke.replica_sequence``, each
with its own 2 cm of GNSS noise and GNSS outages of 8 s placed apart from
row to row) go through ``parallel.mesh.fuse_batch`` + ``evaluate_batch`` in
the port (on the CPU) and in the JAX package, from the same NumPy arrays.
The port's route thresholds are lowered so that these rows are "long":
every batched scan of every combine past 1,024 elements takes
``scan_tiled`` (K2's batch grid) and every batched NN call ``nn_grid``
(K4's), which on CPU tensors run their plain versions; both wrappers are
counted.

Tolerances: those ``test_torch_batch.py`` holds the KITTI buckets to
against JAX, whose RANSAC draws are replayed: positions ≤1e-8 m, scale
≤1e-10, quaternions ≤1e-10, masks equal, every evaluation statistic ≤1e-8.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from gps_optimize_slam_tpu.parallel import batch as jbatch
from gps_optimize_slam_tpu.parallel import mesh as jmesh
from gps_optimize_slam_tpu_torch.ops import kernels, scan
from gps_optimize_slam_tpu_torch.parallel import batch as pbatch
from gps_optimize_slam_tpu_torch.parallel import mesh
from test_torch_batch import GPU_LADDER, PARTS, STATS, jax_draws, window_counts

LENGTHS = (2000, 2600, 3100)
OUTAGE_S = 8.0


def long_logs():
    """[(slam, gps_times, gps_positions, gps_valid)] of ``LENGTHS`` poses,
    each with two GNSS outages at its own places (a fifth and three fifths
    of the way along the first row, shifted from row to row)."""
    rows = []
    for r, n in enumerate(LENGTHS):
        slam, gt, gp = chip_smoke.replica_sequence(n, seed=300 + r)
        st = slam["timestamps"]
        drop = np.zeros(len(gt), bool)
        for frac in (0.2 + 0.07 * r, 0.6 + 0.05 * r):
            t0 = st[0] + frac * (st[-1] - st[0])
            drop |= (gt >= t0) & (gt < t0 + OUTAGE_S)
        rows.append((slam, gt[~drop], gp[~drop], np.ones(int((~drop).sum()), bool)))
    return rows


@pytest.fixture(scope="module")
def bucket():
    rows = long_logs()
    args = [list(x) for x in zip(*rows)]
    return pbatch.pad_batch(*args), jbatch.pad_batch(*args)


@pytest.fixture(scope="module")
def jax_run(bucket):
    _, jb = bucket
    keys = jax.vmap(jax.random.PRNGKey)(jnp.arange(len(LENGTHS)))
    out = jmesh.fuse_batch(jb, keys, dtype=jnp.float64)
    return out, jmesh.evaluate_batch(jb, out)


def test_long_log_bucket_on_k2_and_k4_routes_matches_jax(bucket, jax_run, monkeypatch):
    padded, _ = bucket
    jout, jev = jax_run
    monkeypatch.setattr(scan, "BLOCK_MAX_ELEMENTS", 1024)
    monkeypatch.setattr(scan, "BATCH_TILED_OPS", tuple(scan.OPS))
    monkeypatch.setattr(scan, "BATCH_TILED_MIN_ROW", 1025)
    monkeypatch.setattr(scan, "BATCH_TILED_MIN_ELEMENTS", 0)
    monkeypatch.setattr(kernels, "GRID_MIN_CANDIDATES", 1)
    monkeypatch.setattr(kernels, "GRID_MAX_QUERY_TILES", 10**6)
    calls = {"scan_block": 0, "scan_tiled": 0, "nn_resident": 0, "nn_grid": 0}
    for module, name in ((scan, "scan_block"), (scan, "scan_tiled"), (kernels, "nn_resident"),
                         (kernels, "nn_grid")):
        real = getattr(module, name)

        def counted(*a, _n=name, _f=real):
            if a[1].ndim == 3:  # a batched call (its leaves or its queries have the row axis)
                calls[_n] += 1
            return _f(*a)

        monkeypatch.setattr(module, name, counted)
    counts = window_counts(padded)
    draws = torch.stack([jax_draws(i, counts[i]) for i in range(len(LENGTHS))])
    out = mesh.fuse_batch(padded, config=GPU_LADDER, device="cpu", sim3_draws=draws)
    ev = mesh.evaluate_batch(padded, out)

    assert calls["scan_tiled"] > 0 and calls["nn_grid"] == 3  # the three NN statistics of the evaluation
    assert calls["scan_block"] == 0 and calls["nn_resident"] == 0
    assert out.corrected_pos.shape == (3, padded.slam_times.shape[1], 3)
    assert bool(out.ok.all()) and bool(np.asarray(jout.ok).all())
    for name in ("gps_valid", "sim3_inliers"):
        np.testing.assert_array_equal(getattr(out, name).numpy(), np.asarray(getattr(jout, name)), err_msg=name)
    for name in ("corrected_pos", "sim3_pos", "aligned_gps"):
        np.testing.assert_allclose(getattr(out, name).numpy(), np.asarray(getattr(jout, name)), atol=1e-8,
                                   rtol=0, err_msg=name)
    np.testing.assert_allclose(out.corrected_quat.numpy(), np.asarray(jout.corrected_quat), atol=1e-10)
    np.testing.assert_allclose(out.sim3.scale.numpy(), np.asarray(jout.sim3.scale), atol=1e-10, rtol=0)
    for part in PARTS:
        for stat in STATS:
            got, want = getattr(getattr(ev, part), stat).numpy(), np.asarray(getattr(getattr(jev, part), stat))
            np.testing.assert_allclose(got, want, atol=1e-8, rtol=0, err_msg=f"{part}.{stat}")
    assert (ev.nn_ekf.count > 1000).all()
