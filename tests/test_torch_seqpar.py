"""Sequence parallelism of the port (``parallel.seqpar``) on the CPU, float64:
``fuse_ekf_rts_seqparallel`` on an 8-block CPU mesh against the JAX
package's on its virtual 8-device mesh and against the port's single-device
filter; ``sequence_parallel_scan`` against the plain scan for every combine;
the ``scan_fn`` hooks of ``kalman_parallel``, ``kalman_chunked``,
``fusion_chunked`` and the robust chunked gate.

Tolerances: positions ≤1e-8 m and quaternions ≤1e-10 (the JAX package's
own bounds for seqpar against one device, tests/test_seqpar.py); a scan
≤1e-10 relative to (max |plain| + 1) (``chip_smoke.TOL``: only the
association order differs).
"""

import numpy as np
import pytest
import torch

import chip_smoke
from gps_optimize_slam_tpu.parallel import seqpar as jseqpar
from gps_optimize_slam_tpu.parallel.mesh import make_mesh as jmake_mesh
from gps_optimize_slam_tpu_torch.config import FusionConfig
from gps_optimize_slam_tpu_torch.models import fusion_chunked
from gps_optimize_slam_tpu_torch.models import robust
from gps_optimize_slam_tpu_torch.ops import kalman_chunked, kalman_parallel, scan
from gps_optimize_slam_tpu_torch.parallel import seqpar
from gps_optimize_slam_tpu_torch.parallel.mesh import make_mesh
from tests.test_fusion_chunked import _scenario
from tests.test_seqpar import _traj


def port_traj(n, seed=0):
    """tests/test_seqpar.py's trajectory (two outages) as CPU tensors."""
    return tuple(torch.tensor(np.array(x)) for x in _traj(n, seed))


@pytest.fixture(scope="module")
def mesh8():
    return make_mesh(devices=["cpu"] * 8)


@pytest.mark.parametrize("n", [256, 251])  # a mesh multiple, and the padding path
@pytest.mark.parametrize("rts_mode", ["outage", "full"])
def test_seqparallel_matches_jax_and_one_device(mesh8, n, rts_mode):
    t, pos, quat, gps, valid = port_traj(n)
    got_p, got_q = seqpar.fuse_ekf_rts_seqparallel(mesh8, t, pos, quat, pos, quat, gps, valid, rts_mode=rts_mode)
    one_p, one_q = kalman_parallel.fuse_ekf_rts_parallel(t, pos, quat, pos, quat, gps, valid, rts_mode=rts_mode)
    jt, jpos, jquat, jgps, jvalid = _traj(n)
    want_p, want_q = jseqpar.fuse_ekf_rts_seqparallel(jmake_mesh(n_devices=8), jt, jpos, jquat, jpos, jquat, jgps,
                                                      jvalid, rts_mode=rts_mode)
    assert got_p.shape == (n, 3) and got_q.shape == (n, 4)
    for ref_p, ref_q in ((np.asarray(want_p), np.asarray(want_q)), (one_p.numpy(), one_q.numpy())):
        np.testing.assert_allclose(got_p.numpy(), ref_p, atol=1e-8, rtol=0)
        np.testing.assert_allclose(got_q.numpy(), ref_q, atol=1e-10, rtol=0)


@pytest.mark.parametrize("d", [1, 3, 8])
@pytest.mark.parametrize("op", list(scan.OPS))
def test_sequence_parallel_scan_matches_the_plain_scan(op, d):
    """Every combine, both directions, on (L, n) and (L, B, n) leaves: the
    block totals' scan and the fold of the exclusive prefix (suffix) agree
    with one scan over the whole axis."""
    scan_fn = seqpar.sequence_parallel_scan(make_mesh(devices=["cpu"] * d))
    assert scan_fn.mesh.size == d
    gen = torch.Generator().manual_seed(d)
    x = chip_smoke.scan_inputs(op, 40 * d, gen, torch.float64, "cpu")
    rows = torch.stack([x, chip_smoke.scan_inputs(op, 40 * d, gen, torch.float64, "cpu")], 1)
    for leaves in (x, rows):
        for reverse in (False, True):
            got = scan_fn(op, leaves, reverse)
            assert got.shape == leaves.shape and got.device == leaves.device
            assert chip_smoke.rel_err(got, scan.scan_plain(op, leaves, reverse)) <= chip_smoke.TOL["float64"]


def test_scan_axis_must_divide_by_the_mesh(mesh8):
    with pytest.raises(ValueError, match="must divide by the mesh size"):
        seqpar.sequence_parallel_scan(mesh8)("add2", torch.zeros(2, 250, dtype=torch.float64))


def test_every_scan_of_the_filter_goes_through_scan_fn():
    seen = []

    def recording(op, x, reverse=False):
        seen.append((op, reverse, tuple(x.shape)))
        return scan.associative_scan(op, x, reverse)

    t, pos, quat, gps, valid = port_traj(64)
    got = kalman_parallel.fuse_ekf_rts_parallel(t, pos, quat, pos, quat, gps, valid, scan_fn=recording)
    want = kalman_parallel.fuse_ekf_rts_parallel(t, pos, quat, pos, quat, gps, valid)
    assert seen == [("quat_chain", False, (4, 64)), ("filter", False, (27, 64)), ("rts", True, (12, 64))]
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_chunked_composes_with_seqpar(mesh8):
    """Host chunks meet device blocks: ``chunk_size = 8·8 − 1`` so each
    scan's chunk_size + 1 elements split evenly (JAX's
    test_chunked_composes_with_seqpar), against the chunked filter without
    ``scan_fn`` and the single-device in-core filter."""
    t, pos, quat, gps, valid = port_traj(200)
    host = [x.numpy() for x in (t, pos, quat)]
    args = (*host, host[1][0], host[2][0], gps.numpy(), valid.numpy())
    got = kalman_chunked.fuse_ekf_rts_chunked(*args, chunk_size=63, scan_fn=seqpar.sequence_parallel_scan(mesh8),
                                              device="cpu")
    plain = kalman_chunked.fuse_ekf_rts_chunked(*args, chunk_size=63, device="cpu")
    one = kalman_parallel.fuse_ekf_rts_parallel(t, pos, quat, pos, quat, gps, valid)
    for ref_p, ref_q in (plain, (one[0].numpy(), one[1].numpy())):
        np.testing.assert_allclose(got[0], ref_p, atol=1e-8, rtol=0)
        np.testing.assert_allclose(got[1], ref_q, atol=1e-10, rtol=0)


@pytest.mark.parametrize("robust_gate", [False, True])
def test_fuse_core_chunked_with_seqpar(robust_gate):
    """The whole chunked fusion (the robust gate's passes too) with its
    filter scans split over a 4-block mesh, against the same fusion with
    one scan a chunk."""
    (st, sp, sq), (gt, gp, gv) = _scenario(seed=1)
    scan_fn = seqpar.sequence_parallel_scan(make_mesh(devices=["cpu"] * 4))
    kw = dict(config=FusionConfig(), chunk_size=4 * 40 - 1, halo=24, robust=robust_gate, device="cpu")
    got = fusion_chunked.fuse_core_chunked(st, sp, sq, gt, gp, gv, scan_fn=scan_fn, **kw)
    want = fusion_chunked.fuse_core_chunked(st, sp, sq, gt, gp, gv, **kw)
    assert got.ok and want.ok
    np.testing.assert_allclose(got.corrected_pos, want.corrected_pos, atol=1e-8, rtol=0)
    np.testing.assert_allclose(got.corrected_quat, want.corrected_quat, atol=1e-10, rtol=0)
    if robust_gate:
        np.testing.assert_array_equal(got.robust_accepted, want.robust_accepted)


def test_robust_gate_pass_takes_scan_fn():
    """A chunked gate pass runs both of each chunk's scans through the
    ``scan_fn`` it is given."""
    seen = []

    def recording(op, x, reverse=False):
        seen.append(op)
        return scan.associative_scan(op, x, reverse)

    t, pos, quat, gps, valid = (x.numpy() for x in port_traj(100))
    avail = valid & ~np.isnan(gps).any(-1)
    robust.gated_availability_chunked(t, pos, quat, pos[0], quat[0], gps, avail, avail, chunk_size=49,
                                      device="cpu", scan_fn=recording)
    assert seen == ["quat_chain", "filter"] * 3
