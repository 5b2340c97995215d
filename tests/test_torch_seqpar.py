"""Sequence parallelism of the port (``parallel.seqpar``) on the CPU, float64:
``fuse_ekf_rts_seqparallel`` on an 8-block CPU mesh against the JAX
package's on its virtual 8-device mesh and against the port's single-device
filter, also with outages that cross block edges; the block form of the
controls (``kalman.controls_over_blocks``) against ``precompute_controls``
on the whole trajectory; that no tensor longer than a block and its halos
is made between staging and the gather; pre-split block inputs;
``sequence_parallel_scan`` against the plain scan for every combine; the
``scan_fn`` hooks of ``kalman_parallel``, ``kalman_chunked``,
``fusion_chunked`` and the robust chunked gate.

Tolerances: positions ≤1e-8 m and quaternions ≤1e-10 (the JAX package's
own bounds for seqpar against one device, tests/test_seqpar.py); a scan
≤1e-10 relative to (max |plain| + 1) (``chip_smoke.TOL``: only the
association order differs); the block controls equal bit for bit (booleans
and integers from the same elementwise arithmetic); the same blocks given
pre-split or staged from whole inputs equal bit for bit (the same
operations on the same values).
"""

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

import chip_smoke
from gps_optimize_slam_tpu.config import RTSDecisionConfig as JRTSDecisionConfig
from gps_optimize_slam_tpu.ops import kalman as jkalman
from gps_optimize_slam_tpu.parallel import seqpar as jseqpar
from gps_optimize_slam_tpu.parallel.mesh import make_mesh as jmake_mesh
from gps_optimize_slam_tpu_torch.config import FusionConfig, RTSDecisionConfig
from gps_optimize_slam_tpu_torch.models import fusion_chunked
from gps_optimize_slam_tpu_torch.models import robust
from gps_optimize_slam_tpu_torch.ops import kalman, kalman_chunked, kalman_parallel, scan
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
    """The controls' two scans (pose indices, float64) first, then the
    quaternion chain, the filter and the RTS suffix."""
    seen = []

    def recording(op, x, reverse=False):
        seen.append((op, reverse, tuple(x.shape)))
        return scan.associative_scan(op, x, reverse)

    t, pos, quat, gps, valid = port_traj(64)
    got = kalman_parallel.fuse_ekf_rts_parallel(t, pos, quat, pos, quat, gps, valid, scan_fn=recording)
    want = kalman_parallel.fuse_ekf_rts_parallel(t, pos, quat, pos, quat, gps, valid)
    assert seen == [("max3", False, (3, 64)), ("min3", True, (3, 64)), ("quat_chain", False, (4, 64)),
                    ("filter", False, (27, 64)), ("rts", True, (12, 64))]
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


# Outages placed against the blocks of length L = ceil(n / d): "across"
# starts in block 0 and ends two blocks later (one later when d = 2),
# "sharp" and "degenerate" are the same outage with a yaw jump or a zero
# quaternion in its middle block, "edge" ends exactly at block edges (its
# recovery is a block's first pose), "sharp-edge" is a sharp outage that
# does so, "turn-at-edge" is "across" with its one high-yaw-rate pair
# straddling the edge into block 1 (a lasting turn there), "trailing" runs
# from block d-2 to the end (the padding included).
EDGE_KINDS = ("across", "sharp", "degenerate", "edge", "sharp-edge", "turn-at-edge", "trailing")


def edge_traj(kind: str, n: int, d: int, seed: int = 0):
    """tests/test_seqpar.py's trajectory with the outages of ``kind`` for
    ``d`` blocks, as float64 host arrays (t, pos, quat, gps, valid)."""
    size = -(-n // d)
    if kind in ("across", "sharp", "degenerate", "turn-at-edge"):
        outages = [(size // 2, min(2, d - 1) * size + size // 4)]
    elif kind == "edge":
        outages = [(size - size // 3, size)] + ([(size + size // 2, 2 * size)] if d >= 3 else [])
    elif kind == "sharp-edge":
        outages = [(size // 2, min(2, d - 1) * size)]
    else:
        outages = [(size // 2, size // 2 + 6), ((d - 1) * size - size // 4, n)]
    t, pos, quat, gps, valid = (np.array(x) for x in _traj(n, seed, outages))
    a, b = outages[0]
    mid = (a + b) // 2
    if kind in ("sharp", "sharp-edge"):
        quat[mid] = [0.0, 0.0, np.sin(1.5), np.cos(1.5)]  # two yaw steps of ~3 rad in 0.1 s
    elif kind == "degenerate":
        quat[mid] = 0.0
    elif kind == "turn-at-edge":
        yaw = 2.0 * np.arctan2(quat[:, 2], quat[:, 3])
        yaw[size:] += 1.5
        quat[:, 2], quat[:, 3] = np.sin(yaw / 2), np.cos(yaw / 2)
    return t, pos, quat, gps, valid


def split_controls_blocks(args, d):
    """``args`` (t, quat, gps, valid) as ``d`` ControlsBlocks of length
    ceil(n / d) (the last shorter), each with its one-pose halo."""
    n = len(args[0])
    size = -(-n // d)
    blocks = []
    for k in range(d):
        a, b = k * size, min((k + 1) * size, n)
        prev = None if k == 0 else tuple(torch.as_tensor(x[a - 1 : a]) for x in args)
        blocks.append(kalman.ControlsBlock(*(torch.as_tensor(x[a:b]) for x in args), start=a, prev=prev))
    return blocks


@pytest.mark.parametrize("rts_mode", ["outage", "full"])
@pytest.mark.parametrize("d", [2, 3, 4, 8])
@pytest.mark.parametrize("kind", EDGE_KINDS)
def test_block_controls_equal_the_whole_trajectorys(kind, d, rts_mode):
    """Every field of every pose bit for bit: the halo and the two scans
    across the blocks reproduce outages that cross one or two block edges, their
    sharp-turn and degenerate-quaternion analysis, a recovery on a block's
    first pose and a trailing outage; also against the JAX package's
    controls."""
    n = 197
    t, _, quat, gps, valid = edge_traj(kind, n, d)
    cfg = RTSDecisionConfig()
    want = base = kalman.precompute_controls(*(torch.as_tensor(x) for x in (t, quat, gps, valid)), cfg)
    jwant = jkalman.precompute_controls(t, quat, gps, valid, JRTSDecisionConfig())
    blocks = split_controls_blocks((t, quat, gps, valid), d)
    got = kalman.controls_over_blocks(blocks, cfg, seqpar.block_scan(make_mesh(devices=["cpu"] * d)))
    if rts_mode == "full":
        want = kalman.full_smoother_controls(want)
        got = [kalman.full_smoother_controls(c, b.start, n) for c, b in zip(got, blocks)]
    for name in kalman.FusionControls._fields:
        whole = torch.cat([getattr(c, name) for c in got])
        assert whole.dtype == getattr(want, name).dtype and torch.equal(whole, getattr(want, name)), name
        if rts_mode == "outage":
            np.testing.assert_array_equal(whole.numpy(), np.asarray(getattr(jwant, name)), err_msg=name)
    outage = base.rts_member[~base.avail]
    if kind in ("sharp", "degenerate", "sharp-edge", "turn-at-edge"):  # each makes the outage sharp: no RTS
        assert base.sharp_turn.sum() == 1 and not outage.any()
    elif kind == "trailing":
        assert not base.rts_member[-1] and outage.any()
    else:
        assert outage.all()


def test_block_controls_need_a_scan_across_blocks():
    t, _, quat, gps, valid = edge_traj("across", 40, 2)
    blocks = split_controls_blocks((t, quat, gps, valid), 2)
    with pytest.raises(ValueError, match="scan across them"):
        kalman.controls_over_blocks(blocks)


@pytest.mark.parametrize("rts_mode", ["outage", "full"])
@pytest.mark.parametrize("kind", EDGE_KINDS)
def test_seqparallel_matches_jax_across_block_edges(mesh8, kind, rts_mode):
    """n = 197 on 8 blocks (padded to 200): the port's seqpar against the
    JAX package's on its virtual 8-device mesh and the port's single-device
    filter, with each kind of outage placed against the block edges."""
    n = 197
    t, pos, quat, gps, valid = edge_traj(kind, n, 8)
    got_p, got_q = seqpar.fuse_ekf_rts_seqparallel(mesh8, t, pos, quat, pos, quat, gps, valid, rts_mode=rts_mode)
    targs = [torch.as_tensor(x) for x in (t, pos, quat, pos, quat, gps, valid)]
    one_p, one_q = kalman_parallel.fuse_ekf_rts_parallel(*targs, rts_mode=rts_mode)
    want_p, want_q = jseqpar.fuse_ekf_rts_seqparallel(jmake_mesh(n_devices=8), t, pos, quat, pos, quat, gps, valid,
                                                      rts_mode=rts_mode)
    assert got_p.shape == (n, 3) and got_q.shape == (n, 4)
    for ref_p, ref_q in ((np.asarray(want_p), np.asarray(want_q)), (one_p.numpy(), one_q.numpy())):
        np.testing.assert_allclose(got_p.numpy(), ref_p, atol=1e-8, rtol=0)
        np.testing.assert_allclose(got_q.numpy(), ref_q, atol=1e-10, rtol=0)


@pytest.mark.parametrize("d", [2, 3, 4])
@pytest.mark.parametrize("kind", EDGE_KINDS)
def test_seqparallel_matches_one_device_across_block_edges(kind, d):
    """n = 197, not a multiple of 2, 3 or 4, against the single-device
    filter in both modes."""
    n = 197
    args = [torch.as_tensor(x) for x in edge_traj(kind, n, d, seed=d)]
    t, pos, quat, gps, valid = args
    mesh = make_mesh(devices=["cpu"] * d)
    for rts_mode in ("outage", "full"):
        got_p, got_q = seqpar.fuse_ekf_rts_seqparallel(mesh, t, pos, quat, pos, quat, gps, valid, rts_mode=rts_mode)
        one_p, one_q = kalman_parallel.fuse_ekf_rts_parallel(t, pos, quat, pos, quat, gps, valid, rts_mode=rts_mode)
        assert float((got_p - one_p).abs().max()) <= 1e-8 and float((got_q - one_q).abs().max()) <= 1e-10


class LongestOutput(TorchDispatchMode):
    """Records the longest axis of every tensor an operation makes
    (``lift_fresh`` only wraps the caller's host array: no copy, no new
    memory)."""

    def __init__(self):
        super().__init__()
        self.longest, self.op = 0, None

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func is torch.ops.aten.lift_fresh.default:
            return out
        for leaf in tree_leaves(out):
            if isinstance(leaf, torch.Tensor) and leaf.ndim and max(leaf.shape) > self.longest:
                self.longest, self.op = max(leaf.shape), func
        return out


@pytest.mark.parametrize("as_tensors", [False, True])
@pytest.mark.parametrize("d", [4, 8])
def test_no_tensor_outgrows_a_block_and_its_halos(d, as_tensors):
    """From staging to the per-block outputs (``gather=False``), every
    tensor made has no axis longer than a block plus its two halos: the
    whole trajectory is sliced, never copied or concatenated, and every
    stage runs per block (251 poses: blocks of 63 or 32, longer than the
    27 leaves of a filter element)."""
    n = 251
    size = -(-n // d)
    args = edge_traj("across", n, d)
    if as_tensors:
        args = tuple(torch.as_tensor(x) for x in args)
    t, pos, quat, gps, valid = args
    mesh = make_mesh(devices=["cpu"] * d)
    with LongestOutput() as seen:
        got_p, got_q = seqpar.fuse_ekf_rts_seqparallel(mesh, t, pos, quat, pos, quat, gps, valid, gather=False)
    assert seen.longest <= size + 2, (seen.longest, seen.op)
    assert [len(p) for p in got_p] == [size] * (d - 1) + [n - (d - 1) * size]
    one_p, _ = kalman_parallel.fuse_ekf_rts_parallel(*(torch.as_tensor(x) for x in (t, pos, quat, pos, quat, gps,
                                                                                     valid)))
    assert float((torch.cat(got_p) - one_p).abs().max()) <= 1e-8
    with LongestOutput() as whole:
        kalman_parallel.fuse_ekf_rts_parallel(*(torch.as_tensor(x) for x in (t, pos, quat, pos, quat, gps, valid)))
    assert whole.longest >= n  # the probe sees a whole-trajectory filter


def test_pre_split_blocks_equal_whole_inputs(mesh8):
    """The blocks ``stage_blocks`` makes, given as lists, give the whole
    inputs' result bit for bit; blocks of unequal lengths (no padding) give
    the single-device result, block by block."""
    n = 251
    args = edge_traj("edge", n, 8)
    whole = seqpar.fuse_ekf_rts_seqparallel(mesh8, *args[:3], *args[1:3], *args[3:])
    staged = seqpar.stage_blocks(mesh8, *args[:3], *args[1:3], *args[3:])
    assert all(len(x) == 8 for x in staged) and [len(b) for b in staged[0]] == [32] * 8
    got = seqpar.fuse_ekf_rts_seqparallel(mesh8, *staged)  # the padding is given: 256 poses out
    assert torch.equal(got[0][:n], whole[0]) and torch.equal(got[1][:n], whole[1])

    cuts = np.array([0, 30, 100, 150, 251])
    t, pos, quat, gps, valid = (torch.as_tensor(x) for x in args)
    blocks = [[x[a:b] for a, b in zip(cuts[:-1], cuts[1:])] for x in (t, pos, quat, pos, quat, gps, valid)]
    got_p, got_q = seqpar.fuse_ekf_rts_seqparallel(make_mesh(devices=["cpu"] * 4), *blocks, gather=False)
    assert [len(p) for p in got_p] == [30, 70, 50, 101]
    one_p, one_q = kalman_parallel.fuse_ekf_rts_parallel(t, pos, quat, pos, quat, gps, valid)
    assert float((torch.cat(got_p) - one_p).abs().max()) <= 1e-8
    assert float((torch.cat(got_q) - one_q).abs().max()) <= 1e-10
    with pytest.raises(ValueError, match="at least one pose"):
        seqpar.fuse_ekf_rts_seqparallel(make_mesh(devices=["cpu"] * 2),
                                        *[[x[:0], x] for x in (t, pos, quat, pos, quat, gps, valid)])


def test_padding_spans_the_last_blocks_when_blocks_are_short():
    """9 poses on 4 blocks: blocks of 3, the last all padding; 5 on 4: the
    padding fills the last block and part of the one before."""
    for n in (9, 5):
        args = [torch.as_tensor(x) for x in edge_traj("across", n, 4)]
        t, pos, quat, gps, valid = args
        mesh = make_mesh(devices=["cpu"] * 4)
        got = seqpar.fuse_ekf_rts_seqparallel(mesh, t, pos, quat, pos, quat, gps, valid)
        one = kalman_parallel.fuse_ekf_rts_parallel(t, pos, quat, pos, quat, gps, valid)
        assert float((got[0] - one[0]).abs().max()) <= 1e-8 and float((got[1] - one[1]).abs().max()) <= 1e-10
        blocks = seqpar.fuse_ekf_rts_seqparallel(mesh, t, pos, quat, pos, quat, gps, valid, gather=False)
        assert [len(b) for b in blocks[0]] == ([3, 3, 3, 0] if n == 9 else [2, 2, 1, 0])
        assert torch.equal(torch.cat(blocks[0]), got[0]) and torch.equal(torch.cat(blocks[1]), got[1])
