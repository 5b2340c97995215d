"""Sequence parallelism: one trajectory's pose axis split into blocks over
the devices of a mesh (port of ``gps_optimize_slam_tpu.parallel.seqpar``).

``parallel.mesh`` scales across sequences; this module scales within one.
The three recursions of the fused filter are associative scans
(``ops.kalman_parallel``), and an associative scan splits exactly across
devices, as ``ops.kalman_chunked`` re-enters it across host chunks:

1. each device scans its contiguous block of the pose axis
   (``ops.scan.associative_scan``: K1, or K2 past 65,536 elements, on a
   card; the plain ladder on the CPU);
2. the block totals, one composite a device (27 numbers for the filter, 12
   for the RTS suffix, 4 for the quaternion chain), are gathered onto the
   mesh's first device and scanned there (a D-length scan, K1 on a card);
3. each block's exclusive prefix (suffix, for the reverse RTS scan) is
   sent back to the block's device and folded into its local results with
   one broadcast combine of ``ops.scan``; the edge block keeps its local
   results.

``fuse_ekf_rts_seqparallel`` stages block k of every input on
``mesh.devices[k]`` and runs every stage of the filter there, as the JAX
package's SPMD partitioner does from the input shardings: the controls
(``kalman.controls_over_blocks``: a one-pose halo and two more block scans,
``max3`` and ``min3`` of pose indices, carry outages across block edges),
the relative poses, the filter and RTS elements
(``kalman_parallel.fuse_ekf_rts_blocks``: the pose before a block and the
pose after it are its halos). Only halos, block totals and exclusive
prefixes cross devices, by device-to-device copies that PyTorch orders on
the streams; no step waits on the host, so on several cards the blocks
run at once. On a card the work of a block between two scans (seven
stages: three of the controls, four of the filter) and each fold is a
program captured on the second call for a block shape and replayed from
then on (``utils.graphs``), as the JAX
package compiles its ``shard_map`` bodies: the host issues a block's stage
as one replay, and the copies and the totals' scan run between the
replays. On a mesh of one card (``["cuda:0"] * D``) the blocks run one
after another on it.

``sequence_parallel_scan(mesh)`` is the block scan with the contract of
``ops.scan.associative_scan`` for callers that hold whole tensors:
``kalman_chunked.fuse_ekf_rts_chunked``, ``fusion_chunked.fuse_core_chunked``
and the robust chunked gate take it as ``scan_fn`` (host chunks meet device
blocks).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from gps_optimize_slam_tpu_torch.config import EKFConfig, RTSDecisionConfig
from gps_optimize_slam_tpu_torch.ops import kalman, kalman_parallel, scan
from gps_optimize_slam_tpu_torch.parallel.mesh import Mesh
from gps_optimize_slam_tpu_torch.utils import graphs


def _fold(op: str, ext: torch.Tensor, blk: torch.Tensor) -> torch.Tensor:
    """``ext`` (L, ...) combined into every composite of the locally scanned
    block ``blk`` (L, ..., n_k): ext is the accumulated composite, the
    first combine argument in both directions (``ops.scan``'s convention;
    under reverse, the later composite), broadcast over the block."""
    fixed = scan.OPS[op][1](list(ext[..., None].unbind(0)), list(blk.unbind(0)))
    return torch.stack([f.expand_as(blk[0]) for f in fixed])


def _block_scan(mesh: Mesh, op: str, blocks: Sequence[torch.Tensor], reverse: bool) -> List[torch.Tensor]:
    """The cross-device scan of ``op`` over per-block (L, n_k) or (L, B, n_k)
    leaves, block k on ``mesh.devices[k]``: local scans, the scan of the
    block totals on the first device, the fold of each block's exclusive
    prefix (suffix under ``reverse``) on the block's device, a captured
    program on a card (``utils.graphs``; a local scan is one launch, which
    a graph would only wrap in two copies of the block)."""
    d = mesh.size
    if len(blocks) != d:
        raise ValueError(f"{len(blocks)} blocks for a mesh of {d} devices")
    local = [scan.associative_scan(op, blk.contiguous(), reverse) for blk in blocks]
    # A block's total: its last composite (its first, for a suffix scan).
    home = mesh.devices[0]
    totals = torch.stack([(blk[..., 0] if reverse else blk[..., -1]).to(home) for blk in local], -1)
    block_scan = scan.associative_scan(op, totals.contiguous(), reverse)
    out = []
    for k, (dev, blk) in enumerate(zip(mesh.devices, local)):
        if k == (d - 1 if reverse else 0):  # the edge block has nothing before it
            out.append(blk)
            continue
        # The exclusive prefix is the inclusive prefix of the block before
        # (suffix: of the block after).
        ext = block_scan[..., k + 1 if reverse else k - 1].to(dev)
        out.append(graphs.run(_fold, op, ext, blk))
    return out


def block_scan(mesh: Mesh) -> kalman.BlockScanFn:
    """The cross-device scans of ``kalman_parallel.fuse_ekf_rts_blocks`` (and
    of its controls) over ``mesh``, block k on ``mesh.devices[k]``."""
    return lambda op, blocks, reverse=False: _block_scan(mesh, op, blocks, reverse)


def sequence_parallel_scan(mesh: Mesh):
    """A drop-in ``ops.scan.associative_scan`` that splits the scan axis
    into ``mesh.size`` contiguous blocks, block k on ``mesh.devices[k]``.
    Pass it as ``scan_fn=`` to ``kalman_parallel.fuse_ekf_rts_parallel``,
    ``parallel_quat_chain``, ``parallel_position_filter``,
    ``kalman_chunked.fuse_ekf_rts_chunked`` or
    ``fusion_chunked.fuse_core_chunked``. The scan axis must divide by the
    mesh size (``fuse_ekf_rts_seqparallel`` pads); the output lies on the
    input's device. The function carries the mesh as ``.mesh``."""

    def scan_fn(op: str, x: torch.Tensor, reverse: bool = False) -> torch.Tensor:
        d = mesh.size
        n = x.shape[-1]
        if n % d:
            raise ValueError(f"the scan axis ({n}) must divide by the mesh size ({d}); "
                             "fuse_ekf_rts_seqparallel pads for you")
        size = n // d
        blocks = [x[..., k * size : (k + 1) * size].to(dev) for k, dev in enumerate(mesh.devices)]
        return torch.cat([blk.to(x.device) for blk in _block_scan(mesh, op, blocks, reverse)], -1)

    scan_fn.mesh = mesh
    return scan_fn


def _pad_for_mesh(n: int, d: int) -> int:
    return -(-n // d) * d


Inputs = Union[torch.Tensor, np.ndarray, Sequence]


def stage_blocks(mesh: Mesh, slam_times, slam_pos, slam_quat, sim3_pos, sim3_quat, aligned_gps, valid_mask,
                 dtype: Optional[torch.dtype] = None) -> Tuple[list, ...]:
    """The seven inputs of ``fuse_ekf_rts_seqparallel`` (whole trajectories:
    tensors on any device, or arrays) as per-device blocks, block k of each
    on ``mesh.devices[k]`` in ``dtype`` (None: ``slam_pos``'s), the mask as
    bool. The trajectory is padded to a mesh multiple with inert trailing
    steps on the last block (on the last few when a block holds fewer poses
    than the mesh has devices): the last pose repeated (zero motion) at
    timestamps 1 ms apart, NaN GNSS and invalid fixes, a trailing outage
    that the controls dead-reckon and that the RTS suffix never reaches
    across, so padding never perturbs a real pose. Returns seven lists of
    ``mesh.size`` tensors; no device receives more than its block."""
    d = mesh.size
    dtype = torch.as_tensor(slam_pos).dtype if dtype is None else dtype
    n = len(slam_times)
    if n == 0:
        raise ValueError("an empty trajectory")
    size = _pad_for_mesh(n, d) // d

    def split(x, dt=dtype, fill=None):
        """Each device's block of ``x``: its real poses, then its share of
        the padding, made from the last real pose (``fill(last, offset,
        count)``; None repeats it)."""
        x = torch.as_tensor(x)
        out = []
        for k, dev in enumerate(mesh.devices):
            a, b = k * size, (k + 1) * size
            blk = x[a:min(b, n)].to(device=dev, dtype=dt)
            if b > n:
                last = x[n - 1 : n].to(device=dev, dtype=dt)
                off, count = max(a, n) - n, b - max(a, n)
                tail = last.expand(count, *last.shape[1:]) if fill is None else fill(last, off, count)
                blk = torch.cat([blk, tail])
            out.append(blk)
        return out

    # Strictly increasing padded timestamps keep dt > 0 (controls, Qd).
    times = split(slam_times, fill=lambda last, off, count: last + 1e-3 * torch.arange(
        off + 1, off + count + 1, dtype=dtype, device=last.device))
    gps = split(aligned_gps, fill=lambda last, off, count: torch.full_like(last, float("nan")).expand(count, 3))
    valid = split(valid_mask, torch.bool, fill=lambda last, off, count: torch.zeros_like(last).expand(count))
    return (times, split(slam_pos), split(slam_quat), split(sim3_pos), split(sim3_quat), gps, valid)


def fuse_ekf_rts_seqparallel(
    mesh: Mesh,
    slam_times: Inputs,
    slam_pos: Inputs,
    slam_quat: Inputs,
    sim3_pos: Inputs,
    sim3_quat: Inputs,
    aligned_gps: Inputs,
    valid_mask: Inputs,
    ekf_cfg: EKFConfig = EKFConfig(),
    rts_cfg: RTSDecisionConfig = RTSDecisionConfig(),
    rts_mode: str = "outage",
    gather: bool = True,
):
    """``kalman_parallel.fuse_ekf_rts_parallel`` with the pose axis split
    into ``mesh.size`` blocks, block k and every stage of the filter on it
    on ``mesh.devices[k]``.

    The inputs are whole trajectories (tensors on any device, or arrays, in
    ``slam_pos``'s dtype), staged and padded by :func:`stage_blocks`, or
    lists of per-device blocks, block k of each on ``mesh.devices[k]``
    (blocks of any lengths, no padding; the counterpart of the JAX
    package's arrays placed with a ``NamedSharding``). Of ``sim3_pos`` and
    ``sim3_quat`` only the first pose is read.

    Returns (pos (N,3), quat (N,4)) on ``mesh.devices[0]``, or, with
    ``gather=False``, the per-device blocks (lists of (L_k,3) and (L_k,4),
    the padding sliced off), as the JAX function's sharded outputs. Equals
    ``fuse_ekf_rts_parallel`` to float round-off (≤1e-8 m in float64, the
    JAX package's bound)."""
    if isinstance(slam_times, (list, tuple)):
        inputs = [[x.to(dev) for x, dev in zip(arg, mesh.devices, strict=True)]
                  for arg in (slam_times, slam_pos, slam_quat, sim3_pos, sim3_quat, aligned_gps, valid_mask)]
        n = sum(len(t) for t in inputs[0])
        if any(len(t) == 0 for t in inputs[0]):
            raise ValueError("every block needs at least one pose")
    else:
        inputs = stage_blocks(mesh, slam_times, slam_pos, slam_quat, sim3_pos, sim3_quat, aligned_gps, valid_mask)
        n = len(slam_times)
    t, pos, quat, s3p, s3q, gz, gv = inputs
    d = mesh.size
    starts = np.cumsum([0] + [len(x) for x in t])
    blocks = []
    for k, dev in enumerate(mesh.devices):
        prev = None if k == 0 else tuple(x[k - 1][-1:].to(dev) for x in (t, pos, quat, gz, gv))
        nxt = None if k == d - 1 else tuple(x[k + 1][:1].to(dev) for x in (t, pos, quat))
        blocks.append(kalman_parallel.PoseBlock(t[k], pos[k], quat[k], gz[k], gv[k], int(starts[k]), prev, nxt))
    out_pos, out_quat = kalman_parallel.fuse_ekf_rts_blocks(
        blocks, s3p[0][0], s3q[0][0], int(starts[-1]), ekf_cfg, rts_cfg, rts_mode, block_scan(mesh), graphs.run,
    )
    if gather:
        home = mesh.devices[0]
        return tuple(torch.cat([x.to(home) for x in xs])[:n] for xs in (out_pos, out_quat))
    real = [min(max(n - int(a), 0), len(x)) for a, x in zip(starts, t)]  # each block's real poses
    return tuple([x[:r] for x, r in zip(xs, real)] for xs in (out_pos, out_quat))
