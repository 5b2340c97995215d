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
   folded into its local results with one broadcast combine of
   ``ops.scan``; the edge block keeps its local results.

``sequence_parallel_scan(mesh)`` is that scan with the contract of
``ops.scan.associative_scan``; ``fuse_ekf_rts_seqparallel`` passes it to
``kalman_parallel.fuse_ekf_rts_parallel`` as ``scan_fn``, and
``kalman_chunked.fuse_ekf_rts_chunked`` and
``fusion_chunked.fuse_core_chunked`` take it too (host chunks meet device
blocks).

Unlike the JAX package, whose SPMD partitioner also splits the elementwise
stages (controls, relative poses, element construction) by the input
shardings, only the three scans are split across devices here: everything
else runs on ``mesh.devices[0]``, and the blocks are moved to their devices
for the scans. On a mesh of one card (``["cuda:0"] * D``) the blocks run one
after another on it.
"""

from __future__ import annotations

from typing import Tuple

import torch

from gps_optimize_slam_tpu_torch.config import EKFConfig, RTSDecisionConfig
from gps_optimize_slam_tpu_torch.ops import kalman_parallel, scan
from gps_optimize_slam_tpu_torch.parallel.mesh import Mesh


def _block_scan(mesh: Mesh, op: str, x: torch.Tensor, reverse: bool) -> torch.Tensor:
    """The cross-device scan of ``op`` over the (L, n) or (L, B, n) leaves
    ``x``: local scans, the scan of the block totals, the fold of each
    block's exclusive prefix (suffix under ``reverse``)."""
    d = mesh.size
    n = x.shape[-1]
    if n % d:
        raise ValueError(f"the scan axis ({n}) must divide by the mesh size ({d}); "
                         "fuse_ekf_rts_seqparallel pads for you")
    combine = scan.OPS[op][1]
    size = n // d
    local = [scan.associative_scan(op, x[..., k * size : (k + 1) * size].to(dev).contiguous(), reverse)
             for k, dev in enumerate(mesh.devices)]
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
        # (suffix: of the block after). It is the accumulated composite, the
        # first combine argument in both directions (ops.scan's convention;
        # under reverse, the later composite), broadcast over the block.
        ext = block_scan[..., k + 1 if reverse else k - 1].to(dev)
        fixed = combine(list(ext[..., None].unbind(0)), list(blk.unbind(0)))
        out.append(torch.stack([f.expand_as(blk[0]) for f in fixed]))
    return torch.cat([blk.to(x.device) for blk in out], -1)


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
        return _block_scan(mesh, op, x, reverse)

    scan_fn.mesh = mesh
    return scan_fn


def _pad_for_mesh(n: int, d: int) -> int:
    return -(-n // d) * d


def fuse_ekf_rts_seqparallel(
    mesh: Mesh,
    slam_times,
    slam_pos,
    slam_quat,
    sim3_pos,
    sim3_quat,
    aligned_gps,
    valid_mask,
    ekf_cfg: EKFConfig = EKFConfig(),
    rts_cfg: RTSDecisionConfig = RTSDecisionConfig(),
    rts_mode: str = "outage",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``kalman_parallel.fuse_ekf_rts_parallel`` with its three scans split
    over ``mesh`` (``sequence_parallel_scan``). Inputs (tensors or arrays,
    in ``slam_pos``'s dtype) are staged on ``mesh.devices[0]``, where the
    elementwise stages run and the outputs (pos (N,3), quat (N,4)) are
    returned.

    The trajectory is padded to a mesh multiple with inert trailing steps:
    the last pose repeated (zero motion) at timestamps 1 ms apart, NaN GNSS
    and invalid fixes, a trailing outage that the controls dead-reckon and
    that the RTS suffix never reaches across, so padding never perturbs a
    real pose. Outputs are sliced back to N. Equals
    ``fuse_ekf_rts_parallel`` to float round-off (≤1e-8 m in float64, the
    JAX package's bound)."""
    home = mesh.devices[0]
    dtype = torch.as_tensor(slam_pos).dtype
    n = len(slam_times)
    pad = _pad_for_mesh(n, mesh.size) - n

    def stage(x, dt=dtype):
        return torch.as_tensor(x).to(device=home, dtype=dt)

    def pad_repeat(x):
        x = stage(x)
        return torch.cat([x, x[-1:].expand(pad, *x.shape[1:])]) if pad else x

    st = stage(slam_times)
    gz = stage(aligned_gps)
    gv = stage(valid_mask, torch.bool)
    if pad:
        # Strictly increasing padded timestamps keep dt > 0 (controls, Qd).
        st = torch.cat([st, st[-1] + 1e-3 * torch.arange(1, pad + 1, dtype=dtype, device=home)])
        gz = torch.cat([gz, torch.full((pad, 3), float("nan"), dtype=dtype, device=home)])
        gv = torch.cat([gv, torch.zeros(pad, dtype=torch.bool, device=home)])
    pos, quat = kalman_parallel.fuse_ekf_rts_parallel(
        st, pad_repeat(slam_pos), pad_repeat(slam_quat), pad_repeat(sim3_pos), pad_repeat(sim3_quat), gz, gv,
        ekf_cfg, rts_cfg, rts_mode=rts_mode, scan_fn=sequence_parallel_scan(mesh),
    )
    return pos[:n], quat[:n]
