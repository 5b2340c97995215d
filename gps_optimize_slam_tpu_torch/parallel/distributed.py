"""Multi-process batched fusion on ``torch.distributed`` (port of
``gps_optimize_slam_tpu.parallel.distributed``).

* ``initialize``: joins the process group over a ``tcp://`` rendezvous,
  NCCL for a rank on a card and gloo on the CPU. Gloo may be asked for on
  CUDA ranks: NCCL refuses two ranks on one card, so that is how one card
  runs two ranks.
* ``global_mesh``: a ``parallel.mesh.Mesh`` of every rank's device, in rank
  order.
* ``fuse_batch_distributed``: every rank passes the same full host batch;
  the rows are padded to a multiple of the world size with copies of row 0,
  and rank r fuses rows [r·B/P, (r+1)·B/P) with ``parallel.mesh.fuse_batch``
  on its device. The per-sequence scans never cross ranks.
* ``gather_outputs``: all-gathers each output leaf in rank order and
  returns host NumPy arrays with the padding dropped. NCCL gathers on the
  card; gloo stages each leaf to the host first and gathers there.

Nothing here catches a collective's failure: a rank that cannot reach the
others raises (or times out after ``timeout_s``).
"""

from __future__ import annotations

import datetime
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from gps_optimize_slam_tpu_torch.config import FusionConfig
from gps_optimize_slam_tpu_torch.models import fusion
from gps_optimize_slam_tpu_torch.ops.umeyama import Sim3
from gps_optimize_slam_tpu_torch.parallel import mesh as pmesh
from gps_optimize_slam_tpu_torch.parallel.batch import SequenceBatch

# This rank's device, set by ``initialize``: the process group is state of
# the process, and so is the device it was joined with.
_device: Optional[torch.device] = None


def _rank_device(process_id: int, device) -> torch.device:
    """The rank's device: the one named, else card ``process_id`` modulo the
    cards present; without a card and without a name, raise."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: a rank runs on a card; pass device='cpu' to run it on the CPU")
    return torch.device("cuda", process_id % torch.cuda.device_count())


def initialize(
    coordinator_address: str,
    num_processes: int,
    process_id: int,
    backend: Optional[str] = None,
    device=None,
    timeout_s: int = 120,
) -> torch.device:
    """Join the process group (once a process, before any collective):
    ``coordinator_address`` is ``host:port`` of the rendezvous, rank 0
    listens there. ``backend`` defaults to "nccl" for a CUDA rank and
    "gloo" for a CPU one. Returns the rank's device."""
    global _device
    dev = _rank_device(process_id, device)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    address = coordinator_address if "://" in coordinator_address else f"tcp://{coordinator_address}"
    dist.init_process_group(
        backend=backend, init_method=address, world_size=num_processes, rank=process_id,
        timeout=datetime.timedelta(seconds=timeout_s),
    )
    _device = dev
    return dev


def _this_device() -> torch.device:
    if _device is None or not dist.is_initialized():
        raise RuntimeError("call distributed.initialize first")
    return _device


def global_mesh() -> pmesh.Mesh:
    """A 1-D mesh of every rank's device, in rank order."""
    device = _this_device()
    names = [None] * dist.get_world_size()
    dist.all_gather_object(names, str(device))
    return pmesh.Mesh(tuple(torch.device(n) for n in names))


def fuse_batch_distributed(
    batch: SequenceBatch,
    seeds: Optional[Sequence[int]] = None,
    config: FusionConfig = FusionConfig(),
    device=None,
    dtype=None,
    time_offsets=None,
):
    """Fuse ``batch`` across every rank. Every rank passes the same full
    host batch (``seeds`` (B,) default to 0..B-1, ``time_offsets`` (B,) to
    zeros); each fuses its own shard of rows on ``device`` (the rank's
    device by default) as one batched program, row i with seed
    ``seeds[i]``. Returns (this rank's ``FusionOutputs``, B); pass both to
    ``gather_outputs``."""
    b = np.asarray(batch.slam_times).shape[0]
    seeds = np.arange(b) if seeds is None else np.asarray(seeds)
    time_offsets = np.zeros(b) if time_offsets is None else np.asarray(time_offsets)
    rows = pmesh._shard_rows(b, dist.get_world_size())[dist.get_rank()]
    out = pmesh.fuse_batch(
        pmesh._take_rows(batch, rows), seeds[rows].tolist(), config=config,
        device=device if device is not None else _this_device(), dtype=dtype, time_offsets=time_offsets[rows],
    )
    return out, b


def _all_gather(leaf: torch.Tensor, on_host: bool) -> np.ndarray:
    """One leaf gathered from every rank, concatenated in rank order along
    the rows (bool leaves travel as uint8)."""
    x = leaf.to(torch.uint8) if leaf.dtype == torch.bool else leaf
    x = x.cpu() if on_host else x
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, x.contiguous())
    out = torch.cat(parts).cpu().numpy()
    return out.astype(bool) if leaf.dtype == torch.bool else out


def gather_outputs(outputs: fusion.FusionOutputs, n_real: Optional[int] = None) -> fusion.FusionOutputs:
    """Every rank's outputs on every rank, as host NumPy arrays in row
    order, the padding rows dropped when ``n_real`` is given. NCCL gathers
    the leaves on the card; gloo gathers them on the host."""
    on_host = dist.get_backend() != "nccl"

    def gather(leaf):
        out = _all_gather(leaf, on_host)
        return out if n_real is None else out[:n_real]

    return fusion.FusionOutputs(
        **{k: gather(getattr(outputs, k)) for k in fusion.FusionOutputs._fields if k != "sim3"},
        sim3=Sim3(*(gather(x) for x in outputs.sim3)),
    )
