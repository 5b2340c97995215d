"""Batched multi-sequence fusion on one card (port of
``gps_optimize_slam_tpu.parallel.mesh``).

A padded batch of sequences (``parallel.batch``) is fused as ONE batched
program: ``fusion.fuse_core`` and ``fusion.evaluate`` take the leading batch
axis, so every stage is issued once for all rows and each kernel (K1, the
keep lists, K3, K5) launches once with a grid over the rows. The JAX package
``vmap``s ``fuse_core`` and shards the batch axis over a device mesh; the
port runs on one card, so the mesh, its shardings and the padding of the
batch to a mesh multiple are left out. ``fuse_buckets`` pipelines the
length buckets through the card with ``utils.streaming.stream_chunks``.

RANSAC draws: the JAX package takes a PRNG key a row; the port takes an
integer seed a row (``seed + i``, as the ``fuse-batch`` command numbers its
sequences), or ``sim3_draws`` to replay given draws. A row seeded ``s``
draws what ``fuse_core`` on that sequence alone draws with ``seed=s``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from gps_optimize_slam_tpu_torch.config import FusionConfig
from gps_optimize_slam_tpu_torch.models import fusion
from gps_optimize_slam_tpu_torch.ops import alignment
from gps_optimize_slam_tpu_torch.ops.umeyama import Sim3
from gps_optimize_slam_tpu_torch.parallel.batch import SequenceBatch
from gps_optimize_slam_tpu_torch.utils import streaming
from gps_optimize_slam_tpu_torch.utils.device import resolve_device


def _dtype(batch: SequenceBatch, dtype) -> torch.dtype:
    """The working dtype: the given one, else float64 for float64 host arrays
    (``pad_batch`` makes them), else float32."""
    if dtype is not None:
        return dtype
    return torch.float64 if np.asarray(batch.slam_pos).dtype == np.float64 else torch.float32


def estimate_offsets_batch(
    batch: SequenceBatch,
    device=None,
    dtype=None,
    max_lag_seconds: float = 10.0,
    n_grid: int = 4096,
) -> np.ndarray:
    """Per-sequence clock offsets, estimated on the device in one batched
    call (the FFT speed cross-correlation of
    ``ops.alignment.estimate_time_offset_xcorr_device``), honouring the
    padding masks. Returns a host (B,) array for
    ``fuse_batch(..., time_offsets=...)``."""
    device = resolve_device(device)
    dtype = _dtype(batch, dtype)

    def dev(a, dt=dtype):
        return torch.as_tensor(np.asarray(a), device=device).to(dt)

    out = alignment.estimate_time_offset_xcorr_device(
        dev(batch.slam_times), dev(batch.slam_pos), dev(batch.gps_times), dev(batch.gps_pos),
        slam_mask=dev(batch.slam_mask, torch.bool), gps_valid=dev(batch.gps_valid, torch.bool),
        max_lag_seconds=max_lag_seconds, n_grid=n_grid,
    )
    return out.cpu().numpy()


class StagedBatch(NamedTuple):
    """A batch already on the card, from ``stage_batch``: pass it to
    ``fuse_batch`` in place of a ``SequenceBatch`` to skip the host→device
    copy on repeated calls."""

    args: tuple  # slam_times, slam_pos, slam_quat, gps_times, gps_pos, gps_valid, slam_mask, time_offsets
    seeds: tuple  # the RANSAC seed of each row
    # Every row's VALID GPS timestamps were verified nondecreasing on the
    # host at staging time: fuse_batch may then run with
    # config.gps_sorted=True (skips the alignment's compaction sort;
    # identical outputs, see ops.alignment._compact_sort).
    gps_sorted: bool = False


def _gps_rows_sorted(gps_times, gps_valid) -> bool:
    """Whether every row's valid GPS timestamps are nondecreasing (the host
    check ``pipeline.fuse_arrays`` applies to one sequence)."""
    gt = np.asarray(gps_times)
    gv = np.asarray(gps_valid, bool)
    return all(np.all(np.diff(row[vrow]) >= 0) for row, vrow in zip(gt, gv))


def stage_batch(
    batch: SequenceBatch,
    seeds: Optional[Sequence[int]] = None,
    device=None,
    dtype=None,
    time_offsets=None,
) -> StagedBatch:
    """Copy a batch onto the card once. ``seeds`` (B,) default to 0..B-1;
    ``time_offsets`` (B,) to zeros."""
    device = resolve_device(device)
    dtype = _dtype(batch, dtype)
    b = np.asarray(batch.slam_times).shape[0]
    seeds = tuple(range(b)) if seeds is None else tuple(int(s) for s in seeds)
    if len(seeds) != b:
        raise ValueError(f"{len(seeds)} seeds for {b} sequences")
    if time_offsets is None:
        time_offsets = np.zeros(b)

    def dev(a, dt=dtype):
        return torch.as_tensor(np.asarray(a), device=device).to(dt)

    args = (
        dev(batch.slam_times), dev(batch.slam_pos), dev(batch.slam_quat), dev(batch.gps_times),
        dev(batch.gps_pos), dev(batch.gps_valid, torch.bool), dev(batch.slam_mask, torch.bool),
        dev(time_offsets),
    )
    return StagedBatch(args=args, seeds=seeds, gps_sorted=_gps_rows_sorted(batch.gps_times, batch.gps_valid))


def fuse_batch(
    batch,
    seeds: Optional[Sequence[int]] = None,
    config: FusionConfig = FusionConfig(),
    device=None,
    dtype=None,
    time_offsets=None,
    estimate_offsets: bool = False,
    sim3_draws: Optional[torch.Tensor] = None,
) -> fusion.FusionOutputs:
    """Fuse a padded batch of sequences as one batched program on the card
    (the CPU only with ``device="cpu"``).

    ``batch`` is a ``SequenceBatch`` (host arrays, staged on every call) or
    a ``StagedBatch`` from ``stage_batch`` (its device, dtype, seeds and
    offsets are the staged ones). ``estimate_offsets=True`` (with
    ``time_offsets=None``) estimates the per-sequence clock offsets on the
    device first (``estimate_offsets_batch``). ``sim3_draws`` (B, trials, k)
    replaces the seeded RANSAC draws. Every output leaf has the leading B.
    """
    if isinstance(batch, StagedBatch):
        staged = batch
    else:
        device = resolve_device(device)
        dtype = _dtype(batch, dtype)
        if time_offsets is None and estimate_offsets:
            time_offsets = estimate_offsets_batch(batch, device=device, dtype=dtype)
        staged = stage_batch(batch, seeds, device=device, dtype=dtype, time_offsets=time_offsets)
    if staged.gps_sorted and not config.gps_sorted:
        config = config.replace(gps_sorted=True)
    st, sp, sq, gt, gp, gv, sm, toff = staged.args
    return fusion.fuse_core(st, sp, sq, gt, gp, gv, config, seed=staged.seeds, slam_mask=sm,
                            time_offset=toff, sim3_draws=sim3_draws)


def _to_host(out: fusion.FusionOutputs) -> fusion.FusionOutputs:
    """Every leaf of a fusion's outputs as a host NumPy array."""
    d = {k: v.cpu().numpy() for k, v in out._asdict().items() if k != "sim3"}
    return fusion.FusionOutputs(**d, sim3=Sim3(*(v.cpu().numpy() for v in out.sim3)))


def fuse_buckets(
    buckets,
    seeds: Optional[Sequence[int]] = None,
    config: FusionConfig = FusionConfig(),
    device=None,
    dtype=None,
    estimate_offsets: bool = False,
):
    """Fuse length-bucketed sequences (``batch.bucket_by_length`` output).

    Each bucket runs as its own batched program (bounded padding waste).
    ``seeds`` is (B_total,) in the ORIGINAL sequence order, 0..B_total-1 by
    default. Returns a list in original order of per-sequence
    ``FusionOutputs`` of host arrays, every SLAM-indexed leaf sliced to the
    sequence's real length.

    Buckets are independent programs, so the sweep is software-pipelined
    (``utils.streaming``): bucket i+1's staging and bucket i-1's host
    read-back overlap bucket i's device time."""
    device = resolve_device(device)
    total = sum(len(idxs) for idxs, _ in buckets)
    seeds = np.arange(total) if seeds is None else np.asarray(seeds)
    results = [None] * total

    def _stage(bucket):
        idxs, b = bucket
        toff = estimate_offsets_batch(b, device=device, dtype=dtype) if estimate_offsets else None
        return stage_batch(b, seeds[idxs], device=device, dtype=dtype, time_offsets=toff)

    def _launch(bucket, staged):
        return fuse_batch(staged, config=config)

    def _drain(bucket, out):
        idxs, b = bucket
        host = _to_host(out)
        n_max = b.slam_times.shape[1]
        for row, i in enumerate(idxs):
            n = int(b.n_slam[row])

            def slice_leaf(x):
                x_row = x[row]
                return x_row[:n] if x_row.ndim >= 1 and x_row.shape[0] == n_max else x_row

            results[int(i)] = fusion.FusionOutputs(
                **{k: slice_leaf(v) for k, v in host._asdict().items() if k != "sim3"},
                sim3=Sim3(*(slice_leaf(v) for v in host.sim3)),
            )

    streaming.stream_chunks(buckets, _stage, _launch, _drain)
    return results


def evaluate_batch(batch: SequenceBatch, outputs: fusion.FusionOutputs, skip_seconds: float = 5.0):
    """Batched evaluation (``fusion.evaluate`` with the batch axis), masked to
    real poses, on the outputs' device and in their dtype."""
    dt, device = outputs.corrected_pos.dtype, outputs.corrected_pos.device
    return fusion.evaluate(
        torch.as_tensor(np.asarray(batch.slam_times), device=device).to(dt),
        torch.as_tensor(np.asarray(batch.slam_pos), device=device).to(dt),
        outputs,
        skip_seconds=skip_seconds,
    )
