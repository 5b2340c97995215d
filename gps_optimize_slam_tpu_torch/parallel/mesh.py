"""Batched multi-sequence fusion, on one card or over a mesh of devices
(port of ``gps_optimize_slam_tpu.parallel.mesh``).

A padded batch of sequences (``parallel.batch``) is fused as ONE batched
program: ``fusion.fuse_core`` and ``fusion.evaluate`` take the leading batch
axis, so every stage is issued once for all rows and each kernel (K1, the
keep lists, K3, K5) launches once with a grid over the rows.
``fuse_buckets`` pipelines the length buckets through the card with
``utils.streaming.stream_chunks``; ``fuse_buckets_checkpointed`` saves each
bucket as it drains and resumes a killed sweep from the buckets on disk.

A ``Mesh`` (``make_mesh``) is a 1-D tuple of devices on the "seq" axis.
Given ``mesh=``, the batch entry points pad the rows to a multiple of its
size D with copies of row 0, and each device fuses a contiguous shard of
rows as one batched program; the outputs are concatenated on
``mesh.devices[0]`` and the padding sliced off (rows are independent, so a
copy cannot perturb a real row). The JAX package shards the batch axis of
one ``jit``-ed program over the mesh, so all shards run at once. The port
issues one program a shard, each distinct device's shards from a host
thread of their own (``_on_devices``), and on a card each shard's fusion,
evaluation and offset estimate is one captured program
(``utils.graphs``, captured on the second call for its shape): a thread
copies its shard's inputs in, replays the graph and clones its outputs,
a few host calls where eager dispatch made ~7,700. Eager, three shards' threads on four H100 cards took about 3× the
same shards issued in turn from one thread, their dispatch contending for
the interpreter lock; replayed, they take as long as the shards in turn
(``tools/torch_phase9_cards.py`` times both). Shards that share a device
run one after another in its thread: a mesh of one card
(``devices=["cuda:0"] * k``, how one card and the CPU tests run this
code) runs its shards in turn. A device may repeat; nothing falls back to
the CPU.

RANSAC draws: the JAX package takes a PRNG key a row; the port takes an
integer seed a row (``seed + i``, as the ``fuse-batch`` command numbers its
sequences), or ``sim3_draws`` to replay given draws. A row seeded ``s``
draws what ``fuse_core`` on that sequence alone draws with ``seed=s``.
"""

from __future__ import annotations

import contextlib
import os
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, List, NamedTuple, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from gps_optimize_slam_tpu_torch.config import FusionConfig
from gps_optimize_slam_tpu_torch.models import fusion
from gps_optimize_slam_tpu_torch.ops import alignment
from gps_optimize_slam_tpu_torch.ops.umeyama import Sim3
from gps_optimize_slam_tpu_torch.parallel.batch import SequenceBatch, _round_up
from gps_optimize_slam_tpu_torch.utils import graphs, profiling, streaming
from gps_optimize_slam_tpu_torch.utils.device import resolve_device

SEQ_AXIS = "seq"


class Mesh(NamedTuple):
    """A 1-D mesh: the devices of the "seq" axis, in order (a device may
    repeat: blocks or shards sharing one device)."""

    devices: Tuple[torch.device, ...]
    axis_names: Tuple[str, ...] = (SEQ_AXIS,)

    @property
    def size(self) -> int:
        return len(self.devices)


def make_mesh(devices: Optional[Sequence] = None, n_devices: Optional[int] = None) -> Mesh:
    """A 1-D mesh over ``devices`` (names or ``torch.device``s, in order; a
    device may repeat, e.g. ``["cuda:0"] * 4`` or ``["cpu"] * 8``), or, with
    ``devices=None``, over the first ``n_devices`` CUDA devices (all of them
    when None). Raises without a card when no ``devices`` are named, and
    when ``n_devices`` exceeds the cards present: the mesh never falls back
    to the CPU."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: a mesh defaults to the cards; pass devices=['cpu'] * k to run on the CPU"
            )
        count = torch.cuda.device_count()
        n = count if n_devices is None else int(n_devices)
        if not 1 <= n <= count:
            raise ValueError(
                f"{n} devices asked for and {count} CUDA devices present; pass devices=[...] to name them "
                f"(a device may repeat, e.g. devices=['cuda:0'] * {n})"
            )
        return Mesh(tuple(torch.device("cuda", i) for i in range(n)))
    if n_devices is not None:
        raise ValueError("pass devices or n_devices, not both")
    devices = tuple(torch.device(d) for d in devices)
    if not devices:
        raise ValueError("a mesh needs at least one device")
    return Mesh(devices)


def _device_groups(devices: Sequence[torch.device]) -> List[List[int]]:
    """The mesh positions of each distinct device, in order of first
    appearance: the shards one host thread runs."""
    groups = {}
    for k, dev in enumerate(devices):
        groups.setdefault(dev, []).append(k)
    return list(groups.values())


def _on_devices(devices: Sequence[torch.device], fn: Callable[[int], object]) -> list:
    """``fn(k)`` for each mesh position k, on ``devices[k]``: one host thread
    a distinct device (inside ``torch.cuda.device`` for a card, on its
    current stream), the positions sharing a device in turn in its thread.
    Returns the results in position order; an exception from any thread
    reaches the caller after every thread has stopped."""
    results = [None] * len(devices)

    def run(group):
        dev = devices[group[0]]
        with torch.cuda.device(dev) if dev.type == "cuda" else contextlib.nullcontext():
            for k in group:
                results[k] = fn(k)

    groups = _device_groups(devices)
    if len(groups) == 1:
        run(groups[0])
        return results
    with ThreadPoolExecutor(max_workers=len(groups)) as pool:
        futures = [pool.submit(run, g) for g in groups]
        for f in futures:
            f.result()
    return results


def _placement(device, mesh: Optional[Mesh]):
    """The device of an unsharded call, after the check that a caller named
    at most one of ``device`` and ``mesh``."""
    if mesh is not None:
        if device is not None:
            raise ValueError("mesh= and device= exclude each other")
        return None
    return resolve_device(device)


def _shard_rows(b: int, d: int):
    """Each of ``d`` devices' contiguous shard of the row indices of a batch
    of ``b`` rows padded to a multiple of ``d`` with copies of row 0."""
    b_pad = _round_up(b, d)
    reps = np.concatenate([np.arange(b), np.zeros(b_pad - b, np.intp)])
    per = b_pad // d
    return [reps[k * per : (k + 1) * per] for k in range(d)]


def _take_rows(batch: SequenceBatch, rows: np.ndarray) -> SequenceBatch:
    return SequenceBatch(*(np.asarray(x)[rows] for x in batch))


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
    mesh: Optional[Mesh] = None,
) -> np.ndarray:
    """Per-sequence clock offsets, estimated on the device in one batched
    call (the FFT speed cross-correlation of
    ``ops.alignment.estimate_time_offset_xcorr_device``), honouring the
    padding masks, one captured program a shape on a card; with ``mesh``,
    one call a device on its shard of rows, the devices' shards issued at
    once (``_on_devices``).
    Returns a host (B,) array for ``fuse_batch(..., time_offsets=...)``."""
    device = _placement(device, mesh)
    dtype = _dtype(batch, dtype)
    if mesh is not None:
        b = np.asarray(batch.slam_times).shape[0]
        rows = _shard_rows(b, mesh.size)
        return np.concatenate(_on_devices(mesh.devices, lambda k: estimate_offsets_batch(
            _take_rows(batch, rows[k]), device=mesh.devices[k], dtype=dtype, max_lag_seconds=max_lag_seconds,
            n_grid=n_grid)))[:b]

    def dev(a, dt=dtype):
        return streaming.to_device((np.asarray(a),), device)[0].to(dt)

    out = graphs.run(
        alignment.estimate_time_offset_xcorr_device,
        dev(batch.slam_times), dev(batch.slam_pos), dev(batch.gps_times), dev(batch.gps_pos),
        slam_mask=dev(batch.slam_mask, torch.bool), gps_valid=dev(batch.gps_valid, torch.bool),
        max_lag_seconds=max_lag_seconds, n_grid=n_grid,
    )
    return streaming.fetch((out,)).numpy()[0].copy()


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


class ShardedBatch(NamedTuple):
    """A batch staged over a mesh, from ``stage_batch(..., mesh=...)``: one
    ``StagedBatch`` a device, each a contiguous shard of the rows padded to
    a mesh multiple with copies of row 0; each shard's row indices, and the
    number of real rows."""

    shards: Tuple[StagedBatch, ...]
    rows: Tuple[np.ndarray, ...]
    n_real: int


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
    mesh: Optional[Mesh] = None,
):
    """Copy a batch onto the card once. ``seeds`` (B,) default to 0..B-1;
    ``time_offsets`` (B,) to zeros. With ``mesh``, a ``ShardedBatch``: each
    device's shard of the rows padded to a mesh multiple (a padding row
    copies row 0, seed and offset included)."""
    device = _placement(device, mesh)
    dtype = _dtype(batch, dtype)
    b = np.asarray(batch.slam_times).shape[0]
    seeds = tuple(range(b)) if seeds is None else tuple(int(s) for s in seeds)
    if len(seeds) != b:
        raise ValueError(f"{len(seeds)} seeds for {b} sequences")
    if time_offsets is None:
        time_offsets = np.zeros(b)
    if mesh is not None:
        shard_rows = _shard_rows(b, mesh.size)
        return ShardedBatch(
            shards=tuple(
                stage_batch(_take_rows(batch, rows), [seeds[i] for i in rows], device=dev, dtype=dtype,
                            time_offsets=np.asarray(time_offsets)[rows])
                for dev, rows in zip(mesh.devices, shard_rows)
            ),
            rows=tuple(shard_rows),
            n_real=b,
        )

    def dev(a, dt=dtype):
        return streaming.to_device((np.asarray(a),), device)[0].to(dt)

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
    mesh: Optional[Mesh] = None,
) -> fusion.FusionOutputs:
    """Fuse a padded batch of sequences as one batched program on the card
    (the CPU only with ``device="cpu"``), or one a device over ``mesh``.

    ``batch`` is a ``SequenceBatch`` (host arrays, staged on every call) or
    a ``StagedBatch`` / ``ShardedBatch`` from ``stage_batch`` (its devices,
    dtype, seeds and offsets are the staged ones). ``estimate_offsets=True``
    (with ``time_offsets=None``) estimates the per-sequence clock offsets on
    the device first (``estimate_offsets_batch``). ``sim3_draws`` (B,
    trials, k) replaces the seeded RANSAC draws. ``mesh`` and ``device``
    exclude each other; with a mesh the outputs are concatenated on
    ``mesh.devices[0]``. Every output leaf has the leading B.
    """
    if isinstance(batch, (StagedBatch, ShardedBatch)):
        staged = batch
    else:
        device = _placement(device, mesh)
        dtype = _dtype(batch, dtype)
        if time_offsets is None and estimate_offsets:
            time_offsets = estimate_offsets_batch(batch, device=device, dtype=dtype, mesh=mesh)
        staged = stage_batch(batch, seeds, device=device, dtype=dtype, time_offsets=time_offsets, mesh=mesh)
    if isinstance(staged, ShardedBatch):
        return _fuse_sharded(staged, config, sim3_draws)
    if staged.gps_sorted and not config.gps_sorted:
        config = config.replace(gps_sorted=True)
    st, sp, sq, gt, gp, gv, sm, toff = staged.args
    return fusion.fuse_core(st, sp, sq, gt, gp, gv, config, seed=staged.seeds, slam_mask=sm,
                            time_offset=toff, sim3_draws=sim3_draws)


def _fuse_sharded(sharded: ShardedBatch, config: FusionConfig, sim3_draws) -> fusion.FusionOutputs:
    """Each shard fused on its own device, the devices' shards issued at once
    (``_on_devices``), the outputs concatenated in shard order on the first
    shard's device with the padding rows sliced off."""
    devices = [shard.args[0].device for shard in sharded.shards]
    home = devices[0]
    # Each shard's draws are on its device before the threads start: a
    # thread touches its own device only.
    draws = [None if sim3_draws is None else sim3_draws[torch.as_tensor(rows, device=sim3_draws.device)].to(dev)
             for rows, dev in zip(sharded.rows, devices)]

    def fuse(k):
        return fuse_batch(sharded.shards[k], config=config, sim3_draws=draws[k])

    outs = _on_devices(devices, fuse)

    def cat(leaves):
        return torch.cat([x.to(home) for x in leaves])[: sharded.n_real]

    return fusion.FusionOutputs(
        **{k: cat([getattr(o, k) for o in outs]) for k in fusion.FusionOutputs._fields if k != "sim3"},
        sim3=Sim3(*(cat([getattr(o.sim3, k) for o in outs]) for k in Sim3._fields)),
    )


_LEAVES = tuple(k for k in fusion.FusionOutputs._fields if k != "sim3")


def _fetch_outputs(out: fusion.FusionOutputs) -> streaming.Fetched:
    """Every leaf of a fusion's outputs on its way to the host
    (``streaming.fetch``; ``_host_outputs`` takes them)."""
    return streaming.fetch([getattr(out, k) for k in _LEAVES] + list(out.sim3))


def _host_outputs(fetched: streaming.Fetched) -> fusion.FusionOutputs:
    """The fetched leaves as host ``FusionOutputs`` of NumPy arrays."""
    leaves = fetched.numpy()
    return fusion.FusionOutputs(**dict(zip(_LEAVES, leaves)), sim3=Sim3(*leaves[len(_LEAVES):]))


def _sweep(pending, seeds, results, config, device, dtype, estimate_offsets, mesh=None, on_bucket=None) -> None:
    """Fuse the ``(j, (idxs, batch))`` buckets of ``pending`` into
    ``results`` (in original order, each leaf sliced to its sequence's
    length), pipelined with ``utils.streaming.stream_chunks``, each bucket
    on ``device`` or sharded over ``mesh``; then ``on_bucket(j, idxs,
    rows)`` for each bucket as it drains. Traced, each callback is a host
    span (``sweep.stage``, ``sweep.launch``, and the drain's wait for its
    copy, ``sweep.drain.wait``, and its per-row slicing,
    ``sweep.drain.rows``)."""

    def _stage(jb):
        with profiling.span("sweep.stage"):
            idxs, b = jb[1]
            toff = estimate_offsets_batch(b, device=device, dtype=dtype, mesh=mesh) if estimate_offsets else None
            return stage_batch(b, seeds[idxs], device=device, dtype=dtype, time_offsets=toff, mesh=mesh)

    def _launch(jb, staged):
        with profiling.span("sweep.launch"):
            return _fetch_outputs(fuse_batch(staged, config=config))

    def _drain(jb, fetched):
        j, (idxs, b) = jb
        with profiling.span("sweep.drain.wait"):
            host = _host_outputs(fetched)
        n_max = b.slam_times.shape[1]
        rows = []
        with profiling.span("sweep.drain.rows"):
            for row, i in enumerate(idxs):
                n = int(b.n_slam[row])

                def slice_leaf(x):
                    # A copy: the fetched leaves are pinned buffers, returned to
                    # the host allocator's pool once the bucket is drained.
                    x_row = x[row]
                    return (x_row[:n] if x_row.ndim >= 1 and x_row.shape[0] == n_max else x_row).copy()

                results[int(i)] = fusion.FusionOutputs(
                    **{k: slice_leaf(v) for k, v in host._asdict().items() if k != "sim3"},
                    sim3=Sim3(*(slice_leaf(v) for v in host.sim3)),
                )
                rows.append(results[int(i)])
        if on_bucket is not None:
            on_bucket(j, idxs, rows)

    streaming.stream_chunks(pending, _stage, _launch, _drain)


def fuse_buckets(
    buckets,
    seeds: Optional[Sequence[int]] = None,
    config: FusionConfig = FusionConfig(),
    device=None,
    dtype=None,
    estimate_offsets: bool = False,
    mesh: Optional[Mesh] = None,
):
    """Fuse length-bucketed sequences (``batch.bucket_by_length`` output).

    Each bucket runs as its own batched program (bounded padding waste), on
    ``device`` or, with ``mesh``, a program a device on its shard of the
    bucket's rows.
    ``seeds`` is (B_total,) in the ORIGINAL sequence order, 0..B_total-1 by
    default. Returns a list in original order of per-sequence
    ``FusionOutputs`` of host arrays, every SLAM-indexed leaf sliced to the
    sequence's real length.

    Buckets are independent programs, so the sweep is software-pipelined
    (``utils.streaming``): bucket i+1's staging and bucket i-1's host
    read-back overlap bucket i's device time."""
    device = _placement(device, mesh)
    total = sum(len(idxs) for idxs, _ in buckets)
    seeds = np.arange(total) if seeds is None else np.asarray(seeds)
    results = [None] * total
    _sweep(list(enumerate(buckets)), seeds, results, config, device, dtype, estimate_offsets, mesh)
    return results


def _outputs_to_tree(out: fusion.FusionOutputs) -> dict:
    d = out._asdict()
    d["sim3"] = d["sim3"]._asdict()
    return d


def _outputs_from_tree(d: dict) -> fusion.FusionOutputs:
    """Host ``FusionOutputs`` from a restored checkpoint's dict of CPU
    tensors (the leaves ``fuse_buckets`` returns: NumPy arrays)."""
    leaves = {k: v.numpy() for k, v in d.items() if k != "sim3"}
    return fusion.FusionOutputs(**leaves, sim3=Sim3(**{k: v.numpy() for k, v in d["sim3"].items()}))


def fuse_buckets_checkpointed(
    buckets,
    seeds: Optional[Sequence[int]],
    ckpt_dir: str,
    config: FusionConfig = FusionConfig(),
    device=None,
    dtype=None,
    estimate_offsets: bool = False,
    mesh: Optional[Mesh] = None,
):
    """``fuse_buckets`` with a checkpoint a bucket and resume
    (``utils.checkpoint``).

    Each bucket is saved to ``ckpt_dir/bucket_NNNN`` as it drains (its state
    first, ``metadata.json`` last: the metadata file marks it complete). A
    rerun with the same ``ckpt_dir`` restores the finished buckets from disk
    and fuses only the rest, so a killed sweep loses at most the buckets in
    flight. Results equal ``fuse_buckets``'s.

    The caller owns invalidation: pass a fresh ``ckpt_dir`` when the inputs
    or the configuration change. A bucket whose stored sequence indices
    differ from the bucket's now raises ValueError."""
    from gps_optimize_slam_tpu_torch.utils import checkpoint as ckpt_util

    device = _placement(device, mesh)
    total = sum(len(idxs) for idxs, _ in buckets)
    seeds = np.arange(total) if seeds is None else np.asarray(seeds)
    results = [None] * total

    def _bucket_path(j: int) -> str:
        return os.path.join(ckpt_dir, f"bucket_{j:04d}")

    pending = []
    for j, bucket in enumerate(buckets):
        idxs = np.asarray(bucket[0])
        bpath = _bucket_path(j)
        if not os.path.exists(os.path.join(bpath, "metadata.json")):
            pending.append((j, bucket))
            continue
        state, meta = ckpt_util.restore_checkpoint_untyped(bpath)
        stored = np.asarray(meta["indices"])
        if not np.array_equal(stored, idxs):
            raise ValueError(
                f"checkpoint {bpath} was written for sequences {stored.tolist()}, bucket {j} now holds "
                f"{idxs.tolist()}: pass a fresh ckpt_dir"
            )
        for i in idxs:
            results[int(i)] = _outputs_from_tree(state[f"seq_{int(i)}"])

    def _save(j, idxs, rows):
        ckpt_util.save_checkpoint(
            _bucket_path(j),
            {f"seq_{int(i)}": _outputs_to_tree(r) for i, r in zip(idxs, rows)},
            metadata={"bucket": j, "indices": np.asarray(idxs).tolist()},
        )

    _sweep(pending, seeds, results, config, device, dtype, estimate_offsets, mesh, on_bucket=_save)
    return results


def evaluate_batch(batch: Union[SequenceBatch, StagedBatch], outputs: fusion.FusionOutputs,
                   skip_seconds: float = 5.0):
    """Batched evaluation (``fusion.evaluate`` with the batch axis, one
    captured program a shape on a card), masked to real poses, on the
    outputs' device and in their dtype. ``batch`` is the ``SequenceBatch``
    that was fused (its SLAM times and positions copied to the device), or
    the ``StagedBatch`` that ``fuse_batch`` took (its device SLAM times and
    positions, copied nowhere): the same evaluation bit for bit."""
    dt, device = outputs.corrected_pos.dtype, outputs.corrected_pos.device
    if isinstance(batch, StagedBatch):
        slam_times, slam_pos = (x.to(device=device, dtype=dt) for x in batch.args[:2])
    else:
        slam_times, slam_pos = (torch.as_tensor(np.asarray(a), device=device).to(dt)
                                for a in (batch.slam_times, batch.slam_pos))
    return fusion.evaluate(slam_times, slam_pos, outputs, skip_seconds=skip_seconds)
