#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``gps_optimize_slam_tpu_torch``) on one
NVIDIA GPU: builds the CUDA kernels from ``gps_optimize_slam_tpu_torch/csrc``,
holds each against its plain PyTorch version on the card, and drives the
port's paths on data built from the real KITTI seq-04 golden arrays:
the in-core path (``pipeline.fuse_files`` / ``fuse_arrays`` →
``fusion.fuse_core`` + ``fusion.evaluate`` → ``export_result``) on seq-04
and on a 4,661-pose sequence, the out-of-core chunked path
(``pipeline.fuse_files_chunked`` → ``fusion_chunked.fuse_core_chunked`` +
``evaluate_chunked``) on a 1,048,576-pose sequence and on seq-04, and the
robust and ground-truth path (dirty GNSS through the χ² gate of
``models.robust`` in core and out of core, ``evaluate_vs_track`` and its
chunked form, the cross-correlation clock offsets, adaptive RANSAC stopping,
and the ``fuse`` command) at both sizes, batched multi-sequence fusion
(``parallel.mesh``: the eleven KITTI odometry sequences in length buckets,
a 64-row fleet bucket, and the ``fuse-batch`` command), and the pose-graph
refinement (``pipeline.refine_pose_graph`` after ``fuse_arrays`` on a
4,541-pose shuttle, and the ``refine-graph`` and ``kitti2tum`` commands), the
multi-device paths on blocks sharing the card (``parallel.seqpar``,
``mesh=`` shards, the ``distributed_launch`` example over gloo and NCCL,
``decimated_view``), and a bucket of long logs (four rows of 300,000 to
524,288 poses) through the batched entry points and the ``fuse-batch``
command, on K2's and K4's batch grids.

Usage (from the repository root, on a machine with a CUDA device):

    python3 chip_smoke.py

Prints one JSON object per phase, the card's name and power limit as
``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` gives them,
one ``{"kernels": [...]}`` line, and as its last line
``{"ok": true, "device": {...}}``. Any failure raises and the exit code is
non-zero; without a CUDA device it exits with 2 before doing anything. The
port imports no JAX; neither does this script.

Phases:
  0. set-up: card, versions, kernel build time;
  1. each kernel against its plain version on the card, with CUDA-event
     times, each kernel's bound (bytes over 3.35 TB/s or operations over the
     published peak, whichever is larger) and, where one PyTorch call
     computes the same function, that call's time: K1, 8 combines at N = 271
     and 4661; K2, 8 combines at N = 262,145 (a default chunk plus its
     carry), 262,145 + 777, 524,289 (phase 5's chunk plus its carry), 20,001
     (fewer tiles than persistent blocks) and 1,048,577 (many more), also
     held against K1; the keep-list kernel's lists against the plain mask's
     compaction at 4661 x 4661 (also part-masked, at UTM magnitudes and with
     one candidate tile) and 524,288 x 524,288; K3, 4661 x 4661 (also at
     UTM magnitudes), one candidate tile, fewer queries than one block
     takes, a ragged last block, 16,384 x 262,144, each all-masked too and
     bit for bit against K4, beside the reference's own method
     (``torch.cdist`` and ``min``, where its matrix fits in half the card's
     free memory; past 2^31 - 1 pairs with the matrix-product expansion) as
     its library yardstick; K4, 16,384 x
     300,000, 700 x 524,288 shuffled (few query tiles, long keep lists: K4
     by the routing rule) and 524,288 x 524,288 (phase 5's NN blocks, K3 by
     the rule; the plain version on every 64th query; the kernel alone and
     with its wrapper), bit for bit against K3, and all-masked; K5, counts equal
     to the plain version's at 1000 trials x 4661 and 279 points and 333 x
     5003 (ragged point and trial chunks), with every point invalid, and
     twice on the same inputs; float32 and float64; and the routes: K1
     against K2 (and against the plain version) from 271 to 524,289 elements
     and at the last length the JAX package's budget gave K1, K1's batch
     grid against K2's at 2 to 64 rows of 16,385 to 524,289 elements, K3
     against K4 at 16,384 queries and 4661 to 1,048,576 candidates and, with
     shuffled candidates (every tile kept, long keep lists), at 700 to
     16,384 queries, on the same inputs, the times that place the routing
     thresholds on this card; the batch grids (``@batch`` entries): K1,
     every combine, the keep lists with K3, and K5, each at the eleven KITTI
     lengths as one ragged batch and at 64 x 4661, against the batched plain
     version and row by row against the single-row kernel (K1 to TOL, the
     others bit for bit), timed at 64 x 4661 in float32; K2, every combine,
     at four ragged float64 rows of 524,289 / 393,217 / 300,001 / 20,001
     elements (identity-padded) and at 4 x 20,001, against the batched plain
     version and row by row against K2 alone (bit for bit for add2, max3,
     min3), timed beside K1's grid; K4 (one work list over all rows' query
     tiles) at 4 x 700 x 524,288
     shuffled candidates with a row all masked and at phase 10's evaluation
     shape, bit for bit against K3's batch grid and against the plain
     version on every 64th query, timed beside it;
  2. seq-04 golden arrays, float64 UTM, ``fuse_arrays`` on the card, held
     against tests/golden/seq04_golden.npz and seq04_meta.json;
  3. seq-04 from TUM + GNSS files rebuilt from the npz, ``fuse_files`` in
     float32 ENU on the card + ``export_result``, held against the port's
     own CPU float64 run of the same files;
  4. a 4,661-pose sequence (KITTI seq-02's length) made of time-shifted
     replicas of seq-04, float32 and float64 on the card against the port's
     CPU float64 run, with the kernels' launch counts and the warm wall time;
  5. the chunked path at 1,048,576 poses (3,870 seq-04 replicas, GNSS
     outages straddling the 262,144-pose boundaries), float64 on the card:
     ``fuse_core_chunked`` (524,288-pose chunks) against the in-core
     ``fusion.fuse_core``, ``evaluate_chunked`` (524,288-pose NN blocks, K3
     by the route) once more with the blocks forced onto K4, and against
     262,144-pose blocks, launch counts, warm wall times, poses per second
     and peak device memory; and ``fuse_files_chunked`` +
     ``export_result`` on the seq-04 files against the in-core
     ``fuse_files``, with launch counts of its own;
  6. the robust and ground-truth path, float64 on the card. In core, the
     4,661-pose sequence with 1 % gross outliers and an 8 s outage injected
     by ``utils.faults``: ``fuse_arrays(robust=True)`` under the parallel
     and the sequential gate (both at their fixed point, masks equal,
     positions ≤1e-9 m; every injected outlier rejected; the gated
     trajectory closer to the clean fusion than the ungated one; the card
     against the CPU run ≤1e-6 m), ``evaluate_vs_track`` against an
     independent track in core (K3) and chunked, the ``xcorr`` and
     ``xcorr_device`` offsets on a GNSS clock moved by 1.7 s, and
     ``sim3_ransac`` under ``stop_probability``. Out of core, the
     1,048,576-pose sequence with 0.5 % outliers:
     ``fuse_core_chunked(robust=True)`` against
     ``fuse_robust(gate_mode="parallel")`` in core (masks equal, ≤1e-6 m,
     quaternions ≤1e-8, NIS ≤1e-6 relative; K2 and no K1) and
     ``evaluate_vs_track_chunked`` (K3) against ``evaluate_vs_track``
     (≤1e-6 relative, aligned track ≤1e-6 m). Then ``python3 -m
     gps_optimize_slam_tpu_torch fuse ... --robust --gt ... --json`` and the
     same with ``--chunked`` as subprocesses on the seq-04 files. The walls
     of a gate pass (both gates) and of the robust chunked fusion are
     printed on lines of their own;
  7. batched fusion. The eleven KITTI odometry sequences with ground truth
     at their lengths (seq-04 the golden arrays, the others
     ``replica_sequence`` with distinct seeds; every GNSS track in a local
     frame), float64, ``bucket_by_length(max_waste=2.0)``: 3 buckets,
     each ``fuse_batch`` + ``evaluate_batch`` counted alone and held to one
     single-row fusion + evaluation's launches; every row within 1e-9 m of
     its single-row ``fuse_core`` on the card (same seed, so the same
     draws), masks equal, the evaluation within 1e-9 relative, seq-04
     within 1e-6 m of golden; warm walls of ``fuse_buckets`` and of the
     loop over the rows. The fleet bucket, 64 x 4661 float32: warm wall,
     sequences per second, idle share, peak memory, the row loop's wall.
     Then ``fuse-batch --json`` on two pairs as a subprocess;
  8. the pose-graph refinement, float64. A shuttle at KITTI seq-00's length
     (4,541 poses: seq-04's legs alternately forward and backward over one
     road, 2 cm of fresh GNSS noise a leg, GNSS dropped over one backward
     leg): ``fuse_arrays`` then ``refine_pose_graph`` (10 Gauss-Newton steps
     of 50 CG iterations, closures proposed within 5 m and 30 s apart, a
     checkpoint directory) on the card, held against the port's CPU run of
     the same arrays (positions ≤1e-6 m, quaternions ≤1e-8, cost history
     ≤1e-9 relative, the valid closures equal); a refinement stopped after 5
     steps and resumed equal to the uninterrupted one bit for bit; warm
     walls (median of 3), the refine's profile (kernels, launches, idle
     share), its peak memory and the proposal's share of its wall. Then
     ``refine-graph --json`` on the seq-04 files and ``kitti2tum`` on a
     KITTI pose file written from the golden arrays, as subprocesses;
  9. the multi-device paths on one card, the mesh's blocks sharing it:
     (a) ``fuse_ekf_rts_seqparallel`` on 4 blocks of phase 5's 1,048,576
     poses (float64, the EKF stage's inputs from one ``fuse_core``; every
     stage per block, K2 a block's scan, K1 the totals', for the filter's
     three scans and the controls' two), every run with each host
     synchronisation an error (``no_host_sync``), against
     ``fuse_ekf_rts_parallel`` on the
     card, both ``rts_mode``s, ≤1e-8 m and quaternions ≤1e-10, each
     device's peak memory beside the single-device filter's; (b) the same
     at 4,661 poses in float32 (padded to 4,664; K1 a block), ≤1e-2 m;
     (c) ``fuse_core_chunked(scan_fn=...)`` at 1,048,576 poses in
     524,287-pose chunks against the same without ``scan_fn``, ≤1e-8 m, the
     same scale; (f) its ``decimated_view()``, ≤5,000 poses, equal to the
     strided arrays; (d) ``fuse_batch(mesh=...)`` of phase 7's eleven KITTI
     rows as one batch on 3 shards against the unsharded batch, ≤1e-9 m,
     timed beside the unsharded batch and the shards issued one after
     another from one thread (``fuse_batch`` gives each distinct device a
     host thread; on one card both run in one thread); with two cards or
     more, (a) and (d) also run over the cards;
     (e) ``python3 -m gps_optimize_slam_tpu_torch.examples.distributed_launch``
     on the same rows, two gloo ranks sharing the card and then a one-rank
     NCCL group, the gathered rows ≤1e-9 m from (d). Each beside its
     single-device baseline (``utils.profiling.wallclock``), with the
     profiles of (a), (b) and (d) and the ranks' fusion and gather times;
 10. a bucket of long logs, float64: four rows of 524,288 / 458,752 /
     393,216 / 300,000 poses (``outage_sequence`` replicas, each with its
     own GNSS noise, a day apart), one bucket under
     ``bucket_by_length(max_waste=2.0)``: ``fuse_batch`` + ``evaluate_batch``
     (the scans and the NN calls on the kernels the routes pick), the
     evaluation again with K4 forced, bit for bit, and the fusion again
     with K2's batch grid forced; each row within 1e-9 m (or 64 ulps of
     its hundreds of kilometres) of its single-row ``fuse_core`` +
     ``evaluate``, each fusion's launches those of one row alone;
     ``fuse_buckets`` equal to the batch; warm walls of the bucket and of
     the row loop, idle share, peak memory; then ``fuse-batch --json`` as a
     subprocess on two logs of 70,000 poses.

The launch counts of the ``{"kernels": [...]}`` line are those of the
main-path runs (phase 4: ``fuse_arrays`` at 4,661 poses; phase 5:
``fuse_core_chunked`` + ``evaluate_chunked`` at 1,048,576 poses and
524,288-pose chunks; phase 6: ``fuse_arrays(robust=True, gt=...)`` under
each gate and the adaptive ``sim3_ransac`` at 4,661 poses,
``fuse_core_chunked(robust=True)`` and ``evaluate_vs_track_chunked`` at
1,048,576; phase 8: ``fuse_arrays`` + ``refine_pose_graph`` on the
shuttle; phase 9: the seqpar runs of (a) and (b) and the chunked fusion of
(c)), each with the counts set to 0 just before it and read just after;
``launches`` is their sum and ``launches_by_phase`` the five terms. The
``@batch`` entries' launches are phase 7's (the KITTI buckets' fusion and
evaluation, the fleet bucket's fusion), phase 9's mesh shards (d) and phase
10's bucket of long logs, where every launch has a batch grid. Phase 5's and
phase 10's counted runs include their evaluation with the NN calls forced
onto K4 (the route sends their shapes to K3), and phase 10's its fusion
with the scans forced onto K2 (the route sends four rows of 524,288 to
K1): K4's launches there and K2's batched ones are those.
The comparison launches of phase 1, phase 5's 262,144-pose evaluation and
its seq-04 run, phase 6's, phase 7's and phase 10's reference runs and
phase 9's single-device baselines do not count there.
"""

from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(REPO, "tests", "golden", "seq04_golden.npz")
META = os.path.join(REPO, "tests", "golden", "seq04_meta.json")
SEQ02_LEN = 4661  # KITTI odometry seq-02, the longest sequence

# Tolerances of phase 1, relative to (max |plain| + 1) per leaf or output:
# the kernels compute in the same dtype as the plain versions but associate
# differently (K1) or sum in another order, so they agree to a few ulps
# times the scan depth.
TOL = {"float32": 1e-4, "float64": 1e-10}

TILED_N = 262_145  # one default chunk (262,144 steps) plus its carried composite
CHUNKED_N = 1_048_576  # phase 5's poses
CHUNK = 524_288  # phase 5's chunk: its NN blocks (4,096 query tiles) take K3 by kernels.nn_route
# K2's lengths in phase 1: a default chunk plus its carry, a ragged one,
# phase 5's chunk plus its carry, one with fewer tiles than the card has
# persistent blocks (79 tiles of the float64 filter) and one with many more
# (4,097 of them).
TILED_LENGTHS = (TILED_N, TILED_N + 777, CHUNK + 1, 20_001, 1_048_577)
GRID_NN_SHAPE = (16_384, 300_000)  # K4's check and times below its route, a ragged last tile
GRID_NN_MAIN = (CHUNK, CHUNK)  # phase 5's NN block: queries x candidates
GRID_NN_WIN = (700, CHUNK)  # K4's winning shape (shuffled candidates: few query tiles, long keep lists)
PLAIN_STRIDE = 64  # phase 1 holds K4 at GRID_NN_MAIN against plain on every 64th query

# Published peaks of one H100 SXM (NVIDIA data sheet; float32 and float64
# outside the tensor cores), for the bounds. The card's power limit is
# printed beside them.
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "float64": 34e12}
# Floating-point operations of one combine, counted from csrc/scan_ops.cuh
# (a 3x3 product is 45, a matrix-vector product 15, the adjugate inverse 42).
COMBINE_FLOPS = {"quat_chain": 41, "filter": 489, "rts": 63, "mobius": 25, "affine3": 7,
                 "add2": 2, "max3": 3, "min3": 3}
NN_PAIR_FLOPS = 8  # 3 differences, 3 squares, 2 sums per (query, candidate)
# Float64 operations per (query segment, candidate segment) pair of the
# keep lists' bounds when every pair is taken (the plain version, and the
# kernel's first design): the upper bound and its running minimum (6
# differences, 3 maxima, 3 squares, 2 sums, 1 minimum) and the lower bound
# and its test (6 differences, 6 maxima, 3 squares, 2 sums, 1 comparison).
# Printed beside the kernel's bound; the kernel's exact tile-level test
# makes the pairs it takes a property of its design, so its bound is bytes.
KEEP_PAIR_FLOPS = 33
COUNT_FLOPS = 30  # s*R*p + t - d, squared and summed, compared, per (trial, point)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def say(text: str) -> None:
    """A line of its own for a reader, between the JSON lines."""
    print(text, flush=True)


def cuda_ms(fn, reps: int = 10) -> float:
    """Median CUDA-event time of ``fn`` over ``reps`` runs, after a warm-up."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(stop))
    return float(np.median(times))


def device_profile(fn, reps: int = 20) -> dict:
    """Device ms per call of each kernel, memset or copy ``fn`` runs on the
    card, by name, from a torch.profiler trace of ``reps`` calls after a
    warm-up."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):  # a trace now and then comes back without device events
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        times = {e.key[:60]: e.device_time_total / reps / 1e3 for e in prof.key_averages()
                 if e.device_time_total > 0}
        if times:
            break
    return times


def device_ms(fn, reps: int = 20) -> float:
    """Device time per call of everything ``fn`` runs on the card. Unlike
    ``cuda_ms`` it leaves out the host time between launches, so a call
    whose time is the wrapper's host work shows it."""
    return sum(device_profile(fn, reps).values())


def host_ms(fn, reps: int = 200) -> float:
    """Host time per call of ``fn`` (what it takes to enqueue its work),
    over ``reps`` calls with no synchronisation between them."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return 1e3 * (t1 - t0) / reps


def bound(bytes_moved: float, flops: float, dtype: str):
    """(bound_ms, bound_by): the larger of the bytes' time at the card's
    memory rate and the operations' time at its peak for ``dtype``."""
    t_bytes = bytes_moved / PEAK_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype]
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def dtype_name(dtype) -> str:
    return str(dtype).split(".")[1]


def scan_bound(op: str, x):
    """Each leaf read once and written once; n - 1 combines at least, a row
    of (L, B, n) leaves."""
    rows = x.numel() // x.shape[0] // x.shape[-1]
    return bound(2 * x.numel() * x.element_size(), COMBINE_FLOPS[op] * rows * (x.shape[-1] - 1),
                 dtype_name(x.dtype))


def scan_library_ms(op: str, x, reverse: bool):
    """One PyTorch call that computes the same scan, where there is one
    (``torch.cumsum``, ``torch.cummax``, ``torch.cummin`` along the last
    axis of the (L, n) or (L, B, n) leaves).
    A reverse scan is timed on a copy flipped beforehand: the flip is not
    the scan's work."""
    import torch

    fn = library_call(op, x, reverse)
    return None if fn is None else cuda_ms(fn)


def library_call(op: str, x, reverse: bool):
    """The call ``scan_library_ms`` times, or None."""
    import torch

    call = {"add2": torch.cumsum, "max3": torch.cummax, "min3": torch.cummin}.get(op)
    if call is None:
        return None
    y = x.flip(-1).contiguous() if reverse else x
    return lambda: call(y, dim=-1)


def nn_bound(traj, cand, mask):
    """The operands read once and the output written once; the distance
    work of the candidate tiles this run's data keeps."""
    from gps_optimize_slam_tpu_torch.ops import kernels

    _, nkept, _ = kernels.keep_lists(traj, cand, mask)
    pairs = int(nkept.sum()) * kernels.TILE_N * kernels.TILE_M
    size = traj.element_size()
    moved = (traj.numel() + cand.numel() + traj[..., 0].numel()) * size + mask.numel()
    return bound(moved, NN_PAIR_FLOPS * pairs, dtype_name(traj.dtype))


def fits_on_card(nbytes: float) -> bool:
    """Whether a library yardstick's intermediates of ``nbytes`` fit in half
    of the card's free memory (read after the allocator's cache is
    released; the other half leaves room for the call's own temporaries)."""
    import torch

    torch.cuda.empty_cache()
    return nbytes <= 0.5 * torch.cuda.mem_get_info()[0]


CDIST_PAIRS_DIFF_MAX = 2**31 - 1  # torch.cdist's difference form launches one block a pair


def cdist_library_ms(traj, cand, mask, reps: int = 5):
    """The reference pipeline's own method for the NN distance, as K3's and
    K4's library yardstick: ``torch.cdist`` then ``min`` (two calls, the n x
    m matrix between them in device memory; distances, not their squares),
    without the matrix-product expansion up to ``CDIST_PAIRS_DIFF_MAX``
    pairs and with it beyond, where the difference form's grid cannot
    launch. Timed only: the port never calls it. None where the matrix does
    not fit (``fits_on_card``)."""
    import torch

    kept = cand[mask]
    pairs = traj.shape[0] * kept.shape[0]
    if not fits_on_card(pairs * traj.element_size()):
        return None
    mode = "donot_use_mm_for_euclid_dist" if pairs <= CDIST_PAIRS_DIFF_MAX else "use_mm_for_euclid_dist"
    ms = cuda_ms(lambda: torch.cdist(traj, kept, compute_mode=mode).min(1), reps)
    torch.cuda.empty_cache()
    return ms


def keep_bound(traj, cand, mask, nkept, cand4):
    """The coordinates and the mask read once; the packed candidates, the
    kept entries of the lists and their counts written once."""
    moved = (traj.numel() + cand.numel() + cand4.numel()) * traj.element_size() + mask.numel() + 4 * (
        int(nkept.sum()) + nkept.numel())
    return bound(moved, 0.0, "float64")


def keep_all_pairs_ms(traj, cand) -> float:
    """The time of both bounds over every segment pair at the float64 peak:
    the operations bound of the kernel's first design."""
    from gps_optimize_slam_tpu_torch.ops import kernels

    n_sub = -(-traj.shape[0] // kernels.TILE_N) * kernels.TILE_N // kernels.SUB
    m_sub = -(-cand.shape[0] // kernels.TILE_M) * kernels.TILE_M // kernels.SUB
    return 1e3 * KEEP_PAIR_FLOPS * n_sub * m_sub / PEAK_FLOPS["float64"]


def build_registers(log: str) -> dict:
    """{kernel: [registers, bytes of spill stores]} from nvcc's ``-Xptxas -v``
    output, for the keep-list kernels, the 12- and 27-leaf scans (the
    kernels whose registers decide how many blocks share an SM) and K3, K4
    and K5; empty when an up-to-date library was found and nothing was
    compiled."""
    import re

    wanted = re.compile(r"(keep_lists_kernelILi\d+|segment_boxes_kernelI[fd]"
                        r"|(?:tiled|lookback)_scan_kernelINS_\d+(?:Filter|RtsSuffix)I[fd]"
                        r"|nn_kernelI[fd]Li\d+ELi\d+|nn_grid_kernelI[fd]|count_kernelI[fd])")
    out, name = {}, None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            m = wanted.search(line)
            name = m.group(1) if m else None
        elif name and (m := re.search(r"(\d+) bytes spill stores", line)):
            out[name] = [None, int(m.group(1))]
        elif name and (m := re.search(r"Used (\d+) registers", line)):
            out.setdefault(name, [None, 0])[0] = int(m.group(1))
    return out


def launch_counts() -> dict:
    """Every kernel wrapper's launch count, by entry name."""
    from gps_optimize_slam_tpu_torch.ops import kernels, scan

    counts = {f"scan_block/{op}": c for op, c in scan.scan_block.launches.items()}
    counts.update({f"scan_tiled/{op}": c for op, c in scan.scan_tiled.launches.items()})
    counts.update(nn_keep=kernels.keep_lists.launches, nn_resident=kernels.nn_resident.launches,
                  nn_grid=kernels.nn_grid.launches, ransac_counts=kernels.ransac_counts.launches)
    return counts


def reset_launch_counts() -> None:
    from gps_optimize_slam_tpu_torch.ops import kernels, scan

    for op in scan.OPS:
        scan.scan_block.launches[op] = 0
        scan.scan_tiled.launches[op] = 0
    kernels.keep_lists.launches = 0
    kernels.nn_resident.launches = 0
    kernels.nn_grid.launches = 0
    kernels.ransac_counts.launches = 0


def walk(gen, n: int, dtype, device, scale: float = 0.8):
    """A random-walk trajectory (spatially coherent, like the main path's)."""
    import torch

    steps = scale * torch.randn(n, 3, generator=gen, dtype=torch.float64)
    return torch.cumsum(steps, 0).to(dtype=dtype, device=device)


def rel_err(a, b) -> float:
    """max |a − b| / (max |b| + 1), per leading row, maximised; 0 for equal
    infinities."""
    import torch

    a, b = a.double().reshape(a.shape[0], -1), b.double().reshape(b.shape[0], -1)
    same = (a == b) | (torch.isnan(a) & torch.isnan(b))
    d = torch.where(same, torch.zeros_like(a), (a - b).abs())
    scale = torch.where(torch.isfinite(b), b.abs(), torch.zeros_like(b)).amax(1, keepdim=True) + 1.0
    return float((d / scale).max())


def abs_err(a, b) -> float:
    import torch

    a, b = a.double(), b.double()
    same = (a == b) | (torch.isnan(a) & torch.isnan(b))
    return float(torch.where(same, torch.zeros_like(a), (a - b).abs()).max())


def scan_inputs(op: str, n: int, gen, dtype, device):
    """Leaves shaped like the main path's for each K1 combine."""
    import torch

    from gps_optimize_slam_tpu_torch.ops.kalman_parallel import filter_elements

    f64 = torch.float64

    def randn(*shape):
        return torch.randn(*shape, generator=gen, dtype=f64)

    if op == "quat_chain":
        q = torch.cat([0.02 * randn(n, 3), torch.ones(n, 1, dtype=f64)], 1)
        x = (q / q.norm(dim=1, keepdim=True)).T
    elif op == "filter":
        d = 0.8 * randn(n - 1, 3)
        dt = 0.1 + 0.01 * torch.rand(n - 1, generator=gen, dtype=f64)
        qd = torch.tensor([0.1, 0.1, 0.7], dtype=f64)[None] * dt[:, None]
        z = torch.cumsum(d, 0) + 0.2 * randn(n - 1, 3)
        avail = torch.rand(n - 1, generator=gen) > 0.1
        x = filter_elements(
            torch.zeros(3, dtype=f64), 0.1 * torch.eye(3, dtype=f64), d, qd,
            torch.full((3,), 0.2, dtype=f64), z, avail,
        )
    elif op == "rts":
        e = torch.zeros(9, n, dtype=f64)
        for i in (0, 4, 8):
            e[i] = 0.5 + 0.3 * torch.rand(n, generator=gen, dtype=f64)
        e[:, torch.rand(n, generator=gen) > 0.7] = 0.0  # segment resets
        x = torch.cat([e, 10.0 * randn(3, n)])
    elif op == "mobius":
        h = 0.1 + 0.01 * torch.rand(n, generator=gen, dtype=f64)
        x = torch.stack([2 * h / 3, -(h / 6) ** 2, torch.ones(n, dtype=f64), torch.zeros(n, dtype=f64)])
    elif op == "affine3":
        x = torch.cat([-0.25 + 0.01 * randn(1, n), randn(3, n)])
    elif op == "add2":
        x = (torch.rand(2, n, generator=gen) > 0.5).to(f64)
    else:  # max3 / min3: segment-marked indices, times and counts
        marked = torch.rand(n, generator=gen) > 0.9
        fill = -float("inf") if op == "max3" else float("inf")
        idx = torch.arange(n, dtype=f64)
        x = torch.stack([torch.where(marked, idx, fill), torch.where(marked, 0.1 * idx, fill),
                         torch.where(marked, torch.floor(idx / 50), fill)])
    return x.to(dtype=dtype, device=device).contiguous()


def kernel_entry(name, source, replaces, dtype, err, ms, plain_ms, bound_ms_by, library_ms=None,
                 dev_ms=None):
    """One entry of the ``{"kernels": [...]}`` line; ``device_ms`` is the
    call's device time alone (``device_ms``), where it was taken."""
    return {"name": name, "route": "cuda", "source": f"gps_optimize_slam_tpu_torch/csrc/{source}",
            "replaces": f"gps_optimize_slam_tpu/ops/{replaces}", "dtype": dtype,
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms_by[0],
            "bound_by": bound_ms_by[1], "library_ms": library_ms, "device_ms": dev_ms}


# The directions the main paths scan each combine in.
REVERSE_OF = {"rts": True, "min3": True}


def directions(op: str):
    return sorted({REVERSE_OF.get(op, False), op == "affine3"})


def phase1_block_scan(device, gen):
    """K1: all eight combines at the in-core path's sizes."""
    import torch

    from gps_optimize_slam_tpu_torch.ops import scan

    entries = []
    for op in scan.OPS:
        worst = {}
        for dtype in (torch.float32, torch.float64):
            for n in (271, SEQ02_LEN):
                x = scan_inputs(op, n, gen, dtype, device)
                for rev in directions(op):
                    got = scan.scan_block(op, x, rev)
                    torch.cuda.synchronize()
                    want = scan.scan_plain(op, x, rev)
                    err = rel_err(got, want)
                    name = dtype_name(dtype)
                    if not err <= TOL[name]:
                        raise AssertionError(f"scan {op} {name} n={n} rev={rev}: rel err {err:.3e}")
                    worst[name] = max(worst.get(name, 0.0), err)
                    if n == SEQ02_LEN and dtype == torch.float32 and rev == REVERSE_OF.get(op, False):
                        timed = (x, rev, abs_err(got, want))
        x, rev, aerr = timed
        ms = cuda_ms(lambda: scan.scan_block(op, x, rev))
        plain_ms = cuda_ms(lambda: scan.scan_plain(op, x, rev))
        lib_ms = scan_library_ms(op, x, rev)
        dev = device_ms(lambda: scan.scan_block(op, x, rev))
        lib = library_call(op, x, rev)
        emit({"phase": 1, "kernel": f"scan_block/{op}", "rel_err": worst, "ms": ms,
              "plain_ms": plain_ms, "library_ms": lib_ms, "device_ms": dev,
              "host_ms": host_ms(lambda: scan.scan_block(op, x, rev)),
              "library_device_ms": None if lib is None else device_ms(lib),
              "library_host_ms": None if lib is None else host_ms(lib),
              "shape": list(x.shape), "dtype": "float32"})
        entries.append(kernel_entry(f"scan_block/{op}", "scan.cu", "pallas_scan.py:227", "float32",
                                    aerr, ms, plain_ms, scan_bound(op, x), lib_ms, dev))
    return entries


def phase1_tiled_scan(device, gen):
    """K2: all eight combines at ``TILED_LENGTHS`` (a default chunk plus
    its carry, a ragged length, phase 5's chunk plus its carry, fewer tiles
    than persistent blocks, many more), against the plain version and
    against K1 on the same input; times at 262,145 in float32 and float64
    beside K1's and the library call's."""
    import torch

    from gps_optimize_slam_tpu_torch.ops import scan

    entries = []
    for op in scan.OPS:
        worst, times = {}, {}
        for dtype in (torch.float32, torch.float64):
            name = dtype_name(dtype)
            for n in TILED_LENGTHS:
                x = scan_inputs(op, n, gen, dtype, device)
                if n >= TILED_N and scan.scan_route(x.shape[0], n, x.element_size()) != "tiled":
                    raise AssertionError(f"scan {op} {name} n={n} routes to K1")
                for rev in directions(op):
                    got = scan.scan_tiled(op, x, rev)
                    k1 = scan.scan_block(op, x, rev)
                    torch.cuda.synchronize()
                    want = scan.scan_plain(op, x, rev)
                    err, err_k1 = rel_err(got, want), rel_err(got, k1)
                    if not (err <= TOL[name] and err_k1 <= TOL[name]):
                        raise AssertionError(f"tiled scan {op} {name} n={n} rev={rev}: rel err "
                                             f"{err:.3e} (plain), {err_k1:.3e} (K1)")
                    worst[name] = max(worst.get(name, 0.0), err, err_k1)
                    if n == TILED_N and rev == REVERSE_OF.get(op, False):
                        timed = (x, rev, abs_err(got, want))
            x, rev, aerr = timed
            times[name] = {
                "ms": cuda_ms(lambda: scan.scan_tiled(op, x, rev)),
                "device_ms": device_ms(lambda: scan.scan_tiled(op, x, rev)),
                "plain_ms": cuda_ms(lambda: scan.scan_plain(op, x, rev), reps=3),
                "k1_ms": cuda_ms(lambda: scan.scan_block(op, x, rev), reps=3),
                "library_ms": scan_library_ms(op, x, rev),
                "bound": scan_bound(op, x), "max_abs_err": aerr,
            }
        emit({"phase": 1, "kernel": f"scan_tiled/{op}", "rel_err": worst, "n": TILED_N,
              "lengths": list(TILED_LENGTHS),
              "tile": {dtype_name(d): scan.tiled_tile(op, d) for d in (torch.float32, torch.float64)},
              "times": times})
        t = times["float64"]  # the chunked path runs in float64 (phase 5)
        entries.append(kernel_entry(f"scan_tiled/{op}", "scan_tiled.cu", "pallas_scan.py:361", "float64",
                                    t["max_abs_err"], t["ms"], t["plain_ms"], t["bound"], t["library_ms"],
                                    t["device_ms"]))
    return entries


# K3's checks: (queries, candidates, coordinate offset). Seq-02's length
# (a ragged last block of 5 queries), one candidate tile, fewer queries than
# one block takes, a ragged last block past a whole query tile, UTM
# magnitudes, and 16,384 x 262,144 (the larger block size's grid is taken
# from 257 query tiles on: GRID_NN_MAIN, below).
RESIDENT_CASES = ((SEQ02_LEN, SEQ02_LEN, 0.0), (300, 777, 0.0), (5, 1, 0.0), (1000 + 131, 3000, 0.0),
                  (SEQ02_LEN, SEQ02_LEN, 5.4e6), (16_384, 262_144, 0.0))


def phase1_nn(device, gen):
    """K3 at ``RESIDENT_CASES`` against the plain version and bit for bit
    against K4, times at the in-core path's size beside the library
    yardstick; K4 at 16,384 x 300,000 and at phase 5's NN block, bit for
    bit against K3 on the same inputs."""
    import torch

    from gps_optimize_slam_tpu_torch.ops import kernels

    nn_err, timed = {}, None
    for dtype in (torch.float32, torch.float64):
        name = dtype_name(dtype)
        for n, m, offset in RESIDENT_CASES:
            if offset and dtype == torch.float32:
                continue  # float32 cannot hold UTM coordinates to better than 0.5 m
            traj = (walk(gen, n, torch.float64, device) + offset).to(dtype)
            cand = (walk(gen, m, torch.float64, device) + (offset + 0.3)).to(dtype)
            mask = (torch.rand(m, generator=gen) > 0.1).to(device)
            got = kernels.nn_resident(traj, cand, mask)
            k4 = kernels.nn_grid(traj, cand, mask)
            torch.cuda.synchronize()
            want = kernels.nn_min_dist2_plain(traj, cand, mask, block=128 if m > 65_536 else 512)
            err = rel_err(got[None], want[None])
            if not err <= TOL[name]:
                raise AssertionError(f"nn {name} {n}x{m}: rel err {err:.3e}")
            if not torch.equal(got, k4):
                raise AssertionError(f"nn {name} {n}x{m}: K3 differs from K4 in {int((got != k4).sum())} queries")
            nn_err[name] = max(nn_err.get(name, 0.0), err)
            if (n, m, offset) == RESIDENT_CASES[0] and dtype == torch.float32:
                timed = (traj, cand, mask, abs_err(got, want))
            none = kernels.nn_resident(traj, cand, torch.zeros_like(mask))
            torch.cuda.synchronize()
            if none.shape != (n,) or not bool(torch.isinf(none).all()):
                raise AssertionError("nn: all-masked candidates must give +inf")
            del want, k4, none
    traj, cand, mask, aerr = timed
    ms = cuda_ms(lambda: kernels.nn_resident(traj, cand, mask))
    plain_ms = cuda_ms(lambda: kernels.nn_min_dist2_plain(traj, cand, mask))
    library_ms = cdist_library_ms(traj, cand, mask, reps=10)
    by_kernel = device_profile(lambda: kernels.nn_resident(traj, cand, mask))
    dev = sum(by_kernel.values())
    n_tiles, m_tiles = kernels._tiles(*RESIDENT_CASES[0][:2])
    emit({"phase": 1, "kernel": "nn_resident", "rel_err": nn_err, "equal_to_k4": True, "ms": ms,
          "plain_ms": plain_ms, "library_ms": library_ms,
          "device_ms": dev, "device_ms_by_kernel": by_kernel,
          "host_ms": host_ms(lambda: kernels.nn_resident(traj, cand, mask)),
          "kept_tile_pairs": int(kernels.keep_lists(traj, cand, mask)[1].sum()), "tile_pairs": n_tiles * m_tiles,
          "cases": [list(c) for c in RESIDENT_CASES], "shape": [SEQ02_LEN, SEQ02_LEN], "dtype": "float32"})
    entries = [kernel_entry("nn_resident", "nn.cu", "pallas_kernels.py:283", "float32", aerr, ms,
                            plain_ms, nn_bound(traj, cand, mask), library_ms, dev)]

    def check_grid(shape, stride, shuffled=False):
        """K4 at ``shape`` in both dtypes: bit for bit against K3, within
        TOL of the plain version on every ``stride``-th query (the plain
        minimum of a query does not depend on the others), +inf when every
        candidate is masked; ``shuffled`` candidates keep every tile.
        Returns per dtype the operands, K4's output, the plain one on the
        sampled queries and the relative error."""
        n, m = shape
        out = {}
        for dtype in (torch.float32, torch.float64):
            name = dtype_name(dtype)
            traj, cand = walk(gen, n, dtype, device), walk(gen, m, dtype, device) + 0.3
            if shuffled:
                cand = cand[torch.randperm(m, generator=gen).to(device)].contiguous()
            mask = (torch.rand(m, generator=gen) > 0.1).to(device)
            got = kernels.nn_grid(traj, cand, mask)
            k3 = kernels.nn_resident(traj, cand, mask)
            torch.cuda.synchronize()
            want = kernels.nn_min_dist2_plain(traj[::stride].contiguous(), cand, mask, block=128)
            err = rel_err(got[::stride][None], want[None])
            if not err <= TOL[name]:
                raise AssertionError(f"nn grid {name} {n}x{m}: rel err {err:.3e}")
            if not torch.equal(got, k3):
                raise AssertionError(f"nn grid {name} {n}x{m}: differs from K3 in "
                                     f"{int((got != k3).sum())} queries")
            none = kernels.nn_grid(traj, cand, torch.zeros_like(mask))
            torch.cuda.synchronize()
            if not bool(torch.isinf(none).all()):
                raise AssertionError("nn grid: all-masked candidates must give +inf")
            out[name] = (traj, cand, mask, got, want, err)
            del k3, none
        return out

    n, m = GRID_NN_SHAPE
    grid_err, times = {}, {}
    for name, (traj, cand, mask, got, want, err) in check_grid(GRID_NN_SHAPE, 1).items():
        grid_err[name] = err
        times[name] = {
            "ms": cuda_ms(lambda: kernels.nn_grid(traj, cand, mask)),
            "device_ms": device_ms(lambda: kernels.nn_grid(traj, cand, mask)),
            "plain_ms": cuda_ms(lambda: kernels.nn_min_dist2_plain(traj, cand, mask), reps=3),
            "k3_ms": cuda_ms(lambda: kernels.nn_resident(traj, cand, mask), reps=3),
            "bound": nn_bound(traj, cand, mask), "max_abs_err": abs_err(got, want),
            "library_ms": cdist_library_ms(traj, cand, mask),
        }
    emit({"phase": 1, "kernel": "nn_grid", "rel_err": grid_err, "equal_to_k3": True,
          "shape": [n, m], "times": times})
    t = times["float64"]
    entries.append(kernel_entry("nn_grid", "nn_grid.cu", "pallas_kernels.py:302", "float64",
                                t["max_abs_err"], t["ms"], t["plain_ms"], t["bound"], t["library_ms"],
                                t["device_ms"]))

    if (kernels.nn_route(GRID_NN_MAIN[1], GRID_NN_MAIN[0]) != "resident"
            or kernels.nn_route(SEQ02_LEN, SEQ02_LEN) != "resident"
            or kernels.nn_route(GRID_NN_WIN[1], GRID_NN_WIN[0]) != "grid"):
        raise AssertionError("the routing rule must send phase 5's NN blocks and phase 4's calls to K3, and a few "
                             "query tiles against 524,288 candidates to K4")
    win = {}
    for name, (traj, cand, mask, got, want, err) in check_grid(GRID_NN_WIN, 1, shuffled=True).items():
        win[name] = {"rel_err": err, "ms": cuda_ms(lambda: kernels.nn_grid(traj, cand, mask)),
                     "device_ms": device_ms(lambda: kernels.nn_grid(traj, cand, mask)),
                     "k3_ms": cuda_ms(lambda: kernels.nn_resident(traj, cand, mask)),
                     "k3_device_ms": device_ms(lambda: kernels.nn_resident(traj, cand, mask)),
                     "kept_tile_pairs": int(kernels.keep_lists(traj, cand, mask)[1].sum()),
                     "route": kernels.nn_route(cand.shape[0], traj.shape[0]), "bound": nn_bound(traj, cand, mask)}
    emit({"phase": 1, "kernel": "nn_grid", "shape": list(GRID_NN_WIN), "shuffled": True, "equal_to_k3": True,
          "checks": win})
    main = {}
    for name, (traj, cand, mask, got, want, err) in check_grid(GRID_NN_MAIN, PLAIN_STRIDE).items():
        operands = kernels.nn_grid_operands(traj, cand, mask)
        n_items = int(operands[3][-1])
        main[name] = {"rel_err": err, "ms": cuda_ms(lambda: kernels.nn_grid(traj, cand, mask), reps=5),
                      "device_ms": device_ms(lambda: kernels.nn_grid(traj, cand, mask), reps=5),
                      "kernel_ms": cuda_ms(lambda: kernels.grid_launch(traj, operands, n_items), reps=5),
                      "k3_ms": cuda_ms(lambda: kernels.nn_resident(traj, cand, mask), reps=5),
                      "blocks": n_items, "kept_tile_pairs": int(operands[1].sum()),
                      "bound": nn_bound(traj, cand, mask)}
        del operands
    emit({"phase": 1, "kernel": "nn_grid", "shape": list(GRID_NN_MAIN), "plain_queries_every": PLAIN_STRIDE,
          "equal_to_k3": True, "checks": main})
    torch.cuda.empty_cache()
    return entries


def plain_keep_lists(traj, cand, mask):
    """(order, nkept, cand4) of the keep-list kernel's plain version, with
    the inputs' batch axis if they have one."""
    from gps_optimize_slam_tpu_torch.ops import kernels

    order, nkept = kernels.keep_lists_plain(kernels.tile_keep_mask(*kernels.bounds_operands(traj, cand, mask)))
    return order, nkept, kernels.pack_candidates_plain(cand, mask, order.shape[-1])


def phase1_keep(device, gen):
    """The keep-list kernel: its lists equal the plain mask's compaction
    (the same float64 bounds in the same order; the kernel's tile-level
    test is exact) and its packed candidates the plain packing, float32 and
    float64 coordinates: at seq-02's length (37 query tiles, one a block),
    with one candidate tile, at UTM magnitudes, with whole tiles and runs of
    segments masked out, and at phase 5's NN block (4,096 query tiles, four
    a block); each also with every candidate masked (every tile kept, as in
    the JAX mask). Times at 524,288 x 524,288 in float64 (phase 5's shape):
    the call, its device time by kernel, and the bytes bound beside the
    operations bound of taking every segment pair."""
    import torch

    from gps_optimize_slam_tpu_torch.ops import kernels

    def check(traj, cand, mask, what):
        order, nkept, cand4 = kernels.keep_lists(traj, cand, mask)
        want_order, want_nkept, want_cand4 = plain_keep_lists(traj, cand, mask)
        if not torch.equal(nkept, want_nkept):
            raise AssertionError(f"keep lists {what}: counts differ in "
                                 f"{int((nkept != want_nkept).sum())} query tiles")
        cols = torch.arange(order.shape[1], device=device)[None] < nkept[:, None]
        if not torch.equal(torch.where(cols, order, -1), torch.where(cols, want_order, -1)):
            raise AssertionError(f"keep lists {what}: the lists differ")
        if not torch.equal(cand4, want_cand4):
            raise AssertionError(f"keep lists {what}: the packed candidates differ")
        return nkept, want_nkept, order.numel(), cand4

    # (queries, candidates, coordinate offset, part-masked)
    cases = ((SEQ02_LEN, SEQ02_LEN, 0.0, False), (SEQ02_LEN, 777, 0.0, False),
             (SEQ02_LEN, SEQ02_LEN, 5.4e6, False), (SEQ02_LEN, 9000, 0.0, True),
             GRID_NN_MAIN + (0.0, False))
    checks = {}
    for n, m, offset, part in cases:
        for dtype in (torch.float32, torch.float64):
            traj = walk(gen, n, torch.float64, device) + offset
            cand = walk(gen, m, torch.float64, device) + (offset + 0.3)
            traj, cand = traj.to(dtype), cand.to(dtype)
            mask = (torch.rand(m, generator=gen) > 0.1).to(device)
            if part:  # a whole tile, a run of segments, and a tile with one fix left
                mask[:1024] = False
                mask[3000:3100] = False
                mask[8192:] = False
                mask[8500] = True
            what = f"{n}x{m}/{dtype_name(dtype)}" + ("/utm" if offset else "") + ("/part-masked" if part else "")
            nkept, want_nkept, pairs, cand4 = check(traj, cand, mask, what)
            # Every candidate masked: no finite upper bound, every tile kept
            # (as in the JAX mask); K3 and K4 then give +inf.
            check(traj, cand, torch.zeros_like(mask), what + "/all-masked")
            checks[what] = {"kept_tile_pairs": int(nkept.sum()), "tile_pairs": pairs}
    ms = cuda_ms(lambda: kernels.keep_lists(traj, cand, mask))
    plain_ms = cuda_ms(lambda: plain_keep_lists(traj, cand, mask), reps=3)
    by_kernel = device_profile(lambda: kernels.keep_lists(traj, cand, mask), reps=5)
    dev = sum(by_kernel.values())
    aerr = float((nkept - want_nkept).abs().max())
    bound_ms_by = keep_bound(traj, cand, mask, nkept, cand4)
    emit({"phase": 1, "kernel": "nn_keep", "equal_to_plain": True, "checks": checks, "ms": ms,
          "plain_ms": plain_ms, "device_ms": dev, "device_ms_by_kernel": by_kernel,
          "bound_ms": bound_ms_by[0], "all_segment_pairs_bound_ms": keep_all_pairs_ms(traj, cand),
          "shape": list(GRID_NN_MAIN), "dtype": "float64"})
    entry = kernel_entry("nn_keep", "nn_keep.cu", "pallas_kernels.py:174", "float64", aerr, ms, plain_ms,
                         bound_ms_by, None, dev)
    del cand4
    torch.cuda.empty_cache()
    return [entry]


# K1 against K2, besides the last length within the JAX package's budget
ROUTE_LENGTHS = (271, 1024, 2048, SEQ02_LEN, 16_385, 65_537, 131_073, TILED_N, CHUNK + 1)
# K3 against K4: candidate counts at 16,384 queries on random walks, and
# (queries, candidates) with the candidates shuffled, so that every tile is
# kept and a few query tiles each hold a long keep list
ROUTE_CANDIDATES = (SEQ02_LEN, 65_536, 262_144, CHUNK, 1_048_576)
ROUTE_LONG_LISTS = ((700, 65_536), (700, CHUNK), (SEQ02_LEN, CHUNK), (8_192, CHUNK), (16_384, CHUNK))
# K1's batch grid against K2's (float64, every combine): rows x elements a row.
ROUTE_BATCHES = tuple((b, n) for b in (2, 4, 8, 16, 64) for n in (16_385, 65_537, 131_073, CHUNK + 1)
                      if b * n <= 64 * 65_537)


def phase1_routes(device, gen):
    """The times that place the routing thresholds on this card, each pair
    on the same inputs: K1 against K2 (both held against the plain version)
    for every combine in both dtypes at ``ROUTE_LENGTHS`` and at the last
    length within the JAX package's 4 MiB budget, with the library call
    where there is one (``scan.scan_route`` is set from these times); K3
    against K4, bit for bit equal, at 16,384 queries and
    ``ROUTE_CANDIDATES`` candidates on random walks and at
    ``ROUTE_LONG_LISTS`` with shuffled candidates, each call with its
    device time and, where its matrix fits, the library yardstick
    (``kernels.nn_route`` is set from these times and phase 5's block in
    ``phase1_nn``)."""
    import torch

    from gps_optimize_slam_tpu_torch.ops import kernels, scan

    scans = {}
    for op in scan.OPS:
        for dtype in (torch.float32, torch.float64):
            name = dtype_name(dtype)
            x = scan_inputs(op, 8, gen, dtype, device)
            L, size = x.shape[0], x.element_size()
            last = 4 * 1024 * 1024 // (2 * L * size) // 128 * 128
            rev = REVERSE_OF.get(op, False)
            for n in sorted(ROUTE_LENGTHS + (last,)):
                x = scan_inputs(op, n, gen, dtype, device)
                want = scan.scan_plain(op, x, rev)
                err = max(rel_err(scan.scan_block(op, x, rev), want), rel_err(scan.scan_tiled(op, x, rev), want))
                if not err <= TOL[name]:
                    raise AssertionError(f"scan {op} {name} n={n} rev={rev}: K1 or K2 rel err {err:.3e}")
                scans[f"{op}/{name}/{n}"] = {
                    "k1_ms": cuda_ms(lambda: scan.scan_block(op, x, rev), reps=5),
                    "k2_ms": cuda_ms(lambda: scan.scan_tiled(op, x, rev), reps=5),
                    "library_ms": scan_library_ms(op, x, rev), "rel_err": err,
                    "route": scan.scan_route(L, n, size)}
    emit({"phase": 1, "routes": "scan", "times": scans})

    batches = {}
    for op in scan.OPS:
        rev = REVERSE_OF.get(op, False)
        for b, n in ROUTE_BATCHES:
            x = torch.stack([scan_inputs(op, n, gen, torch.float64, device) for _ in range(b)], 1).contiguous()
            k1, k2 = scan.scan_block(op, x, rev), scan.scan_tiled(op, x, rev)
            err = rel_err(k1.flatten(1), k2.flatten(1))
            if not err <= TOL["float64"]:
                raise AssertionError(f"batched scan {op} {b}x{n}: K1 and K2 differ by {err:.3e}")
            batches[f"{op}/float64/{b}x{n}"] = {
                "k1_ms": cuda_ms(lambda: scan.scan_block(op, x, rev), reps=5),
                "k2_ms": cuda_ms(lambda: scan.scan_tiled(op, x, rev), reps=5),
                "route": scan.scan_route(x.shape[0], n, x.element_size(), b)}
            del x, k1, k2
        torch.cuda.empty_cache()
    emit({"phase": 1, "routes": "scan@batch", "times": batches})

    edge = kernels.GRID_MIN_CANDIDATES
    if [kernels.nn_route(m, 700) for m in (1, SEQ02_LEN, edge - 1, edge, CHUNK, 2 * CHUNK)] != 3 * ["resident"] + 3 * ["grid"]:
        raise AssertionError(f"K3 must take fewer than {edge} candidates and K4 the rest at 700 queries")
    nns = {}
    cases = [(GRID_NN_SHAPE[0], m, False) for m in ROUTE_CANDIDATES] + [(n, m, True) for n, m in ROUTE_LONG_LISTS]
    for n, m, shuffled in cases:
        for dtype in (torch.float32, torch.float64):
            traj, cand = walk(gen, n, dtype, device), walk(gen, m, dtype, device) + 0.3
            if shuffled:
                cand = cand[torch.randperm(m, generator=gen).to(device)].contiguous()
            mask = (torch.rand(m, generator=gen) > 0.1).to(device)
            k3, k4 = kernels.nn_resident(traj, cand, mask), kernels.nn_grid(traj, cand, mask)
            if not torch.equal(k3, k4):
                raise AssertionError(f"nn {n}x{m} {dtype}: K4 differs from K3")
            del k3, k4
            key = f"{n}x{m}/{dtype_name(dtype)}" + ("/shuffled" if shuffled else "")
            nns[key] = {"k3_ms": cuda_ms(lambda: kernels.nn_resident(traj, cand, mask)),
                        "k4_ms": cuda_ms(lambda: kernels.nn_grid(traj, cand, mask)),
                        "k3_device_ms": device_ms(lambda: kernels.nn_resident(traj, cand, mask), reps=5),
                        "k4_device_ms": device_ms(lambda: kernels.nn_grid(traj, cand, mask), reps=5),
                        "kept_tile_pairs": int(kernels.keep_lists(traj, cand, mask)[1].sum()),
                        "library_ms": cdist_library_ms(traj, cand, mask),
                        "route": kernels.nn_route(m, n)}
    emit({"phase": 1, "routes": "nn", "times": nns})
    torch.cuda.empty_cache()


# K5's checks: (points, trials, every point invalid). The main path's size,
# seq-04's 279 fixes, ragged point and trial chunks, and no valid point.
COUNT_CASES = ((SEQ02_LEN, 1000, False), (279, 1000, False), (5003, 333, False), (SEQ02_LEN, 1000, True))


def phase1_counts(device, gen):
    """K5: four-point Umeyama trials on a noisy Sim(3) pair at
    ``COUNT_CASES``; the counts equal the plain version's (the same
    elementwise order, uncontracted), twice over, and the re-ranked winner
    with them."""
    import torch

    from gps_optimize_slam_tpu_torch.ops import kernels
    from gps_optimize_slam_tpu_torch.ops.ransac import select_winner
    from gps_optimize_slam_tpu_torch.ops.umeyama import umeyama_sim3

    timed, worst = None, 0
    for dtype in (torch.float32, torch.float64):
        for n, trials, none_valid in COUNT_CASES:
            src = walk(gen, n, torch.float64, device, scale=2.0)
            dst = 0.987 * src + torch.tensor([3.0, -2.0, 1.0], dtype=torch.float64, device=device)
            dst = dst + 2.0 * torch.randn(n, 3, generator=gen, dtype=torch.float64).to(device)
            src, dst = src.to(dtype), dst.to(dtype)
            valid = (torch.rand(n, generator=gen) > (1.0 if none_valid else 0.05)).to(device)
            draws = torch.randint(0, n, (trials, 4), generator=gen).to(device)
            fits = umeyama_sim3(src[draws], dst[draws])
            args = (src, dst, valid, fits.R.contiguous(), fits.t.contiguous(), fits.scale.contiguous(), 16.0)
            got, again = kernels.ransac_counts(*args), kernels.ransac_counts(*args)
            torch.cuda.synchronize()
            want = kernels.ransac_counts_plain(*args)
            diff = int((got - want).abs().max())
            what = f"ransac_counts {dtype} {trials}x{n}" + (" (no valid point)" if none_valid else "")
            if diff != 0 or got.dtype != torch.int32:
                raise AssertionError(f"{what}: counts differ from the plain version's by {diff}")
            if not torch.equal(got, again):
                raise AssertionError(f"{what}: two runs on the same inputs differ")
            if none_valid != (int(got.max()) == 0):
                raise AssertionError(f"{what}: largest count {int(got.max())}")
            w_k = int(select_winner(src, dst, valid, fits, got, 16.0))
            w_p = int(select_winner(src, dst, valid, fits, want, 16.0))
            if w_k != w_p:
                raise AssertionError(f"{what}: winner {w_k} != {w_p}")
            worst = max(worst, diff)
            if dtype == torch.float32 and (n, trials, none_valid) == COUNT_CASES[0]:
                timed = (args, diff)
    args, diff32 = timed
    ms = cuda_ms(lambda: kernels.ransac_counts(*args))
    plain_ms = cuda_ms(lambda: kernels.ransac_counts_plain(*args))
    by_kernel = device_profile(lambda: kernels.ransac_counts(*args))
    dev = sum(by_kernel.values())
    emit({"phase": 1, "kernel": "ransac_counts", "max_count_diff": worst, "identical_runs": True, "ms": ms,
          "plain_ms": plain_ms, "device_ms": dev, "device_ms_by_kernel": by_kernel,
          "host_ms": host_ms(lambda: kernels.ransac_counts(*args)),
          "cases": [list(c) for c in COUNT_CASES], "shape": [1000, SEQ02_LEN], "dtype": "float32"})
    src, T = args[0], args[3].shape[0]
    moved = (2 * src.numel() + T * 13) * src.element_size() + src.shape[0] + 4 * T
    return [kernel_entry("ransac_counts", "ransac_counts.cu", "pallas_kernels.py:450", "float32",
                         float(diff32), ms, plain_ms,
                         bound(moved, COUNT_FLOPS * T * src.shape[0], "float32"), None, dev)]


# The batch grids' checks and times: the eleven KITTI odometry sequences
# with ground truth (00-10) at their lengths as one ragged batch, and a
# fleet bucket of 64 rows of seq-02's length (phase 7's two workloads).
KITTI_LENGTHS = (4541, 1101, 4661, 801, 271, 2761, 1101, 1101, 4071, 1591, 1201)
FLEET = (64, SEQ02_LEN)


def ragged_walks(gen, ns, ms, dtype, device, offset: float = 0.0):
    """(traj (B, n, 3), cands (B, m, 3), mask (B, m)): random walks, row r
    real for its first ns[r] queries and ms[r] candidates and its last point
    repeated after them, masked out (as ``parallel.batch.pad_batch`` pads);
    with two or more rows the last has every candidate masked."""
    import torch

    n, m = max(ns), max(ms)
    traj = torch.empty(len(ns), n, 3, dtype=dtype, device=device)
    cands = torch.empty(len(ns), m, 3, dtype=dtype, device=device)
    mask = torch.zeros(len(ns), m, dtype=torch.bool, device=device)
    for r, (nr, mr) in enumerate(zip(ns, ms)):
        t, c = walk(gen, nr, torch.float64, device) + offset, walk(gen, mr, torch.float64, device) + offset + 0.3
        traj[r, :nr], traj[r, nr:] = t.to(dtype), t[-1].to(dtype)
        cands[r, :mr], cands[r, mr:] = c.to(dtype), c[-1].to(dtype)
        mask[r, :mr] = (torch.rand(mr, generator=gen) > 0.1).to(device)
    if len(ns) > 1:
        mask[-1] = False
    return traj, cands, mask


def same_bits(t):
    """``t``'s bits as integers, so that NaNs compare equal."""
    import torch

    return t.view(torch.int32 if t.dtype == torch.float32 else torch.int64)


def batched_scan_inputs(op: str, ns, gen, dtype, device):
    """(L, B, max(ns)) leaves: row r is ``scan_inputs`` at ns[r] with its
    last element repeated to the common length."""
    import torch

    n = max(ns)
    rows = []
    for nr in ns:
        x = scan_inputs(op, nr, gen, dtype, device)
        rows.append(torch.cat([x, x[:, -1:].expand(-1, n - nr)], 1))
    return torch.stack(rows, 1).contiguous()


def phase1_batched_scan(device, gen):
    """K1's batch grid, every combine in both directions the main path
    scans it, float32 and float64: the eleven KITTI lengths as one ragged
    batch and the fleet bucket (64 x 4,661), one launch each, against the
    batched plain ladder and, row by row, against the single-row K1 (every
    row of the ragged batch, the first and last of the fleet), each to TOL:
    the look-back folds whatever its predecessors have published, so two
    K1 calls on one row agree to the scan's tolerance, not bit for bit.
    Times of the fleet bucket in float32, with the bound over all rows and
    the library call where there is one."""
    import torch

    from gps_optimize_slam_tpu_torch.ops import scan

    entries = []
    for op in scan.OPS:
        worst = {}
        for dtype in (torch.float32, torch.float64):
            name = dtype_name(dtype)
            for ns in (KITTI_LENGTHS, (FLEET[1],) * FLEET[0]):
                x = batched_scan_inputs(op, ns, gen, dtype, device)
                for rev in directions(op):
                    got = scan.scan_block(op, x, rev)
                    torch.cuda.synchronize()
                    want = scan.scan_plain(op, x, rev)
                    err = rel_err(got.reshape(-1, got.shape[-1]), want.reshape(-1, want.shape[-1]))
                    if not err <= TOL[name]:
                        raise AssertionError(f"batched scan {op} {name} B={len(ns)} rev={rev}: rel err {err:.3e}")
                    rows = range(len(ns)) if len(ns) != FLEET[0] else (0, len(ns) - 1)
                    for r in rows:
                        alone = scan.scan_block(op, x[:, r].contiguous(), rev)
                        err = max(err, rel_err(got[:, r], alone))
                    if not err <= TOL[name]:
                        raise AssertionError(f"batched scan {op} {name} B={len(ns)}: rows off K1 alone by {err:.3e}")
                    worst[name] = max(worst.get(name, 0.0), err)
                    if len(ns) == FLEET[0] and dtype == torch.float32 and rev == REVERSE_OF.get(op, False):
                        timed = (x, rev, abs_err(got, want))
        x, rev, aerr = timed
        ms = cuda_ms(lambda: scan.scan_block(op, x, rev))
        plain_ms = cuda_ms(lambda: scan.scan_plain(op, x, rev), reps=3)
        lib_ms = scan_library_ms(op, x, rev)
        dev = device_ms(lambda: scan.scan_block(op, x, rev))
        emit({"phase": 1, "kernel": f"scan_block/{op}@batch", "rel_err": worst, "ms": ms, "plain_ms": plain_ms,
              "library_ms": lib_ms, "device_ms": dev, "rows_within_tol_of_k1_alone": True,
              "shape": list(x.shape), "dtype": "float32", "ragged_rows": list(KITTI_LENGTHS)})
        entries.append(kernel_entry(f"scan_block/{op}@batch", "scan.cu", "pallas_scan.py:227", "float32", aerr,
                                    ms, plain_ms, scan_bound(op, x), lib_ms, dev))
    return entries


def phase1_batched_nn(device, gen):
    """The keep lists and K3 with a batch grid, float32 and float64: the
    eleven KITTI lengths as one ragged batch (its last row all-masked), the
    fleet bucket (64 x 4,661: 2,368 query tiles, so the batch takes K3's
    32-query blocks where each row alone takes 16), one row, and in float64
    the KITTI batch at UTM magnitudes. The lists and packed candidates equal
    the batched plain ones bit for bit, the minima the plain ones to TOL,
    and each row equals the single-row kernels on it bit for bit. Times of
    the fleet bucket in float32; the library yardstick (``torch.cdist`` of
    the batch, masked, then ``min``) where its matrix fits."""
    import torch

    from gps_optimize_slam_tpu_torch.ops import kernels

    fleet = ((FLEET[1],) * FLEET[0],) * 2
    cases = [(KITTI_LENGTHS, KITTI_LENGTHS, 0.0), fleet + (0.0,), ((SEQ02_LEN,), (SEQ02_LEN,), 0.0),
             (KITTI_LENGTHS, KITTI_LENGTHS, 5.4e6)]
    nn_err, checks = {}, {}
    for dtype in (torch.float32, torch.float64):
        name = dtype_name(dtype)
        for ns, ms, offset in cases:
            if offset and dtype == torch.float32:
                continue  # float32 cannot hold UTM coordinates to better than 0.5 m
            traj, cand, mask = ragged_walks(gen, ns, ms, dtype, device, offset)
            what = f"B{len(ns)}/{name}" + ("/utm" if offset else "")
            order, nkept, cand4 = kernels.keep_lists(traj, cand, mask)
            got = kernels.nn_resident(traj, cand, mask)
            torch.cuda.synchronize()
            w_order, w_nkept, w_cand4 = plain_keep_lists(traj, cand, mask)
            cols = torch.arange(order.shape[-1], device=device) < nkept[..., None]
            if not (torch.equal(nkept, w_nkept) and torch.equal(torch.where(cols, order, -1), torch.where(cols, w_order, -1))
                    and torch.equal(same_bits(cand4), same_bits(w_cand4))):
                raise AssertionError(f"batched keep lists {what}: differ from the plain ones")
            want = kernels.nn_min_dist2_plain(traj, cand, mask, block=128)
            err = rel_err(got, want)
            if not err <= TOL[name]:
                raise AssertionError(f"batched nn {what}: rel err {err:.3e}")
            for r in (range(len(ns)) if len(ns) != FLEET[0] else (0, len(ns) - 1)):
                o1, k1, c1 = kernels.keep_lists(traj[r], cand[r], mask[r])
                c = torch.arange(o1.shape[-1], device=device) < k1[:, None]
                if not (torch.equal(k1, nkept[r]) and torch.equal(torch.where(c, o1, -1), torch.where(c, order[r], -1))
                        and torch.equal(same_bits(c1), same_bits(cand4[r]))):
                    raise AssertionError(f"batched keep lists {what}: row {r} differs from the call alone")
                if not torch.equal(kernels.nn_resident(traj[r], cand[r], mask[r]), got[r]):
                    raise AssertionError(f"batched nn {what}: row {r} differs from K3 alone")
            if len(ns) > 1 and not bool(torch.isinf(got[-1]).all()):
                raise AssertionError(f"batched nn {what}: the all-masked row must give +inf")
            nn_err[name] = max(nn_err.get(name, 0.0), err)
            checks[what] = {"kept_tile_pairs": int(nkept.sum()), "tile_pairs": order.numel()}
            if len(ns) == FLEET[0] and dtype == torch.float32:
                timed = (traj, cand, mask, abs_err(got, want), float((nkept - w_nkept).abs().max()), nkept, cand4)
            del want, w_order, w_cand4
    traj, cand, mask, aerr, keep_err, nkept, cand4 = timed

    def cdist_min():
        d = torch.cdist(traj, cand, compute_mode="donot_use_mm_for_euclid_dist")
        return torch.where(mask[:, None, :], d, float("inf")).amin(-1)

    # The distances and their masked copy: two B x n x m matrices.
    library_ms = cuda_ms(cdist_min, reps=5) if fits_on_card(2 * traj[..., 0].numel() * cand.shape[1]
                                                            * traj.element_size()) else None
    torch.cuda.empty_cache()
    ms = cuda_ms(lambda: kernels.nn_resident(traj, cand, mask))
    plain_ms = cuda_ms(lambda: kernels.nn_min_dist2_plain(traj, cand, mask, block=128), reps=3)
    by_kernel = device_profile(lambda: kernels.nn_resident(traj, cand, mask))
    keep_ms = cuda_ms(lambda: kernels.keep_lists(traj, cand, mask))
    keep_plain_ms = cuda_ms(lambda: plain_keep_lists(traj, cand, mask), reps=3)
    keep_dev = device_ms(lambda: kernels.keep_lists(traj, cand, mask))
    emit({"phase": 1, "kernel": "nn_resident@batch", "rel_err": nn_err, "ms": ms, "plain_ms": plain_ms,
          "library_ms": library_ms, "device_ms": sum(by_kernel.values()), "device_ms_by_kernel": by_kernel,
          "keep_ms": keep_ms, "keep_plain_ms": keep_plain_ms, "keep_device_ms": keep_dev,
          "rows_equal_to_the_calls_alone": True, "checks": checks, "shape": list(traj.shape), "dtype": "float32"})
    torch.cuda.empty_cache()
    return [kernel_entry("nn_keep@batch", "nn_keep.cu", "pallas_kernels.py:174", "float32", keep_err, keep_ms,
                         keep_plain_ms, keep_bound(traj, cand, mask, nkept, cand4), None, keep_dev),
            kernel_entry("nn_resident@batch", "nn.cu", "pallas_kernels.py:283", "float32", aerr, ms, plain_ms,
                         nn_bound(traj, cand, mask), library_ms, sum(by_kernel.values()))]


# K2's batch grid in phase 1: four ragged float64 rows around phase 5's
# chunk length (the last with fewer tiles than the card has persistent
# blocks), and four rows of 20,001 (fewer tiles in all than blocks).
TILED_BATCH = (CHUNK + 1, 393_217, 300_001, 20_001)
TILED_BATCH_FEW = (20_001,) * 4
EXACT_COMBINES = ("add2", "max3", "min3")  # add2 on 0/1 counts: every sum exact


def identity_padded_rows(op: str, ns, gen, dtype, device):
    """(L, B, max(ns)) leaves: row r is ``scan_inputs`` at ns[r], then the
    combine's identity to the common length (a padded row's tail leaves its
    scan as it is)."""
    import torch

    from gps_optimize_slam_tpu_torch.ops import scan

    n = max(ns)
    ident = torch.tensor(scan.OPS[op][2], dtype=dtype, device=device)[:, None]
    rows = [torch.cat([scan_inputs(op, k, gen, dtype, device), ident.expand(-1, n - k)], 1) for k in ns]
    return torch.stack(rows, 1).contiguous()


def phase1_batched_tiled_scan(device, gen):
    """K2's batch grid, every combine in the directions the main path scans
    it, float64: ``TILED_BATCH`` and ``TILED_BATCH_FEW``, one launch each,
    against the batched plain ladder and, row by row, against K2 on that
    row alone (and, forward, on its real elements alone), bit for bit where
    the combine is exact and to TOL elsewhere. Times at ``TILED_BATCH``
    beside K1's batch grid on the same leaves, with the bound over all rows
    and the library call where there is one."""
    import torch

    from gps_optimize_slam_tpu_torch.ops import scan

    entries = []
    for op in scan.OPS:
        worst = 0.0
        for ns in (TILED_BATCH, TILED_BATCH_FEW):
            x = identity_padded_rows(op, ns, gen, torch.float64, device)
            for rev in directions(op):
                got = scan.scan_tiled(op, x, rev)
                torch.cuda.synchronize()
                want = scan.scan_plain(op, x, rev)
                err = rel_err(got.flatten(1), want.flatten(1))
                for r, k in enumerate(ns):
                    pairs = [(got[:, r], scan.scan_tiled(op, x[:, r].contiguous(), rev))]
                    if not rev:
                        pairs.append((got[:, r, :k], scan.scan_tiled(op, x[:, r, :k].contiguous(), False)))
                    for a, b in pairs:
                        if op in EXACT_COMBINES and not torch.equal(a, b):
                            raise AssertionError(f"batched tiled scan {op} rows {ns} rev={rev}: row {r} differs "
                                                 "from K2 alone")
                        err = max(err, rel_err(a, b))
                if not err <= TOL["float64"]:
                    raise AssertionError(f"batched tiled scan {op} rows {ns} rev={rev}: rel err {err:.3e}")
                worst = max(worst, err)
                if ns == TILED_BATCH and rev == REVERSE_OF.get(op, False):
                    timed = (x, rev, abs_err(got, want))
                del got, want
        x, rev, aerr = timed
        ms = cuda_ms(lambda: scan.scan_tiled(op, x, rev))
        plain_ms = cuda_ms(lambda: scan.scan_plain(op, x, rev), reps=3)
        lib_ms = scan_library_ms(op, x, rev)
        dev = device_ms(lambda: scan.scan_tiled(op, x, rev))
        emit({"phase": 1, "kernel": f"scan_tiled/{op}@batch", "rel_err": worst, "rows": list(TILED_BATCH),
              "rows_few_tiles": list(TILED_BATCH_FEW), "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
              "device_ms": dev, "k1_batch_ms": cuda_ms(lambda: scan.scan_block(op, x, rev)),
              "k1_batch_device_ms": device_ms(lambda: scan.scan_block(op, x, rev)),
              "route": scan.scan_route(x.shape[0], x.shape[-1], x.element_size(), x.shape[1]),
              "shape": list(x.shape), "dtype": "float64"})
        entries.append(kernel_entry(f"scan_tiled/{op}@batch", "scan_tiled.cu", "pallas_scan.py:361", "float64",
                                    aerr, ms, plain_ms, scan_bound(op, x), lib_ms, dev))
        del x
        torch.cuda.empty_cache()
    return entries


# K4's batch grid in phase 1: 4 rows x 700 queries x 524,288 shuffled
# candidates (K4's winning shape, a row all masked), and phase 10's
# evaluation shape (its rows' real lengths, padded as pad_batch pads).
GRID_BATCH_WIN = (4, 700, CHUNK)
LONG_LOG_LENGTHS = (CHUNK, 458_752, 393_216, 300_000)


def phase1_batched_grid(device, gen):
    """K4's batch grid, float64 and float32 (one work list over every row's
    query tiles): bit for bit against K3's batch grid, the wrapper and the
    launch alone, within TOL of the plain version on every 64th
    query, +inf on the all-masked row; at ``GRID_BATCH_WIN`` (shuffled
    candidates) and at phase 10's evaluation shape (random walks of
    ``LONG_LOG_LENGTHS`` queries and candidates, ragged). Times of each in
    float64 beside K3's batch grid, with the library yardstick (``cdist``
    of the batch in the matrix-product form, masked, then ``min``) where
    its matrices fit."""
    import torch

    from gps_optimize_slam_tpu_torch.ops import kernels

    B, n, m = GRID_BATCH_WIN
    checks, entry = {}, None
    for case in ("win", "long_logs"):
        for dtype in (torch.float64, torch.float32):
            name = dtype_name(dtype)
            if case == "win":
                traj = torch.stack([walk(gen, n, dtype, device) for _ in range(B)])
                cand = torch.stack([(walk(gen, m, dtype, device) + 0.3)[torch.randperm(m, generator=gen).to(device)]
                                    for _ in range(B)]).contiguous()
                mask = (torch.rand(B, m, generator=gen) > 0.1).to(device)
                mask[2] = False
            else:
                traj, cand, mask = ragged_walks(gen, LONG_LOG_LENGTHS, LONG_LOG_LENGTHS, dtype, device)
            k3 = kernels.nn_resident(traj, cand, mask)
            res = {"route": kernels.nn_route(cand.shape[1], traj.shape[1], traj.shape[0])}
            ops = kernels.nn_grid_operands(traj, cand, mask)
            items = int(ops[3][-1, -1])
            got = kernels.grid_launch(traj, ops, items)
            torch.cuda.synchronize()
            if not torch.equal(got, k3):
                raise AssertionError(f"batched nn grid {case} {name}: differs from K3 in "
                                     f"{int((got != k3).sum())} queries")
            if dtype == torch.float64:
                res.update(blocks=items, kernel_ms=cuda_ms(lambda: kernels.grid_launch(traj, ops, items), reps=5))
            del ops, got
            idx = torch.arange(0, traj.shape[1], PLAIN_STRIDE, device=device)
            want = kernels.nn_min_dist2_plain(traj[:, idx].contiguous(), cand, mask, block=8)
            err = rel_err(k3[:, idx].flatten()[None], want.flatten()[None])
            if not err <= TOL[name]:
                raise AssertionError(f"batched nn grid {case} {name}: rel err {err:.3e}")
            dead = 2 if case == "win" else -1
            if not bool(torch.isinf(k3[dead]).all()):
                raise AssertionError(f"batched nn grid {case} {name}: the all-masked row must give +inf")
            res.update(rel_err=err, kept_tile_pairs=int(kernels.keep_lists(traj, cand, mask)[1].sum()))
            if dtype == torch.float64:
                res.update(ms=cuda_ms(lambda: kernels.nn_grid(traj, cand, mask), reps=5),
                           device_ms=device_ms(lambda: kernels.nn_grid(traj, cand, mask), reps=5),
                           k3_ms=cuda_ms(lambda: kernels.nn_resident(traj, cand, mask), reps=5),
                           k3_device_ms=device_ms(lambda: kernels.nn_resident(traj, cand, mask), reps=5),
                           plain_ms_every_64th=cuda_ms(lambda: kernels.nn_min_dist2_plain(
                               traj[:, idx].contiguous(), cand, mask, block=8), reps=3),
                           library_ms=cdist_batch_library_ms(traj, cand, mask),
                           bound=nn_bound(traj, cand, mask))
                if case == "win":
                    entry = kernel_entry("nn_grid@batch", "nn_grid.cu", "pallas_kernels.py:302", "float64",
                                         abs_err(k3[:, idx], want), res["ms"], res["plain_ms_every_64th"],
                                         res["bound"], res["library_ms"], res["device_ms"])
            checks[f"{case}/{name}"] = res
            del traj, cand, mask, k3, want
            torch.cuda.empty_cache()
    emit({"phase": 1, "kernel": "nn_grid@batch", "equal_to_k3": True, "plain_queries_every": PLAIN_STRIDE,
          "shapes": {"win": list(GRID_BATCH_WIN), "long_logs": [list(LONG_LOG_LENGTHS)] * 2}, "checks": checks})
    return [entry]


def cdist_batch_library_ms(traj, cand, mask, reps: int = 3):
    """The library yardstick of a batched NN call: ``torch.cdist`` of the
    batch in its matrix-product form, the masked candidates set to +inf,
    then ``min`` (the B x n x m distances and their masked copy in device
    memory); None where they do not fit (``fits_on_card``). Timed only."""
    import torch

    if not fits_on_card(2 * traj[..., 0].numel() * cand.shape[-2] * traj.element_size()):
        return None

    def call():
        d = torch.cdist(traj, cand, compute_mode="use_mm_for_euclid_dist")
        return torch.where(mask[:, None, :], d, float("inf")).amin(-1)

    ms = cuda_ms(call, reps)
    torch.cuda.empty_cache()
    return ms


def phase1_batched_counts(device, gen):
    """K5 with a batch grid, float32 and float64: the eleven KITTI lengths
    as one ragged batch (points past a row's length masked out, one row
    with no valid point) and the fleet bucket, 1000 trials a row: counts
    equal the batched plain ones and, row by row, the single-row kernel's;
    the re-ranked winners equal. Times of the fleet bucket in float32."""
    import torch

    from gps_optimize_slam_tpu_torch.ops import kernels
    from gps_optimize_slam_tpu_torch.ops.ransac import select_winner
    from gps_optimize_slam_tpu_torch.ops.umeyama import umeyama_sim3

    trials = 1000
    for dtype in (torch.float32, torch.float64):
        for ns in (KITTI_LENGTHS, (FLEET[1],) * FLEET[0]):
            B, n = len(ns), max(ns)
            src = torch.stack([walk(gen, n, torch.float64, device, scale=2.0) for _ in range(B)])
            dst = 0.987 * src + torch.tensor([3.0, -2.0, 1.0], dtype=torch.float64, device=device)
            dst = (dst + 2.0 * torch.randn(B, n, 3, generator=gen, dtype=torch.float64).to(device)).to(dtype)
            src = src.to(dtype)
            valid = (torch.rand(B, n, generator=gen) > 0.05).to(device)
            for r, nr in enumerate(ns):
                valid[r, nr:] = False
            if B != FLEET[0]:
                valid[1] = False
            draws = torch.randint(0, min(ns), (B, trials, 4), generator=gen).to(device)
            pick = torch.arange(B, device=device)[:, None, None]
            fits = umeyama_sim3(src[pick, draws], dst[pick, draws])
            args = (src, dst, valid, fits.R.contiguous(), fits.t.contiguous(), fits.scale.contiguous(), 16.0)
            got = kernels.ransac_counts(*args)
            torch.cuda.synchronize()
            want = kernels.ransac_counts_plain(*args)
            what = f"batched ransac_counts {dtype} B={B}"
            if not torch.equal(got, want):
                raise AssertionError(f"{what}: counts differ from the plain ones by {int((got - want).abs().max())}")
            for r in (range(B) if B != FLEET[0] else (0, B - 1)):
                if not torch.equal(got[r], kernels.ransac_counts(*(a[r].contiguous() for a in args[:6]), 16.0)):
                    raise AssertionError(f"{what}: row {r} differs from the kernel alone")
            if not torch.equal(select_winner(src, dst, valid, fits, got, 16.0),
                               select_winner(src, dst, valid, fits, want, 16.0)):
                raise AssertionError(f"{what}: winners differ")
            if B != FLEET[0] and int(got[1].max()) != 0:
                raise AssertionError(f"{what}: a row with no valid point counted hits")
            if B == FLEET[0] and dtype == torch.float32:
                timed = args
    args = timed
    ms = cuda_ms(lambda: kernels.ransac_counts(*args))
    plain_ms = cuda_ms(lambda: kernels.ransac_counts_plain(*args), reps=3)
    dev = device_ms(lambda: kernels.ransac_counts(*args))
    src, B, T = args[0], args[0].shape[0], args[3].shape[1]
    emit({"phase": 1, "kernel": "ransac_counts@batch", "equal_to_plain": True, "rows_equal_to_the_kernel_alone": True,
          "ms": ms, "plain_ms": plain_ms, "device_ms": dev, "shape": [B, T, src.shape[1]], "dtype": "float32",
          "ragged_rows": list(KITTI_LENGTHS)})
    moved = (2 * src.numel() + B * T * 13) * src.element_size() + src.shape[0] * src.shape[1] + 4 * B * T
    return [kernel_entry("ransac_counts@batch", "ransac_counts.cu", "pallas_kernels.py:450", "float32", 0.0, ms,
                         plain_ms, bound(moved, COUNT_FLOPS * B * T * src.shape[1], "float32"), None, dev)]


def phase1(device):
    """Kernels against their plain versions on the card."""
    import torch

    gen = torch.Generator().manual_seed(0)
    entries = phase1_block_scan(device, gen)
    entries += phase1_tiled_scan(device, gen)
    entries += phase1_keep(device, gen)
    entries += phase1_nn(device, gen)
    entries += phase1_counts(device, gen)
    entries += phase1_batched_scan(device, gen)
    entries += phase1_batched_nn(device, gen)
    entries += phase1_batched_counts(device, gen)
    entries += phase1_batched_tiled_scan(device, gen)
    entries += phase1_batched_grid(device, gen)
    phase1_routes(device, gen)
    return entries


def golden_arrays():
    g = np.load(GOLDEN)
    slam = {"timestamps": g["slam_times"], "positions": g["slam_pos"], "quaternions": g["slam_quat"]}
    return g, slam


def phase2(device):
    """seq-04 golden arrays, float64 UTM, on the card."""
    import torch

    from gps_optimize_slam_tpu_torch import pipeline

    g, slam = golden_arrays()
    meta = json.load(open(META))
    gps = pipeline.GPSData(
        timestamps=g["gps_times"], positions=g["gps_utm"], valid=np.ones(len(g["gps_times"]), bool),
        frame="utm", utm_zone=32, utm_south=False,
    )
    res = pipeline.fuse_arrays(slam, gps, dtype=torch.float64, device=device)
    pos_err = float(np.abs(res.corrected_pos - g["corrected_pos"]).max())
    ev = res.evaluation
    rel = {
        "sim3_scale": abs(res.sim3_scale / meta["sim3_scale"] - 1),
        "rmse_sim3": abs(float(ev.nn_sim3.rmse) / meta["rmse_sim3"] - 1),
        "rmse_ekf": abs(float(ev.nn_ekf.rmse) / meta["rmse_ekf"] - 1),
    }
    emit({"phase": 2, "corrected_pos_max_err_m": pos_err, "rel_err": rel,
          "inliers": int(res.outputs.sim3_inliers.sum())})
    if not pos_err <= 1e-6:
        raise AssertionError(f"golden corrected_pos off by {pos_err:.3e} m")
    if not max(rel.values()) <= 1e-6:
        raise AssertionError(f"golden scalars off: {rel}")


def write_seq04_files(tmp: str):
    """TUM and GNSS files rebuilt from the npz (GNSS via the inverse UTM
    projection, zone 32N)."""
    import torch

    from gps_optimize_slam_tpu_torch.io import tum
    from gps_optimize_slam_tpu_torch.ops import geodesy

    g, slam = golden_arrays()
    slam_path = os.path.join(tmp, "seq04.tum")
    gps_path = os.path.join(tmp, "seq04_gnss.txt")
    tum.write_tum(slam_path, slam["timestamps"], slam["positions"], slam["quaternions"],
                  position_fmt="%.9f")
    utm = torch.from_numpy(g["gps_utm"])
    lon, lat = geodesy.utm_inverse(utm[:, 0], utm[:, 1], 32, False)
    rows = np.column_stack([g["gps_times"], lat.numpy(), lon.numpy(), g["gps_utm"][:, 2]])
    np.savetxt(gps_path, rows, fmt=["%.6f", "%.10f", "%.10f", "%.4f"])
    return slam_path, gps_path


def independent_track(times, positions, m: int, seed: int, sigma: float = 0.05):
    """An independent reference track made from a GNSS track: ``m`` sampling
    times of its own (an even grid over the span, each time jittered by up
    to 0.3 of a step, so no two fall together and the spline through the
    noise stays tame), the positions interpolated there, and ``sigma``
    metres of fresh noise, from ``seed``."""
    rng = np.random.default_rng(seed)
    step = (times[-1] - times[0]) / (m - 1)
    tt = np.clip(np.linspace(times[0], times[-1], m) + rng.uniform(-0.3, 0.3, m) * step, times[0], times[-1])
    tp = np.stack([np.interp(tt, times, positions[:, k]) for k in range(3)], -1)
    return tt, tp + rng.normal(size=tp.shape) * sigma


def write_seq04_gt_file(tmp: str, seed: int = 7):
    """A ground-truth GNSS file for the seq-04 files: an independent track
    of the golden GNSS (``independent_track``, 250 fixes), written lon-first
    (``ts lon lat alt``), the column order of a ground-truth file."""
    import torch

    from gps_optimize_slam_tpu_torch.ops import geodesy

    g, _ = golden_arrays()
    tt, tp = independent_track(g["gps_times"], g["gps_utm"], 250, seed)
    lon, lat = geodesy.utm_inverse(torch.from_numpy(tp[:, 0]), torch.from_numpy(tp[:, 1]), 32, False)
    gt_path = os.path.join(tmp, "seq04_gt.txt")
    np.savetxt(gt_path, np.column_stack([tt, lon.numpy(), lat.numpy(), tp[:, 2]]),
               fmt=["%.6f", "%.10f", "%.10f", "%.4f"])
    return gt_path


def phase3(device):
    """seq-04 from files: float32 ENU on the card against CPU float64."""
    import torch

    from gps_optimize_slam_tpu_torch import pipeline

    with tempfile.TemporaryDirectory() as tmp:
        slam_path, gps_path = write_seq04_files(tmp)
        res = pipeline.fuse_files(slam_path, gps_path, frame="enu", dtype=torch.float32, device=device)
        out = os.path.join(tmp, "fused_enu.tum")
        pipeline.export_result(res, out)
        back = np.loadtxt(out)
        ref = pipeline.fuse_files(slam_path, gps_path, frame="enu", dtype=torch.float64, device="cpu")
    kept, total = int(res.gps.valid.sum()), len(res.gps.valid)
    pos_err = float(np.abs(res.corrected_pos - ref.corrected_pos).max())
    scale_rel = abs(res.sim3_scale / ref.sim3_scale - 1)
    emit({"phase": 3, "gate_kept": [kept, total], "corrected_pos_max_err_m": pos_err,
          "scale_rel_err": scale_rel, "exported_rows": int(back.shape[0]),
          "rmse_ekf_m": float(res.evaluation.nn_ekf.rmse)})
    if kept != total or total != 279:
        raise AssertionError(f"gate kept {kept}/{total}, expected 279/279")
    if not pos_err <= 1e-3 or not scale_rel <= 1e-5:
        raise AssertionError(f"float32 card run off the CPU float64 run: {pos_err:.3e} m, {scale_rel:.3e}")
    if back.shape != (271, 8) or not np.isfinite(back).all():
        raise AssertionError("export_result wrote a malformed trajectory")


def replica_sequence(n: int, seed: int = 0):
    """A real-derived sequence of ``n`` poses: time-shifted replicas of the
    seq-04 golden arrays (real GNSS noise and timing), 2 cm of fresh noise
    per replica from ``seed``, GNSS in a local frame (UTM minus its first
    fix).

    The SLAM replicas are shifted by the stream's end-start vector, and the
    GNSS replicas by the golden Sim(3)'s image of that shift (s·R·Δ), so all
    replicas share one Sim(3). bench.py shifts the GNSS by its own end-start
    vector instead, which accumulates the real ~1 m end-point mismatch per
    replica: over the 180 s Sim(3) window hundreds of residuals then sit
    near the 4 m RANSAC threshold, and the consensus set, and with it every
    pose, moves with float32 rounding (0.31-0.34 m float32 against float64
    on the CPU for four sets of draws). Here the float32 card run and the
    float64 CPU run share one consensus set, so their agreement measures
    the arithmetic."""
    g, _ = golden_arrays()
    st0, sp0, sq0 = g["slam_times"], g["slam_pos"], g["slam_quat"]
    gt0, gp0 = g["gps_times"], g["gps_utm"] - g["gps_utm"][0]
    n0 = len(st0)
    period = max(st0[-1] - st0[0], gt0[-1] - gt0[0]) + 2.0
    dstep_s = (sp0[-1] - sp0[0]) * (1.0 + 1.0 / n0)
    dstep_g = float(g["sim3_scale"]) * g["sim3_R"] @ dstep_s
    rng = np.random.default_rng(seed)
    reps = -(-n // n0)
    ks = np.arange(reps)
    st = np.concatenate([st0 + k * period for k in ks])[:n]
    sp = np.concatenate([sp0 + k * dstep_s for k in ks])[:n]
    sq = np.tile(sq0, (reps, 1))[:n]
    gt = np.concatenate([gt0 + k * period for k in ks])
    gp = np.concatenate([gp0 + k * dstep_g + rng.normal(size=gp0.shape) * 0.02 for k in ks])
    keep = gt <= st[-1] + 2.0
    return {"timestamps": st, "positions": sp, "quaternions": sq}, gt[keep], gp[keep]


def phase4(device):
    """4,661 poses on the card: float32 (launch counts, warm wall time) and
    float64, each against the port's CPU float64 run.

    Bounds: float64 ≤ 1e-6 m (same arithmetic, other order). float32
    ≤ 1e-2 m: at this sequence's ~7 km extent a float32 coordinate's ulp is
    4.9e-4 m, so the 1e-3 m of the seq-04 check is two ulps; on the CPU the
    float32 spline alone lands 1.1e-3 m and the parallel filter 3.3e-3 m
    from float64."""
    import torch

    from gps_optimize_slam_tpu_torch import pipeline
    from gps_optimize_slam_tpu_torch.ops import scan

    slam, gt, gp = replica_sequence(SEQ02_LEN)
    gps = pipeline.GPSData(timestamps=gt, positions=gp, valid=np.ones(len(gt), bool),
                           frame="enu", utm_zone=32, utm_south=False)

    def run(dev, dtype):
        return pipeline.fuse_arrays(slam, gps, dtype=dtype, device=dev)

    t0 = time.perf_counter()
    ref = run("cpu", torch.float64)
    cpu_s = time.perf_counter() - t0
    res64 = run(device, torch.float64)

    reset_launch_counts()
    res = run(device, torch.float32)
    torch.cuda.synchronize()
    launches = launch_counts()

    walls = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run(device, torch.float32)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    err32 = float(np.abs(res.corrected_pos - ref.corrected_pos).max())
    err64 = float(np.abs(res64.corrected_pos - ref.corrected_pos).max())
    emit({"phase": 4, "poses": SEQ02_LEN, "gnss": int(len(gt)),
          "corrected_pos_max_err_m": {"float32": err32, "float64": err64},
          "rmse_ekf_m": float(res.evaluation.nn_ekf.rmse), "launches": launches,
          "gpu_wall_ms_median5": 1e3 * float(np.median(walls)), "cpu_plain_wall_ms": 1e3 * cpu_s})
    if not err64 <= 1e-6 or not err32 <= 1e-2:
        raise AssertionError(f"card runs off the CPU float64 run: {err32:.3e} m (f32), {err64:.3e} m (f64)")
    required = [f"scan_block/{op}" for op in scan.OPS] + ["nn_keep", "nn_resident", "ransac_counts"]
    missing = [k for k in required if launches[k] <= 0]
    if missing:
        raise AssertionError(f"kernels not launched on the in-core path: {missing}")
    return launches


def profile_device(fn, host_ops: bool = True) -> dict:
    """One run of ``fn`` under torch.profiler: its wall time, the summed
    device time of its kernels and of its copies, the number of kernels, the
    busy time (the union of those intervals, so overlap is counted once), the
    device's idle share of the wall (1 − busy/wall, not clamped, so a busy
    time past the wall shows as a negative share), and the five kernels with
    the most device time. ``host_ops=False`` traces the device alone, as
    phase 8 does for the refine's ~7·10⁵ launches: tracing their host ops
    too slows the traced run and takes long to read (``PERF.md``, from
    ``tools/torch_pose_graph_probe.py --profiler-cost``)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA] if host_ops else [ProfilerActivity.CUDA]
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    kernels, copy_ms, spans = {}, 0.0, []
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        spans.append((e.time_range.start, e.time_range.end))
        ms = e.time_range.elapsed_us() / 1e3
        if e.name.startswith("Memcpy") or e.name.startswith("Memset"):
            copy_ms += ms
        else:
            k = kernels.setdefault(e.name[:60], [0.0, 0])
            k[0] += ms
            k[1] += 1
    busy_us, end = 0.0, -float("inf")
    for s, e in sorted(spans):
        if e > end:
            busy_us += e - max(s, end)
            end = e
    kernel_ms = sum(v[0] for v in kernels.values())
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:5]
    return {"wall_ms": wall_ms, "kernel_ms": kernel_ms, "copy_ms": copy_ms, "busy_ms": busy_us / 1e3,
            "kernels": sum(v[1] for v in kernels.values()),
            "idle_share": 1.0 - busy_us / 1e3 / wall_ms,
            "top_kernels": [[name, ms, count] for name, (ms, count) in top]}


@contextlib.contextmanager
def forced_route(module, rule: str, route: str):
    """Within it, ``module.rule`` (``scan.scan_route`` or
    ``kernels.nn_route``) answers ``route`` whatever the shapes: how a run
    holds the kernel a route does not pick on the same path and data."""
    saved = getattr(module, rule)
    setattr(module, rule, lambda *args, **kw: route)
    try:
        yield
    finally:
        setattr(module, rule, saved)


def outage_sequence(n: int, seed: int = 0):
    """``replica_sequence(n, seed)`` with every GNSS fix dropped in a 10 s
    window around each 262,144-pose boundary, so that outage runs and RTS
    segments straddle the chunks (the gap threshold is 5 s)."""
    slam, gt, gp = replica_sequence(n, seed)
    st = slam["timestamps"]
    drop = np.zeros(len(gt), bool)
    for k in range(262_144, n, 262_144):
        drop |= np.abs(gt - st[k]) <= 5.0
    return slam, gt[~drop], gp[~drop]


def chunked_stage_split(st, sp, sq, gt, gp, gv, cfg, device) -> dict:
    """Warm wall ms of each stage of ``fuse_core_chunked`` (its four calls,
    in its order), synchronised after each."""
    import torch

    from gps_optimize_slam_tpu_torch.models import fusion_chunked
    from gps_optimize_slam_tpu_torch.ops import alignment_chunked, kalman_chunked

    f64, ms = torch.float64, {}

    def timed(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        ms[name] = 1e3 * (time.perf_counter() - t0)
        return out

    aligned, valid = timed("align", lambda: alignment_chunked.align_gps_to_slam_chunked(
        st, gt, gp, gps_valid=gv, cfg=cfg.time_alignment, chunk_size=CHUNK, dtype=f64, device=device))
    sres = timed("window_ransac", lambda: alignment_chunked.sim3_ransac_streaming(
        sp, np.nan_to_num(aligned, nan=0.0), alignment_chunked.sim3_window_mask_host(
            st, valid, cfg.time_alignment.max_gps_gap_threshold,
            cfg.sim3_ransac.max_initial_duration, cfg.sim3_ransac.min_samples),
        cfg=cfg.sim3_ransac, chunk_size=CHUNK, dtype=f64, device=device))
    p0, q0 = timed("transform", lambda: fusion_chunked.transform_trajectory_chunked(
        sp[:1], sq[:1], sres.sim3, dtype=f64, device=device))
    timed("ekf_rts", lambda: kalman_chunked.fuse_ekf_rts_chunked(
        st, sp, sq, p0[0], q0[0], aligned, valid, cfg.ekf, cfg.rts_decision, cfg.rts_mode,
        chunk_size=CHUNK, dtype=f64, device=device))
    return ms


def rel_diff(a: float, b: float) -> float:
    return 0.0 if a == b else abs(a - b) / max(abs(b), 1e-300)


def phase5(device):
    """The chunked path at 1,048,576 poses, float64 on the card.

    (a) ``fuse_core_chunked`` with 524,288-pose chunks against the in-core
    ``fusion.fuse_core`` on the same arrays and seed (both draw the same
    Sim(3) trials from one generator seeded alike on the card, over the same
    window): ``corrected_pos`` ≤1e-6 m, ``corrected_quat`` ≤1e-8, scale
    ≤1e-9 relative, the JAX package's own bounds for chunked against
    in-core (tests/test_fusion_chunked.py:158-166). (b) ``evaluate_chunked``
    at 524,288 (NN blocks on the route: K3) against the same with the
    blocks forced onto K4 and against 262,144: every statistic ≤1e-12
    relative (K4 equals K3 bit for bit). (c) every kernel of the
    path launched in this run. Then ``fuse_files_chunked`` +
    ``export_result`` on the seq-04 files, against the in-core
    ``fuse_files`` ≤1e-6 m."""
    import torch

    from gps_optimize_slam_tpu_torch import pipeline
    from gps_optimize_slam_tpu_torch.config import FusionConfig
    from gps_optimize_slam_tpu_torch.models import fusion, fusion_chunked
    from gps_optimize_slam_tpu_torch.ops import kernels, scan

    f64 = torch.float64
    slam, gt, gp = outage_sequence(CHUNKED_N)
    st, sp, sq = slam["timestamps"], slam["positions"], slam["quaternions"]
    gv = np.ones(len(gt), bool)
    cfg = FusionConfig(gps_sorted=True)

    def dev(a, dt=f64):
        return torch.as_tensor(a, device=device).to(dt)

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ref = fusion.fuse_core(dev(st), dev(sp), dev(sq), dev(gt), dev(gp), dev(gv, torch.bool), cfg, seed=0)
    ref_pos, ref_quat = ref.corrected_pos.cpu().numpy(), ref.corrected_quat.cpu().numpy()
    ref_scale, ref_ok = float(ref.sim3.scale), bool(ref.ok)
    incore_s = time.perf_counter() - t0
    del ref
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()

    def fuse():
        return fusion_chunked.fuse_core_chunked(st, sp, sq, gt, gp, gv, seed=0, config=cfg,
                                                chunk_size=CHUNK, dtype=f64, device=device)

    def evaluate(res, chunk):
        return fusion_chunked.evaluate_chunked(st, sp, sq, res, chunk_size=chunk, dtype=f64, device=device)

    # The main path: its counts are set to 0 just before it and read just
    # after. Its NN blocks take the kernel the route picks; the evaluation
    # runs once more with them forced onto K4 (both count).
    reset_launch_counts()
    res = fuse()
    torch.cuda.synchronize()
    fuse_peak = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    ev_routed = evaluate(res, CHUNK)
    torch.cuda.synchronize()
    eval_peak = torch.cuda.max_memory_allocated()
    with forced_route(kernels, "nn_route", "grid"):
        ev_grid = evaluate(res, CHUNK)
    torch.cuda.synchronize()
    launches = launch_counts()

    ev_resident = evaluate(res, 262_144)
    with tempfile.TemporaryDirectory() as tmp:
        slam_path, gps_path = write_seq04_files(tmp)
        reset_launch_counts()
        res04 = pipeline.fuse_files_chunked(slam_path, gps_path, dtype=f64, device=device)
        out = os.path.join(tmp, "fused_chunked.tum")
        pipeline.export_result(res04, out)
        back = np.loadtxt(out)
        torch.cuda.synchronize()
        launches04 = launch_counts()
        ref04 = pipeline.fuse_files(slam_path, gps_path, dtype=f64, device=device)

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fuse()
    torch.cuda.synchronize()
    fuse_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    evaluate(res, CHUNK)
    torch.cuda.synchronize()
    eval_s = time.perf_counter() - t0
    stages = chunked_stage_split(st, sp, sq, gt, gp, gv, cfg, device)
    prof = {"fuse": profile_device(fuse), "evaluate": profile_device(lambda: evaluate(res, CHUNK))}

    pos_err = float(np.abs(res.corrected_pos - ref_pos).max())
    quat_err = float(np.abs(res.corrected_quat - ref_quat).max())
    scale_rel = rel_diff(float(res.sim3.scale), ref_scale)
    parts = ("nn_slam", "nn_sim3", "nn_ekf", "ate_sim3", "ate_ekf")
    stats = ("mean", "median", "rmse", "max", "count")
    eval_rel = max(rel_diff(float(getattr(getattr(ev_grid, p), f)), float(getattr(getattr(ev, p), f)))
                   for p in parts for f in stats for ev in (ev_routed, ev_resident))
    err04 = float(np.abs(res04.corrected_pos - ref04.corrected_pos).max())
    emit({"phase": 5, "poses": CHUNKED_N, "gnss": int(len(gt)), "chunk": CHUNK, "dtype": "float64",
          "ok": [res.ok, ref_ok], "inliers": res.num_inliers,
          "chunked_vs_incore": {"corrected_pos_max_err_m": pos_err, "corrected_quat_max_err": quat_err,
                                "scale_rel_err": scale_rel},
          "nn_block_route": kernels.nn_route(CHUNK, CHUNK),
          "eval_k4_vs_k3_max_rel_err": eval_rel, "rmse_ekf_m": float(ev_routed.nn_ekf.rmse),
          "launches": launches,
          "chunked_fuse_warm_s": fuse_s, "poses_per_s": CHUNKED_N / fuse_s,
          "evaluate_warm_s": eval_s, "incore_fuse_first_s": incore_s,
          "fuse_stage_ms": stages, "profile": prof,
          "max_memory_allocated_mb": {"chunked_fuse": fuse_peak / 2**20, "evaluate": eval_peak / 2**20},
          "seq04_files": {"corrected_pos_max_err_m": err04, "exported_rows": int(back.shape[0]),
                          "launches": launches04}})
    if not (res.ok and ref_ok):
        raise AssertionError("phase 5: the Sim3 alignment failed")
    if not (pos_err <= 1e-6 and quat_err <= 1e-8 and scale_rel <= 1e-9):
        raise AssertionError(f"chunked off in-core: {pos_err:.3e} m, quat {quat_err:.3e}, scale {scale_rel:.3e}")
    if not eval_rel <= 1e-12:
        raise AssertionError(f"evaluation with K4 forced off the routed one (K3): {eval_rel:.3e}")
    if not err04 <= 1e-6 or back.shape != (271, 8) or not np.isfinite(back).all():
        raise AssertionError(f"seq-04 chunked off in-core ({err04:.3e} m) or malformed export")
    # At 524,288-pose chunks every scan is past K1's longest; every NN block
    # (4,096 query tiles) takes K3 by the route and K4 when forced; seq-04's
    # single short chunk takes K1 and K3.
    required = [f"scan_tiled/{op}" for op in scan.OPS] + ["nn_keep", "nn_resident", "nn_grid", "ransac_counts"]
    missing = [k for k in required if launches[k] <= 0]
    if missing:
        raise AssertionError(f"kernels not launched on the chunked path: {missing}")
    missing = [k for k in ("nn_keep", "nn_resident", "ransac_counts") if launches04[k] <= 0]
    if not any(v for k, v in launches04.items() if k.startswith("scan_block/")):
        missing.append("scan_block")
    if missing:
        raise AssertionError(f"kernels not launched on the chunked seq-04 run: {missing}")
    return launches


def faulty_gnss(gt, gp, st, seed: int, fraction: float, outage_s: float = 8.0):
    """Dirty GNSS from a clean track, by the port's ``utils.faults`` from a
    fixed seed: ``fraction`` of the fixes teleported by ~30 m (gross
    outliers) and one outage of ``outage_s`` seconds at 0.6 of the SLAM
    span (past the Sim(3) window). Returns (positions, valid, outlier)."""
    from gps_optimize_slam_tpu_torch.utils import faults

    bad, outlier = faults.inject_gross_outliers(gp, fraction=fraction, magnitude=30.0, seed=seed)
    start = st[0] + 0.6 * (st[-1] - st[0])
    valid = faults.inject_outages(np.ones(len(gt), bool), [(start, start + outage_s)], gt)
    return bad, valid, outlier & valid


def poses_at_fixes(st, gt, which, within: float = 0.06):
    """Index of the SLAM pose nearest in time to each GNSS fix of the mask
    ``which`` that has a pose within ``within`` seconds (half a fix
    interval and a little: the replicas' seams hold fixes and no poses)."""
    t = gt[which]
    t = t[(t >= st[0]) & (t <= st[-1])]
    right = np.clip(np.searchsorted(st, t), 1, len(st) - 1)
    nearest = np.where(t - st[right - 1] <= st[right] - t, right - 1, right)
    return nearest[np.abs(st[nearest] - t) <= within]


def timed_s(fn):
    """Wall seconds of ``fn()``, synchronised before and after, and its
    result."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0, out


def counted(fn):
    """(result, launch counts) of ``fn()`` alone: the counts are set to 0
    just before it and read just after."""
    import torch

    reset_launch_counts()
    out = fn()
    torch.cuda.synchronize()
    return out, launch_counts()


def eval_rel(a, b) -> float:
    """Largest relative difference over every statistic of two evaluations."""
    parts = ("nn_slam", "nn_sim3", "nn_ekf", "ate_sim3", "ate_ekf")
    stats = ("mean", "median", "rmse", "max", "count")
    return max(rel_diff(float(getattr(getattr(a, p), f)), float(getattr(getattr(b, p), f)))
               for p in parts for f in stats)


ROBUST_PASSES = 16  # cap of the gate iteration in phase 6; neighbouring outliers mask each other for a few passes
OFFSET_SHIFT_S = 1.7  # phase 6 moves the GNSS clock by this much


def phase6_in_core(device):
    """Robust fusion, ground truth, offsets and adaptive stopping at 4,661
    poses, float64 on the card. Returns the launch counts of its main-path
    runs, one dict a run."""
    import torch

    from gps_optimize_slam_tpu_torch import pipeline
    from gps_optimize_slam_tpu_torch.config import FusionConfig, Sim3RansacConfig
    from gps_optimize_slam_tpu_torch.models import fusion, fusion_chunked, robust
    from gps_optimize_slam_tpu_torch.ops import alignment, kernels, ransac
    from gps_optimize_slam_tpu_torch.ops.kalman import ekf_params

    f64 = torch.float64
    slam, gt, gp = replica_sequence(SEQ02_LEN)
    st, sp = slam["timestamps"], slam["positions"]
    bad, valid, outlier = faulty_gnss(gt, gp, st, seed=6, fraction=0.01)

    def gps_data(positions, ok, times=gt):
        return pipeline.GPSData(timestamps=times, positions=positions, valid=ok, frame="enu",
                                utm_zone=32, utm_south=False)

    tt, tp = independent_track(gt, gp, int(0.85 * len(gt)), seed=9)
    track = gps_data(tp, np.ones(len(tt), bool), tt)
    # The same draws on the card and on the CPU: indices into the first
    # 1,500 poses of the Sim(3) window (180 s of poses at 10 Hz).
    draws = torch.randint(0, 1500, (1000, 4), generator=torch.Generator().manual_seed(0))

    def run(dev, gps, **kw):
        return pipeline.fuse_arrays(slam, gps, dtype=f64, device=dev, sim3_draws=draws,
                                    robust_iterations=ROBUST_PASSES, **kw)

    dirty = gps_data(bad, valid)
    clean = run(device, gps_data(gp, np.ones(len(gt), bool)))
    ungated = run(device, dirty)
    par, n_par = counted(lambda: run(device, dirty, robust=True, robust_gate_mode="parallel", gt=track))
    seq, n_seq = counted(lambda: run(device, dirty, robust=True, robust_gate_mode="sequential"))
    cpu = run("cpu", dirty, robust=True, robust_gate_mode="parallel")

    # fuse_core's own fusion and the robust one's final fusion take a
    # quaternion chain each; every other one is a gate pass. A gate that
    # stops short of its cap stopped because a pass changed nothing: the
    # fixed point (``gate_converged``).
    passes = {"parallel": n_par["scan_block/quat_chain"] - 2, "sequential": n_seq["scan_block/quat_chain"] - 2}
    at_outliers = poses_at_fixes(st, gt, outlier)
    err = {name: float(np.abs(r.corrected_pos - clean.corrected_pos).max())
           for name, r in (("gated", par), ("ungated", ungated))}
    seq_par = float(np.abs(seq.corrected_pos - par.corrected_pos).max())
    card_cpu = float(np.abs(par.corrected_pos - cpu.corrected_pos).max())

    # One gate pass of each form at the fixed point, warm.
    o = par.outputs
    dev_t = lambda a: torch.as_tensor(np.asarray(a), dtype=f64, device=device)  # noqa: E731
    acc = torch.as_tensor(par.robust_accepted, device=device)
    avail = o.gps_valid & ~torch.isnan(o.aligned_gps).any(-1)
    gate_args = (dev_t(st), dev_t(sp), dev_t(slam["quaternions"]), o.sim3_pos[0], o.sim3_quat[0],
                 o.aligned_gps, avail, acc, ekf_params(par.config.ekf, dtype=f64, device=device),
                 robust.CHI2_3DOF_95)
    pass_ms = {}
    for name, fn in (("parallel", robust._parallel_nis), ("sequential", robust._gated_availability)):
        fn(*gate_args)
        pass_ms[name] = 1e3 * float(np.median([timed_s(lambda: fn(*gate_args))[0] for _ in range(5)]))
    say(f"gate pass at {SEQ02_LEN} poses, float64, warm wall: parallel {pass_ms['parallel']:.3f} ms, "
        f"sequential {pass_ms['sequential']:.3f} ms")

    # Ground truth: in core (K3) against chunked, 2,048-pose chunks.
    res = fusion_chunked.ChunkedFusionResult(
        corrected_pos=par.corrected_pos, corrected_quat=par.corrected_quat, sim3=o.sim3,
        aligned_gps=o.aligned_gps.cpu().numpy(), gps_valid=o.gps_valid.cpu().numpy(),
        num_inliers=int(o.sim3_inliers.sum()), ok=True)
    gt_ev, gt_al = fusion_chunked.evaluate_vs_track_chunked(
        st, sp, slam["quaternions"], res, tt, tp, cfg=par.config, chunk_size=2048, dtype=f64, device=device)
    gt_rel = eval_rel(gt_ev, par.gt_evaluation)
    al_valid = par.gt_aligned.valid.cpu().numpy()
    gt_al_err = float(np.abs(gt_al.aligned[al_valid] - par.gt_aligned.aligned.cpu().numpy()[al_valid]).max())

    # Offsets: the GNSS clock moved by a known amount; each estimator's
    # answer moves by minus that, to one cell of its grid.
    cells = {"xcorr": 0.05, "xcorr_device": float((st[-1] - st[0] + 20.0) / 4096)}
    offsets = {}
    for mode in cells:
        cfg = FusionConfig(offset_mode=mode)
        base = pipeline.estimate_offset(slam, gps_data(gp, np.ones(len(gt), bool)), cfg, dtype=f64, device=device)
        moved = pipeline.estimate_offset(slam, gps_data(gp, np.ones(len(gt), bool), gt + OFFSET_SHIFT_S), cfg,
                                         dtype=f64, device=device)
        offsets[mode] = {"unshifted_s": base, "shifted_s": moved, "cell_s": cells[mode]}

    # Adaptive stopping on the Sim(3) window of the clean sequence.
    al = alignment.align_gps_to_slam(dev_t(st), dev_t(gt), dev_t(gp), assume_sorted=True)
    window = alignment.sim3_window_mask(dev_t(st), al.valid, 5.0, 180.0, 4)
    dst = torch.nan_to_num(al.aligned, nan=0.0)
    fixed = ransac.sim3_ransac(dev_t(sp), dst, window, Sim3RansacConfig(), seed=0)
    adaptive, n_ada = counted(lambda: ransac.sim3_ransac(
        dev_t(sp), dst, window, Sim3RansacConfig(stop_probability=0.9999), seed=0))
    chunks = n_ada["ransac_counts"]
    ada = {"chunks_run": chunks, "chunks_max": 8, "same_mask": bool(torch.equal(adaptive.inlier_mask, fixed.inlier_mask)),
           "R_max_diff": float((adaptive.sim3.R - fixed.sim3.R).abs().max()),
           "scale_rel": rel_diff(float(adaptive.sim3.scale), float(fixed.sim3.scale)),
           "t_max_diff": float((adaptive.sim3.t - fixed.sim3.t).abs().max())}

    emit({"phase": 6, "part": "in core", "poses": SEQ02_LEN, "gnss": int(len(gt)), "dtype": "float64",
          "outliers": int(outlier.sum()), "outage_fixes": int((~valid).sum()),
          "gate_passes": passes, "gate_passes_cap": ROBUST_PASSES,
          "accepted": int(par.robust_accepted.sum()), "rejected": int((~par.robust_accepted & avail.cpu().numpy()).sum()),
          "max_err_to_clean_fusion_m": err, "sequential_vs_parallel_m": seq_par, "card_vs_cpu_m": card_cpu,
          "gate_pass_ms": pass_ms, "gt_chunked_vs_in_core": {"max_rel_err": gt_rel, "aligned_max_err_m": gt_al_err},
          "gt_rmse_ekf_m": float(par.gt_evaluation.nn_ekf.rmse), "offsets": offsets, "adaptive": ada,
          "launches": {"robust_parallel_gt": n_par, "robust_sequential": n_seq, "adaptive_ransac": n_ada}})
    if max(passes.values()) >= ROBUST_PASSES:
        raise AssertionError(f"a gate used all {ROBUST_PASSES} passes: no fixed point shown ({passes})")
    if not np.array_equal(seq.robust_accepted, par.robust_accepted) or not seq_par <= 1e-9:
        raise AssertionError(f"sequential and parallel gates differ at the fixed point: {seq_par:.3e} m")
    if par.robust_accepted[at_outliers].any():
        raise AssertionError("an injected outlier survived the gate")
    if not 5 * err["gated"] < err["ungated"]:
        raise AssertionError(f"the gate does not protect the trajectory: {err}")
    if not np.array_equal(par.robust_accepted, cpu.robust_accepted) or not card_cpu <= 1e-6:
        raise AssertionError(f"robust fusion on the card off the CPU run: {card_cpu:.3e} m")
    if n_par["scan_block/quat_chain"] < passes["parallel"] or n_par["scan_block/filter"] < passes["parallel"]:
        raise AssertionError(f"fewer K1 launches than gate passes: {n_par}")
    if not (gt_rel <= 1e-6 and gt_al_err <= 1e-6):
        raise AssertionError(f"ground truth, chunked off in-core: {gt_rel:.3e}, {gt_al_err:.3e} m")
    for mode, o_ in offsets.items():
        if abs(o_["shifted_s"] - o_["unshifted_s"] + OFFSET_SHIFT_S) > o_["cell_s"] + 1e-9:
            raise AssertionError(f"{mode} did not recover the shift: {o_}")
    if abs(offsets["xcorr"]["shifted_s"] - offsets["xcorr_device"]["shifted_s"]) > max(cells.values()) + 1e-9:
        raise AssertionError(f"the two offset estimators disagree: {offsets}")
    if not (1 <= chunks < 8 and bool(adaptive.ok) and ada["R_max_diff"] <= 5e-3 and ada["scale_rel"] <= 1e-3
            and ada["t_max_diff"] <= 0.2):
        raise AssertionError(f"adaptive stopping: {ada}")
    required = [f"scan_block/{op}" for op in ("quat_chain", "filter", "rts", "add2", "max3", "min3", "mobius", "affine3")]
    missing = [k for k in required + ["nn_keep", "nn_resident", "ransac_counts"] if n_par[k] <= 0]
    if missing or n_par["nn_resident"] < 6:
        raise AssertionError(f"robust + ground truth in core: kernels not launched: {missing}, {n_par}")
    return [n_par, n_seq, n_ada]


def phase6_chunked(device):
    """Robust fusion and the ground-truth evaluation out of core at
    1,048,576 poses, float64 on the card, against the in-core functions on
    the same arrays and draws."""
    import torch

    from gps_optimize_slam_tpu_torch.config import FusionConfig
    from gps_optimize_slam_tpu_torch.models import fusion, fusion_chunked, robust

    f64 = torch.float64
    slam, gt, gp = outage_sequence(CHUNKED_N)
    st, sp, sq = slam["timestamps"], slam["positions"], slam["quaternions"]
    gp, gv, outlier = faulty_gnss(gt, gp, st, seed=7, fraction=0.005)
    cfg = FusionConfig(gps_sorted=True)
    tt, tp = independent_track(gt, gp, int(0.85 * len(gt)), seed=10)

    def dev(a, dt=f64):
        return torch.as_tensor(a, device=device).to(dt)

    def fuse():
        return fusion_chunked.fuse_core_chunked(
            st, sp, sq, gt, gp, gv, seed=0, config=cfg, chunk_size=CHUNK, dtype=f64, robust=True,
            robust_iterations=ROBUST_PASSES, device=device)

    res, n_fuse = counted(fuse)
    fuse_s, _ = timed_s(fuse)
    # Two chunks: each gate pass and the final fusion take two quaternion chains.
    passes = n_fuse["scan_tiled/quat_chain"] // 2 - 1
    say(f"fuse_core_chunked(robust=True) at {CHUNKED_N} poses, {CHUNK}-pose chunks, float64, warm wall: "
        f"{fuse_s:.3f} s with {passes} gate passes")
    (gt_ev, gt_al), n_gt = counted(lambda: fusion_chunked.evaluate_vs_track_chunked(
        st, sp, sq, res, tt, tp, cfg=cfg, chunk_size=CHUNK, dtype=f64, device=device))
    # The scores of the fixed point: one more pass with the final mask.
    avail = res.gps_valid & ~np.isnan(res.aligned_gps).any(-1)
    p0, q0 = fusion_chunked.transform_trajectory_chunked(sp[:1], sq[:1], res.sim3, dtype=f64, device=device)
    pass_s, (_, nis) = timed_s(lambda: robust.gated_availability_chunked(
        st, sp, sq, p0[0], q0[0], res.aligned_gps, avail, res.robust_accepted, cfg.ekf, chunk_size=CHUNK,
        dtype=f64, device=device))
    say(f"chunked gate pass at {CHUNKED_N} poses, float64, warm wall: {pass_s:.3f} s")

    ref = fusion.fuse_core(dev(st), dev(sp), dev(sq), dev(gt), dev(gp), dev(gv, torch.bool), cfg, seed=0)
    rres = robust.fuse_robust(dev(st), dev(sp), dev(sq), ref.sim3_pos, ref.sim3_quat, ref.aligned_gps,
                              ref.gps_valid, cfg.ekf, cfg.rts_decision, n_iterations=ROBUST_PASSES,
                              gate_mode="parallel")
    ref = ref._replace(corrected_pos=rres.positions, corrected_quat=rres.quaternions)
    ref_ev, ref_al = fusion.evaluate_vs_track(dev(st), dev(sp), ref, dev(tt), dev(tp),
                                              torch.ones(len(tt), dtype=torch.bool, device=device), cfg=cfg)
    same_mask = bool(np.array_equal(res.robust_accepted, rres.accepted.cpu().numpy()))
    pos_err = float(np.abs(res.corrected_pos - rres.positions.cpu().numpy()).max())
    quat_err = float(np.abs(res.corrected_quat - rres.quaternions.cpu().numpy()).max())
    ref_nis = rres.nis.cpu().numpy()
    nis_rel = float((np.abs(nis - ref_nis) / np.maximum(np.abs(ref_nis), 1e-9)).max())
    gt_rel = eval_rel(gt_ev, ref_ev)
    al_valid = ref_al.valid.cpu().numpy()
    al_same = bool(np.array_equal(gt_al.valid, al_valid))
    gt_al_err = float(np.abs(gt_al.aligned[al_valid] - ref_al.aligned.cpu().numpy()[al_valid]).max())
    survived = int(res.robust_accepted[poses_at_fixes(st, gt, outlier)].sum())

    emit({"phase": 6, "part": "out of core", "poses": CHUNKED_N, "gnss": int(len(gt)), "chunk": CHUNK,
          "dtype": "float64", "outliers": int(outlier.sum()), "gate_passes": passes,
          "gate_converged_in_core": bool(rres.gate_converged),
          "accepted": int(res.robust_accepted.sum()), "rejected": int((~res.robust_accepted & avail).sum()),
          "outliers_survived": survived, "robust_chunked_fuse_warm_s": fuse_s,
          "chunked_gate_pass_warm_s": pass_s,
          "chunked_vs_incore": {"same_mask": same_mask, "corrected_pos_max_err_m": pos_err,
                                "corrected_quat_max_err": quat_err, "nis_max_rel_err": nis_rel},
          "gt_chunked_vs_in_core": {"max_rel_err": gt_rel, "same_valid": al_same, "aligned_max_err_m": gt_al_err},
          "gt_rmse_ekf_m": float(gt_ev.nn_ekf.rmse),
          "launches": {"robust_chunked": n_fuse, "gt_chunked": n_gt}})
    if not (res.ok and bool(ref.ok)) or passes >= ROBUST_PASSES or not rres.gate_converged:
        raise AssertionError(f"robust chunked: Sim3 failed or no fixed point in {ROBUST_PASSES} passes ({passes})")
    if not (same_mask and pos_err <= 1e-6 and quat_err <= 1e-8 and nis_rel <= 1e-6):
        raise AssertionError(f"robust chunked off in-core: mask {same_mask}, {pos_err:.3e} m, quat "
                             f"{quat_err:.3e}, NIS {nis_rel:.3e}")
    if survived:
        raise AssertionError(f"{survived} injected outliers survived the chunked gate")
    if not (al_same and gt_rel <= 1e-6 and gt_al_err <= 1e-6):
        raise AssertionError(f"ground truth, chunked off in-core: {gt_rel:.3e}, {gt_al_err:.3e} m")
    k1 = {k: v for k, v in n_fuse.items() if k.startswith("scan_block/") and v}
    missing = [k for k in ("scan_tiled/quat_chain", "scan_tiled/filter", "scan_tiled/rts", "ransac_counts")
               if n_fuse[k] <= 0]
    if k1 or missing or n_fuse["scan_tiled/filter"] < 2 * (passes + 1):
        raise AssertionError(f"robust chunked: K1 launched {k1}, K2 missing {missing}, {n_fuse}")
    # Its 524,288 x 524,288 NN blocks take K3 by the route (4,096 query tiles).
    if n_gt["nn_resident"] <= 0 or n_gt["nn_keep"] <= 0 or n_gt["nn_grid"]:
        raise AssertionError(f"chunked ground truth off the K3 route: {n_gt}")
    return [n_fuse, n_gt]


def phase6_command():
    """``python3 -m gps_optimize_slam_tpu_torch fuse ... --robust --gt ...
    --json``, in core and with ``--chunked``, as subprocesses on the seq-04
    files; a non-zero exit or output that is no JSON object fails."""
    rows = {}
    with tempfile.TemporaryDirectory() as tmp:
        slam_path, gps_path = write_seq04_files(tmp)
        gt_path = write_seq04_gt_file(tmp)
        for name, extra in (("fuse", []), ("fuse --chunked", ["--chunked", "--chunk-size", "128"])):
            t0 = time.perf_counter()
            proc = subprocess.run(
                [sys.executable, "-m", "gps_optimize_slam_tpu_torch", "fuse", slam_path, gps_path, "--gt", gt_path,
                 "--robust", "--json"] + extra,
                cwd=REPO, capture_output=True, text=True, timeout=300, env={**os.environ, "PYTHONPATH": REPO})
            if proc.returncode != 0:
                raise AssertionError(f"{name}: exit code {proc.returncode}\n{proc.stderr[-2000:]}")
            out = json.loads(proc.stdout)
            keys = ["poses", "gps_kept", "sim3_scale", "time_offset_s", "nn_vs_primary", "ate_vs_primary",
                    "robust_accepted", "robust_rejected", "nn_vs_ground_truth", "ate_vs_ground_truth"]
            missing = [k for k in keys if k not in out]
            if missing or out["poses"] != 271 or abs(out["nn_vs_primary"]["ekf"]["rmse_m"] - 0.0839) > 2e-3:
                raise AssertionError(f"{name}: keys missing {missing} or values off: {proc.stdout[:600]}")
            rows[name] = {"wall_s": time.perf_counter() - t0, "sim3_scale": out["sim3_scale"],
                          "robust_accepted": out["robust_accepted"],
                          "rmse_ekf_vs_gt_m": out["nn_vs_ground_truth"]["ekf"]["rmse_m"]}
    emit({"phase": 6, "part": "command", "runs": rows})


def phase6(device):
    """This slice's path at full size: the robust gate in core and out of
    core, the ground-truth evaluation, the offsets, adaptive stopping and
    the command. Returns the launch counts of its main-path runs, summed."""
    runs = phase6_in_core(device) + phase6_chunked(device)
    phase6_command()
    return {k: sum(r[k] for r in runs) for k in runs[0]}


def kitti_sequences():
    """The eleven KITTI odometry sequences with ground truth, 00-10, at their
    lengths (``KITTI_LENGTHS``): seq-04 is the golden arrays, the others
    ``replica_sequence`` at their lengths with distinct seeds. Every row's
    GNSS is in a local frame, seq-04's its UTM track minus its first fix
    (returned as the fourth item, else None): at a 5.4e6 m northing one
    float64 ulp is 9.3e-10 m, so a 1e-9 m comparison of two summation
    orders would measure the frame, not the arithmetic. Returns
    [(slam, gps_times, gps_positions, origin)]."""
    g, slam04 = golden_arrays()
    origin = g["gps_utm"][0]
    return [(slam04, g["gps_times"], g["gps_utm"] - origin, origin) if i == 4
            else replica_sequence(n, seed=100 + i) + (None,) for i, n in enumerate(KITTI_LENGTHS)]


def phase7_kitti(device):
    """The eleven KITTI sequences, float64, ``bucket_by_length(max_waste=2.0)``
    (3 buckets), through ``fuse_buckets`` and, bucket by bucket, through
    ``fuse_batch`` + ``evaluate_batch`` (the counted main path). Returns the
    launch counts of that run."""
    import torch

    from gps_optimize_slam_tpu_torch.config import FusionConfig
    from gps_optimize_slam_tpu_torch.models import fusion
    from gps_optimize_slam_tpu_torch.ops import scan
    from gps_optimize_slam_tpu_torch.parallel import batch as pbatch
    from gps_optimize_slam_tpu_torch.parallel import mesh

    f64, cfg = torch.float64, FusionConfig()
    g, _ = golden_arrays()
    seqs = kitti_sequences()
    slams, gts, gps = [s for s, _, _, _ in seqs], [t for _, t, _, _ in seqs], [p for _, _, p, _ in seqs]
    buckets = pbatch.bucket_by_length(slams, gts, gps, max_waste=2.0)
    seeds = list(range(len(seqs)))

    def dev(a, dt=f64):
        return torch.as_tensor(np.asarray(a), device=device).to(dt)

    def single(i):
        s = slams[i]
        out = fusion.fuse_core(dev(s["timestamps"]), dev(s["positions"]), dev(s["quaternions"]), dev(gts[i]),
                               dev(gps[i]), dev(np.ones(len(gts[i]), bool), torch.bool),
                               cfg.replace(gps_sorted=True), seed=i)
        return out, fusion.evaluate(dev(s["timestamps"]), dev(s["positions"]), out)

    def bucket(idxs, b):
        out = mesh.fuse_batch(b, [seeds[i] for i in idxs], config=cfg, device=device, dtype=f64)
        return out, mesh.evaluate_batch(b, out)

    # The main path, bucket by bucket, each counted alone, beside one
    # single-row fusion + evaluation of the bucket's first sequence.
    total, per_bucket, outs = {}, [], []
    for idxs, b in buckets:
        (out, ev), n_b = counted(lambda: bucket(idxs, b))
        _, n_1 = counted(lambda: single(int(idxs[0])))
        per_bucket.append({"rows": len(idxs), "padded_poses": int(b.slam_times.shape[1]), "launches": n_b,
                           "single_row_launches": n_1})
        outs.append((idxs, b, out, ev))
        total = {k: total.get(k, 0) + v for k, v in n_b.items()}
    res = mesh.fuse_buckets(buckets, seeds, config=cfg, device=device, dtype=f64)

    pos_err, eval_err, masks_equal, ok = 0.0, 0.0, True, True
    for idxs, b, out, ev in outs:
        for row, i in enumerate(idxs):
            i, n = int(i), int(b.n_slam[row])
            one, one_ev = single(i)
            pos_err = max(pos_err, float((out.corrected_pos[row, :n] - one.corrected_pos).abs().max()),
                          float(np.abs(res[i].corrected_pos - one.corrected_pos.cpu().numpy()).max()))
            masks_equal &= bool(torch.equal(out.sim3_inliers[row, :n], one.sim3_inliers)
                                and torch.equal(out.gps_valid[row, :n], one.gps_valid))
            ok &= bool(out.ok[row]) and bool(one.ok)
            for p_ in ("nn_slam", "nn_sim3", "nn_ekf", "ate_sim3", "ate_ekf"):
                for f in ("mean", "median", "rmse", "max", "count"):
                    eval_err = max(eval_err, rel_diff(float(getattr(getattr(ev, p_), f)[row]),
                                                      float(getattr(getattr(one_ev, p_), f))))
    golden_err = float(np.abs(res[4].corrected_pos + seqs[4][3] - g["corrected_pos"]).max())

    def loop():
        return [single(i)[0] for i in range(len(seqs))]

    walls = {"fuse_buckets": [], "row_loop": []}
    for _ in range(3):
        for name, fn in (("fuse_buckets", lambda: mesh.fuse_buckets(buckets, seeds, config=cfg, device=device,
                                                                     dtype=f64)),
                         ("row_loop", lambda: [o.corrected_pos.cpu() for o in loop()])):
            walls[name].append(1e3 * timed_s(fn)[0])
    emit({"phase": 7, "part": "kitti", "sequences": len(seqs), "poses": list(KITTI_LENGTHS), "dtype": "float64",
          "buckets": per_bucket, "row_vs_single_max_err_m": pos_err, "masks_equal": masks_equal,
          "evaluate_vs_single_max_rel_err": eval_err, "seq04_vs_golden_m": golden_err,
          "fuse_buckets_warm_ms": walls["fuse_buckets"], "row_loop_warm_ms": walls["row_loop"],
          "launches": total})
    if len(buckets) != 3 or not ok:
        raise AssertionError(f"phase 7: {len(buckets)} buckets (3 expected) or a failed alignment")
    if not (golden_err <= 1e-6 and pos_err <= 1e-9 and masks_equal and eval_err <= 1e-9):
        raise AssertionError(f"phase 7: golden {golden_err:.3e} m, rows {pos_err:.3e} m, masks {masks_equal}, "
                             f"evaluation {eval_err:.3e}")
    for bk in per_bucket:
        if bk["launches"] != bk["single_row_launches"]:
            raise AssertionError(f"phase 7: a bucket launched otherwise than one row: {bk}")
    want = {f"scan_block/{op}": 1 for op in scan.OPS}
    # affine3: the alignment's two; max3, min3: the alignment's and the
    # filter controls'.
    want.update({"scan_block/affine3": 2, "scan_block/max3": 2, "scan_block/min3": 2, "nn_keep": 3,
                 "nn_resident": 3, "ransac_counts": 1})
    got = {k: v for k, v in per_bucket[0]["launches"].items() if v}
    if got != want:
        raise AssertionError(f"phase 7: a bucket's launches {got}, expected {want}")
    return total


def phase7_fleet(device):
    """The fleet bucket: 64 sequences of seq-02's length (``replica_sequence``
    with distinct seeds), float32, one ``fuse_batch``: warm wall, sequences
    per second, the device's idle share, peak memory, and the loop of
    single-row ``fuse_core`` over the rows in the same run; rows 0 and 63
    against their single-row fusion (float32, the bound of phase 4)."""
    import torch

    from gps_optimize_slam_tpu_torch.config import FusionConfig
    from gps_optimize_slam_tpu_torch.models import fusion
    from gps_optimize_slam_tpu_torch.parallel import batch as pbatch
    from gps_optimize_slam_tpu_torch.parallel import mesh

    f32, cfg = torch.float32, FusionConfig(gps_sorted=True)
    B, n = FLEET
    seqs = [replica_sequence(n, seed=200 + i) for i in range(B)]
    b = pbatch.pad_batch([s for s, _, _ in seqs], [t for _, t, _ in seqs], [p for _, _, p in seqs])
    staged = mesh.stage_batch(b, device=device, dtype=f32)

    def fuse():
        return mesh.fuse_batch(staged, config=cfg)

    def dev(a, dt=f32):
        return torch.as_tensor(np.asarray(a), device=device).to(dt)

    rows = [[dev(a) for a in (s["timestamps"], s["positions"], s["quaternions"], t, p)]
            + [dev(np.ones(len(t), bool), torch.bool)] for s, t, p in seqs]

    def loop():
        return [fusion.fuse_core(*r, cfg, seed=i).corrected_pos for i, r in enumerate(rows)]

    out, launches = counted(fuse)
    torch.cuda.reset_peak_memory_stats()
    walls = {"batch": [], "row_loop": []}
    for _ in range(3):
        walls["batch"].append(1e3 * timed_s(fuse)[0])
        walls["row_loop"].append(1e3 * timed_s(loop)[0])
    peak = torch.cuda.max_memory_allocated()
    prof = profile_device(fuse)
    errs = [float((out.corrected_pos[i, :n] - fusion.fuse_core(*rows[i], cfg, seed=i).corrected_pos).abs().max())
            for i in (0, B - 1)]
    wall = float(np.median(walls["batch"]))
    emit({"phase": 7, "part": "fleet", "rows": B, "poses": n, "dtype": "float32", "ok": bool(out.ok.all()),
          "batch_warm_ms": walls["batch"], "row_loop_warm_ms": walls["row_loop"],
          "sequences_per_s": B / (wall / 1e3), "loop_over_batch": float(np.median(walls["row_loop"])) / wall,
          "max_memory_allocated_mb": peak / 2**20, "profile": prof, "rows_vs_single_m": errs,
          "launches": launches})
    if not bool(out.ok.all()) or not bool(torch.isfinite(out.corrected_pos).all()) or not max(errs) <= 1e-2:
        raise AssertionError(f"phase 7 fleet: ok {bool(out.ok.all())}, rows off their single fusion by {errs} m")
    return launches


def phase7_command():
    """``python3 -m gps_optimize_slam_tpu_torch fuse-batch ... --json`` on two
    pairs of seq-04 files as a subprocess; a non-zero exit, other keys, or
    values off the seq-04 fusion fail."""
    with tempfile.TemporaryDirectory() as tmp:
        pair = ":".join(write_seq04_files(tmp))
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-m", "gps_optimize_slam_tpu_torch", "fuse-batch", pair, pair, "--json",
                               "-o", os.path.join(tmp, "out")],
                              cwd=REPO, capture_output=True, text=True, timeout=300,
                              env={**os.environ, "PYTHONPATH": REPO})
        wall = time.perf_counter() - t0
        if proc.returncode != 0:
            raise AssertionError(f"fuse-batch: exit code {proc.returncode}\n{proc.stderr[-2000:]}")
        out = json.loads(proc.stdout)
        keys = ["slam", "poses", "ok", "sim3_scale", "ate_rmse_m", "ate_mean_m", "eval_points", "output"]
        rows = out["sequences"]
        if (list(out) != ["sequences", "buckets"] or out["buckets"] != 1 or len(rows) != 2
                or any(list(r) != keys or r["poses"] != 271 or not r["ok"] or abs(r["ate_rmse_m"] - 0.0839) > 2e-3
                       or np.loadtxt(r["output"]).shape != (271, 8) for r in rows)):
            raise AssertionError(f"fuse-batch: keys or values off: {proc.stdout[:800]}")
    emit({"phase": 7, "part": "command", "wall_s": wall, "sim3_scale": rows[0]["sim3_scale"],
          "ate_rmse_m": rows[0]["ate_rmse_m"]})


def phase7(device):
    """Batched multi-sequence fusion: the eleven KITTI sequences in three
    length buckets, the fleet bucket, and the ``fuse-batch`` command.
    Returns the launch counts of its main-path runs, summed."""
    runs = [phase7_kitti(device), phase7_fleet(device)]
    phase7_command()
    return {k: sum(r[k] for r in runs) for k in runs[0]}


SHUTTLE_N = 4541  # KITTI odometry seq-00's poses, the longest of the loop sequences (00, 05, 06, 07, 09)
SHUTTLE_OUTAGE_LEG = 3  # a backward leg with no GNSS at all
REFINE = dict(iterations=10, cg_iters=50, propose_loops=True, loop_radius=5.0, loop_min_time_gap=30.0, max_loops=32)


def shuttle_sequence(n: int = SHUTTLE_N, seed: int = 0):
    """A real-derived shuttle of ``n`` poses: legs of the seq-04 golden arrays
    alternately forward and backward over the same road. A backward leg is
    the forward leg's SLAM and GNSS arrays in reverse time order, re-timed
    to follow on (one time map for both streams, so they stay aligned); every
    leg reuses the same SLAM coordinates, so one Sim(3) fits them all. Each
    leg's GNSS carries 2 cm of fresh noise from ``seed`` and lies in a local
    frame (UTM minus the first fix); leg ``SHUTTLE_OUTAGE_LEG`` has none, an
    outage the loop closures carry. A return leg passes its forward twins
    within centimetres and more than 30 s later for most of its length: the
    revisits ``propose_loop_closures`` finds."""
    g, _ = golden_arrays()
    st0, sp0, sq0 = g["slam_times"], g["slam_pos"], g["slam_quat"]
    gt0, gp0 = g["gps_times"], g["gps_utm"] - g["gps_utm"][0]
    start, end = min(st0[0], gt0[0]), max(st0[-1], gt0[-1])
    period = end - start + 2.0
    rng = np.random.default_rng(seed)
    st, sp, sq, gt, gp = [], [], [], [], []
    for k in range(-(-n // len(st0))):
        back = k % 2 == 1
        remap = (lambda t: end - t[::-1]) if back else (lambda t: t - start)
        flip = (lambda a: a[::-1]) if back else (lambda a: a)
        st.append(remap(st0) + k * period)
        sp.append(flip(sp0))
        sq.append(flip(sq0))
        if k != SHUTTLE_OUTAGE_LEG:
            gt.append(remap(gt0) + k * period)
            gp.append(flip(gp0) + rng.normal(size=gp0.shape) * 0.02)
    st, sp, sq = (np.concatenate(a)[:n] for a in (st, sp, sq))
    gt, gp = np.concatenate(gt), np.concatenate(gp)
    keep = gt <= st[-1] + 2.0
    return {"timestamps": st, "positions": sp, "quaternions": sq}, gt[keep], gp[keep]


def shuttle_gps(gt, gp):
    from gps_optimize_slam_tpu_torch import pipeline

    return pipeline.GPSData(timestamps=gt, positions=gp, valid=np.ones(len(gt), bool), frame="enu", utm_zone=32,
                            utm_south=False)


def refine_gaps(gn, info, ref, ref_info) -> dict:
    """The refinement against a reference run: positions (m), quaternions,
    the cost history (relative), and whether the valid closures agree."""
    a, b = gn.cost_history.cpu().double(), ref.cost_history.cpu().double()
    return {"positions_m": float((gn.state.positions.cpu() - ref.state.positions.cpu()).abs().max()),
            "quaternions": float((gn.state.quaternions.cpu() - ref.state.quaternions.cpu()).abs().max()),
            "cost_history_rel": float(((a - b).abs() / b.abs()).max()),
            "loop_ij_equal": info["loop_ij"] == ref_info["loop_ij"]}


def phase8_refine(device):
    """The pose-graph path at KITTI seq-00's length: ``fuse_arrays`` then
    ``refine_pose_graph`` (10 Gauss-Newton steps of 50 CG iterations,
    closures proposed, checkpointed) on the shuttle, float64, on the card;
    launch counts of the pair; held against the port's own CPU float64 run
    of the same arrays (positions ≤1e-6 m, quaternions ≤1e-8, cost history
    ≤1e-9 relative, the valid closures equal); a run stopped after 5 of the
    10 steps and resumed from its checkpoint equal to the uninterrupted card
    run bit for bit; warm walls, the refine's profile, peak memory and the
    proposal's share of the refine's wall."""
    import torch

    from gps_optimize_slam_tpu_torch import pipeline
    from gps_optimize_slam_tpu_torch.models import pose_graph

    slam, gt, gp = shuttle_sequence()
    gps = shuttle_gps(gt, gp)
    with tempfile.TemporaryDirectory() as tmp:
        def fuse_refine(dev, ckpt, **kw):
            res = pipeline.fuse_arrays(slam, gps, dtype=torch.float64, device=dev)
            return res, pipeline.refine_pose_graph(res, **{**REFINE, "checkpoint_dir": ckpt, **kw})

        (res, (gn, info)), launches = counted(lambda: fuse_refine(device, os.path.join(tmp, "card")))
        t0 = time.perf_counter()
        res_cpu, (gn_cpu, info_cpu) = fuse_refine("cpu", os.path.join(tmp, "cpu"))
        cpu_s = time.perf_counter() - t0
        stopped = os.path.join(tmp, "stopped")
        pipeline.refine_pose_graph(res, **{**REFINE, "checkpoint_dir": stopped, "iterations": 5})
        gn_resumed, _ = pipeline.refine_pose_graph(res, **{**REFINE, "checkpoint_dir": stopped})
    resumed_equal = all(torch.equal(a, b) for a, b in zip(gn_resumed.state, gn.state)) and torch.equal(
        gn_resumed.cost_history, gn.cost_history)
    gaps = refine_gaps(gn, info, gn_cpu, info_cpu)
    fuse_gap = float((res.outputs.corrected_pos.cpu() - res_cpu.outputs.corrected_pos).abs().max())

    walls = {"fuse": [], "refine": []}
    for _ in range(3):
        s, r = timed_s(lambda: pipeline.fuse_arrays(slam, gps, dtype=torch.float64, device=device))
        walls["fuse"].append(1e3 * s)
        walls["refine"].append(1e3 * timed_s(lambda: pipeline.refine_pose_graph(r, **REFINE))[0])
    times = torch.as_tensor(slam["timestamps"], device=device)
    o = res.outputs
    propose_ms = [1e3 * timed_s(lambda: pose_graph.propose_loop_closures(
        o.corrected_pos, times, o.sim3_quat, radius=5.0, min_time_gap=30.0, max_loops=32))[0] for _ in range(3)]
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    prof = profile_device(lambda: pipeline.refine_pose_graph(res, **REFINE), host_ops=False)
    peak = torch.cuda.max_memory_allocated() - base
    refine_ms = float(np.median(walls["refine"]))
    emit({"phase": 8, "part": "refine", "poses": SHUTTLE_N, "gnss": int(len(gt)), "dtype": "float64",
          "loops_proposed": info["n_loops"], "loop_pairs": info["loop_ij"][:8], "cost_history":
          gn.cost_history.tolist(), "card_vs_cpu": gaps, "fuse_card_vs_cpu_m": fuse_gap,
          "resumed_equal_bit_for_bit": resumed_equal, "launches": launches, "fuse_warm_ms": walls["fuse"],
          "refine_warm_ms": walls["refine"], "fuse_refine_warm_ms_median3": float(np.median(
              [a + b for a, b in zip(walls["fuse"], walls["refine"])])), "refine_warm_ms_median3": refine_ms,
          "cpu_fuse_refine_wall_ms": 1e3 * cpu_s, "propose_ms": propose_ms,
          "propose_share_of_refine": float(np.median(propose_ms)) / refine_ms, "refine_profile": prof,
          "refine_peak_memory_mb": peak / 2**20})
    say(f"phase 8: {info['n_loops']} loop closures proposed on the {SHUTTLE_N}-pose shuttle")
    if info["n_loops"] < 1:
        raise AssertionError("phase 8: no loop closure proposed on the shuttle")
    if not (gaps["positions_m"] <= 1e-6 and gaps["quaternions"] <= 1e-8 and gaps["cost_history_rel"] <= 1e-9
            and gaps["loop_ij_equal"]):
        raise AssertionError(f"phase 8: the card's refinement off the CPU's: {gaps}")
    if not resumed_equal:
        raise AssertionError("phase 8: the resumed refinement differs from the uninterrupted one")
    if not float(gn.final_cost) < float(gn.cost_history[0]) or not bool(torch.isfinite(gn.state.positions).all()):
        raise AssertionError(f"phase 8: the refinement did not lower the cost: {gn.cost_history.tolist()}")
    missing = [k for k in ("nn_keep", "nn_resident", "ransac_counts") if launches[k] <= 0]
    missing += [] if any(launches[f"scan_block/{op}"] for op in ("quat_chain", "filter", "rts")) else ["scan_block"]
    if missing:
        raise AssertionError(f"phase 8: kernels not launched by fuse + refine: {missing}")
    return launches


def write_seq04_kitti_files(tmp: str):
    """A KITTI pose file (12 columns a row, the row-major [R|t]) and its
    timestamp file, from the seq-04 golden SLAM arrays."""
    _, slam = golden_arrays()
    x, y, z, w = slam["quaternions"].T
    R = np.stack([
        np.stack([1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)], -1),
        np.stack([2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)], -1),
        np.stack([2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)], -1),
    ], -2)
    poses = np.concatenate([R, slam["positions"][:, :, None]], axis=2).reshape(-1, 12)
    poses_path, times_path = os.path.join(tmp, "04.txt"), os.path.join(tmp, "times04.txt")
    np.savetxt(poses_path, poses, fmt="%.12e")
    np.savetxt(times_path, slam["timestamps"] - slam["timestamps"][0], fmt="%.6e")
    return poses_path, times_path


def phase8_commands():
    """``refine-graph --json`` on the seq-04 files and ``kitti2tum`` on a KITTI
    pose file written from the golden arrays, as subprocesses; a non-zero
    exit, other keys or values off fail."""
    env = {**os.environ, "PYTHONPATH": REPO}
    with tempfile.TemporaryDirectory() as tmp:
        slam_path, gps_path = write_seq04_files(tmp)
        out = os.path.join(tmp, "refined.tum")
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-m", "gps_optimize_slam_tpu_torch", "refine-graph", slam_path, gps_path,
                               "--json", "-o", out], cwd=REPO, capture_output=True, text=True, timeout=300, env=env)
        wall = time.perf_counter() - t0
        if proc.returncode != 0:
            raise AssertionError(f"refine-graph: exit code {proc.returncode}\n{proc.stderr[-2000:]}")
        rep = json.loads(proc.stdout[: proc.stdout.rindex("}") + 1])
        keys = ["poses", "gn_iterations", "initial_cost", "final_cost", "cost_reduction_pct", "loops_proposed",
                "loop_pairs", "ate_rmse_m"]
        if (list(rep) != keys or rep["poses"] != 271 or not rep["final_cost"] <= rep["initial_cost"]
                or rep["loops_proposed"] != 0 or np.loadtxt(out).shape != (271, 8)):
            raise AssertionError(f"refine-graph: keys or values off: {proc.stdout[:800]}")
        poses_path, times_path = write_seq04_kitti_files(tmp)
        tum = os.path.join(tmp, "kitti04.tum")
        proc = subprocess.run([sys.executable, "-m", "gps_optimize_slam_tpu_torch", "kitti2tum", poses_path,
                               times_path, tum], cwd=REPO, capture_output=True, text=True, timeout=120, env=env)
        back = np.loadtxt(tum) if proc.returncode == 0 else None
        g, _ = golden_arrays()
        if back is None or back.shape != (271, 8) or not np.abs(back[:, 1:4] - g["slam_pos"]).max() <= 1e-6:
            raise AssertionError(f"kitti2tum: exit code {proc.returncode}\n{proc.stderr[-2000:]}")
    emit({"phase": 8, "part": "command", "refine_graph_wall_s": wall, "initial_cost": rep["initial_cost"],
          "final_cost": rep["final_cost"], "ate_rmse_m": rep["ate_rmse_m"], "kitti2tum_rows": int(back.shape[0])})


def phase8(device):
    """The pose-graph refinement path: the shuttle, fused and refined on the
    card, and the ``refine-graph`` and ``kitti2tum`` commands. Returns the
    launch counts of its main-path run."""
    launches = phase8_refine(device)
    phase8_commands()
    return launches


SEQPAR_BLOCKS = 4  # phase 9's sequence-parallel mesh: four blocks sharing the card (or spread over the cards)
SEQPAR_CHUNK = 524_287  # (c)'s chunks: 524,288 scan elements with the carry, blocks of 131,072 (K2)
MESH_SHARDS = 3  # (d)'s mesh: the eleven KITTI rows padded to twelve
# (e)'s runs of the distributed example: two gloo ranks sharing the card (NCCL
# refuses two ranks on one card), then a one-rank NCCL group.
DISTRIBUTED_RUNS = ((2, "gloo"), (1, "nccl"))


def card_name() -> str:
    import torch

    return f"cuda:{torch.cuda.current_device()}"


def card_mesh(k: int):
    """A mesh of ``k`` blocks on the current card."""
    from gps_optimize_slam_tpu_torch.parallel.mesh import make_mesh

    return make_mesh(devices=[card_name()] * k)


def cards_mesh(k: int):
    """A mesh of ``k`` blocks dealt over every card, block i on card i mod
    the card count."""
    import torch

    from gps_optimize_slam_tpu_torch.parallel.mesh import make_mesh

    return make_mesh(devices=[f"cuda:{i % torch.cuda.device_count()}" for i in range(k)])


def no_host_sync(fn):
    """``fn()`` with every host synchronisation with a card an error
    (``torch.cuda.set_sync_debug_mode("error")``)."""
    import torch

    torch.cuda.set_sync_debug_mode("error")
    try:
        return fn()
    finally:
        torch.cuda.set_sync_debug_mode(0)


def run_peak_bytes(fn, devices) -> dict:
    """The most device memory ``fn()`` held on each of ``devices`` beyond
    what was allocated before it (``max_memory_allocated``)."""
    import torch

    devices = sorted({torch.device(d) for d in devices}, key=str)
    torch.cuda.synchronize()
    before = {}
    for d in devices:
        torch.cuda.reset_peak_memory_stats(d)
        before[d] = torch.cuda.memory_allocated(d)
    out = fn()
    for d in devices:
        torch.cuda.synchronize(d)
    peaks = {str(d): torch.cuda.max_memory_allocated(d) - before[d] for d in devices}
    del out
    return peaks


def ekf_inputs(slam, gt, gp, dtype, device):
    """The EKF stage's seven inputs as ``fusion.fuse_core`` hands them to the
    filter on the card (times, SLAM poses, the Sim(3) trajectory, the aligned
    GNSS and its mask), from one fusion of the sequence."""
    import torch

    from gps_optimize_slam_tpu_torch.config import FusionConfig
    from gps_optimize_slam_tpu_torch.models import fusion

    def dev(a, dt=dtype):
        return torch.as_tensor(np.asarray(a), device=device).to(dt)

    st, sp, sq = dev(slam["timestamps"]), dev(slam["positions"]), dev(slam["quaternions"])
    out = fusion.fuse_core(st, sp, sq, dev(gt), dev(gp), dev(np.ones(len(gt), bool), torch.bool),
                           FusionConfig(gps_sorted=True), seed=0)
    if not bool(out.ok):
        raise AssertionError("phase 9: the Sim3 alignment failed")
    return st, sp, sq, out.sim3_pos, out.sim3_quat, out.aligned_gps, out.gps_valid


def seqpar_case(label, args, pos_tol, quat_tol, modes, expect, mesh=None):
    """``fuse_ekf_rts_seqparallel`` on ``SEQPAR_BLOCKS`` blocks of ``mesh``
    (None: the card), every run with each host synchronisation an error
    (``no_host_sync``), against ``fuse_ekf_rts_parallel`` on the card, for
    each ``rts_mode``: the gaps, the launches of the first mode's run (held
    to ``expect``), warm walls of both (``utils.profiling.wallclock``), the
    first mode's profile and each device's peak memory beside the
    single-device ones. Returns the launch counts."""
    from gps_optimize_slam_tpu_torch.ops import kalman_parallel
    from gps_optimize_slam_tpu_torch.parallel import seqpar
    from gps_optimize_slam_tpu_torch.utils import profiling

    mesh = mesh or card_mesh(SEQPAR_BLOCKS)
    gaps, launches, walls, prof, peaks = {}, None, {}, {}, {}
    for mode in modes:
        def single():
            return kalman_parallel.fuse_ekf_rts_parallel(*args, rts_mode=mode)

        def split():
            return no_host_sync(lambda: seqpar.fuse_ekf_rts_seqparallel(mesh, *args, rts_mode=mode))

        want = single()
        got, counts = counted(split)
        launches = launches or counts
        gaps[mode] = {"positions_m": abs_err(got[0], want[0]), "quaternions": abs_err(got[1], want[1])}
        del got, want
        walls[mode] = {"single_device": profiling.wallclock(single, runs=3),
                       "seqpar": profiling.wallclock(split, runs=3)}
        if not prof:
            prof = {"seqpar": profile_device(split), "single_device": profile_device(single)}
            peaks = {"seqpar": run_peak_bytes(split, mesh.devices),
                     "single_device": run_peak_bytes(single, [args[1].device])}
    emit({"phase": 9, "part": label, "poses": int(args[0].shape[0]), "blocks": SEQPAR_BLOCKS,
          "devices": [str(d) for d in mesh.devices], "dtype": dtype_name(args[1].dtype),
          "seqpar_vs_single_device": gaps, "launches": {k: v for k, v in launches.items() if v}, "walls": walls,
          "profile": prof, "peak_bytes": peaks})
    bad = {m: g for m, g in gaps.items() if not (g["positions_m"] <= pos_tol and g["quaternions"] <= quat_tol)}
    if bad:
        raise AssertionError(f"phase 9 {label}: seqpar off the single-device filter: {bad}")
    got = {k: v for k, v in launches.items() if v}
    if got != expect:
        raise AssertionError(f"phase 9 {label}: launches {got}, expected {expect}")
    return launches


def phase9_chunked(device):
    """(c) ``fuse_core_chunked`` at 1,048,576 poses in 524,287-pose chunks,
    every chunk's filter scans split over four blocks of the card, against
    the same chunked fusion with one scan a chunk: ≤1e-8 m, the same scale;
    then (f) the ``decimated_view`` of that result against the strided host
    arrays. Returns (the split run's launches, the result)."""
    import torch

    from gps_optimize_slam_tpu_torch import pipeline
    from gps_optimize_slam_tpu_torch.config import FusionConfig
    from gps_optimize_slam_tpu_torch.models import fusion_chunked
    from gps_optimize_slam_tpu_torch.parallel import seqpar
    from gps_optimize_slam_tpu_torch.utils import profiling

    f64, cfg = torch.float64, FusionConfig(gps_sorted=True)
    slam, gt, gp = outage_sequence(CHUNKED_N)
    st, sp, sq = slam["timestamps"], slam["positions"], slam["quaternions"]
    gv = np.ones(len(gt), bool)
    scan_fn = seqpar.sequence_parallel_scan(card_mesh(SEQPAR_BLOCKS))

    def fuse(**kw):
        return fusion_chunked.fuse_core_chunked(st, sp, sq, gt, gp, gv, seed=0, config=cfg, chunk_size=SEQPAR_CHUNK,
                                                dtype=f64, device=device, **kw)

    res, launches = counted(lambda: fuse(scan_fn=scan_fn))
    ref = fuse()
    pos_err = float(np.abs(res.corrected_pos - ref.corrected_pos).max())
    quat_err = float(np.abs(res.corrected_quat - ref.corrected_quat).max())
    scale_rel = rel_diff(float(res.sim3.scale), float(ref.sim3.scale))
    walls = {"one_scan_a_chunk": profiling.wallclock(fuse, runs=2),
             "seqpar": profiling.wallclock(lambda: fuse(scan_fn=scan_fn), runs=2)}
    emit({"phase": 9, "part": "chunked", "poses": CHUNKED_N, "chunk": SEQPAR_CHUNK, "blocks": SEQPAR_BLOCKS,
          "dtype": "float64", "ok": [res.ok, ref.ok], "seqpar_vs_one_scan": {
              "corrected_pos_max_err_m": pos_err, "corrected_quat_max_err": quat_err, "scale_rel_err": scale_rel},
          "launches": {k: v for k, v in launches.items() if v}, "walls": walls})
    if not (res.ok and ref.ok and pos_err <= 1e-8 and quat_err <= 1e-10 and scale_rel <= 1e-12):
        raise AssertionError(f"phase 9 chunked: {pos_err:.3e} m, quat {quat_err:.3e}, scale {scale_rel:.3e}")
    if not all(launches[f"scan_tiled/{op}"] for op in ("quat_chain", "filter", "rts")) or not all(
            launches[f"scan_block/{op}"] for op in ("quat_chain", "filter", "rts")):
        raise AssertionError(f"phase 9 chunked: K2 blocks and K1 totals not all launched: {launches}")

    # (f) The decimated overview of the split run's result.
    gps = pipeline.GPSData(timestamps=gt, positions=gp, valid=gv, frame="enu", utm_zone=32, utm_south=False)
    view = pipeline.ChunkedPipelineResult(slam=slam, gps=gps, result=res, evaluation=None, config=cfg,
                                          device=device).decimated_view()
    s = -(-CHUNKED_N // 5000)
    full_sim3, _ = fusion_chunked.transform_trajectory_chunked(sp, sq, res.sim3, chunk_size=SEQPAR_CHUNK,
                                                               dtype=f64, device=device)
    n_view = len(view.slam["timestamps"])
    strided = (np.array_equal(view.corrected_pos, res.corrected_pos[::s])
               and np.array_equal(view.slam["positions"], sp[::s])
               and np.array_equal(view.outputs.gps_valid, res.gps_valid[::s])
               and np.array_equal(view.outputs.aligned_gps, res.aligned_gps[::s], equal_nan=True))
    sim3_err = float(np.abs(view.outputs.sim3_pos - full_sim3[::s]).max())
    emit({"phase": 9, "part": "decimated view", "poses": n_view, "stride": s, "strided_arrays_equal": strided,
          "sim3_pos_vs_strided_full_m": sim3_err})
    if not (n_view <= 5000 and strided and sim3_err <= 1e-9):
        raise AssertionError(f"phase 9 decimated view: {n_view} poses, strided {strided}, sim3 {sim3_err:.3e} m")
    return launches


def mesh_shards(device, b, seeds, shards, label):
    """``fuse_batch(mesh=shards)`` of the batch ``b`` against the unsharded
    batch on ``device``: rows ≤1e-9 m, masks equal, each shard launching
    what the unsharded batch launches (RANSAC counts), warm walls of the
    unsharded batch, the shards (one host thread a distinct device) and the
    shards one after another from one thread, and the profiles. Returns (the sharded run's launches, the unsharded
    outputs)."""
    import torch

    from gps_optimize_slam_tpu_torch.config import FusionConfig
    from gps_optimize_slam_tpu_torch.parallel import mesh
    from gps_optimize_slam_tpu_torch.utils import profiling

    cfg, f64 = FusionConfig(), torch.float64

    def unsharded():
        return mesh.fuse_batch(b, seeds, config=cfg, device=device, dtype=f64)

    def sharded():
        return mesh.fuse_batch(b, seeds, config=cfg, mesh=shards, dtype=f64)

    def in_turn():
        staged = mesh.stage_batch(b, seeds, dtype=f64, mesh=shards)
        outs = [mesh.fuse_batch(shard, config=cfg) for shard in staged.shards]
        home = shards.devices[0]
        return torch.cat([o.corrected_pos.to(home) for o in outs])[: staged.n_real]

    want, want_launches = counted(unsharded)
    got, launches = counted(sharded)
    err = abs_err(got.corrected_pos, want.corrected_pos)
    turn_err = abs_err(in_turn(), want.corrected_pos)
    masks = bool(torch.equal(got.sim3_inliers, want.sim3_inliers) and torch.equal(got.gps_valid, want.gps_valid))
    walls = {"unsharded": profiling.wallclock(unsharded, runs=3), "sharded": profiling.wallclock(sharded, runs=3),
             "shards_in_turn": profiling.wallclock(in_turn, runs=3)}
    prof = {"sharded": profile_device(sharded), "unsharded": profile_device(unsharded)}
    emit({"phase": 9, "part": label, "rows": len(seeds), "shards": shards.size,
          "devices": [str(d) for d in shards.devices], "padded_poses": int(b.slam_times.shape[1]),
          "dtype": "float64", "ok": bool(got.ok.all()), "rows_vs_unsharded_max_err_m": err,
          "in_turn_vs_unsharded_max_err_m": turn_err, "masks_equal": masks,
          "launches": {k: v for k, v in launches.items() if v},
          "unsharded_launches": {k: v for k, v in want_launches.items() if v}, "walls": walls, "profile": prof})
    if not (bool(got.ok.all()) and err <= 1e-9 and turn_err <= 1e-9 and masks):
        raise AssertionError(f"phase 9 {label}: rows off the unsharded batch by {err:.3e} m "
                             f"(in turn {turn_err:.3e} m), masks {masks}")
    if launches["ransac_counts"] != shards.size * want_launches["ransac_counts"]:
        raise AssertionError(f"phase 9 {label}: {launches} against one batch's {want_launches}")
    return launches, want


def phase9_mesh(device):
    """(d) The eleven KITTI rows as one batch (B = 11, each row padded to the
    longest) on a 3-shard mesh of the card against the unsharded batch on the
    card (``mesh_shards``), and over the cards when there are several. (e)
    The same rows through the ``distributed_launch`` example: two gloo ranks
    on the card, then a one-rank NCCL group; the gathered rows equal (d)'s
    ≤1e-9 m. Returns the launches of the card's sharded run."""
    import torch

    from gps_optimize_slam_tpu_torch.examples import distributed_launch
    from gps_optimize_slam_tpu_torch.parallel import batch as pbatch

    seqs = kitti_sequences()
    b = pbatch.pad_batch([s for s, _, _, _ in seqs], [t for _, t, _, _ in seqs], [p for _, _, p, _ in seqs])
    seeds = list(range(len(seqs)))
    launches, want = mesh_shards(device, b, seeds, card_mesh(MESH_SHARDS), "mesh shards")
    if torch.cuda.device_count() >= 2:
        mesh_shards(device, b, seeds, cards_mesh(MESH_SHARDS), "mesh shards over the cards")

    want_pos = want.corrected_pos.cpu().numpy()
    runs = []
    with tempfile.TemporaryDirectory() as tmp:
        batch_path = os.path.join(tmp, "batch.npz")
        distributed_launch.save_batch(batch_path, b, seeds)
        for nproc, backend in DISTRIBUTED_RUNS:
            out = os.path.join(tmp, f"{backend}.npz")
            t0 = time.perf_counter()
            proc = subprocess.run(
                [sys.executable, "-m", "gps_optimize_slam_tpu_torch.examples.distributed_launch", "--nproc",
                 str(nproc), "--backend", backend, "--device", card_name(), "--batch",
                 batch_path, "--out", out, "--log-dir", os.path.join(tmp, backend), "--timeout", "300"],
                cwd=REPO, capture_output=True, text=True, timeout=400, env={**os.environ, "PYTHONPATH": REPO})
            wall = time.perf_counter() - t0
            if proc.returncode != 0:
                raise AssertionError(f"distributed_launch {backend}: exit code {proc.returncode}\n"
                                     f"{proc.stdout[-2000:]}\n{proc.stderr[-2000:]}")
            timing = [json.loads(line[len("timing "):]) for line in proc.stdout.splitlines()
                      if line.startswith("timing ")]
            with np.load(out) as f:
                gathered = f["corrected_pos"]
            gap = float(np.abs(gathered - want_pos).max()) if gathered.shape == want_pos.shape else float("inf")
            runs.append({"backend": backend, "ranks": nproc, "wall_s": wall, "rows_vs_unsharded_max_err_m": gap,
                         "ranks_timing": timing})
    emit({"phase": 9, "part": "distributed", "rows": len(seqs), "runs": runs})
    bad = [r for r in runs if not r["rows_vs_unsharded_max_err_m"] <= 1e-9 or len(r["ranks_timing"]) != r["ranks"]]
    if bad:
        raise AssertionError(f"phase 9 distributed: gathered rows off the unsharded batch: {bad}")
    return launches


def phase9(device):
    """Multi-device paths on one card: (a) seqpar float64 at 1,048,576 poses,
    (b) seqpar float32 at 4,661, (c) the chunked fusion with seqpar scans and
    (f) its decimated view, (d) mesh shards and (e) the distributed example;
    (a) and (d) also over the cards when there are several (their launches
    stay out of the counts). Returns (the launches of (a), (b) and (c),
    summed; those of (d) on the card)."""
    import torch

    from gps_optimize_slam_tpu_torch.config import FusionConfig

    cfg = FusionConfig()
    # The filter's three scans and the controls' two (max3 forward, min3
    # backward): a block's scan (K2 past 65,536 poses), the totals' (K1).
    ops = ("quat_chain", "filter", "rts", "max3", "min3")
    blocks = {f"scan_{route}/{op}": n for op in ops for route, n in (("tiled", SEQPAR_BLOCKS), ("block", 1))}
    slam, gt, gp = outage_sequence(CHUNKED_N)
    args = ekf_inputs(slam, gt, gp, torch.float64, device) + (cfg.ekf, cfg.rts_decision)
    runs = [seqpar_case("seqpar float64", args, 1e-8, 1e-10, ("outage", "full"), blocks)]
    if torch.cuda.device_count() >= 2:
        seqpar_case("seqpar float64 over the cards", args, 1e-8, 1e-10, ("outage",), blocks,
                    mesh=cards_mesh(SEQPAR_BLOCKS))
    del args
    torch.cuda.empty_cache()
    slam, gt, gp = replica_sequence(SEQ02_LEN)
    args = ekf_inputs(slam, gt, gp, torch.float32, device) + (cfg.ekf, cfg.rts_decision)
    runs.append(seqpar_case("seqpar float32", args, 1e-2, TOL["float32"], ("outage",),
                            {f"scan_block/{op}": SEQPAR_BLOCKS + 1 for op in ops}))
    runs.append(phase9_chunked(device))
    sharded = phase9_mesh(device)
    return {k: sum(r[k] for r in runs) for k in runs[0]}, sharded


LONG_LOG_SHIFT_S = 86_400.0  # each long log a day after the one before
COMMAND_LOG_POSES = 70_000  # the fuse-batch subprocess's two logs: past K1's route


def long_logs():
    """Phase 10's bucket: ``LONG_LOG_LENGTHS`` poses, each row
    ``outage_sequence`` (seq-04 replicas, 10 s GNSS outages at every
    262,144-pose boundary) with its own 2 cm of GNSS noise (seed 400 + i),
    shifted by i days. Returns [(slam, gps_times, gps_positions)]."""
    rows = []
    for i, n in enumerate(LONG_LOG_LENGTHS):
        slam, gt, gp = outage_sequence(n, seed=400 + i)
        shift = i * LONG_LOG_SHIFT_S
        rows.append(({**slam, "timestamps": slam["timestamps"] + shift}, gt + shift, gp))
    return rows


def write_replica_files(tmp: str, name: str, n: int, seed: int):
    """TUM and GNSS files of ``replica_sequence(n, seed)`` (the GNSS back in
    UTM zone 32N, by the golden track's first fix, then latitude and
    longitude by the inverse projection), as ``write_seq04_files`` writes
    seq-04's. Returns the ``slam:gnss`` pair the fuse-batch command takes."""
    import torch

    from gps_optimize_slam_tpu_torch.io import tum
    from gps_optimize_slam_tpu_torch.ops import geodesy

    g, _ = golden_arrays()
    slam, gt, gp = replica_sequence(n, seed)
    slam_path, gps_path = os.path.join(tmp, f"{name}.tum"), os.path.join(tmp, f"{name}_gnss.txt")
    tum.write_tum(slam_path, slam["timestamps"], slam["positions"], slam["quaternions"], position_fmt="%.9f")
    utm = torch.from_numpy(gp + g["gps_utm"][0])
    lon, lat = geodesy.utm_inverse(utm[:, 0], utm[:, 1], 32, False)
    np.savetxt(gps_path, np.column_stack([gt, lat.numpy(), lon.numpy(), utm[:, 2].numpy()]),
               fmt=["%.6f", "%.10f", "%.10f", "%.4f"])
    return f"{slam_path}:{gps_path}"


def phase10_command():
    """``fuse-batch --json`` as a subprocess on two TUM/GNSS file pairs of
    ``COMMAND_LOG_POSES`` poses (one bucket of two rows past K1's route and
    within ``BATCH_TILED_MAX_ELEMENTS``: K2's batch grid by the route); a
    non-zero exit, other keys or a malformed output fail."""
    with tempfile.TemporaryDirectory() as tmp:
        pairs = [write_replica_files(tmp, f"log{i}", COMMAND_LOG_POSES, seed=500 + i) for i in range(2)]
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-m", "gps_optimize_slam_tpu_torch", "fuse-batch", *pairs, "--json",
                               "-o", os.path.join(tmp, "out")],
                              cwd=REPO, capture_output=True, text=True, timeout=600,
                              env={**os.environ, "PYTHONPATH": REPO})
        wall = time.perf_counter() - t0
        if proc.returncode != 0:
            raise AssertionError(f"fuse-batch on long logs: exit code {proc.returncode}\n{proc.stderr[-2000:]}")
        out = json.loads(proc.stdout)
        keys = ["slam", "poses", "ok", "sim3_scale", "ate_rmse_m", "ate_mean_m", "eval_points", "output"]
        rows = out["sequences"]
        if (list(out) != ["sequences", "buckets"] or out["buckets"] != 1 or len(rows) != 2
                or any(list(r) != keys or r["poses"] != COMMAND_LOG_POSES or not r["ok"] or not r["ate_rmse_m"] < 1.0
                       or np.loadtxt(r["output"]).shape != (COMMAND_LOG_POSES, 8) for r in rows)):
            raise AssertionError(f"fuse-batch on long logs: keys or values off: {proc.stdout[:800]}")
    return {"wall_s": wall, "poses": [r["poses"] for r in rows], "sim3_scale": [r["sim3_scale"] for r in rows],
            "ate_rmse_m": [r["ate_rmse_m"] for r in rows]}


def phase10(device):
    """A bucket of long logs, float64 on the card: four rows of
    ``LONG_LOG_LENGTHS`` poses (``long_logs``), one bucket under
    ``bucket_by_length(max_waste=2.0)``. The counted main path is
    ``mesh.fuse_batch`` + ``evaluate_batch`` on the kernels the routes pick
    (the scans K1's batch grid at this size, the NN calls K3's), then the
    evaluation once more with its NN calls forced onto K4
    (``forced_route``), held bit for bit to the routed one, and the
    fusion once more with every scan forced onto K2's batch grid
    (``forced_route``). Each row of both fusions within the bound of
    ``tol_m`` (1e-9 m, or 64 ulps of the largest coordinate where that is
    more: these rows span hundreds of kilometres) of ``fusion.fuse_core`` +
    ``evaluate`` on that row alone (single-row K2, and K3 or K4 by the
    route) and of each other, masks equal, the evaluation's statistics
    within the same bound (counts equal); each fusion's launches those of
    one row alone;
    ``fuse_buckets`` equal to the batch;
    warm walls of the bucket and of the row loop, the device's idle share
    and peak memory; then ``fuse-batch`` as a subprocess on two logs of
    ``COMMAND_LOG_POSES`` poses. Returns the counted launches."""
    import torch

    from gps_optimize_slam_tpu_torch.config import FusionConfig
    from gps_optimize_slam_tpu_torch.models import fusion
    from gps_optimize_slam_tpu_torch.ops import kernels, scan
    from gps_optimize_slam_tpu_torch.parallel import batch as pbatch
    from gps_optimize_slam_tpu_torch.parallel import mesh

    f64, cfg = torch.float64, FusionConfig()
    rows = long_logs()
    slams, gts, gps = [r[0] for r in rows], [r[1] for r in rows], [r[2] for r in rows]
    buckets = pbatch.bucket_by_length(slams, gts, gps, max_waste=2.0)
    if len(buckets) != 1:
        raise AssertionError(f"phase 10: the long logs fell into {len(buckets)} buckets, not one")
    idxs, b = buckets[0]
    seeds = [int(i) for i in idxs]  # row r of the bucket fuses sequence idxs[r], seeded as that sequence
    B, n_pad = b.slam_times.shape

    def fuse():
        return mesh.fuse_batch(b, seeds, config=cfg, device=device, dtype=f64)

    def dev(a, dt=f64):
        return torch.as_tensor(np.asarray(a), device=device).to(dt)

    def single(i):
        s = slams[i]
        out = fusion.fuse_core(dev(s["timestamps"]), dev(s["positions"]), dev(s["quaternions"]), dev(gts[i]),
                               dev(gps[i]), dev(np.ones(len(gts[i]), bool), torch.bool),
                               cfg.replace(gps_sorted=True), seed=i)
        return out, fusion.evaluate(dev(s["timestamps"]), dev(s["positions"]), out)

    routes = {"scan": scan.scan_route(27, n_pad, 8, B), "nn": kernels.nn_route(n_pad, n_pad, B)}
    # The main path: its counts are set to 0 just before it and read just
    # after. The fusion and evaluation on the kernels the routes pick, then
    # the evaluation with the NN calls forced onto K4 and the fusion with
    # every scan forced onto K2 (all counted).
    reset_launch_counts()
    out = fuse()
    ev = mesh.evaluate_batch(b, out)
    with forced_route(kernels, "nn_route", "grid"):
        ev_grid = mesh.evaluate_batch(b, out)
    with forced_route(scan, "scan_route", "tiled"):
        out_k2 = fuse()
    torch.cuda.synchronize()
    launches = launch_counts()

    parts = ("nn_slam", "nn_sim3", "nn_ekf", "ate_sim3", "ate_ekf")
    stats = ("mean", "median", "rmse", "max", "count")
    grid_equal = all(torch.equal(getattr(getattr(ev, p), f), getattr(getattr(ev_grid, p), f))
                     for p in parts for f in stats)
    k2_err = float((out_k2.corrected_pos - out.corrected_pos).abs().max())
    k2_masks = bool(torch.equal(out_k2.sim3_inliers, out.sim3_inliers) and torch.equal(out_k2.gps_valid, out.gps_valid))
    res = mesh.fuse_buckets(buckets, list(range(len(rows))), config=cfg, device=device, dtype=f64)
    pos_err, eval_err, buckets_err, masks_equal, ok = 0.0, 0.0, 0.0, True, True
    single_launches = None
    for r, i in enumerate(seeds):
        n = len(slams[i]["timestamps"])
        if single_launches is None:
            (one, one_ev), single_launches = counted(lambda: single(i))
        else:
            one, one_ev = single(i)
        pos_err = max(pos_err, float((out.corrected_pos[r, :n] - one.corrected_pos).abs().max()),
                      float((out_k2.corrected_pos[r, :n] - one.corrected_pos).abs().max()))
        buckets_err = max(buckets_err, float(np.abs(res[i].corrected_pos - out.corrected_pos[r, :n].cpu().numpy()).max()))
        masks_equal &= bool(torch.equal(out.sim3_inliers[r, :n], one.sim3_inliers)
                            and torch.equal(out.gps_valid[r, :n], one.gps_valid))
        ok &= bool(out.ok[r]) and bool(one.ok)
        for p in parts:
            for f in stats:
                got, want = float(getattr(getattr(ev, p), f)[r]), float(getattr(getattr(one_ev, p), f))
                eval_err = max(eval_err, abs(got - want) if f != "count" else (0.0 if got == want else float("inf")))
        del one, one_ev
    del out_k2
    torch.cuda.empty_cache()

    def bucket_run():
        o = fuse()
        return mesh.evaluate_batch(b, o).nn_ekf.rmse.cpu()

    def loop():
        return [single(int(i))[1].nn_ekf.rmse.cpu() for i in range(len(rows))]

    walls = {"bucket": [], "row_loop": []}
    for _ in range(2):
        walls["bucket"].append(1e3 * timed_s(bucket_run)[0])
        walls["row_loop"].append(1e3 * timed_s(loop)[0])
    torch.cuda.reset_peak_memory_stats()
    timed_s(bucket_run)
    peak = torch.cuda.max_memory_allocated()
    prof = profile_device(bucket_run)
    command = phase10_command()
    # Two association orders of the same float64 scans at these rows'
    # hundreds of kilometres differ by a few ulps of the coordinates (2^-30 m
    # is 8 of them from 2^19 m on): the rows are held to 1e-9 m or, where the
    # coordinates are larger, 64 ulps of the largest (phase 7's 1e-9 m is
    # ~1,000 ulps of its few-kilometre rows). The evaluation's statistics
    # are lengths, and move no more than the poses do.
    extent = float(out.corrected_pos.abs().max())
    tol_m = max(1e-9, 64 * float(np.spacing(extent)))
    emit({"phase": 10, "rows": B, "poses": [len(s["timestamps"]) for s in slams], "padded_poses": n_pad,
          "dtype": "float64", "ok": ok, "routes": routes, "largest_coordinate_m": extent, "bound_m": tol_m,
          "row_vs_single_max_err_m": pos_err,
          "masks_equal": masks_equal, "evaluate_vs_single_max_err_m": eval_err,
          "evaluate_k4_forced_equal": grid_equal, "fuse_k2_forced_vs_routed_max_err_m": k2_err,
          "fuse_k2_forced_masks_equal": k2_masks, "fuse_buckets_vs_batch_max_err_m": buckets_err,
          "launches": launches, "single_row_launches": single_launches,
          "bucket_warm_ms": walls["bucket"], "row_loop_warm_ms": walls["row_loop"],
          "max_memory_allocated_mb": peak / 2**20, "profile": prof, "command": command})
    if not ok or not (pos_err <= tol_m and masks_equal and eval_err <= tol_m and buckets_err <= tol_m):
        raise AssertionError(f"phase 10: ok {ok}, rows {pos_err:.3e} m, masks {masks_equal}, evaluation "
                             f"{eval_err:.3e} m, fuse_buckets {buckets_err:.3e} m (bound {tol_m:.3e} m)")
    if not grid_equal or not (k2_err <= tol_m and k2_masks):
        raise AssertionError(f"phase 10: with K4 forced the evaluation {'equals' if grid_equal else 'differs from'} "
                             f"the routed one; with K2 forced the fusion is {k2_err:.3e} m off, masks {k2_masks}")
    # The routed fusion's scans on the kernel the route picks, the forced
    # fusion's on K2, each as many as one row alone launches (K2, its rows
    # being past K1's route); K5 once a fusion; the NN calls by the route,
    # and K4 in the forced evaluation, each with its keep lists.
    per_fusion = {op: 1 for op in scan.OPS}
    per_fusion.update(affine3=2, max3=2, min3=2)
    want = {f"scan_tiled/{op}": c for op, c in per_fusion.items()}
    for op, c in per_fusion.items():
        key = f"scan_{routes['scan']}/{op}"
        want[key] = want.get(key, 0) + c
    want.update({"nn_keep": 6, f"nn_{routes['nn']}": 3, "ransac_counts": 2})
    want["nn_grid"] = want.get("nn_grid", 0) + 3
    n0 = len(slams[seeds[0]]["timestamps"])
    want_alone = {**{f"scan_tiled/{op}": c for op, c in per_fusion.items()}, "nn_keep": 3,
                  f"nn_{kernels.nn_route(n0, n0)}": 3, "ransac_counts": 1}
    got = {k: v for k, v in launches.items() if v}
    alone = {k: v for k, v in single_launches.items() if v}
    if got != want or alone != want_alone:
        raise AssertionError(f"phase 10: the bucket launched {got}, expected {want}; one row alone {alone}, "
                             f"expected {want_alone} (routes {routes})")
    return launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    needed = [os.path.join(REPO, "gps_optimize_slam_tpu_torch", "__init__.py"), GOLDEN, META]
    missing = [os.path.relpath(p, REPO) for p in needed if not os.path.exists(p)]
    if missing:
        print(f"chip_smoke: run it from a checkout of the repository; missing beside it: {', '.join(missing)}",
              file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from gps_optimize_slam_tpu_torch.ops import _build

    device = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    t0 = time.perf_counter()
    _build.library()
    build_s = time.perf_counter() - t0
    emit({"phase": 0, "nvidia_smi": smi, "torch": torch.__version__, "cuda": torch.version.cuda,
          "kernel_build_s": build_s, "library": os.path.basename(_build.BUILD_INFO["path"]),
          "registers_and_spills": build_registers(_build.BUILD_INFO["log"])})
    entries = phase1(device)
    phase2(device)
    phase3(device)
    in_core = phase4(device)
    chunked = phase5(device)
    robust = phase6(device)
    batched = phase7(device)
    refined = phase8(device)
    split, sharded = phase9(device)
    long_logs_run = phase10(device)
    for e in entries:
        # A batched entry is the same wrapper at the batch shapes of phase 7,
        # of phase 9's mesh shards and of phase 10's long logs, where every
        # launch has a batch grid.
        name, at_batch = e["name"].split("@")[0], "@" in e["name"]
        by_phase = {"7": batched[name], "9": sharded[name], "10": long_logs_run[name]} if at_batch else {
            "4": in_core[name], "5": chunked[name], "6": robust[name], "8": refined[name], "9": split[name]}
        e["launches"] = sum(by_phase.values())
        e["launches_by_phase"] = by_phase
    print(smi, flush=True)
    emit({"kernels": entries})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
