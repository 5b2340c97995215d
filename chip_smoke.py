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
     rate the card issues operations that are not fused multiply-adds, half
     the published peak, whichever is larger, and both terms) and, where one
     PyTorch call computes the same function, that call's time (and for
     the scans its device time): K1, 8 combines at N = 271
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
     with its wrapper), bit for bit against K3, and all-masked, its launch
     alone (the grid sized from the card, the work list's length read on
     the device) timed against one block an item with the length read on
     the host, at both shapes and at the batch grid's; K5, counts equal
     to the plain version's at 1000 trials x 4661 and 279 points and 333 x
     5003 (ragged point and trial chunks), with every point invalid, and
     twice on the same inputs, with the share of pairs its band left to the
     plain recount; float32 and float64; and the routes: K1
     against K2 (and against the plain version) from 271 to 524,289 elements
     and at the last length the JAX package's budget gave K1, K1's batch
     grid against K2's at 2 to 64 rows of 16,385 to 524,289 elements, K3
     against K4 at 16,384 queries and 4661 to 1,048,576 candidates and, with
     shuffled candidates (every tile kept, long keep lists), at 700 to
     16,384 queries, on the same inputs, the times that place the routing
     thresholds on this card; the batch grids (``@batch`` entries): K1,
     every combine (a thread-block cluster a row on the cluster path for
     every combine but the filter; each entry with its tile, cluster size
     and registers at both batches and at phase 10's rows), the keep lists
     with K3, and K5, each at the eleven KITTI
     lengths as one ragged batch and at 64 x 4661, against the batched plain
     version and row by row against the single-row kernel (K1 to TOL, the
     others bit for bit), timed at 64 x 4661 in float32; K2, every combine,
     at four ragged float64 rows of 524,289 / 393,217 / 300,001 / 20,001
     elements (identity-padded) and at 4 x 20,001, against the batched plain
     version and row by row against K2 alone (bit for bit for add2, max3,
     min3), timed beside K1's grid; K5 also at the fleet's own operands
     (its fusion's Sim(3) window mask a row, recorded from an eager
     ``fuse_batch``) and on an adversarial batch whose pairs sit within
     a few ulps of the threshold, equal to the plain counts, with the
     pairs recounted; K1's filter entry with its registers and spills; K4
     (one work list over all rows' query
     tiles) at 4 x 700 x 524,288
     shuffled candidates with a row all masked and at phase 10's evaluation
     shape, bit for bit against K3's batch grid and against the plain
     version on every 64th query, timed beside it; K3's launch alone at
     each of its block sizes (16, 32 and 64 queries), bit for bit equal,
     at single rows of 37 to 4,096 query tiles and at the fleet bucket,
     float32 and float64, with the device time of each (the times that set
     ``kernels.resident_block``); and the SASS of K3's and K4's tile loops,
     their instructions a (query, candidate) pair (``sass_tile_loops``)
     and of K5's trial walk, its instructions a (trial, point) pair
     (``sass_count_loops``);
  2. seq-04 golden arrays, float64 UTM, ``fuse_arrays`` on the card, held
     against tests/golden/seq04_golden.npz and seq04_meta.json;
  3. seq-04 from TUM + GNSS files rebuilt from the npz, ``fuse_files`` in
     float32 ENU on the card + ``export_result``, held against the port's
     own CPU float64 run of the same files;
  4. a 4,661-pose sequence (KITTI seq-02's length) made of time-shifted
     replicas of seq-04, float32 and float64 on the card against the port's
     CPU float64 run, replaying the captured programs of ``fuse_core`` and
     ``evaluate`` (``utils.graphs``), each against the same under
     ``graphs.eager()`` (float64 ≤1e-9 m, float32 ≤1e-2 m, masks and ``ok``
     equal), with a replay's launch counts, the walls of the first call
     for a key (eager), of the second (capture and replay) and of an eager
     call, and the warm walls of both (medians of 5 and 3) with their idle
     shares;
  5. the chunked path at 1,048,576 poses (3,870 seq-04 replicas, GNSS
     outages straddling the 262,144-pose boundaries), float64 on the card:
     ``fuse_core_chunked`` (524,288-pose chunks) against the in-core
     ``fusion.fuse_core``, ``evaluate_chunked`` (524,288-pose NN blocks, K3
     by the route) once more with the blocks forced onto K4 (its chunk
     bodies captured and replayed against eager dispatch, ≤1e-9 m), and against
     262,144-pose blocks, launch counts, warm wall times of the replayed
     chunk bodies against the same under ``graphs.eager()`` (≤1e-9 m apart,
     idle shares), poses per second and peak device memory; and
     ``fuse_files_chunked`` +
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
     (≤1e-6 relative, aligned track ≤1e-6 m). The robust fusion replayed
     against the same under ``graphs.eager()``, ≤1e-9 m with masks equal:
     in core ``fuse_robust`` under each gate (the parallel one a program of
     every pass, masked, and the final fusion; its passes to the fixed point
     counted as the fewest ``n_iterations`` that converge), and the robust
     chunked fusion. Then ``python3 -m
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
     within 1e-6 m of golden; warm walls of ``fuse_buckets`` replayed and
     eager (≤1e-9 m apart) and of the loop over the rows. The fleet bucket,
     64 x 4661 float32: warm walls replayed and eager, sequences per
     second, idle shares, peak memory, the row loop's wall.
     Then ``fuse-batch --json`` on two pairs as a subprocess;
  8. the pose-graph refinement, float64. A shuttle at KITTI seq-00's length
     (4,541 poses: seq-04's legs alternately forward and backward over one
     road, 2 cm of fresh GNSS noise a leg, GNSS dropped over one backward
     leg): ``fuse_arrays`` then ``refine_pose_graph`` (10 Gauss-Newton steps
     of 50 CG iterations, closures proposed within 5 m and 30 s apart, a
     checkpoint directory) on the card, held against the port's CPU run of
     the same arrays (positions ≤1e-6 m, quaternions ≤1e-8, cost history
     ≤1e-9 relative, the valid closures equal); a refinement stopped after 5
     steps and resumed equal to the uninterrupted one bit for bit; a
     Gauss-Newton step's program called first (eager), then captured, then
     replayed, with the pool's growth; the refine without closures replayed
     against eager dispatch (≤1e-9 m); warm walls of the replayed refine
     (median of 3) and of one eager refine as its yardstick (held to the
     replays as the card to the CPU), profiles of two steps of each
     (kernels, launches, idle share), its peak memory and the proposal's
     share of its wall. Then
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
     device's peak memory beside the single-device filter's, the blocks'
     stage programs replayed against eager dispatch (walls, idle shares,
     ≤1e-9 m apart); (b) the same
     at 4,661 poses in float32 (padded to 4,664; K1 a block), ≤1e-2 m;
     (c) ``fuse_core_chunked(scan_fn=...)`` at 1,048,576 poses in
     524,287-pose chunks against the same without ``scan_fn``, ≤1e-8 m, the
     same scale; (f) its ``decimated_view()``, ≤5,000 poses, equal to the
     strided arrays; (d) ``fuse_batch(mesh=...)`` of phase 7's eleven KITTI
     rows as one batch on 3 shards against the unsharded batch, ≤1e-9 m,
     timed beside the unsharded batch and the shards issued one after
     another from one thread (``fuse_batch`` gives each distinct device a
     host thread; on one card both run in one thread), each replayed and
     eager; with two cards or more, (a) and (d) also run over the cards;
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
     ``fuse_buckets`` equal to the batch; warm walls of the bucket replayed
     and eager (within the same bound) and of the row loop, idle shares,
     peak memory; then ``fuse-batch --json`` as a subprocess on two logs of
     70,000 poses; and, uncounted, K3's batch grid and the keep lists on the
     operands of the bucket's own evaluation and K1's batch grid on the
     leaves of its routed fusion (recorded from an eager run), timed with
     their bounds.

After each of phases 2-10 a line ``{"phase": k, "wall_s": ..., "graphs":
{...}}`` gives its wall and the first calls, captures and replays of its
captured programs, and the programs held after it with the device memory
of their shared pool and of their static inputs and outputs. The programs
are kept from phase to phase, as a process that fuses many logs keeps
them: the pool's growth over the run is the figure to read. A run with a
route forced (``forced_route``) drops every program on its way in and out:
a captured program keeps the route it was captured with. Captured on the card: the in-core
fusion and evaluation, the batched offsets, mesh shards and seqpar blocks,
each Gauss-Newton step and the closure proposal of the pose graph, the
robust parallel fusion and the sequential gate's final fusion, and every
chunk body of the chunked paths.

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

# Peaks of one H100 SXM for the bounds (NVIDIA data sheet), the card's
# power limit printed beside them: the memory rate, and the float32 and
# float64 rates outside the tensor cores, which count a fused multiply-add
# as two operations in one instruction. The operation counts below count
# each multiply and each add as one operation, so at these peaks they give
# the least time the function needs however its multiply-adds contract.
# Every kernel here is built with --fmad=false (ops/_build.py): each
# counted operation then takes an instruction of its own, and the card
# issues those at half the peaks (ISSUE_RATE). That time is printed as a
# term of its own beside the bound, the cost of the build's choice, and is
# not the bound. K3 and K4 contract two of a pair's eight operations by
# hand (csrc/nn_tile.cuh), so they issue 6 instructions for them and their
# unfused term overstates their cost by a third; the SASS counts of phase 1
# (``sass_tile_loops``) give what they issue.
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "float64": 34e12}
ISSUE_RATE = {k: v / 2 for k, v in PEAK_FLOPS.items()}
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
COUNT_FLOPS = 30  # s*R*p + t - d, squared and summed, compared, per (trial, valid point)
# Operations of one CG iteration of pose_cg: a factor's u = J·[p_i; p_j]
# (6 rows of 12 multiplies and 11 adds) and Jᵀu (12 columns of 6 multiplies
# and 5 adds); a pose's 6 elements each join their two odometry sums (1),
# add λp (2), p·Ap (2), x += αp (2), r −= αAp (2), r·r (2) and p = r + βp (2).
POSE_CG_FACTOR_FLOPS = 138 + 132
POSE_CG_POSE_FLOPS = 6 * 13
POSE_CG_ITERS = 50  # the refine's CG iterations a Gauss-Newton step (REFINE)


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


def launch_device_ms(fn, name: str, reps: int = 10):
    """(ms, launches): the device time of one launch of the kernels whose
    name holds ``name``, from a torch.profiler trace of ``reps`` calls of
    ``fn``, as the traced time over the traced launches, and how many
    launches the trace holds. A trace now and then holds fewer launches
    than were made (one run's traces of phase 10's calls held about a tenth
    of them), which a time per call taken as the total over ``reps`` reads
    as a faster kernel."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total, count = 0.0, 0
    for e in prof.key_averages():
        if name in e.key and e.device_time_total > 0:
            total, count = total + e.device_time_total, count + e.count
    return (total / count / 1e3 if count else None), count


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
    """(bound_ms, bound_by, bytes_ms, operations_ms, unfused_ms): the larger
    of the bytes' time at the card's memory rate and the operations' time
    at its peak for ``dtype``, which of the two it is, both, and the
    operations' time with each its own instruction (``--fmad=false``)."""
    t_bytes = 1e3 * bytes_moved / PEAK_BYTES_PER_S
    t_ops = 1e3 * flops / PEAK_FLOPS[dtype]
    return (max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations"), t_bytes, t_ops,
            1e3 * flops / ISSUE_RATE[dtype])


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


def library_device_ms(op: str, x, reverse: bool):
    """The device time of the call ``scan_library_ms`` times (the
    profiler's, without the call's host time), or None."""
    fn = library_call(op, x, reverse)
    return None if fn is None else device_ms(fn)


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


def keep_bound(traj, cand, mask, nkept, cand3):
    """The coordinates and the mask read once; the packed candidates, the
    kept entries of the lists and their counts written once."""
    moved = (traj.numel() + cand.numel() + cand3.numel()) * traj.element_size() + mask.numel() + 4 * (
        int(nkept.sum()) + nkept.numel())
    return bound(moved, 0.0, "float64")


def keep_all_pairs_ms(traj, cand) -> float:
    """The time of both bounds over every segment pair at the float64 peak:
    the operations bound of the kernel's first design."""
    from gps_optimize_slam_tpu_torch.ops import kernels

    n_sub = -(-traj.shape[0] // kernels.TILE_N) * kernels.TILE_N // kernels.SUB
    m_sub = -(-cand.shape[0] // kernels.TILE_M) * kernels.TILE_M // kernels.SUB
    return 1e3 * KEEP_PAIR_FLOPS * n_sub * m_sub / PEAK_FLOPS["float64"]


KEEP_KERNELS = ("segment_boxes_kernel", "group_boxes_kernel", "keep_lists_kernel")  # a keep-lists call's launches


def keep_plan(traj, cand) -> dict:
    """The keep-list kernel's regime at these operands: query tiles of the
    launch, candidate tiles and groups of 32 of them a row (the group level
    and its launch only at two groups or more), and the warps a query tile
    (``kernels.keep_split``)."""
    from gps_optimize_slam_tpu_torch.ops import kernels

    batch = traj.shape[0] if traj.ndim == 3 else 1
    n_tiles, m_tiles = kernels._tiles(traj.shape[-2], cand.shape[-2])
    return {"query_tiles": batch * n_tiles, "m_tiles": m_tiles, "groups": -(-m_tiles // kernels.GROUP_TILES),
            "warps_a_query_tile": kernels.keep_split(batch, n_tiles, m_tiles)}


def keep_launch_ms(traj, cand, mask, reps: int = 10) -> dict:
    """{kernel: [device ms of a launch, launches traced]} of a keep-lists
    call's launches (``launch_device_ms``; the group step only where a row
    has two groups or more)."""
    from gps_optimize_slam_tpu_torch.ops import kernels

    def call():
        return kernels.keep_lists(traj, cand, mask)

    names = KEEP_KERNELS if keep_plan(traj, cand)["groups"] > 1 else KEEP_KERNELS[::2]
    return {k: list(launch_device_ms(call, k, reps)) for k in names}


def build_registers(log: str) -> dict:
    """{kernel: [registers, bytes of spill stores]} from nvcc's ``-Xptxas -v``
    output, for the keep-list kernels, the 12- and 27-leaf scans (the
    kernels whose registers decide how many blocks share an SM; K1's, a key
    a tile) and K3, K4 and K5 (each points-a-thread
    instantiation, and its chunk list); empty when an up-to-date library was
    found and nothing was compiled."""
    import re

    wanted = re.compile(r"(keep_lists_kernelILi\d+|segment_boxes_kernelI[fd]|group_boxes_kernel"
                        r"|(?:tiled|lookback)_scan_kernelINS_\d+(?:Filter|RtsSuffix)I[fd](?:EE[fd]Li\d+ELb[01])?"
                        r"|nn_kernelI[fd]Li\d+ELi\d+|nn_grid_kernelI[fd]|count_kernelI[fd]Li\d+|chunk_list_kernel)")
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


SCAN_KERNEL_RE = r"(cluster|lookback)_scan_kernelINS_\d+(\w+?)I([fd])EE[fd]Li(\d+)ELb([01])ELi(\d+)E"
SCAN_COMBINES = {"QuatChain": "quat_chain", "Filter": "filter", "RtsSuffix": "rts", "Mobius": "mobius",
                 "Affine3": "affine3", "Add2": "add2", "Max3": "max3", "Min3": "min3"}


def scan_kernel_registers(log: str) -> dict:
    """{"path/op/dtype/tile/threads/items": [registers, bytes of spill
    stores]} of every instantiation of K1's two kernels (``cluster`` and
    ``lookback``; tile ``ladder`` or ``runs``) in nvcc's ``-Xptxas -v``
    output; empty when an up-to-date library was found and nothing was
    compiled."""
    import re

    rx = re.compile(SCAN_KERNEL_RE)
    out, key = {}, None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            m = rx.search(line)
            key = None
            if m and m.group(2) in SCAN_COMBINES:
                dt = "float32" if m.group(3) == "f" else "float64"
                tile = "runs" if m.group(5) == "1" else "ladder"
                key = f"{m.group(1)}/{SCAN_COMBINES[m.group(2)]}/{dt}/{tile}/{m.group(6)}/{m.group(4)}"
        elif key and (m := re.search(r"(\d+) bytes spill stores", line)):
            out.setdefault(key, [None, 0])[1] = int(m.group(1))
        elif key and (m := re.search(r"Used (\d+) registers", line)):
            out.setdefault(key, [None, 0])[0] = int(m.group(1))
    return out


SASS_OPS = {"float64": ("DADD", "DMUL", "DFMA", "DSETP", "DMNMX"), "float32": ("FADD", "FMUL", "FFMA", "FSETP", "FMNMX")}
SASS_INT_OPS = ("ISETP", "SEL", "FSEL", "IMNMX", "LDS")


def sass_functions(library: str, name_re) -> dict:
    """{name: {"ins": [(address, opcode, operands)], "loops": [(first,
    last)]}} for each function of the library's SASS (``cuobjdump -sass``)
    whose name ``name_re`` matches (group 1 names it), with its innermost
    loops (a backward branch to a label or address at or before it); None
    where the toolkit has no cuobjdump."""
    import re
    import shutil

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        return None
    text = subprocess.run([tool, "-sass", library], capture_output=True, text=True, timeout=300).stdout
    ins_re = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)(.*?);")
    out, cur = {}, None
    for line in text.splitlines():
        if "Function :" in line:
            m = name_re.search(line)
            cur = out.setdefault(m.group(1), {"ins": [], "labels": {}, "match": m}) if m else None
        elif cur is not None:
            lab = re.match(r"\s*(\.L_\w+):", line)
            if lab:
                cur["labels"][lab.group(1)] = None  # the address of the next instruction
                cur["pending"] = lab.group(1)
                continue
            m = ins_re.search(line)
            if m:
                addr = int(m.group(1), 16)
                if cur.get("pending"):
                    cur["labels"][cur.pop("pending")] = addr
                cur["ins"].append((addr, m.group(2), m.group(3)))
    for f in out.values():
        loops = []
        for addr, op, args in f["ins"]:
            if not op.startswith("BRA"):
                continue
            t = re.search(r"0x([0-9a-f]+)", args)
            lab = re.search(r"\((\.L_\w+)\)", args)
            target = int(t.group(1), 16) if t else f["labels"].get(lab.group(1)) if lab else None
            if target is not None and target <= addr:
                loops.append((target, addr))
        f["loops"] = [lp for lp in loops if not any(o != lp and lp[0] <= o[0] and o[1] <= lp[1] for o in loops)]
    return out


def sass_loop_ops(f: dict, loop, ops) -> tuple:
    """({opcode: count} for ``ops``, all instructions) of one loop of a
    ``sass_functions`` entry, opcodes without their modifiers."""
    body = [op.split(".")[0] for addr, op, _ in f["ins"] if loop[0] <= addr <= loop[1]]
    return {o: body.count(o) for o in ops}, len(body)


def sass_count_loops(library: str) -> dict:
    """What the card runs for a (trial, point) pair of K5, read from the
    library's SASS: for each instantiation ``count_kernel<T, P, ...>`` (P
    points a thread), the innermost loop with the most fused multiply-adds
    (the trial walk of csrc/ransac_counts.cu, which holds no branch: the
    plain recount of the pairs the band leaves open runs after it), the
    trials it walks an iteration (one ``REDUX``, the warp's sum, a trial),
    and its instructions a (warp, trial) and a pair (over P), with each
    floating-point, compare, select, warp-sum and shared-load opcode a
    pair. Empty where the toolkit has no cuobjdump."""
    import re

    funcs = sass_functions(library, re.compile(r"Function : \S*?(count_kernelI([fd])Li(\d+)E)"))
    if funcs is None:
        return {}
    ops_of = SASS_INT_OPS + ("REDUX", "VOTE", "IADD3", "PLOP3", "LEA", "BRA")
    result = {}
    for name, f in funcs.items():
        dtype = "float64" if f["match"].group(2) == "d" else "float32"
        P = int(f["match"].group(3))
        fma_op = "DFMA" if dtype == "float64" else "FFMA"
        best = max(f["loops"], key=lambda lp: sass_loop_ops(f, lp, (fma_op,))[0][fma_op], default=None)
        if best is None:
            result[name] = {"error": "no loop found"}
            continue
        body = [op.split(".")[0] for a, op, _ in f["ins"] if best[0] <= a <= best[1]]
        trials = body.count("REDUX")
        if not trials:
            result[name] = {"error": "the loop holds no warp sum"}
            continue
        counted = {o: body.count(o) for o in SASS_OPS[dtype] + ops_of if body.count(o)}
        result[name] = {"dtype": dtype, "points_a_thread": P, "trials_in_loop": trials,
                        "instructions_per_warp_trial": len(body) / trials,
                        "instructions_per_pair": len(body) / trials / P,
                        "per_pair": {o: c / trials / P for o, c in counted.items()}}
    return result


def sass_tile_loops(library: str) -> dict:
    """What the card runs for a (query, candidate) pair, read from the
    library's SASS (``cuobjdump -sass``): for each instantiation of K3
    (``nn_kernel<T, queries a block, Q>``) and K4 (``nn_grid_kernel<T>``),
    the innermost loop with the most floating-point adds (the unrolled
    tile scan of csrc/nn_tile.cuh: three differences a pair), its pairs
    (its minima, one a pair: DSETP in float64, FMNMX in float32; where a
    float64 minimum takes no DSETP, its 16-byte shared loads, three a
    vector of 2 candidates, times the Q queries a thread holds) and each
    floating-point, compare, select and shared-load opcode per pair, with
    all its instructions per pair. Empty where the toolkit has no
    cuobjdump; an entry with "error" where the loop is not found."""
    import re

    funcs = sass_functions(library, re.compile(r"Function : \S*?(nn_kernelI([fd])Li(\d+)ELi(\d+)E|nn_grid_kernelI([fd])E)"))
    if funcs is None:
        return {}
    result = {}
    for name, f in funcs.items():
        m = f["match"]
        dtype = "float64" if (m.group(2) or m.group(5)) == "d" else "float32"
        q = int(m.group(4)) if m.group(4) else 1
        add = "DADD" if dtype == "float64" else "FADD"
        best = max(f["loops"], key=lambda lp: sass_loop_ops(f, lp, (add,))[0][add], default=None)
        if best is None or sass_loop_ops(f, best, (add,))[0][add] == 0:
            result[name] = {"error": "no loop with floating-point adds found"}
            continue
        ops, total = sass_loop_ops(f, best, SASS_OPS[dtype] + SASS_INT_OPS)
        minimum = ops["DSETP" if dtype == "float64" else "FMNMX"]
        pairs = minimum or ops["LDS"] / 3 * 2 * q
        result[name] = {"pairs_in_loop": pairs, "instructions_per_pair": total / pairs if pairs else None,
                        "per_pair": {o: c / pairs for o, c in ops.items() if c} if pairs else ops}
    return result


def launch_counts() -> dict:
    """Every kernel wrapper's launch count, by entry name."""
    from gps_optimize_slam_tpu_torch.ops import kernels, scan

    counts = {f"scan_block/{op}": c for op, c in scan.scan_block.launches.items()}
    counts.update({f"scan_tiled/{op}": c for op, c in scan.scan_tiled.launches.items()})
    counts.update(nn_keep=kernels.keep_lists.launches, nn_resident=kernels.nn_resident.launches,
                  nn_grid=kernels.nn_grid.launches, ransac_counts=kernels.ransac_counts.launches,
                  pose_cg=kernels.pose_cg.launches)
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
    kernels.pose_cg.launches = 0


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
                 dev_ms=None, library_dev_ms=None):
    """One entry of the ``{"kernels": [...]}`` line; ``device_ms`` is the
    call's device time alone (``device_ms``), where it was taken, and
    ``library_device_ms`` the library call's; ``bound_bytes_ms`` and
    ``bound_operations_ms`` the two terms of ``bound_ms``, and
    ``unfused_operations_ms`` the operations with no multiply-add
    contracted, as the kernels are built."""
    return {"name": name, "route": "cuda", "source": f"gps_optimize_slam_tpu_torch/csrc/{source}",
            "replaces": f"gps_optimize_slam_tpu/ops/{replaces}", "dtype": dtype,
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms_by[0],
            "bound_by": bound_ms_by[1], "library_ms": library_ms, "device_ms": dev_ms,
            "library_device_ms": library_dev_ms, "bound_bytes_ms": bound_ms_by[2],
            "bound_operations_ms": bound_ms_by[3], "unfused_operations_ms": bound_ms_by[4]}


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
        lib_dev = library_device_ms(op, x, rev)
        emit({"phase": 1, "kernel": f"scan_block/{op}", "rel_err": worst, "ms": ms,
              "plain_ms": plain_ms, "library_ms": lib_ms, "device_ms": dev,
              "host_ms": host_ms(lambda: scan.scan_block(op, x, rev)),
              "library_device_ms": lib_dev,
              "library_host_ms": None if lib is None else host_ms(lib),
              "shape": list(x.shape), "dtype": "float32"})
        entries.append(kernel_entry(f"scan_block/{op}", "scan.cu", "pallas_scan.py:227", "float32",
                                    aerr, ms, plain_ms, scan_bound(op, x), lib_ms, dev, lib_dev))
        if op == "filter":  # registers and spill bytes, a dtype and tile each
            entries[-1]["registers_and_spills"] = filter_registers()
    return entries


def filter_registers() -> dict:
    """{dtype: {tile: [registers, spill bytes]}} of K1's filter, its ladder
    tile (a single row of the main path) and its runs tile, from the
    build's ``-Xptxas -v``; empty where nothing was compiled."""
    from gps_optimize_slam_tpu_torch.ops import _build

    regs = build_registers(_build.BUILD_INFO.get("log", ""))
    out = {}
    for dtype, c in (("float32", "f"), ("float64", "d")):
        for name, v in regs.items():
            if name.startswith(f"lookback_scan_kernelINS_6FilterI{c}EE"):
                out.setdefault(dtype, {})["runs" if name.endswith("Lb1") else "ladder"] = v
    return out


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
                "library_device_ms": library_device_ms(op, x, rev),
                "bound": scan_bound(op, x), "max_abs_err": aerr,
            }
        emit({"phase": 1, "kernel": f"scan_tiled/{op}", "rel_err": worst, "n": TILED_N,
              "lengths": list(TILED_LENGTHS),
              "tile": {dtype_name(d): scan.tiled_tile(op, d) for d in (torch.float32, torch.float64)},
              "times": times})
        t = times["float64"]  # the chunked path runs in float64 (phase 5)
        entries.append(kernel_entry(f"scan_tiled/{op}", "scan_tiled.cu", "pallas_scan.py:361", "float64",
                                    t["max_abs_err"], t["ms"], t["plain_ms"], t["bound"], t["library_ms"],
                                    t["device_ms"], t["library_device_ms"]))
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
        win[name] = {"rel_err": err, **launch_times(traj, cand, mask, got),
                     "ms": cuda_ms(lambda: kernels.nn_grid(traj, cand, mask)),
                     "device_ms": device_ms(lambda: kernels.nn_grid(traj, cand, mask)),
                     "k3_ms": cuda_ms(lambda: kernels.nn_resident(traj, cand, mask)),
                     "k3_device_ms": device_ms(lambda: kernels.nn_resident(traj, cand, mask)),
                     "kept_tile_pairs": int(kernels.keep_lists(traj, cand, mask)[1].sum()),
                     "route": kernels.nn_route(cand.shape[0], traj.shape[0]), "bound": nn_bound(traj, cand, mask),
                     "library_ms": cdist_library_ms(traj, cand, mask),
                     "sort_candidates": sort_candidates_times(traj, cand, mask, got)}
    emit({"phase": 1, "kernel": "nn_grid", "shape": list(GRID_NN_WIN), "shuffled": True, "equal_to_k3": True,
          "checks": win})
    main = {}
    for name, (traj, cand, mask, got, want, err) in check_grid(GRID_NN_MAIN, PLAIN_STRIDE).items():
        main[name] = {"rel_err": err, **launch_times(traj, cand, mask, got),
                      "ms": cuda_ms(lambda: kernels.nn_grid(traj, cand, mask), reps=5),
                      "device_ms": device_ms(lambda: kernels.nn_grid(traj, cand, mask), reps=5),
                      "k3_ms": cuda_ms(lambda: kernels.nn_resident(traj, cand, mask), reps=5),
                      "bound": nn_bound(traj, cand, mask)}
    emit({"phase": 1, "kernel": "nn_grid", "shape": list(GRID_NN_MAIN), "plain_queries_every": PLAIN_STRIDE,
          "equal_to_k3": True, "checks": main})
    torch.cuda.empty_cache()
    return entries


# K3's block sizes in phase 1: single rows of n = m random-walk poses, from
# the main path's 37 query tiles to phase 5's 4,096, and the fleet bucket
# (2,368 query tiles of 64 rows).
TIER_LENGTHS = (SEQ02_LEN, 32_768, 65_536, 131_072, 262_144, CHUNK)


def phase1_tiers(device, gen):
    """K3's launch alone (``kernels.resident_launch`` on operands made
    beforehand) at every block size it has, on the same inputs, float32 and
    float64: at ``TIER_LENGTHS`` and the fleet bucket, each block size's
    minima bit for bit those of the others, of the wrapper and of K4; the
    device time of each (the profiler's, the kernel alone) and the block
    size ``kernels.resident_block`` picks: the times that set its tiers
    (``launch_device_ms``: a launch's time from the launches traced)."""
    import torch

    from gps_optimize_slam_tpu_torch.ops import kernels

    times = {}
    cases = [((n,), (n,)) for n in TIER_LENGTHS] + [((FLEET[1],) * FLEET[0],) * 2]
    for dtype in (torch.float32, torch.float64):
        for ns, ms in cases:
            traj, cand, mask = ragged_walks(gen, ns, ms, dtype, device)
            if len(ns) == 1:
                traj, cand, mask = traj[0], cand[0], mask[0]
            operands = kernels.keep_lists(traj, cand, mask)
            got = kernels.nn_resident(traj, cand, mask)
            k4 = kernels.nn_grid(traj, cand, mask)
            torch.cuda.synchronize()
            if not torch.equal(got, k4):
                raise AssertionError(f"tiers {len(ns)}x{ns[0]} {dtype}: K3 differs from K4")
            res = {}
            for block in kernels.RESIDENT_BLOCKS:
                out = kernels.resident_launch(traj, operands, block)
                torch.cuda.synchronize()
                if not torch.equal(out, got):
                    raise AssertionError(f"tiers {len(ns)}x{ns[0]} {dtype}: {block} queries a block differ from "
                                         f"the wrapper's launch in {int((out != got).sum())} queries")
                res[str(block)] = launch_device_ms(lambda: kernels.resident_launch(traj, operands, block),
                                                   "nn_kernel")[0]
            tiles = len(ns) * operands[0].shape[-2]
            times[f"{len(ns)}x{ns[0]}/{dtype_name(dtype)}"] = {
                "query_tiles": tiles, "kept_tile_pairs": int(operands[1].sum()),
                "picked": kernels.resident_block(tiles), "device_ms": res}
            del traj, cand, mask, operands, got, k4
            torch.cuda.empty_cache()
    emit({"phase": 1, "tiers": "nn_resident", "times": times})


def launch_times(traj, cand, mask, got) -> dict:
    """K4's launch alone on one set of operands, as ``nn_grid`` makes it
    (the grid sized from the card, the blocks drawing the items of the work
    list whose length they read on the device), held to ``got`` (K3's
    minima) bit for bit: its CUDA-event ms, the list's items and kept tile
    pairs."""
    import torch

    from gps_optimize_slam_tpu_torch.ops import kernels

    operands = kernels.nn_grid_operands(traj, cand, mask)
    out = kernels.grid_launch(traj, operands)
    torch.cuda.synchronize()
    if not torch.equal(out, got):
        raise AssertionError("K4's launch with the device-read count differs from K3")
    return {"items": int(operands[3].reshape(-1)[-1]), "kept_tile_pairs": int(operands[1].sum()),
            "kernel_ms": cuda_ms(lambda: kernels.grid_launch(traj, operands), reps=5)}


def sort_candidates_times(traj, cand, mask, got) -> dict:
    """``kernels.nn_min_dist2`` with ``sort_candidates`` off and on: call
    ms and the kept tile pairs of the candidates it hands the keep lists
    (the Morton sort's are those of ``morton_sort_candidates``); the sorted
    call's minima equal ``got`` (the unsorted K4 call's) bit for bit, a
    minimum not depending on the order."""
    import torch

    from gps_optimize_slam_tpu_torch.ops import kernels

    out = {}
    for on in (False, True):
        c, m = kernels.morton_sort_candidates(cand, mask) if on else (cand, mask)
        if not torch.equal(kernels.nn_min_dist2(traj, cand, mask, sort_candidates=on), got):
            raise AssertionError(f"nn_min_dist2(sort_candidates={on}) differs from K4 unsorted")
        out["on" if on else "off"] = {
            "ms": cuda_ms(lambda: kernels.nn_min_dist2(traj, cand, mask, sort_candidates=on)),
            "kept_tile_pairs": int(kernels.keep_lists(traj, c, m)[1].sum())}
    return out


def plain_keep_lists(traj, cand, mask):
    """(order, nkept, cand3) of the keep-list kernel's plain version, with
    the inputs' batch axis if they have one."""
    from gps_optimize_slam_tpu_torch.ops import kernels

    order, nkept = kernels.keep_lists_plain(kernels.tile_keep_mask(*kernels.bounds_operands(traj, cand, mask)))
    return order, nkept, kernels.pack_candidates_plain(cand, mask, order.shape[-1])


def phase1_keep(device, gen):
    """The keep-list kernel: its lists equal the plain mask's compaction
    (the same float64 bounds in the same order; the kernel's group- and
    tile-level tests are exact) and its packed candidates the plain
    packing, float32 and float64 coordinates: at seq-02's length (37 query
    tiles, a warp each, one group), with one candidate tile, at UTM
    magnitudes, with whole tiles and runs of segments masked out, at K4's
    shuffled 700 x 524,288 (6 query tiles of 8 warps each over 16 groups,
    every tile kept) and at phase 5's NN block (4,096 query tiles, a warp
    each, 16 groups); each also with every candidate masked (every tile
    kept, as in the JAX mask). Times at 524,288 x 524,288 in float64
    (phase 5's shape): the call, its device time by kernel, each launch's,
    the regime, and the bytes bound beside the operations bound of taking
    every segment pair."""
    import torch

    from gps_optimize_slam_tpu_torch.ops import kernels

    def check(traj, cand, mask, what):
        order, nkept, cand3 = kernels.keep_lists(traj, cand, mask)
        want_order, want_nkept, want_cand3 = plain_keep_lists(traj, cand, mask)
        if not torch.equal(nkept, want_nkept):
            raise AssertionError(f"keep lists {what}: counts differ in "
                                 f"{int((nkept != want_nkept).sum())} query tiles")
        cols = torch.arange(order.shape[1], device=device)[None] < nkept[:, None]
        if not torch.equal(torch.where(cols, order, -1), torch.where(cols, want_order, -1)):
            raise AssertionError(f"keep lists {what}: the lists differ")
        if not torch.equal(cand3, want_cand3):
            raise AssertionError(f"keep lists {what}: the packed candidates differ")
        return nkept, want_nkept, order.numel(), cand3

    # (queries, candidates, coordinate offset, "part-masked", "shuffled" or "")
    cases = ((SEQ02_LEN, SEQ02_LEN, 0.0, ""), (SEQ02_LEN, 777, 0.0, ""),
             (SEQ02_LEN, SEQ02_LEN, 5.4e6, ""), (SEQ02_LEN, 9000, 0.0, "part-masked"),
             GRID_NN_WIN + (0.0, "shuffled"), GRID_NN_MAIN + (0.0, ""))
    checks = {}
    for n, m, offset, kind in cases:
        for dtype in (torch.float32, torch.float64):
            traj = walk(gen, n, torch.float64, device) + offset
            cand = walk(gen, m, torch.float64, device) + (offset + 0.3)
            if kind == "shuffled":
                cand = cand[torch.randperm(m, generator=gen).to(device)].contiguous()
            traj, cand = traj.to(dtype), cand.to(dtype)
            mask = (torch.rand(m, generator=gen) > 0.1).to(device)
            if kind == "part-masked":  # a whole tile, a run of segments, and a tile with one fix left
                mask[:1024] = False
                mask[3000:3100] = False
                mask[8192:] = False
                mask[8500] = True
            what = f"{n}x{m}/{dtype_name(dtype)}" + ("/utm" if offset else "") + (f"/{kind}" if kind else "")
            nkept, want_nkept, pairs, cand3 = check(traj, cand, mask, what)
            # Every candidate masked: no finite upper bound, every tile kept
            # (as in the JAX mask); K3 and K4 then give +inf.
            check(traj, cand, torch.zeros_like(mask), what + "/all-masked")
            checks[what] = {"kept_tile_pairs": int(nkept.sum()), "tile_pairs": pairs, **keep_plan(traj, cand)}
    splits = sorted({c["warps_a_query_tile"] for c in checks.values()})
    if splits != [1, 8]:  # seq-02's rows take one warp a query tile, K4's shuffled shape eight
        raise AssertionError(f"keep lists: the checks took {splits} warps a query tile, not 1 and 8")
    ms = cuda_ms(lambda: kernels.keep_lists(traj, cand, mask))
    plain_ms = cuda_ms(lambda: plain_keep_lists(traj, cand, mask), reps=3)
    by_kernel = device_profile(lambda: kernels.keep_lists(traj, cand, mask), reps=5)
    dev = sum(by_kernel.values())
    aerr = float((nkept - want_nkept).abs().max())
    bound_ms_by = keep_bound(traj, cand, mask, nkept, cand3)
    emit({"phase": 1, "kernel": "nn_keep", "equal_to_plain": True, "checks": checks, "ms": ms,
          "plain_ms": plain_ms, "device_ms": dev, "device_ms_by_kernel": by_kernel,
          "launch_device_ms": keep_launch_ms(traj, cand, mask), **keep_plan(traj, cand),
          "bound_ms": bound_ms_by[0], "all_segment_pairs_bound_ms": keep_all_pairs_ms(traj, cand),
          "shape": list(GRID_NN_MAIN), "dtype": "float64"})
    entry = kernel_entry("nn_keep", "nn_keep.cu", "pallas_kernels.py:174", "float64", aerr, ms, plain_ms,
                         bound_ms_by, None, dev)
    del cand3
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
    """The times that place the scans' routing thresholds on this card,
    each pair on the same inputs: K1 against K2 (both held against the
    plain version) for every combine in both dtypes at ``ROUTE_LENGTHS``
    and at the last length within the JAX package's 4 MiB budget, with the
    library call where there is one, and K1's batch grid against K2's at
    ``ROUTE_BATCHES`` (``scan.scan_route``'s single-row rule is set from
    these times, its batch rule from ``tools/scan_launch_compare.py
    --kernel k2 --route``)."""
    import torch

    from gps_optimize_slam_tpu_torch.ops import scan

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
                "route": scan.scan_route(x.shape[0], n, x.element_size(), b, op)}
            del x, k1, k2
        torch.cuda.empty_cache()
    emit({"phase": 1, "routes": "scan@batch", "times": batches})


def phase1_nn_routes(device, gen):
    """K3 against K4, bit for bit equal, at 16,384 queries and
    ``ROUTE_CANDIDATES`` candidates on random walks and at
    ``ROUTE_LONG_LISTS`` with shuffled candidates: each call's CUDA-event
    and device time, the kept tile pairs and, where its matrix fits, the
    library yardstick (``kernels.nn_route`` is set from these times and
    phase 5's block in ``phase1_nn``)."""
    import torch

    from gps_optimize_slam_tpu_torch.ops import kernels

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

    from gps_optimize_slam_tpu_torch.ops import _build, kernels
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
          "count_kernel_ms": launch_device_ms(lambda: kernels.ransac_counts(*args), "count_kernel")[0],
          "host_ms": host_ms(lambda: kernels.ransac_counts(*args)), "recounted_share": recounted_share(args),
          "sass_count_loops": sass_count_loops(_build.BUILD_INFO["path"]),
          "cases": [list(c) for c in COUNT_CASES], "shape": [1000, SEQ02_LEN], "dtype": "float32"})
    return [kernel_entry("ransac_counts", "ransac_counts.cu", "pallas_kernels.py:450", "float32",
                         float(diff32), ms, plain_ms, count_bound(args), None, dev)]


def phase1_pose_cg(device, gen):
    """The pose graph's CG kernel at the refine's own step: the 4,541-pose
    shuttle fused on the card in float64, its 32 closures proposed, the
    factors' blocks taken at the fused trajectory (``pose_graph._linearise``),
    50 iterations. δ within TOL of ``pose_cg_plain`` on CPU copies of the
    same operands, the same count of active iterations (all 50), two
    launches bit-equal; call ms, the plain version's ms on the card (ATen)
    and the launch's device ms, all from this run."""
    import torch

    from gps_optimize_slam_tpu_torch import pipeline
    from gps_optimize_slam_tpu_torch.models import pose_graph
    from gps_optimize_slam_tpu_torch.ops import kernels

    slam, gt, gp = shuttle_sequence()
    res = pipeline.fuse_arrays(slam, shuttle_gps(gt, gp), dtype=torch.float64, device=device)
    o = res.outputs
    times = torch.as_tensor(slam["timestamps"], dtype=torch.float64, device=device)
    loops = pose_graph.propose_loop_closures(o.corrected_pos, times, o.sim3_quat, radius=REFINE["loop_radius"],
                                             min_time_gap=REFINE["loop_min_time_gap"],
                                             max_loops=REFINE["max_loops"])
    data = pose_graph.build_data_from_fusion(o.sim3_pos, o.sim3_quat, o.aligned_gps, o.gps_valid, *loops)
    lin = pose_graph._linearise(pose_graph.PoseGraphState(o.corrected_pos, o.corrected_quat), data)
    args = (lin.blocks, lin.r0, lin.r_gps, data.gps_valid, data.w_gps, data.loop_ij, 1e-6, POSE_CG_ITERS)
    got, count = kernels.pose_cg(*args)
    again, count_again = kernels.pose_cg(*args)
    torch.cuda.synchronize()
    want, want_count = kernels.pose_cg_plain(*(a.cpu() if torch.is_tensor(a) else a for a in args))
    err = rel_err(got.cpu(), want)
    closures = int(loops[3].sum())
    what = f"pose_cg float64 {SHUTTLE_N} poses, {closures} closures"
    if not torch.equal(got, again) or not torch.equal(count, count_again):
        raise AssertionError(f"{what}: two launches on the same inputs differ")
    if not err <= TOL["float64"] or not int(count) == int(want_count) == POSE_CG_ITERS:
        raise AssertionError(f"{what}: {err} off the plain version, counts {int(count)} / {int(want_count)}")
    ms = cuda_ms(lambda: kernels.pose_cg(*args))
    plain_ms = cuda_ms(lambda: kernels.pose_cg_plain(*args), reps=3)
    dev, traced = launch_device_ms(lambda: kernels.pose_cg(*args), "pose_cg")
    by = pose_cg_bound(args)
    emit({"phase": 1, "kernel": "pose_cg", "poses": SHUTTLE_N, "closures": closures, "iterations": POSE_CG_ITERS,
          "max_rel_err": err, "active_iterations": int(count), "identical_runs": True, "ms": ms,
          "plain_ms": plain_ms, "device_ms": dev, "traced_launches": traced, "bound_ms": by[0],
          "bound_bytes_ms": by[2], "bound_operations_ms": by[3], "dtype": "float64"})
    entry = kernel_entry("pose_cg", "pose_cg.cu", "", "float64", err, ms, plain_ms, by, None, dev)
    entry["replaces"] = "gps_optimize_slam_tpu/models/pose_graph.py"  # no TPU kernel: jax.scipy's CG
    return [entry]


def pose_cg_bound(args):
    """pose_cg's least time on ``args``: the blocks, r0, the GNSS residual
    and mask and the closures' pairs read once and δ written once, and in
    each iteration x, r, p and Ap (N × 6 each) read once and written once
    (a floor at the memory's rate: the vectors may stay in L2 or shared
    memory); ``POSE_CG_FACTOR_FLOPS`` a factor and ``POSE_CG_POSE_FLOPS`` a
    pose an iteration, and b = −Jᵀr0 once."""
    blocks, r0, r_gps, valid, loop_ij, iters = args[0], args[1], args[2], args[3], args[5], args[7]
    size, m, n = blocks.element_size(), blocks.shape[0], valid.shape[0]
    once = (blocks.numel() + r0.numel() + r_gps.numel() + 6 * n) * size + valid.numel() + 8 * loop_ij.numel()
    moved = once + iters * 8 * 6 * n * size
    flops = iters * (POSE_CG_FACTOR_FLOPS * m + POSE_CG_POSE_FLOPS * n) + 132 * m
    return bound(moved, flops, dtype_name(blocks.dtype))


def count_bound(args):
    """K5's least time on ``args``: the valid points (p and d) and every
    trial read once, the mask read once, the counts written once; 30
    operations for each (trial, valid point) pair, the only pairs the counts
    need (a masked point's pairs are no work of the function's)."""
    src, valid, R = args[0], args[2], args[3]
    T, rows = R.shape[-3], valid.numel() // valid.shape[-1]
    nv = int(valid.sum())
    moved = (6 * nv + 13 * rows * T) * src.element_size() + valid.numel() + 4 * rows * T
    return bound(moved, COUNT_FLOPS * T * nv, dtype_name(src.dtype))


def recounted_share(args) -> float:
    """The share of (trial, valid point) pairs that K5's band left open and
    the kernel recounted in the plain order, on ``args``."""
    import torch

    from gps_optimize_slam_tpu_torch.ops import kernels

    rc = torch.zeros(1, dtype=torch.int64, device=args[0].device)
    kernels.counts_launch(*args, recounted=rc)
    pairs = int(args[2].sum()) * args[3].shape[-3]
    return int(rc) / max(pairs, 1)


def near_threshold_counts(gen, B: int, n: int, trials: int, dtype, device):
    """An adversarial batch for K5: random-walk points, trial 0 of each row
    a Umeyama fit and every dst its prediction s R p + t plus 4 m (the
    threshold's root) along a random direction, nudged by up to 4 ulps a
    coordinate; the other trials trial 0 with its translation moved by 1e-4
    m. Most pairs' plain residual lies within a few parts in 1e4 of thr2,
    many within a few ulps."""
    import torch

    from gps_optimize_slam_tpu_torch.ops.umeyama import umeyama_sim3

    f64 = torch.float64
    src = torch.stack([walk(gen, n, f64, device, scale=2.0) for _ in range(B)])
    noisy = 0.987 * src + 2.0 * torch.randn(B, n, 3, generator=gen, dtype=f64).to(device)
    draws = torch.randint(0, n, (B, 1, 4), generator=gen).to(device)
    pick = torch.arange(B, device=device)[:, None, None]
    src = src.to(dtype)
    fit = umeyama_sim3(src[pick, draws], noisy.to(dtype)[pick, draws])
    R = fit.R.expand(B, trials, 3, 3).contiguous()
    s = fit.scale.expand(B, trials).contiguous()
    t = fit.t.expand(B, trials, 3) + 1e-4 * torch.randn(B, trials, 3, generator=gen, dtype=f64).to(device)
    t[:, 0] = fit.t[:, 0]
    t = t.to(dtype).contiguous()
    v = torch.randn(B, n, 3, generator=gen, dtype=f64).to(device)
    v = v / v.norm(dim=-1, keepdim=True)
    pred = s[:, 0, None, None].double() * torch.einsum("bjk,bnk->bnj", R[:, 0].double(), src.double())
    dst = (pred + t[:, 0, None].double() + 4.0 * v).to(dtype)
    for _ in range(4):
        k = torch.randint(-1, 2, dst.shape, generator=gen).to(device)
        dst = torch.where(k > 0, torch.nextafter(dst, torch.full_like(dst, float("inf"))),
                          torch.where(k < 0, torch.nextafter(dst, torch.full_like(dst, -float("inf"))), dst))
    valid = (torch.rand(B, n, generator=gen) > 0.05).to(device)
    return (src, dst.contiguous(), valid, R, t, s, 16.0)


def fleet_count_operands(device):
    """K5's operands as the fleet bucket's fusion hands them (phase 7's 64
    ``replica_sequence`` rows, float32): the Sim(3) window mask a row
    (``alignment.sim3_window_mask``) and the row's 1000 trials, recorded
    from one eager ``fuse_batch``."""
    import torch

    from gps_optimize_slam_tpu_torch.config import FusionConfig
    from gps_optimize_slam_tpu_torch.ops import ransac
    from gps_optimize_slam_tpu_torch.parallel import batch as pbatch
    from gps_optimize_slam_tpu_torch.parallel import mesh
    from gps_optimize_slam_tpu_torch.utils import graphs

    B, n = FLEET
    seqs = [replica_sequence(n, seed=200 + i) for i in range(B)]
    b = pbatch.pad_batch([s for s, _, _ in seqs], [t for _, t, _ in seqs], [p for _, _, p in seqs])
    staged = mesh.stage_batch(b, device=device, dtype=torch.float32)
    calls = []
    with recording(ransac, "ransac_counts", calls), graphs.eager():
        mesh.fuse_batch(staged, config=FusionConfig(gps_sorted=True))
    return calls[0]


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


def batched_scan_paths(op: str) -> dict:
    """{dtype: {shape: {"tile", "cluster", "registers_and_spills"}}} of K1's
    launch at phase 1's two batches and phase 10's rows: its tile, its
    cluster size (0: the look-back path) and the registers and spill bytes
    of the kernel it launches (``scan_kernel_registers``; none where an
    up-to-date library was found)."""
    import torch

    from gps_optimize_slam_tpu_torch.ops import _build, scan

    regs = scan_kernel_registers(_build.BUILD_INFO.get("log", ""))
    out = {}
    for dtype in (torch.float32, torch.float64):
        name = dtype_name(dtype)
        for label, (B, n) in (("kitti", (len(KITTI_LENGTHS), max(KITTI_LENGTHS))), ("fleet", FLEET),
                              ("phase10", (len(LONG_LOG_LENGTHS), max(LONG_LOG_LENGTHS)))):
            tile, cluster = scan.block_tile(op, dtype, n, B), scan.block_cluster(op, dtype, n, B)
            path = "cluster" if cluster else "lookback"
            kernel = {k: v for k, v in regs.items() if k.startswith(f"{path}/{op}/{name}/")
                      and int(k.split("/")[-2]) * int(k.split("/")[-1]) == tile}
            out.setdefault(name, {})[label] = {"tile": tile, "cluster": cluster, "registers_and_spills": kernel}
    return out


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
        lib_dev = library_device_ms(op, x, rev)
        emit({"phase": 1, "kernel": f"scan_block/{op}@batch", "rel_err": worst, "ms": ms, "plain_ms": plain_ms,
              "library_ms": lib_ms, "device_ms": dev, "library_device_ms": lib_dev,
              "rows_within_tol_of_k1_alone": True,
              "shape": list(x.shape), "dtype": "float32", "ragged_rows": list(KITTI_LENGTHS),
              "paths": batched_scan_paths(op)})
        source = "scan_cluster.cu" if scan.block_cluster(op, x.dtype, x.shape[-1], x.shape[1]) else "scan.cu"
        entries.append(kernel_entry(f"scan_block/{op}@batch", source, "pallas_scan.py:227", "float32", aerr,
                                    ms, plain_ms, scan_bound(op, x), lib_ms, dev, lib_dev))
    return entries


def phase1_batched_nn(device, gen):
    """The keep lists and K3 with a batch grid, float32 and float64: the
    eleven KITTI lengths as one ragged batch (its last row all-masked), the
    fleet bucket (64 x 4,661: 2,368 query tiles, so the batch takes K3's
    64-query blocks where each row alone takes 16), one row, and in float64
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
            order, nkept, cand3 = kernels.keep_lists(traj, cand, mask)
            got = kernels.nn_resident(traj, cand, mask)
            torch.cuda.synchronize()
            w_order, w_nkept, w_cand3 = plain_keep_lists(traj, cand, mask)
            cols = torch.arange(order.shape[-1], device=device) < nkept[..., None]
            if not (torch.equal(nkept, w_nkept) and torch.equal(torch.where(cols, order, -1), torch.where(cols, w_order, -1))
                    and torch.equal(same_bits(cand3), same_bits(w_cand3))):
                raise AssertionError(f"batched keep lists {what}: differ from the plain ones")
            want = kernels.nn_min_dist2_plain(traj, cand, mask, block=128)
            err = rel_err(got, want)
            if not err <= TOL[name]:
                raise AssertionError(f"batched nn {what}: rel err {err:.3e}")
            for r in (range(len(ns)) if len(ns) != FLEET[0] else (0, len(ns) - 1)):
                o1, k1, c1 = kernels.keep_lists(traj[r], cand[r], mask[r])
                c = torch.arange(o1.shape[-1], device=device) < k1[:, None]
                if not (torch.equal(k1, nkept[r]) and torch.equal(torch.where(c, o1, -1), torch.where(c, order[r], -1))
                        and torch.equal(same_bits(c1), same_bits(cand3[r]))):
                    raise AssertionError(f"batched keep lists {what}: row {r} differs from the call alone")
                if not torch.equal(kernels.nn_resident(traj[r], cand[r], mask[r]), got[r]):
                    raise AssertionError(f"batched nn {what}: row {r} differs from K3 alone")
            if len(ns) > 1 and not bool(torch.isinf(got[-1]).all()):
                raise AssertionError(f"batched nn {what}: the all-masked row must give +inf")
            nn_err[name] = max(nn_err.get(name, 0.0), err)
            checks[what] = {"kept_tile_pairs": int(nkept.sum()), "tile_pairs": order.numel()}
            if len(ns) == FLEET[0] and dtype == torch.float32:
                timed = (traj, cand, mask, abs_err(got, want), float((nkept - w_nkept).abs().max()), nkept, cand3)
            del want, w_order, w_cand3
    traj, cand, mask, aerr, keep_err, nkept, cand3 = timed

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
    from gps_optimize_slam_tpu_torch.ops import _build

    emit({"phase": 1, "kernel": "nn_resident@batch", "rel_err": nn_err, "ms": ms, "plain_ms": plain_ms,
          "library_ms": library_ms, "device_ms": sum(by_kernel.values()), "device_ms_by_kernel": by_kernel,
          "keep_ms": keep_ms, "keep_plain_ms": keep_plain_ms, "keep_device_ms": keep_dev,
          "keep_launch_device_ms": keep_launch_ms(traj, cand, mask), "keep_plan": keep_plan(traj, cand),
          "queries_a_block": kernels.resident_block(traj.shape[0] * kernels._tiles(traj.shape[1], 1)[0]),
          "kept_tile_pairs": int(nkept.sum()), "sass_tile_loops": sass_tile_loops(_build.BUILD_INFO["path"]),
          "rows_equal_to_the_calls_alone": True, "checks": checks, "shape": list(traj.shape), "dtype": "float32"})
    torch.cuda.empty_cache()
    return [kernel_entry("nn_keep@batch", "nn_keep.cu", "pallas_kernels.py:174", "float32", keep_err, keep_ms,
                         keep_plain_ms, keep_bound(traj, cand, mask, nkept, cand3), None, keep_dev),
            kernel_entry("nn_resident@batch", "nn.cu", "pallas_kernels.py:283", "float32", aerr, ms, plain_ms,
                         nn_bound(traj, cand, mask), library_ms, sum(by_kernel.values()))]


# K2's batch grid in phase 1: four ragged float64 rows around phase 5's
# chunk length (the last with fewer tiles than the card has persistent
# blocks), and four rows of 20,001 (fewer tiles in all than blocks).
TILED_BATCH = (CHUNK + 1, 393_217, 300_001, 20_001)
TILED_BATCH_FEW = (20_001,) * 4
FUSE_BATCH = (70_001,) * 2  # the fuse-batch command's two logs of 70,000 poses (phase 10), a scan row each
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


TILED_GRID_RE = r"tiled_grid_kernelINS_\d+(\w+?)I([fd])EE[fd]NS_\d+GridOfIS\d+_[fd]EEEE"


def tiled_grid_layouts() -> dict:
    """{"op/dtype": layout} of K2's batch grid on this card
    (``scan.tiled_grid_layout``: compute warps, items a thread, stages,
    tile, blocks an SM, shared-memory bytes), each with the registers and
    spill bytes of its instantiation (nvcc's ``-Xptxas -v``; none where an
    up-to-date library was found)."""
    import re

    import torch

    from gps_optimize_slam_tpu_torch.ops import _build, scan

    _build.library()  # the log is the build's
    regs, key = {}, None
    for line in _build.BUILD_INFO.get("log", "").splitlines():
        if "Compiling entry function" in line:
            m = re.search(TILED_GRID_RE, line)
            key = (f"{SCAN_COMBINES[m.group(1)]}/{'float32' if m.group(2) == 'f' else 'float64'}"
                   if m and m.group(1) in SCAN_COMBINES else None)
        elif key and (m := re.search(r"(\d+) bytes spill stores", line)):
            regs.setdefault(key, [None, 0])[1] = int(m.group(1))
        elif key and (m := re.search(r"Used (\d+) registers", line)):
            regs.setdefault(key, [None, 0])[0] = int(m.group(1))
    out = {}
    for op in scan.OPS:
        for dtype in (torch.float32, torch.float64):
            key = f"{op}/{dtype_name(dtype)}"
            out[key] = {**scan.tiled_grid_layout(op, dtype), "registers_and_spills": regs.get(key)}
    return out


def phase1_batched_tiled_scan(device, gen):
    """K2's batch grid, every combine in the directions the main path scans
    it, float64: ``TILED_BATCH``, ``TILED_BATCH_FEW`` and ``FUSE_BATCH``
    (the fuse-batch command's two logs), one launch each, against the
    batched plain ladder and, row by row, against K2 on that row alone
    (and, forward, on its real elements alone): bit for bit where the
    combine is exact (add2 on counts, max3, min3), to TOL elsewhere, since
    a row alone takes the single-row kernel's tile and the batch grid its
    own. The grid's layout a combine and dtype (``tiled_grid_layouts``) on a
    line before. Times at ``TILED_BATCH`` beside K1's batch grid on the same
    leaves, with the bound over all rows and the library call where there
    is one; the device times at ``FUSE_BATCH`` beside K1's."""
    import torch

    from gps_optimize_slam_tpu_torch.ops import scan

    emit({"phase": 1, "kernel": "scan_tiled@batch", "grid_layouts": tiled_grid_layouts()})
    entries = []
    for op in scan.OPS:
        worst = 0.0
        for ns in (TILED_BATCH, TILED_BATCH_FEW, FUSE_BATCH):
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
                if ns == FUSE_BATCH and rev == REVERSE_OF.get(op, False):
                    fuse = {"device_ms": device_ms(lambda: scan.scan_tiled(op, x, rev)),
                            "k1_batch_device_ms": device_ms(lambda: scan.scan_block(op, x, rev)),
                            "bound": scan_bound(op, x),
                            "route": scan.scan_route(x.shape[0], x.shape[-1], x.element_size(), x.shape[1], op)}
                del got, want
        x, rev, aerr = timed
        ms = cuda_ms(lambda: scan.scan_tiled(op, x, rev))
        plain_ms = cuda_ms(lambda: scan.scan_plain(op, x, rev), reps=3)
        lib_ms = scan_library_ms(op, x, rev)
        dev = device_ms(lambda: scan.scan_tiled(op, x, rev))
        lib_dev = library_device_ms(op, x, rev)
        emit({"phase": 1, "kernel": f"scan_tiled/{op}@batch", "rel_err": worst, "rows": list(TILED_BATCH),
              "rows_few_tiles": list(TILED_BATCH_FEW), "rows_fuse_batch": list(FUSE_BATCH), "ms": ms,
              "plain_ms": plain_ms, "library_ms": lib_ms, "library_device_ms": lib_dev,
              "device_ms": dev, "k1_batch_ms": cuda_ms(lambda: scan.scan_block(op, x, rev)),
              "k1_batch_device_ms": device_ms(lambda: scan.scan_block(op, x, rev)),
              "route": scan.scan_route(x.shape[0], x.shape[-1], x.element_size(), x.shape[1], op),
              "fuse_batch": fuse, "shape": list(x.shape), "dtype": "float64"})
        entries.append(kernel_entry(f"scan_tiled/{op}@batch", "scan_tiled.cu", "pallas_scan.py:361", "float64",
                                    aerr, ms, plain_ms, scan_bound(op, x), lib_ms, dev, lib_dev))
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
            res = {"route": kernels.nn_route(cand.shape[1], traj.shape[1], traj.shape[0]),
                   "k3_queries_a_block": kernels.resident_block(traj.shape[0] * kernels._tiles(traj.shape[1], 1)[0])}
            got = kernels.nn_grid(traj, cand, mask)
            torch.cuda.synchronize()
            if not torch.equal(got, k3):
                raise AssertionError(f"batched nn grid {case} {name}: differs from K3 in "
                                     f"{int((got != k3).sum())} queries")
            if dtype == torch.float64:
                res.update(launch_times(traj, cand, mask, got))
            del got
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
    the re-ranked winners equal; an adversarial batch (``near_threshold_counts``,
    16 x 4,661, 256 trials, float32 and float64) equal to the plain counts,
    with the share of pairs recounted. Times of the fleet bucket in float32,
    and of the fleet at its fusion's own operands (``fleet_count_operands``:
    the Sim(3) window mask a row), also held to the plain counts and, at
    its first and last rows, to the kernel alone."""
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
    shares = {}
    for dtype in (torch.float32, torch.float64):
        adv = near_threshold_counts(gen, 16, SEQ02_LEN, 256, dtype, device)
        got = kernels.ransac_counts(*adv)
        torch.cuda.synchronize()
        if not torch.equal(got, kernels.ransac_counts_plain(*adv)):
            raise AssertionError(f"ransac_counts {dtype} at the threshold: counts differ from the plain ones")
        r2 = kernels.sim3_residual2(adv[0][:, None], adv[1][:, None], adv[3], adv[4], adv[5])
        near = adv[2][:, None] & ((r2 - 16.0).abs() <= 4 * torch.finfo(dtype).eps * 16.0)
        shares[dtype_name(dtype)] = {"recounted_share": recounted_share(adv), "pairs_within_4_ulps": int(near.sum())}
        del adv, r2, near
    emit({"phase": 1, "kernel": "ransac_counts@batch (at the threshold)", "equal_to_plain": True,
          "shape": [16, 256, SEQ02_LEN], **shares})
    entries = [count_entry("ransac_counts@batch", timed, {"ragged_rows": list(KITTI_LENGTHS)})]
    window = fleet_count_operands(device)
    want = kernels.ransac_counts_plain(*window)
    got = kernels.ransac_counts(*window)
    torch.cuda.synchronize()
    alone = [torch.equal(got[r], kernels.ransac_counts(*(a[r].contiguous() for a in window[:6]), window[6]))
             for r in (0, FLEET[0] - 1)]
    if not torch.equal(got, want) or not all(alone):
        raise AssertionError("ransac_counts at the fleet's window masks: counts differ from the plain ones "
                             "or a row from the kernel alone")
    share = window[2].double().mean(1)
    entries.append(count_entry("ransac_counts@batch/fleet-window", window, {
        "valid_share_min_max": [float(share.min()), float(share.max())], "equal_to_plain": True}))
    return entries


def count_entry(name: str, args, extra: dict):
    """K5's times on ``args`` (float32) and their kernel entry: the call's
    CUDA-event and device ms (three profiles, the median kept: an earlier
    run's two readings of one shape disagreed), the count kernel's and the
    chunk list's launches alone, the plain version's ms, the share of pairs
    recounted, and the bound of the valid pairs."""
    from gps_optimize_slam_tpu_torch.ops import kernels

    ms = cuda_ms(lambda: kernels.ransac_counts(*args))
    plain_ms = cuda_ms(lambda: kernels.ransac_counts_plain(*args), reps=3)
    reads = [device_ms(lambda: kernels.ransac_counts(*args)) for _ in range(3)]
    dev = float(np.median(reads))
    src, B, T = args[0], args[0].shape[0], args[3].shape[1]
    emit({"phase": 1, "kernel": name, "rows_equal_to_the_kernel_alone": True,
          "ms": ms, "plain_ms": plain_ms, "device_ms": dev, "device_ms_reads": reads,
          "count_kernel_ms": launch_device_ms(lambda: kernels.ransac_counts(*args), "count_kernel")[0],
          "list_kernel_ms": launch_device_ms(lambda: kernels.ransac_counts(*args), "chunk_list_kernel")[0],
          "recounted_share": recounted_share(args), "valid_pairs": int(args[2].sum()) * T,
          "shape": [B, T, src.shape[1]], "dtype": dtype_name(src.dtype), **extra})
    return kernel_entry(name, "ransac_counts.cu", "pallas_kernels.py:450", dtype_name(src.dtype), 0.0, ms,
                        plain_ms, count_bound(args), None, dev)


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
    entries += phase1_pose_cg(device, gen)
    phase1_tiers(device, gen)
    phase1_routes(device, gen)
    phase1_nn_routes(device, gen)
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
    from gps_optimize_slam_tpu_torch.utils import graphs

    slam, gt, gp = replica_sequence(SEQ02_LEN)
    gps = pipeline.GPSData(timestamps=gt, positions=gp, valid=np.ones(len(gt), bool),
                           frame="enu", utm_zone=32, utm_south=False)

    def run(dev, dtype):
        return pipeline.fuse_arrays(slam, gps, dtype=dtype, device=dev)

    t0 = time.perf_counter()
    ref = run("cpu", torch.float64)
    cpu_s = time.perf_counter() - t0
    gaps, cold = {}, {}
    for dtype in (torch.float64, torch.float32):
        # The first call for fuse_core's and evaluate's keys runs eagerly,
        # the second captures and replays them; the runs below replay.
        first_s, _ = timed_s(lambda: run(device, dtype))
        second_s, res = timed_s(lambda: run(device, dtype))
        with graphs.eager():
            eager_s, eager_res = timed_s(lambda: run(device, dtype))
        gaps[dtype_name(dtype)] = fusion_dist(res.outputs, eager_res.outputs)
        cold[dtype_name(dtype)] = {"first_call_ms": 1e3 * first_s, "capture_call_ms": 1e3 * second_s,
                                   "eager_call_ms": 1e3 * eager_s}
        if dtype == torch.float64:
            res64 = res

    # The main path, replayed: its counts are set to 0 just before it and
    # read just after (each replay adds the launches of its capture).
    reset_launch_counts()
    res = run(device, torch.float32)
    torch.cuda.synchronize()
    launches = launch_counts()

    compare = graph_vs_eager(lambda: run(device, torch.float32), lambda a, b: fusion_dist(a.outputs, b.outputs))
    # Calls of one key after which the graphs have saved what the capture cost.
    cold["float32"]["break_even_calls"] = 2 + (cold["float32"]["capture_call_ms"] - compare["eager_ms"]) / (
        compare["eager_ms"] - compare["graph_ms"])
    err32 = float(np.abs(res.corrected_pos - ref.corrected_pos).max())
    err64 = float(np.abs(res64.corrected_pos - ref.corrected_pos).max())
    emit({"phase": 4, "poses": SEQ02_LEN, "gnss": int(len(gt)),
          "corrected_pos_max_err_m": {"float32": err32, "float64": err64},
          "graph_vs_eager": gaps, "cold_calls": cold, "rmse_ekf_m": float(res.evaluation.nn_ekf.rmse), "launches": launches,
          "gpu_wall_ms_median5": compare["graph_ms"], "eager_wall_ms_median3": compare["eager_ms"],
          "graphs_against_eager": compare, "cpu_plain_wall_ms": 1e3 * cpu_s})
    if not err64 <= 1e-6 or not err32 <= 1e-2:
        raise AssertionError(f"card runs off the CPU float64 run: {err32:.3e} m (f32), {err64:.3e} m (f64)")
    check_graph_gap("phase 4 float64", gaps["float64"], 1e-9)
    check_graph_gap("phase 4 float32", gaps["float32"], 1e-2)
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
    phase 8 does for its refines (~2·10⁴ kernels each): tracing their host
    ops too slows the traced run and takes long to read (``PERF.md``, from
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


def copy_kind(name: str) -> str:
    """A profiler copy event's kind: "HtoD pinned", "HtoD pageable", "DtoH
    pinned", "DtoH pageable", "DtoD" or "memset", from names such as
    ``Memcpy HtoD (Pinned -> Device)``."""
    if name.startswith("Memset"):
        return "memset"
    for way in ("HtoD", "DtoH"):
        if way in name:
            return f"{way} {'pageable' if 'Pageable' in name else 'pinned'}"
    return "DtoD"


def union_us(spans) -> list:
    """The union of (start, end) intervals, as sorted disjoint intervals."""
    out = []
    for s, e in sorted(spans):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def overlap_us(a, b) -> float:
    """The length of the intersection of two sorted disjoint interval lists."""
    i = j = 0
    total = 0.0
    while i < len(a) and j < len(b):
        total += max(0.0, min(a[i][1], b[j][1]) - max(a[i][0], b[j][0]))
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def stream_profile(fn) -> dict:
    """One run of ``fn`` with the device traced (``torch.profiler``, CUDA
    activity only, read from its exported trace): the wall, the kernels'
    device time, the busy time (the union of kernels and copies) and idle
    share, and for each kind of copy (``copy_kind``) its count, device ms,
    bytes and GB/s (bytes over its device time), and the device time in
    which a copy ran beside a kernel."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    kernels, copies, kinds = [], [], {}
    for e in events:
        cat = e.get("cat", "")
        if e.get("ph") != "X" or cat not in ("kernel", "gpu_memcpy", "gpu_memset"):
            continue
        span = (float(e["ts"]), float(e["ts"]) + float(e["dur"]))
        if cat == "kernel":
            kernels.append(span)
            continue
        copies.append(span)
        k = kinds.setdefault(copy_kind(e["name"]), {"count": 0, "ms": 0.0, "bytes": 0})
        k["count"] += 1
        k["ms"] += float(e["dur"]) / 1e3
        k["bytes"] += int(e.get("args", {}).get("bytes", 0))
    for k in kinds.values():
        k["gb_s"] = k["bytes"] / (k["ms"] * 1e6) if k["ms"] > 0 else None
    busy = union_us(kernels + copies)
    busy_ms = sum(e - s for s, e in busy) / 1e3
    return {"wall_ms": wall_ms, "kernel_ms": sum(e - s for s, e in kernels) / 1e3, "kernels": len(kernels),
            "busy_ms": busy_ms, "idle_share": 1.0 - busy_ms / wall_ms, "copies": kinds,
            "copy_beside_kernel_ms": overlap_us(union_us(kernels), union_us(copies)) / 1e3}


@contextlib.contextmanager
def watched_streams():
    """Within it every ``utils.streaming.stream_chunks`` call records the
    ``streaming.Fetched`` handles its launches return, in item order, and
    every ``streaming.fetch`` its handle in call order. Yields (streams,
    fetches): a list of handle lists, and the list of all handles."""
    from gps_optimize_slam_tpu_torch.utils import streaming

    saved_stream, saved_fetch = streaming.stream_chunks, streaming.fetch
    streams, fetches = [], []

    def stream_chunks(items, stage, launch, drain):
        handles = []
        streams.append(handles)

        def launching(item, staged):
            out = launch(item, staged)
            if isinstance(out, streaming.Fetched):
                handles.append(out)
            return out

        return saved_stream(items, stage, launching, drain)

    def fetch(tensors):
        out = saved_fetch(tensors)
        fetches.append(out)
        return out

    streaming.stream_chunks, streaming.fetch = stream_chunks, fetch
    try:
        yield streams, fetches
    finally:
        streaming.stream_chunks, streaming.fetch = saved_stream, saved_fetch


DRAIN_SLACK_MS = 0.05  # a download that starts this long after it could have, past the next chunk's end, waited


def drain_waits(streams, fetches) -> dict:
    """Read from the events of a run's fetched chunks (``watched_streams``,
    after a synchronise) whether a drain waited for the next chunk: for
    each pair of consecutive chunks i-1, i of a stream, chunk i-1's
    download could start once its own work was done (``ready``) and the
    download before it on the card had ended; ``lag`` is how long after
    that it started. It waited for chunk i when it started after chunk i's
    work was done and its lag exceeds ``DRAIN_SLACK_MS``. Also counted: the
    pairs whose download ended before chunk i's work did (the copy hidden
    behind the compute), and the bytes fetched."""
    order = {id(h): k for k, h in enumerate(fetches)}
    pairs = waited = hidden = 0
    lags = []
    for handles in streams:
        for prev, nxt in zip(handles, handles[1:]):
            k = order[id(prev)]
            before = next((h for h in reversed(fetches[:k]) if h.device == prev.device), None)
            free = prev.ready
            if before is not None and before.copied.elapsed_time(prev.ready) < 0:
                free = before.copied
            lag = free.elapsed_time(prev.started)
            lags.append(lag)
            pairs += 1
            waited += nxt.ready.elapsed_time(prev.started) >= 0 and lag > DRAIN_SLACK_MS
            hidden += prev.copied.elapsed_time(nxt.ready) >= 0
    return {"pairs": pairs, "waited_for_next": waited, "copy_done_before_next_chunk": hidden,
            "max_lag_ms": max(lags, default=0.0), "fetches": len(fetches),
            "fetched_mb": sum(h.nbytes for h in fetches) / 2**20}


def pinned_mb():
    """The pinned host memory PyTorch's caching host allocator holds (MB),
    or None where this PyTorch does not report it."""
    import torch

    stats = torch.cuda.host_memory_stats() if hasattr(torch.cuda, "host_memory_stats") else {}
    held = stats.get("allocated_bytes.current")
    return None if held is None else held / 2**20


def stream_report(label: str, fn) -> dict:
    """One traced run of ``fn`` (warm: its programs captured before) with
    its chunk streams watched: ``stream_profile``, ``drain_waits`` and the
    pinned MB held after it. Fails if a drain waited for the next chunk
    or a copy ran from pageable memory."""
    import torch

    with watched_streams() as (streams, fetches):
        prof = stream_profile(fn)
        torch.cuda.synchronize()
        waits = drain_waits(streams, fetches)
    report = {**prof, "drains": waits, "pinned_mb": pinned_mb()}
    if waits["waited_for_next"]:
        raise AssertionError(f"{label}: a drain waited for the next chunk: {waits}")
    pageable = {k: v for k, v in prof["copies"].items() if "pageable" in k}
    if pageable:
        raise AssertionError(f"{label}: copies from pageable memory: {pageable}")
    return report


def graph_stats() -> dict:
    """The captured programs (``utils.graphs``): first calls (eager),
    captures and replays since the counts were last set to 0, and the
    programs held with the device memory of their shared pools and of their
    static inputs and outputs."""
    from gps_optimize_slam_tpu_torch.utils import graphs

    st = graphs.stats()
    return {"first_calls": st["first_calls"], "captures": st["captures"], "replays": st["replays"],
            "programs": st["programs"], "pool_mb": st["pool_bytes"] / 2**20,
            "input_mb": st["input_bytes"] / 2**20, "output_mb": st["output_bytes"] / 2**20}


def graph_vs_eager(fn, dist, runs: int = 5, eager_runs: int = 3) -> dict:
    """``fn()`` replaying its captured programs (``utils.graphs``; two calls
    before the clock, the first eager and the second capturing, make sure
    of them) against ``fn()`` under
    ``graphs.eager()``, in this run: warm walls (medians of ``runs`` and
    ``eager_runs`` synchronised calls), the replays' profile and the eager
    run's idle share and kernel count (``profile_device``; the eager run's
    device alone: tracing its host ops takes long to read),
    ``dist(replayed result, eager result)``, and the programs' captures,
    replays and pools so far."""
    from gps_optimize_slam_tpu_torch.utils import graphs

    fn()
    out = fn()
    walls = [1e3 * timed_s(fn)[0] for _ in range(runs)]
    prof = profile_device(fn)
    with graphs.eager():
        ref = fn()
        eager_walls = [1e3 * timed_s(fn)[0] for _ in range(eager_runs)]
        eager_prof = profile_device(fn, host_ops=False)
    return {"graph_warm_ms": walls, "eager_warm_ms": eager_walls, "graph_ms": float(np.median(walls)),
            "eager_ms": float(np.median(eager_walls)), "graph_profile": prof,
            "eager_idle_share": eager_prof["idle_share"], "eager_kernels": eager_prof["kernels"],
            "graph_vs_eager": dist(out, ref), "graphs": graph_stats()}


def fusion_dist(a, b) -> dict:
    """Two fusions' largest position gap (m) and whether their RANSAC
    masks, GNSS masks and ``ok`` flags are equal (``FusionOutputs`` of
    tensors or host arrays, or lists of them)."""
    import torch

    if isinstance(a, list):
        gaps = [fusion_dist(x, y) for x, y in zip(a, b, strict=True)]
        return {"corrected_pos_m": max(g["corrected_pos_m"] for g in gaps),
                "masks_equal": all(g["masks_equal"] for g in gaps), "ok_equal": all(g["ok_equal"] for g in gaps)}

    def t(x):
        return torch.as_tensor(x).cpu()

    return {"corrected_pos_m": abs_err(t(a.corrected_pos), t(b.corrected_pos)),
            "masks_equal": bool(torch.equal(t(a.sim3_inliers), t(b.sim3_inliers))
                                and torch.equal(t(a.gps_valid), t(b.gps_valid))),
            "ok_equal": bool(torch.equal(t(a.ok), t(b.ok)))}


def check_graph_gap(label: str, gap: dict, bound_m: float) -> None:
    """Fail unless a replayed fusion is within ``bound_m`` of the eager one
    with equal masks and ``ok`` flags."""
    if not (gap["corrected_pos_m"] <= bound_m and gap["masks_equal"] and gap["ok_equal"]):
        raise AssertionError(f"{label}: the replayed programs are off eager dispatch: {gap} (bound {bound_m} m)")


@contextlib.contextmanager
def forced_route(module, rule: str, route: str):
    """Within it, ``module.rule`` (``scan.scan_route`` or
    ``kernels.nn_route``) answers ``route`` whatever the shapes: how a run
    holds the kernel a route does not pick on the same path and data. A
    captured program keeps the route it was captured with, and the route is
    not in its key, so every program is dropped (``graphs.clear()``) on the
    way in and on the way out: within the block a key's first call runs
    eagerly on the forced route, its second captures that route and later
    calls replay it."""
    from gps_optimize_slam_tpu_torch.utils import graphs

    saved = getattr(module, rule)
    setattr(module, rule, lambda *args, **kw: route)
    graphs.clear()
    try:
        yield
    finally:
        setattr(module, rule, saved)
        graphs.clear()


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


def chunked_dist(a, b) -> dict:
    """Two chunked fusions' largest position gap (m), and whether their
    GNSS masks and ``ok`` flags are equal."""
    return {"corrected_pos_m": float(np.abs(a.corrected_pos - b.corrected_pos).max()),
            "masks_equal": bool(np.array_equal(a.gps_valid, b.gps_valid)), "ok_equal": a.ok == b.ok}


def eval_dist(a, b) -> dict:
    """Two evaluations' largest gap over every statistic (m), counts equal."""
    parts = ("nn_slam", "nn_sim3", "nn_ekf", "ate_sim3", "ate_ekf")
    gap = max(abs(float(getattr(getattr(a, p), f)) - float(getattr(getattr(b, p), f)))
              for p in parts for f in ("mean", "median", "rmse", "max"))
    same = all(int(getattr(a, p).count) == int(getattr(b, p).count) for p in parts)
    return {"corrected_pos_m": gap, "masks_equal": same, "ok_equal": True}


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
    relative (K4 equals K3 bit for bit), and the forced evaluation's chunk
    bodies captured and replayed, launching K4, ≤1e-9 m from eager dispatch
    on the same route. (c) every kernel of the path launched in this run. Then ``fuse_files_chunked`` +
    ``export_result`` on the seq-04 files, against the in-core
    ``fuse_files`` ≤1e-6 m."""
    import torch

    from gps_optimize_slam_tpu_torch import pipeline
    from gps_optimize_slam_tpu_torch.config import FusionConfig
    from gps_optimize_slam_tpu_torch.models import fusion, fusion_chunked
    from gps_optimize_slam_tpu_torch.ops import kernels, scan
    from gps_optimize_slam_tpu_torch.utils import graphs

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
    # The evaluation's chunk bodies captured with their NN blocks on K4 and
    # replayed: the replay launches K4 (its launches are the capture's),
    # then the replays against eager dispatch on the same route.
    with forced_route(kernels, "nn_route", "grid"):
        evaluate(res, CHUNK)
        evaluate(res, CHUNK)  # captures
        reset_launch_counts()
        graphs.reset_stats()
        evaluate(res, CHUNK)
        torch.cuda.synchronize()
        k4_replay = {"nn_grid_launches": launch_counts()["nn_grid"], **graph_stats()}
        grid_cmp = graph_vs_eager(lambda: evaluate(res, CHUNK), eval_dist, runs=3, eager_runs=2)
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

    # The chunk bodies replayed against eager dispatch.
    fuse_cmp = graph_vs_eager(fuse, chunked_dist, runs=3, eager_runs=2)
    eval_cmp = graph_vs_eager(lambda: evaluate(res, CHUNK), eval_dist, runs=3, eager_runs=2)
    fuse_s, eval_s = fuse_cmp["graph_ms"] / 1e3, eval_cmp["graph_ms"] / 1e3
    streams = {"chunked_fuse": stream_report("phase 5 chunked fusion", fuse),
               "evaluate": stream_report("phase 5 chunked evaluation", lambda: evaluate(res, CHUNK))}
    stages = chunked_stage_split(st, sp, sq, gt, gp, gv, cfg, device)

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
          "fuse_stage_ms": stages, "streams": streams, "fuse_graphs_against_eager": fuse_cmp,
          "evaluate_graphs_against_eager": eval_cmp,
          "evaluate_k4_forced_replay": k4_replay, "evaluate_k4_forced_graphs_against_eager": grid_cmp,
          "max_memory_allocated_mb": {"chunked_fuse": fuse_peak / 2**20, "evaluate": eval_peak / 2**20},
          "seq04_files": {"corrected_pos_max_err_m": err04, "exported_rows": int(back.shape[0]),
                          "launches": launches04}})
    if not (res.ok and ref_ok):
        raise AssertionError("phase 5: the Sim3 alignment failed")
    if not (pos_err <= 1e-6 and quat_err <= 1e-8 and scale_rel <= 1e-9):
        raise AssertionError(f"chunked off in-core: {pos_err:.3e} m, quat {quat_err:.3e}, scale {scale_rel:.3e}")
    if not eval_rel <= 1e-12:
        raise AssertionError(f"evaluation with K4 forced off the routed one (K3): {eval_rel:.3e}")
    check_graph_gap("phase 5 chunked fusion", fuse_cmp["graph_vs_eager"], 1e-9)
    check_graph_gap("phase 5 chunked evaluation", eval_cmp["graph_vs_eager"], 1e-9)
    check_graph_gap("phase 5 chunked evaluation, K4 forced", grid_cmp["graph_vs_eager"], 1e-9)
    if not (k4_replay["nn_grid_launches"] > 0 and k4_replay["captures"] == 0 and k4_replay["replays"] > 0):
        raise AssertionError(f"phase 5: the forced evaluation's replays did not launch K4: {k4_replay}")
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


def gate_passes(args, mode: str) -> int:
    """The passes ``robust.fuse_robust(*args)`` takes to its fixed point
    under ``mode``: the fewest ``n_iterations`` at which it reports
    ``gate_converged`` (the JAX package's ``while_loop`` count). The
    parallel program runs all its passes, masked, so its launches do not
    count them. The warnings of the capped runs are held back."""
    import logging

    from gps_optimize_slam_tpu_torch.models import robust
    from gps_optimize_slam_tpu_torch.utils.logging import get_logger

    logger = get_logger()
    level = logger.level
    logger.setLevel(logging.ERROR)
    try:
        for k in range(1, ROBUST_PASSES + 1):
            if robust.fuse_robust(*args, n_iterations=k, gate_mode=mode).gate_converged:
                return k
    finally:
        logger.setLevel(level)
    return ROBUST_PASSES


def robust_dist(a, b) -> dict:
    """Two ``fuse_robust`` results' largest position gap (m), and whether
    their accept masks and ``gate_converged`` flags are equal."""
    import torch

    return {"corrected_pos_m": abs_err(a.positions, b.positions),
            "masks_equal": bool(torch.equal(a.accepted, b.accepted)) and a.gate_converged == b.gate_converged,
            "ok_equal": True}


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

    # A gate that stops short of its cap stopped because a pass changed
    # nothing: the fixed point (``gate_converged``).
    o = par.outputs
    dev_t = lambda a: torch.as_tensor(np.asarray(a), dtype=f64, device=device)  # noqa: E731
    robust_args = (dev_t(st), dev_t(sp), dev_t(slam["quaternions"]), o.sim3_pos, o.sim3_quat, o.aligned_gps,
                   o.gps_valid, par.config.ekf, par.config.rts_decision)
    passes = {mode: gate_passes(robust_args, mode) for mode in ("parallel", "sequential")}
    # The robust fusion alone, replayed against eager dispatch: the parallel
    # form one program (every pass, masked, and the final fusion), the
    # sequential form its host gate and its final fusion's program.
    robust_cmp = {mode: graph_vs_eager(lambda: robust.fuse_robust(*robust_args, n_iterations=ROBUST_PASSES,
                                                                  gate_mode=mode), robust_dist)
                  for mode in ("parallel", "sequential")}
    at_outliers = poses_at_fixes(st, gt, outlier)
    err = {name: float(np.abs(r.corrected_pos - clean.corrected_pos).max())
           for name, r in (("gated", par), ("ungated", ungated))}
    seq_par = float(np.abs(seq.corrected_pos - par.corrected_pos).max())
    card_cpu = float(np.abs(par.corrected_pos - cpu.corrected_pos).max())

    # One gate pass of each form at the fixed point, warm.
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
          "gate_passes": passes, "gate_passes_cap": ROBUST_PASSES, "robust_graphs_against_eager": robust_cmp,
          "accepted": int(par.robust_accepted.sum()), "rejected": int((~par.robust_accepted & avail.cpu().numpy()).sum()),
          "max_err_to_clean_fusion_m": err, "sequential_vs_parallel_m": seq_par, "card_vs_cpu_m": card_cpu,
          "gate_pass_ms": pass_ms, "gt_chunked_vs_in_core": {"max_rel_err": gt_rel, "aligned_max_err_m": gt_al_err},
          "gt_rmse_ekf_m": float(par.gt_evaluation.nn_ekf.rmse), "offsets": offsets, "adaptive": ada,
          "launches": {"robust_parallel_gt": n_par, "robust_sequential": n_seq, "adaptive_ransac": n_ada}})
    if max(passes.values()) >= ROBUST_PASSES:
        raise AssertionError(f"a gate used all {ROBUST_PASSES} passes: no fixed point shown ({passes})")
    for mode, cmp in robust_cmp.items():
        check_graph_gap(f"phase 6 robust {mode}", cmp["graph_vs_eager"], 1e-9)
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
    fuse_cmp = graph_vs_eager(fuse, chunked_dist, runs=2, eager_runs=1)
    fuse_s = fuse_cmp["graph_ms"] / 1e3
    stream = stream_report("phase 6 robust chunked fusion", fuse)
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
          "robust_chunked_graphs_against_eager": fuse_cmp, "robust_chunked_stream": stream,
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
    check_graph_gap("phase 6 robust chunked", fuse_cmp["graph_vs_eager"], 1e-9)
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


# The command line under ``graphs.eager()``: ``python3 -c EAGER_COMMAND fuse ...``.
EAGER_COMMAND = ("import runpy, sys; from gps_optimize_slam_tpu_torch.utils import graphs\n"
                 "with graphs.eager(): runpy.run_module('gps_optimize_slam_tpu_torch', run_name='__main__')")


def phase6_command():
    """``python3 -m gps_optimize_slam_tpu_torch fuse ... --robust --gt ...
    --json``, in core (as it runs and under ``graphs.eager()``, in the
    order as-is, eager, eager, as-is: the subprocess walls of each, side
    by side) and with ``--chunked``, as subprocesses on the seq-04 files;
    a non-zero exit or output that is no JSON object fails."""
    rows = {}
    module, eager = ["-m", "gps_optimize_slam_tpu_torch"], ["-c", EAGER_COMMAND]
    with tempfile.TemporaryDirectory() as tmp:
        slam_path, gps_path = write_seq04_files(tmp)
        gt_path = write_seq04_gt_file(tmp)
        for name, prog, extra in (("fuse", module, []), ("fuse, eager dispatch", eager, []),
                                  ("fuse, eager dispatch, again", eager, []), ("fuse, again", module, []),
                                  ("fuse --chunked", module, ["--chunked", "--chunk-size", "128"])):
            t0 = time.perf_counter()
            proc = subprocess.run(
                [sys.executable, *prog, "fuse", slam_path, gps_path, "--gt", gt_path, "--robust", "--json"] + extra,
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

    compare = graph_vs_eager(lambda: mesh.fuse_buckets(buckets, seeds, config=cfg, device=device, dtype=f64),
                             fusion_dist, runs=3)
    stream = stream_report("phase 7 fuse_buckets", lambda: mesh.fuse_buckets(buckets, seeds, config=cfg,
                                                                              device=device, dtype=f64))
    row_loop = [1e3 * timed_s(lambda: [o.corrected_pos.cpu() for o in loop()])[0] for _ in range(3)]
    emit({"phase": 7, "part": "kitti", "sequences": len(seqs), "poses": list(KITTI_LENGTHS), "dtype": "float64",
          "buckets": per_bucket, "row_vs_single_max_err_m": pos_err, "masks_equal": masks_equal,
          "evaluate_vs_single_max_rel_err": eval_err, "seq04_vs_golden_m": golden_err,
          "fuse_buckets_warm_ms": compare["graph_warm_ms"], "fuse_buckets_eager_warm_ms": compare["eager_warm_ms"],
          "row_loop_warm_ms": row_loop, "graphs_against_eager": compare, "fuse_buckets_stream": stream,
          "launches": total})
    check_graph_gap("phase 7 kitti", compare["graph_vs_eager"], 1e-9)
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

    fuse()  # the first call, eager: the counted run captures the bucket's program and replays it
    out, launches = counted(fuse)
    torch.cuda.reset_peak_memory_stats()
    fuse()
    peak = torch.cuda.max_memory_allocated()
    compare = graph_vs_eager(fuse, fusion_dist)
    row_loop = [1e3 * timed_s(loop)[0] for _ in range(3)]
    prof = compare.pop("graph_profile")
    errs = [float((out.corrected_pos[i, :n] - fusion.fuse_core(*rows[i], cfg, seed=i).corrected_pos).abs().max())
            for i in (0, B - 1)]
    wall = compare["graph_ms"]
    emit({"phase": 7, "part": "fleet", "rows": B, "poses": n, "dtype": "float32", "ok": bool(out.ok.all()),
          "batch_warm_ms": compare["graph_warm_ms"], "batch_eager_warm_ms": compare["eager_warm_ms"],
          "row_loop_warm_ms": row_loop, "sequences_per_s": B / (wall / 1e3),
          "eager_sequences_per_s": B / (compare["eager_ms"] / 1e3), "loop_over_batch": float(np.median(row_loop)) / wall,
          "max_memory_allocated_mb": peak / 2**20, "profile": prof, "graphs_against_eager": compare,
          "rows_vs_single_m": errs, "launches": launches})
    if not bool(out.ok.all()) or not bool(torch.isfinite(out.corrected_pos).all()) or not max(errs) <= 1e-2:
        raise AssertionError(f"phase 7 fleet: ok {bool(out.ok.all())}, rows off their single fusion by {errs} m")
    check_graph_gap("phase 7 fleet", compare["graph_vs_eager"], 1e-2)
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
    run bit for bit. A Gauss-Newton step is one captured program: a step's
    key (no closures) called first (eager), second (capture, instantiation
    and a replay) and third (a replay), one step a call, with the pool's
    growth; the refine without closures replayed against the same under
    ``graphs.eager()`` (3 steps, ≤1e-9 m); warm walls of the replayed
    refine with closures (median of 3) and one eager refine with closures
    as its yardstick (held to the replays as the card is held to the CPU);
    the idle shares of both from traces of a whole refine each; peak
    memory and the proposal's share of the refine's wall. Each refine makes
    one ``pose_cg`` launch a Gauss-Newton step."""
    import torch

    from gps_optimize_slam_tpu_torch import pipeline
    from gps_optimize_slam_tpu_torch.models import pose_graph
    from gps_optimize_slam_tpu_torch.utils import graphs

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

    # A step's program: without closures the loop arrays have another
    # shape, so its key is new here. One step a call: eager, capture, replay.
    no_loops = {**REFINE, "propose_loops": False}
    before = graph_stats()
    step = {}
    for call in ("eager_first", "capture", "replay"):
        step[f"{call}_call_ms"] = 1e3 * timed_s(lambda: pipeline.refine_pose_graph(res, **{**no_loops,
                                                                                           "iterations": 1}))[0]
    after = graph_stats()
    step["capture_and_instantiation_ms"] = step["capture_call_ms"] - step["replay_call_ms"]
    step["pool_growth_mb"] = after["pool_mb"] - before["pool_mb"]
    step["graphs"] = after
    short = {**no_loops, "iterations": 3}
    replayed, _ = pipeline.refine_pose_graph(res, **short)
    with graphs.eager():
        eager_short, _ = pipeline.refine_pose_graph(res, **short)
    no_loops_gap = {"positions_m": abs_err(replayed.state.positions, eager_short.state.positions),
                    "quaternions": abs_err(replayed.state.quaternions, eager_short.state.quaternions),
                    "cost_history_rel": rel_err(replayed.cost_history[None], eager_short.cost_history[None])}

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
    pipeline.refine_pose_graph(res, **REFINE)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    with graphs.eager():
        eager_s, (gn_eager, info_eager) = timed_s(lambda: pipeline.refine_pose_graph(res, **REFINE))
    eager_gaps = refine_gaps(gn, info, gn_eager, info_eager)
    prof = profile_device(lambda: pipeline.refine_pose_graph(res, **REFINE), host_ops=False)
    with graphs.eager():
        eager_prof = profile_device(lambda: pipeline.refine_pose_graph(res, **REFINE), host_ops=False)
    refine_ms = float(np.median(walls["refine"]))
    emit({"phase": 8, "part": "refine", "poses": SHUTTLE_N, "gnss": int(len(gt)), "dtype": "float64",
          "loops_proposed": info["n_loops"], "loop_pairs": info["loop_ij"][:8], "cost_history":
          gn.cost_history.tolist(), "card_vs_cpu": gaps, "fuse_card_vs_cpu_m": fuse_gap,
          "resumed_equal_bit_for_bit": resumed_equal, "launches": launches, "fuse_warm_ms": walls["fuse"],
          "refine_warm_ms": walls["refine"], "fuse_refine_warm_ms_median3": float(np.median(
              [a + b for a, b in zip(walls["fuse"], walls["refine"])])), "refine_warm_ms_median3": refine_ms,
          "refine_eager_ms": 1e3 * eager_s, "refine_graph_vs_eager": eager_gaps,
          "refine_no_loops_graph_vs_eager": no_loops_gap, "gn_step_program": step,
          "cpu_fuse_refine_wall_ms": 1e3 * cpu_s, "propose_ms": propose_ms,
          "propose_share_of_refine": float(np.median(propose_ms)) / refine_ms, "refine_profile": prof,
          "refine_eager_profile": eager_prof, "refine_peak_memory_mb": peak / 2**20})
    say(f"phase 8: {info['n_loops']} loop closures proposed on the {SHUTTLE_N}-pose shuttle")
    if info["n_loops"] < 1:
        raise AssertionError("phase 8: no loop closure proposed on the shuttle")
    for label, g in (("the CPU's", gaps), ("eager dispatch's", eager_gaps)):
        if not (g["positions_m"] <= 1e-6 and g["quaternions"] <= 1e-8 and g["cost_history_rel"] <= 1e-9
                and g["loop_ij_equal"]):
            raise AssertionError(f"phase 8: the card's refinement off {label}: {g}")
    if not no_loops_gap["positions_m"] <= 1e-9:
        raise AssertionError(f"phase 8: the replayed refine without closures off eager dispatch: {no_loops_gap}")
    if not resumed_equal:
        raise AssertionError("phase 8: the resumed refinement differs from the uninterrupted one")
    if not float(gn.final_cost) < float(gn.cost_history[0]) or not bool(torch.isfinite(gn.state.positions).all()):
        raise AssertionError(f"phase 8: the refinement did not lower the cost: {gn.cost_history.tolist()}")
    missing = [k for k in ("nn_keep", "nn_resident", "ransac_counts") if launches[k] <= 0]
    missing += [] if any(launches[f"scan_block/{op}"] for op in ("quat_chain", "filter", "rts")) else ["scan_block"]
    if missing:
        raise AssertionError(f"phase 8: kernels not launched by fuse + refine: {missing}")
    if launches["pose_cg"] != REFINE["iterations"]:
        raise AssertionError(f"phase 8: {launches['pose_cg']} pose_cg launches, not one a Gauss-Newton step")
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


def nvidia_smi() -> str:
    """The card's name and power limit, as ``nvidia-smi --query-gpu=name,power.limit
    --format=csv,noheader`` gives them (the first card)."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


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
    import torch

    from gps_optimize_slam_tpu_torch.ops import kalman_parallel
    from gps_optimize_slam_tpu_torch.parallel import seqpar
    from gps_optimize_slam_tpu_torch.utils import profiling

    mesh = mesh or card_mesh(SEQPAR_BLOCKS)
    gaps, launches, walls, prof, peaks, compare = {}, None, {}, {}, {}, None
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
        walls[mode] = {"single_device": profiling.wallclock(single, runs=3)}
        if not prof:
            compare = graph_vs_eager(split, lambda a, b: {"positions_m": abs_err(a[0], b[0]),
                                                          "quaternions": abs_err(a[1], b[1])}, runs=3)
            walls[mode].update(seqpar=compare["graph_warm_ms"], seqpar_eager=compare["eager_warm_ms"])
            prof = {"seqpar": compare.pop("graph_profile"), "single_device": profile_device(single)}
            peaks = {"seqpar": run_peak_bytes(split, mesh.devices),
                     "single_device": run_peak_bytes(single, [args[1].device])}
        else:
            walls[mode]["seqpar"] = profiling.wallclock(split, runs=3)
    emit({"phase": 9, "part": label, "poses": int(args[0].shape[0]), "blocks": SEQPAR_BLOCKS,
          "devices": [str(d) for d in mesh.devices], "dtype": dtype_name(args[1].dtype),
          "seqpar_vs_single_device": gaps, "launches": {k: v for k, v in launches.items() if v}, "walls": walls,
          "profile": prof, "peak_bytes": peaks, "graphs_against_eager": compare})
    bad = {m: g for m, g in gaps.items() if not (g["positions_m"] <= pos_tol and g["quaternions"] <= quat_tol)}
    if bad:
        raise AssertionError(f"phase 9 {label}: seqpar off the single-device filter: {bad}")
    gap = compare["graph_vs_eager"]
    graph_tol = 1e-9 if args[1].dtype == torch.float64 else pos_tol
    if not (gap["positions_m"] <= graph_tol and gap["quaternions"] <= quat_tol):
        raise AssertionError(f"phase 9 {label}: the replayed stages are off eager dispatch: {gap}")
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
    compare = {"sharded": graph_vs_eager(sharded, fusion_dist, runs=3),
               "unsharded": graph_vs_eager(unsharded, fusion_dist, runs=3)}
    walls = {"unsharded": compare["unsharded"]["graph_warm_ms"], "sharded": compare["sharded"]["graph_warm_ms"],
             "unsharded_eager": compare["unsharded"]["eager_warm_ms"],
             "sharded_eager": compare["sharded"]["eager_warm_ms"],
             "shards_in_turn": profiling.wallclock(in_turn, runs=3)}
    prof = {name: c.pop("graph_profile") for name, c in compare.items()}
    emit({"phase": 9, "part": label, "rows": len(seeds), "shards": shards.size,
          "devices": [str(d) for d in shards.devices], "padded_poses": int(b.slam_times.shape[1]),
          "dtype": "float64", "ok": bool(got.ok.all()), "rows_vs_unsharded_max_err_m": err,
          "in_turn_vs_unsharded_max_err_m": turn_err, "masks_equal": masks,
          "launches": {k: v for k, v in launches.items() if v},
          "unsharded_launches": {k: v for k, v in want_launches.items() if v}, "walls": walls, "profile": prof,
          "graphs_against_eager": compare})
    if not (bool(got.ok.all()) and err <= 1e-9 and turn_err <= 1e-9 and masks):
        raise AssertionError(f"phase 9 {label}: rows off the unsharded batch by {err:.3e} m "
                             f"(in turn {turn_err:.3e} m), masks {masks}")
    for name, c in compare.items():
        check_graph_gap(f"phase 9 {label} ({name})", c["graph_vs_eager"], 1e-9)
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
COMMAND_LOG_POSES = 70_000  # the fuse-batch subprocess's two logs: rows past K1's single-row route


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
    ``COMMAND_LOG_POSES`` poses (one bucket of two rows of 70,000: K1's
    batch grid by the route, where it measured faster than K2's); a
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


@contextlib.contextmanager
def recording(module, name: str, calls: list):
    """Within it, the kernel wrapper ``module.name`` also appends the
    arguments of each call to ``calls`` (its launches go on being counted,
    on the recorder's own count)."""
    real = getattr(module, name)

    def record(*args):
        calls.append(args)
        return real(*args)

    record.launches = real.launches
    setattr(module, name, record)
    try:
        yield calls
    finally:
        setattr(module, name, real)


def phase10_kernels(nn_args, scan_calls, count_args, tiled_calls) -> dict:
    """The kernels at the long-log bucket's own shapes (not counted, not
    captured): K3's batch grid and the keep lists on the operands of the
    evaluation's first NN call (the coherent ``outage_sequence`` replicas),
    with their kept tile pairs, K3's block size, bounds and the plain
    version's time and error on every 64th query; K1's and K2's batch
    grids on the first leaves of each combine the routed fusion scanned on
    them (``scan_calls``, ``tiled_calls``), K1's beside K2's, with the
    library call where there is one; and K5's batch grid on the fusion's
    own operands (each row's Sim(3) window mask, 1000 trials a row), its
    counts equal to the plain ones, each row's valid share, the pairs
    recounted and the bound of the valid pairs. Times: CUDA events around a
    call (and around K3's launch alone), and each kernel's launch from the
    launches a trace holds (``launch_device_ms``)."""
    import torch

    from gps_optimize_slam_tpu_torch.ops import kernels, scan

    def counts():
        return kernels.ransac_counts(*count_args)

    got, want = counts(), kernels.ransac_counts_plain(*count_args)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        raise AssertionError(f"phase 10: K5's counts differ from the plain ones by {int((got - want).abs().max())}")
    valid = count_args[2]
    count_out = {"ransac_counts@batch": {
        "shape": [valid.shape[0], count_args[3].shape[1], valid.shape[1]], "dtype": dtype_name(count_args[0].dtype),
        "valid_share": [float(v) for v in valid.double().mean(1)], "equal_to_plain": True,
        "recounted_share": recounted_share(count_args),
        "ms": cuda_ms(counts), "launch_device_ms": launch_device_ms(counts, "count_kernel"),
        "list_launch_device_ms": launch_device_ms(counts, "chunk_list_kernel"),
        "plain_ms": cuda_ms(lambda: kernels.ransac_counts_plain(*count_args), reps=2),
        "bound": count_bound(count_args)}}
    del got, want

    traj, cand, mask = nn_args
    operands = kernels.keep_lists(traj, cand, mask)
    order, nkept, cand3 = operands
    got = kernels.nn_resident(traj, cand, mask)
    idx = torch.arange(0, traj.shape[1], PLAIN_STRIDE, device=traj.device)
    sub = traj[:, idx].contiguous()
    want = kernels.nn_min_dist2_plain(sub, cand, mask, block=8)
    torch.cuda.synchronize()
    out = {"nn_resident@batch": {
        "shape": list(traj.shape[:2]) + [cand.shape[1]], "dtype": dtype_name(traj.dtype),
        "queries_a_block": kernels.resident_block(order.shape[0] * order.shape[1]),
        "kept_tile_pairs": int(nkept.sum()), "tile_pairs": order.numel(),
        "rel_err_every_64th": rel_err(got[:, idx].flatten()[None], want.flatten()[None]),
        "ms": cuda_ms(lambda: kernels.nn_resident(traj, cand, mask)),
        "launch_ms": cuda_ms(lambda: kernels.resident_launch(traj, operands)),
        "launch_device_ms": launch_device_ms(lambda: kernels.resident_launch(traj, operands), "nn_kernel"),
        "plain_ms_every_64th": cuda_ms(lambda: kernels.nn_min_dist2_plain(sub, cand, mask, block=8), reps=2),
        "library_ms": cdist_batch_library_ms(traj, cand, mask), "bound": nn_bound(traj, cand, mask)}}

    def keep():
        return kernels.keep_lists(traj, cand, mask)

    out["nn_keep@batch"] = {
        "ms": cuda_ms(keep),
        "launch_device_ms": keep_launch_ms(traj, cand, mask), **keep_plan(traj, cand),
        "plain_ms": cuda_ms(lambda: plain_keep_lists(traj, cand, mask), reps=2),
        "bound": keep_bound(traj, cand, mask, nkept, cand3)}
    del operands, order, nkept, cand3, got, want
    for name, calls in (("scan_block", scan_calls), ("scan_tiled", tiled_calls)):
        firsts = {}
        for op, x, reverse in calls:
            firsts.setdefault(op, (x, reverse))
        for op, (x, reverse) in firsts.items():
            want = scan.scan_plain(op, x, reverse)
            wrapper = getattr(scan, name)
            entry = {
                "shape": list(x.shape), "reverse": reverse,
                "rel_err": rel_err(wrapper(op, x, reverse).reshape(-1, x.shape[-1]), want.reshape(-1, x.shape[-1])),
                "ms": cuda_ms(lambda: wrapper(op, x, reverse)),
                "launch_device_ms": launch_device_ms(lambda: wrapper(op, x, reverse),
                                                     "scan_kernel" if name == "scan_block" else "tiled_"),
                "plain_ms": cuda_ms(lambda: scan.scan_plain(op, x, reverse), reps=2),
                "library_ms": scan_library_ms(op, x, reverse), "bound": scan_bound(op, x)}
            if name == "scan_block":
                entry.update(tile=scan.block_tile(op, x.dtype, x.shape[-1], x.shape[1]),
                             cluster=scan.block_cluster(op, x.dtype, x.shape[-1], x.shape[1]))
            else:  # K1's batch grid beside it, on the same leaves
                entry.update(tile=scan.tiled_tile(op, x.dtype, x.shape[1]),
                             k1_launch_device_ms=launch_device_ms(lambda: scan.scan_block(op, x, reverse),
                                                                  "scan_kernel"))
            out[f"{name}/{op}@batch"] = entry
            del want
    torch.cuda.empty_cache()
    return {**count_out, **out}


def phase10(device):
    """A bucket of long logs, float64 on the card: four rows of
    ``LONG_LOG_LENGTHS`` poses (``long_logs``), one bucket under
    ``bucket_by_length(max_waste=2.0)``. The counted main path is
    ``mesh.fuse_batch`` + ``evaluate_batch`` on the kernels the routes pick
    (the scans K2's batch grid for rts, mobius and affine3 at this size and
    K1's for the rest, the NN calls K3's), then the
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
    from gps_optimize_slam_tpu_torch.ops import kernels, ransac, scan
    from gps_optimize_slam_tpu_torch.parallel import batch as pbatch
    from gps_optimize_slam_tpu_torch.parallel import mesh
    from gps_optimize_slam_tpu_torch.utils import graphs

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

    routes = {"scan": {op: scan.scan_route(len(scan.OPS[op][2]), n_pad, 8, B, op) for op in scan.OPS},
              "nn": kernels.nn_route(n_pad, n_pad, B)}
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
        mesh.evaluate_batch(b, o).nn_ekf.rmse.cpu()
        return o

    def loop():
        return [single(int(i))[1].nn_ekf.rmse.cpu() for i in range(len(rows))]

    compare = graph_vs_eager(bucket_run, fusion_dist, runs=3)
    prof = compare.pop("graph_profile")
    row_loop = [1e3 * timed_s(loop)[0] for _ in range(2)]
    torch.cuda.reset_peak_memory_stats()
    timed_s(bucket_run)
    peak = torch.cuda.max_memory_allocated()
    # ``fuse_buckets`` again, its programs warm: the stream of one bucket.
    stream = stream_report("phase 10 fuse_buckets", lambda: mesh.fuse_buckets(
        buckets, list(range(len(rows))), config=cfg, device=device, dtype=f64))
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
          "bucket_warm_ms": compare["graph_warm_ms"], "bucket_eager_warm_ms": compare["eager_warm_ms"],
          "row_loop_warm_ms": row_loop, "max_memory_allocated_mb": peak / 2**20, "profile": prof,
          "graphs_against_eager": compare, "fuse_buckets_stream": stream, "command": command})
    if not ok or not (pos_err <= tol_m and masks_equal and eval_err <= tol_m and buckets_err <= tol_m):
        raise AssertionError(f"phase 10: ok {ok}, rows {pos_err:.3e} m, masks {masks_equal}, evaluation "
                             f"{eval_err:.3e} m, fuse_buckets {buckets_err:.3e} m (bound {tol_m:.3e} m)")
    check_graph_gap("phase 10", compare["graph_vs_eager"], tol_m)
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
        key = f"scan_{routes['scan'][op]}/{op}"
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
    # The kernels at this bucket's own shapes, on the inputs an eager run of
    # the routed fusion and evaluation hands them (after the counted runs).
    nn_calls, scan_calls, tiled_calls, count_calls = [], [], [], []
    with recording(kernels, "nn_resident", nn_calls), recording(scan, "scan_block", scan_calls), \
            recording(scan, "scan_tiled", tiled_calls), recording(ransac, "ransac_counts", count_calls), \
            graphs.eager():
        mesh.evaluate_batch(b, fuse())
    emit({"phase": 10, "part": "kernels at the bucket's shapes",
          **phase10_kernels(nn_calls[0], scan_calls, count_calls[0], tiled_calls)})
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
    from gps_optimize_slam_tpu_torch.utils import graphs

    device = torch.device("cuda")
    smi = nvidia_smi()
    t0 = time.perf_counter()
    _build.library()
    build_s = time.perf_counter() - t0
    emit({"phase": 0, "nvidia_smi": smi, "torch": torch.__version__, "cuda": torch.version.cuda,
          "kernel_build_s": build_s, "library": os.path.basename(_build.BUILD_INFO["path"]),
          "registers_and_spills": build_registers(_build.BUILD_INFO["log"])})
    t0 = time.perf_counter()
    entries = phase1(device)
    emit({"phase": 1, "wall_s": time.perf_counter() - t0})

    def programs_of(k, phase):
        """Phase ``k`` with the captured programs' counts set to 0 before it,
        and a line of its wall and of their first calls, captures and
        replays after it, with the programs held and their pools: the
        programs stay for the phases after it."""
        graphs.reset_stats()
        t0 = time.perf_counter()
        out = phase(device)
        torch.cuda.synchronize()
        emit({"phase": k, "wall_s": time.perf_counter() - t0, "graphs": graph_stats(),
              "memory_reserved_mb": torch.cuda.memory_reserved() / 2**20})
        return out

    programs_of(2, phase2)
    programs_of(3, phase3)
    in_core = programs_of(4, phase4)
    chunked = programs_of(5, phase5)
    robust = programs_of(6, phase6)
    batched = programs_of(7, phase7)
    refined = programs_of(8, phase8)
    split, sharded = programs_of(9, phase9)
    long_logs_run = programs_of(10, phase10)
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
