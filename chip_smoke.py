#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``gps_optimize_slam_tpu_torch``) on one
NVIDIA GPU: builds the CUDA kernels from ``gps_optimize_slam_tpu_torch/csrc``,
holds each against its plain PyTorch version on the card, and drives the
port's two paths on data built from the real KITTI seq-04 golden arrays:
the in-core path (``pipeline.fuse_files`` / ``fuse_arrays`` →
``fusion.fuse_core`` + ``fusion.evaluate`` → ``export_result``) on seq-04
and on a 4,661-pose sequence, and the out-of-core chunked path
(``pipeline.fuse_files_chunked`` → ``fusion_chunked.fuse_core_chunked`` +
``evaluate_chunked``) on a 1,048,576-pose sequence and on seq-04.

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
     (``torch.cdist`` and ``min``) as its library yardstick; K4, 16,384 x
     300,000 and 524,288 x 524,288 (phase 5's NN blocks, K4 by the routing
     rule; the plain version on every 64th query; the kernel alone and with
     its wrapper), bit for bit against K3, and all-masked; K5, counts equal
     to the plain version's at 1000 trials x 4661 and 279 points and 333 x
     5003 (ragged point and trial chunks), with every point invalid, and
     twice on the same inputs; float32 and float64; and the routes: K1
     against K2 (and against the plain version) from 271 to 524,289 elements
     and at the last length the JAX package's budget gave K1, K3 against K4
     at 16,384 queries and 4661 to 1,048,576 candidates and, with shuffled
     candidates (every tile kept, long keep lists), at 700 and 4661
     queries, on the same inputs, the times that place the routing
     thresholds on this card;
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
     ``fusion.fuse_core``, ``evaluate_chunked`` on the K4 route (524,288-candidate
     blocks) against the K3 route (262,144), launch counts, warm wall times, poses
     per second and peak device memory; and ``fuse_files_chunked`` +
     ``export_result`` on the seq-04 files against the in-core
     ``fuse_files``, with launch counts of its own.

The launch counts of the ``{"kernels": [...]}`` line are those of the two
main-path runs (phase 4: ``fuse_arrays`` at 4,661 poses; phase 5:
``fuse_core_chunked`` + ``evaluate_chunked`` at 1,048,576 poses and
524,288-pose chunks), each with the counts set to 0 just before it and
read just after. The comparison launches of phase 1, phase 5's K3-route
evaluation and its seq-04 run do not count there.
"""

from __future__ import annotations

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
CHUNK = 524_288  # phase 5's chunk: its NN blocks take K4 (kernels.GRID_MIN_CANDIDATES)
# K2's lengths in phase 1: a default chunk plus its carry, a ragged one,
# phase 5's chunk plus its carry, one with fewer tiles than the card has
# persistent blocks (79 tiles of the float64 filter) and one with many more
# (4,097 of them).
TILED_LENGTHS = (TILED_N, TILED_N + 777, CHUNK + 1, 20_001, 1_048_577)
GRID_NN_SHAPE = (16_384, 300_000)  # K4's check and times below its route, a ragged last tile
GRID_NN_MAIN = (CHUNK, CHUNK)  # phase 5's NN block: queries x candidates
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
CDIST_BYTES_MAX = 4e9  # the library yardstick of K3 is timed where its n x m matrix fits in this


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


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
    """Each leaf read once and written once; n - 1 combines at least."""
    return bound(2 * x.numel() * x.element_size(), COMBINE_FLOPS[op] * (x.shape[1] - 1),
                 dtype_name(x.dtype))


def scan_library_ms(op: str, x, reverse: bool):
    """One PyTorch call that computes the same scan, where there is one
    (``torch.cumsum``, ``torch.cummax``, ``torch.cummin`` along the leaves).
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
    y = x.flip(1).contiguous() if reverse else x
    return lambda: call(y, dim=1)


def nn_bound(traj, cand, mask):
    """The operands read once and the output written once; the distance
    work of the candidate tiles this run's data keeps."""
    from gps_optimize_slam_tpu_torch.ops import kernels

    _, nkept, _ = kernels.keep_lists(traj, cand, mask)
    pairs = int(nkept.sum()) * kernels.TILE_N * kernels.TILE_M
    size = traj.element_size()
    moved = (traj.numel() + cand.numel() + traj.shape[0]) * size + mask.numel()
    return bound(moved, NN_PAIR_FLOPS * pairs, dtype_name(traj.dtype))


def cdist_library_ms(traj, cand, mask, reps: int = 5):
    """The reference pipeline's own method for the NN distance, as K3's and
    K4's library yardstick: ``torch.cdist`` without the matrix-product
    expansion, then ``min`` (two calls, the n x m matrix between them in
    device memory; distances, not their squares). Timed only: the port
    never calls it. None where the matrix would not fit in
    ``CDIST_BYTES_MAX``."""
    import torch

    if traj.shape[0] * cand.shape[0] * traj.element_size() > CDIST_BYTES_MAX:
        return None
    kept = cand[mask]
    ms = cuda_ms(lambda: torch.cdist(traj, kept, compute_mode="donot_use_mm_for_euclid_dist").min(1), reps)
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

    def check_grid(shape, stride):
        """K4 at ``shape`` in both dtypes: bit for bit against K3, within
        TOL of the plain version on every ``stride``-th query (the plain
        minimum of a query does not depend on the others), +inf when every
        candidate is masked. Returns per dtype the operands, K4's output,
        the plain one on the sampled queries and the relative error."""
        n, m = shape
        out = {}
        for dtype in (torch.float32, torch.float64):
            name = dtype_name(dtype)
            traj, cand = walk(gen, n, dtype, device), walk(gen, m, dtype, device) + 0.3
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
        }
    emit({"phase": 1, "kernel": "nn_grid", "rel_err": grid_err, "equal_to_k3": True,
          "shape": [n, m], "times": times})
    t = times["float64"]
    entries.append(kernel_entry("nn_grid", "nn_grid.cu", "pallas_kernels.py:302", "float64",
                                t["max_abs_err"], t["ms"], t["plain_ms"], t["bound"], None, t["device_ms"]))

    if kernels.nn_route(GRID_NN_MAIN[1]) != "grid" or kernels.nn_route(SEQ02_LEN) != "resident":
        raise AssertionError("the routing rule must send phase 5's NN blocks to K4 and phase 4's calls to K3")
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

    def plain(traj, cand, mask):
        order, nkept = kernels.keep_lists_plain(kernels.tile_keep_mask(*kernels.bounds_operands(traj, cand, mask)))
        return order, nkept, kernels.pack_candidates_plain(cand, mask, order.shape[1])

    def check(traj, cand, mask, what):
        order, nkept, cand4 = kernels.keep_lists(traj, cand, mask)
        want_order, want_nkept, want_cand4 = plain(traj, cand, mask)
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
    plain_ms = cuda_ms(lambda: plain(traj, cand, mask), reps=3)
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
ROUTE_LONG_LISTS = ((700, 65_536), (700, CHUNK), (SEQ02_LEN, CHUNK))


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

    edge = kernels.GRID_MIN_CANDIDATES
    if [kernels.nn_route(m) for m in (1, SEQ02_LEN, edge - 1, edge, CHUNK, 2 * CHUNK)] != 3 * ["resident"] + 3 * ["grid"]:
        raise AssertionError(f"K3 must take fewer than {edge} candidates and K4 the rest")
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
                        "route": kernels.nn_route(m)}
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


def phase1(device):
    """Kernels against their plain versions on the card."""
    import torch

    gen = torch.Generator().manual_seed(0)
    entries = phase1_block_scan(device, gen)
    entries += phase1_tiled_scan(device, gen)
    entries += phase1_keep(device, gen)
    entries += phase1_nn(device, gen)
    entries += phase1_counts(device, gen)
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


def replica_sequence(n: int):
    """A real-derived sequence of ``n`` poses: time-shifted replicas of the
    seq-04 golden arrays (real GNSS noise and timing), 2 cm of fresh noise
    per replica, GNSS in a local frame (UTM minus its first fix).

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
    rng = np.random.default_rng(0)
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


def profile_device(fn) -> dict:
    """One run of ``fn`` under torch.profiler: its wall time, the summed
    device time of its kernels and of its copies, the busy time (the union
    of those intervals, so overlap is counted once), the device's idle share
    of the wall (1 − busy/wall, not clamped, so a busy time past the wall
    shows as a negative share), and the five kernels with the most device
    time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
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
            "idle_share": 1.0 - busy_us / 1e3 / wall_ms,
            "top_kernels": [[name, ms, count] for name, (ms, count) in top]}


def outage_sequence(n: int):
    """``replica_sequence(n)`` with every GNSS fix dropped in a 10 s window
    around each 262,144-pose boundary, so that outage runs and RTS segments
    straddle the chunks (the gap threshold is 5 s)."""
    slam, gt, gp = replica_sequence(n)
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
    at 524,288 (NN blocks on K4) against 262,144 (on K3): every statistic
    ≤1e-12 relative (K4 equals K3 bit for bit). (c) every kernel of the
    path launched in this run. Then ``fuse_files_chunked`` +
    ``export_result`` on the seq-04 files, against the in-core
    ``fuse_files`` ≤1e-6 m."""
    import torch

    from gps_optimize_slam_tpu_torch import pipeline
    from gps_optimize_slam_tpu_torch.config import FusionConfig
    from gps_optimize_slam_tpu_torch.models import fusion, fusion_chunked
    from gps_optimize_slam_tpu_torch.ops import scan

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

    # The main path: its counts are set to 0 just before it and read just after.
    reset_launch_counts()
    res = fuse()
    torch.cuda.synchronize()
    fuse_peak = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    ev_grid = evaluate(res, CHUNK)
    torch.cuda.synchronize()
    eval_peak = torch.cuda.max_memory_allocated()
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
    eval_rel = max(rel_diff(float(getattr(getattr(ev_grid, p), f)), float(getattr(getattr(ev_resident, p), f)))
                   for p in parts for f in stats)
    err04 = float(np.abs(res04.corrected_pos - ref04.corrected_pos).max())
    emit({"phase": 5, "poses": CHUNKED_N, "gnss": int(len(gt)), "chunk": CHUNK, "dtype": "float64",
          "ok": [res.ok, ref_ok], "inliers": res.num_inliers,
          "chunked_vs_incore": {"corrected_pos_max_err_m": pos_err, "corrected_quat_max_err": quat_err,
                                "scale_rel_err": scale_rel},
          "eval_k4_vs_k3_max_rel_err": eval_rel, "rmse_ekf_m": float(ev_grid.nn_ekf.rmse),
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
        raise AssertionError(f"evaluation on the K4 route off the K3 route: {eval_rel:.3e}")
    if not err04 <= 1e-6 or back.shape != (271, 8) or not np.isfinite(back).all():
        raise AssertionError(f"seq-04 chunked off in-core ({err04:.3e} m) or malformed export")
    # At 524,288-pose chunks every scan is past K1's longest and every NN
    # block at K4's first candidate count; seq-04's single short chunk takes K1 and K3.
    required = [f"scan_tiled/{op}" for op in scan.OPS] + ["nn_keep", "nn_grid", "ransac_counts"]
    missing = [k for k in required if launches[k] <= 0]
    if missing:
        raise AssertionError(f"kernels not launched on the chunked path: {missing}")
    missing = [k for k in ("nn_keep", "nn_resident", "ransac_counts") if launches04[k] <= 0]
    if not any(v for k, v in launches04.items() if k.startswith("scan_block/")):
        missing.append("scan_block")
    if missing:
        raise AssertionError(f"kernels not launched on the chunked seq-04 run: {missing}")
    return launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
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
    for e in entries:
        e["launches"] = in_core[e["name"]] + chunked[e["name"]]
    print(smi, flush=True)
    emit({"kernels": entries})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
