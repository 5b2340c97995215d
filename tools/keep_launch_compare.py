#!/usr/bin/env python3
"""The keep lists of K3 and K4 (``csrc/nn_keep.cu``, ``kernels.keep_lists``)
of one checkout of the port, timed on one NVIDIA GPU at the shapes the main
path gives them, to compare two checkouts in one run.

Imports ``gps_optimize_slam_tpu_torch`` from ``--root`` (a checkout's root;
the kernels build into its own ``build/kernels``) and prints one JSON line
with, per shape:

* ``call_ms``: a whole ``kernels.keep_lists`` call, CUDA-event median of 50
  calls after a warm-up (the wrapper's host time included: the start event
  runs on an idle card, so a call whose host part is longer than its
  launches' device time reads as that host time plus the last launch);
* ``host_us``: the host's part of a call, ``time.perf_counter`` median,
  10th and 90th percentiles over 200 calls, each after a synchronisation:
  ``call`` the whole call, ``entry`` the C entry point ``gps_nn_keep``
  within it (its launches), ``rest`` the medians' difference (the Python
  wrapper and its allocations), and ``empties`` four bare ``torch.empty``
  calls of the call's sizes (the same code in every checkout: how fast
  this process's host side runs);
* ``graph_ms``: the call captured once in a CUDA graph and replayed 20
  times between two CUDA events, a replay's share: the device time of all
  its launches and the gaps between them, without the wrapper;
* ``launch_device_ms``: ``{kernel: [ms, traced]}``, a launch's device time
  from a ``torch.profiler`` trace of 20 calls (``chip_smoke.launch_device_ms``:
  the traced time over the launches the trace holds, and how many it
  holds; a trace now and then holds fewer than the 20 made) for
  ``segment_boxes_kernel``, ``group_boxes_kernel`` (where the checkout has
  it and a row has two groups or more) and ``keep_lists_kernel``;
* ``kept_tile_pairs``, ``tile_pairs`` and ``equal_to_plain`` (the counts,
  the lists up to their counts and the packed candidates against
  ``chip_smoke.plain_keep_lists``), and ``plain_ms``, that plain version's
  CUDA-event median of 2 calls;
* ``plan``: where the checkout has ``kernels.keep_split``, the regime
  (``chip_smoke.keep_plan``: query tiles, groups, warps a query tile);

and the keep-list kernels' registers and spill bytes from ``-Xptxas -v``.

The shapes: the fleet bucket (64 x 4,661 random walks, float32, phase 1's
and phase 7's), phase 10's own operands (the first NN call of
``mesh.evaluate_batch`` on the long-log bucket after ``mesh.fuse_batch``,
4 x 524,288 float64 coherent replicas), phase 4's (the three NN calls of
``pipeline.fuse_arrays`` on the 4,661-pose replica sequence, float32),
phase 5's (the first NN block of each of the three metrics of
``evaluate_chunked`` after ``fuse_core_chunked`` at 1,048,576 poses, 524,288
x 524,288 float64), 524,288 x 524,288 float64 random walks, K4's winning
shape (700 x 524,288 shuffled candidates, float64), and the shapes whose
few query tiles take several warps each (``split/...``, float64 walks:
700 x 70,000 shuffled, 4,661 x 100,000, 700 x 524,288 and 2,000 x
1,000,000 coherent and shuffled). The operands of
phases 4, 5 and 10 are recorded from the checkout's own entry points under
``graphs.eager()``; the rest are made from ``--seed`` alike for every
checkout. Run from the repository root, a parent checkout unpacked under
``build/``, in turns:

    python3 tools/keep_launch_compare.py --root build/parent
    python3 tools/keep_launch_compare.py --root .
    python3 tools/keep_launch_compare.py --root .
    python3 tools/keep_launch_compare.py --root build/parent
"""

import argparse
import importlib.util
import json
import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHUNK = 524_288
FLEET = (64, 4661)
WIN = (700, CHUNK)
LONG_POSES = 1_048_576  # phase 5's chunked sequence
SPLIT_SHAPES = ((700, 70_000, True), (4661, 100_000, False), (700, CHUNK, False), (2000, 1_000_000, False),
                (2000, 1_000_000, True))  # (queries, candidates, shuffled)


def load_chip_smoke():
    """This checkout's ``chip_smoke.py`` (its timers, inputs and plain
    lists), whatever ``--root`` holds."""
    spec = importlib.util.spec_from_file_location("chip_smoke_of_this_tool", os.path.join(HERE, "chip_smoke.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def recorded(cs, kernels, fn):
    """The (traj, cand, mask) of every ``kernels.keep_lists`` call ``fn``
    makes, run eagerly (no captured program)."""
    from gps_optimize_slam_tpu_torch.utils import graphs

    calls = []
    with graphs.eager(), cs.recording(kernels, "keep_lists", calls):
        fn()
    return [tuple(c[:3]) for c in calls]


def phase4_operands(cs, kernels, device):
    import torch

    from gps_optimize_slam_tpu_torch import pipeline

    slam, gt, gp = cs.replica_sequence(cs.SEQ02_LEN)
    gps = pipeline.GPSData(timestamps=gt, positions=gp, valid=np.ones(len(gt), bool), frame="enu",
                           utm_zone=32, utm_south=False)
    return recorded(cs, kernels, lambda: pipeline.fuse_arrays(slam, gps, dtype=torch.float32, device=device))


def phase5_operands(cs, kernels, device):
    import torch

    from gps_optimize_slam_tpu_torch.config import FusionConfig
    from gps_optimize_slam_tpu_torch.models import fusion_chunked

    slam, gt, gp = cs.outage_sequence(LONG_POSES)
    st, sp, sq = slam["timestamps"], slam["positions"], slam["quaternions"]
    cfg, f64 = FusionConfig(gps_sorted=True), torch.float64
    res = fusion_chunked.fuse_core_chunked(st, sp, sq, gt, gp, np.ones(len(gt), bool), seed=0, config=cfg,
                                           chunk_size=CHUNK, dtype=f64, device=device)
    calls = recorded(cs, kernels, lambda: fusion_chunked.evaluate_chunked(
        st, sp, sq, res, chunk_size=CHUNK, dtype=f64, device=device))
    per_metric = len(calls) // 3
    return calls[::per_metric][:3]


def phase10_operands(cs, kernels, device):
    import torch

    from gps_optimize_slam_tpu_torch.config import FusionConfig
    from gps_optimize_slam_tpu_torch.parallel import batch as pbatch
    from gps_optimize_slam_tpu_torch.parallel import mesh

    rows = cs.long_logs()
    buckets = pbatch.bucket_by_length([r[0] for r in rows], [r[1] for r in rows], [r[2] for r in rows],
                                      max_waste=2.0)
    idxs, b = buckets[0]
    out = mesh.fuse_batch(b, [int(i) for i in idxs], config=FusionConfig(), device=device, dtype=torch.float64)
    return recorded(cs, kernels, lambda: mesh.evaluate_batch(b, out))[:1]


def cases(cs, kernels, seed: int, device):
    """(label, traj, cand, mask) of every shape."""
    import torch

    gen = torch.Generator().manual_seed(seed)
    f32, f64 = torch.float32, torch.float64
    yield ("fleet/float32", *cs.ragged_walks(gen, (FLEET[1],) * FLEET[0], (FLEET[1],) * FLEET[0], f32, device))
    for k, ops in enumerate(phase10_operands(cs, kernels, device)):
        yield (f"phase10/{k}/float64", *ops)
    for k, ops in enumerate(phase4_operands(cs, kernels, device)):
        yield (f"phase4/{k}/float32", *ops)
    for k, ops in enumerate(phase5_operands(cs, kernels, device)):
        yield (f"phase5/{k}/float64", *ops)
    traj, cand, mask = cs.ragged_walks(gen, (CHUNK,), (CHUNK,), f64, device)
    yield f"{CHUNK}x{CHUNK}/float64", traj[0], cand[0], mask[0]
    n, m = WIN
    traj = cs.walk(gen, n, f64, device)
    cand = (cs.walk(gen, m, f64, device) + 0.3)[torch.randperm(m, generator=gen).to(device)].contiguous()
    yield "win/float64", traj, cand, (torch.rand(m, generator=gen) > 0.1).to(device)
    for n, m, shuffle in SPLIT_SHAPES:
        traj, cand = cs.walk(gen, n, f64, device), cs.walk(gen, m, f64, device) + 0.3
        if shuffle:
            cand = cand[torch.randperm(m, generator=gen).to(device)].contiguous()
        yield (f"split/{n}x{m}{'/shuffled' if shuffle else ''}/float64", traj, cand,
               (torch.rand(m, generator=gen) > 0.1).to(device))


def host_us(fn, lib, sizes, dtype, reps: int = 200) -> dict:
    """The host time of ``fn`` (a keep-lists call) in µs, split as the
    module's docstring says; ``lib`` the kernels' library, ``sizes`` the
    call's (order, nkept, cand3, boxes) element counts."""
    import time

    import torch

    def stats(times):
        return [float(np.median(times)), float(np.percentile(times, 10)), float(np.percentile(times, 90))]

    real, entry = lib.gps_nn_keep, []

    def timed(*args):
        t0 = time.perf_counter()
        rc = real(*args)
        entry.append(1e6 * (time.perf_counter() - t0))
        return rc

    lib.gps_nn_keep = timed
    try:
        fn()
        entry.clear()
        calls = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            calls.append(1e6 * (time.perf_counter() - t0))
        torch.cuda.synchronize()
    finally:
        lib.gps_nn_keep = real
    empties = []
    for _ in range(reps):
        t0 = time.perf_counter()
        for n, dt in zip(sizes, (torch.int32, torch.int32, dtype, torch.float64)):
            torch.empty((n,), dtype=dt, device="cuda")
        empties.append(1e6 * (time.perf_counter() - t0))
    return {"call": stats(calls), "entry": stats(entry), "rest": float(np.median(calls) - np.median(entry)),
            "empties": stats(empties)}


def boxes_numel(traj, cand) -> int:
    """The float64 box scratch of a keep-lists call (``kernels.keep_lists``'s
    layout: every segment's, candidate tile's and group's box)."""
    from gps_optimize_slam_tpu_torch.ops import kernels

    batch = traj.shape[0] if traj.ndim == 3 else 1
    n_tiles, m_tiles = kernels._tiles(traj.shape[-2], cand.shape[-2])
    segs = (n_tiles * kernels.TILE_N + m_tiles * kernels.TILE_M) // kernels.SUB
    return batch * 6 * (segs + m_tiles + -(-m_tiles // 32))


def graph_ms(fn, reps: int = 20) -> float:
    """A replay's share of ``reps`` replays of ``fn`` captured in one CUDA
    graph, between two CUDA events."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    graph.replay()
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=".", help="the checkout whose port to time")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    cs = load_chip_smoke()
    sys.path.insert(0, root)
    import torch

    from gps_optimize_slam_tpu_torch.ops import _build, kernels

    if not torch.cuda.is_available():
        raise SystemExit("keep_launch_compare: no CUDA device")
    if not kernels.__file__.startswith(root + os.sep):
        raise SystemExit(f"keep_launch_compare: imported {kernels.__file__}, not the checkout at {root}")
    device = torch.device("cuda")
    _build.library()
    registers = cs.build_registers(_build.BUILD_INFO["log"])
    out = {"root": args.root, "card": cs.card_name(),
           "registers_and_spills": {k: v for k, v in registers.items() if "boxes" in k or "keep" in k},
           "cases": {}}
    for label, traj, cand, mask in cases(cs, kernels, args.seed, device):
        def call():
            return kernels.keep_lists(traj, cand, mask)

        order, nkept, cand3 = call()
        want_order, want_nkept, want_cand3 = cs.plain_keep_lists(traj, cand, mask)
        cols = torch.arange(order.shape[-1], device=device) < nkept[..., None]
        equal = bool(torch.equal(nkept, want_nkept)
                     and torch.equal(torch.where(cols, order, -1), torch.where(cols, want_order, -1))
                     and torch.equal(cs.same_bits(cand3), cs.same_bits(want_cand3)))
        res = {"shape": [*traj.shape[:-1], cand.shape[-2]], "equal_to_plain": equal,
               "kept_tile_pairs": int(nkept.sum()), "tile_pairs": order.numel(),
               "call_ms": cs.cuda_ms(call, reps=50),
               "host_us": host_us(call, _build.library(), [t.numel() for t in (order, nkept, cand3)]
                                  + [boxes_numel(traj, cand)], traj.dtype),
               "graph_ms": graph_ms(call),
               "plain_ms": cs.cuda_ms(lambda: cs.plain_keep_lists(traj, cand, mask), reps=2),
               "launch_device_ms": {k: list(cs.launch_device_ms(call, k, reps=20)) for k in cs.KEEP_KERNELS}}
        if hasattr(kernels, "keep_split"):
            res["plan"] = cs.keep_plan(traj, cand)
        out["cases"][label] = res
        del traj, cand, mask, order, nkept, cand3, want_order, want_nkept, want_cand3
        torch.cuda.empty_cache()
    print(json.dumps(out), flush=True)
    if not all(c["equal_to_plain"] for c in out["cases"].values()):
        raise SystemExit("keep_launch_compare: the keep lists differ from the plain ones")


if __name__ == "__main__":
    main()
