#!/usr/bin/env python3
"""What one Gauss-Newton step of the port's pose graph
(``gps_optimize_slam_tpu_torch/models/pose_graph.py``) costs, on one NVIDIA
GPU (the default) or on the CPU.

Fuses the shuttle of ``chip_smoke.shuttle_sequence`` (``--poses`` poses,
float64), proposes its loop closures, linearises the pose graph at the
fused trajectory, and prints as one JSON line:

* the leaf ATen ops of one step's linearisation (``pose_graph._linearise``,
  the per-factor Jacobian blocks) and of one whole step, counted by
  ``torch.profiler`` on the host (on the card, each op that is not a view or
  an allocation is one kernel launch);
* the time of one linearisation and of one 50-iteration CG solve over its
  blocks (``kernels.pose_cg``: one launch on the card, the plain version on
  the CPU; CUDA events on the card, the host clock on the CPU), and the
  largest relative difference of the blocks' Jv from ``torch.func.jvp`` of
  the whole residual;
* with ``--sensitivity``, how far a refinement moves when the fused
  positions change by one part in 1e15: the shuttle's (``chip_smoke.REFINE``)
  and seq-04's golden fusion with closures proposed 2 s apart within 40 m
  (5 steps of 50 CG iterations);
* with ``--profiler-cost`` (card only), one more JSON line a run: what
  ``chip_smoke.profile_device`` costs on the shuttle's refinement
  (``chip_smoke.REFINE`` cut to 1 and 2 steps) when it traces the device
  alone and when it traces the host's ops too: the traced run's wall, the
  seconds spent reading the trace after it, the kernels, the idle share and
  the growth of the process's peak resident memory.

Run from the repository root:

    python3 tools/torch_pose_graph_probe.py [--device cuda|cpu] [--poses N] [--sensitivity] [--profiler-cost]
"""

import argparse
import json
import os
import resource
import sys
import time

import torch
from torch.func import jvp
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402
from gps_optimize_slam_tpu_torch import pipeline  # noqa: E402
from gps_optimize_slam_tpu_torch.models import pose_graph  # noqa: E402
from gps_optimize_slam_tpu_torch.ops import kernels  # noqa: E402


def leaf_ops(fn) -> dict:
    """Leaf ATen ops of ``fn()``, by name, from a host-side profile."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    counts = {}
    for e in prof.events():
        if e.name.startswith("aten::") and not any(c.name.startswith("aten::") for c in e.cpu_children):
            counts[e.name] = counts.get(e.name, 0) + 1
    return {"total": sum(counts.values()), "top": sorted(counts.items(), key=lambda kv: -kv[1])[:8]}


SEQ04_CLOSURES = dict(iterations=5, cg_iters=50, loop_min_time_gap=2.0, loop_radius=40.0, max_loops=6)


def golden_fusion(device):
    """seq-04's golden fusion outputs as a result ``refine_pose_graph`` takes."""
    import numpy as np

    from gps_optimize_slam_tpu_torch.models import fusion
    from gps_optimize_slam_tpu_torch.ops.umeyama import Sim3

    g, slam = chip_smoke.golden_arrays()
    t = {k: torch.as_tensor(g[k], device=device) for k in ("corrected_pos", "corrected_quat", "sim3_pos",
                                                             "sim3_quat", "aligned_gps")}
    n = len(slam["timestamps"])
    out = fusion.FusionOutputs(**t, sim3_inliers=torch.zeros(n, dtype=torch.bool, device=device),
                               gps_valid=torch.as_tensor(g["valid_mask"].astype(bool), device=device),
                               ok=torch.tensor(True, device=device),
                               sim3=Sim3(*(torch.as_tensor(np.asarray(g[k]), device=device)
                                           for k in ("sim3_R", "sim3_t", "sim3_scale")), torch.tensor(True)))
    return pipeline.FusionResult(slam=slam, gps=None, outputs=out, evaluation=None, config=None)


def sensitivity(res, kw) -> dict:
    """The refinement of ``res`` against that of ``res`` with its fused
    positions scaled by 1 + 1e-15."""
    gn, info = pipeline.refine_pose_graph(res, **kw)
    o = res.outputs
    res.outputs = o._replace(corrected_pos=o.corrected_pos * (1 + 1e-15))
    gn2, info2 = pipeline.refine_pose_graph(res, **kw)
    res.outputs = o
    return {**chip_smoke.refine_gaps(gn2, info2, gn, info), "loops": info["n_loops"]}


def profiler_cost(res):
    """``chip_smoke.profile_device`` on ``refine_pose_graph(res)`` cut to 1
    and 2 Gauss-Newton steps, tracing the device alone and then the host's
    ops too (peak memory only grows, so the lighter trace runs first);
    yields one result a run."""
    for iterations in (1, 2):
        for host_ops in (False, True):
            rss0 = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
            t0 = time.perf_counter()
            prof = chip_smoke.profile_device(
                lambda: pipeline.refine_pose_graph(res, **{**chip_smoke.REFINE, "iterations": iterations}),
                host_ops=host_ops)
            total_s = time.perf_counter() - t0
            yield {"gn_steps": iterations, "trace": "host_and_device" if host_ops else "device_only",
                   "traced_wall_s": prof["wall_ms"] / 1e3, "read_trace_s": total_s - prof["wall_ms"] / 1e3,
                   "kernels": prof["kernels"], "idle_share": prof["idle_share"],
                   "peak_rss_growth_mb": (resource.getrusage(resource.RUSAGE_SELF).ru_maxrss - rss0) / 1024}


def ms(fn, device, reps: int = 5) -> float:
    fn()
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return 1e3 * (time.perf_counter() - t0) / reps
    return chip_smoke.cuda_ms(fn, reps)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--poses", type=int, default=chip_smoke.SHUTTLE_N)
    ap.add_argument("--sensitivity", action="store_true")
    ap.add_argument("--profiler-cost", action="store_true")
    args = ap.parse_args()
    device = torch.device(args.device)

    slam, gt, gp = chip_smoke.shuttle_sequence(args.poses)
    res = pipeline.fuse_arrays(slam, chip_smoke.shuttle_gps(gt, gp), device=device)
    o = res.outputs
    times = torch.as_tensor(slam["timestamps"], device=device)
    loops = pose_graph.propose_loop_closures(o.corrected_pos, times, o.sim3_quat)
    data = pose_graph.build_data_from_fusion(o.sim3_pos, o.sim3_quat, o.aligned_gps, o.gps_valid, *loops)
    state = pose_graph.PoseGraphState(o.corrected_pos, o.corrected_quat)
    lin = pose_graph._linearise(state, data)
    n = state.positions.shape[0]
    v = torch.randn((n, 6), generator=torch.Generator().manual_seed(8), dtype=lin.blocks.dtype).to(device)
    cost = pose_graph._cost(state, data)
    cg_args = (lin.blocks, lin.r0, lin.r_gps, data.gps_valid, data.w_gps, data.loop_ij, 1e-6, 50)

    def r_of_delta(delta):
        """The residual on the tangent space, for ``torch.func.jvp``."""
        return pose_graph.residuals(pose_graph._retract(state, delta), data)

    want = jvp(r_of_delta, (torch.zeros_like(v),), (v,))[1]
    pi = torch.cat([torch.arange(n - 1, device=device), data.loop_ij[:, 0]])
    pj = torch.cat([torch.arange(1, n, device=device), data.loop_ij[:, 1]])
    u = torch.einsum("mrc,mc->mr", lin.blocks, torch.cat([v[pi], v[pj]], -1))
    gps = torch.where(data.gps_valid[:, None], data.w_gps * v[:, :3], torch.zeros_like(v[:, :3]))
    got = torch.cat([u[: n - 1].reshape(-1), gps.reshape(-1), u[n - 1 :].reshape(-1)])
    out = {
        "device": torch.cuda.get_device_name(0) if device.type == "cuda" else "cpu",
        "poses": args.poses,
        "loops": int(loops[3].sum()),
        "leaf_ops": {
            "linearise": leaf_ops(lambda: pose_graph._linearise(state, data)),
            "gn_step": leaf_ops(lambda: pose_graph._gn_step(state, data, 50, 1e-6, cost))["total"],
        },
        "linearise_ms": ms(lambda: pose_graph._linearise(state, data), device),
        "pose_cg_ms": ms(lambda: kernels.pose_cg(*cg_args), device),
        "jv_rel_diff": float((got - want).abs().max() / want.abs().max()),
    }
    if args.sensitivity:
        out["sensitivity_1e-15"] = {"shuttle": sensitivity(res, chip_smoke.REFINE),
                                    "seq04_closures": sensitivity(golden_fusion(device), SEQ04_CLOSURES)}
    print(json.dumps(out), flush=True)
    if args.profiler_cost:
        for line in profiler_cost(res):
            print(json.dumps({"profiler_cost": line}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
