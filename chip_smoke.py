#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``gps_optimize_slam_tpu_torch``) on one
NVIDIA GPU: builds the CUDA kernels from ``gps_optimize_slam_tpu_torch/csrc``,
holds each against its plain PyTorch version on the card, and drives the
port's main path (``pipeline.fuse_files`` / ``fuse_arrays`` →
``fusion.fuse_core`` + ``fusion.evaluate`` → ``export_result``) on the real
KITTI seq-04 golden arrays and on a 4,661-pose sequence built from them.

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
  1. each kernel against its plain version on the card (K1: 8 combines at
     N = 271 and 4661 in float32 and float64; K3: 4661 x 4661, an all-masked
     and a ragged case; K5: 1000 trials x 4661 points), with CUDA-event times;
  2. seq-04 golden arrays, float64 UTM, ``fuse_arrays`` on the card, held
     against tests/golden/seq04_golden.npz and seq04_meta.json;
  3. seq-04 from TUM + GNSS files rebuilt from the npz, ``fuse_files`` in
     float32 ENU on the card + ``export_result``, held against the port's
     own CPU float64 run of the same files;
  4. a 4,661-pose sequence (KITTI seq-02's length) made of time-shifted
     replicas of seq-04, float32 and float64 on the card against the port's
     CPU float64 run, with the kernels' launch counts and the warm wall time.
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


def phase1(device):
    """Kernels against their plain versions on the card."""
    import torch

    from gps_optimize_slam_tpu_torch.ops import kernels, scan
    from gps_optimize_slam_tpu_torch.ops.ransac import select_winner
    from gps_optimize_slam_tpu_torch.ops.umeyama import umeyama_sim3

    gen = torch.Generator().manual_seed(0)
    entries = []
    # K1: all eight combines, both directions where the main path uses them.
    reverse_of = {"rts": True, "min3": True}
    for op in scan.OPS:
        worst = {}
        for dtype in (torch.float32, torch.float64):
            for n in (271, SEQ02_LEN):
                x = scan_inputs(op, n, gen, dtype, device)
                for rev in sorted({reverse_of.get(op, False), op == "affine3"}):
                    got = scan.associative_scan(op, x, rev)
                    torch.cuda.synchronize()
                    want = scan.scan_plain(op, x, rev)
                    err = rel_err(got, want)
                    name = str(dtype).split(".")[1]
                    if not err <= TOL[name]:
                        raise AssertionError(f"scan {op} {name} n={n} rev={rev}: rel err {err:.3e}")
                    worst[name] = max(worst.get(name, 0.0), err)
                    if n == SEQ02_LEN and dtype == torch.float32 and rev == reverse_of.get(op, False):
                        timed = (x, rev, abs_err(got, want))
        x, rev, aerr = timed
        ms = cuda_ms(lambda: scan.associative_scan(op, x, rev))
        plain_ms = cuda_ms(lambda: scan.scan_plain(op, x, rev))
        emit({"phase": 1, "kernel": f"scan/{op}", "rel_err": worst, "ms": ms, "plain_ms": plain_ms,
              "shape": list(x.shape), "dtype": "float32"})
        entries.append({"name": f"scan/{op}", "route": "cuda",
                        "source": "gps_optimize_slam_tpu_torch/csrc/scan.cu",
                        "replaces": "gps_optimize_slam_tpu/ops/pallas_scan.py:227",
                        "max_abs_err": aerr, "ms": ms, "plain_ms": plain_ms})

    # K3: trajectory-like query and candidate sets.
    def walk(n, dtype, scale=0.8):
        steps = scale * torch.randn(n, 3, generator=gen, dtype=torch.float64)
        return torch.cumsum(steps, 0).to(dtype=dtype, device=device)

    nn_err, timed = {}, None
    for dtype in (torch.float32, torch.float64):
        name = str(dtype).split(".")[1]
        for n, m in ((SEQ02_LEN, SEQ02_LEN), (300, 777)):
            traj, cand = walk(n, dtype), walk(m, dtype) + 0.3
            mask = (torch.rand(m, generator=gen) > 0.1).to(device)
            got = kernels.nn_min_dist2(traj, cand, mask)
            torch.cuda.synchronize()
            want = kernels.nn_min_dist2_plain(traj, cand, mask)
            err = rel_err(got[None], want[None])
            if not err <= TOL[name]:
                raise AssertionError(f"nn {name} {n}x{m}: rel err {err:.3e}")
            nn_err[name] = max(nn_err.get(name, 0.0), err)
            if n == SEQ02_LEN and dtype == torch.float32:
                timed = (traj, cand, mask, abs_err(got, want))
        none = kernels.nn_min_dist2(traj, cand, torch.zeros_like(mask))
        torch.cuda.synchronize()
        if not bool(torch.isinf(none).all()):
            raise AssertionError("nn: all-masked candidates must give +inf")
    traj, cand, mask, aerr = timed
    ms = cuda_ms(lambda: kernels.nn_min_dist2(traj, cand, mask))
    plain_ms = cuda_ms(lambda: kernels.nn_min_dist2_plain(traj, cand, mask))
    emit({"phase": 1, "kernel": "nn_min_dist2", "rel_err": nn_err, "ms": ms, "plain_ms": plain_ms,
          "shape": [SEQ02_LEN, SEQ02_LEN], "dtype": "float32"})
    entries.append({"name": "nn_min_dist2", "route": "cuda",
                    "source": "gps_optimize_slam_tpu_torch/csrc/nn.cu",
                    "replaces": "gps_optimize_slam_tpu/ops/pallas_kernels.py:283",
                    "max_abs_err": aerr, "ms": ms, "plain_ms": plain_ms})

    # K5: 1000 four-point Umeyama trials on a noisy Sim(3) pair.
    timed, worst = None, 0
    for dtype in (torch.float32, torch.float64):
        src = walk(SEQ02_LEN, torch.float64, scale=2.0)
        dst = 0.987 * src + torch.tensor([3.0, -2.0, 1.0], dtype=torch.float64, device=device)
        dst = dst + 2.0 * torch.randn(SEQ02_LEN, 3, generator=gen, dtype=torch.float64).to(device)
        src, dst = src.to(dtype), dst.to(dtype)
        valid = (torch.rand(SEQ02_LEN, generator=gen) > 0.05).to(device)
        draws = torch.randint(0, SEQ02_LEN, (1000, 4), generator=gen).to(device)
        fits = umeyama_sim3(src[draws], dst[draws])
        args = (src, dst, valid, fits.R.contiguous(), fits.t.contiguous(), fits.scale.contiguous(), 16.0)
        got = kernels.ransac_counts(*args)
        torch.cuda.synchronize()
        want = kernels.ransac_counts_plain(*args)
        diff = int((got - want).abs().max())
        if diff > 2:
            raise AssertionError(f"ransac_counts {dtype}: counts differ by {diff}")
        w_k = int(select_winner(src, dst, valid, fits, got, 16.0))
        w_p = int(select_winner(src, dst, valid, fits, want, 16.0))
        if w_k != w_p:
            raise AssertionError(f"ransac_counts {dtype}: winner {w_k} != {w_p}")
        worst = max(worst, diff)
        if dtype == torch.float32:
            timed = (args, diff)
    args, diff32 = timed
    ms = cuda_ms(lambda: kernels.ransac_counts(*args))
    plain_ms = cuda_ms(lambda: kernels.ransac_counts_plain(*args))
    emit({"phase": 1, "kernel": "ransac_counts", "max_count_diff": worst, "ms": ms,
          "plain_ms": plain_ms, "shape": [1000, SEQ02_LEN], "dtype": "float32"})
    entries.append({"name": "ransac_counts", "route": "cuda",
                    "source": "gps_optimize_slam_tpu_torch/csrc/ransac_counts.cu",
                    "replaces": "gps_optimize_slam_tpu/ops/pallas_kernels.py:450",
                    "max_abs_err": float(diff32), "ms": ms, "plain_ms": plain_ms})
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
    from gps_optimize_slam_tpu_torch.ops import kernels, scan

    slam, gt, gp = replica_sequence(SEQ02_LEN)
    gps = pipeline.GPSData(timestamps=gt, positions=gp, valid=np.ones(len(gt), bool),
                           frame="enu", utm_zone=32, utm_south=False)

    def run(dev, dtype):
        return pipeline.fuse_arrays(slam, gps, dtype=dtype, device=dev)

    t0 = time.perf_counter()
    ref = run("cpu", torch.float64)
    cpu_s = time.perf_counter() - t0
    res64 = run(device, torch.float64)

    for key in scan.OPS:
        scan.associative_scan.launches[key] = 0
    kernels.nn_min_dist2.launches = 0
    kernels.ransac_counts.launches = 0
    res = run(device, torch.float32)
    torch.cuda.synchronize()
    launches = dict(scan.associative_scan.launches)
    launches["nn_min_dist2"] = kernels.nn_min_dist2.launches
    launches["ransac_counts"] = kernels.ransac_counts.launches

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
    missing = [k for k, v in launches.items() if v <= 0]
    if missing:
        raise AssertionError(f"kernels not launched on the main path: {missing}")
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
          "kernel_build_s": build_s, "library": os.path.basename(_build.BUILD_INFO["path"])})
    entries = phase1(device)
    phase2(device)
    phase3(device)
    launches = phase4(device)
    for e in entries:
        e["launches"] = launches[e["name"].split("/")[-1]]
    print(smi, flush=True)
    emit({"kernels": entries})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
