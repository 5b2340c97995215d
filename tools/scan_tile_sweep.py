#!/usr/bin/env python3
"""K1's batch grid (``csrc/scan_lookback.cuh``, ``csrc/scan_cluster.cuh``)
at other tiles than the ones it launches, timed on one NVIDIA GPU: the
measurements that choose the cluster path's tile (``ClusterTile``) and the
runs tile of rts and quat_chain (``RunsTile``).

Writes one CUDA source a combine under ``build/scan_tile_sweep/`` that
instantiates, from this checkout's headers, every variant below, builds
them with the library's own nvcc flags (``ops._build.NVCC_FLAGS``, one
nvcc process a source, all started together) and loads them with ctypes:

* ``cluster``: the cluster path (``cluster_scan_kernel``) at the fleet
  bucket (64 x 4,661) and the eleven KITTI lengths as one ragged batch
  (rows padded with their last element), every combine but the filter,
  float32 and float64: the ladder tile (256 threads) at 3 and 4 items a
  thread and the runs tile (128 threads) at 4, 6 and 8, each through the
  library's ``cluster_launch`` (up to 16 blocks a cluster);
  beside it the look-back path (``lookback_scan_kernel``, the memset of its
  flags included) with the ladder tile K1 had before the cluster path
  (``scan_items``);
* ``mid``: quat_chain, rts, mobius and add2 at 16 rows of 8,192 and
  16,384 and 64 rows of 8,192: the cluster path's runs tiles (where a row
  fits in 16 blocks) against the look-back path's ladder tile and, for rts
  and quat_chain, its runs tiles;
* ``long``: rts and quat_chain on the look-back path at 2, 4, 8, 16 and 64
  rows of 16,385 and phase 10's four identity-padded rows of 524,288 /
  458,752 / 393,216 / 300,000, float32 and float64: the ladder tile at its
  items and the runs tile at 128 threads x 4 and 8 items and 256 x 4.

Each variant is held against ``scan.scan_plain`` (its relative error, and
whether it is within the scan's tolerance) and timed: ``device_ms``, the device time of everything a
call runs (``chip_smoke.device_ms``: kernel and memset, a torch.profiler
trace of 20 calls), and ``ms``, its CUDA-event median. The registers and
spill bytes of each instantiation come from ``-Xptxas -v``. Prints one JSON
line a shape and writes all of it to ``--out``, where given.

    python3 tools/scan_tile_sweep.py [--parts cluster,mid,long] [--out FILE]
"""

import argparse
import ctypes
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

import chip_smoke  # noqa: E402

OUT_DIR = os.path.join(HERE, "build", "scan_tile_sweep")
OPS = {  # op -> C++ combine
    "quat_chain": "QuatChain", "rts": "RtsSuffix", "mobius": "Mobius", "affine3": "Affine3",
    "add2": "Add2", "max3": "Max3", "min3": "Min3",
}
LADDER_ITEMS = {"quat_chain": 8, "rts": 2, "mobius": 8, "affine3": 8, "add2": 8, "max3": 8, "min3": 8}
CLUSTER_TILES = [("ladder", 256, 3), ("ladder", 256, 4), ("runs", 128, 4), ("runs", 128, 6), ("runs", 128, 8)]
LONG_OPS = ("rts", "quat_chain")
LONG_TILES = [("runs", 128, 4), ("runs", 128, 8), ("runs", 256, 4)]
MID_OPS = ("quat_chain", "rts", "mobius", "add2")
MID_SHAPES = {"16x8192": (8192,) * 16, "16x16384": (16_384,) * 16, "64x8192": (8192,) * 64}
LONG_SHAPES = {"2x16385": (16_385,) * 2, "4x16385": (16_385,) * 4, "8x16385": (16_385,) * 8,
               "16x16385": (16_385,) * 16, "64x16385": (16_385,) * 64, "phase10": chip_smoke.LONG_LOG_LENGTHS}

PRELUDE = r'''
#include "scan_cluster.cuh"
#define EXPORT extern "C" __attribute__((visibility("default")))
namespace {
template <class Op, typename T, int ITEMS, bool RUNS, int THREADS>
int cluster_any(const void* in, void* out, int n, int batch, int reverse, void* stream) {
  return (int)cluster_launch<Op, T, ITEMS, RUNS, THREADS>(in, out, n, batch, reverse, static_cast<cudaStream_t>(stream));
}
template <class Op, typename T, int ITEMS, bool RUNS, int THREADS>
int lookback_any(const void* in, void* out, int n, int batch, int reverse, void* scratch, void* stream) {
  return (int)LookbackScan<Op, T>::template launch<ITEMS, RUNS, THREADS>(in, out, n, batch, reverse, scratch,
                                                                          static_cast<cudaStream_t>(stream));
}
template <class Op, typename T, int ITEMS, int THREADS>
long long lookback_scratch(int n, int batch) {
  return (long long)LookbackLayout<Op, T, ITEMS, THREADS>::scratch_bytes(n, batch);
}
}  // namespace
'''


def variants():
    """[(kind, op, dtype, tile, threads, items)]: every instantiation the
    sweep builds, in the order of their codes."""
    out = []
    for op in OPS:
        for dt in ("float32", "float64"):
            out.append(("lookback", op, dt, "ladder", 256, LADDER_ITEMS[op]))
            out += [("cluster", op, dt, tile, th, it) for tile, th, it in CLUSTER_TILES]
            if op in LONG_OPS:
                out += [("lookback", op, dt, tile, th, it) for tile, th, it in LONG_TILES]
    return out


def source(op: str, vs) -> str:
    """The CUDA source of ``op``'s variants: three C entry points a combine
    (a launch on each path and the look-back path's scratch bytes), each
    switching on the variant's code."""
    cases = {"cluster": [], "lookback": [], "scratch": []}
    for code, (kind, o, dt, tile, th, it) in enumerate(vs):
        if o != op:
            continue
        T = "float" if dt == "float32" else "double"
        args = f"{OPS[op]}<{T}>, {T}, {it}, {'true' if tile == 'runs' else 'false'}, {th}"
        if kind == "cluster":
            cases["cluster"].append(f"case {code}: return cluster_any<{args}>(in, out, n, batch, reverse, stream);")
        else:
            cases["lookback"].append(
                f"case {code}: return lookback_any<{args}>(in, out, n, batch, reverse, scratch, stream);")
            cases["scratch"].append(f"case {code}: return lookback_scratch<{OPS[op]}<{T}>, {T}, {it}, {th}>(n, batch);")
    body = PRELUDE
    body += (f"EXPORT int sweep_cluster_{op}(int v, const void* in, void* out, int n, int batch, int reverse, "
             f"void* stream) {{\n  switch (v) {{\n    " + "\n    ".join(cases["cluster"])
             + "\n    default: return (int)cudaErrorInvalidValue;\n  }\n}\n")
    body += (f"EXPORT int sweep_lookback_{op}(int v, const void* in, void* out, int n, int batch, int reverse, "
             f"void* scratch, void* stream) {{\n  switch (v) {{\n    " + "\n    ".join(cases["lookback"])
             + "\n    default: return (int)cudaErrorInvalidValue;\n  }\n}\n")
    body += (f"EXPORT long long sweep_scratch_{op}(int v, int n, int batch) {{\n  switch (v) {{\n    "
             + "\n    ".join(cases["scratch"]) + "\n    default: return -1;\n  }\n}\n")
    return body


def build(vs):
    """(ctypes library, nvcc's -Xptxas -v output)."""
    from gps_optimize_slam_tpu_torch.ops import _build

    os.makedirs(OUT_DIR, exist_ok=True)
    nvcc = _build._nvcc()
    procs, objs = [], []
    for op in OPS:
        src = os.path.join(OUT_DIR, f"sweep_{op}.cu")
        with open(src, "w") as f:
            f.write(source(op, vs))
        obj = src[:-3] + ".o"
        objs.append(obj)
        procs.append(subprocess.Popen([nvcc, *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-c", "-o", obj, src],
                                      stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    outs = [(p.communicate()[0], p.returncode) for p in procs]
    log = "".join(o for o, _ in outs)
    if any(rc for _, rc in outs):
        raise SystemExit(f"scan_tile_sweep: nvcc failed:\n{log[-20000:]}")
    so = os.path.join(OUT_DIR, "libsweep.so")
    link = subprocess.run([nvcc, "-shared", "-o", so, *objs], capture_output=True, text=True)
    if link.returncode:
        raise SystemExit(f"scan_tile_sweep: link failed:\n{link.stdout}{link.stderr}")
    lib = ctypes.CDLL(so)
    VP, I = ctypes.c_void_p, ctypes.c_int
    for op in OPS:
        getattr(lib, f"sweep_cluster_{op}").argtypes = [I, VP, VP, I, I, I, VP]
        getattr(lib, f"sweep_lookback_{op}").argtypes = [I, VP, VP, I, I, I, VP, VP]
        getattr(lib, f"sweep_scratch_{op}").argtypes = [I, I, I]
        getattr(lib, f"sweep_scratch_{op}").restype = ctypes.c_longlong
    return lib, log


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parts", default="cluster,mid,long")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None, help="also write every result to this JSON file")
    args = ap.parse_args()
    import torch

    from gps_optimize_slam_tpu_torch.ops import _build, scan

    if not torch.cuda.is_available():
        raise SystemExit("scan_tile_sweep: no CUDA device")
    device = torch.device("cuda")
    vs = variants()
    lib, log = build(vs)
    regs = chip_smoke.scan_kernel_registers(log)
    stream = lambda: torch.cuda.current_stream(device).cuda_stream  # noqa: E731
    gen = torch.Generator().manual_seed(args.seed)
    result = {"card": chip_smoke.nvidia_smi(), "registers_and_spills": regs, "shapes": {}}
    print(json.dumps({"card": result["card"], "registers_and_spills": regs}), flush=True)

    def call(code, kind, op, x, reverse):
        out = torch.empty_like(x)
        n, batch = x.shape[-1], x.shape[1]
        if kind == "cluster":
            fn = lambda: getattr(lib, f"sweep_cluster_{op}")(code, x.data_ptr(), out.data_ptr(), n, batch,  # noqa: E731
                                                             int(reverse), stream())
        else:
            nbytes = getattr(lib, f"sweep_scratch_{op}")(code, n, batch)
            scratch = torch.empty((nbytes,), dtype=torch.uint8, device=device)
            fn = lambda: getattr(lib, f"sweep_lookback_{op}")(code, x.data_ptr(), out.data_ptr(), n, batch,  # noqa: E731
                                                              int(reverse), scratch.data_ptr(), stream())
        return fn, out

    def time_variants(label, shape_of, picks):
        for op in sorted({v[1] for _, v in picks}):
            for dt in ("float32", "float64"):
                dtype = getattr(torch, dt)
                x = shape_of(op, dtype)
                reverse = chip_smoke.REVERSE_OF.get(op, False)
                want = scan.scan_plain(op, x, reverse).reshape(-1, x.shape[-1])
                rows = {}
                for code, (kind, o, d, tile, th, it) in picks:
                    if o != op or d != dt:
                        continue
                    fn, out = call(code, kind, op, x, reverse)
                    rc = fn()
                    torch.cuda.synchronize()
                    key = f"{kind}/{tile}/{th}x{it}"
                    if rc != 0:
                        rows[key] = {"rc": rc}
                        continue
                    err = chip_smoke.rel_err(out.reshape(-1, x.shape[-1]), want)
                    tile_n = th * it
                    rows[key] = {"tiles": -(-x.shape[-1] // tile_n), "rel_err": err,
                                 "within_tol": err <= chip_smoke.TOL[dt],
                                 "device_ms": chip_smoke.device_ms(fn), "ms": chip_smoke.cuda_ms(fn, reps=20),
                                 "registers_and_spills": regs.get(f"{kind}/{op}/{dt}/{tile}/{th}/{it}")}
                entry = {"shape": list(x.shape), "reverse": reverse, "bound": chip_smoke.scan_bound(op, x),
                         "variants": rows}
                result["shapes"][f"{label}/{op}/{dt}"] = entry
                print(json.dumps({f"{label}/{op}/{dt}": entry}), flush=True)
                del x, want
                torch.cuda.empty_cache()

    parts = args.parts.split(",")
    if "cluster" in parts:
        picks = [(c, v) for c, v in enumerate(vs) if v[0] == "cluster" or v[3:] == ("ladder", 256, LADDER_ITEMS[v[1]])]
        fleet = (chip_smoke.FLEET[1],) * chip_smoke.FLEET[0]
        time_variants("fleet", lambda op, dt: chip_smoke.batched_scan_inputs(op, fleet, gen, dt, device), picks)
        time_variants("kitti", lambda op, dt: chip_smoke.batched_scan_inputs(op, chip_smoke.KITTI_LENGTHS, gen, dt,
                                                                             device), picks)
    if "mid" in parts:
        picks = [(c, v) for c, v in enumerate(vs) if v[1] in MID_OPS and (v[0] == "cluster" and v[3] == "runs"
                                                                           or v[0] == "lookback")]
        for label, ns in MID_SHAPES.items():
            time_variants(label, lambda op, dt, ns=ns: chip_smoke.batched_scan_inputs(op, ns, gen, dt, device), picks)
    if "long" in parts:
        picks = [(c, v) for c, v in enumerate(vs) if v[0] == "lookback" and v[1] in LONG_OPS]
        for label, ns in LONG_SHAPES.items():
            time_variants(label, lambda op, dt, ns=ns: chip_smoke.identity_padded_rows(op, ns, gen, dt, device), picks)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f)


if __name__ == "__main__":
    main()
