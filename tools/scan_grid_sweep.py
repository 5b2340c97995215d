#!/usr/bin/env python3
"""K2's batch grid (``csrc/scan_tiled.cu``, ``tiled_grid_kernel``) at the shape
each combine launches (``GridOf``, listed as such) and at every shape of its
``GPS_SWEEP_SHAPES`` (compute warps, items a thread, stages of
the ring), timed on one NVIDIA GPU beside K1's batch grid: the
measurements that choose ``GridOf``.

Builds ``scan_tiled.cu`` once a combine with ``-DGPS_GRID_SWEEP=<op code>``
and the library's own nvcc flags (``ops._build.NVCC_FLAGS``; one nvcc
process a combine, all started together) into
``build/scan_grid_sweep/``, loads each with ctypes, and for each combine
and shape, float64, in the direction the main path scans it: the scan's
error against ``scan.scan_plain``, ``device_ms`` (``chip_smoke.device_ms``:
the kernel and the memset of its flags, a torch.profiler trace of 20
calls), the registers and spill bytes (``-Xptxas -v``), and K1's batch grid
(``scan.scan_block``) on the same leaves. A shape the card refuses (too
much shared memory) is listed with its error. Shapes: ``chip_smoke``'s
``TILED_BATCH`` (4 rows of 524,289 to 20,001), ``FUSE_BATCH`` (2 x 70,001),
4 x 262,145, and one row of 262,145 and of 524,289, where K2's single-row
kernel (``scan.scan_tiled`` on one row) is timed beside the grid. Prints one JSON line and writes it to ``--out``, where
given:

    python3 tools/scan_grid_sweep.py [--ops filter,rts] [--out FILE]
"""

import argparse
import ctypes
import json
import os
import re
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

import chip_smoke  # noqa: E402

OUT_DIR = os.path.join(HERE, "build", "scan_grid_sweep")
SHAPES = {"tiled_batch": chip_smoke.TILED_BATCH, "fuse_batch": chip_smoke.FUSE_BATCH, "4x262145": (262_145,) * 4,
          "1x262145": (262_145,), "1x524289": (524_289,)}


def build(ops):
    """{op: library path}, one nvcc a combine, all started together; and
    {op: nvcc's output}."""
    from gps_optimize_slam_tpu_torch.ops import _build, scan

    os.makedirs(OUT_DIR, exist_ok=True)
    src = str(_build.CSRC / "scan_tiled.cu")
    procs = {}
    for op in ops:
        so = os.path.join(OUT_DIR, f"{op}.so")
        procs[op] = (so, subprocess.Popen([_build._nvcc(), *_build.NVCC_FLAGS, f"-DGPS_GRID_SWEEP={scan.OPS[op][0]}",
                                           "-shared", "-o", so, src],
                                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs, logs = {}, {}
    for op, (so, p) in procs.items():
        logs[op] = p.communicate()[0]
        if p.returncode != 0:
            raise SystemExit(f"scan_grid_sweep: nvcc failed for {op}:\n{logs[op][-4000:]}")
        libs[op] = so
    return libs, logs


def registers(log: str) -> dict:
    """{"warps/items/stages" or "GridOf": [registers, spill bytes]} of the
    float64 ``tiled_grid_kernel`` instantiations in nvcc's output."""
    out, key = {}, None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            m = re.search(r"tiled_grid_kernel\w*?GridShapeILi(\d+)ELi(\d+)ELi(\d+)E", line)
            key = "/".join(m.groups()) if m and "IdE" in line else None
            if "tiled_grid_kernel" in line and "GridOfI" in line and "IdE" in line:
                key = "GridOf"
        elif key and (m := re.search(r"(\d+) bytes spill stores", line)):
            out.setdefault(key, [None, 0])[1] = int(m.group(1))
        elif key and (m := re.search(r"Used (\d+) registers", line)):
            out.setdefault(key, [None, 0])[0] = int(m.group(1))
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ops", default=None, help="comma-separated combines (default: all)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    import torch

    from gps_optimize_slam_tpu_torch.ops import _build, scan

    if not torch.cuda.is_available():
        raise SystemExit("scan_grid_sweep: no CUDA device")
    ops = args.ops.split(",") if args.ops else list(scan.OPS)
    libs, logs = build(ops)
    device = torch.device("cuda")
    gen = torch.Generator().manual_seed(args.seed)
    result = {"card": chip_smoke.nvidia_smi(), "sweep": {}}
    V, I, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    for op in ops:
        lib = ctypes.CDLL(libs[op])
        lib.gps_scan_tiled_variant.argtypes = [I, V, V, V, LL, I, I, I, V, V]
        lib.gps_scan_tiled_variant.restype = I
        lib.gps_scan_tiled_variant_shape.argtypes = [I, V]
        lib.gps_error_string.argtypes = [I]
        lib.gps_error_string.restype = ctypes.c_char_p
        shapes = []
        shape = (ctypes.c_int * 3)()
        while lib.gps_scan_tiled_variant_shape(len(shapes), shape) == 0:
            shapes.append(tuple(shape))
        entry = {"registers_and_spills": registers(logs[op]), "shapes": {}}
        reverse = chip_smoke.REVERSE_OF.get(op, False)
        for label, ns in SHAPES.items():
            x = chip_smoke.identity_padded_rows(op, ns, gen, torch.float64, device)
            n, batch = x.shape[-1], x.shape[1]
            want = scan.scan_plain(op, x, reverse)
            row = {"k1_device_ms": chip_smoke.device_ms(lambda: scan.scan_block(op, x, reverse)),
                   "bound_ms": chip_smoke.scan_bound(op, x)[0]}
            if batch == 1:  # the single-row kernel K2 launches for one row
                row["k2_single_row_device_ms"] = chip_smoke.device_ms(lambda: scan.scan_tiled(op, x, reverse))
            for v, (w, i, s) in enumerate(shapes):
                nbytes = ctypes.c_longlong()
                lib.gps_scan_tiled_variant(v, None, None, None, 0, n, batch, int(reverse), None, ctypes.byref(nbytes))
                scratch = torch.empty(nbytes.value, dtype=torch.uint8, device=device)
                out = torch.empty_like(x)

                def call():
                    rc = lib.gps_scan_tiled_variant(v, x.data_ptr(), out.data_ptr(), scratch.data_ptr(), nbytes.value,
                                                    n, batch, int(reverse), _build.stream(device), None)
                    if rc != 0:
                        raise RuntimeError(lib.gps_error_string(rc).decode())
                    return out

                key = "GridOf" if v == 0 else f"{w}/{i}/{s}"  # variant 0: the shape the combine launches
                try:
                    call()
                    torch.cuda.synchronize()
                except RuntimeError as e:
                    row[key] = {"error": str(e)}
                    continue
                err = chip_smoke.rel_err(out.reshape(-1, n), want.reshape(-1, n))
                row[key] = {"rel_err": err, "ok": err <= chip_smoke.TOL["float64"], "device_ms": chip_smoke.device_ms(call)}
            entry["shapes"][label] = row
            print(json.dumps({op: {label: row}}), flush=True)
            del x, want
            torch.cuda.empty_cache()
        result["sweep"][op] = entry
    line = json.dumps(result)
    print(line, flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")


if __name__ == "__main__":
    main()
