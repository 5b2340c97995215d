#!/usr/bin/env python3
"""K3 and K4, the NN kernels (``csrc/nn.cu``, ``csrc/nn_grid.cu``), of one
checkout of the port, timed on one NVIDIA GPU, to compare two checkouts in
one run.

Imports ``gps_optimize_slam_tpu_torch`` from ``--root`` (a checkout's root;
the kernels build into its own ``build/kernels``) and, at the shapes where
``chip_smoke.py`` times them, prints one JSON line with, per shape and
dtype:

* ``k3_ms`` and ``k4_ms``: ``kernels.nn_resident`` and ``kernels.nn_grid``,
  the whole calls (keep lists, the work list, the launch), CUDA-event
  medians of 10 calls after a warm-up;
* ``k3_device_ms`` and ``k4_device_ms``: the NN kernel alone, a launch's
  device time from a ``torch.profiler`` trace of 10 calls
  (``chip_smoke.launch_device_ms`` on ``nn_kernel`` and
  ``nn_grid_kernel``; the keep lists left out);
* ``equal_to_k3``: whether K4's output equals K3's bit for bit;
* where the checkout has ``kernels.resident_launch``, ``k3_device_ms_by_block``:
  K3's launch alone at each of its block sizes, and the one it picks.

Also ``sass``: what the checkout's library runs for a (query, candidate)
pair (``chip_smoke.sass_tile_loops`` of this tool's own checkout, read on
the other's library), and the NN kernels' registers and spill bytes from
``-Xptxas -v`` (where the library was built in this run). The shapes: phase 1's ``long_logs`` (four ragged
float64 rows of 524,288 / 458,752 / 393,216 / 300,000 random-walk poses,
the last row all masked) and ``win`` (4 x 700 queries against 524,288
shuffled candidates, float64), the fleet bucket (64 x 4,661, float32),
and single rows of 4,661 (float32) and 524,288 (float32 and float64)
poses. The data is made from ``--seed`` alike for every checkout. Run from
the repository root, a parent checkout unpacked under ``build/``, in turns:

    python3 tools/nn_launch_compare.py --root build/parent
    python3 tools/nn_launch_compare.py --root .
"""

import argparse
import importlib.util
import json
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHUNK = 524_288
LONG_LOGS = (CHUNK, 458_752, 393_216, 300_000)
FLEET = (64, 4661)


def load_chip_smoke():
    """This checkout's ``chip_smoke.py`` (its timers, inputs and SASS
    reader), whatever ``--root`` holds."""
    spec = importlib.util.spec_from_file_location("chip_smoke_of_this_tool", os.path.join(HERE, "chip_smoke.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def cases(cs, seed: int, device):
    """(label, traj, cand, mask) of every shape, made from ``seed``."""
    import torch

    gen = torch.Generator().manual_seed(seed)
    f32, f64 = torch.float32, torch.float64
    yield ("long_logs/float64", *cs.ragged_walks(gen, LONG_LOGS, LONG_LOGS, f64, device))
    B, n, m = 4, 700, CHUNK
    traj = torch.stack([cs.walk(gen, n, f64, device) for _ in range(B)])
    cand = torch.stack([(cs.walk(gen, m, f64, device) + 0.3)[torch.randperm(m, generator=gen).to(device)]
                        for _ in range(B)]).contiguous()
    mask = (torch.rand(B, m, generator=gen) > 0.1).to(device)
    mask[2] = False
    yield "win/float64", traj, cand, mask
    yield ("fleet/float32", *cs.ragged_walks(gen, (FLEET[1],) * FLEET[0], (FLEET[1],) * FLEET[0], f32, device))
    for n, dtype in ((FLEET[1], f32), (CHUNK, f32), (CHUNK, f64)):
        traj, cand, mask = cs.ragged_walks(gen, (n,), (n,), dtype, device)
        yield f"{n}x{n}/{str(dtype).split('.')[1]}", traj[0], cand[0], mask[0]


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
        raise SystemExit("nn_launch_compare: no CUDA device")
    if not kernels.__file__.startswith(root + os.sep):
        raise SystemExit(f"nn_launch_compare: imported {kernels.__file__}, not the checkout at {root}")
    device = torch.device("cuda")
    _build.library()
    registers = cs.build_registers(_build.BUILD_INFO["log"])
    out = {"root": args.root, "sass": cs.sass_tile_loops(_build.BUILD_INFO["path"]),
           "registers_and_spills": {k: v for k, v in registers.items() if "nn_" in k}, "cases": {}}

    def kernel_ms(fn, name):
        return cs.launch_device_ms(fn, name)[0]

    for label, traj, cand, mask in cases(cs, args.seed, device):
        k3 = kernels.nn_resident(traj, cand, mask)
        k4 = kernels.nn_grid(traj, cand, mask)
        torch.cuda.synchronize()
        res = {"k3_ms": cs.cuda_ms(lambda: kernels.nn_resident(traj, cand, mask)),
               "k3_device_ms": kernel_ms(lambda: kernels.nn_resident(traj, cand, mask), "nn_kernel"),
               "k4_ms": cs.cuda_ms(lambda: kernels.nn_grid(traj, cand, mask)),
               "k4_device_ms": kernel_ms(lambda: kernels.nn_grid(traj, cand, mask), "nn_grid_kernel"),
               "equal_to_k3": bool(torch.equal(k3, k4))}
        if hasattr(kernels, "resident_launch"):
            operands = kernels.keep_lists(traj, cand, mask)
            tiles = (traj.shape[0] if traj.ndim == 3 else 1) * operands[0].shape[-2]
            res["k3_block_picked"] = kernels.resident_block(tiles)
            res["k3_device_ms_by_block"] = {
                str(b): kernel_ms(lambda: kernels.resident_launch(traj, operands, b), "nn_kernel")
                for b in kernels.RESIDENT_BLOCKS}
            del operands
        out["cases"][label] = res
        del traj, cand, mask, k3, k4
        torch.cuda.empty_cache()
    print(json.dumps(out), flush=True)
    if not all(c["equal_to_k3"] for c in out["cases"].values()):
        raise SystemExit("nn_launch_compare: K4 differs from K3")


if __name__ == "__main__":
    main()
