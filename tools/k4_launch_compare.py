#!/usr/bin/env python3
"""K4's launch (``csrc/nn_grid.cu``) of one checkout of the port, timed on
one NVIDIA GPU, to compare two checkouts in one run.

Imports ``gps_optimize_slam_tpu_torch`` from ``--root`` (a checkout's root;
the kernels build into its own ``build/kernels``) and, at the shapes where
``chip_smoke.py`` times K4 (524,288 queries against 524,288 candidates on a
coherent random walk; 700 queries against 524,288 shuffled candidates; a
batch of 4 such rows), in float64 and float32, prints one JSON line with:

* ``call_ms``: ``kernels.nn_grid``, the whole call (keep lists, the work
  list, any host read, the launch);
* ``launch_ms``: ``kernels.grid_launch`` alone on operands made beforehand,
  as that checkout's ``nn_grid`` calls it. A launch whose signature needs
  the work list's length is given it, read on the host before the clock
  (``launch`` says which: ``host_count`` or ``device_count``);
* ``k3_ms``: K3 (``kernels.nn_resident``) on the same inputs, and whether
  K4's output equals K3's bit for bit (``equal_to_k3``).

Each time is the median of 10 CUDA-event-timed calls after a warm-up. The
data is made from ``--seed`` alike for every checkout. Run from the
repository root, a parent checkout unpacked under ``build/``, the two in
turns:

    python3 tools/k4_launch_compare.py --root build/parent
    python3 tools/k4_launch_compare.py --root .
"""

import argparse
import inspect
import json
import os
import sys

CHUNK = 524_288
SHAPES = (("524288x524288", None, CHUNK, CHUNK, False), ("700x524288_shuffled", None, 700, CHUNK, True),
          ("4x700x524288_shuffled", 4, 700, CHUNK, True))


def cuda_ms(fn, reps: int = 10) -> float:
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
    times.sort()
    return times[len(times) // 2]


def inputs(seed: int, batch, n: int, m: int, shuffled: bool, dtype, device):
    """Queries, candidates and the candidates' mask: random walks (steps of
    0.8 m, candidates 0.3 m off), 10 % of the candidates masked."""
    import torch

    gen = torch.Generator().manual_seed(seed)
    rows = []
    for _ in range(batch or 1):
        traj = torch.cumsum(0.8 * torch.randn(n, 3, generator=gen, dtype=torch.float64), 0)
        cand = torch.cumsum(0.8 * torch.randn(m, 3, generator=gen, dtype=torch.float64), 0) + 0.3
        if shuffled:
            cand = cand[torch.randperm(m, generator=gen)]
        rows.append((traj, cand, torch.rand(m, generator=gen) > 0.1))
    traj, cand, mask = (torch.stack(x) if batch else x[0] for x in zip(*rows))
    return (traj.to(dtype=dtype, device=device).contiguous(), cand.to(dtype=dtype, device=device).contiguous(),
            mask.to(device))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=".", help="the checkout whose port to time")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch

    from gps_optimize_slam_tpu_torch.ops import kernels

    if not torch.cuda.is_available():
        raise SystemExit("k4_launch_compare: no CUDA device")
    if not kernels.__file__.startswith(root + os.sep):
        raise SystemExit(f"k4_launch_compare: imported {kernels.__file__}, not the checkout at {root}")
    device = torch.device("cuda")
    # A third parameter with no default is the length read on the host.
    third = list(inspect.signature(kernels.grid_launch).parameters.values())[2]
    host_count = third.default is inspect.Parameter.empty
    out = {"root": args.root, "launch": "host_count" if host_count else "device_count", "cases": {}}
    for label, batch, n, m, shuffled in SHAPES:
        for dtype in (torch.float64, torch.float32):
            traj, cand, mask = inputs(args.seed, batch, n, m, shuffled, dtype, device)
            operands = kernels.nn_grid_operands(traj, cand, mask)
            extra = (int(operands[3].reshape(-1)[-1]),) if host_count else ()
            got = kernels.grid_launch(traj, operands, *extra)
            k3 = kernels.nn_resident(traj, cand, mask)
            torch.cuda.synchronize()
            out["cases"][f"{label}/{str(dtype).split('.')[1]}"] = {
                "call_ms": cuda_ms(lambda: kernels.nn_grid(traj, cand, mask)),
                "launch_ms": cuda_ms(lambda: kernels.grid_launch(traj, operands, *extra)),
                "k3_ms": cuda_ms(lambda: kernels.nn_resident(traj, cand, mask)),
                "equal_to_k3": bool(torch.equal(got, k3)),
                "items": int(operands[3].reshape(-1)[-1]),
            }
            del traj, cand, mask, operands, got, k3
            torch.cuda.empty_cache()
    print(json.dumps(out), flush=True)
    if not all(c["equal_to_k3"] for c in out["cases"].values()):
        raise SystemExit("k4_launch_compare: K4 differs from K3")


if __name__ == "__main__":
    main()
