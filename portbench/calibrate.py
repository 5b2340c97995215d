"""The readings a cell's limits are set from, at the cell's own sizes:

    python3 -m portbench.calibrate --workload <cell> --seeds S1 S2 ... --control-seeds C1 C2 C3 [--out F.json]

For each of ``--seeds``, the requests made from that seed, the program's
outputs of the request a run of that seed compares (its timed path, warm),
and each number of ``portbench.checks`` against the float64 reference: the
lower readings. For each of ``--control-seeds``, the control: the
reference computed in float32 put in the program's place, against the
float64 reference: the upper readings. One JSON line a seed, and the
largest program reading and smallest control reading of each number last.
The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    import torch

    from portbench import harness

    cell = harness.cell(args.workload)
    cfg = harness.config(cell["config"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < int(cfg["chips"]):
        sys.exit("portbench.calibrate: not enough CUDA devices for the cell")
    devices = [torch.device("cuda", i) for i in range(int(cfg["chips"]))]
    Flow = harness.flow_class(cell["flow"])
    lines, warm = [], True
    for kind, seeds in (("program", args.seeds), ("control", args.control_seeds)):
        for seed in seeds:
            t0 = time.perf_counter()
            flow = Flow(cell, cfg, seed, devices, harness.Spans())
            pick = int(np.random.default_rng([int(seed), 17]).integers(0, flow.variants))
            if kind == "program":
                if warm:
                    flow.warm([])
                    warm = False
                kept = flow.keep(pick, flow.request(pick))
            else:
                kept = flow.control(pick, torch.float32)
            t1 = time.perf_counter()
            readings = flow.check(kept, torch.float64)
            line = {"kind": kind, "seed": seed, "readings": readings, "run_s": t1 - t0,
                    "check_s": time.perf_counter() - t1}
            print(json.dumps(line), flush=True)
            lines.append(line)
            del flow, kept
    summary = {}
    for kind, pick in (("program", max), ("control", min)):
        rs = [ln["readings"] for ln in lines if ln["kind"] == kind]
        if rs:
            summary[kind] = {k: pick(r[k] for r in rs) for k in rs[0]}
    print(json.dumps({"summary": summary, "device": torch.cuda.get_device_name(devices[0])}), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"lines": lines, "summary": summary}, f, indent=1)


if __name__ == "__main__":
    main()
