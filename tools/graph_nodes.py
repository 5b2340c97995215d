"""The kernel nodes of the programs the benchmark's cells capture, counted
from the graphs themselves, for a checkout: with the tracer off, a parent
checkout and this one should hold the same nodes.

    PYTHONPATH=. python3 tools/graph_nodes.py --root build/parent --out build/nodes_parent.json
    PYTHONPATH=. python3 tools/graph_nodes.py --root . --out build/nodes_this.json

On the card: imports the port and ``portbench`` from ``--root``, sends two
requests of ``batch-kitti22`` (the second captures its bucket programs) and
one of ``refine-kitti00`` (its second Gauss-Newton step captures the step)
with every graph kept (``torch.cuda.CUDAGraph(keep_graph=True)``), and
counts each held program's kernel nodes with this checkout's library
(``gps_graph_kernel_nodes``, child graphs counted through). Prints one JSON
object: ``{function name: [[input shapes, kernel nodes], ...]}``; with
``--per-request`` also the kernel nodes a request replays, each program's
nodes times its replays in one more request of each cell.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def this_library():
    """This checkout's kernel library, whatever checkout the port is
    imported from."""
    spec = importlib.util.spec_from_file_location(
        "graph_nodes_build", os.path.join(HERE, "gps_optimize_slam_tpu_torch", "ops", "_build.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.library()


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--per-request", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)

    import torch

    from gps_optimize_slam_tpu_torch.utils import graphs
    from portbench import harness

    assert os.path.abspath(graphs.__file__).startswith(os.path.join(root, "")), graphs.__file__
    lib = this_library()
    real = torch.cuda.CUDAGraph
    torch.cuda.CUDAGraph = lambda: real(keep_graph=True)
    device = torch.device("cuda", 0)

    def flow(name):
        cell = harness.cell(name)
        return harness.flow_class(cell["flow"])(cell, harness.config(cell["config"]), args.seed, [device],
                                               harness.Spans())

    batch, refine = flow("batch-kitti22"), flow("refine-kitti00")
    batch.request(0)
    batch.request(1)
    refine.request(0)
    torch.cuda.synchronize()
    programs = graphs._DEVICES[device].programs
    nodes = {}
    for key, program in programs.items():
        shapes = [list(s[0]) for s in key[3]]
        count = int(lib.gps_graph_kernel_nodes(program.graph.raw_cuda_graph()))
        nodes.setdefault(key[0].__name__, []).append([shapes, count])
    out = {"root": root, "nodes": {k: sorted(v) for k, v in sorted(nodes.items())}}
    if args.per_request:
        for name, fl in (("batch-kitti22", batch), ("refine-kitti00", refine)):
            replays = {}
            real_replay = graphs._replay

            def counting(dev, program, tensors, replays=replays, real_replay=real_replay):
                replays[id(program)] = replays.get(id(program), 0) + 1
                return real_replay(dev, program, tensors)

            graphs._replay = counting
            fl.request(2)
            graphs._replay = real_replay
            torch.cuda.synchronize()
            out.setdefault("per_request", {})[name] = sum(
                n * int(lib.gps_graph_kernel_nodes(p.graph.raw_cuda_graph()))
                for p in graphs._DEVICES[device].programs.values() for pid, n in replays.items() if pid == id(p))
    text = json.dumps(out)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(text)
    print(text, flush=True)


if __name__ == "__main__":
    main()
