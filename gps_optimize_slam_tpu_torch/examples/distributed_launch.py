"""Multi-process batched fusion on ``torch.distributed``.

Launcher role (the default): starts ``--nproc`` worker processes on this
machine, joined into one process group over a ``tcp://localhost`` rendezvous,
waits for each with its own timeout, and fails if one fails. Each worker's
output goes to a file in ``--log-dir`` (not a pipe: a worker that fills an
undrained pipe blocks while another is being read).

Worker role (``--worker COORD NPROC PID``): joins the group, fuses its
contiguous shard of the batch's rows (``parallel.distributed``), gathers every
rank's rows, prints a ``timing`` JSON line (the fusion's wall, first call
included, and ``utils.profiling.wallclock`` of the gather), and rank 0 prints
the scales and, with ``--out``, saves the gathered outputs to an ``.npz``.
The batch is ``--batch`` (an ``.npz`` from ``save_batch``) or six synthetic
sequences.

    python -m gps_optimize_slam_tpu_torch.examples.distributed_launch \\
        [--nproc 2] [--backend gloo|nccl] [--device DEV] [--batch IN.npz] [--out OUT.npz]

``--device cpu`` with gloo runs on the CPU. On one card: ``--device cuda:0
--backend gloo`` (NCCL refuses two ranks on one card), or one rank with
NCCL. On a host with a card a rank: no ``--device`` (rank r takes card r)
and NCCL, the default for CUDA ranks. On several hosts run the worker role
once a rank with the first host's address.
"""

import argparse
import json
import os
import socket
import subprocess
import sys
import tempfile
import time

import numpy as np

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def save_batch(path: str, batch, seeds) -> None:
    """A ``SequenceBatch`` and its rows' seeds, as ``--batch`` reads them."""
    np.savez(path, seeds=np.asarray(seeds), **batch._asdict())


def load_batch(path: str):
    from gps_optimize_slam_tpu_torch.parallel.batch import SequenceBatch

    with np.load(path) as f:
        return SequenceBatch(**{k: f[k] for k in SequenceBatch._fields}), f["seeds"]


def save_outputs(path: str, out) -> None:
    """Gathered ``FusionOutputs`` of host arrays, the Sim(3) leaves as
    ``sim3_<name>``."""
    leaves = {k: v for k, v in out._asdict().items() if k != "sim3"}
    leaves.update({f"sim3_{k}": v for k, v in out.sim3._asdict().items()})
    np.savez(path, **leaves)


def synthetic_batch():
    from gps_optimize_slam_tpu_torch.examples.batch_mesh_fusion import synthetic_sequence
    from gps_optimize_slam_tpu_torch.parallel import batch as pbatch

    seqs = [synthetic_sequence(120 + 8 * i, seed=i) for i in range(6)]
    return pbatch.pad_batch([s for s, _, _ in seqs], [t for _, t, _ in seqs], [p for _, _, p in seqs]), np.arange(6)


def worker(args) -> None:
    import torch.distributed as tdist

    from gps_optimize_slam_tpu_torch.parallel import distributed as dist
    from gps_optimize_slam_tpu_torch.utils import profiling

    coord, nproc, pid = args.worker[0], int(args.worker[1]), int(args.worker[2])
    device = dist.initialize(coord, nproc, pid, backend=args.backend, device=args.device, timeout_s=args.timeout)
    try:
        batch, seeds = load_batch(args.batch) if args.batch else synthetic_batch()
        t0 = time.perf_counter()
        out, n_real = dist.fuse_batch_distributed(batch, seeds)
        profiling.synchronize(out)
        fuse_s = time.perf_counter() - t0
        gather = profiling.wallclock(dist.gather_outputs, out, n_real, runs=3)
        gathered = dist.gather_outputs(out, n_real=n_real)
        mesh = dist.global_mesh()
        print(f"rank {pid} on {device}: fused {out.corrected_pos.shape[0]} rows", flush=True)
        print("timing " + json.dumps({"rank": pid, "fuse_s": fuse_s, "gather": gather}), flush=True)
        if pid == 0:
            print(f"{tdist.get_backend()} group of {nproc} ranks on {[str(d) for d in mesh.devices]}: "
                  f"{n_real} sequences, scales {np.round(gathered.sim3.scale, 4).tolist()}", flush=True)
            if args.out:
                save_outputs(args.out, gathered)
    finally:
        tdist.destroy_process_group()


def launch(args) -> None:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        coord = f"127.0.0.1:{s.getsockname()[1]}"
    log_dir = args.log_dir or tempfile.mkdtemp(prefix="distributed_launch_")
    os.makedirs(log_dir, exist_ok=True)
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(filter(None, [_ROOT, os.environ.get("PYTHONPATH")]))}
    passed = [f"--{k}={v}" for k, v in (("backend", args.backend), ("device", args.device), ("batch", args.batch),
                                         ("out", args.out), ("timeout", args.timeout)) if v is not None]
    logs = [os.path.join(log_dir, f"rank{pid}.log") for pid in range(args.nproc)]
    handles = [open(log, "w") for log in logs]
    procs = []
    try:
        for pid, handle in enumerate(handles):
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "gps_optimize_slam_tpu_torch.examples.distributed_launch",
                 "--worker", coord, str(args.nproc), str(pid), *passed],
                stdout=handle, stderr=subprocess.STDOUT, env=env, cwd=_ROOT,
            ))
        for p in procs:
            try:
                p.wait(timeout=args.timeout)
            except subprocess.TimeoutExpired:
                pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for handle in handles:
            handle.close()
    for pid, (p, log) in enumerate(zip(procs, logs)):
        with open(log) as f:
            text = f.read()
        print(text, end="")
        if p.returncode != 0:
            raise RuntimeError(f"rank {pid} exited with {p.returncode} (log {log}):\n{text[-4000:]}")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--worker", nargs=3, metavar=("COORD", "NPROC", "PID"), help="run as one rank")
    ap.add_argument("--nproc", type=int, default=2, help="ranks the launcher starts")
    ap.add_argument("--backend", choices=["gloo", "nccl"], default=None,
                    help="nccl for CUDA ranks and gloo for CPU ones by default")
    ap.add_argument("--device", default=None, help="every rank's device (rank r takes card r by default)")
    ap.add_argument("--batch", help="an .npz written by save_batch (default: six synthetic sequences)")
    ap.add_argument("--out", help="rank 0 saves the gathered outputs here (.npz)")
    ap.add_argument("--log-dir", help="the launcher writes each rank's output here")
    ap.add_argument("--timeout", type=int, default=600, help="seconds each rank may take")
    args = ap.parse_args(argv)
    if args.worker:
        worker(args)
    else:
        launch(args)


if __name__ == "__main__":
    main()
