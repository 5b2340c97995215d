#!/usr/bin/env python3
"""Phase 9 (a) and (d) of ``chip_smoke.py`` over every card of a machine
with two or more NVIDIA GPUs, each beside the same run on one card.

Prints the cards' names and power limits, then one JSON line a run
(``chip_smoke.seqpar_case`` and ``chip_smoke.mesh_shards``):

* ``fuse_ekf_rts_seqparallel`` on 4 blocks of 1,048,576 float64 poses
  (phase 5's outage sequence, the EKF inputs from one ``fuse_core``), both
  ``rts_mode``s, on one card, then block k on card k mod the card count,
  then on one card again: the gaps to the single-device filter (≤1e-8 m),
  the launches, warm walls of the blocks' stage programs replayed and of
  the same under ``graphs.eager()`` (≤1e-9 m apart), profiles and each
  card's peak memory;
* ``fuse_batch(mesh=...)`` of the eleven KITTI rows on 3 shards, on one
  card, then shard k on card k mod the card count, then on one card again:
  the rows against the unsharded batch (≤1e-9 m) and the walls of the
  unsharded batch, the threaded shards (each shard's program replayed on
  its card, and eager) and the shards in turn;
* the captures, replays and pools of the captured programs
  (``utils.graphs``).

It fails if a check fails, and exits 1 on a machine with fewer than two
cards. Run from the repository root:

    PYTHONPATH=. python3 tools/torch_phase9_cards.py
"""

import subprocess
import sys
import time

import torch

import chip_smoke as cs
from gps_optimize_slam_tpu_torch.config import FusionConfig
from gps_optimize_slam_tpu_torch.ops import _build
from gps_optimize_slam_tpu_torch.parallel import batch as pbatch


def main() -> int:
    if torch.cuda.device_count() < 2:
        print("torch_phase9_cards: needs two CUDA devices or more", file=sys.stderr)
        return 1
    _build.library()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout, flush=True)
    device = torch.device("cuda")
    cfg = FusionConfig()
    expect = {f"scan_{route}/{op}": n for op in ("quat_chain", "filter", "rts", "max3", "min3")
              for route, n in (("tiled", cs.SEQPAR_BLOCKS), ("block", 1))}
    t0 = time.perf_counter()
    slam, gt, gp = cs.outage_sequence(cs.CHUNKED_N)
    args = cs.ekf_inputs(slam, gt, gp, torch.float64, device) + (cfg.ekf, cfg.rts_decision)
    for label, mesh in (("seqpar float64, one card", cs.card_mesh(cs.SEQPAR_BLOCKS)),
                        ("seqpar float64 over the cards", cs.cards_mesh(cs.SEQPAR_BLOCKS)),
                        ("seqpar float64, one card again", cs.card_mesh(cs.SEQPAR_BLOCKS))):
        cs.seqpar_case(label, args, 1e-8, 1e-10, ("outage", "full"), expect, mesh=mesh)
    del args
    torch.cuda.empty_cache()
    seqs = cs.kitti_sequences()
    b = pbatch.pad_batch([s for s, _, _, _ in seqs], [t for _, t, _, _ in seqs], [p for _, _, p, _ in seqs])
    seeds = list(range(len(seqs)))
    for label, mesh in (("mesh shards, one card", cs.card_mesh(cs.MESH_SHARDS)),
                        ("mesh shards over the cards", cs.cards_mesh(cs.MESH_SHARDS)),
                        ("mesh shards, one card again", cs.card_mesh(cs.MESH_SHARDS))):
        cs.mesh_shards(device, b, seeds, mesh, label)
    cs.emit({"graphs": cs.graph_stats()})
    print(f"seconds {time.perf_counter() - t0:.1f}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
