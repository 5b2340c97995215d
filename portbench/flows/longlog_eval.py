"""Every log of a dataset fused and evaluated in one request:
``parallel.mesh.stage_batch`` → ``fuse_batch`` on the staged batch →
``evaluate_batch`` on the staged batch and the fusion's outputs → the fused
trajectories (what the ``fuse-batch`` command exports) and every statistic of
the error report on the host, through ``utils.streaming.fetch``. Four host
spans: ``stage``, ``fuse``, ``evaluate``, ``fetch``. Each variant's padded
batch is built once, at set-up: the logs are the request's input files.

The comparison takes every log: the fusion's numbers of ``portbench.checks``
and the error report against ``portbench.reference.evaluation`` on the
reference's own fusion: ``eval_m``, the largest gap of any statistic
(metres), and ``eval_count_diff``, the gated poses counted on one side
only, summed over a log's five evaluations.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench import checks
from portbench.flows.common import FlowBase, program_drive
from portbench.reference import evaluation as ref_eval

FETCHED = ("corrected_pos", "corrected_quat")
KEPT = ("aligned_gps", "gps_valid", "sim3_inliers", "sim3_pos")


def np_dtype(dtype):
    return np.float64 if dtype == torch.float64 else np.float32


def eval_gaps(got: dict, want: dict) -> dict:
    """``eval_m`` and ``eval_count_diff`` of one log's error reports
    (``{evaluation: {stat: value}}``); equal values, infinities included,
    have no gap, and a NaN gap is no agreement."""
    gap, counts = 0.0, 0
    for name in ref_eval.EVALUATIONS:
        for stat in ref_eval.STATS:
            a, b = float(got[name][stat]), float(want[name][stat])
            if stat == "count":
                counts += abs(int(a) - int(b))
            elif a != b:
                d = abs(a - b)
                gap = max(gap, d if d == d else float("inf"))
    return {"eval_m": gap, "eval_count_diff": counts}


class Flow(FlowBase):
    def __init__(self, *args):
        super().__init__(*args)
        from gps_optimize_slam_tpu_torch.parallel import batch as pbatch

        self.batches = [pbatch.pad_batch([d[0] for d in drives], [d[1] for d in drives], [d[2] for d in drives])
                        for drives, _ in self.requests]

    def request(self, k: int):
        from gps_optimize_slam_tpu_torch.parallel import mesh
        from gps_optimize_slam_tpu_torch.utils import streaming

        v = k % self.variants
        with self.spans("stage"):
            staged = mesh.stage_batch(self.batches[v], self.requests[v][1], device=self.device, dtype=self.dtype)
        with self.spans("fuse"):
            out = mesh.fuse_batch(staged, config=self.fusion_config)
        with self.spans("evaluate"):
            ev = mesh.evaluate_batch(staged, out)
        with self.spans("fetch"):
            report = [getattr(getattr(ev, name), stat) for name in ref_eval.EVALUATIONS for stat in ref_eval.STATS]
            host = streaming.fetch([getattr(out, name) for name in FETCHED] + report).numpy()
        return {"host": host, "device": {name: getattr(out, name) for name in KEPT}}

    def keep(self, k: int, out):
        """The request's rows on the host: the fetched trajectories and
        report, and the leaves the comparison needs beside them fetched from
        the request's own device outputs, each log cut to its real poses."""
        from gps_optimize_slam_tpu_torch.utils import streaming

        v = k % self.variants
        leaves = dict(zip(FETCHED, out["host"][: len(FETCHED)]))
        leaves.update(zip(KEPT, streaming.fetch([out["device"][name] for name in KEPT]).numpy()))
        report = out["host"][len(FETCHED):]
        rows = []
        for i in range(leaves["corrected_pos"].shape[0]):
            n = int(self.batches[v].n_slam[i])
            row = program_drive({name: np.array(x[i, :n]) for name, x in leaves.items()})
            stats = iter(report)
            row["eval"] = {name: {stat: next(stats)[i].item() for stat in ref_eval.STATS}
                           for name in ref_eval.EVALUATIONS}
            rows.append(row)
        return v, rows

    def check(self, kept, dtype) -> dict:
        v, rows = kept
        drives = self.requests[v][0]
        gaps, missing = [], abs(len(drives) - len(rows))
        for row, (slam, gt, gp) in zip(rows, drives):
            if len(row["pos"]) != len(slam["timestamps"]):
                missing += 1
                continue
            want = checks.reference_drive(slam, gt, gp, self.cfg, dtype)
            gap = checks.drive_gaps(row, want)
            gap.update(eval_gaps(row["eval"], ref_eval.evaluate(slam, want, np_dtype(dtype))))
            gaps.append(gap)
        if not gaps:
            return {"drives_diff": missing}
        return checks.worst(gaps, missing)

    def control(self, v: int, dtype):
        rows = []
        for slam, gt, gp in self.requests[v][0]:
            want = checks.reference_drive(slam, gt, gp, self.cfg, dtype)
            rows.append({**want, "eval": ref_eval.evaluate(slam, want, np_dtype(dtype))})
        return v, rows
