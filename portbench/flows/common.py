"""What every flow shares: the cell's requests from the seed, the program's
configuration from the configuration's file, the launch counters."""

from __future__ import annotations

import torch

from portbench import checks, harness
from portbench.traffic import generate


class FlowBase:
    """A flow over the requests of a cell: ``variants`` requests made from
    the seed, sent in turn (request k is variant k mod ``variants``).

    ``cell["traffic_params"]``, where given, replaces the mix's file (the
    tests' small requests)."""

    def __init__(self, cell: dict, cfg: dict, seed: int, devices: list, spans):
        from gps_optimize_slam_tpu_torch.config import config_from_dict

        self.cell, self.cfg, self.devices, self.spans = cell, cfg, devices, spans
        self.device = devices[0]
        self.traffic = cell.get("traffic_params") or generate.load(cell["traffic"])
        self.requests = generate.requests(self.traffic, seed)
        self.variants = len(self.requests)
        self.dtype = getattr(torch, cfg["dtype"])
        self.fusion_config = config_from_dict(cfg["fusion"])

    def poses(self, k: int) -> int:
        return generate.real_poses(self.requests[k % self.variants])

    def warm(self, work: list) -> None:
        """Every shape of the cell's requests: a first call (eager, its work
        recorded), a second (captured) and a third (replayed)."""
        with harness.recording(work):
            self.request(0)
        for k in range(1, 3):
            self.request(k)

    def padding(self):
        return None

    def check(self, kept, dtype) -> dict:
        """The numbers of ``portbench.checks`` for a kept request: each
        drive's outputs against the reference computed in ``dtype``."""
        v, rows = kept
        drives = self.requests[v][0]
        gaps, missing = [], abs(len(drives) - len(rows))
        for row, (slam, gt, gp) in zip(rows, drives):
            if row is None or len(row["pos"]) != len(slam["timestamps"]):
                missing += 1
                continue
            gaps.append(checks.drive_gaps(row, checks.reference_drive(slam, gt, gp, self.cfg, dtype)))
        if not gaps:
            return {"drives_diff": missing}
        return checks.worst(gaps, missing)

    def control(self, v: int, dtype):
        """The reference computed in ``dtype``, put in the program's place:
        a kept request of variant ``v``."""
        return v, [checks.reference_drive(s, gt, gp, self.cfg, dtype)
                   for s, gt, gp in self.requests[v][0]]

    def close(self) -> None:
        from gps_optimize_slam_tpu_torch.utils import graphs

        graphs.clear()

    @staticmethod
    def launch_counts() -> dict:
        from gps_optimize_slam_tpu_torch.ops import kernels, scan

        counts = {f"scan_block/{op}": c for op, c in scan.scan_block.launches.items() if c}
        counts.update({f"scan_tiled/{op}": c for op, c in scan.scan_tiled.launches.items() if c})
        counts.update(nn_keep=kernels.keep_lists.launches, nn_resident=kernels.nn_resident.launches,
                      nn_grid=kernels.nn_grid.launches, ransac_counts=kernels.ransac_counts.launches)
        return counts


def program_drive(rows: dict, n: int = None) -> dict:
    """A drive's program outputs (host arrays of ``FusionOutputs`` leaves)
    in the layout of ``portbench.checks``, cut to its ``n`` real poses."""
    cut = slice(None) if n is None else slice(0, n)
    return {"aligned": rows["aligned_gps"][cut], "valid": rows["gps_valid"][cut],
            "inliers": rows["sim3_inliers"][cut], "sim3_pos": rows["sim3_pos"][cut],
            "pos": rows["corrected_pos"][cut], "quat": rows["corrected_quat"][cut]}
