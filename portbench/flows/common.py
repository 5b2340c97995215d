"""What every flow shares: the cell's requests from the seed, the program's
configuration from the configuration's file, the launch counters."""

from __future__ import annotations

import torch

from portbench import checks, harness
from portbench.traffic import generate

# A launch counter's key where it is not the wrapper's name.
COUNTER_KEYS = {"keep_lists": "nn_keep"}


class FlowBase:
    """A flow over the requests of a cell: ``variants`` requests made from
    the seed, sent in turn (request k is variant k mod ``variants``).

    ``cell["traffic_params"]``, where given, replaces the mix's file (the
    CPU tests put the cell's ``small`` mix there)."""

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

    def warm(self, work: list, metrics=()) -> None:
        """Every shape of the cell's requests: a first call (eager, the
        calls that ``metrics``' records name written to ``work``), a second
        (captured) and a third (replayed)."""
        with harness.recording(work, metrics):
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
        """Every launch counter (a ``launches`` attribute) of the kernel
        wrappers of the port's ``ops.kernels`` and ``ops.scan``: a counter by
        combine as ``<wrapper>/<op>`` where not 0, any other as ``<wrapper>``
        (the keep lists' as ``nn_keep``)."""
        from gps_optimize_slam_tpu_torch.ops import kernels, scan

        counts = {}
        for module in (kernels, scan):
            for name, fn in vars(module).items():
                launches = getattr(fn, "launches", None)
                if launches is None or not callable(fn) or fn.__module__ != module.__name__:
                    continue
                key = COUNTER_KEYS.get(name, name)
                if isinstance(launches, dict):
                    counts.update({f"{key}/{op}": c for op, c in launches.items() if c})
                else:
                    counts[key] = launches
        return counts


def program_drive(rows: dict, n: int = None) -> dict:
    """A drive's program outputs (host arrays of ``FusionOutputs`` leaves)
    in the layout of ``portbench.checks``, cut to its ``n`` real poses."""
    cut = slice(None) if n is None else slice(0, n)
    return {"aligned": rows["aligned_gps"][cut], "valid": rows["gps_valid"][cut],
            "inliers": rows["sim3_inliers"][cut], "sim3_pos": rows["sim3_pos"][cut],
            "pos": rows["corrected_pos"][cut], "quat": rows["corrected_quat"][cut]}
