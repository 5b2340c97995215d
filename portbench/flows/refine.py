"""One drive refined by a pose graph in one request: ``pipeline.fuse_arrays``
→ ``pipeline.refine_pose_graph`` with the ``refine-graph`` command's
settings (the configuration's ``refine``) → the refined poses, the cost
history, the proposed closures and the fusion's outputs on the host."""

from __future__ import annotations

import numpy as np

from portbench import checks
from portbench.flows.common import FlowBase, program_drive
from portbench.reference import pose_graph as ref_pg

FUSION_LEAVES = ("corrected_pos", "corrected_quat", "sim3_pos", "sim3_quat", "sim3_inliers", "aligned_gps",
                 "gps_valid")


class Flow(FlowBase):
    def __init__(self, *args):
        super().__init__(*args)
        from gps_optimize_slam_tpu_torch import pipeline

        self.gps = [pipeline.GPSData(timestamps=gt, positions=gp, valid=np.ones(len(gt), bool), frame="enu",
                                     utm_zone=32, utm_south=False) for (((_, gt, gp),), _) in self.requests]
        r = self.cfg["refine"]
        self.refine_args = dict(iterations=r["iterations"], cg_iters=r["cg_iters"], damping=r["damping"],
                                propose_loops=r["propose_loops"], loop_radius=r["loop_radius"],
                                loop_min_time_gap=r["loop_min_time_gap"], max_loops=r["max_loops"], **r["weights"])

    def request(self, k: int):
        from gps_optimize_slam_tpu_torch import pipeline

        v = k % self.variants
        (slam, _, _), = self.requests[v][0]
        with self.spans("fuse"):
            res = pipeline.fuse_arrays(slam, self.gps[v], config=self.fusion_config, seed=self.requests[v][1][0],
                                       dtype=self.dtype, device=self.device)
        with self.spans("refine"):
            gn, info = pipeline.refine_pose_graph(res, **self.refine_args)
        with self.spans("fetch"):
            out = {name: getattr(res.outputs, name).cpu().numpy() for name in FUSION_LEAVES}
            out.update(refined_pos=gn.state.positions.cpu().numpy(), refined_quat=gn.state.quaternions.cpu().numpy(),
                       cost=gn.cost_history.cpu().numpy(), loop_ij=np.asarray(info["loop_ij"], np.int64).reshape(-1, 2))
        return out

    def keep(self, k: int, out):
        return k % self.variants, out

    def check(self, kept, dtype) -> dict:
        v, out = kept
        (slam, gt, gp), = self.requests[v][0]
        want = checks.reference_drive(slam, gt, gp, self.cfg, dtype)
        gaps = checks.drive_gaps(program_drive(out), want)
        gaps.update(checks.refine_gaps(out, ref_pg.refine(slam, want, self.cfg["refine"], dtype)))
        return gaps

    def control(self, v: int, dtype):
        (slam, gt, gp), = self.requests[v][0]
        f = checks.reference_drive(slam, gt, gp, self.cfg, dtype)
        pg = ref_pg.refine(slam, f, self.cfg["refine"], dtype)
        return v, {"aligned_gps": f["aligned"], "gps_valid": f["valid"], "sim3_inliers": f["inliers"],
                   "sim3_pos": f["sim3_pos"], "corrected_pos": f["pos"], "corrected_quat": f["quat"],
                   "refined_pos": pg["pos"], "refined_quat": pg["quat"], "cost": pg["cost"], "loop_ij": pg["loop_ij"]}
