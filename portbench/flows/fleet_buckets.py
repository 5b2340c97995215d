"""A set of drives in one request: ``parallel.batch.bucket_by_length`` →
``parallel.mesh.fuse_buckets`` on the cell's card → per-sequence rows on
the host, as the ``fuse-batch`` command fuses them."""

from __future__ import annotations

from portbench.flows.common import FlowBase, program_drive


class Flow(FlowBase):
    def __init__(self, *args):
        super().__init__(*args)
        self._padding = None

    def request(self, k: int):
        from gps_optimize_slam_tpu_torch.parallel import batch as pbatch
        from gps_optimize_slam_tpu_torch.parallel import mesh

        drives, seeds = self.requests[k % self.variants]
        with self.spans("batch"):
            buckets = pbatch.bucket_by_length([d[0] for d in drives], [d[1] for d in drives],
                                              [d[2] for d in drives], max_waste=float(self.cell["max_waste"]))
        if self._padding is None:
            self._padding = {"padded": sum(int(b.slam_times.size) for _, b in buckets),
                             "real": sum(int(b.n_slam.sum()) for _, b in buckets), "buckets": len(buckets)}
        with self.spans("fuse"):
            return mesh.fuse_buckets(buckets, seeds, config=self.fusion_config, dtype=self.dtype, device=self.device)

    def padding(self):
        return self._padding

    def keep(self, k: int, rows):
        return k % self.variants, [None if r is None else program_drive(r._asdict()) for r in rows]

