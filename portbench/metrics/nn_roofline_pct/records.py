"""The program calls nn_roofline_pct reads: each nearest-neighbour call of
the evaluation (``ops.metrics.nn_min_dist2``, the name ``nn_errors_auto``
calls), written to the work as ``("nn", query shape, candidate shape,
dtype)``."""

METRICS = "gps_optimize_slam_tpu_torch.ops.metrics"


def note(traj, candidates, *rest, **kwargs):
    return ("nn", tuple(traj.shape), tuple(candidates.shape), str(traj.dtype).split(".")[-1])


RECORDS = [(METRICS, "nn_min_dist2", note)]
