"""The faults of the ``longlog_eval`` flow."""

import contextlib
from unittest import mock


@contextlib.contextmanager
def altered_answer():
    """One fused position of the first log moved by 1 mm where
    ``mesh.fuse_batch`` produces it."""
    from gps_optimize_slam_tpu_torch.parallel import mesh

    real = mesh.fuse_batch

    def fuse(*args, **kwargs):
        out = real(*args, **kwargs)
        pos = out.corrected_pos.clone()
        pos[0, 5, 0] += 1e-3
        return out._replace(corrected_pos=pos)

    with mock.patch.object(mesh, "fuse_batch", fuse):
        yield


@contextlib.contextmanager
def one_log_left_out():
    """The staging leaves out the request's last log."""
    from gps_optimize_slam_tpu_torch.parallel import mesh

    real = mesh.stage_batch

    def stage(batch, seeds=None, **kwargs):
        return real(type(batch)(*(x[:-1] for x in batch)), None if seeds is None else seeds[:-1], **kwargs)

    with mock.patch.object(mesh, "stage_batch", stage):
        yield


@contextlib.contextmanager
def altered_statistic():
    """The EKF trajectory's NN RMSE of the first log moved by 1 µm in
    ``mesh.evaluate_batch``'s result."""
    from gps_optimize_slam_tpu_torch.parallel import mesh

    real = mesh.evaluate_batch

    def evaluate(*args, **kwargs):
        ev = real(*args, **kwargs)
        rmse = ev.nn_ekf.rmse.clone()
        rmse[0] += 1e-6
        return ev._replace(nn_ekf=ev.nn_ekf._replace(rmse=rmse))

    with mock.patch.object(mesh, "evaluate_batch", evaluate):
        yield


@contextlib.contextmanager
def half_the_candidates():
    """Each nearest-neighbour search over the first half of each row's
    candidates only."""
    from gps_optimize_slam_tpu_torch.ops import metrics

    real = metrics.nn_min_dist2

    def nn(traj, candidates, cand_mask, *args, **kwargs):
        half = candidates.shape[-2] // 2
        return real(traj, candidates[..., :half, :], cand_mask[..., :half], *args, **kwargs)

    with mock.patch.object(metrics, "nn_min_dist2", nn):
        yield


FAULTS = [altered_answer, one_log_left_out, altered_statistic, half_the_candidates]
