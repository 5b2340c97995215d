"""The faults of the ``fleet_buckets`` flow."""

import contextlib
from unittest import mock

# The rows of fuse_buckets come from the fusion's core.
from portbench.tests.faults import altered_answer


@contextlib.contextmanager
def half_the_fleet():
    """The bucketing leaves out the second half of the drives."""
    from gps_optimize_slam_tpu_torch.parallel import batch as pbatch

    real = pbatch.bucket_by_length

    def bucket(slams, gts, gps, **kw):
        h = len(slams) // 2
        return real(slams[:h], gts[:h], gps[:h], **kw)

    with mock.patch.object(pbatch, "bucket_by_length", bucket):
        yield


FAULTS = [altered_answer, half_the_fleet]
