"""The faults of each flow, planted under the timed path by the CPU tests
(``test_portbench_reference.py``): ``faults/<flow>.py`` holds ``FAULTS``, a
list of context managers, each of which breaks the program while it is
open so that the flow's run must come out not correct. Among them is
``altered_answer``: one answer of the flow altered where the flow's outputs
are produced. A new flow brings its own file, with its own
``altered_answer``."""

import contextlib
from unittest import mock


@contextlib.contextmanager
def altered_answer():
    """One fused position moved by 1 mm where the fusion produces it
    (``models.fusion._fuse_core``): the ``altered_answer`` of the flows
    whose fused outputs come from there."""
    from gps_optimize_slam_tpu_torch.models import fusion

    real = fusion._fuse_core

    def fuse(*args, **kwargs):
        out = real(*args, **kwargs)
        pos = out.corrected_pos.clone()
        pos[..., 5, 0] += 1e-3
        return out._replace(corrected_pos=pos)

    with mock.patch.object(fusion, "_fuse_core", fuse):
        yield
