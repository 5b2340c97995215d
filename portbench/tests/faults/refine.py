"""The faults of the ``refine`` flow."""

import contextlib
from unittest import mock

# The fused outputs come from the fusion's core (altered_refinement alters the refined ones).
from portbench.tests.faults import altered_answer


@contextlib.contextmanager
def unchanged_step():
    """Each Gauss-Newton step returns its state and cost unchanged."""
    from gps_optimize_slam_tpu_torch.models import pose_graph

    with mock.patch.object(pose_graph, "_gn_step", lambda state, data, cg, damping, c_old: (state, c_old)):
        yield


@contextlib.contextmanager
def altered_refinement():
    """One refined position moved by 1 mm where the solve produces it."""
    from gps_optimize_slam_tpu_torch.models import pose_graph

    real = pose_graph.solve_pose_graph_checkpointed

    def solve(*args, **kwargs):
        res = real(*args, **kwargs)
        pos = res.state.positions.clone()
        pos[7, 1] += 1e-3
        return res._replace(state=res.state._replace(positions=pos))

    with mock.patch.object(pose_graph, "solve_pose_graph_checkpointed", solve):
        yield


FAULTS = [altered_answer, unchanged_step, altered_refinement]
