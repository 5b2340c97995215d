"""Multi-process batched fusion of the port (``parallel.distributed`` on
``torch.distributed``) on the CPU, float64: two gloo ranks started by the
``distributed_launch`` example's launcher (each rank's output in a file,
each with its own timeout), and a one-rank group in this process.

Tolerance: the gathered rows against one process's ``fuse_batch`` of the
whole batch ≤1e-9 m (each rank runs the same batched program on its shard;
the JAX package holds its distributed rows to 1e-9 m too).
"""

import socket

import numpy as np
import pytest
import torch
import torch.distributed as tdist

from gps_optimize_slam_tpu_torch.examples import distributed_launch
from gps_optimize_slam_tpu_torch.parallel import batch as pbatch
from gps_optimize_slam_tpu_torch.parallel import distributed as dist
from gps_optimize_slam_tpu_torch.parallel import mesh
from tests.test_parallel import make_sequences


@pytest.fixture(scope="module")
def batch5():
    return pbatch.pad_batch(*make_sequences(n_seqs=5, base_n=40))


def _assert_rows_equal(got, want):
    for name in ("corrected_pos", "corrected_quat", "sim3_pos"):
        assert np.abs(getattr(got, name) - getattr(want, name).numpy()).max() <= 1e-9, name
    np.testing.assert_array_equal(got.gps_valid, want.gps_valid.numpy())
    np.testing.assert_array_equal(got.ok, want.ok.numpy())
    assert np.abs(got.sim3.scale - want.sim3.scale.numpy()).max() <= 1e-12


def test_two_gloo_ranks_match_one_process(batch5, tmp_path):
    """Five rows over two ranks (padded to six): the launcher's two worker
    processes gather rows equal to one process's batch."""
    seeds = np.arange(5) + 3
    distributed_launch.save_batch(str(tmp_path / "batch.npz"), batch5, seeds)
    out = tmp_path / "gathered.npz"
    distributed_launch.main(["--nproc", "2", "--device", "cpu", "--batch", str(tmp_path / "batch.npz"),
                             "--out", str(out), "--log-dir", str(tmp_path / "logs"), "--timeout", "240"])
    logs = [(tmp_path / "logs" / f"rank{r}.log").read_text() for r in range(2)]
    assert "rank 0 on cpu: fused 3 rows" in logs[0] and "rank 1 on cpu: fused 3 rows" in logs[1]
    assert "gloo group of 2 ranks on ['cpu', 'cpu']: 5 sequences" in logs[0]
    with np.load(out) as f:
        from gps_optimize_slam_tpu_torch.models.fusion import FusionOutputs
        from gps_optimize_slam_tpu_torch.ops.umeyama import Sim3

        got = FusionOutputs(**{k: f[k] for k in FusionOutputs._fields if k != "sim3"},
                            sim3=Sim3(*(f[f"sim3_{k}"] for k in Sim3._fields)))
    _assert_rows_equal(got, mesh.fuse_batch(batch5, seeds, device="cpu"))


def test_a_failed_rank_fails_the_launcher(tmp_path):
    with pytest.raises(RuntimeError, match="rank 0 exited"):
        distributed_launch.main(["--nproc", "1", "--device", "cpu", "--batch", str(tmp_path / "missing.npz"),
                                 "--log-dir", str(tmp_path / "logs"), "--timeout", "120"])


@pytest.fixture
def one_rank_group():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    device = dist.initialize(f"127.0.0.1:{port}", 1, 0, device="cpu", timeout_s=60)
    try:
        yield device
    finally:
        tdist.destroy_process_group()
        dist._device = None


def test_one_rank_group(one_rank_group, batch5):
    assert one_rank_group == torch.device("cpu") and tdist.get_backend() == "gloo"
    assert dist.global_mesh() == mesh.Mesh((torch.device("cpu"),))
    out, n_real = dist.fuse_batch_distributed(batch5, np.arange(5))
    assert n_real == 5 and out.corrected_pos.shape[0] == 5
    _assert_rows_equal(dist.gather_outputs(out, n_real), mesh.fuse_batch(batch5, device="cpu"))


def test_ranks_need_a_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dist.initialize("127.0.0.1:1", 1, 0)
    with pytest.raises(RuntimeError, match="initialize first"):
        dist.global_mesh()
    assert not tdist.is_initialized()
