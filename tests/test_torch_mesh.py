"""The port's mesh (``parallel.mesh.Mesh``, ``make_mesh`` and ``mesh=`` on the
batch entry points) on the CPU, float64, and the launch scoping of the kernel
wrappers (every launch on its tensors' own device and stream).

Tolerances: a sharded row against the unsharded batch ≤1e-9 m (the JAX
package holds a batch's row to its single call at that bound; here both
sides run the same batched program on fewer rows), offsets ≤1e-9 s.
"""

import numpy as np
import pytest
import torch

from gps_optimize_slam_tpu_torch.config import FusionConfig
from gps_optimize_slam_tpu_torch.ops import _build, kernels, scan
from gps_optimize_slam_tpu_torch.parallel import batch as pbatch
from gps_optimize_slam_tpu_torch.parallel import mesh
from tests.test_parallel import make_sequences

GPU_LADDER = FusionConfig(platform="gpu")  # the parallel filter, through the plain K1 ladder on CPU tensors


@pytest.fixture(scope="module")
def batch5():
    return pbatch.pad_batch(*make_sequences(n_seqs=5, base_n=40))


@pytest.fixture(scope="module")
def unsharded(batch5):
    return mesh.fuse_batch(batch5, config=GPU_LADDER, device="cpu")


def test_make_mesh_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mesh.make_mesh()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mesh.make_mesh(n_devices=2)


def test_make_mesh_never_falls_back_to_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert mesh.make_mesh().devices == (torch.device("cuda", 0), torch.device("cuda", 1))
    assert mesh.make_mesh(n_devices=1).devices == (torch.device("cuda", 0),)
    with pytest.raises(ValueError, match=r"devices=\['cuda:0'\] \* 4"):
        mesh.make_mesh(n_devices=4)


def test_make_mesh_takes_named_devices_that_may_repeat():
    m = mesh.make_mesh(devices=["cpu"] * 3)
    assert m.devices == (torch.device("cpu"),) * 3 and m.size == 3 and m.axis_names == ("seq",)
    with pytest.raises(ValueError):
        mesh.make_mesh(devices=[])
    with pytest.raises(ValueError):
        mesh.make_mesh(devices=["cpu"], n_devices=1)


@pytest.mark.parametrize("d", [2, 3, 5, 8])
def test_sharded_batch_matches_unsharded(batch5, unsharded, d):
    """B = 5 over 2, 3, 5 and 8 devices: padded to 6, 6, 5 and 8 rows
    (JAX's test_sharded_mesh_matches_unsharded and
    test_non_divisible_batch_shards_and_matches)."""
    got = mesh.fuse_batch(batch5, config=GPU_LADDER, mesh=mesh.make_mesh(devices=["cpu"] * d))
    assert got.corrected_pos.shape == unsharded.corrected_pos.shape
    for name in ("corrected_pos", "corrected_quat", "sim3_pos", "aligned_gps"):
        a, b = getattr(got, name), getattr(unsharded, name)
        assert float((a - b).nan_to_num().abs().max()) <= 1e-9, name
    assert torch.equal(got.sim3_inliers, unsharded.sim3_inliers) and torch.equal(got.gps_valid, unsharded.gps_valid)
    assert torch.equal(got.ok, unsharded.ok) and bool(got.ok.all())
    assert float((got.sim3.scale - unsharded.sim3.scale).abs().max()) <= 1e-12
    ev, want = mesh.evaluate_batch(batch5, got), mesh.evaluate_batch(batch5, unsharded)
    assert torch.allclose(ev.nn_ekf.rmse, want.nn_ekf.rmse, rtol=1e-9, atol=0)


def test_stage_batch_shards_rows_with_their_seeds(batch5):
    staged = mesh.stage_batch(batch5, seeds=[10, 11, 12, 13, 14], mesh=mesh.make_mesh(devices=["cpu"] * 4),
                              time_offsets=np.arange(5) * 0.5)
    assert isinstance(staged, mesh.ShardedBatch) and staged.n_real == 5
    assert [s.seeds for s in staged.shards] == [(10, 11), (12, 13), (14, 10), (10, 10)]
    rows = torch.cat([s.args[1] for s in staged.shards])
    assert torch.equal(rows[:5], torch.as_tensor(batch5.slam_pos)) and torch.equal(rows[5], rows[0])
    assert torch.cat([s.args[7] for s in staged.shards]).tolist() == [0.0, 0.5, 1.0, 1.5, 2.0, 0.0, 0.0, 0.0]


def test_mesh_and_device_exclude_each_other(batch5):
    m = mesh.make_mesh(devices=["cpu"] * 2)
    for call in (lambda: mesh.fuse_batch(batch5, mesh=m, device="cpu"),
                 lambda: mesh.stage_batch(batch5, mesh=m, device="cpu"),
                 lambda: mesh.estimate_offsets_batch(batch5, mesh=m, device="cpu"),
                 lambda: mesh.fuse_buckets([(np.arange(5), batch5)], mesh=m, device="cpu")):
        with pytest.raises(ValueError, match="exclude each other"):
            call()


def test_sharded_offsets_draws_and_buckets_match_unsharded(batch5):
    m = mesh.make_mesh(devices=["cpu"] * 3)
    np.testing.assert_allclose(mesh.estimate_offsets_batch(batch5, mesh=m),
                               mesh.estimate_offsets_batch(batch5, device="cpu"), atol=1e-9, rtol=0)
    draws = torch.stack([torch.randint(0, 30, (1000, 4), generator=torch.Generator().manual_seed(i))
                         for i in range(5)])
    got = mesh.fuse_batch(batch5, config=GPU_LADDER, mesh=m, sim3_draws=draws)
    want = mesh.fuse_batch(batch5, config=GPU_LADDER, device="cpu", sim3_draws=draws)
    assert float((got.corrected_pos - want.corrected_pos).abs().max()) <= 1e-9
    slams, gts, gps_list, valids = make_sequences(n_seqs=5, base_n=40)
    buckets = pbatch.bucket_by_length(slams, gts, gps_list, valids, max_waste=1.2)
    assert len(buckets) > 1
    for a, b in zip(mesh.fuse_buckets(buckets, config=GPU_LADDER, mesh=m),
                    mesh.fuse_buckets(buckets, config=GPU_LADDER, device="cpu")):
        assert a.corrected_pos.shape == b.corrected_pos.shape
        assert np.abs(a.corrected_pos - b.corrected_pos).max() <= 1e-9


class _FakeLib:
    """Stands in for the kernels' library: every size query answers 16, K4's
    run length is the wrapper's, every launch succeeds."""

    def __getattr__(self, name):
        if name == "gps_nn_grid_run":
            return lambda: kernels.RUN_TILES
        return lambda *args: 16 if name.endswith(("_bytes", "_tile")) else 0


def test_every_wrapper_launches_on_its_tensors_device(monkeypatch):
    """Each wrapper makes its tensors' device current around the launch and
    passes that device's stream (meta tensors stand in for a second card:
    they take the wrappers' CUDA path)."""
    entered, streams = [], []

    class Scope:
        def __init__(self, device):
            entered.append(torch.device(device))

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    monkeypatch.setattr(torch.cuda, "device", Scope)
    monkeypatch.setattr(_build, "stream", lambda device: streams.append(device) or 0)
    monkeypatch.setattr(_build, "library", lambda: _FakeLib())
    monkeypatch.setattr(_build, "require_cuda", lambda *a, **k: None)
    monkeypatch.setattr(kernels, "_check_nn", lambda *a: None)
    meta = torch.device("meta")
    x = torch.empty(27, 100, dtype=torch.float64, device=meta)
    traj = torch.empty(300, 3, dtype=torch.float64, device=meta)
    mask = torch.empty(300, dtype=torch.bool, device=meta)
    R = torch.empty(8, 3, 3, dtype=torch.float64, device=meta)
    calls = [
        lambda: scan.scan_block("filter", x),
        lambda: scan.scan_tiled("filter", x),
        lambda: kernels.keep_lists(traj, traj, mask),
        lambda: kernels.nn_resident(traj, traj, mask),
        lambda: kernels.grid_launch(traj, kernels.nn_grid_operands(traj, traj, mask), 4),
        lambda: kernels.ransac_counts(traj, traj, mask, R, R[:, 0], R[:, 0, 0], 1.0),
    ]
    for call in calls:
        entered.clear()
        streams.clear()
        call()
        assert entered and entered == streams and set(entered) == {meta}
