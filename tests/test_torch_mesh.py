"""The port's mesh (``parallel.mesh.Mesh``, ``make_mesh`` and ``mesh=`` on the
batch entry points) on the CPU, float64; shards on distinct devices in flight
together (distinct devices faked by patching the grouping of shards into
host threads), an error in one shard reaching the caller; the kernels'
library built once from several threads and the launch counts kept under
threads; and the launch scoping of the kernel wrappers (every launch on its
tensors' own device and stream).

Tolerances: a sharded row against the unsharded batch ≤1e-9 m (the JAX
package holds a batch's row to its single call at that bound; here both
sides run the same batched program on fewer rows), offsets ≤1e-9 s.
"""

import contextlib
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from gps_optimize_slam_tpu_torch.config import FusionConfig
from gps_optimize_slam_tpu_torch.ops import _build, kernels, scan
from gps_optimize_slam_tpu_torch.parallel import batch as pbatch
from gps_optimize_slam_tpu_torch.parallel import mesh
from tests.test_parallel import make_sequences
from tests.test_torch_profiling import tracer  # noqa: F401

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


def one_thread_a_shard(devices):
    """Stands in for ``mesh._device_groups`` on a mesh of distinct devices."""
    return [[k] for k in range(len(devices))]


@pytest.mark.parametrize("entry", ["fuse_batch", "estimate_offsets_batch"])
def test_shards_on_distinct_devices_are_in_flight_together(batch5, unsharded, monkeypatch, entry):
    """Three shards, each its own "device": every shard's call waits at a
    barrier of three, so the run ends only if all three are issued before
    any finishes; the rows are still the unsharded batch's."""
    d = 3
    m = mesh.make_mesh(devices=["cpu"] * d)
    monkeypatch.setattr(mesh, "_device_groups", one_thread_a_shard)
    barrier = threading.Barrier(d, timeout=10)
    threads = set()
    original = getattr(mesh, entry)

    def waiting(batch, *args, **kw):
        if kw.get("mesh") is None:  # a shard's own call
            threads.add(threading.get_ident())
            barrier.wait()
        return original(batch, *args, **kw)

    monkeypatch.setattr(mesh, entry, waiting)
    if entry == "fuse_batch":
        got = original(batch5, config=GPU_LADDER, mesh=m)
        assert float((got.corrected_pos - unsharded.corrected_pos).abs().max()) <= 1e-9
        assert torch.equal(got.sim3_inliers, unsharded.sim3_inliers)
    else:
        got = original(batch5, mesh=m)
        np.testing.assert_allclose(got, original(batch5, device="cpu"), atol=1e-9, rtol=0)
    assert len(threads) == d and not barrier.broken


def test_shards_sharing_a_device_run_in_one_thread_in_order(batch5, monkeypatch):
    order = []
    original = mesh.fuse_batch

    def recording(batch, *args, **kw):
        if isinstance(batch, mesh.StagedBatch):
            order.append((threading.get_ident(), batch.seeds))
        return original(batch, *args, **kw)

    monkeypatch.setattr(mesh, "fuse_batch", recording)
    original(batch5, seeds=[10, 11, 12, 13, 14], config=GPU_LADDER, mesh=mesh.make_mesh(devices=["cpu"] * 3))
    assert [s for _, s in order] == [(10, 11), (12, 13), (14, 10)]
    assert len({t for t, _ in order}) == 1
    assert mesh._device_groups([torch.device("cpu"), torch.device("meta"), torch.device("cpu")]) == [[0, 2], [1]]


@pytest.mark.parametrize("distinct", [False, True])
def test_an_error_in_one_shard_reaches_the_caller(batch5, monkeypatch, distinct):
    if distinct:
        monkeypatch.setattr(mesh, "_device_groups", one_thread_a_shard)
    original = mesh.fuse_batch
    finished = []

    def failing(batch, *args, **kw):
        if isinstance(batch, mesh.StagedBatch):
            if 12 in batch.seeds:
                raise RuntimeError("shard 1 failed")
            finished.append(batch.seeds)
        return original(batch, *args, **kw)

    monkeypatch.setattr(mesh, "fuse_batch", failing)
    with pytest.raises(RuntimeError, match="shard 1 failed"):
        original(batch5, seeds=[10, 11, 12, 13, 14], config=GPU_LADDER, mesh=mesh.make_mesh(devices=["cpu"] * 3))
    # In one thread the shards after the failing one are never issued; in
    # one thread a shard, the others run to their end before the error is raised.
    assert sorted(finished) == ([(10, 11), (14, 10)] if distinct else [(10, 11)])


def test_the_library_is_built_once_from_eight_threads(monkeypatch, tmp_path):
    """Eight threads reach their first kernel together: the build (nvcc,
    patched here) runs once and every thread gets the same library."""
    builds = []
    library = object()

    def slow_compile(so):
        builds.append(so)
        time.sleep(0.2)
        so.write_bytes(b"")
        return "nvcc log"

    monkeypatch.setattr(_build, "_lib", None)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "BUILD_INFO", {})
    monkeypatch.setattr(_build, "_compile", slow_compile)
    monkeypatch.setattr(_build, "_open", lambda so: library)
    start = threading.Barrier(8, timeout=10)

    def first_use(_):
        start.wait()
        return _build.library()

    with ThreadPoolExecutor(8) as pool:
        got = list(pool.map(first_use, range(8)))
    assert len(builds) == 1 and all(lib is library for lib in got)
    assert _build.BUILD_INFO["log"] == "nvcc log" and _build.BUILD_INFO["path"] == str(builds[0])


def test_launch_counts_survive_many_threads(monkeypatch):
    """Sixteen threads, more than this host's cores may be, each launching
    K1 200 times (meta tensors take the wrappers' CUDA path; the library is
    faked) with a short switch interval: no count is lost."""
    monkeypatch.setattr(torch.cuda, "device", lambda device: contextlib.nullcontext())
    monkeypatch.setattr(_build, "stream", lambda device: 0)
    monkeypatch.setattr(_build, "library", lambda: _FakeLib())
    monkeypatch.setattr(_build, "require_cuda", lambda *a, **k: None)
    monkeypatch.setitem(scan.scan_block.launches, "add2", 0)
    x = torch.empty(2, 64, dtype=torch.float64, device="meta")

    def launch(_):
        for _ in range(200):
            scan.scan_block("add2", x)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with ThreadPoolExecutor(16) as pool:
            list(pool.map(launch, range(16)))
    finally:
        sys.setswitchinterval(interval)
    assert scan.scan_block.launches["add2"] == 16 * 200


def test_fuse_buckets_stages_the_next_bucket_before_draining_this_one(tracer):  # noqa: F811
    """Traced, ``fuse_buckets``' sweep records a span for each stage, launch,
    drain wait and drain's row slicing: bucket i+1's stage starts (and ends)
    before bucket i's drain starts, its launch after bucket i's launch."""
    seqs = make_sequences(n_seqs=4, base_n=60)
    buckets = pbatch.bucket_by_length(*seqs, max_waste=0.0)
    assert len(buckets) == 4
    tracer.enable()
    mesh.fuse_buckets(buckets, config=FusionConfig(platform="gpu"), device="cpu")
    rec = tracer.records()
    tracer.disable()
    by = {}
    for name, _, start, end in rec["spans"]:
        if name.startswith("sweep."):
            by.setdefault(name, []).append((start, end))
    assert {k: len(v) for k, v in by.items()} == {k: 4 for k in ("sweep.stage", "sweep.launch", "sweep.drain.wait",
                                                                 "sweep.drain.rows")}
    for k in by:
        by[k].sort()
    for i in range(3):
        assert by["sweep.stage"][i + 1][1] <= by["sweep.drain.wait"][i][0]
        assert by["sweep.launch"][i][1] <= by["sweep.stage"][i + 1][0] <= by["sweep.launch"][i + 1][0]
        assert by["sweep.drain.wait"][i][1] <= by["sweep.drain.rows"][i][0]
