"""The port's compiled programs (``utils.graphs``) on the CPU, where no
graph is captured: what makes a program capturable, the keys, ``eager()``,
the replay's bookkeeping, and the adaptive RANSAC that a graph runs.

* Capture safety: every body the port captures on a card runs under
  ``FakeTensorMode``, which raises on any read of a tensor's value on the
  host (a read would synchronise, and a synchronisation inside a capture
  raises): ``fusion._fuse_core`` single and batched (the parallel filter,
  the draws or the uniforms passed in), ``fusion._evaluate_against``, and
  each stage and fold of a sequence-parallel block.
* Adaptive RANSAC: under a capture every chunk runs, masked; the result
  equals the early stop's and the JAX package's ``while_loop`` on the same
  injected draws (masks and counts equal; R, t, s ≤1e-10, the bounds of
  tests/test_torch_ransac_alignment.py).
* A replay on fake CUDA tensors (``FakeTensorMode`` makes them without a
  card): inputs copied in, the capture's launches added, clones returned;
  a capture that raises reaches the caller.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from gps_optimize_slam_tpu.config import Sim3RansacConfig as JSim3RansacConfig
from gps_optimize_slam_tpu.ops import quaternion as jquat
from gps_optimize_slam_tpu.ops import ransac as jr
from gps_optimize_slam_tpu_torch.config import FusionConfig, Sim3RansacConfig
from gps_optimize_slam_tpu_torch.models import fusion
from gps_optimize_slam_tpu_torch.ops import _build, kalman, kalman_parallel, quaternion, ransac, scan
from gps_optimize_slam_tpu_torch.parallel import batch as pbatch
from gps_optimize_slam_tpu_torch.parallel import mesh, seqpar
from gps_optimize_slam_tpu_torch.utils import graphs
from tests.test_parallel import make_sequences
from tests.test_torch_ransac_alignment import jax_loop_counts, jax_sim3_draws, sim3_problem  # noqa: F401

PARALLEL = FusionConfig(platform="gpu", ekf_scan="parallel", gps_sorted=True)


def fusion_inputs(b: int):
    """A padded batch of ``b`` sequences (test_parallel's), float64 CPU
    tensors: slam times, positions, quaternions, GPS times, positions,
    validity, the SLAM mask and the offsets."""
    slams, gts, gps, valids = make_sequences(n_seqs=b, base_n=70)
    batch = pbatch.pad_batch(slams, gts, gps, valids)
    f64 = torch.float64
    return (torch.tensor(batch.slam_times, dtype=f64), torch.tensor(batch.slam_pos, dtype=f64),
            torch.tensor(batch.slam_quat, dtype=f64), torch.tensor(batch.gps_times, dtype=f64),
            torch.tensor(batch.gps_pos, dtype=f64), torch.tensor(batch.gps_valid),
            torch.tensor(batch.slam_mask), torch.zeros(b, dtype=f64))


def under_fake_mode(fn, *args):
    """``fn(*args)`` with every tensor of ``args`` a fake one: no value
    exists, so a host read raises."""
    with FakeTensorMode() as mode:
        fake = [torch.utils._pytree.tree_map_only(torch.Tensor, mode.from_tensor, a) for a in args]
        return fn(*fake)


@pytest.mark.parametrize("batched", [False, True])
@pytest.mark.parametrize("draws", ["uniforms", "draws"])
def test_fuse_core_program_reads_no_value_on_the_host(batched, draws, monkeypatch):
    """``_fuse_core`` with the parallel filter, single and batched, given
    its RANSAC uniforms (as ``fuse_core`` makes them) or draws, and under
    ``stop_probability`` as a capture runs it (``graphs.capturing()``)."""
    st, sp, sq, gt, gp, gv, sm, toff = fusion_inputs(2)
    args = (st, sp, sq, gt, gp, gv, sm, toff) if batched else (
        st[0], sp[0], sq[0], gt[0], gp[0], gv[0], sm[0], toff[0])
    lead = (2,) if batched else ()
    monkeypatch.setattr(graphs, "capturing", lambda: True)
    for cfg in (PARALLEL, PARALLEL.replace(sim3_ransac=Sim3RansacConfig(stop_probability=0.99, adaptive_chunk=128))):
        trials = ransac.sim3_trials(cfg.sim3_ransac)
        u = ransac.seeded_uniforms(0, lead, trials, 4, "cpu")
        given = (None, u) if draws == "uniforms" else (torch.zeros((*lead, trials, 4), dtype=torch.long), None)
        out = under_fake_mode(lambda *a: fusion._fuse_core(*a, cfg), *args, *given)
        assert out.corrected_pos.shape == args[1].shape


@pytest.mark.parametrize("batched", [False, True])
def test_evaluate_program_reads_no_value_on_the_host(batched):
    st, sp, sq, gt, gp, gv, sm, toff = fusion_inputs(2)
    res = fusion.fuse_core(st, sp, sq, gt, gp, gv, PARALLEL, seed=(0, 1), slam_mask=sm, time_offset=toff)
    rows = slice(None) if batched else 0
    args = (st[rows], sp[rows], res.sim3_pos[rows], res.corrected_pos[rows], res.aligned_gps[rows],
            res.gps_valid[rows])
    ev = under_fake_mode(lambda *a: fusion._evaluate_against(*a, 5.0), *args)
    assert ev.nn_ekf.rmse.shape == ((2,) if batched else ())


def test_seqpar_stages_read_no_value_on_the_host(monkeypatch):
    """Every stage and fold of ``fuse_ekf_rts_seqparallel`` on a 3-block CPU
    mesh, each run under fake mode as ``graphs.run`` would capture it (the
    stages of the middle block see both halos)."""
    st, sp, sq, gt, gp, gv, sm, _ = fusion_inputs(1)
    res = fusion.fuse_core(st[0], sp[0], sq[0], gt[0], gp[0], gv[0], PARALLEL)
    seen = []

    def faked(fn, *args):
        seen.append(fn.__name__)
        under_fake_mode(fn, *args)
        return fn(*args)

    monkeypatch.setattr(graphs, "run", faked)
    got, _ = seqpar.fuse_ekf_rts_seqparallel(mesh.make_mesh(devices=["cpu"] * 3), st[0], sp[0], sq[0],
                                             res.sim3_pos, res.sim3_quat, res.aligned_gps, res.gps_valid)
    assert set(seen) == {"_marks", "_forward", "_block_controls", "_chain_stage", "_filter_stage", "_rts_stage",
                         "_smoothed_stage", "_fold"}
    assert seen.count("_fold") == 5 * 2  # five scans, two blocks with a neighbour before (after) them
    torch.testing.assert_close(got, res.corrected_pos, rtol=0, atol=1e-8)


@pytest.mark.parametrize("seed,outliers,p", [(1, 0.45, 0.9999), (2, 0.6, 0.999999), (3, 0.0, 0.9999)])
def test_masked_chunks_equal_the_early_stop_and_jax(seed, outliers, p, jax_loop_counts, monkeypatch):  # noqa: F811
    """Under a capture (``graphs.capturing()``) all 7 chunks run; the Sim(3),
    the inlier mask and the count equal those of the early stop (which
    ran fewer chunks) and of the JAX package's ``while_loop``."""
    src, dst, valid = sim3_problem(seed, outliers=outliers)
    kw = dict(max_trials=200, stop_probability=p, adaptive_chunk=32)
    key = jax.random.PRNGKey(seed)
    want = jr.sim3_ransac(key, jnp.asarray(src), jnp.asarray(dst), valid=jnp.asarray(valid),
                          cfg=JSim3RansacConfig(**kw), platform="cpu")
    jax.effects_barrier()
    draws = torch.tensor(jax_sim3_draws(key, valid, JSim3RansacConfig(**kw)))
    inputs = (torch.tensor(src), torch.tensor(dst), torch.tensor(valid))
    early = ransac.sim3_ransac(*inputs, cfg=Sim3RansacConfig(**kw), draws=draws)
    calls = []
    real_counts = ransac.ransac_counts
    monkeypatch.setattr(ransac, "ransac_counts", lambda *a: calls.append(1) or real_counts(*a))
    monkeypatch.setattr(graphs, "capturing", lambda: True)
    masked = ransac.sim3_ransac(*inputs, cfg=Sim3RansacConfig(**kw), draws=draws)
    assert len(calls) == 7 and jax_loop_counts[-1] <= 7  # seeds 1 and 3 stop after 2 and 1 chunks
    for got in (masked, early):
        np.testing.assert_array_equal(got.inlier_mask.numpy(), np.asarray(want.inlier_mask))
        assert int(got.num_inliers) == int(want.num_inliers) and bool(got.ok) == bool(want.ok)
        np.testing.assert_allclose(got.sim3.R.numpy(), np.asarray(want.sim3.R), atol=1e-10)
        np.testing.assert_allclose(got.sim3.t.numpy(), np.asarray(want.sim3.t), rtol=1e-10)
        assert abs(float(got.sim3.scale) - float(want.sim3.scale)) <= 1e-10
    assert torch.equal(masked.inlier_mask, early.inlier_mask) and torch.equal(masked.sim3.R, early.sim3.R)


def test_seeded_uniforms_draw_what_the_generator_draws():
    """A row seeded ``s`` draws the uniforms of a generator seeded ``s``
    alone, and ``sim3_ransac`` given them equals its seeded run."""
    src, dst, valid = (torch.tensor(x) for x in sim3_problem(0))
    cfg = Sim3RansacConfig(max_trials=64)
    u = ransac.seeded_uniforms((3, 5), (2,), 64, 4, "cpu")
    assert torch.equal(u[1], ransac.seeded_uniforms(5, (), 64, 4, "cpu"))
    a = ransac.sim3_ransac(src, dst, valid, cfg=cfg, seed=5)
    b = ransac.sim3_ransac(src, dst, valid, cfg=cfg, uniforms=u[1])
    assert torch.equal(a.inlier_mask, b.inlier_mask) and torch.equal(a.sim3.t, b.sim3.t)


def program(x, y, scale, cfg=None):
    return {"sum": x + y * scale, "cfg": cfg}


def test_keys_follow_shapes_dtypes_and_static_arguments():
    x, y = torch.zeros(4), torch.ones(4)
    key = graphs.key_of(program, x, y, 2.0)
    assert graphs.key_of(program, torch.ones(4), torch.zeros(4), 2.0) == key  # values are not in the key
    assert graphs.key_of(program, torch.zeros(5), torch.ones(5), 2.0) != key  # shape
    assert graphs.key_of(program, x.double(), y.double(), 2.0) != key  # dtype
    assert graphs.key_of(program, x, y, 3.0) != key  # a static argument
    assert graphs.key_of(program, x, y, 2.0, cfg=FusionConfig()) != graphs.key_of(
        program, x, y, 2.0, cfg=FusionConfig(rts_mode="full"))  # a static config
    assert graphs.key_of(program, x, y, 2.0, cfg=FusionConfig()) == graphs.key_of(
        program, x, y, 2.0, cfg=FusionConfig())


def test_eager_nests_and_restores():
    assert not graphs._EAGER
    with graphs.eager():
        assert graphs._EAGER
        with graphs.eager():
            assert graphs._EAGER
        assert graphs._EAGER
    assert not graphs._EAGER
    with pytest.raises(KeyError):
        with graphs.eager():
            raise KeyError("inside")
    assert not graphs._EAGER


def test_cpu_tensors_run_the_function_itself():
    x = torch.arange(3.0)
    out = graphs.run(program, x, x, 2.0)
    assert torch.equal(out["sum"], x * 3) and graphs.stats()["captures"] == 0


class _FakeGraph:
    def __init__(self):
        self.replays = 0

    def replay(self):
        self.replays += 1


class _FakeStream:
    def wait_stream(self, other):
        pass


class _NoScope:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


@pytest.fixture
def fake_cuda(monkeypatch):
    """Fake CUDA tensors (no card needed); ``torch.cuda``'s device and
    stream scopes no-ops, its streams stand-ins, the held-bytes budget that
    of an 80 GB card; the devices and counts of ``graphs`` restored
    afterwards."""
    stream = _FakeStream()
    monkeypatch.setattr(torch.cuda, "device", lambda device: _NoScope())
    monkeypatch.setattr(torch.cuda, "stream", lambda s: _NoScope())
    monkeypatch.setattr(torch.cuda, "Stream", lambda device: stream)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: stream)
    monkeypatch.setattr(torch.Tensor, "record_stream", lambda self, s: None)
    monkeypatch.setattr(graphs, "_held_budget", lambda device: 10 * 2**30)
    monkeypatch.setattr(graphs, "_DEVICES", {})
    monkeypatch.setattr(graphs, "_STATS", {"first_calls": 0, "captures": 0, "replays": 0})
    with FakeTensorMode(allow_non_fake_inputs=True) as mode:
        yield mode


def fake_capture(graph, counted_wrapper=None, copies=None):
    """A stand-in for ``graphs._capture``: static buffers shaped as the
    tensors, whose ``copy_`` appends its source to ``copies``; the
    program's outputs computed on them (its static leaves as given); two
    launches of ``counted_wrapper`` tallied."""
    copies = [] if copies is None else copies

    def capture(dev, fn, spec, leaves, tensors):
        inputs = tuple(torch.empty_like(t) for t in tensors)
        for buf in inputs:
            buf.copy_ = lambda t, buf=buf: copies.append(t) or buf
        it = iter(inputs)
        args, kwargs = torch.utils._pytree.tree_unflatten(
            [next(it) if isinstance(x, torch.Tensor) else x for x in leaves], spec)
        with _build.tally_launches() as launches:
            if counted_wrapper is not None:
                _build.count_launch(counted_wrapper)
                _build.count_launch(counted_wrapper)
        outputs = fn(*args, **kwargs)
        return graphs._Program(graph, inputs, outputs, launches, graphs._nbytes(inputs), graphs._nbytes(outputs))

    return capture


def test_a_failed_capture_reaches_the_caller(fake_cuda, monkeypatch):
    def failing(*args):
        raise RuntimeError("operation not permitted when stream is capturing")

    monkeypatch.setattr(graphs, "_capture", failing)
    x = torch.zeros(4, device="cuda")
    graphs.run(program, x, x, 2.0)  # the first call runs eagerly
    with pytest.raises(RuntimeError, match="stream is capturing"):
        graphs.run(program, x, x, 2.0)
    assert graphs.stats()["programs"] == 0


def test_a_replay_copies_in_counts_and_returns_clones(fake_cuda, monkeypatch):
    """The first call runs eagerly and captures nothing; the second
    captures, and it and each later call copy their tensors into the
    static buffers, replay, add the capture's launches and return fresh
    clones."""

    def counted_wrapper():
        pass

    counted_wrapper.launches = 0
    graph = _FakeGraph()
    copies = []
    monkeypatch.setattr(graphs, "_capture", fake_capture(graph, counted_wrapper, copies))
    x = torch.zeros(4, device="cuda")
    first = graphs.run(program, x, x, 2.0)
    assert graphs.stats()["programs"] == 0 and first["sum"].shape == (4,)
    graphs.run(program, x, x, 2.0)
    assert graph.replays == 1 and counted_wrapper.launches == 2  # the capture launched nothing; its replay did
    (prog,) = graphs._DEVICES[x.device].programs.values()
    a = graphs.run(program, x, x, 2.0)
    b = graphs.run(program, x + 1, x, 2.0)
    assert graph.replays == 3 and counted_wrapper.launches == 6 and len(copies) == 6
    assert a["sum"] is not prog.outputs["sum"] and b["sum"] is not a["sum"]
    assert graphs.stats() == {"first_calls": 1, "captures": 1, "replays": 3, "programs": 1, "pool_bytes": 0,
                              "input_bytes": 32, "output_bytes": 16}


def test_a_shape_called_once_is_never_captured(fake_cuda, monkeypatch):
    """Each first call for a key runs eagerly and holds nothing; only a
    key's second call captures, and a program inside a program's first
    call is part of it (no key of its own)."""
    monkeypatch.setattr(graphs, "_capture", fake_capture(_FakeGraph()))

    def outer(x):
        return graphs.run(program, x, x, 1.0)

    for n in range(3, 9):
        graphs.run(outer, torch.zeros(n, device="cuda"))
    assert graphs.stats()["first_calls"] == 6 and graphs.stats()["captures"] == 0
    assert graphs.stats()["programs"] == 0 and len(graphs._DEVICES[torch.device("cuda", 0)].seen) == 6
    graphs.run(outer, torch.zeros(5, device="cuda"))
    assert graphs.stats()["captures"] == 1 and graphs.stats()["programs"] == 1


def test_held_programs_stay_within_their_bytes(fake_cuda, monkeypatch):
    """Past the budget of held inputs and outputs the least recently used
    programs are dropped: the newest is always kept, a replayed program
    counts as used. A program of n floats holds 12·n bytes (two inputs, one
    output)."""
    budget = 12 * 3 * 4100
    monkeypatch.setattr(graphs, "_capture", fake_capture(_FakeGraph()))
    monkeypatch.setattr(graphs, "_held_budget", lambda device: budget)

    def twice(n):
        x = torch.zeros(n, device="cuda")
        graphs.run(program, x, x, 2.0)
        return graphs.run(program, x, x, 2.0)

    def held():
        return [k[3][0][0][0] for k in graphs._DEVICES[torch.device("cuda", 0)].programs]

    for n in (4096, 4097, 4098):
        twice(n)
    assert held() == [4096, 4097, 4098]
    twice(4099)
    assert held() == [4097, 4098, 4099]  # 4,096 dropped: four would pass the budget
    graphs.run(program, torch.ones(4097, device="cuda"), torch.ones(4097, device="cuda"), 2.0)  # a replay
    twice(4100)
    assert held() == [4099, 4097, 4100]
    st = graphs.stats()
    assert st["input_bytes"] + st["output_bytes"] <= budget and st["captures"] == 5
    monkeypatch.setattr(graphs, "_held_budget", lambda device: 0)
    twice(10)
    assert held() == [10]  # the newest stays whatever its size


def test_tally_launches_holds_a_captures_launches():
    """Inside ``tally_launches`` (a capture) a launch is tallied and not
    counted; ``add_launches`` adds the tally (a replay)."""
    start = scan.scan_block.launches["add2"]
    with _build.tally_launches() as tally:
        _build.count_launch(scan.scan_block, "add2")
    assert scan.scan_block.launches["add2"] == start and tally == {(scan.scan_block, "add2"): 1}
    _build.add_launches(tally)
    _build.add_launches(tally)
    assert scan.scan_block.launches["add2"] == start + 2
    scan.scan_block.launches["add2"] = start


def test_blocked_filter_runs_every_stage_through_run():
    """``fuse_ekf_rts_blocks`` on one block with a recording ``run`` equals
    ``fuse_ekf_rts_parallel`` bit for bit: the stages are the same work."""
    st, sp, sq, gt, gp, gv, _, _ = fusion_inputs(1)
    res = fusion.fuse_core(st[0], sp[0], sq[0], gt[0], gp[0], gv[0], PARALLEL)
    names = []
    block = kalman_parallel.PoseBlock(st[0], sp[0], sq[0], res.aligned_gps, res.gps_valid)
    (pos,), _ = kalman_parallel.fuse_ekf_rts_blocks(
        [block], res.sim3_pos[0], res.sim3_quat[0], st.shape[-1],
        run=lambda fn, *a: names.append(fn.__name__) or kalman.call_stage(fn, *a))
    assert names == ["_marks", "_forward", "_block_controls", "_chain_stage", "_filter_stage", "_rts_stage",
                     "_smoothed_stage"]
    assert torch.equal(pos, res.corrected_pos)


def test_identity_quaternion_equals_the_jax_packages():
    assert quaternion.IDENTITY == jquat.IDENTITY
    q = torch.tensor(quaternion.IDENTITY, dtype=torch.float64)
    assert torch.equal(quaternion.identity_like(torch.zeros(4, dtype=torch.float64)), q)
