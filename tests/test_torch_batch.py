"""Batched multi-sequence fusion of the port (``parallel.batch``,
``parallel.mesh``, the batch axis through ``fuse_core`` and ``evaluate``,
and the ``fuse-batch`` command) on the CPU in float64, against the JAX
package's ``parallel.batch`` and ``parallel.mesh`` and against the port's
own single-row calls.

Tolerances: ≤1e-8 m (positions) and ≤1e-10 (scale) against JAX, whose draws
are replayed (the port runs the parallel filter through the plain K1
ladder, JAX the sequential filter, as ``test_torch_slice.py`` compares
them); ≤1e-9 m row against the port's single-row ``fuse_core`` (JAX's own
bound for a row of its batch against its single call); ≤1e-6 m against
``tests/golden/seq04_golden.npz``. The JAX oracles run once, in
module-scoped fixtures, at one shared shape.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from gps_optimize_slam_tpu import cli as jcli
from gps_optimize_slam_tpu.parallel import batch as jbatch
from gps_optimize_slam_tpu.parallel import mesh as jmesh
from gps_optimize_slam_tpu_torch import cli
from gps_optimize_slam_tpu_torch.config import FusionConfig, Sim3RansacConfig
from gps_optimize_slam_tpu_torch.models import fusion
from gps_optimize_slam_tpu_torch.ops import alignment, ransac
from gps_optimize_slam_tpu_torch.parallel import batch as pbatch
from gps_optimize_slam_tpu_torch.parallel import mesh
from tests.test_parallel import make_sequences

HERE = os.path.dirname(os.path.abspath(__file__))
PARTS = ("nn_slam", "nn_sim3", "nn_ekf", "ate_sim3", "ate_ekf")
STATS = ("mean", "median", "rmse", "max", "count")
GPU_LADDER = FusionConfig(platform="gpu")  # the parallel filter, through the plain K1 ladder on CPU tensors


@pytest.fixture(scope="module")
def seqs():
    return make_sequences(n_seqs=4, base_n=60)


@pytest.fixture(scope="module")
def padded(seqs):
    return pbatch.pad_batch(*seqs)


def window_counts(b) -> list:
    """Each row's Sim(3) window size, the bound of its RANSAC draws."""
    t = {k: torch.as_tensor(v) for k, v in b._asdict().items()}
    al = alignment.align_gps_to_slam(t["slam_times"], t["gps_times"], t["gps_pos"], gps_valid=t["gps_valid"],
                                     assume_sorted=True)
    valid = al.valid & t["slam_mask"]
    cfg = FusionConfig()
    window = alignment.sim3_window_mask(t["slam_times"], valid, cfg.time_alignment.max_gps_gap_threshold,
                                        cfg.sim3_ransac.max_initial_duration, cfg.sim3_ransac.min_samples)
    return window.sum(-1).tolist()


def jax_draws(seed: int, n_window: int, trials: int = 1000) -> torch.Tensor:
    """The (trials, 4) draws JAX's fuse_core makes from PRNGKey(seed)."""
    keys = jax.random.split(jax.random.PRNGKey(seed), trials)
    hi = max(n_window, 1)
    return torch.tensor(np.asarray(jax.vmap(lambda k: jax.random.randint(k, (4,), 0, hi))(keys)))


@pytest.fixture(scope="module")
def jax_oracle(seqs):
    jb = jbatch.pad_batch(*seqs)
    keys = jax.vmap(jax.random.PRNGKey)(jnp.arange(4))
    out = jmesh.fuse_batch(jb, keys, dtype=jnp.float64)
    return jb, out, jmesh.evaluate_batch(jb, out), jmesh.estimate_offsets_batch(jb, dtype=jnp.float64)


@pytest.fixture(scope="module")
def port_run(padded):
    counts = window_counts(padded)
    draws = torch.stack([jax_draws(i, counts[i]) for i in range(4)])
    out = mesh.fuse_batch(padded, config=GPU_LADDER, device="cpu", sim3_draws=draws)
    return draws, out, mesh.evaluate_batch(padded, out)


def test_pad_batch_and_buckets_equal_jax():
    slams, gts, gps_list, valids = make_sequences(n_seqs=6, base_n=30)
    for got, want in ((pbatch.pad_batch(slams, gts, gps_list, valids), jbatch.pad_batch(slams, gts, gps_list, valids)),
                      (pbatch.pad_batch(slams[:2], gts[:2], gps_list[:2], None, pad_multiple=16, pad_dt=0.5),
                       jbatch.pad_batch(slams[:2], gts[:2], gps_list[:2], None, pad_multiple=16, pad_dt=0.5))):
        for name in pbatch.SequenceBatch._fields:
            a, b = getattr(got, name), np.asarray(getattr(want, name))
            assert a.dtype == b.dtype, name
            np.testing.assert_array_equal(a, b, err_msg=name)
    # Padding repeats the last pose with strictly increasing times and
    # leaves padded GNSS invalid.
    st = got.slam_times[0]
    assert np.all(np.diff(st) > 0) and not got.gps_valid[0, got.n_gps[0]:].any()
    for waste in (1.1, 2.0, 5.0):
        mine = pbatch.bucket_by_length(slams, gts, gps_list, valids, max_waste=waste)
        theirs = jbatch.bucket_by_length(slams, gts, gps_list, valids, max_waste=waste)
        assert len(mine) == len(theirs) and (waste > 2.0) == (len(mine) == 1)
        for (i0, b0), (i1, b1) in zip(mine, theirs):
            np.testing.assert_array_equal(i0, i1)
            for name in pbatch.SequenceBatch._fields:
                np.testing.assert_array_equal(getattr(b0, name), np.asarray(getattr(b1, name)))


def test_fuse_batch_matches_jax(jax_oracle, port_run):
    _, jout, _, _ = jax_oracle
    _, out, _ = port_run
    assert out.corrected_pos.shape == (4, 104, 3) and out.sim3.R.shape == (4, 3, 3)
    assert bool(out.ok.all()) and bool(np.asarray(jout.ok).all())
    for name in ("gps_valid", "sim3_inliers"):
        np.testing.assert_array_equal(getattr(out, name).numpy(), np.asarray(getattr(jout, name)), err_msg=name)
    for name in ("corrected_pos", "sim3_pos", "aligned_gps"):
        np.testing.assert_allclose(getattr(out, name).numpy(), np.asarray(getattr(jout, name)), atol=1e-8,
                                   rtol=0, err_msg=name)
    np.testing.assert_allclose(out.corrected_quat.numpy(), np.asarray(jout.corrected_quat), atol=1e-10)
    np.testing.assert_allclose(out.sim3.scale.numpy(), np.asarray(jout.sim3.scale), atol=1e-10, rtol=0)


def test_evaluate_batch_matches_jax(jax_oracle, port_run):
    _, _, jev, _ = jax_oracle
    _, _, ev = port_run
    for part in PARTS:
        for stat in STATS:
            got, want = getattr(getattr(ev, part), stat).numpy(), np.asarray(getattr(getattr(jev, part), stat))
            assert got.shape == (4,)
            np.testing.assert_allclose(got, want, atol=1e-8, rtol=0, err_msg=f"{part}.{stat}")
    assert (ev.nn_ekf.count > 5).all() and (ev.nn_ekf.rmse < 1.0).all()


@pytest.mark.parametrize("platform", ["cpu", "gpu"])
def test_rows_match_the_single_row_fuse_core(seqs, padded, port_run, platform):
    """platform="cpu" takes the sequential filter (a row at a time), "gpu"
    the parallel scans on (L, B, n) leaves."""
    slams, gts, gps_list, valids = seqs
    draws, gpu_out, _ = port_run
    cfg = FusionConfig(platform=platform)
    out = gpu_out if platform == "gpu" else mesh.fuse_batch(padded, config=cfg, device="cpu", sim3_draws=draws)
    ev = mesh.evaluate_batch(padded, out)
    for i in range(4):
        t = [torch.as_tensor(a) for a in (slams[i]["timestamps"], slams[i]["positions"], slams[i]["quaternions"],
                                         gts[i], gps_list[i], valids[i])]
        single = fusion.fuse_core(*t, cfg, sim3_draws=draws[i])
        n = len(t[0])
        for name in ("corrected_pos", "sim3_pos"):
            err = float((getattr(out, name)[i, :n] - getattr(single, name)).abs().max())
            assert err <= 1e-9, (name, i, err)
        assert torch.equal(out.sim3_inliers[i, :n], single.sim3_inliers)
        assert torch.equal(out.gps_valid[i, :n], single.gps_valid) and not out.gps_valid[i, n:].any()
        assert abs(float(out.sim3.scale[i] - single.sim3.scale)) <= 1e-12
        sev = fusion.evaluate(t[0], t[1], single)
        for part in PARTS:
            for stat in STATS:
                got, want = float(getattr(getattr(ev, part), stat)[i]), float(getattr(getattr(sev, part), stat))
                assert abs(got - want) <= 1e-9 * max(1.0, abs(want)), (part, stat, i)


def test_seq04_in_a_batch_keeps_golden_parity():
    g = np.load(os.path.join(HERE, "golden", "seq04_golden.npz"))
    slam = {"timestamps": g["slam_times"], "positions": g["slam_pos"], "quaternions": g["slam_quat"]}
    s2, g2t, g2p, g2v = make_sequences(n_seqs=1, base_n=100)
    b = pbatch.pad_batch([slam] + s2, [g["gps_times"]] + g2t, [g["gps_utm"]] + g2p,
                         [np.ones(len(g["gps_times"]), bool)] + g2v)
    out = mesh.fuse_batch(b, config=GPU_LADDER, device="cpu")
    n = len(slam["timestamps"])
    assert bool(out.ok.all())
    assert float(np.abs(out.corrected_pos[0, :n].numpy() - g["corrected_pos"]).max()) <= 1e-6


def test_time_offsets_undo_a_shifted_clock(seqs, padded):
    slams, gts, gps_list, valids = seqs
    shift = 0.7
    moved = pbatch.pad_batch(slams, [t + (shift if i == 1 else 0.0) for i, t in enumerate(gts)], gps_list, valids)
    base = mesh.fuse_batch(padded, config=GPU_LADDER, device="cpu")
    fixed = mesh.fuse_batch(moved, config=GPU_LADDER, device="cpu", time_offsets=np.array([0.0, -shift, 0.0, 0.0]))
    off = mesh.fuse_batch(moved, config=GPU_LADDER, device="cpu")
    err = float((fixed.corrected_pos - base.corrected_pos).abs().max())
    assert err <= 1e-8, err
    assert torch.equal(fixed.gps_valid, base.gps_valid)
    # Unrepaired, the shifted row's alignment moves and the others do not.
    assert float((off.aligned_gps[1] - base.aligned_gps[1]).nan_to_num().abs().max()) > 0.1
    assert torch.equal(off.corrected_pos[[0, 2, 3]], base.corrected_pos[[0, 2, 3]])


def test_estimate_offsets_batch_matches_jax(seqs, padded, jax_oracle):
    _, _, _, want = jax_oracle
    got = mesh.estimate_offsets_batch(padded, device="cpu")
    assert got.shape == (4,)
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-9, rtol=0)
    for i, s in enumerate(seqs[0]):  # each row is the single-row estimate
        one = alignment.estimate_time_offset_xcorr_device(
            torch.as_tensor(s["timestamps"]), torch.as_tensor(s["positions"]), torch.as_tensor(seqs[1][i]),
            torch.as_tensor(seqs[2][i]), gps_valid=torch.as_tensor(seqs[3][i]))
        assert abs(float(one) - got[i]) <= 1e-9


def test_stage_batch_sortedness_matches_jax(seqs, padded):
    keys = np.zeros((4, 2), np.uint32)
    assert mesh.stage_batch(padded, device="cpu").gps_sorted
    assert jmesh.stage_batch(jbatch.pad_batch(*seqs), keys).gps_sorted
    slams, gts, gps_list, valids = seqs
    swap = [5, 6], [6, 5]  # two fixes of row 2 out of time order
    times, positions = [t.copy() for t in gts], [p.copy() for p in gps_list]
    times[2][swap[0]], positions[2][swap[0]] = times[2][swap[1]], positions[2][swap[1]]
    staged = mesh.stage_batch(pbatch.pad_batch(slams, times, positions, valids), seeds=[7, 8, 9, 10], device="cpu")
    assert not staged.gps_sorted and staged.seeds == (7, 8, 9, 10)
    assert not jmesh.stage_batch(jbatch.pad_batch(slams, times, positions, valids), keys).gps_sorted
    # The unsorted row is sorted by the alignment: the same fusion.
    a = mesh.fuse_batch(staged, config=GPU_LADDER)
    b = mesh.fuse_batch(padded, seeds=[7, 8, 9, 10], config=GPU_LADDER, device="cpu")
    assert float((a.corrected_pos - b.corrected_pos).abs().max()) <= 1e-12


def test_fuse_buckets_returns_the_original_order_sliced():
    slams, gts, gps_list, valids = make_sequences(n_seqs=4, base_n=60)
    perm = [2, 0, 3, 1]
    slams, gts, gps_list, valids = ([x[i] for i in perm] for x in (slams, gts, gps_list, valids))
    buckets = pbatch.bucket_by_length(slams, gts, gps_list, valids, max_waste=1.3)
    assert len(buckets) == 2
    seeds = [11, 12, 13, 14]
    res = mesh.fuse_buckets(buckets, seeds, config=GPU_LADDER, device="cpu")
    for i, r in enumerate(res):
        n = len(slams[i]["timestamps"])
        assert r.corrected_pos.shape == (n, 3) and r.sim3_inliers.shape == (n,) and r.sim3.R.shape == (3, 3)
        assert isinstance(r.corrected_pos, np.ndarray) and bool(r.ok)
        single = fusion.fuse_core(*(torch.as_tensor(a) for a in (
            slams[i]["timestamps"], slams[i]["positions"], slams[i]["quaternions"], gts[i], gps_list[i],
            valids[i])), GPU_LADDER, seed=seeds[i])
        assert np.abs(r.corrected_pos - single.corrected_pos.numpy()).max() <= 1e-9
        np.testing.assert_array_equal(r.sim3_inliers, single.sim3_inliers.numpy())


def test_adaptive_stopping_runs_the_chunks_the_neediest_row_needs(monkeypatch):
    """Under ``stop_probability`` a batch runs chunks while any row needs one
    (JAX's vmapped while_loop): as many as the neediest row alone, and a
    row that stopped earlier keeps its own result."""
    rng = np.random.default_rng(4)
    n = 300
    src = np.cumsum(rng.normal(size=(3, n, 3)), 1)
    dst = 0.98 * src + 0.05 * rng.normal(size=(3, n, 3))
    dst[1, ::2] += rng.normal(size=(n // 2, 3)) * 30.0  # half the points gross outliers
    dst[2, ::4] += rng.normal(size=(-(-n // 4), 3)) * 30.0
    src, dst = torch.tensor(src), torch.tensor(dst)
    valid = torch.ones(3, n, dtype=torch.bool)
    cfg = Sim3RansacConfig(max_trials=640, stop_probability=0.999, adaptive_chunk=32)
    calls = []
    real = ransac.ransac_counts
    monkeypatch.setattr(ransac, "ransac_counts", lambda *a: calls.append(a[0].ndim) or real(*a))
    singles = []
    for r in range(3):
        calls.clear()
        singles.append((ransac.sim3_ransac(src[r], dst[r], valid[r], cfg, seed=20 + r), len(calls)))
    calls.clear()
    batched = ransac.sim3_ransac(src, dst, valid, cfg, seed=[20, 21, 22])
    chunks = [c for _, c in singles]
    assert len(calls) == max(chunks) and set(calls) == {3}  # one batched count a chunk
    assert min(chunks) < max(chunks) < 20  # the rows stop at different chunks, early
    for r, (one, _) in enumerate(singles):
        assert torch.equal(batched.inlier_mask[r], one.inlier_mask)
        assert torch.equal(batched.sim3.R[r], one.sim3.R) and torch.equal(batched.sim3.scale[r], one.sim3.scale)


@pytest.fixture(scope="module")
def pair_files(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("batch_cli"))
    slam_path, gps_path = chip_smoke.write_seq04_files(tmp)
    return tmp, f"{slam_path}:{gps_path}"


def test_fuse_batch_command_has_the_jax_keys(pair_files, capsys, monkeypatch):
    tmp, pair = pair_files
    from gps_optimize_slam_tpu.utils import cache as jcache

    monkeypatch.setattr(jcache, "enable_persistent_cache", lambda *a, **k: "")
    argv = ["fuse-batch", pair, pair, "--json", "--seed", "3"]
    assert jcli.main(argv) == 0
    want = json.loads(capsys.readouterr().out)
    out_dir = os.path.join(tmp, "fused")
    assert cli.main(argv + ["--device", "cpu", "-o", out_dir]) == 0
    got = json.loads(capsys.readouterr().out)
    assert list(got) == list(want) == ["sequences", "buckets"] and got["buckets"] == want["buckets"] == 1
    for i, (g, w) in enumerate(zip(got["sequences"], want["sequences"])):
        assert list(g) == list(w) + ["output"]
        assert (g["poses"], g["ok"], g["eval_points"]) == (w["poses"], w["ok"], w["eval_points"]) == (271, True, 222)
        assert abs(g["sim3_scale"] - w["sim3_scale"]) <= 1e-6  # other draws, the same consensus
        assert abs(g["ate_rmse_m"] - w["ate_rmse_m"]) <= 1e-3 and abs(g["ate_rmse_m"] - 0.0839) <= 2e-3
        assert g["output"] == os.path.join(out_dir, f"seq{i:02d}_fused.txt")
        assert np.loadtxt(g["output"]).shape == (271, 8)
    assert cli.main(["fuse-batch", "no-colon-here", "--device", "cpu"]) == 2


def test_entry_points_need_a_card_unless_asked_for_the_cpu(padded, pair_files, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: mesh.fuse_batch(padded), lambda: mesh.stage_batch(padded),
                 lambda: mesh.estimate_offsets_batch(padded), lambda: mesh.fuse_buckets([(np.arange(4), padded)]),
                 lambda: cli.main(["fuse-batch", pair_files[1], "--json"])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
