"""The out-of-core fusion path of the port (``models.fusion_chunked`` and
``pipeline.fuse_files_chunked``) against the JAX package and against the
port's own in-core path, CPU float64; and the rule that the port's entry
points run on the card unless the caller asks for the CPU.

Tolerances: ``fuse_core_chunked`` against JAX's (JAX's RANSAC draws
injected) ≤1e-8 m, quaternions and scale ≤1e-10; ``evaluate_chunked``
against JAX's every statistic ≤1e-9; chunked against the port's in-core
fusion ≤1e-10 m on the same draws (the scans re-enter exactly; only the
association order differs); ``fuse_files_chunked`` on seq-04 against the
in-core ``fuse_files`` ≤1e-8 m, and its export reads back within the
format's rounding. The fused trajectory written into given ``np.memmap``
buffers and the Sim3 trajectory of ``return_sim3_trajectory`` against
JAX's, with and without the robust gate: the same bounds, the Sim3
trajectory ≤1e-8 m and quaternions ≤1e-10.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

import chip_smoke
from gps_optimize_slam_tpu.config import FusionConfig as JFusionConfig
from gps_optimize_slam_tpu.models import fusion_chunked as jfc
from gps_optimize_slam_tpu.ops import alignment_chunked as jac
from gps_optimize_slam_tpu_torch import pipeline
from gps_optimize_slam_tpu_torch.config import FusionConfig, config_from_dict
from gps_optimize_slam_tpu_torch.io import tum
from gps_optimize_slam_tpu_torch.models import fusion, fusion_chunked
from gps_optimize_slam_tpu_torch.ops.umeyama import Sim3
from gps_optimize_slam_tpu_torch.utils.device import resolve_device
from tests.test_fusion_chunked import _scenario
from tests.test_torch_ransac_alignment import jax_sim3_draws

PARTS = ("nn_slam", "nn_sim3", "nn_ekf", "ate_sim3", "ate_ekf")
STATS = ("mean", "median", "rmse", "max")


@pytest.fixture(scope="module")
def jax_chunked():
    """JAX's chunked fusion of the e2e scenario (chunk 159: three full
    chunks and a padded one; halo 24) and the Sim(3) draws it made."""
    (st, sp, sq), (gt, gp, gv) = _scenario(seed=1)
    jcfg = JFusionConfig()
    key = jax.random.PRNGKey(0)
    out = jfc.fuse_core_chunked(st, sp, sq, gt, gp, gv, key=key, config=jcfg, chunk_size=159, halo=24)
    _, valid = jac.align_gps_to_slam_chunked(st, gt, gp, gps_valid=gv, chunk_size=159, halo=24)
    window = jac.sim3_window_mask_host(st, valid, 5.0, 180.0, 4)
    draws = jax_sim3_draws(key, np.ones(int(window.sum()), bool), jcfg.sim3_ransac)
    return (st, sp, sq, gt, gp, gv), config_from_dict(dataclasses.asdict(jcfg)), out, draws


def test_fuse_core_chunked_matches_jax(jax_chunked):
    (st, sp, sq, gt, gp, gv), cfg, want, draws = jax_chunked
    got = fusion_chunked.fuse_core_chunked(
        st, sp, sq, gt, gp, gv, config=cfg, chunk_size=159, halo=24,
        sim3_draws=torch.tensor(draws), device="cpu",
    )
    assert got.ok and want.ok and got.num_inliers == want.num_inliers
    np.testing.assert_array_equal(got.gps_valid, want.gps_valid)
    np.testing.assert_allclose(got.corrected_pos, want.corrected_pos, atol=1e-8, rtol=0)
    np.testing.assert_allclose(got.corrected_quat, want.corrected_quat, atol=1e-10, rtol=0)
    assert abs(float(got.sim3.scale) - float(want.sim3.scale)) <= 1e-10
    v = got.gps_valid
    np.testing.assert_allclose(got.aligned_gps[v], want.aligned_gps[v], atol=1e-10, rtol=0)


@pytest.mark.parametrize("robust", [False, True])
def test_fuse_core_chunked_writes_given_buffers_and_returns_the_sim3_trajectory(jax_chunked, tmp_path, robust):
    """``out_pos``/``out_quat`` (memory-mapped ``.npy`` files here) receive
    the fused trajectory through ``fuse_ekf_rts_chunked`` or, with the
    robust gate, ``fuse_robust_chunked``; ``return_sim3_trajectory=True``
    adds the Sim3-transformed trajectory; both as JAX's."""
    (st, sp, sq, gt, gp, gv), cfg, _, draws = jax_chunked
    n = len(st)

    def buffers(tag):
        return tuple(np.lib.format.open_memmap(tmp_path / f"{tag}_{k}.npy", mode="w+", dtype=np.float64,
                                               shape=(n, k)) for k in (3, 4))

    jpos, jquat = buffers("jax")
    want, (want_sp, want_sq) = jfc.fuse_core_chunked(
        st, sp, sq, gt, gp, gv, key=jax.random.PRNGKey(0), config=JFusionConfig(), chunk_size=159, halo=24,
        out_pos=jpos, out_quat=jquat, return_sim3_trajectory=True, robust=robust,
    )
    pos, quat = buffers("port")
    got, (got_sp, got_sq) = fusion_chunked.fuse_core_chunked(
        st, sp, sq, gt, gp, gv, config=cfg, chunk_size=159, halo=24, sim3_draws=torch.tensor(draws),
        device="cpu", out_pos=pos, out_quat=quat, return_sim3_trajectory=True, robust=robust,
    )
    assert got.corrected_pos is pos and got.corrected_quat is quat
    pos.flush()
    np.testing.assert_array_equal(np.load(tmp_path / "port_3.npy"), got.corrected_pos)
    np.testing.assert_allclose(got.corrected_pos, want.corrected_pos, atol=1e-8, rtol=0)
    np.testing.assert_allclose(got.corrected_quat, want.corrected_quat, atol=1e-10, rtol=0)
    np.testing.assert_allclose(got_sp, want_sp, atol=1e-8, rtol=0)
    np.testing.assert_allclose(got_sq, want_sq, atol=1e-10, rtol=0)
    if robust:
        np.testing.assert_array_equal(got.robust_accepted, want.robust_accepted)


def test_evaluate_chunked_matches_jax(jax_chunked):
    (st, sp, sq, *_), _, jres, _ = jax_chunked
    want = jfc.evaluate_chunked(st, sp, sq, jres, chunk_size=131)
    res = fusion_chunked.ChunkedFusionResult(
        corrected_pos=jres.corrected_pos, corrected_quat=jres.corrected_quat,
        sim3=Sim3(*(torch.tensor(np.asarray(x)) for x in jres.sim3)),
        aligned_gps=jres.aligned_gps, gps_valid=jres.gps_valid,
        num_inliers=jres.num_inliers, ok=True,
    )
    # chunk 131: trajectory and candidate streams split mid-gate, padded tails.
    got = fusion_chunked.evaluate_chunked(st, sp, sq, res, chunk_size=131, device="cpu")
    for part in PARTS:
        g, w = getattr(got, part), getattr(want, part)
        assert int(g.count) == int(w.count) > 0, part
        for stat in STATS:
            assert abs(float(getattr(g, stat)) - float(getattr(w, stat))) <= 1e-9, (part, stat)


def test_nn_errors_streamed_writes_a_given_buffer_as_jax(jax_chunked, tmp_path):
    """``out`` (a memory-mapped ``.npy`` file) receives the streamed NN
    distances and is what is returned, as JAX's with ``out``: 131-row
    blocks split the queries and candidates mid-gate with padded tails, an
    unfilled buffer is written in every row (+inf for invalid points)."""
    (st, sp, sq, *_), _, jres, _ = jax_chunked
    n = len(st)
    gate = np.asarray(jres.gps_valid, bool) & (st > st[0] + 5.0)
    cands = np.asarray(jres.aligned_gps)

    def traj(a, b):
        return np.asarray(jres.corrected_pos)[a:b]

    jout = np.lib.format.open_memmap(tmp_path / "jax.npy", mode="w+", dtype=np.float64, shape=(n,))
    want = jfc.nn_errors_streamed(traj, n, cands, gate, gate, chunk_size=131, out=jout)
    out = np.lib.format.open_memmap(tmp_path / "port.npy", mode="w+", dtype=np.float64, shape=(n,))
    out[:] = np.nan  # every row is written
    got = fusion_chunked.nn_errors_streamed(traj, n, cands, gate, gate, chunk_size=131, out=out, device="cpu")
    assert got is out and want is jout
    out.flush()
    back = np.load(tmp_path / "port.npy")
    np.testing.assert_array_equal(back, got)
    assert np.isinf(back[~gate]).all() and np.isfinite(back[gate]).all()
    np.testing.assert_allclose(back[gate], np.asarray(want)[gate], atol=1e-12, rtol=0)
    np.testing.assert_array_equal(back, fusion_chunked.nn_errors_streamed(traj, n, cands, gate, gate,
                                                                          chunk_size=131, device="cpu"))


@pytest.mark.parametrize("rts_mode", ["outage", "full"])
def test_fuse_core_chunked_matches_the_in_core_port(rts_mode):
    (st, sp, sq), (gt, gp, gv) = _scenario(seed=1)
    cfg = FusionConfig(platform="gpu", rts_mode=rts_mode)  # the parallel scans, on CPU tensors
    ref = fusion.fuse_core(*(torch.tensor(x) for x in (st, sp, sq, gt, gp, gv)), cfg, seed=3)
    got = fusion_chunked.fuse_core_chunked(st, sp, sq, gt, gp, gv, seed=3, config=cfg,
                                           chunk_size=100, halo=24, device="cpu")
    sim3_pos, _ = fusion_chunked.transform_trajectory_chunked(sp, sq, got.sim3, chunk_size=100,
                                                              device="cpu")
    assert got.ok and bool(ref.ok)
    np.testing.assert_array_equal(got.gps_valid, ref.gps_valid.numpy())
    np.testing.assert_allclose(got.corrected_pos, ref.corrected_pos.numpy(), atol=1e-10, rtol=0)
    np.testing.assert_allclose(got.corrected_quat, ref.corrected_quat.numpy(), atol=1e-12, rtol=0)
    np.testing.assert_allclose(sim3_pos, ref.sim3_pos.numpy(), atol=1e-10, rtol=0)
    ev_in = fusion.evaluate(torch.tensor(st), torch.tensor(sp), ref)
    ev = fusion_chunked.evaluate_chunked(st, sp, sq, got, chunk_size=100, device="cpu")
    for part in PARTS:
        for stat in STATS:
            want = float(getattr(getattr(ev_in, part), stat))
            assert abs(float(getattr(getattr(ev, part), stat)) - want) <= 1e-9, (part, stat)


def test_fuse_files_chunked_matches_in_core_fuse_files(tmp_path):
    slam_path, gps_path = chip_smoke.write_seq04_files(str(tmp_path))
    cfg = FusionConfig(platform="gpu")  # the in-core run takes the parallel scans too
    res = pipeline.fuse_files_chunked(slam_path, gps_path, config=cfg, chunk_size=100, device="cpu")
    ref = pipeline.fuse_files(slam_path, gps_path, config=cfg, device="cpu")
    assert res.gps.valid.all() and res.corrected_pos.shape == (271, 3)
    np.testing.assert_allclose(res.corrected_pos, ref.corrected_pos, atol=1e-8, rtol=0)
    np.testing.assert_allclose(res.corrected_quat, ref.corrected_quat, atol=1e-10, rtol=0)
    assert abs(res.sim3_scale - ref.sim3_scale) <= 1e-10
    assert abs(float(res.evaluation.nn_ekf.rmse) - float(ref.evaluation.nn_ekf.rmse)) <= 1e-8
    assert "scale=0.98" in res.summary() and "(chunked/out-of-core)" in res.summary()
    out = str(tmp_path / "fused_chunked.tum")
    pipeline.export_result(res, out, str(tmp_path / "fused_chunked_wgs84.txt"))
    back = tum.read_tum(out)
    np.testing.assert_array_equal(back["timestamps"], res.slam["timestamps"])
    # %.6f rounds by at most 5e-7 m; parsing it back at 5.4e6 m adds ulps.
    np.testing.assert_allclose(back["positions"], res.corrected_pos, atol=6e-7, rtol=0)
    np.testing.assert_allclose(back["quaternions"], res.corrected_quat, atol=5e-9, rtol=0)


def test_entry_points_raise_without_a_card(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device(None)
    assert resolve_device("cpu") == torch.device("cpu")
    g = np.load(chip_smoke.GOLDEN)
    slam = {"timestamps": g["slam_times"], "positions": g["slam_pos"], "quaternions": g["slam_quat"]}
    gps = pipeline.GPSData(timestamps=g["gps_times"], positions=g["gps_utm"], valid=np.ones(279, bool),
                           frame="utm", utm_zone=32, utm_south=False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pipeline.fuse_arrays(slam, gps)
    slam_path, gps_path = chip_smoke.write_seq04_files(str(tmp_path))
    for call in (lambda: pipeline.fuse_files(slam_path, gps_path),
                 lambda: pipeline.fuse_files_chunked(slam_path, gps_path),
                 lambda: fusion_chunked.fuse_core_chunked(
                     g["slam_times"], g["slam_pos"], g["slam_quat"], g["gps_times"], g["gps_utm"])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


def test_unported_options_raise(tmp_path):
    """The ground-truth evaluation and the robust gate run out of core now;
    what the chunked path still refuses is transition blending, which no
    associative scan covers."""
    slam_path, gps_path = chip_smoke.write_seq04_files(str(tmp_path))
    # 128-pose chunks: a default 262,144-pose chunk would pad seq-04's 271
    # poses a thousandfold on the CPU.
    res = pipeline.fuse_files_chunked(slam_path, gps_path, gt_path=chip_smoke.write_seq04_gt_file(str(tmp_path)),
                                      robust=True, device="cpu", chunk_size=128)
    assert res.gt_evaluation is not None and res.result.robust_accepted is not None
    blending = FusionConfig(rts_decision=dataclasses.replace(
        FusionConfig().rts_decision, default_ekf_transition_steps_on_sharp_turn=3))
    with pytest.raises(ValueError, match="hard updates"):
        pipeline.fuse_files_chunked(slam_path, gps_path, config=blending, device="cpu", chunk_size=128)
    with pytest.raises(ValueError, match="hard updates"):
        pipeline.fuse_files_chunked(slam_path, gps_path, config=blending, robust=True, device="cpu", chunk_size=128)
