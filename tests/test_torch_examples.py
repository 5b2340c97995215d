"""The port's examples (``gps_optimize_slam_tpu_torch.examples``) at small
sizes on the CPU (``--device cpu``), each through its ``main``; the
``distributed_launch`` example is tests/test_torch_distributed.py's.
``fuse_kitti04`` runs on the seq-04 files written from
``tests/golden/seq04_golden.npz``; its export must hold ``fuse_files`` of
the same files to the TUM format's rounding (6 decimals: ≤1e-6 m)."""

import numpy as np

import chip_smoke
from gps_optimize_slam_tpu_torch import pipeline
from gps_optimize_slam_tpu_torch.examples import batch_mesh_fusion, fuse_kitti04, out_of_core_1m


def test_fuse_kitti04(tmp_path, capsys):
    slam, gps = chip_smoke.write_seq04_files(str(tmp_path))
    gt = chip_smoke.write_seq04_gt_file(str(tmp_path))
    out_dir = tmp_path / "out"
    fuse_kitti04.main(["--slam", slam, "--gps", gps, "--gt", gt, "--out-dir", str(out_dir), "--device", "cpu"])
    assert "vs GT" in capsys.readouterr().out
    fused = np.loadtxt(out_dir / "fused_traj.txt")
    want = pipeline.fuse_files(slam, gps, frame="utm", gt_path=gt, device="cpu").corrected_pos
    assert np.abs(fused[:, 1:4] - want).max() <= 1e-6
    assert np.loadtxt(out_dir / "fused_wgs84.txt").shape == (271, 8)
    assert (out_dir / "overview.png").stat().st_size > 10_000


def test_batch_mesh_fusion(capsys):
    batch_mesh_fusion.main(["--device", "cpu", "--mesh-size", "3", "--lengths", "120", "130", "300"])
    out = capsys.readouterr().out
    assert "mesh: 3 x ['cpu']" in out and "buckets: [[0, 1], [2]]" in out
    assert all(f"seq {i}: poses={n} " in out and out.count("ok=True") == 3 for i, n in enumerate((120, 130, 300)))


def test_out_of_core(capsys):
    out_of_core_1m.main(["--poses", "10000", "--chunk", "2047", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "10000 poses + 900 raw GNSS fixes through 2047-pose chunks on cpu" in out
    assert "streamed evaluation" in out
