"""The port's KITTI readers (``io.kitti``, ``io.oxts``, ``io.native.oxts_scan``)
and its checkpoints (``utils.checkpoint``) on the CPU, against the JAX
package's on the same files. The readers are NumPy copies: their outputs are
held equal, the written files byte for byte. The KITTI pose file is
written from the seq-04 golden arrays (no fixture outside the repository is
read).
"""

import os
import subprocess
import sys
from typing import NamedTuple

import numpy as np
import pytest
import torch

import chip_smoke
from gps_optimize_slam_tpu.io import kitti as jkitti
from gps_optimize_slam_tpu.io import native as jnative
from gps_optimize_slam_tpu.io import oxts as joxts
from gps_optimize_slam_tpu_torch.io import gps as gps_io
from gps_optimize_slam_tpu_torch.io import kitti, native, oxts
from gps_optimize_slam_tpu_torch.io import tum as tum_io
from gps_optimize_slam_tpu_torch.utils import checkpoint

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)


def write_kitti_files(tmp) -> tuple:
    """``chip_smoke.write_seq04_kitti_files`` and the golden arrays."""
    return (*chip_smoke.write_seq04_kitti_files(tmp), np.load(os.path.join(HERE, "golden", "seq04_golden.npz")))


@pytest.mark.parametrize("use_native", [True, False])
def test_kitti_to_tum_file_matches_jax(tmp_path, monkeypatch, use_native):
    poses_path, times_path, g = write_kitti_files(str(tmp_path))
    if not use_native:
        monkeypatch.setattr(native, "_get_lib", lambda: None)
    got, want = str(tmp_path / "port.tum"), str(tmp_path / "jax.tum")
    kitti.kitti_to_tum_file(poses_path, times_path, got)
    jkitti.kitti_to_tum_file(poses_path, times_path, want)
    assert open(got).read() == open(want).read()
    traj = kitti.kitti_to_trajectory(poses_path, times_path)
    jtraj = jkitti.kitti_to_trajectory(poses_path, times_path)
    for k in ("timestamps", "positions", "quaternions"):
        np.testing.assert_array_equal(traj[k], jtraj[k])
    np.testing.assert_allclose(traj["positions"], g["slam_pos"], atol=1e-9)
    dots = np.abs(np.sum(traj["quaternions"] * g["slam_quat"], axis=-1))
    np.testing.assert_allclose(dots, 1.0, atol=1e-9)
    assert (traj["quaternions"][:, 3] >= 0).all()
    back = tum_io.read_tum(got)
    np.testing.assert_allclose(back["positions"], g["slam_pos"], atol=1e-6)


def test_kitti_readers_refuse_what_jax_refuses(tmp_path):
    poses_path, times_path, _ = write_kitti_files(str(tmp_path))
    bad = tmp_path / "bad.txt"
    np.savetxt(bad, np.zeros((3, 11)))
    with pytest.raises(ValueError, match="12 columns"):
        kitti.read_kitti_poses(str(bad))
    short = tmp_path / "short.txt"
    np.savetxt(short, np.arange(5.0))
    with pytest.raises(ValueError, match="same number of rows"):
        kitti.kitti_to_trajectory(poses_path, str(short))
    one = tmp_path / "one.txt"
    np.savetxt(one, np.eye(3, 4).reshape(1, 12))
    assert kitti.read_kitti_poses(str(one)).shape == (1, 3, 4)


def write_oxts_folder(root, n_frames=3, hole=None, multi=None, seed=None):
    """An oxts folder: timestamps.txt and data/%010d.txt rows of 30 columns
    (lat lon alt ... numsats at 25, velmode at 27); ``hole`` a frame without
    a file, ``multi`` a frame file of two rows; random rows from ``seed``."""
    d = root / "oxts"
    (d / "data").mkdir(parents=True)
    base = ["2011-09-30 11:50:40.354663000", "2011-09-30 11:50:40.457765000", "2011-09-30 11:50:40.561034000"]
    stamps = [base[i % 3].replace("40.", f"{40 + i // 3}.") for i in range(n_frames)]
    (d / "timestamps.txt").write_text("\n".join(stamps) + "\n")
    rng = np.random.default_rng(seed) if seed is not None else None
    for i in range(n_frames):
        if i == hole:
            continue
        rows = 2 if i == multi else 1
        if rng is not None:
            block = rng.normal(size=(rows, 30))
        else:
            block = np.zeros((rows, 30))
            block[:, 0], block[:, 1], block[:, 2], block[:, 25], block[:, 27] = 49.03 + i * 1e-5, 8.39, 112.0, 4, 5
        np.savetxt(d / "data" / f"{i:010d}.txt", block)
    return d


def test_oxts_extract_roundtrip_in_both_offset_modes(tmp_path):
    """The JAX package's roundtrip (tests/test_io.py), on the port and held
    equal to the JAX package's output."""
    d = write_oxts_folder(tmp_path)
    out = oxts.extract_oxts(str(d), time_offset=0.5, cumulative_offset=True)
    diffs = np.diff(out["timestamps"])
    assert out["timestamps"][0] == 0.5  # the reference (Q3): ts[0] = offset, each step re-adds it
    assert np.all(diffs > 0.5)
    assert np.all(out["numsats"] == 4) and np.all(out["velmode"] == 5)
    out2 = oxts.extract_oxts(str(d), time_offset=0.5, cumulative_offset=False)
    assert np.all(np.abs(np.diff(out2["timestamps"]) - 0.103) < 5e-3)  # the offset applied once
    for cumulative, got in ((True, out), (False, out2)):
        want = joxts.extract_oxts(str(d), time_offset=0.5, cumulative_offset=cumulative)
        assert list(got) == list(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])
    f, jf = str(tmp_path / "combined.txt"), str(tmp_path / "jax_combined.txt")
    oxts.extract_oxts(str(d), time_offset=0.0, output_file=f)
    joxts.extract_oxts(str(d), time_offset=0.0, output_file=jf)
    assert open(f).read() == open(jf).read()
    reread = gps_io.read_gps_fixes(f)
    assert reread["valid"].all() and len(reread["timestamps"]) == 3


@pytest.mark.parametrize("use_native", [True, False])
def test_oxts_with_holes_and_multi_row_frames_matches_jax(tmp_path, monkeypatch, use_native):
    """A missing frame file is skipped and a two-row frame gives two fixes at
    its frame's time, through the native scanner and through the per-file
    loop alike."""
    d = write_oxts_folder(tmp_path, n_frames=7, hole=3, multi=5, seed=0)
    want = joxts.extract_oxts(str(d), time_offset=0.1)
    if not use_native:
        monkeypatch.setattr(native, "oxts_scan", lambda *a: None)
    got = oxts.extract_oxts(str(d), time_offset=0.1)
    assert len(got["timestamps"]) == 7 and got["timestamps"][4] == got["timestamps"][5]  # frame 5, after the hole
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


def test_native_oxts_scan_matches_the_files_and_jax(tmp_path):
    """The C directory scanner returns exactly the rows np.loadtxt reads,
    holes and multi-row frames included, as the JAX package's binding does."""
    if not native._get_lib():
        pytest.skip("the native parser (native/libfastparse.so) is not built")
    d = write_oxts_folder(tmp_path, n_frames=7, hole=3, multi=5, seed=0)
    expect = []
    for i in range(7):
        f = d / "data" / f"{i:010d}.txt"
        if f.exists():
            for r in np.atleast_2d(np.loadtxt(f)):
                expect.append([i, r[0], r[1], r[2], r[25], r[27]])
    got = native.oxts_scan(str(d / "data"), 7)
    np.testing.assert_array_equal(got, np.asarray(expect))
    np.testing.assert_array_equal(got, jnative.oxts_scan(str(d / "data"), 7))
    assert native.oxts_scan(str(d / "data"), 3).shape == (3, 6)  # frames 0-2 only
    (d / "data" / f"{7:010d}.txt").write_text("1 2 x\n")
    with pytest.raises(ValueError, match="fastparse_oxts_dir"):
        native.oxts_scan(str(d / "data"), 8)


class Pair(NamedTuple):
    a: torch.Tensor
    b: np.ndarray


def test_checkpoint_roundtrip(tmp_path):
    """The JAX package's roundtrip (tests/test_io.py) on the port, and the
    containers the port's callers save: NamedTuples (stored as dicts),
    tensors, NumPy arrays and 0-d values; the metadata file comes last."""
    state = {"pos": np.arange(12.0).reshape(4, 3), "q": np.ones((4, 4))}
    p = str(tmp_path / "ck")
    checkpoint.save_checkpoint(p, state, {"note": "round1"})
    restored, meta = checkpoint.restore_checkpoint(p, {"pos": np.zeros((4, 3)), "q": np.zeros((4, 4))})
    np.testing.assert_array_equal(restored["pos"], state["pos"])
    assert isinstance(restored["pos"], np.ndarray) and meta == {"note": "round1"}
    assert sorted(os.listdir(p)) == ["metadata.json", "state"]

    pair = Pair(torch.arange(6.0, dtype=torch.float64).reshape(2, 3), np.array(True))
    q = str(tmp_path / "pair")
    checkpoint.save_checkpoint(q, {"x": pair, "steps": 3, "costs": [1.5, 0.25]})
    raw, meta = checkpoint.restore_checkpoint_untyped(q)
    assert meta is None and raw["steps"] == 3 and raw["costs"] == [1.5, 0.25]
    assert set(raw["x"]) == {"a", "b"} and torch.equal(raw["x"]["a"], pair.a)
    typed, _ = checkpoint.restore_checkpoint(q, {"x": Pair(torch.zeros(2, 3), np.zeros(())), "steps": 0,
                                                 "costs": []})
    assert isinstance(typed["x"], Pair) and torch.equal(typed["x"].a, pair.a) and typed["x"].b.item() is True
    # A checkpoint is rewritten in place; the reader loads no pickled code.
    checkpoint.save_checkpoint(q, {"steps": 4}, {"done": True})
    assert checkpoint.restore_checkpoint_untyped(q) == ({"steps": 4}, {"done": True})


def test_new_modules_import_no_jax():
    """The pose graph, the KITTI readers, the checkpoints and the command
    line import nothing of JAX or of the JAX package."""
    modules = ["gps_optimize_slam_tpu_torch.models.pose_graph", "gps_optimize_slam_tpu_torch.io.kitti",
               "gps_optimize_slam_tpu_torch.io.oxts", "gps_optimize_slam_tpu_torch.utils.checkpoint",
               "gps_optimize_slam_tpu_torch.pipeline", "gps_optimize_slam_tpu_torch.cli"]
    code = (
        "import importlib, sys\n"
        f"for m in {modules!r}: importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'jaxlib', "
        "'gps_optimize_slam_tpu.')) or m == 'gps_optimize_slam_tpu')\n"
        "assert 'jax' not in sys.modules and not bad, bad\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                          env={**os.environ, "PYTHONPATH": REPO})
    assert proc.returncode == 0, proc.stderr
