"""The port's command line (``python -m gps_optimize_slam_tpu_torch fuse``)
on seq-04 files written from the golden arrays, on the CPU: its JSON has the
keys of the JAX package's command in the same order, its values are those of
the port's own ``pipeline`` call with the same seed (equal: the same code on
the same inputs), and without ``--device cpu`` and without a card it raises.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import chip_smoke
from gps_optimize_slam_tpu import cli as jcli
from gps_optimize_slam_tpu_torch import cli, pipeline
from gps_optimize_slam_tpu_torch.config import FusionConfig

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("cli"))
    slam_path, gps_path = chip_smoke.write_seq04_files(tmp)
    return slam_path, gps_path, chip_smoke.write_seq04_gt_file(tmp)


def payload(text: str) -> dict:
    return json.loads(text[: text.rindex("}") + 1])


def key_tree(d):
    """The keys of a JSON object, in order, with those of its objects."""
    return [(k, key_tree(v)) if isinstance(v, dict) else k for k, v in d.items()]


def stats(s) -> dict:
    return {"mean_m": float(s.mean), "median_m": float(s.median), "rmse_m": float(s.rmse),
            "max_m": float(s.max), "count": int(s.count)}


@pytest.mark.parametrize("chunked", [False, True])
def test_fuse_json_has_the_jax_keys_and_the_pipeline_values(files, chunked, capsys, monkeypatch):
    slam_path, gps_path, gt_path = files
    argv = ["fuse", slam_path, gps_path, "--gt", gt_path, "--robust", "--robust-iters", "3", "--json",
            "--seed", "4"] + (["--chunked", "--chunk-size", "100"] if chunked else [])
    # The JAX command would repoint the suite's compile cache.
    from gps_optimize_slam_tpu.utils import cache as jcache

    monkeypatch.setattr(jcache, "enable_persistent_cache", lambda *a, **k: "")
    assert jcli.main(argv) == 0
    want = payload(capsys.readouterr().out)
    assert cli.main(argv + ["--device", "cpu"]) == 0
    got = payload(capsys.readouterr().out)
    assert key_tree(got) == key_tree(want)
    assert got["poses"] == want["poses"] == 271 and got["gps_kept"] == want["gps_kept"] == 279
    assert abs(got["sim3_scale"] - want["sim3_scale"]) < 1e-6  # other draws, the same consensus
    assert abs(got["nn_vs_ground_truth"]["ekf"]["rmse_m"] - want["nn_vs_ground_truth"]["ekf"]["rmse_m"]) < 1e-3

    call = pipeline.fuse_files_chunked if chunked else pipeline.fuse_files
    kw = dict(chunk_size=100) if chunked else {}
    res = call(slam_path, gps_path, frame="utm", seed=4, device="cpu", gt_path=gt_path, robust=True,
               robust_iterations=3, **kw)
    accepted = res.result.robust_accepted if chunked else res.robust_accepted
    valid = res.result.gps_valid if chunked else res.outputs.gps_valid.numpy()
    assert got["sim3_scale"] == res.sim3_scale and got["time_offset_s"] == res.time_offset
    assert got["robust_accepted"] == int(accepted.sum())
    assert got["robust_rejected"] == int((~accepted & valid).sum())
    for block, ev in (("primary", res.evaluation), ("ground_truth", res.gt_evaluation)):
        assert got[f"nn_vs_{block}"] == {"slam": stats(ev.nn_slam), "sim3": stats(ev.nn_sim3),
                                         "ekf": stats(ev.nn_ekf)}
        assert got[f"ate_vs_{block}"] == {"sim3": stats(ev.ate_sim3), "ekf": stats(ev.ate_ekf)}
    if chunked:
        assert got["chunked"] is True and got["chunk_size"] == 100


def test_fuse_without_a_card_raises_unless_asked_for_the_cpu(files, monkeypatch):
    slam_path, gps_path, gt_path = files
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for extra in ([], ["--chunked"]):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cli.main(["fuse", slam_path, gps_path, "--gt", gt_path, "--robust", "--json"] + extra)


def test_module_entry_point_runs_as_a_subprocess(files, tmp_path):
    slam_path, gps_path, gt_path = files
    out = str(tmp_path / "fused_utm.txt")
    proc = subprocess.run(
        [sys.executable, "-m", "gps_optimize_slam_tpu_torch", "fuse", slam_path, gps_path, "--gt", gt_path,
         "--robust", "--json", "--device", "cpu", "-o", out],
        cwd=REPO, capture_output=True, text=True, env={**os.environ, "PYTHONPATH": REPO},
    )
    assert proc.returncode == 0, proc.stderr
    got = payload(proc.stdout)
    assert got["poses"] == 271 and "robust_accepted" in got and "nn_vs_ground_truth" in got
    assert f"saved: {out} and {str(tmp_path / 'fused_wgs84.txt')}" in proc.stdout
    assert np.loadtxt(out).shape == (271, 8) and np.loadtxt(str(tmp_path / "fused_wgs84.txt")).shape == (271, 8)


def test_human_readable_output_and_chunked_export(files, tmp_path, capsys):
    slam_path, gps_path, gt_path = files
    assert cli.main(["fuse", slam_path, gps_path, "--device", "cpu", "-v"]) == 0
    text = capsys.readouterr().out
    assert "poses: 271" in text and "scale=0.98" in text and "EKF fused (NN)" in text
    out = str(tmp_path / "chunked.tum")
    assert cli.main(["fuse", slam_path, gps_path, "--gt", gt_path, "--robust", "--chunked", "--chunk-size", "128",
                     "--device", "cpu", "-o", out]) == 0
    text = capsys.readouterr().out
    assert "(chunked/out-of-core)" in text and "robust χ² gate" in text and "vs ground-truth GNSS:" in text
    assert f"saved: {out}" in text and np.loadtxt(out).shape == (271, 8)


def test_frame_follows_the_dtype(files, capsys):
    assert cli._resolve_frame("auto", "float64") == "utm" and cli._resolve_frame("enu", "float64") == "enu"
    assert cli._resolve_frame("auto", "float32") == "enu"
    assert capsys.readouterr().err == ""
    assert cli._resolve_frame("utm", "float32") == "utm"
    assert "float32" in capsys.readouterr().err
    slam_path, gps_path, _ = files
    assert cli.main(["fuse", slam_path, gps_path, "--device", "cpu", "--dtype", "float32", "--json"]) == 0
    got = payload(capsys.readouterr().out)
    ref = pipeline.fuse_files(slam_path, gps_path, frame="enu", dtype=torch.float32, device="cpu")
    assert got["sim3_scale"] == ref.sim3_scale
    assert abs(got["nn_vs_primary"]["ekf"]["rmse_m"] - 0.0839) < 5e-3


def test_config_file_and_flag_overrides(files, tmp_path, capsys):
    slam_path, gps_path, _ = files
    cfg_path = tmp_path / "cfg.json"
    cfg_path.write_text(json.dumps({"sim3_ransac": {"max_trials": 300, "stop_probability": 0.999},
                                    "rts_mode": "full"}))
    args = cli.build_parser().parse_args(
        ["fuse", slam_path, gps_path, "--config", str(cfg_path), "--rts-mode", "outage", "--ekf-scan", "parallel",
         "--estimate-offset", "xcorr", "--meas-noise", "0.3", "0.3", "0.5", "--no-gps-filter"])
    config = cli._build_config(args)
    assert config.sim3_ransac.max_trials == 300 and config.sim3_ransac.stop_probability == 0.999
    assert (config.rts_mode, config.ekf_scan, config.offset_mode) == ("outage", "parallel", "xcorr")
    assert config.ekf.meas_noise_diag == (0.3, 0.3, 0.5) and not config.gps_filtering_ransac.enabled
    assert cli._build_config(cli.build_parser().parse_args(["fuse", slam_path, gps_path])) == FusionConfig()
    # The file's adaptive stopping and the flags run end to end.
    assert cli.main(["fuse", slam_path, gps_path, "--config", str(cfg_path), "--estimate-offset", "xcorr_device",
                     "--device", "cpu", "--json"]) == 0
    got = payload(capsys.readouterr().out)
    # On seq-04's speed profile both packages' estimators land at -1.09 s.
    assert abs(got["time_offset_s"] + 1.09) < 0.05 and got["nn_vs_primary"]["ekf"]["count"] > 200


def test_parser_knows_fuse_only_and_leaves_plotting_out(files):
    """The parser refuses a subcommand the port has not taken over yet
    (``refine-graph``; ``fuse`` and ``fuse-batch`` it knows), the plotting
    flags, and no subcommand at all."""
    slam_path, gps_path, _ = files
    assert cli.build_parser().parse_args(["fuse-batch", f"{slam_path}:{gps_path}"]).fn is cli._cmd_fuse_batch
    for argv in (["refine-graph", slam_path, gps_path], ["fuse", slam_path, gps_path, "--plot", "x.png"],
                 ["fuse", slam_path, gps_path, "--show"], []):
        with pytest.raises(SystemExit):
            cli.build_parser().parse_args(argv)


def test_chip_smoke_alone_names_what_it_misses(tmp_path):
    """Copied into a directory of its own the smoke script still fails, and
    says which files of the repository it looked for (a card is pretended,
    since the check for one comes first)."""
    import shutil

    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path / "chip_smoke.py")
    code = ("import sys, torch; torch.cuda.is_available = lambda: True\n"
            "import chip_smoke; sys.exit(chip_smoke.main())")
    proc = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True, text=True,
                          env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"})
    assert proc.returncode == 1 and proc.stdout == ""
    assert "tests/golden/seq04_golden.npz" in proc.stderr and "gps_optimize_slam_tpu_torch" in proc.stderr
