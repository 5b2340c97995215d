"""The port's figure (``viz``), ``ChunkedPipelineResult.decimated_view`` and
the ``fuse --plot`` flags on the CPU, against the JAX package's ``viz`` and
``decimated_view`` on the same host arrays.

The seq-04 files are written from ``tests/golden/seq04_golden.npz``
(``chip_smoke.write_seq04_files``) and fused by the port; both packages'
``plot_fusion_result`` draw the same host view of that fusion (JAX's viz
needs no JAX fusion, only its ``metrics.nn_errors``). Tolerances: the NN
errors ≤1e-9 m (the same distances, brute force in both); the decimated
Sim(3) layer ≤1e-6 m (the chunked parity bound; each package transforms
the strided poses itself).
"""

import sys
import types

import jax
import matplotlib
import numpy as np
import pytest
import torch

matplotlib.use("Agg")
import matplotlib.pyplot as plt  # noqa: E402

import chip_smoke  # noqa: E402
from gps_optimize_slam_tpu import pipeline as jpipeline  # noqa: E402
from gps_optimize_slam_tpu import viz as jviz  # noqa: E402
from gps_optimize_slam_tpu.config import FusionConfig as JFusionConfig  # noqa: E402
from gps_optimize_slam_tpu.models import fusion_chunked as jfc  # noqa: E402
from gps_optimize_slam_tpu.ops.umeyama import Sim3 as JSim3  # noqa: E402
from gps_optimize_slam_tpu_torch import cli, pipeline, viz  # noqa: E402
from gps_optimize_slam_tpu_torch.config import FusionConfig  # noqa: E402
from gps_optimize_slam_tpu_torch.models import fusion_chunked  # noqa: E402
from gps_optimize_slam_tpu_torch.ops.umeyama import Sim3  # noqa: E402
from tests.test_fusion_chunked import _scenario  # noqa: E402


@pytest.fixture(scope="module")
def seq04_files(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("seq04"))
    return (*chip_smoke.write_seq04_files(tmp), chip_smoke.write_seq04_gt_file(tmp))


@pytest.fixture(scope="module")
def fused(seq04_files):
    slam_path, gps_path, gt_path = seq04_files
    return pipeline.fuse_files(slam_path, gps_path, gt_path=gt_path, device="cpu")


def host_view(res):
    """The port's fusion as the duck-typed host view both packages' viz
    read."""
    o = res.outputs
    return types.SimpleNamespace(
        slam=res.slam, gps=res.gps, gt=res.gt, corrected_pos=res.corrected_pos,
        outputs=types.SimpleNamespace(sim3_pos=o.sim3_pos.numpy(), aligned_gps=o.aligned_gps.numpy(),
                                      gps_valid=o.gps_valid.numpy()),
        gt_aligned=types.SimpleNamespace(aligned=res.gt_aligned.aligned.numpy(), valid=res.gt_aligned.valid.numpy()),
    )


def panels(fig):
    """Titles of the axes, layer labels and their artist counts, the 2D
    overlay's line labels and texts."""
    ax1 = fig.axes[0]
    return ([ax.get_title() for ax in fig.axes], {k: len(v) for k, v in fig._layer_artists.items()},
            [ln.get_label() for ln in ax1.get_lines()], [t.get_text() for t in ax1.texts])


def test_figure_matches_jax(fused, tmp_path):
    view = host_view(fused)
    want = jviz.plot_fusion_result(view, str(tmp_path / "jax.png"), close=False)
    got = viz.plot_fusion_result(view, str(tmp_path / "port.png"), close=False, device="cpu")
    try:
        assert panels(got) == panels(want)
        assert "(vs GT GNSS)" in got.axes[3].get_title()
        for a, b in zip(got.axes[3].get_lines(), want.axes[3].get_lines()):  # the error over time
            np.testing.assert_allclose(a.get_ydata(), b.get_ydata(), atol=1e-9, rtol=0)
            np.testing.assert_array_equal(a.get_xdata(), b.get_xdata())
        assert (tmp_path / "port.png").read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
    finally:
        plt.close(got)
        plt.close(want)


@pytest.mark.parametrize("source", ["gt", "primary"])
def test_nn_errors_match_jax(fused, source):
    view = host_view(fused)
    src = view.gt_aligned if source == "gt" else types.SimpleNamespace(aligned=view.outputs.aligned_gps,
                                                                      valid=view.outputs.gps_valid)
    for traj in (view.corrected_pos, view.outputs.sim3_pos):
        err, t = viz._nn_errors_np(view, traj, src.aligned, src.valid, "cpu")
        jerr, jt = jviz._nn_errors_np(view, traj, src.aligned, src.valid)
        assert len(err) == len(jerr) > 200
        np.testing.assert_allclose(err, np.asarray(jerr), atol=1e-9, rtol=0)
        np.testing.assert_array_equal(t, jt)


def test_plot_runs_on_the_results_device_or_the_card(fused, tmp_path, monkeypatch):
    """A fusion's tensors name their device (the CPU here); a host view
    names none and needs a card (no quiet CPU fallback)."""
    assert viz._result_device(fused) == torch.device("cpu")
    viz.plot_fusion_result(fused, str(tmp_path / "fused.png"))
    assert (tmp_path / "fused.png").stat().st_size > 10_000
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        viz.plot_fusion_result(host_view(fused), None)


def test_plot_without_matplotlib_names_it(fused, monkeypatch):
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    with pytest.raises(ImportError, match="matplotlib"):
        viz.plot_fusion_result(fused, None)


def test_toggle_layer_and_checkbuttons(fused, tmp_path):
    """JAX's test_viz_layer_toggles_reference_checkbuttons on the port's
    figure: a layer's 2D and 3D artists flip together, a hidden layer
    leaves the legend, the mounted CheckButtons drive the same toggle."""
    fig = viz.plot_fusion_result(fused, str(tmp_path / "i.png"), interactive=True)
    try:
        layers = fig._layer_artists
        assert list(layers) == ["Sim3 Aligned", "EKF Fused", "GPS (kept)", "GT GNSS"]  # UTM: raw SLAM omitted
        assert len(layers["EKF Fused"]) == 2
        assert viz.toggle_layer(fig, "EKF Fused") is False
        assert not any(a.get_visible() for a in layers["EKF Fused"])
        assert all(t.get_text() != "EKF Fused" for t in fig._layer_axes[0].get_legend().get_texts())
        assert viz.toggle_layer(fig, "EKF Fused") is True
        assert all(a.get_visible() for a in layers["EKF Fused"])
        (check,) = fig._widgets_store
        idx = list(layers).index("Sim3 Aligned")
        check.set_active(idx)
        assert not any(a.get_visible() for a in layers["Sim3 Aligned"])
        check.set_active(idx)
        assert all(a.get_visible() for a in layers["Sim3 Aligned"])
    finally:
        plt.close(fig)


@pytest.mark.parametrize("chunked", [False, True])
def test_fuse_plot_writes_a_png(seq04_files, tmp_path, capsys, chunked):
    slam_path, gps_path, gt_path = seq04_files
    png = tmp_path / "overview.png"
    extra = ["--chunked", "--chunk-size", "128"] if chunked else []
    assert cli.main(["fuse", slam_path, gps_path, "--gt", gt_path, "--device", "cpu", "--plot", str(png), *extra]) == 0
    out = capsys.readouterr().out
    assert f"plot saved: {png}" + (" (decimated overview)" if chunked else "") in out
    assert png.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n" and png.stat().st_size > 10_000


@pytest.fixture(scope="module")
def chunked_results():
    """The e2e scenario fused out of core by both packages (their own
    draws): host arrays of each result."""
    (st, sp, sq), (gt, gp, gv) = _scenario(seed=1)
    port = fusion_chunked.fuse_core_chunked(st, sp, sq, gt, gp, gv, chunk_size=159, halo=24, device="cpu")
    jres = jfc.fuse_core_chunked(st, sp, sq, gt, gp, gv, key=jax.random.PRNGKey(0), chunk_size=159, halo=24)

    def host(r):
        return dict(corrected_pos=np.asarray(r.corrected_pos), aligned_gps=np.asarray(r.aligned_gps),
                    gps_valid=np.asarray(r.gps_valid), R=np.asarray(r.sim3.R), t=np.asarray(r.sim3.t),
                    scale=np.asarray(r.sim3.scale))

    slam = {"timestamps": st, "positions": sp, "quaternions": sq}
    return slam, {"port": host(port), "jax": host(jres)}


@pytest.mark.parametrize("source", ["port", "jax"])
def test_decimated_view_matches_jax(chunked_results, source):
    slam, results = chunked_results
    r = results[source]
    gps = types.SimpleNamespace(positions=np.zeros((0, 3)), valid=np.zeros(0, bool))
    gt_aligned = types.SimpleNamespace(aligned=r["aligned_gps"] + 0.5, valid=r["gps_valid"])

    def wrapped(sim3):
        return types.SimpleNamespace(corrected_pos=r["corrected_pos"], aligned_gps=r["aligned_gps"],
                                     gps_valid=r["gps_valid"], sim3=sim3)

    got = pipeline.ChunkedPipelineResult(
        slam=slam, gps=gps, evaluation=None, config=FusionConfig(), gt_aligned=gt_aligned, device=torch.device("cpu"),
        result=wrapped(Sim3(*(torch.tensor(r[k]) for k in ("R", "t", "scale")), torch.tensor(True))),
    ).decimated_view(max_points=100)
    want = jpipeline.ChunkedPipelineResult(
        slam=slam, gps=gps, evaluation=None, config=JFusionConfig(), gt_aligned=gt_aligned,
        result=wrapped(JSim3(r["R"], r["t"], r["scale"], np.asarray(True))),
    ).decimated_view(max_points=100)
    n = len(got.slam["timestamps"])
    assert n == len(want.slam["timestamps"]) <= 100 and got.device == torch.device("cpu")
    for k in slam:
        np.testing.assert_array_equal(got.slam[k], want.slam[k])
    np.testing.assert_array_equal(got.corrected_pos, want.corrected_pos)
    np.testing.assert_allclose(got.outputs.sim3_pos, np.asarray(want.outputs.sim3_pos), atol=1e-6, rtol=0)
    np.testing.assert_array_equal(got.outputs.aligned_gps, want.outputs.aligned_gps)
    np.testing.assert_array_equal(got.outputs.gps_valid, want.outputs.gps_valid)
    np.testing.assert_array_equal(got.gt_aligned.aligned, want.gt_aligned.aligned)
    np.testing.assert_array_equal(got.gt_aligned.valid, want.gt_aligned.valid)
