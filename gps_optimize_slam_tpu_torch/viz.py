"""Offline matplotlib overview of a fusion (port of
``gps_optimize_slam_tpu.viz``; headless Agg unless a window is asked for).

The reference's ``plot_results`` panels (EKFGPSSLAM.py:469-666): the X-Y
overlay of up to five trajectories (raw SLAM, Sim3, EKF, kept GPS, GT GNSS;
:501-522), the 3D overlay on median-centred equal-range axes (:524-558), the
error histograms with mean, median and RMSE lines (:599-612) and the error
over time (:614-663), saved to a file. With a ground-truth GNSS track the
error panels use ground-truth errors (:1069-1082), else the primary GPS.

Layer toggles (reference CheckButtons, :561-597): each trajectory layer's
artists are registered on the figure (``fig._layer_artists``) and
``toggle_layer(fig, label)`` flips one in any backend; ``interactive=True``
mounts a CheckButtons panel wired to it, ``show=True`` opens the window.

The figure reads host arrays (``.cpu().numpy()`` of the port's tensors).
The NN errors of the error panels are computed on the result's device
(``ops.metrics.nn_errors_auto``: K3/K4 on a card). matplotlib is imported
only when a figure is drawn; a machine without it cannot plot.
"""

from __future__ import annotations

import numpy as np
import torch

from gps_optimize_slam_tpu_torch.ops import metrics
from gps_optimize_slam_tpu_torch.utils.device import resolve_device


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _result_device(result, device=None) -> torch.device:
    """Where the error panels' NN distances run: ``device`` when named, else
    the result's own (its ``device``, or that of its output tensors), else
    the card (``utils.device.resolve_device``: raises without one)."""
    if device is None:
        device = getattr(result, "device", None)
    if device is None:
        pos = getattr(result.outputs, "corrected_pos", None)
        if isinstance(pos, torch.Tensor):
            device = pos.device
    return resolve_device(device)


def _nn_errors_np(result, traj_pos, aligned, valid, device=None):
    """NN errors of a trajectory against an aligned candidate set after the
    5 s gate, computed on ``_result_device(result, device)``; returns host
    (errors, their timestamps)."""
    device = _result_device(result, device)
    slam_t = _host(result.slam["timestamps"])
    gate = _host(valid).astype(bool) & (slam_t > slam_t[0] + 5.0)
    traj = torch.as_tensor(_host(traj_pos), device=device)
    cands = torch.nan_to_num(torch.as_tensor(_host(aligned), device=device).to(traj.dtype), nan=0.0)
    g = torch.as_tensor(gate, device=device)
    err = metrics.nn_errors_auto(traj, cands, g, g).cpu().numpy()
    return err[gate], slam_t[gate]


def _equal_range_3d(ax, pts):
    """Median-centred equal-range 3D axes (reference EKFGPSSLAM.py:544-556)."""
    med = np.median(pts, axis=0)
    half = max(float(np.max(np.ptp(pts, axis=0))) / 2.0, 1.0)
    ax.set_xlim(med[0] - half, med[0] + half)
    ax.set_ylim(med[1] - half, med[1] + half)
    ax.set_zlim(med[2] - half, med[2] + half)


def toggle_layer(fig, label: str) -> bool:
    """Flip a trajectory layer's visibility on a ``plot_fusion_result``
    figure (the reference's CheckButtons callback, EKFGPSSLAM.py:584-597),
    refresh the overlay legends, and return the new visibility. Works in
    any backend; the interactive CheckButtons call this same function."""
    artists = fig._layer_artists[label]
    new_vis = not artists[0].get_visible()
    for a in artists:
        a.set_visible(new_vis)
    for ax in fig._layer_axes:
        handles = [h for h in ax._layer_handles if h.get_visible()]
        if handles:
            ax.legend(handles=handles, loc="best", fontsize=8)
        elif ax.get_legend() is not None:
            ax.get_legend().remove()
    fig.canvas.draw_idle()
    return new_vis


def _mount_layer_checkbuttons(fig):
    """Mount a CheckButtons panel driving ``toggle_layer`` (reference
    EKFGPSSLAM.py:561-597). Returns the widget (kept alive on the figure)."""
    from matplotlib.widgets import CheckButtons

    labels = list(fig._layer_artists)
    ax = fig.add_axes([0.005, 0.45, 0.10, 0.028 * max(len(labels), 1) + 0.04])
    ax.set_title("Show/Hide Layers", fontsize=9)
    check = CheckButtons(ax=ax, labels=labels, actives=[True] * len(labels))
    check.on_clicked(lambda label: toggle_layer(fig, label))
    fig._widgets_store = [check]
    return check


def plot_fusion_result(
    result,
    out_path,
    dpi: int = 110,
    close: bool = True,
    interactive: bool = False,
    show: bool = False,
    device=None,
):
    """Render the four-panel overview of ``result`` (a ``FusionResult``, or
    the view of ``ChunkedPipelineResult.decimated_view``) to ``out_path``
    (None: no file). Returns the figure, closed unless ``close=False``,
    ``interactive`` or ``show``. ``interactive=True`` mounts the
    show/hide-layers CheckButtons; ``show=True`` also opens a window (a GUI
    backend is needed). ``device``: where the NN errors are computed (see
    ``_result_device``). Raises ImportError without matplotlib."""
    try:
        import matplotlib
    except ImportError as e:
        raise ImportError("plotting needs matplotlib, which is not installed") from e

    if not (interactive or show):
        matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    device = _result_device(result, device)
    slam_pos = _host(result.slam["positions"])
    sim3_pos = _host(result.outputs.sim3_pos)
    ekf_pos = _host(result.corrected_pos)
    gps_pos = result.gps.positions[result.gps.valid]
    has_gt = result.gt is not None
    gt_pos = result.gt.positions[result.gt.valid] if has_gt else None

    # Error source: ground truth when available (reference :1069-1082).
    if has_gt and result.gt_aligned is not None:
        err_aligned, err_valid = result.gt_aligned.aligned, result.gt_aligned.valid
        err_label = "vs GT GNSS"
    else:
        err_aligned, err_valid = result.outputs.aligned_gps, result.outputs.gps_valid
        err_label = "vs primary GPS"
    ekf_err, t_err = _nn_errors_np(result, ekf_pos, err_aligned, err_valid, device)
    sim3_err, _ = _nn_errors_np(result, sim3_pos, err_aligned, err_valid, device)
    t_rel = t_err - t_err[0] if len(t_err) else np.zeros(0)

    fig = plt.figure(figsize=(16, 10))
    fig.suptitle("SLAM-GPS Trajectory Alignment and Fusion Results", fontsize=15)

    ax1 = fig.add_subplot(2, 2, 1)
    # The raw SLAM track lives in its own local frame: it is drawn only when
    # it is commensurate with the fused frame, and its omission is noted.
    layers: dict[str, list] = {}
    extent = np.linalg.norm(ekf_pos.max(0) - ekf_pos.min(0)) + 1.0
    if np.linalg.norm(slam_pos.mean(0) - ekf_pos.mean(0)) < 10 * extent:
        (l_slam,) = ax1.plot(slam_pos[:, 0], slam_pos[:, 1], "b--", lw=1, alpha=0.6, label="Original SLAM")
        layers["Original SLAM"] = [l_slam]
    else:
        ax1.text(0.02, 0.02, "raw SLAM layer omitted:\nlocal frame incommensurate with fused frame",
                 transform=ax1.transAxes, fontsize=7, color="0.35")
    (l_sim3,) = ax1.plot(sim3_pos[:, 0], sim3_pos[:, 1], "m:", lw=1, alpha=0.7, label="Sim3 Aligned")
    (l_ekf,) = ax1.plot(ekf_pos[:, 0], ekf_pos[:, 1], "g-", lw=1.5, label="EKF Fused")
    s_gps = ax1.scatter(gps_pos[:, 0], gps_pos[:, 1], c="r", marker=".", s=12, label="GPS (kept)")
    layers.setdefault("Sim3 Aligned", []).append(l_sim3)
    layers.setdefault("EKF Fused", []).append(l_ekf)
    layers.setdefault("GPS (kept)", []).append(s_gps)
    if has_gt and len(gt_pos):
        (l_gt,) = ax1.plot(gt_pos[:, 0], gt_pos[:, 1], "k-", lw=1, alpha=0.8, label="GT GNSS")
        layers.setdefault("GT GNSS", []).append(l_gt)
    ax1.set_title("Trajectory (X-Y)")
    ax1.axis("equal")
    ax1.grid(True)
    ax1._layer_handles = list(ax1.get_lines()) + [s_gps]
    ax1.legend(loc="best", fontsize=8)

    ax2 = fig.add_subplot(2, 2, 2, projection="3d")
    (l3_sim3,) = ax2.plot(sim3_pos[:, 0], sim3_pos[:, 1], sim3_pos[:, 2], "m:", lw=1, label="Sim3")
    (l3_ekf,) = ax2.plot(ekf_pos[:, 0], ekf_pos[:, 1], ekf_pos[:, 2], "g-", lw=1.5, label="EKF")
    s3_gps = ax2.scatter(gps_pos[:, 0], gps_pos[:, 1], gps_pos[:, 2], c="r", marker="x", s=10)
    layers["Sim3 Aligned"].append(l3_sim3)
    layers["EKF Fused"].append(l3_ekf)
    layers["GPS (kept)"].append(s3_gps)
    if has_gt and len(gt_pos):
        (l3_gt,) = ax2.plot(gt_pos[:, 0], gt_pos[:, 1], gt_pos[:, 2], "k-", lw=1, alpha=0.8, label="GT")
        layers["GT GNSS"].append(l3_gt)
    _equal_range_3d(ax2, ekf_pos)
    ax2.set_title("Trajectory (3D)")
    ax2._layer_handles = [l3_sim3, l3_ekf] + ([l3_gt] if has_gt and len(gt_pos) else [])
    ax2.legend(fontsize=8)

    ax3 = fig.add_subplot(2, 2, 3)
    if len(ekf_err):
        ax3.hist(sim3_err, bins=30, alpha=0.45, color="magenta", label="Sim3 error")
        ax3.hist(ekf_err, bins=30, alpha=0.65, color="purple", label="Fused error")
        for val, color, name in [
            (ekf_err.mean(), "red", "mean"),
            (np.median(ekf_err), "orange", "median"),
            (np.sqrt((ekf_err**2).mean()), "cyan", "rmse"),
        ]:
            ax3.axvline(val, color=color, ls="--", lw=1, label=f"fused {name}: {val:.3f} m")
        ax3.legend(fontsize=8)
    ax3.set_title(f"Position error distribution ({err_label})")
    ax3.set_xlabel("error (m)")
    ax3.grid(axis="y", ls=":")

    ax4 = fig.add_subplot(2, 2, 4)
    if len(ekf_err):
        ax4.plot(t_rel, ekf_err, "g-", lw=1.2, label="Fused")
        ax4.plot(t_rel, sim3_err, "m--", lw=1, alpha=0.7, label="Sim3")
        ax4.legend(fontsize=8)
    ax4.set_title(f"Error over time ({err_label})")
    ax4.set_xlabel("relative time (s)")
    ax4.set_ylabel("error (m)")
    ax4.grid(True)

    fig._layer_artists = layers
    fig._layer_axes = (ax1, ax2)
    # Layout before the CheckButtons: their inset axes live in figure
    # coordinates and do not take part in tight_layout.
    fig.tight_layout(rect=[0, 0, 1, 0.95])
    if interactive or show:
        _mount_layer_checkbuttons(fig)
    if out_path is not None:
        fig.savefig(out_path, dpi=dpi)
    if show:
        plt.show()
    if close and not (interactive or show):
        plt.close(fig)
    return fig
