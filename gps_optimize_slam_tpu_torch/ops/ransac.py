"""Batched RANSAC estimators: Sim(3) alignment and polynomial GPS gating
(port of ``gps_optimize_slam_tpu.ops.ransac``).

* ``sim3_ransac`` replaces compute_sim3_transform_robust (EKFGPSSLAM.py:389-426):
  every trial at once as a batch of 4-point Umeyama fits, consensus counted
  by K5 (``ops.kernels.ransac_counts``), the top 16 trials re-ranked with
  exact counts, and the winner refitted on its inliers.
* ``gps_poly_ransac_mask`` replaces filter_gps_outliers_ransac
  (EKFGPSSLAM.py:136-247): per-window, per-axis degree-2 polynomial RANSAC,
  windows × axes × trials as one batch; the window inlier sets are OR-ed like
  the reference's sliding-window union (Q12).

Random draws come from a ``torch.Generator`` on the tensors' device. They
cannot reproduce jax's threefry streams, so both estimators also accept the
draws themselves (``draws=``), which is how the tests hand in exactly what
the JAX package drew. On clean data the converged result does not depend on
the draws (SURVEY §7 hard-part d).

Both estimators stop early under ``cfg.stop_probability`` (sklearn-style):
trials run in chunks of ``cfg.adaptive_chunk`` until the bound
ln(1−p)/ln(1−w^k) on the number of trials is met, w the best inlier ratio so
far. One host read a chunk decides whether another chunk runs (inside a
captured graph ``sim3_ransac`` runs every chunk, masked, with the same
result; the GNSS gate is never captured).

``sim3_ransac`` also takes a leading batch axis, one sequence a row (the
JAX package's ``vmap`` of it): every chunk is one batched fit, one K5
launch over all rows and one batched re-rank.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from gps_optimize_slam_tpu_torch.config import GPSFilterConfig, Sim3RansacConfig
from gps_optimize_slam_tpu_torch.ops.kernels import ransac_counts, sim3_residual2
from gps_optimize_slam_tpu_torch.ops.umeyama import Sim3, umeyama_sim3
from gps_optimize_slam_tpu_torch.utils import graphs

# The top-RERANK_K trials by kernel count are re-counted exactly before the
# winner is picked (ransac.py:147-173 of the JAX package, whose MXU counts
# can differ near the threshold; the port's kernel counts are exact already,
# so the re-rank is a guard that costs 16 trials' work).
RERANK_K = 16


class Sim3RansacResult(NamedTuple):
    sim3: Sim3
    inlier_mask: torch.Tensor  # (..., N) bool — best consensus set ∩ valid
    num_inliers: torch.Tensor  # (...) — derived from inlier_mask
    ok: torch.Tensor  # (...) bool — enough inliers found


def _generator(device: torch.device, seed: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed)


def _gather_points(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Points x (..., N, 3) at per-row indices idx (..., C, k) → (..., C, k, 3)."""
    if idx.ndim == 2:
        return x[idx]
    flat = idx.reshape(idx.shape[0], -1)
    return torch.gather(x, 1, flat[..., None].expand(*flat.shape, 3)).reshape(*idx.shape, 3)


def seeded_uniforms(seed, lead: tuple, trials: int, k: int, device) -> torch.Tensor:
    """The uniforms of ``sim3_ransac``'s seeded draws, (*lead, trials, k):
    one generator seeded with ``seed`` (an int), or, with a batch axis
    (``lead`` = (B,)), a generator a row seeded with its entry of ``seed``
    (an int for every row, or B ints), so a row draws what it would
    alone. Made before a captured program, which takes them as an input
    (a generator made inside it would not be part of the graph)."""

    def draw(sd):
        return torch.rand((trials, k), generator=_generator(device, sd), dtype=torch.float64, device=device)

    if not lead:
        return draw(seed)
    return torch.stack([draw(int(x)) for x in torch.as_tensor(seed).expand(lead[0]).tolist()])


def scale_uniforms(u: torch.Tensor, n_valid: torch.Tensor) -> torch.Tensor:
    """Uniforms (..., trials, k) in [0, 1) as integer draws in
    [0, max(n_valid, 1)), n_valid (...), on the device without a host sync
    (the counterpart of the JAX package's per-trial
    ``jax.random.randint``)."""
    hi = torch.clamp(n_valid, min=1).to(torch.float64)[..., None, None]
    return torch.minimum(torch.floor(u * hi), hi - 1).long()


def _integer_pow(x: torch.Tensor, k: int) -> torch.Tensor:
    """x**k for a positive integer k as a chain of products (squarings,
    lowest bit first), the rounding of an integer power in the JAX package;
    ``torch.pow`` rounds otherwise."""
    acc = None
    while k > 0:
        if k & 1:
            acc = x if acc is None else acc * x
        k >>= 1
        if k > 0:
            x = x * x
    return acc


def _adaptive_schedule(max_trials: int, adaptive_chunk: int, stop_probability: Optional[float]):
    """(chunk length, number of chunks): one chunk of ``max_trials`` without
    early stopping, else ceil(max_trials / chunk) chunks of
    min(adaptive_chunk, max_trials) trials (so up to one chunk's worth more
    than ``max_trials`` draws)."""
    if stop_probability is None:
        return max_trials, 1
    C = min(adaptive_chunk, max_trials)
    return C, -(-max_trials // C)


def _more_trials_needed(
    trials_done: int, best_count: torch.Tensor, n_members: torch.Tensor, k: int,
    stop_probability: float, dtype: torch.dtype,
) -> torch.Tensor:
    """Whether the sklearn bound ln(1−p)/ln(1−w^k) still exceeds
    ``trials_done``, w = best_count / n_members, elementwise, in the working
    dtype. The failure probability is clipped strictly inside (0, 1): w → 0
    must give a huge bound, not ln(1) = 0, and the upper clip must survive
    the dtype's rounding (1 − 1e-9 is 1 in float32), hence 16 eps."""
    log1mp = math.log1p(-min(stop_probability, 1.0 - 1e-12))
    w = torch.clamp(best_count.to(dtype) / torch.clamp(n_members, min=1), 0.0, 1.0)
    eps1 = 16.0 * torch.finfo(dtype).eps
    fail = torch.clamp(1.0 - _integer_pow(w, k), 1e-12, 1.0 - eps1)
    n_needed = torch.where(w >= 1.0, torch.zeros_like(w), log1mp / torch.log(fail))
    return trials_done < n_needed


def _trials(x: torch.Tensor, idx: torch.Tensor, tail: int) -> torch.Tensor:
    """``x[..., idx, ...]`` along the trial axis with per-row indices: x
    (..., T, *tail dims), idx (..., K) → (..., K, *tail dims)."""
    lead = idx.shape[:-1]
    if not lead:
        return x[idx]
    trail = x.shape[x.ndim - tail:]
    return torch.gather(x, len(lead), idx.reshape(*idx.shape, *(1,) * tail).expand(*idx.shape, *trail))


def select_winner(
    src: torch.Tensor,
    dst: torch.Tensor,
    valid: torch.Tensor,
    fits: Sim3,
    counts: torch.Tensor,
    thr2: float,
) -> torch.Tensor:
    """Index of the winning trial: the RERANK_K trials with the largest
    ``counts`` (a stable descending sort, so equal counts keep ascending
    trial order, which ``torch.topk`` does not promise) are re-counted
    exactly, and the first maximum wins. Trials whose fit failed count -1.
    With a leading batch axis, a winner a row, each re-ranked on its own."""
    counts = torch.where(fits.ok, counts, -1)
    topi = torch.sort(counts, dim=-1, descending=True, stable=True).indices[..., :RERANK_K]
    if counts.ndim == 2:  # a row's points meet each of its trials
        src, dst, valid = src[:, None], dst[:, None], valid[:, None]
    r2 = sim3_residual2(src, dst, _trials(fits.R, topi, 2), _trials(fits.t, topi, 1),
                        _trials(fits.scale, topi, 0))
    exact = torch.where(_trials(fits.ok, topi, 0), ((r2 < thr2) & valid).sum(-1), -1)
    best = exact.amax(-1, keepdim=True)
    return torch.amin(torch.where(exact == best, topi, counts.shape[-1]), -1)


def sim3_trials(cfg: Sim3RansacConfig) -> int:
    """The draws ``sim3_ransac`` takes a row: ``max_trials``, or the whole
    adaptive schedule's ceil(max_trials / chunk) · chunk."""
    C, n_chunks = _adaptive_schedule(cfg.max_trials, cfg.adaptive_chunk, cfg.stop_probability)
    return C * n_chunks


def sim3_ransac(
    src: torch.Tensor,
    dst: torch.Tensor,
    valid: Optional[torch.Tensor] = None,
    cfg: Sim3RansacConfig = Sim3RansacConfig(),
    seed: int = 0,
    draws: Optional[torch.Tensor] = None,
    uniforms: Optional[torch.Tensor] = None,
) -> Sim3RansacResult:
    """RANSAC-robust Sim(3) fit of dst onto src over the valid mask.

    A batch of sequences (src, dst (B, N, 3), valid (B, N)) is fitted as one
    program: ``seed`` is then an int (every row) or B ints (a generator a
    row, so a row draws what it would alone; the generator has no batched
    form, so that is one small draw a row) and ``draws`` (B, trials,
    min_samples). Under ``stop_probability`` the batch runs another chunk
    while any row needs one; a row that needs no more keeps its result, as
    under the JAX package's vmapped ``while_loop``.

    ``draws`` (trials, min_samples): the per-trial integer draws in
    [0, max(n_valid, 1)), taken BEFORE the compaction of the valid indices
    (``ransac.py:110-115`` of the JAX package); None draws them from a
    generator seeded with ``seed`` on the tensors' device, or scales the
    given ``uniforms`` (``seeded_uniforms``: the same generator's numbers,
    made outside a captured program). ``trials`` is ``sim3_trials(cfg)``.
    Sampling is with replacement, as in the JAX package. Counting runs
    through K5, one launch a chunk; a chunk's winner is the first maximum
    of the exact counts over its top 16 trials,
    picked with a stable descending sort, and a later chunk's winner
    replaces the running best only with a strictly larger count, so the
    earlier chunk wins ties. While a graph is captured (``utils.graphs``)
    every chunk runs, masked by ``active`` as the rows that stop early
    are: the host cannot read ``active`` inside a graph, and a chunk adds
    nothing once it is false, so the result is the early stop's.
    """
    n = src.shape[-2]
    lead = src.shape[:-2]
    device = src.device
    if valid is None:
        valid = torch.ones((*lead, n), dtype=torch.bool, device=device)
    n_valid = torch.sum(valid, -1)
    enough = n_valid >= cfg.min_samples

    # Valid indices compacted to the front once (a stable partition by
    # scatter, along each row); each trial's draws index into them.
    iota = torch.arange(n, device=device).expand(*lead, n)
    cv = torch.cumsum(valid.long(), -1)
    pos = torch.where(valid, cv - 1, n_valid[..., None] + iota - cv)
    order = torch.empty_like(iota).scatter_(-1, pos, iota)
    thr2 = float(cfg.residual_threshold) ** 2

    C, n_chunks = _adaptive_schedule(cfg.max_trials, cfg.adaptive_chunk, cfg.stop_probability)
    if draws is None:
        if uniforms is None:
            uniforms = seeded_uniforms(seed, lead, n_chunks * C, cfg.min_samples, device)
        draws = scale_uniforms(uniforms, n_valid)
    draws = draws.to(device)
    src_c, dst_c, valid_c = src.contiguous(), dst.contiguous(), valid.contiguous()
    best_count = torch.full(lead, -1, dtype=torch.long, device=device)
    best_mask = torch.zeros_like(valid)
    active = torch.ones(lead, dtype=torch.bool, device=device)
    for i in range(n_chunks):
        if i > 0:
            active = active & _more_trials_needed(
                i * C, best_count, n_valid, cfg.min_samples, cfg.stop_probability, src.dtype)
            if not graphs.capturing() and not bool(active.any()):
                break
        chunk = draws[..., i * C : (i + 1) * C, :]  # (..., C, k)
        idx = torch.gather(order, -1, chunk.reshape(*lead, -1)).reshape(chunk.shape)
        fits = umeyama_sim3(_gather_points(src, idx), _gather_points(dst, idx))
        counts = ransac_counts(
            src_c, dst_c, valid_c, fits.R.contiguous(), fits.t.contiguous(), fits.scale.contiguous(), thr2
        )
        b = select_winner(src, dst, valid, fits, counts, thr2)
        R_b, t_b, s_b, ok_b = (_trials(x, b[..., None], tail).select(len(lead), 0)
                               for x, tail in ((fits.R, 2), (fits.t, 1), (fits.scale, 0), (fits.ok, 0)))
        mask_b = (sim3_residual2(src, dst, R_b, t_b, s_b) < thr2) & valid
        count_b = torch.where(ok_b, mask_b.sum(-1), -1)
        better = active & (count_b > best_count)
        best_count = torch.where(better, count_b, best_count)
        best_mask = torch.where(better[..., None], mask_b, best_mask)
    best_mask = best_mask & enough[..., None]
    num_inliers = torch.sum(best_mask, -1)
    # The refit runs in float64 whatever the working dtype: the 3×3 SVD of
    # a nearly planar trajectory's cross-covariance (σ₁/σ₃ ≈ 1e5 on KITTI)
    # loses ~1e-4 rad of tilt in float32, which moved every pose by up to
    # 0.47 m on a 4,661-pose sequence. One 3×3 fit costs nothing.
    refit = umeyama_sim3(src.double(), dst.double(), best_mask.double())
    ok = enough & (num_inliers >= cfg.min_inliers_needed) & refit.ok
    dt = src.dtype
    return Sim3RansacResult(
        sim3=Sim3(R=refit.R.to(dt), t=refit.t.to(dt), scale=refit.scale.to(dt), ok=ok),
        inlier_mask=best_mask,
        num_inliers=num_inliers,
        ok=ok,
    )


# ---------------------------------------------------------------------------
# Polynomial GPS outlier gating
# ---------------------------------------------------------------------------


def reference_window_starts(times, cfg: GPSFilterConfig):
    """Host-side sliding-window start times, reproducing the reference's
    while-loop exactly (EKFGPSSLAM.py:199-237): step = duration·factor,
    degenerate-step jump-to-next-distinct-time, and the final tail-window
    adjustment. Returns a NumPy array of window start times."""
    import numpy as np

    times = np.asarray(times)
    if times.size == 0:
        return np.zeros((0,))
    duration = cfg.window_duration_seconds
    step = duration * cfg.window_step_factor
    start_time = float(times[0])
    end_time = float(times[-1])
    starts = []
    cur = start_time
    while cur < end_time:
        starts.append(cur)
        cur_end = cur + duration
        if step <= 1e-6:
            nxt = times[times > cur]
            if len(nxt) == 0:
                break
            cur = float(nxt[0])
        else:
            cur += step
        if cur >= end_time and times[-1] >= cur_end:
            cur = max(start_time, times[-1] - duration + 1e-6)
    return np.asarray(starts)


def _poly_design(t: torch.Tensor, degree: int) -> torch.Tensor:
    return torch.stack([t**d for d in range(degree + 1)], dim=-1)


# Elements of a window block's draws and residuals in the GNSS gate (about
# 1 GiB of float64 each): the gate's sliding windows are taken in blocks of
# at most this many (window, axis, trial, point) entries.
GATE_BLOCK_ELEMENTS = 1 << 27


def _gate_windows(times, positions, in_window, window_ok, draws, gen, cfg: GPSFilterConfig, C: int,
                  n_chunks: int) -> torch.Tensor:
    """(W, m) per-window masks of :func:`gps_poly_ransac_mask` for a block of
    W windows: each window's per-axis RANSAC (the best of its trials,
    drawn from ``gen`` when ``draws`` is None), its axes AND-ed, windows
    with too few members empty."""
    W, m = in_window.shape
    k, device, dtype = cfg.min_samples, times.device, positions.dtype
    if draws is None:
        u = torch.rand((W, 3, n_chunks * C, m), generator=gen, dtype=dtype, device=device)
        scores = torch.where(in_window[:, None, None, :], u, -1.0)
        draws = torch.topk(scores, k, dim=-1).indices
    draws = draws.to(device)  # (W, 3, trials, k)
    design = _poly_design(times, cfg.polynomial_degree)  # (m, D)
    axis = torch.arange(3, device=device)[None, :, None, None]
    n_members = in_window.sum(1)[:, None]  # (W, 1): each axis of a window sees its members

    best_count = torch.full((W, 3), -1, dtype=torch.long, device=device)
    inl_best = torch.zeros((W, 3, m), dtype=torch.bool, device=device)
    active = torch.ones((W, 3), dtype=torch.bool, device=device)
    for i in range(n_chunks):
        if i > 0:
            active = active & _more_trials_needed(
                i * C, best_count, n_members, k, cfg.stop_probability, dtype)
            if not bool(active.any()):
                break
        idx = draws[:, :, i * C : (i + 1) * C]  # (W, 3, C, k)
        X = _poly_design(times[idx], cfg.polynomial_degree)  # (W, 3, C, k, D)
        Y = positions.T[axis, idx]  # (W, 3, C, k)
        coef = (torch.linalg.pinv(X) @ Y[..., None])[..., 0]  # (W, 3, C, D)
        trial_ok = torch.isfinite(coef).all(-1)
        pred = design[:, 0] * coef[..., 0, None]
        for d in range(1, design.shape[1]):
            pred = pred + design[:, d] * coef[..., d, None]
        res = torch.abs(pred - positions.T[None, :, None, :])  # (W, 3, C, m)
        inl = (res < cfg.residual_threshold_meters) & in_window[:, None, None, :]
        counts = torch.where(trial_ok, inl.sum(-1), -1)
        best = torch.argmax(counts, dim=-1, keepdim=True)  # first maximum
        count_b = counts.gather(-1, best)[..., 0]  # (W, 3)
        inl_b = inl.gather(2, best[..., None].expand(W, 3, 1, m))[:, :, 0]
        better = active & (count_b > best_count)
        best_count = torch.where(better, count_b, best_count)
        inl_best = torch.where(better[..., None], inl_b, inl_best)
    ok_axes = best_count >= 0
    combined = (inl_best & ok_axes[..., None]).all(1) & ok_axes.all(1, keepdim=True)
    return combined & window_ok[:, None]


def gps_poly_ransac_mask(
    times: torch.Tensor,
    positions: torch.Tensor,
    valid: Optional[torch.Tensor] = None,
    window_starts: Optional[torch.Tensor] = None,
    cfg: GPSFilterConfig = GPSFilterConfig(),
    seed: int = 0,
    draws: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Inlier mask from per-window, per-axis polynomial RANSAC.

    ``window_starts``: (W,) window start times (``reference_window_starts``;
    NaN entries are padding). None (or cfg.use_sliding_window False) runs
    the reference's global mode: one window, per-axis masks AND-ed; in
    sliding mode each window's AND-ed mask is OR-ed into the result (Q12).

    ``draws`` (W, 3, trials, min_samples): each trial's subset of point
    indices (the JAX package draws them by Gumbel top-k,
    ``ransac.py:44-54``); None draws uniform subsets of each window from a
    generator seeded with ``seed``. ``trials`` is ``max_trials``, or the
    whole schedule's ceil(max_trials / chunk) · chunk under
    ``cfg.stop_probability``, where every window and axis stops on its own
    bound and a later chunk's best trial replaces the running best only
    with a strictly larger count. Each trial's polynomial is the
    minimum-norm least-squares fit (SVD-based, like ``jnp.linalg.lstsq``),
    so degenerate subsets give the same finite-or-not coefficients as the
    JAX package.

    With cfg.enabled False, returns ``valid`` unchanged.
    """
    m = times.shape[0]
    device = times.device
    if valid is None:
        valid = torch.ones((m,), dtype=torch.bool, device=device)
    if not cfg.enabled:
        return valid
    dtype = positions.dtype
    times = times.to(dtype)
    use_windows = cfg.use_sliding_window and window_starts is not None
    duration = cfg.window_duration_seconds
    if use_windows:
        starts = window_starts.to(dtype=dtype, device=device)[:, None]
        in_window = (times >= starts) & (times < starts + duration) & valid
        window_ok = (in_window.sum(1) >= cfg.min_samples) & torch.isfinite(starts[:, 0])
    else:
        in_window = valid[None]
        window_ok = in_window.sum(1) >= cfg.min_samples
    W = in_window.shape[0]
    C, n_chunks = _adaptive_schedule(cfg.max_trials, cfg.adaptive_chunk, cfg.stop_probability)
    # Windows in blocks whose (windows, 3, trials, m) draws and residuals
    # stay near GATE_BLOCK_ELEMENTS: one block up to there (every test and
    # every KITTI-length log), so the seeded draws are those of one call;
    # a long log's O(W·m) intermediates (W grows with m) would not fit.
    per = max(1, GATE_BLOCK_ELEMENTS // (3 * n_chunks * C * max(m, 1)))
    gen = _generator(device, seed) if draws is None else None
    per_window = torch.cat([
        _gate_windows(times, positions, in_window[w0 : w0 + per], window_ok[w0 : w0 + per],
                      None if draws is None else draws[w0 : w0 + per], gen, cfg, C, n_chunks)
        for w0 in range(0, W, per)])

    too_few = valid.sum() < cfg.min_samples
    if use_windows:
        return torch.where(too_few, valid, per_window.any(0))
    mask = per_window[0]
    return torch.where(too_few | ~mask.any(), valid, mask)


def window_starts_device(
    times: torch.Tensor,
    cfg: GPSFilterConfig,
    max_windows: int,
    valid: Optional[torch.Tensor] = None,
):
    """The device form of :func:`reference_window_starts`: the reference's
    while-loop (EKFGPSSLAM.py:199-237) as ``max_windows`` fixed steps of
    tensor operations with no host read, with the same accumulation order
    (``cur += step``), the same jump to the next distinct timestamp when the
    step is degenerate, and the same tail-window adjustment. Equal to the
    host loop at the same dtype for nondecreasing ``times`` (the reference's
    precondition; the first and last element are a masked min and max here,
    so padded rows of a batch work).

    ``valid``: optional (m,) mask of a padded row; the first and last time
    and the next-distinct search honour only valid entries.

    Returns ``(starts, count)``: (max_windows,) NaN-padded start times and
    the number emitted. When the true count exceeds ``max_windows`` the
    output is truncated (count == max_windows); size the bound from the
    data (≈ span/step plus the tail window) or check the count.
    """
    m = times.shape[0]
    dtype, device = times.dtype, times.device
    nan = torch.full((), float("nan"), dtype=dtype, device=device)
    if m == 0:
        return nan.expand(max_windows).clone(), torch.zeros((), dtype=torch.int32, device=device)
    if valid is None:
        valid = torch.ones((m,), dtype=torch.bool, device=device)
    inf = float("inf")
    t0 = torch.min(torch.where(valid, times, inf))
    end = torch.max(torch.where(valid, times, -inf))
    duration = cfg.window_duration_seconds
    step = duration * cfg.window_step_factor
    degenerate = step <= 1e-6  # a property of the config, like the reference's branch

    cur, active = t0, torch.any(valid)
    starts = []
    for _ in range(max_windows):
        emit = active & (cur < end)
        starts.append(torch.where(emit, cur, nan))
        if degenerate:
            # Jump to the next distinct valid timestamp; with none left the
            # reference breaks BEFORE the tail adjustment.
            nxt = torch.min(torch.where(valid & (times > cur), times, inf))
            active = emit & torch.isfinite(nxt)
        else:
            nxt = cur + step
            active = emit
        adjust = (nxt >= end) & (end >= cur + duration)
        cur = torch.where(adjust, torch.clamp(end - duration + 1e-6, min=t0), nxt)
    starts = torch.stack(starts) if starts else nan.expand(0).clone()
    return starts, torch.sum(torch.isfinite(starts)).to(torch.int32)
