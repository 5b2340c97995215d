"""K1 and K2: the port's associative scan (``ops.scan``) against the JAX
package.

The plain version of all eight combines is held against the JAX package's
scans on the CPU in float64: the Pallas kernel ``associative_scan_vmem`` in
interpret mode and ``jax.lax.associative_scan``, for N ∈ {1, 127, 128, 300,
1000}, forward and reverse. The 27-leaf filter and 12-leaf RTS combines are
held against ``associative_scan_fori``, the JAX package's own CPU scan for
exactly these combines: XLA:CPU needs minutes to compile their unrolled
ladders (measured on an 8-core Xeon host: 64 s for the interpret-mode
kernel and 349 s for ``lax.associative_scan`` of the filter at N = 1024).

K2's function (the scan for long leaves) is the same
``scan_plain``; it is held against the JAX package's tiled kernel
``associative_scan_tiled`` in interpret mode with 8-row blocks (1024
elements, so N = 2500 crosses two block carries), and for the filter and
RTS against ``associative_scan_fori`` at N = 2500. The routing between the
two kernels is the crossover measured on the card, held beside the JAX
package's ``_kernel_fits`` rule.

Each JAX reference is computed once per (combine, direction) at N = 1000;
the scan of a prefix is the prefix of the scan (the suffix, in reverse), so
the port runs at every N on the first (last) N elements.

Tolerance: ≤1e-10 relative to the leaf's magnitude (the scans associate in
different orders). The Möbius combine is projective (its consumer reads the
scale-free ratio p00/p10, and lax leaves the first element unnormalised),
so its elements are compared after dividing by their largest entry.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gps_optimize_slam_tpu.ops import alignment as jal
from gps_optimize_slam_tpu.ops import kalman_parallel as jkp
from gps_optimize_slam_tpu.ops import tridiag as jtd
from gps_optimize_slam_tpu.ops import pallas_scan as jps
from gps_optimize_slam_tpu.ops.pallas_scan import (
    associative_scan_fori,
    associative_scan_tiled,
    associative_scan_vmem,
)
from gps_optimize_slam_tpu_torch.ops import scan
from gps_optimize_slam_tpu_torch.ops.kalman_parallel import filter_elements

N_MAX = 1000
SIZES = [1, 127, 128, 300, 1000]
RTOL = 1e-10


def _quat_combine(a, b):
    x1, y1, z1, w1 = a
    x2, y2, z2, w2 = b
    x = w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2
    y = w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2
    z = w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2
    w = w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2
    n = jnp.sqrt(x * x + y * y + z * z + w * w)
    inv = jnp.where(n > 1e-9, 1.0 / jnp.where(n > 1e-9, n, 1.0), 1.0)
    return (x * inv, y * inv, z * inv, w * inv)


def _rts_combine(earlier, later):
    M2, c2 = earlier["M"], earlier["c"]
    M1, c1 = later["M"], later["c"]
    return dict(M=jkp._mmul(M1, M2), c=jkp._vadd(jkp._mvec(M1, c2), c1))


# name → (JAX combine, pytree from the (L, n) leaves, its identity)
def _flat(x):
    return tuple(x)


JAX_COMBINES = {
    "quat_chain": (_quat_combine, _flat, (0.0, 0.0, 0.0, 1.0)),
    "mobius": (jtd._mobius_combine, _flat, (1.0, 0.0, 0.0, 1.0)),
    "affine3": (jtd._affine_combine, lambda x: (x[0], tuple(x[1:])), (1.0, (0.0, 0.0, 0.0))),
    "add2": (jal._add_combine, _flat, (0.0, 0.0)),
    "max3": (jal._max_combine, _flat, (-float("inf"),) * 3),
    "min3": (jal._min_combine, _flat, (float("inf"),) * 3),
    "filter": (
        jkp._combine_filter,
        lambda x: dict(A=tuple(x[0:9]), b=tuple(x[9:12]), C=tuple(x[12:18]),
                       eta=tuple(x[18:21]), J=tuple(x[21:27])),
        jkp._FILTER_IDENTITY,
    ),
    "rts": (_rts_combine, lambda x: dict(M=tuple(x[0:9]), c=tuple(x[9:12])), jkp._RTS_IDENTITY),
}


def _leaves_back(op, tree):
    if op == "filter":
        return np.stack([np.asarray(v) for k in ("A", "b", "C", "eta", "J") for v in tree[k]])
    if op == "rts":
        return np.stack([np.asarray(v) for k in ("M", "c") for v in tree[k]])
    return np.stack([np.asarray(v) for v in jax.tree.leaves(tree)])


def scan_input(op, n, seed=0):
    """(L, n) float64 leaves shaped like the main path's."""
    rng = np.random.default_rng(seed)
    if op == "quat_chain":
        q = np.concatenate([0.05 * rng.normal(size=(n, 3)), np.ones((n, 1))], 1)
        return (q / np.linalg.norm(q, axis=1, keepdims=True)).T.copy()
    if op == "filter":
        d = torch.tensor(rng.normal(size=(n - 1, 3)))
        qd = torch.tensor([0.1, 0.1, 0.7])[None] * torch.tensor(rng.uniform(0.09, 0.11, n - 1))[:, None]
        z = torch.cumsum(d, 0) + 0.2 * torch.tensor(rng.normal(size=(n - 1, 3)))
        avail = torch.tensor(rng.uniform(size=n - 1) > 0.2)
        return filter_elements(
            torch.zeros(3, dtype=torch.float64), 0.1 * torch.eye(3, dtype=torch.float64),
            d.double(), qd.double(), torch.full((3,), 0.2, dtype=torch.float64), z.double(), avail,
        ).numpy()
    if op == "rts":
        e = np.zeros((9, n))
        for i in (0, 4, 8):
            e[i] = rng.uniform(0.5, 0.9, n)
        e[1] = e[3] = 0.05 * rng.normal(size=n)
        e[:, rng.uniform(size=n) > 0.8] = 0.0  # segment resets
        return np.concatenate([e, 10 * rng.normal(size=(3, n))])
    if op == "mobius":
        h = rng.uniform(0.08, 0.12, n)
        a = np.where(rng.uniform(size=n) > 0.1, h / 6, 0.0)  # zero rows decouple
        return np.stack([2 * h / 3, -(a * a), np.ones(n), np.zeros(n)])
    if op == "affine3":
        return np.concatenate([rng.uniform(-0.3, 0.0, (1, n)), rng.normal(size=(3, n))])
    if op == "add2":
        return (rng.uniform(size=(2, n)) > 0.5).astype(float)
    marked = rng.uniform(size=n) > 0.9
    fill = -np.inf if op == "max3" else np.inf
    idx = np.arange(n, dtype=float)
    return np.stack([np.where(marked, idx, fill), np.where(marked, 0.1 * idx, fill),
                     np.where(marked, np.floor(idx / 50), fill)])


@functools.lru_cache(maxsize=None)
def jax_reference(op, reverse, kind):
    combine, tree_of, ident = JAX_COMBINES[op]
    x = scan_input(op, N_MAX)
    tree = tree_of([jnp.asarray(v) for v in x])
    if kind == "vmem":
        out = associative_scan_vmem(combine, tree, ident, reverse=reverse, interpret=True)
    elif kind == "lax":
        out = jax.jit(lambda e: jax.lax.associative_scan(combine, e, reverse=reverse))(tree)
    else:
        out = jax.jit(lambda e: associative_scan_fori(combine, e, ident, reverse=reverse))(tree)
    return x, _leaves_back(op, out)


def _projective(x):
    return x / np.max(np.abs(x), axis=0, keepdims=True)


def _assert_close(op, got, want, rtol=RTOL):
    if op == "mobius":
        got, want = _projective(got), _projective(want)
    scale = np.where(np.isfinite(want), np.abs(want), 0.0).max(1, keepdims=True) + 1e-300
    same = (got == want) | (np.isnan(got) & np.isnan(want))
    with np.errstate(invalid="ignore"):
        err = np.where(same, 0.0, np.abs(got - want)) / scale
    assert err.max() <= rtol, f"{op}: rel err {err.max():.3e}"


CASES = [(op, kind) for op in ("quat_chain", "mobius", "affine3", "add2", "max3", "min3")
         for kind in ("vmem", "lax")] + [("filter", "fori"), ("rts", "fori")]


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("op,kind", CASES)
def test_plain_scan_matches_jax(op, kind, reverse):
    x, want = jax_reference(op, reverse, kind)
    for n in SIZES:
        sl = slice(N_MAX - n, N_MAX) if reverse else slice(0, n)
        got = scan.associative_scan(op, torch.tensor(x[:, sl]), reverse=reverse).numpy()
        _assert_close(op, got, want[:, sl])


@pytest.mark.parametrize("reverse", [False, True])
def test_noncommutative_mobius_products(reverse):
    """2×2 products are order-sensitive: the prefix is T_k ··· T_0, the
    suffix T_k ··· T_{n-1}; any argument-order slip is a gross mismatch."""
    rng = np.random.default_rng(7)
    n = 300
    m = np.eye(2)[None] + 0.1 * rng.normal(size=(n, 2, 2))
    x = np.stack([m[:, 0, 0], m[:, 0, 1], m[:, 1, 0], m[:, 1, 1]])
    got = scan.associative_scan("mobius", torch.tensor(x), reverse=reverse).numpy()
    want = np.empty_like(x)
    acc = np.eye(2)
    for k in (range(n - 1, -1, -1) if reverse else range(n)):
        acc = m[k] @ acc
        acc = acc / np.abs(acc).max()
        want[:, k] = acc.reshape(4)
    np.testing.assert_allclose(_projective(got), _projective(want), rtol=1e-10, atol=1e-12)


def test_cpu_tensors_take_the_plain_scan_without_launching():
    before = (dict(scan.scan_block.launches), dict(scan.scan_tiled.launches))
    x = torch.tensor(scan_input("affine3", 77))
    for fn in (scan.associative_scan, scan.scan_block, scan.scan_tiled):
        torch.testing.assert_close(fn("affine3", x), scan.scan_plain("affine3", x))
    assert (scan.scan_block.launches, scan.scan_tiled.launches) == before


def test_scan_rejects_bad_leaves():
    with pytest.raises(ValueError):
        scan.associative_scan("filter", torch.zeros(4, 10, dtype=torch.float64))
    with pytest.raises(TypeError):
        scan.associative_scan("add2", torch.zeros(2, 10, dtype=torch.int64))
    with pytest.raises(ValueError):
        scan.associative_scan("nope", torch.zeros(2, 10))


def _jax_routes_to_block(n_leaves, n, itemsize):
    return jps._kernel_fits(n_leaves, jps._round_up(max(n, jps._LANES), jps._LANES), itemsize)


@pytest.mark.parametrize("itemsize", [4, 8])
@pytest.mark.parametrize("n_leaves", [2, 3, 4, 12, 27])
def test_scan_route_matches_jax(n_leaves, itemsize):
    """The port routes at the crossover measured on the H100
    (``scan.BLOCK_MAX_ELEMENTS`` elements, whatever the leaves), not by the
    JAX package's 4 MiB VMEM budget. The two rules agree on the main path's
    shapes and part in between, either way: past the budget's last fit the
    port stays on K1 up to the crossover (12 and 27 leaves), and past the
    crossover it takes K2 where the budget would still hold (2-4 leaves)."""
    last_fit = jps._VMEM_BUDGET_BYTES // (2 * n_leaves * itemsize) // 128 * 128
    last = scan.BLOCK_MAX_ELEMENTS
    sizes = {1, 127, 128, 129, 4661, last_fit - 1, last_fit, last_fit + 1, last_fit + 128,
             last - 1, last, last + 1, 262_145, 524_289}
    for n in sorted(sizes):
        want = "block" if n <= last else "tiled"
        assert scan.scan_route(n_leaves, n, itemsize) == want, (n_leaves, n, itemsize)
    assert _jax_routes_to_block(n_leaves, last_fit, itemsize)
    assert not _jax_routes_to_block(n_leaves, last_fit + 1, itemsize)
    for n in (1, 271, 4661):  # the in-core path's shapes: K1 by both rules
        assert scan.scan_route(n_leaves, n, itemsize) == "block" and _jax_routes_to_block(n_leaves, n, itemsize)
    for n in (262_145, 524_289):  # the chunked path's: K2 by both rules
        assert scan.scan_route(n_leaves, n, itemsize) == "tiled" and not _jax_routes_to_block(n_leaves, n, itemsize)
    if last_fit < last:
        assert scan.scan_route(n_leaves, last_fit + 1, itemsize) == "block"
    elif last_fit > last:
        assert scan.scan_route(n_leaves, last_fit, itemsize) == "tiled"


TILED_CASES = [("add2", False), ("affine3", False), ("affine3", True), ("mobius", False),
               ("quat_chain", False)]


@pytest.mark.parametrize("op,reverse", TILED_CASES)
def test_plain_scan_matches_jax_tiled_kernel(op, reverse):
    combine, tree_of, ident = JAX_COMBINES[op]
    for n in (5, 1024, 2500):
        x = scan_input(op, n, seed=n)
        tree = tree_of([jnp.asarray(v) for v in x])
        out = associative_scan_tiled(combine, tree, ident, reverse=reverse, interpret=True,
                                     block_rows=8)
        got = scan.associative_scan(op, torch.tensor(x), reverse=reverse).numpy()
        _assert_close(op, got, _leaves_back(op, out))


@pytest.mark.parametrize("op,reverse", [("filter", False), ("rts", True)])
def test_plain_scan_matches_jax_beyond_one_tile(op, reverse):
    combine, tree_of, ident = JAX_COMBINES[op]
    n = 2500
    x = scan_input(op, n, seed=3)
    tree = tree_of([jnp.asarray(v) for v in x])
    want = _leaves_back(op, jax.jit(lambda e: associative_scan_fori(combine, e, ident,
                                                                   reverse=reverse))(tree))
    for m in (5, 1024, 2500):
        sl = slice(n - m, n) if reverse else slice(0, m)
        got = scan.associative_scan(op, torch.tensor(x[:, sl]), reverse=reverse).numpy()
        _assert_close(op, got, want[:, sl])


# --- K1's cross-tile structure (csrc/scan_lookback.cuh), emulated ----------
#
# The kernel cannot run here, so its association order is emulated with the
# port's own combines (the same arithmetic as csrc/scan_ops.cuh), at small
# warps and tiles: per tile, each thread folds its items into running
# prefixes, each warp scans its thread totals (shift-up steps, the earlier
# composite first) and puts each lane's exclusive prefix in front of its
# running prefixes (with one item a thread, the lane's inclusive prefix is
# taken as it is), the warp totals are scanned, the tile looks back over its
# predecessors a window at a time (aggregates until an inclusive prefix; the
# window folded in a shuffle-down tree, the farther half first; the window
# goes on the left of what was walked), and the warp's exclusive composite
# (tile carry, warp prefix) goes in front of every element, the very first
# element of the scan meeting the identity. Which predecessors have published their
# inclusive prefix is a schedule: at random, only tile 0 (the longest
# walk), or "persistent": K2's (csrc/scan_tiled.cu), where a few blocks
# each scan several tiles in ticket order, so the tiles the other blocks
# hold show aggregates and every older one its prefix. K2 shares the tile's
# steps with K1 and differs in its tile shape (more items a thread), which
# EMULATED_TILED mirrors. An argument-order slip in any step shows as a
# gross mismatch in these non-commutative combines.


def _comb(op, a, b):
    return torch.stack(scan.OPS[op][1](list(a), list(b)))


def _ident(op, *shape):
    ident = torch.tensor(scan.OPS[op][2], dtype=torch.float64)
    return ident.reshape(-1, *([1] * len(shape))).expand(-1, *shape).clone()


def _shift(v, d, fill):
    """v shifted d lanes up along the last axis (lane k reads lane k - d)."""
    return torch.cat([fill[..., :d], v[..., :-d]], -1)


def _lane_scan(op, v, width):
    """Inclusive shift-up scan over the last axis (width lanes)."""
    lane = torch.arange(width)
    d = 1
    while d < width:
        new = _comb(op, _shift(v, d, _ident(op, *v.shape[1:])), v)
        v = torch.where(lane >= d, new, v)
        d *= 2
    return v


def _tile_reduce(op, v, warp, warps, items):
    """Step 3 on one staged tile v (L, T, items): each thread's running
    prefixes made inclusive within its warp (one (L, T) tensor an item),
    the inclusive warp prefixes (L, warps) and the tile aggregate (L,)."""
    L, T = v.shape[0], warp * warps
    loc = [v[:, :, 0]]
    for i in range(1, items):
        loc.append(_comb(op, loc[-1], v[:, :, i]))
    acc = _lane_scan(op, loc[-1].reshape(L, warps, warp), warp)
    lane = torch.arange(warp)[None, :].expand(warps, warp)
    if items == 1:
        wl = [acc.reshape(L, T)]
    else:
        lane_excl = _shift(acc, 1, _ident(op, warps, warp)).reshape(L, T)
        wl = [torch.where(lane.reshape(T) > 0, _comb(op, lane_excl, p), p) for p in loc]
    wscan = _lane_scan(op, acc[:, :, -1], warps)
    return wl, wscan, wscan[:, -1]


def _tile_reduce_runs(op, v, warp, warps, items):
    """Step 3 of the filter's runs tile (csrc/scan_lookback.cuh
    tile_reduce_runs) on one staged tile v (L, T, items): each thread's run
    folded into a total, not written back; the ladder over the totals; the
    lane's exclusive prefix within its warp folded into the run's first
    element. Returns the runs so changed, the inclusive warp prefixes (L,
    warps) and the tile aggregate (L,)."""
    L, T = v.shape[0], warp * warps
    tot = v[:, :, 0]
    for i in range(1, items):
        tot = _comb(op, tot, v[:, :, i])
    acc = _lane_scan(op, tot.reshape(L, warps, warp), warp)
    lane = torch.arange(warp)[None, :].expand(warps, warp).reshape(T)
    lane_excl = _shift(acc, 1, _ident(op, warps, warp)).reshape(L, T)
    runs = v.clone()
    runs[:, :, 0] = torch.where(lane > 0, _comb(op, lane_excl, v[:, :, 0]), v[:, :, 0])
    wscan = _lane_scan(op, acc[:, :, -1], warps)
    return runs, wscan, wscan[:, -1]


def _tile_finish_runs(op, t, carry, runs, wscan, warp, warps, items):
    """Step 5 of the runs tile (tile_finish_runs): the warp's exclusive
    composite (tile carry, then the earlier warps' prefix), once a warp,
    starts each thread's second pass over its run; without one (tile 0,
    warp 0) thread 0 starts from the identity and the other threads from
    their run's first element, which holds their lane prefix; (L, T, items)."""
    L, T = wscan.shape[0], warp * warps
    wid = torch.arange(warps)[:, None].expand(warps, warp).reshape(T)
    warp_pre = torch.cat([_ident(op, 1), wscan[:, :-1]], 1)[:, :, None].expand(L, warps, warp).reshape(L, T)
    if t > 0:
        pre = carry[:, None].expand(L, T)
        pre = torch.where(wid > 0, _comb(op, pre, warp_pre), pre)
        have = torch.ones(T, dtype=torch.bool)
    else:
        pre = warp_pre  # the identity for warp 0
        have = (wid > 0) | (torch.arange(T) == 0)
    res = torch.empty(L, T, items, dtype=torch.float64)
    acc = torch.where(have, _comb(op, pre, runs[:, :, 0]), runs[:, :, 0])
    res[:, :, 0] = acc
    for i in range(1, items):
        acc = _comb(op, acc, runs[:, :, i])
        res[:, :, i] = acc
    return res


# (warp, warps, items, window) of the runs tile's emulation: two items a
# thread, so that each run folds in registers; the filter's input is its
# ladder cases' 31 elements (3 tiles of 8 and a ragged tail), whose JAX
# reference those cases compile already.
EMULATED_RUNS = {"mobius": (4, 2, 2, 4), "rts": (4, 2, 2, 4), "quat_chain": (4, 2, 2, 4), "filter": (2, 2, 2, 2)}


def _window_fold(op, vals, last, window, swap=False):
    """Lane 0's fold of a look-back window vals (L, window), lane 0 the
    nearest predecessor, over lanes [0, last] (shuffle-down tree, the
    farther half first; ``swap`` puts the nearer half first, the slip the
    tests show the emulations catch)."""
    d = 1
    while d <= last:
        moved = torch.cat([vals[:, d:], _ident(op, d)], 1)  # lane k reads lane k + d
        new = _comb(op, vals, moved) if swap else _comb(op, moved, vals)
        vals = torch.where(torch.arange(window) + d < window, new, vals)
        d *= 2
    return vals[:, 0]


def _tile_finish(op, t, carry, wl, wscan, warp, warps, items):
    """Step 5: the warp's exclusive composite (tile carry, warp prefix) in
    front of every element, the very first element of a row meeting the
    identity; (L, T, items)."""
    L, T = wscan.shape[0], warp * warps
    wid = torch.arange(warps)[:, None].expand(warps, warp).reshape(T)
    warp_pre = torch.cat([_ident(op, 1), wscan[:, :-1]], 1)[:, :, None].expand(L, warps, warp).reshape(L, T)
    if t > 0:
        pre = carry[:, None].expand(L, T)
        pre = torch.where(wid > 0, _comb(op, pre, warp_pre), pre)
    else:
        pre = warp_pre
    res = torch.empty(L, T, items, dtype=torch.float64)
    for i in range(items):
        res[:, :, i] = torch.where((wid > 0) | (t > 0), _comb(op, pre, wl[i]), wl[i])
    if t == 0:
        res[:, 0, 0] = _comb(op, _ident(op, 1), wl[0][:, :1])[:, 0]
    return res


def emulate_lookback_scan(op, x, reverse, schedule, warp, warps, items, window, seed=0, blocks=3, tile="ladder"):
    """(L, n) leaves, or (L, B, n) for K1's batch grid: one ticket counter
    over every row's tiles in row-major order (ticket g is tile g % n_tiles
    of row g // n_tiles), the flags and values a slot per (row, tile), and a
    look-back that walks its row's slots only and stops at the row's first
    tile. ``tile``: the tile's steps 3 and 5, "ladder" (every combine's
    tile, and the filter's below kRunsMinF32 / kRunsMinF64 elements a
    launch) or "runs" (the filter's work-efficient tile above them)."""
    tile_kind = tile
    rng = np.random.default_rng(seed)
    batched = x.ndim == 3
    xs = x if batched else x[:, None]
    xs = xs.flip(-1) if reverse else xs  # scan order
    L, B, n = xs.shape
    T = warp * warps
    tile = T * items
    n_tiles = -(-n // tile)
    padded = torch.cat([xs, _ident(op, B, n_tiles * tile - n)], -1)
    out = torch.empty_like(padded)
    agg, incl = {}, {}  # by slot: the row's first slot plus the tile
    for ticket in range(B * n_tiles):
        row, t = divmod(ticket, n_tiles)

        def slot(p, row=row):
            return row * n_tiles + p

        v = padded[:, row, t * tile : (t + 1) * tile].reshape(L, T, items)
        reduce = _tile_reduce_runs if tile_kind == "runs" else _tile_reduce
        wl, wscan, tot = reduce(op, v, warp, warps, items)
        carry = None
        if t == 0:
            incl[slot(0)] = tot
        else:
            agg[slot(t)] = tot
            has_prefix = {j: j == 0 or (schedule == "random" and rng.uniform() < 0.3)
                          or (schedule == "persistent" and slot(j) <= ticket - blocks) for j in range(t)}
            run, base = None, t - 1
            while True:
                preds = [base - k for k in range(window)]
                prefix = [p >= 0 and has_prefix[p] for p in preds]
                last = prefix.index(True) if any(prefix) else window - 1
                vals = torch.stack([
                    (incl[slot(p)] if prefix[k] else agg[slot(p)]) if (k <= last and p >= 0) else _ident(op)
                    for k, p in enumerate(preds)], 1)  # (L, window), lane 0 the nearest
                folded = _window_fold(op, vals, last, window)
                run = folded if run is None else _comb(op, folded, run)
                if any(prefix):
                    break
                base -= window
            carry = run
            incl[slot(t)] = _comb(op, run, tot)
        finish = _tile_finish_runs if tile_kind == "runs" else _tile_finish
        out[:, row, t * tile : (t + 1) * tile] = finish(op, t, carry, wl, wscan, warp, warps, items).reshape(L, tile)
    out = out[..., :n]
    out = out.flip(-1) if reverse else out
    return out if batched else out[:, 0]


def emulate_cluster_scan(op, x, reverse, warp, warps, items, tile="ladder", max_cluster=16, swap=False):
    """K1's cluster path (csrc/scan_cluster.cuh) on (L, n) or (L, B, n)
    leaves: a cluster a row of C = tiles(n) <= ``max_cluster`` blocks; block
    rank r stages scan-order tile r of its row and reduces it (``tile``:
    the ladder's steps, or the runs tile's), and after the cluster barrier
    lane k of its warp 0 holds the aggregate of rank r - 1 - k (the
    identity past rank 0, 32 lanes), folded in the look-back's
    shuffle-down tree, the farther (earlier) half first: the carry, ranks
    0..r-1 composed with the earlier composite first. The tile is then
    finished from that carry as the look-back path finishes it. ``swap``
    folds the nearer composite first, the slip the tests show is caught."""
    batched = x.ndim == 3
    xs = x if batched else x[:, None]
    xs = xs.flip(-1) if reverse else xs  # scan order
    L, B, n = xs.shape
    T = warp * warps
    size = T * items
    C = -(-n // size)
    assert 1 <= C <= max_cluster, f"{n} elements take {C} tiles of {size}"
    padded = torch.cat([xs, _ident(op, B, C * size - n)], -1)
    out = torch.empty_like(padded)
    reduce = _tile_reduce_runs if tile == "runs" else _tile_reduce
    finish = _tile_finish_runs if tile == "runs" else _tile_finish
    for row in range(B):
        tiles = [reduce(op, padded[:, row, r * size : (r + 1) * size].reshape(L, T, items), warp, warps, items)
                 for r in range(C)]
        for r, (wl, wscan, _) in enumerate(tiles):
            carry = None
            if r > 0:
                lanes = torch.stack([tiles[r - 1 - k][2] if k < r else _ident(op) for k in range(32)], 1)
                carry = _window_fold(op, lanes, r - 1, 32, swap)
            out[:, row, r * size : (r + 1) * size] = finish(op, r, carry, wl, wscan, warp, warps,
                                                            items).reshape(L, size)
    out = out[..., :n]
    out = out.flip(-1) if reverse else out
    return out if batched else out[:, 0]


def emulate_tiled_scan(op, x, reverse, warp, warps, items, window, blocks, seed=0, ahead=None):
    """K2 (csrc/scan_tiled.cu) on (L, n) or (L, B, n) leaves, as its
    persistent blocks run it: ``blocks`` blocks each draw a ticket from one
    counter over every row's tiles (ticket t is tile t % n_tiles of row
    t // n_tiles), stage the NEXT ticket's tile into their other buffer
    before they scan the present one (``ahead``, the 2-4-leaf combines;
    the costly ones stage the present tile at the top of each round), and
    publish, look back and store through flags and values a slot per (row,
    tile). The staging and the store compute each element's address in the
    (L, B, n) image as the kernel does: the ticket's row base r * n, leaf
    stride B * n, scan order k at position n - 1 - k under ``reverse``, the
    identity past n. The blocks interleave at random (``seed``) at every
    point where the kernel may wait or be overtaken, and a look-back whose
    window holds an empty flag spins; a schedule that stops making progress
    fails the emulation (forward progress)."""
    rng = np.random.default_rng(seed)
    batched = x.ndim == 3
    xs = x if batched else x[:, None]
    L, B, n = xs.shape
    T = warp * warps
    tile = T * items
    n_tiles = -(-n // tile)
    tickets = B * n_tiles
    ahead = L < 12 if ahead is None else ahead
    image = xs.reshape(L, B * n).clone()  # leaf l of row r at l * B * n + r * n
    out = torch.full_like(image, float("nan"))
    e = torch.arange(tile)

    def address(t):
        row, k0 = divmod(t, n_tiles)
        k = k0 * tile + e
        return k < n, row * n + ((n - 1 - k) if reverse else k).clamp(0, n - 1)

    def stage(t):
        ok, at = address(t)
        return (t, torch.where(ok, image[:, at], _ident(op, tile)))

    counter = [0]
    flags = np.zeros(tickets, int)  # 0 empty, 1 aggregate, 2 prefix; slot row * n_tiles + tile
    agg, incl = {}, {}

    def draw():
        counter[0] += 1
        return counter[0] - 1

    def block():
        t = draw()
        yield
        buf = [stage(t) if ahead and t < tickets else None, None]
        b = 0
        while t < tickets:
            nxt = draw()
            yield
            if ahead:
                if nxt < tickets:
                    buf[b ^ 1] = stage(nxt)  # may be the next row's tile 0
                cur = buf[b]
                b ^= 1
            else:
                cur = stage(t)
            assert cur[0] == t, "a block scans a tile it did not stage"
            row, tt = divmod(t, n_tiles)
            base = row * n_tiles
            wl, wscan, tot = _tile_reduce(op, cur[1].reshape(L, T, items), warp, warps, items)
            carry = None
            if tt == 0:
                incl[base] = tot
                flags[base] = 2
            else:
                agg[base + tt] = tot
                flags[base + tt] = 1
                yield
                run, pos = None, tt - 1
                while True:
                    preds = [pos - k for k in range(window)]
                    while any(p >= 0 and flags[base + p] == 0 for p in preds):
                        yield "spin"
                    prefix = [p >= 0 and flags[base + p] == 2 for p in preds]
                    last = prefix.index(True) if any(prefix) else window - 1
                    vals = torch.stack([
                        (incl[base + p] if prefix[k] else agg[base + p]) if (k <= last and p >= 0) else _ident(op)
                        for k, p in enumerate(preds)], 1)
                    folded = _window_fold(op, vals, last, window)
                    run = folded if run is None else _comb(op, folded, run)
                    if any(prefix):
                        break
                    pos -= window
                    yield
                carry = run
                incl[base + tt] = _comb(op, run, tot)
                flags[base + tt] = 2
            yield
            res = _tile_finish(op, tt, carry, wl, wscan, warp, warps, items).reshape(L, tile)
            ok, at = address(t)
            out[:, at[ok]] = res[:, ok]
            t = nxt

    live = [block() for _ in range(blocks)]
    spins = 0
    while live:
        k = int(rng.integers(len(live)))
        try:
            step = next(live[k])
        except StopIteration:
            live.pop(k)
            continue
        spins = spins + 1 if step == "spin" else 0
        assert spins < 1000 * blocks, "the blocks stopped making progress"
    assert counter[0] == tickets + blocks  # every block drew one ticket past the last
    assert not torch.isnan(out).any()
    got = out.reshape(L, B, n)
    return got if batched else got[:, 0]


def emulate_tiled_grid(op, x, reverse, warp, warps, items, window, blocks, stages, seed=0, vec=2, misalign=0,
                       swap=False):
    """K2's batch grid (csrc/scan_tiled.cu ``tiled_grid_kernel``) on (L, B,
    n) or (L, n) leaves, as its persistent blocks run it. Each block is
    three interleaved actors over a ring of ``stages`` tiles. Its producer
    warp draws a ticket (one counter over every row's tiles, row-major) only
    when a stage is free (its tile stored and that tile's aggregate out),
    stages that tile at once, and, once the compute warps have reduced a
    tile, walks its look-back (windows of ``window`` predecessors folded in
    the shuffle-down tree, the window on the left of what was walked;
    ``swap`` puts the nearer composite first, the slip the tests show is
    caught) and hands over the carry. Its compute warps reduce tile i with
    the runs tile, then finish and store tile i - 1 with its carry and free
    its stage. Its publisher warp publishes each reduced tile's aggregate (a
    row's first tile: its prefix) whenever the schedule lets it run (the
    filter's blocks have no publisher warp: their compute thread 0
    publishes, in the same order of work). A stage is staged by the
    kernel's own arithmetic: each leaf's span lands in memory order at the
    offset that puts its 16-byte interior on a boundary (``vec`` elements,
    the image's first element ``misalign`` elements past one), the identity
    past the row's end, and ``reverse`` reads it backwards
    (``StagedTile``). The actors interleave at random (``seed``) wherever
    the kernel may wait or be overtaken; a schedule that stops making
    progress fails the emulation."""
    rng = np.random.default_rng(seed)
    batched = x.ndim == 3
    xs = x if batched else x[:, None]
    L, B, n = xs.shape
    T = warp * warps
    tile = T * items
    stride = tile + vec
    n_tiles = -(-n // tile)
    tickets = B * n_tiles
    ld = B * n
    image = xs.reshape(L, ld).clone()  # leaf l of row r at l * B * n + r * n
    out = torch.full_like(image, float("nan"))
    ident = _ident(op)
    counter = [0]
    flags = np.zeros(tickets, int)  # 0 empty, 1 aggregate, 2 prefix
    agg, incl = {}, {}

    def span(t):
        row, k = divmod(t, n_tiles)
        k0 = k * tile
        cnt = min(tile, n - k0)
        return row, k, k0, cnt, (n - k0 - cnt if reverse else k0)

    def offset(l, mis0, pad):
        mis = (mis0 + l * ld) % vec
        return ((mis - pad) % vec) + tile - 1 if reverse else mis

    def index(l, e, mis0, pad):
        return offset(l, mis0, pad) - e if reverse else offset(l, mis0, pad) + e

    def stage_tile(t):
        """The ring stage the producer writes for ticket t."""
        row, _, k0, cnt, m0 = span(t)
        pad = tile - cnt
        first = row * n + m0
        mis0 = (misalign + first) % vec
        buf = torch.full((L, stride), float("nan"), dtype=image.dtype)
        for l in range(L):
            mis = (misalign + l * ld + first) % vec
            assert mis == (mis0 + l * ld) % vec
            head = min((vec - mis) % vec, cnt)
            body = (cnt - head) // vec * vec
            q0 = offset(l, mis0, pad) - (cnt - 1) if reverse else offset(l, mis0, pad)
            assert 0 <= q0 and q0 + cnt <= stride and (body == 0 or (q0 + head) % vec == 0)
            buf[l, q0 : q0 + cnt] = image[l, first : first + cnt]  # head, bulk interior, tail
            for e in range(cnt, tile):
                buf[l, index(l, e, mis0, pad)] = ident[l]
        return {"t": t, "buf": buf, "mis0": mis0, "pad": pad}

    def scan_order(st):
        e = torch.arange(tile)
        cols = torch.stack([torch.tensor([index(l, int(k), st["mis0"], st["pad"]) for k in e]) for l in range(L)])
        return torch.gather(st["buf"], 1, cols).reshape(L, T, items)

    def draw():
        counter[0] += 1
        return counter[0] - 1

    def actors():
        ring = [None] * stages
        done = {"full": [0] * stages, "reduced": [0] * stages, "published": [0] * stages, "carried": [0] * stages,
                "freed": [0] * stages}

        def stage(s):
            t = draw()
            ring[s] = stage_tile(t) if t < tickets else {"t": t}
            done["full"][s] += 1
            return t < tickets

        def producer():
            more = True
            for s in range(stages):
                if not more:
                    break
                more = stage(s)
                yield
            i = 0
            while True:
                s, use = i % stages, i // stages
                t = ring[s]["t"]
                if t >= tickets:
                    return
                while done["reduced"][s] <= use:
                    yield "spin"
                row, tt = divmod(t, n_tiles)
                base = row * n_tiles
                tot = ring[s]["tot"]
                if tt > 0:  # its aggregate (tile 0: its prefix) goes out from the publisher
                    run, pos = None, tt - 1
                    while True:
                        preds = [pos - k for k in range(window)]
                        while any(p >= 0 and flags[base + p] == 0 for p in preds):
                            yield "spin"
                        prefix = [p >= 0 and flags[base + p] == 2 for p in preds]
                        last = prefix.index(True) if any(prefix) else window - 1
                        vals = torch.stack([
                            (incl[base + p] if prefix[k] else agg[base + p]) if (k <= last and p >= 0)
                            else _ident(op) for k, p in enumerate(preds)], 1)
                        folded = _window_fold(op, vals, last, window, swap)
                        run = folded if run is None else (_comb(op, run, folded) if swap else _comb(op, folded, run))
                        if any(prefix):
                            break
                        pos -= window
                        yield
                    ring[s]["carry"] = run
                    incl[base + tt], flags[base + tt] = _comb(op, run, tot), 2
                done["carried"][s] += 1
                yield
                if more:  # the stage is free once its tile is stored and its aggregate out
                    while done["freed"][s] <= use or done["published"][s] <= use:
                        yield "spin"
                    more = stage(s)
                    yield
                i += 1

        def publisher():
            i = 0
            while True:
                s, use = i % stages, i // stages
                while done["full"][s] <= use:
                    yield "spin"
                if ring[s]["t"] >= tickets:
                    return
                while done["reduced"][s] <= use:
                    yield "spin"
                row, tt = divmod(ring[s]["t"], n_tiles)
                if tt == 0:
                    incl[row * n_tiles], flags[row * n_tiles] = ring[s]["tot"], 2
                else:
                    agg[row * n_tiles + tt], flags[row * n_tiles + tt] = ring[s]["tot"], 1
                done["published"][s] += 1
                yield
                i += 1

        def finish(i):
            s, use = i % stages, i // stages
            while done["carried"][s] <= use:
                yield "spin"
            st = ring[s]
            row, tt, k0, cnt, _ = span(st["t"])
            res = _tile_finish_runs(op, tt, st.get("carry"), st["runs"], st["wscan"], warp, warps, items).reshape(L, tile)
            e = torch.arange(cnt)
            out[:, row * n + ((n - 1 - k0 - e) if reverse else (k0 + e))] = res[:, :cnt]
            done["freed"][s] += 1
            yield

        def consumer():
            i = 0
            while True:
                s, use = i % stages, i // stages
                while done["full"][s] <= use:
                    yield "spin"
                st = ring[s]
                if st["t"] >= tickets:
                    break
                st["runs"], st["wscan"], st["tot"] = _tile_reduce_runs(op, scan_order(st), warp, warps, items)
                done["reduced"][s] += 1
                yield
                if i > 0:
                    yield from finish(i - 1)
                i += 1
            if i > 0:
                yield from finish(i - 1)

        return [producer(), consumer(), publisher()]

    live = [a for _ in range(blocks) for a in actors()]
    spins = 0
    while live:
        k = int(rng.integers(len(live)))
        try:
            step = next(live[k])
        except StopIteration:
            live.pop(k)
            continue
        spins = spins + 1 if step == "spin" else 0
        assert spins < 1000 * blocks, "the blocks stopped making progress"
    assert counter[0] == tickets + blocks  # every block drew one ticket past the last
    assert not torch.isnan(out).any()
    got = out.reshape(L, B, n)
    return got if batched else got[:, 0]


# (warp, warps, items, window) per combine: small tiles, so that 7 tiles
# stay short where the JAX references compile slowly (lax.associative_scan
# of the 27-leaf filter: ~27 s at 31 elements on an 8-core Xeon host).
EMULATED = {"mobius": (4, 2, 2, 4), "rts": (4, 2, 2, 4), "quat_chain": (4, 2, 2, 4), "filter": (2, 2, 1, 2)}
# K2's tile shape: more items a thread (the float32 filter has 2).
EMULATED_TILED = {"mobius": (4, 2, 4, 4), "rts": (4, 2, 4, 4), "filter": (2, 2, 2, 2)}


@functools.lru_cache(maxsize=None)
def lookback_reference(op, reverse, tiled=False):
    """The input at 7 tiles plus a ragged tail of 3, and the JAX scan of it:
    lax.associative_scan, but associative_scan_fori for the reverse filter
    (the main path scans the filter forward only, and lax's reverse filter
    would compile for another ~27 s) and for the filter at K2's longer
    tiles."""
    warp, warps, items, _ = (EMULATED_TILED if tiled else EMULATED)[op]
    n = 7 * warp * warps * items + 3
    combine, tree_of, ident = JAX_COMBINES[op]
    x = scan_input(op, n, seed=5)
    tree = tree_of([jnp.asarray(v) for v in x])
    if op == "filter" and (reverse or tiled):
        out = jax.jit(lambda e: associative_scan_fori(combine, e, ident, reverse=reverse))(tree)
    else:
        out = jax.jit(lambda e: jax.lax.associative_scan(combine, e, reverse=reverse))(tree)
    return x, _leaves_back(op, out)


@pytest.mark.parametrize("schedule", ["random", "aggregates"])
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("op", list(EMULATED))
def test_lookback_structure_matches_plain_and_jax(op, reverse, schedule):
    warp, warps, items, window = EMULATED[op]
    tile = warp * warps * items
    x, want = lookback_reference(op, reverse)
    n_max = x.shape[1]
    for n in (tile, 2 * tile, n_max):  # 1, 2 and 7 tiles plus a ragged tail
        sl = slice(n_max - n, n_max) if reverse else slice(0, n)
        xt = torch.tensor(x[:, sl])
        got = emulate_lookback_scan(op, xt, reverse, schedule, warp, warps, items, window).numpy()
        _assert_close(op, got, scan.scan_plain(op, xt, reverse).numpy(), rtol=1e-12)
        _assert_close(op, got, want[:, sl], rtol=1e-12)


@pytest.mark.parametrize("schedule", ["random", "aggregates"])
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("op", list(EMULATED_RUNS))
def test_runs_tile_schedule_matches_plain_and_jax(op, reverse, schedule):
    """The runs tile at two items a thread and two warps
    (``EMULATED_RUNS``), on the filter itself (its ladder cases' input: 1,
    2 and 3 tiles plus a ragged tail), on rts and quat_chain (which take it
    in long batches) and on mobius (1, 2 and 7 tiles plus a ragged tail):
    the runs folded in
    registers, the ladder over the thread totals, the lane prefix in the
    run's first element, the warp's composite once a warp, against the
    plain and JAX scans, and two rows in one batch grid against each row
    alone."""
    warp, warps, items, window = EMULATED_RUNS[op]
    tile = warp * warps * items
    x, want = lookback_reference(op, reverse)
    n_max = x.shape[1]
    for n in (tile, 2 * tile, n_max):
        sl = slice(n_max - n, n_max) if reverse else slice(0, n)
        xt = torch.tensor(x[:, sl])
        got = emulate_lookback_scan(op, xt, reverse, schedule, warp, warps, items, window, tile="runs").numpy()
        _assert_close(op, got, scan.scan_plain(op, xt, reverse).numpy(), rtol=1e-12)
        _assert_close(op, got, want[:, sl], rtol=1e-12)
    rows = torch.stack([torch.tensor(x[:, :2 * tile + 3]), torch.tensor(x[:, 5:2 * tile + 8])], 1)
    got = emulate_lookback_scan(op, rows, reverse, schedule, warp, warps, items, window, tile="runs")
    for r in range(2):
        alone = emulate_lookback_scan(op, rows[:, r].contiguous(), reverse, "aggregates", warp, warps, items,
                                      window, tile="runs")
        _assert_close(op, got[:, r].numpy(), alone.numpy(), rtol=1e-12)
        if schedule == "aggregates":
            assert torch.equal(got[:, r], alone)


@pytest.mark.parametrize("schedule", ["persistent", "random"])
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("op", list(EMULATED_TILED))
def test_tiled_lookback_structure_matches_plain_and_jax(op, reverse, schedule):
    """K2: 7 tiles and a ragged tail over 3 persistent blocks (each scans
    two or three tiles in ticket order), 2 tiles (fewer tiles than blocks)
    and one partial tile."""
    warp, warps, items, window = EMULATED_TILED[op]
    tile = warp * warps * items
    x, want = lookback_reference(op, reverse, tiled=True)
    n_max = x.shape[1]
    for n in (tile - 1, 2 * tile, n_max):
        sl = slice(n_max - n, n_max) if reverse else slice(0, n)
        xt = torch.tensor(x[:, sl])
        got = emulate_lookback_scan(op, xt, reverse, schedule, warp, warps, items, window, blocks=3).numpy()
        _assert_close(op, got, scan.scan_plain(op, xt, reverse).numpy(), rtol=1e-12)
        _assert_close(op, got, want[:, sl], rtol=1e-12)


@pytest.mark.parametrize("schedule", ["random", "aggregates"])
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("op", list(EMULATED))
def test_batched_lookback_stops_at_its_rows_first_tile(op, reverse, schedule):
    """K1's batch grid: three rows of 2 tiles plus a ragged tail scanned in
    one emulated launch (tickets over all rows' tiles, a slot per (row,
    tile)). Every row equals the plain scan of that row, the batched plain
    scan, and the single-row emulation bit for bit: a look-back that walked
    past its row's first tile would fold the previous row in."""
    warp, warps, items, window = EMULATED[op]
    n = 2 * warp * warps * items + 3
    x = torch.stack([torch.tensor(scan_input(op, n, seed=11 + r)) for r in range(3)], 1)  # (L, 3, n)
    got = emulate_lookback_scan(op, x, reverse, schedule, warp, warps, items, window)
    plain = scan.scan_plain(op, x, reverse)
    for r in range(3):
        row = x[:, r].contiguous()
        assert torch.equal(plain[:, r], scan.scan_plain(op, row, reverse))
        _assert_close(op, got[:, r].numpy(), plain[:, r].numpy(), rtol=1e-12)
        single = emulate_lookback_scan(op, row, reverse, "aggregates", warp, warps, items, window)
        if schedule == "aggregates":  # the same walk as alone: the same bits
            assert torch.equal(got[:, r], single)


@pytest.mark.parametrize("op", list(scan.OPS))
def test_batched_plain_scan_equals_each_row_alone(op):
    """(L, B, n) leaves: each row of the batched ladder equals the scan of
    that row alone bit for bit, in both directions, and the wrappers (K1's
    and K2's batch grids) take the batched ladder on CPU tensors without
    launching."""
    L = len(scan.OPS[op][2])
    x = torch.stack([torch.tensor(scan_input(op, 300, seed=r)) for r in range(4)], 1)
    assert x.shape == (L, 4, 300)
    before = (dict(scan.scan_block.launches), dict(scan.scan_tiled.launches))
    for reverse in (False, True):
        got = scan.associative_scan(op, x, reverse)
        assert torch.equal(got, scan.scan_block(op, x, reverse))
        for r in range(4):
            assert torch.equal(got[:, r], scan.scan_plain(op, x[:, r].contiguous(), reverse))
        assert torch.equal(got, scan.scan_tiled(op, x, reverse))  # K2's batch grid, its plain version
    assert (scan.scan_block.launches, scan.scan_tiled.launches) == before


# --- K1's cluster path (csrc/scan_cluster.cuh), emulated --------------------
#
# A batch of short rows launches a thread-block cluster a row: block rank r
# reduces tile r, and after the cluster barrier folds the aggregates of
# ranks 0..r-1, read from their shared memory, in the look-back's
# shuffle-down tree (``emulate_cluster_scan``). No schedule: the order is
# fixed by the ranks, so a row's result is the same in any batch.

CLUSTER_OPS = [op for op in scan.OPS if op != "filter"]  # the filter keeps the look-back path
# The cluster tile of each combine at the fleet's rows (csrc/scan_cluster.cuh
# ClusterTile: its steps, threads, items a thread): a row of 4,661 takes
# 10 or 5 blocks. The card's tests hold these to ``scan.block_tile`` /
# ``scan.block_cluster``.
CLUSTER_TILE = {"quat_chain": ("runs", 128, 4), "rts": ("runs", 128, 4), "mobius": ("runs", 128, 4),
                "affine3": ("runs", 128, 8), "add2": ("runs", 128, 8), "max3": ("runs", 128, 8),
                "min3": ("runs", 128, 8)}
KITTI = (4541, 1101, 4661, 801, 271, 2761, 1101, 1101, 4071, 1591, 1201)  # the odometry sequences 00-10
NONCOMMUTATIVE = ("quat_chain", "rts", "mobius")
RUNS_ITEMS = {"rts": 4, "quat_chain": 8}  # csrc/scan_lookback.cuh RunsTile: 128 threads


@functools.lru_cache(maxsize=None)
def cluster_reference(op, reverse):
    """The input at 7 tiles of 16 plus a ragged tail of 3 (8 tiles, the
    largest cluster) and ``jax.lax.associative_scan`` of it."""
    n = 7 * 16 + 3
    combine, tree_of, _ = JAX_COMBINES[op]
    x = scan_input(op, n, seed=5)
    tree = tree_of([jnp.asarray(v) for v in x])
    return x, _leaves_back(op, jax.jit(lambda e: jax.lax.associative_scan(combine, e, reverse=reverse))(tree))


@pytest.mark.parametrize("tile", ["ladder", "runs"])
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("op", CLUSTER_OPS)
def test_cluster_order_matches_plain_and_jax(op, reverse, tile):
    """Every combine of the cluster path at 16-element tiles (4 lanes x 2
    warps x 2 items) on the ladder's and the runs tile's steps: one tile,
    one element past a tile, two tiles and eight (7 plus a ragged tail),
    against the plain scan and JAX's, and two rows in one batch, each equal
    bit for bit to the row alone (the order does not depend on the batch)."""
    x, want = cluster_reference(op, reverse)
    n_max = x.shape[1]
    for n in (16, 17, 32, n_max):
        sl = slice(n_max - n, n_max) if reverse else slice(0, n)
        xt = torch.tensor(x[:, sl])
        got = emulate_cluster_scan(op, xt, reverse, 4, 2, 2, tile=tile).numpy()
        _assert_close(op, got, scan.scan_plain(op, xt, reverse).numpy(), rtol=1e-12)
        _assert_close(op, got, want[:, sl], rtol=1e-12)
    rows = torch.stack([torch.tensor(x[:, :40]), torch.tensor(x[:, 9:49])], 1)
    got = emulate_cluster_scan(op, rows, reverse, 4, 2, 2, tile=tile)
    for r in range(2):
        assert torch.equal(got[:, r], emulate_cluster_scan(op, rows[:, r].contiguous(), reverse, 4, 2, 2, tile=tile))


def kitti_rows(op, ns, n):
    """(L, len(ns), n) float64 leaves: row r is ``scan_input`` at ns[r]
    (seeded apart), then the combine's identity to n, as the padded rows of
    a bucket end."""
    ident = torch.tensor(scan.OPS[op][2], dtype=torch.float64)[:, None]
    return torch.stack([torch.cat([torch.tensor(scan_input(op, k, seed=20 + r)), ident.expand(-1, n - k)], 1)
                        for r, k in enumerate(ns)], 1)


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("op", CLUSTER_OPS)
def test_cluster_path_on_ragged_kitti_rows(op, reverse):
    """The cluster path at the card's geometry (32 lanes, the combine's
    cluster tile): the eleven KITTI lengths as one ragged batch of 4,661 (5
    or 10 blocks a row) and two rows one element past a tile (2 blocks), each row against the plain scan to the file's tolerance, and
    bit for bit against the same row scanned alone."""
    tile, threads, items = CLUSTER_TILE[op]
    size = threads * items
    for ns, n in ((KITTI, max(KITTI)), ((size + 1, size - 7), size + 1)):
        x = kitti_rows(op, ns, n)
        got = emulate_cluster_scan(op, x, reverse, 32, threads // 32, items, tile=tile)
        plain = scan.scan_plain(op, x, reverse)
        for r in range(len(ns)):
            _assert_close(op, got[:, r].numpy(), plain[:, r].numpy())
        alone = emulate_cluster_scan(op, x[:, 1].contiguous(), reverse, 32, threads // 32, items, tile=tile)
        assert torch.equal(got[:, 1], alone)


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("op", ["rts", "quat_chain"])
def test_runs_tile_on_ragged_kitti_rows(op, reverse):
    """rts and quat_chain on the look-back path's runs tile at the card's
    geometry for them (32 lanes, 4 warps, 4 items a thread for rts and 8
    for quat_chain: 10 or 5 tiles a row), the eleven KITTI lengths as one
    ragged batch, tickets over every row's tiles with a random schedule of
    published prefixes: each row against the plain scan to the file's
    tolerance."""
    x = kitti_rows(op, KITTI, max(KITTI))
    got = emulate_lookback_scan(op, x, reverse, "random", 32, 4, RUNS_ITEMS[op], 32, tile="runs")
    plain = scan.scan_plain(op, x, reverse)
    for r in range(len(KITTI)):
        _assert_close(op, got[:, r].numpy(), plain[:, r].numpy())


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("op", NONCOMMUTATIVE)
def test_a_swapped_cluster_fold_fails(op, reverse):
    """The emulation catches an argument-order slip in the carry's fold:
    with the nearer composite first (``swap``) the non-commutative combines
    leave the plain scan by far more than the file's tolerance in both
    directions, while the right order stays within it."""
    x, _ = cluster_reference(op, reverse)
    xt = torch.tensor(x)
    plain = scan.scan_plain(op, xt, reverse).numpy()
    _assert_close(op, emulate_cluster_scan(op, xt, reverse, 4, 2, 2).numpy(), plain)
    with pytest.raises(AssertionError, match="rel err"):
        _assert_close(op, emulate_cluster_scan(op, xt, reverse, 4, 2, 2, swap=True).numpy(), plain)
