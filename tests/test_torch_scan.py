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


def _window_fold(op, vals, last, window):
    """Lane 0's fold of a look-back window vals (L, window), lane 0 the
    nearest predecessor, over lanes [0, last] (shuffle-down tree, the
    farther half first)."""
    d = 1
    while d <= last:
        moved = torch.cat([vals[:, d:], _ident(op, d)], 1)  # lane k reads lane k + d
        new = _comb(op, moved, vals)
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


def emulate_lookback_scan(op, x, reverse, schedule, warp, warps, items, window, seed=0, blocks=3):
    """(L, n) leaves, or (L, B, n) for K1's batch grid: one ticket counter
    over every row's tiles in row-major order (ticket g is tile g % n_tiles
    of row g // n_tiles), the flags and values a slot per (row, tile), and a
    look-back that walks its row's slots only and stops at the row's first
    tile."""
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
        wl, wscan, tot = _tile_reduce(op, v, warp, warps, items)
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
        out[:, row, t * tile : (t + 1) * tile] = _tile_finish(op, t, carry, wl, wscan, warp, warps, items).reshape(L, tile)
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


# (warp, warps, items, window) per combine: small tiles, so that 7 tiles
# stay short where the JAX references compile slowly (lax.associative_scan
# of the 27-leaf filter: ~27 s at 31 elements on an 8-core Xeon host).
EMULATED = {"mobius": (4, 2, 2, 4), "rts": (4, 2, 2, 4), "filter": (2, 2, 1, 2)}
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
