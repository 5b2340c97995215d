"""K2's batch grid (``csrc/scan_tiled.cu`` on (L, B, n) leaves), emulated on
the CPU and held against the JAX package's ``vmap`` of its tiled Pallas
scan.

The kernel cannot run here, so its order of work is emulated by
``test_torch_scan.emulate_tiled_scan``: persistent blocks drawing tickets
over every row's tiles, each staging the next ticket's tile (across a row's
end, and from the row's end under ``reverse``) while it scans the present
one, looking back through its row's flags only. B = 3 rows of n ∈ {5, 1024,
2500} elements (ragged last tiles; at n = 5 fewer tiles than blocks), every
combine, both directions.

Oracles and tolerances: the batched plain ladder (``scan_plain`` on the
(L, B, n) leaves) equals the plain scan of each row alone bit for bit; the
emulation equals both to 1e-12 relative, and bit for bit where the combine
is exact (add2 on 0/1 counts, max3, min3); the emulation equals
``jax.vmap(associative_scan_tiled(..., interpret=True, block_rows=8))``
(1024-element blocks, so 2500 elements cross two block carries) in float64
to ≤1e-10 relative, the file's tolerance for every scan. The JAX reference
is computed once per (combine, direction) at n = 2500 (a prefix of the scan
is the scan of the prefix, a suffix in reverse). The reverse filter takes
``associative_scan_fori`` instead, as ``test_torch_scan.py`` does: the main
path scans the filter forward only, and XLA:CPU needs ~90 s to compile the
interpret-mode kernel of the 27-leaf combine in each direction.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gps_optimize_slam_tpu.ops.pallas_scan import associative_scan_fori, associative_scan_tiled
from gps_optimize_slam_tpu_torch.ops import scan
from test_torch_scan import JAX_COMBINES, _assert_close, _leaves_back, emulate_tiled_scan, scan_input

ROWS = 3
N_MAX = 2500
LENGTHS = (5, 1024, N_MAX)
EXACT = ("add2", "max3", "min3")
# (warp, warps, items, window, blocks): 64-element tiles, 4 persistent blocks.
SHAPE = (4, 2, 8, 4, 4)


@functools.lru_cache(maxsize=None)
def vmap_reference(op, reverse):
    """(L, ROWS, N_MAX) float64 leaves, rows seeded apart, and the JAX
    package's batched scan of them."""
    combine, tree_of, ident = JAX_COMBINES[op]
    x = np.stack([scan_input(op, N_MAX, seed=7 + r) for r in range(ROWS)], 1)
    tree = tree_of([jnp.asarray(v) for v in x])
    if op == "filter" and reverse:
        def one(e):
            return associative_scan_fori(combine, e, ident, reverse=True)
    else:
        def one(e):
            return associative_scan_tiled(combine, e, ident, reverse=reverse, interpret=True, block_rows=8)
    return x, _leaves_back(op, jax.jit(jax.vmap(one))(tree))


def _flat(a):
    return np.asarray(a).reshape(a.shape[0], -1)


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("op", list(scan.OPS))
def test_tiled_batch_order_of_work_matches_plain_and_jax(op, reverse):
    warp, warps, items, window, blocks = SHAPE
    x, want = vmap_reference(op, reverse)
    for n in LENGTHS:
        sl = slice(N_MAX - n, N_MAX) if reverse else slice(0, n)
        xt = torch.tensor(x[..., sl]).contiguous()
        got = emulate_tiled_scan(op, xt, reverse, warp, warps, items, window, blocks, seed=n)
        plain = scan.scan_plain(op, xt, reverse)
        for r in range(ROWS):
            assert torch.equal(plain[:, r], scan.scan_plain(op, xt[:, r].contiguous(), reverse))
        if op in EXACT:
            assert torch.equal(got, plain)
        _assert_close(op, _flat(got.numpy()), _flat(plain.numpy()), rtol=1e-12)
        _assert_close(op, _flat(got.numpy()), _flat(want[..., sl]))


@pytest.mark.parametrize("blocks", [1, 2, 7])
def test_tiled_batch_makes_progress_with_any_number_of_blocks(blocks):
    """One block walking every row's tiles, fewer blocks than one row's
    tiles, and more blocks than all the tiles: each row still equals its
    own scan (the reverse RTS combine, whose argument order a slip in the
    prefetch's indexing would show)."""
    warp, warps, items, window, _ = SHAPE
    x = torch.stack([torch.tensor(scan_input("rts", 300, seed=r)) for r in range(ROWS)], 1)
    got = emulate_tiled_scan("rts", x, True, warp, warps, items, window, blocks, seed=blocks)
    for r in range(ROWS):
        _assert_close("rts", got[:, r].numpy(), scan.scan_plain("rts", x[:, r].contiguous(), True).numpy(),
                      rtol=1e-12)


def test_batched_scan_route():
    """K2's batch grid takes rows past ``BLOCK_MAX_ELEMENTS`` in batches of
    at most ``BATCH_TILED_MAX_ELEMENTS`` elements a leaf, K1's grid every
    other batch: two logs of 70,000 poses take K2, the long-log bucket (4 x
    524,288), the KITTI buckets (rows of 272 to 4,664 poses) and the fleet
    (64 x 4,661) K1, where K1 was level or faster on the card; one row
    keeps the single-row rule at any length."""
    last, most = scan.BLOCK_MAX_ELEMENTS, scan.BATCH_TILED_MAX_ELEMENTS
    assert (last, most) == (65_536, 1 << 20)
    for L in (2, 3, 4, 12, 27):
        for size in (4, 8):
            assert scan.scan_route(L, 70_000, size, batch=2) == "tiled"
            assert scan.scan_route(L, last + 1, size, batch=most // (last + 1)) == "tiled"
            assert scan.scan_route(L, last + 1, size, batch=most // (last + 1) + 1) == "block"
            assert scan.scan_route(L, last, size, batch=2) == "block"
            assert scan.scan_route(L, most // 2, size, batch=2) == "tiled"
            assert scan.scan_route(L, most // 2 + 1, size, batch=2) == "block"
            assert scan.scan_route(L, 524_288, size, batch=4) == "block"
            assert scan.scan_route(L, 4_664, size, batch=4) == "block"
            assert scan.scan_route(L, 4_661, size, batch=64) == "block"
            for n in (last + 1, 1_048_577, 4 * most):
                assert scan.scan_route(L, n, size) == scan.scan_route(L, n, size, batch=1) == "tiled"


@pytest.mark.parametrize("shape,want", [((3, 70_000), "scan_tiled"), ((16, 70_000), "scan_block"),
                                        ((3, 4_000), "scan_block")])
def test_associative_scan_calls_the_routed_wrapper(monkeypatch, shape, want):
    """``associative_scan`` on (L, B, n) leaves calls the wrapper
    ``scan_route`` names for its rows (counted by patching both on CPU
    tensors, where each takes the batched ladder)."""
    calls = []
    for name in ("scan_block", "scan_tiled"):
        real = getattr(scan, name)
        monkeypatch.setattr(scan, name, lambda *a, _n=name, _f=real: calls.append(_n) or _f(*a))
    x = torch.zeros(2, *shape, dtype=torch.float64)
    x[:, :, ::3] = 1.0
    out = scan.associative_scan("add2", x)
    assert calls == [want] and torch.equal(out[:, :, -1], x.sum(-1))
