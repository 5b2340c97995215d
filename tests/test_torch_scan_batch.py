"""K2's batch grid (``csrc/scan_tiled.cu`` on (L, B, n) leaves, B > 1),
emulated on the CPU and held against the JAX package's ``vmap`` of its
tiled Pallas scan.

The kernel cannot run here, so its order of work is emulated by
``test_torch_scan.emulate_tiled_grid``: persistent blocks, each a producer
warp and compute warps over a ring of staged tiles. The producer draws
tickets over every row's tiles, stages each tile by the kernel's own
address arithmetic (a leaf's span in memory order, its 16-byte interior
aligned, the identity past the row's end, read backwards under
``reverse``) and walks each tile's look-back through its row's flags only;
the compute warps reduce tile i with the runs tile, then finish tile i - 1
with the carry the producer found. B = 3 rows of n ∈ {5, 1024, 2500}
elements (ragged last tiles; at n = 5 fewer tiles than blocks), every
combine, both directions; ragged batches of 2-5 rows with fewer tiles than
blocks and with many more, two and three stages, every misalignment of a
float64 and a float32 span; and a carry folded in the wrong argument order,
which the non-commutative combines must catch. A single row keeps the
single-row kernel (``emulate_tiled_scan``: the next ticket's tile staged
ahead).

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
from test_torch_scan import (JAX_COMBINES, NONCOMMUTATIVE, _assert_close, _ident, _leaves_back,
                             emulate_tiled_grid, emulate_tiled_scan, scan_input)

ROWS = 3
N_MAX = 2500
LENGTHS = (5, 1024, N_MAX)
EXACT = ("add2", "max3", "min3")
# (warp, warps, items, window, blocks, stages): 64-element tiles, 4
# persistent blocks, a ring of three stages.
SHAPE = (4, 2, 8, 4, 4, 3)


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
    """The batch grid's order of work (the image one element past a 16-byte
    boundary, so every float64 leaf's span starts misaligned or not by
    turns) against the batched plain ladder and JAX's batched tiled scan."""
    warp, warps, items, window, blocks, stages = SHAPE
    x, want = vmap_reference(op, reverse)
    for n in LENGTHS:
        sl = slice(N_MAX - n, N_MAX) if reverse else slice(0, n)
        xt = torch.tensor(x[..., sl]).contiguous()
        got = emulate_tiled_grid(op, xt, reverse, warp, warps, items, window, blocks, stages, seed=n, misalign=1)
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
    tiles, and more blocks than all the tiles: each row of the batch grid
    still equals its own scan, at two stages and at three (the reverse RTS
    combine, whose argument order a slip in the staging's indexing would
    show), and so does a single row on the single-row kernel, which stages
    the next ticket's tile ahead."""
    warp, warps, items, window, _, _ = SHAPE
    x = torch.stack([torch.tensor(scan_input("rts", 300, seed=r)) for r in range(ROWS)], 1)
    for stages in (2, 3):
        got = emulate_tiled_grid("rts", x, True, warp, warps, items, window, blocks, stages, seed=blocks)
        for r in range(ROWS):
            _assert_close("rts", got[:, r].numpy(), scan.scan_plain("rts", x[:, r].contiguous(), True).numpy(),
                          rtol=1e-12)
    row = x[:, 0].contiguous()
    got = emulate_tiled_scan("rts", row, True, warp, warps, items, window, blocks, seed=blocks)
    _assert_close("rts", got.numpy(), scan.scan_plain("rts", row, True).numpy(), rtol=1e-12)


def ragged_rows(op, ns, n):
    """(L, len(ns), n) float64 leaves: row r is ``scan_input`` at ns[r]
    (seeded apart), then the combine's identity to n."""
    return torch.stack([torch.cat([torch.tensor(scan_input(op, k, seed=30 + r)), _ident(op, n - k)], 1)
                        for r, k in enumerate(ns)], 1)


# (rows' lengths, blocks): 16-element tiles (4 lanes x 2 warps x 2 items).
# Fewer tiles in all than blocks (2 rows of up to 2 tiles against 7 blocks;
# 5 rows of up to 3 against 16), and many more (3 rows of up to 19 tiles
# against 2 blocks; 5 rows of up to 13 against 3).
RAGGED = [((20, 9), 7), ((300, 161, 7), 2), ((40, 33, 17, 1, 25), 16), ((200, 131, 64, 16, 3), 3)]


@pytest.mark.parametrize("stages", [2, 3])
@pytest.mark.parametrize("ns,blocks", RAGGED)
def test_tiled_grid_ragged_batches_match_plain(ns, blocks, stages):
    """Ragged batches of 2-5 rows (identity-padded to the longest, as a
    bucket pads), with fewer tiles than blocks and with many more, at two
    and three stages: the reverse RTS combine, quat_chain forward and add2
    in both directions, each staged from a float64 image at both
    misalignments and a float32 one at all four, against the batched plain
    ladder (add2 bit for bit)."""
    for op, reverse in (("rts", True), ("quat_chain", False), ("add2", False), ("add2", True)):
        x = ragged_rows(op, ns, max(ns))
        plain = scan.scan_plain(op, x, reverse)
        for vec, misalign in ((2, 0), (2, 1), (4, 0), (4, 1), (4, 2), (4, 3)):
            got = emulate_tiled_grid(op, x, reverse, 4, 2, 2, 4, blocks, stages, seed=vec + misalign, vec=vec,
                                     misalign=misalign)
            if op == "add2":
                assert torch.equal(got, plain), (vec, misalign)
            _assert_close(op, _flat(got.numpy()), _flat(plain.numpy()), rtol=1e-12)


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("op", NONCOMMUTATIVE)
def test_a_swapped_grid_carry_fold_fails(op, reverse):
    """The emulation catches an argument-order slip in the producer's fold
    of the carry: with the nearer composite first (``swap``: in the
    window's tree and in the walk's windows) the
    non-commutative combines leave the plain scan by far more than the
    file's tolerance in both directions, while the right order stays
    within it."""
    x = ragged_rows(op, (131, 100, 77), 131)
    plain = _flat(scan.scan_plain(op, x, reverse).numpy())
    _assert_close(op, _flat(emulate_tiled_grid(op, x, reverse, 4, 2, 2, 4, 3, 2).numpy()), plain)
    with pytest.raises(AssertionError, match="rel err"):
        _assert_close(op, _flat(emulate_tiled_grid(op, x, reverse, 4, 2, 2, 4, 3, 2, swap=True).numpy()), plain)


def test_batched_scan_route():
    """K2's batch grid takes the batches of rts, mobius and affine3 with rows
    of at least ``BATCH_TILED_MIN_ROW`` elements and
    ``BATCH_TILED_MIN_ELEMENTS`` in all, where it measured faster than K1's
    grid on the card; K1's grid takes every other batch: the long-log
    bucket (4 x 524,288) for the other five combines, two logs of 70,000
    poses, the KITTI buckets (rows of 272 to 4,664 poses) and the fleet (64
    x 4,661). One row keeps the single-row rule at any length."""
    last, row, most = scan.BLOCK_MAX_ELEMENTS, scan.BATCH_TILED_MIN_ROW, scan.BATCH_TILED_MIN_ELEMENTS
    assert (last, row, most) == (65_536, 131_073, 1 << 20)
    assert set(scan.BATCH_TILED_OPS) == {"rts", "mobius", "affine3"}
    for op, (_, _, ident) in scan.OPS.items():
        L = len(ident)
        grid = op in scan.BATCH_TILED_OPS
        for size in (4, 8):
            assert scan.scan_route(L, 524_288, size, 4, op) == ("tiled" if grid else "block")
            assert scan.scan_route(L, row, size, -(-most // row), op) == ("tiled" if grid else "block")
            assert scan.scan_route(L, row, size, most // row, op) == "block"  # fewer elements in all
            assert scan.scan_route(L, row - 1, size, 16, op) == "block"  # shorter rows
            assert scan.scan_route(L, 70_000, size, 2, op) == "block"
            assert scan.scan_route(L, 4_664, size, 4, op) == "block"
            assert scan.scan_route(L, 4_661, size, 64, op) == "block"
            assert scan.scan_route(L, 524_288, size, 4) == "block"  # no combine named: K1's grid
            for n in (last + 1, 1_048_577, 4 * most):
                assert scan.scan_route(L, n, size, 1, op) == scan.scan_route(L, n, size) == "tiled"
            assert scan.scan_route(L, last, size, 1, op) == "block"


@pytest.mark.parametrize("op,shape,want", [("affine3", (4, 262_145), "scan_tiled"), ("add2", (4, 262_145), "scan_block"),
                                           ("add2", (3, 70_000), "scan_block"), ("add2", (3, 4_000), "scan_block")])
def test_associative_scan_calls_the_routed_wrapper(monkeypatch, op, shape, want):
    """``associative_scan`` on (L, B, n) leaves calls the wrapper
    ``scan_route`` names for its rows and combine (counted by patching both
    on CPU tensors, where each takes the batched ladder)."""
    calls = []
    for name in ("scan_block", "scan_tiled"):
        real = getattr(scan, name)
        monkeypatch.setattr(scan, name, lambda *a, _n=name, _f=real: calls.append(_n) or _f(*a))
    L = len(scan.OPS[op][2])
    x = torch.zeros(L, *shape, dtype=torch.float64)
    x[:, :, ::3] = 1.0
    out = scan.associative_scan(op, x)
    assert calls == [want]
    if op == "add2":
        assert torch.equal(out[:, :, -1], x.sum(-1))
    else:
        assert torch.equal(out, scan.scan_plain(op, x))
