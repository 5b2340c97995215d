"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA device and skips without one. The file imports
no JAX (the machine with the card has none), so it runs there without the
suite's conftest:

    python -m pytest --noconftest -q tests/test_torch_cuda.py

Tolerances: relative to (max |plain| + 1) per leaf, 1e-4 in float32 and
1e-10 in float64 (the kernels associate or sum in another order); NN 1e-5 /
1e-12 relative; counts within 2 of the plain version (a residual within
rounding of the threshold), the re-ranked winner identical; seq-04 on the
card within 1e-6 m of the golden trajectory.
"""

import os
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402
from gps_optimize_slam_tpu_torch.ops import kernels, scan  # noqa: E402
from gps_optimize_slam_tpu_torch.ops.ransac import select_winner  # noqa: E402
from gps_optimize_slam_tpu_torch.ops.umeyama import umeyama_sim3  # noqa: E402

pytestmark = pytest.mark.cuda
TOL = {torch.float32: 1e-4, torch.float64: 1e-10}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("op", list(scan.OPS))
def test_scan_kernel_matches_plain(cuda, op, dtype):
    gen = torch.Generator().manual_seed(0)
    before = scan.associative_scan.launches[op]
    for n in (1, 271, 4661):
        x = chip_smoke.scan_inputs(op, n, gen, dtype, cuda)
        for reverse in (False, True):
            got = scan.associative_scan(op, x, reverse)
            torch.cuda.synchronize()
            assert chip_smoke.rel_err(got, scan.scan_plain(op, x, reverse)) <= TOL[dtype]
    assert scan.associative_scan.launches[op] == before + 6


def walk(gen, n, dtype, device, offset=0.0):
    steps = torch.randn(n, 3, generator=gen, dtype=torch.float64)
    return (torch.cumsum(steps, 0) + offset).to(dtype=dtype, device=device)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_nn_kernel_matches_plain(cuda, dtype):
    gen = torch.Generator().manual_seed(1)
    for n, m in ((4661, 4661), (300, 777), (5, 1)):
        traj, cands = walk(gen, n, dtype, cuda), walk(gen, m, dtype, cuda, offset=0.3)
        mask = (torch.rand(m, generator=gen) > 0.1).to(cuda)
        got = kernels.nn_min_dist2(traj, cands, mask)
        torch.cuda.synchronize()
        want = kernels.nn_min_dist2_plain(traj, cands, mask)
        torch.testing.assert_close(got, want, rtol=1e-5 if dtype == torch.float32 else 1e-12, atol=0.0)
    none = kernels.nn_min_dist2(traj, cands, torch.zeros_like(mask))
    assert torch.isinf(none).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_counts_kernel_matches_plain_and_keeps_the_winner(cuda, dtype):
    gen = torch.Generator().manual_seed(2)
    n = 4661
    src = walk(gen, n, torch.float64, cuda) * 2.0
    dst = 0.987 * src + 2.0 * torch.randn(n, 3, generator=gen, dtype=torch.float64).to(cuda)
    src, dst = src.to(dtype), dst.to(dtype)
    valid = (torch.rand(n, generator=gen) > 0.05).to(cuda)
    draws = torch.randint(0, n, (1000, 4), generator=gen).to(cuda)
    fits = umeyama_sim3(src[draws], dst[draws])
    args = (src, dst, valid, fits.R.contiguous(), fits.t.contiguous(), fits.scale.contiguous(), 16.0)
    got = kernels.ransac_counts(*args)
    torch.cuda.synchronize()
    want = kernels.ransac_counts_plain(*args)
    assert int((got - want).abs().max()) <= 2
    assert int(select_winner(src, dst, valid, fits, got, 16.0)) == int(
        select_winner(src, dst, valid, fits, want, 16.0)
    )


def test_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    x = torch.zeros(2, 10, dtype=torch.float64, device=cuda)
    with pytest.raises(ValueError):
        scan.associative_scan("add2", x[:, ::2])  # not contiguous
    traj = torch.zeros(10, 3, device=cuda)
    with pytest.raises(TypeError):
        kernels.nn_min_dist2(traj, traj.double(), torch.ones(10, dtype=torch.bool, device=cuda))
    with pytest.raises(ValueError):
        kernels.nn_min_dist2(traj.T.contiguous().T, traj, torch.ones(10, dtype=torch.bool, device=cuda))


def test_seq04_golden_on_the_card(cuda):
    chip_smoke.phase2(cuda)
