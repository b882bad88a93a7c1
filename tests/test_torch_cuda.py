"""The hand-written CUDA kernels on the GPU (marked ``cuda``; each test skips
without a CUDA device, since a CUDA kernel has no CPU mode).

This file imports no JAX, so it runs where only PyTorch is installed:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Each kernel is held against its plain version on the same inputs
(vectors rtol = atol = 1e-5, dots rtol 1e-4, as for the reference's
Pallas kernels) and must give bitwise-identical results when rerun.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import api
from repro_torch.kernels import krylov_fused, ref

SIZES = [64, 130, 4096 + 7, 1 << 20]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (a CUDA kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("n", SIZES)
def test_kernels_match_plain_versions(cuda_device, n):
    g = torch.Generator(device=cuda_device).manual_seed(n)
    x, r, p, ap = (torch.randn(n, generator=g, device=cuda_device)
                   for _ in range(4))
    alpha = torch.tensor(0.41, device=cuda_device)
    before = dict(krylov_fused.LAUNCHES)
    got = krylov_fused.fused_cg_update(x, r, p, ap, alpha)
    again = krylov_fused.fused_cg_update(x, r, p, ap, alpha)
    want = ref.fused_cg_update(x, r, p, ap, alpha)
    for a, b in zip(got, again):
        assert torch.equal(a, b)                # no atomics: bitwise reruns
    for a, w in zip(got[:2], want[:2]):
        torch.testing.assert_close(a, w, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(got[2], want[2], rtol=1e-4, atol=0)
    dots = krylov_fused.fused_pipelined_dots(x, r, p)
    for a, b in zip(dots, krylov_fused.fused_pipelined_dots(x, r, p)):
        assert torch.equal(a, b)
    for a, w in zip(dots, ref.fused_pipelined_dots(x, r, p)):
        torch.testing.assert_close(a, w, rtol=1e-4, atol=0)
    assert krylov_fused.LAUNCHES["fused_cg_update"] \
        == before["fused_cg_update"] + 2
    assert krylov_fused.LAUNCHES["fused_pipelined_dots"] \
        == before["fused_pipelined_dots"] + 2


@pytest.mark.cuda
def test_wrapper_needs_alpha_on_the_device(cuda_device):
    x = torch.ones(256, device=cuda_device)
    with pytest.raises(TypeError, match="alpha"):
        krylov_fused.fused_cg_update(x, x, x, x, 0.5)


@pytest.mark.cuda
@pytest.mark.parametrize("method,kernel", [
    ("cg", "fused_cg_update"), ("bicg", "fused_cg_update"),
    ("bicgstab", "fused_cg_update"),
    ("pipelined_cg", "fused_pipelined_dots")])
def test_solve_goes_through_the_kernels(cuda_device, method, kernel):
    rng = np.random.default_rng(0)
    n = 512
    a = rng.standard_normal((n, n)).astype(np.float32)
    a = a @ a.T / n + 4 * np.eye(n, dtype=np.float32)
    b = rng.standard_normal(n).astype(np.float32)
    ref_res = api.solve(a, b, method=method, return_info=True)
    before = krylov_fused.LAUNCHES[kernel]
    res = api.solve(a, b, method=method, backend="cuda", return_info=True)
    assert krylov_fused.LAUNCHES[kernel] > before
    assert bool(res.converged) and res.x.device.type == "cuda"
    assert res.iterations <= max(1.2 * ref_res.iterations,
                                 ref_res.iterations + 2)
