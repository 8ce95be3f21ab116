"""The CUDA ``rbgp4mm_rhs`` kernel against its plain version, on the card.

Needs a CUDA card (and nvcc): the kernel has no CPU mode, so these tests
skip elsewhere.  They import only torch and the port, so they run where
JAX is not installed:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py

Tolerances scale with max|ref|: 1e-5 in float32 (reduction order only),
2e-2 in bfloat16 (one output rounding).
"""
import numpy as np
import pytest
import torch

from repro_torch.core import RBGP4Layout, RBGP4Spec, design_rbgp4
from repro_torch.kernels import KernelTables, rbgp4mm_rhs, rbgp4mm_rhs_reference

TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}

# tests/test_kernels.py sweep: m, k, n, sp_o, sp_i, G, C, ui, vi
SWEEP = [
    (64, 64, 16, 0.5, 0.5, 4, 4, 4, 4),
    (128, 64, 32, 0.75, 0.0, 4, 8, 4, 2),
    (64, 128, 8, 0.0, 0.5, 8, 8, 2, 4),
    (256, 128, 64, 0.5, 0.75, 8, 8, 4, 4),
    (128, 128, 24, 0.875, 0.0, 4, 8, 4, 2),
    (64, 64, 16, 0.9375, 0.0, 2, 2, 2, 2),
    (32, 32, 128, 0.5, 0.5, 2, 2, 4, 4),
]
FULL_WIDTH = [(2048, 2048), (256, 2048), (5632, 2048), (2048, 5632)]
EPILOGUES = [(None, False, False), ("silu", False, False),
             ("gelu", True, True)]


def cases():
    out = []
    for m, k, n, sp_o, sp_i, G, C, ui, vi in SWEEP:
        spec = RBGP4Spec(g_o=(m // (ui * G), k // (vi * C)), g_r=(G, C),
                         g_i=(ui, vi), g_b=(1, 1), sp_o=sp_o, sp_i=sp_i,
                         seed=7)
        out.append((RBGP4Layout(spec), n))
    for m, k in FULL_WIDTH:
        lay = RBGP4Layout(design_rbgp4(m, k, 0.75, seed=0))
        out += [(lay, n) for n in (1, 8, 77)]
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_kernel_matches_plain_version(dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    g = torch.Generator(device="cuda").manual_seed(0)
    rnd = lambda *shape: torch.randn(*shape, device="cuda",
                                     generator=g).to(dtype)
    for lay, n in cases():
        tables = KernelTables.build(lay, "cuda")
        for act, bias, residual in EPILOGUES:
            x, w = rnd(n, lay.k), rnd(*lay.data_shape)
            b = rnd(lay.m) if bias else None
            r = rnd(n, lay.m) if residual else None
            before = rbgp4mm_rhs.launches
            got = rbgp4mm_rhs(tables, x, w, bias=b, act=act, residual=r)
            torch.cuda.synchronize()
            assert rbgp4mm_rhs.launches == before + 1
            want = rbgp4mm_rhs_reference(tables, x, w, bias=b, act=act,
                                         residual=r)
            err = float((got.float() - want.float()).abs().max())
            scale = float(want.float().abs().max())
            assert err <= TOL[dtype] * scale, (lay, n, act, err, scale)


@pytest.mark.cuda
def test_cuda_kernel_rejects_what_it_does_not_take():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    lay = RBGP4Layout(design_rbgp4(256, 2048, 0.75, seed=0))
    tables = KernelTables.build(lay, "cuda")
    x = torch.randn(4, lay.k, device="cuda")
    w = torch.randn(lay.data_shape, device="cuda")
    with pytest.raises(TypeError):
        rbgp4mm_rhs(tables, x.half(), w.half())
    with pytest.raises(TypeError):
        rbgp4mm_rhs(tables, x, w.bfloat16())
    with pytest.raises(ValueError):
        rbgp4mm_rhs(tables, x.t().contiguous().t(), w)
    assert np.isfinite(rbgp4mm_rhs(tables, x, w).cpu().numpy()).all()
