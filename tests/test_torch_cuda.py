"""The CUDA kernels against their plain versions, on the card.

``rbgp4mm_rhs`` (with and without ``save_preact``, on forward and
transposed layouts), ``rbgp4_sddmm_rhs``, and ``RBGP4Linear``'s gradients
on the card against the same function run by the plain versions; the same
for the stacked-expert kernels ``rbgp4mm_rhs_stacked`` and
``rbgp4_sddmm_rhs_stacked`` and ``RBGP4LinearStacked``, whose every expert
must also equal the unstacked kernel on that expert, bit for bit (one
device body); and the deep-chain kernels ``chainmm_rhs`` (forward and
transposed tables) and ``chain_sddmm_rhs`` and ``ChainLinear``'s
gradients, at the chains of the CPU tests (G = C = 1 included) and
tinyllama's four shapes under the hierarchical-block plan; and the
feature-major kernels ``rbgp4mm`` (forward and transposed tables) and
``rbgp4_sddmm`` (bit-equal on a rerun) and ``RBGP4Op.matmul``'s gradients,
at G = C = 4, C = 2, the transposed G = 8, VGG19-CIFAR's widest layout,
an odd G = 9 (C = 9 transposed) and G = 256 (C = 256 transposed), with a
ragged N; and the int8 ``scales=`` paths of ``rbgp4mm_rhs``,
``rbgp4mm_rhs_stacked`` and ``chainmm_rhs`` against their plain versions
on the same int8 values (G = 9, G = 128 and the chain leaves), bit-equal
on a rerun, with a quantized layer launching only them; and the bf16
tensor-core bodies of ``rbgp4mm_rhs`` (forward, ``save_preact``, dX) and
``rbgp4_sddmm_rhs`` (bit-equal on a rerun) at every (G, C) of G in
{16, 64, 128}, C in {16, 64} and tinyllama's four layouts at N in
{16, 64, 77, 1037}, ``RBGP4Linear``'s bf16 gradients on them against dense
autograd at N = 1037, and the FMA bodies kept at decode, in float32 and
on the int8 entry points.  Every stacked expert stays bit-equal to the
unstacked launch of the body ``rhs_path`` (``sddmm_path`` and the
stacked plan, for dW) picks on that expert (the bf16 tensor-core bodies
from 16 rows an expert on).  And the bf16 tensor-core bodies of
``chain_sddmm_rhs`` and ``chainmm_rhs`` (forward and transposed tables)
over row-group classes (small chains with leaves 8 x 16, 16 x 8, 8 x 8
and 128 x 64, classes of unequal sizes among them, and tinyllama's four
chain shapes) against their plain versions, bit-equal on a rerun, and
``ChainLinear``'s bf16 gradients on them against dense autograd at N =
1037.  And the bf16 tensor-core bodies of ``rbgp4mm`` (forward and
transposed tables, over row-group class tiles, G = 8 included) and
``rbgp4_sddmm`` (bit-equal on a rerun) at VGG19's 64 x 576, 128 x 576
and 512 x 4608 at N in {16, 1000, 4104}, every built tile and block of
columns against the plain versions, and the launchers refusing float32,
N not a multiple of 8, WRN's C = 2 and transposed G = 2, tiles and plans
they have no template or slices for, and misaligned operands.  And
``rbgp4mm_rhs`` (forward and transposed tables) and ``rbgp4_sddmm_rhs`` at
the vision models' conv layouts (C 2 and 8 on the FMA bodies) up to 262144
tokens, and one VGG19-CIFAR training step on the card against the CPU,
layer by layer (``-k vision``).  And the forward, dX and dW at one layout
of each budget plan the plan compiler solves (tinyllama's wq/wo at 0.5;
qwen2-moe's stacked ``experts.out`` at 0.875, C 8, whose dX and dW keep
the FMA bodies) against their plain versions (``-k plan``).

Needs a CUDA card (and nvcc): the kernels have no CPU mode, so these tests
skip elsewhere.  They import only torch and the port, so they run where
JAX is not installed:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py
    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py \
        -k "chain or stacked"
    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py \
        -k "fm_mma or featmajor"
    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py -k vision
    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py -k plan

Tolerances scale with max|ref|: 1e-5 in float32 (reduction order only),
2e-2 in bfloat16 (one output rounding).  ``RBGP4Linear``'s gradients chain
three products and the activation's derivative at the saved
pre-activation, which carries the forward's reduction-order difference
into dW and dX: 1e-4 in float32 there.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import (ChainLayout, RBGP4Layout, RBGP4Spec,
                              design_rbgp, design_rbgp4)
from repro_torch.kernels import (ChainLinear, KernelTables, RBGP4Linear,
                                 RBGP4LinearStacked, RBGP4Op,
                                 TransposeTables, rbgp4_sddmm,
                                 rbgp4_sddmm_reference, rbgp4mm,
                                 rbgp4mm_reference,
                                 rbgp4_sddmm_rhs, rbgp4_sddmm_rhs_reference,
                                 rbgp4_sddmm_rhs_stacked,
                                 rbgp4_sddmm_rhs_stacked_reference,
                                 rbgp4mm_rhs, rbgp4mm_rhs_reference,
                                 rbgp4mm_rhs_stacked,
                                 rbgp4mm_rhs_stacked_reference,
                                 chain_sddmm_rhs, chain_sddmm_rhs_reference,
                                 chain_tables, chain_transpose_tables,
                                 chainmm_rhs, chainmm_rhs_reference,
                                 rhs_path, sddmm_path,
                                 stacked_sddmm_mma_plan)
from repro_torch.kernels.chainmm import (_chain_rhs_body, _chain_sddmm_body,
                                         chain_rhs_path, chain_sddmm_path,
                                         chain_unpack_dense)
from repro_torch.kernels.rbgp4mm import (_rhs_body, _sddmm_body,
                                         _sddmm_stacked_body, _sm_count)
from repro_torch.kernels.ref import unpack_dense

TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
GRAD_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}

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


def needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")


def assert_close(got, want, dtype, what, tol=TOL):
    err = float((got.float() - want.float()).abs().max())
    scale = float(want.float().abs().max())
    assert err <= tol[dtype] * scale, (what, err, scale)


def body_rhs(path, tables, x, w, bias=None, act=None):
    """The unstacked kernel's body ``path`` on (x, w), whatever
    ``rhs_path`` picks for the shape."""
    out = torch.empty((x.shape[0], tables.dims.m), dtype=x.dtype,
                      device=x.device)
    _rhs_body(path, tables, x, w, out, bias=bias, act=act)
    return out


def fma_rhs(tables, x, w, bias=None, act=None):
    """The unstacked kernel's FMA body on (x, w)."""
    return body_rhs("fma", tables, x, w, bias=bias, act=act)


def fma_sddmm(tables, gy, x):
    """The unstacked dW kernel's FMA body, as ``fma_rhs``."""
    return body_sddmm("fma", tables, gy, x)


def body_sddmm(path, tables, gy, x, plan=None):
    """The unstacked dW kernel's body ``path`` on (gy, x), the mma body
    with ``plan`` (its own unless given)."""
    dw = torch.empty((tables.dims.m, tables.dims.data_cols), dtype=x.dtype,
                     device=x.device)
    _sddmm_body(path, tables, gy, x, dw, plan=plan)
    return dw


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_save_preact_matches_plain_version(dtype):
    needs_card()
    g = torch.Generator(device="cuda").manual_seed(1)
    rnd = lambda *shape: torch.randn(*shape, device="cuda",
                                     generator=g).to(dtype)
    for lay, n in cases():
        tables = KernelTables.build(lay, "cuda")
        for act, bias, residual in EPILOGUES[1:]:
            x, w = rnd(n, lay.k), rnd(*lay.data_shape)
            b = rnd(lay.m) if bias else None
            r = rnd(n, lay.m) if residual else None
            y, z = rbgp4mm_rhs(tables, x, w, bias=b, act=act, residual=r,
                               save_preact=True)
            torch.cuda.synchronize()
            wy, wz = rbgp4mm_rhs_reference(tables, x, w, bias=b, act=act,
                                           residual=r, save_preact=True)
            assert_close(y, wy, dtype, (lay.spec, n, act, "y"))
            assert_close(z, wz, dtype, (lay.spec, n, act, "z"))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_sddmm_matches_plain_version(dtype):
    needs_card()
    g = torch.Generator(device="cuda").manual_seed(2)
    rnd = lambda *shape: torch.randn(*shape, device="cuda",
                                     generator=g).to(dtype)
    for lay, n in cases() + [(lay, 1000) for lay, n in cases()
                              if n == 77]:
        tables = KernelTables.build(lay, "cuda")
        gy, x = rnd(n, lay.m), rnd(n, lay.k)
        before = rbgp4_sddmm_rhs.launches
        got = rbgp4_sddmm_rhs(tables, gy, x)
        torch.cuda.synchronize()
        assert rbgp4_sddmm_rhs.launches == before + 1
        assert got.dtype == dtype and tuple(got.shape) == lay.data_shape
        want = rbgp4_sddmm_rhs_reference(tables, gy, x)
        assert_close(got, want, dtype, (lay.spec, n))
        # a rerun gives the same bits: no atomics, a fixed order of sums
        assert torch.equal(got, rbgp4_sddmm_rhs(tables, gy, x))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_kernel_on_transposed_layouts(dtype):
    """dX = g @ W_s through the kernel on the layout of W^T: at full width
    G = 64 or 128 with C = 16 and up to 88 chunks a row."""
    needs_card()
    g = torch.Generator(device="cuda").manual_seed(3)
    rnd = lambda *shape: torch.randn(*shape, device="cuda",
                                     generator=g).to(dtype)
    for lay, n in cases():
        tt = TransposeTables.build(lay, "cuda")
        w = rnd(*lay.data_shape)
        gy = rnd(n, lay.m)
        wt = tt.values(w)
        before = (rbgp4mm_rhs.launches, rbgp4mm_rhs.launches_dx)
        got = rbgp4mm_rhs(tt.tables, gy, wt)
        torch.cuda.synchronize()
        # a launch on transposed tables counts as a dX launch only
        assert (rbgp4mm_rhs.launches, rbgp4mm_rhs.launches_dx) == (
            before[0], before[1] + 1)
        want = rbgp4mm_rhs_reference(tt.tables, gy, wt)
        assert_close(got, want, dtype, (lay.spec, n))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_rbgp4_linear_grads_match_plain_versions(dtype):
    """y, dX, dW, db and dresidual on the card against the same inputs run
    through the plain versions on the CPU."""
    needs_card()
    rng = np.random.default_rng(4)
    for lay, n in cases()[::2]:
        tables = {d: KernelTables.build(lay, d) for d in ("cuda", "cpu")}
        tt = {d: TransposeTables.build(lay, d) for d in ("cuda", "cpu")}
        for fuse, bias, residual in EPILOGUES:
            arrs = [rng.standard_normal(s).astype(np.float32) for s in
                    ((n, lay.k), lay.data_shape, (lay.m,), (n, lay.m),
                     (n, lay.m))]
            outs = {}
            counters = lambda: (rbgp4mm_rhs.launches,
                                rbgp4mm_rhs.launches_dx,
                                rbgp4_sddmm_rhs.launches)
            before = counters()
            for d in ("cuda", "cpu"):
                x, w, b, r, gy = (torch.tensor(a, device=d).to(dtype)
                                  for a in arrs)
                leaves = [x, w] + [t if on else None
                                   for t, on in ((b, bias), (r, residual))]
                for t in leaves:
                    if t is not None:
                        t.requires_grad_()
                y = RBGP4Linear.apply(*leaves, tables[d], tt[d], fuse)
                y.backward(gy)
                outs[d] = [y.detach()] + [None if t is None else t.grad
                                          for t in leaves]
            # forward and dX on the kernel, dW on the sddmm kernel; the
            # CPU run launches nothing
            assert tuple(a - b for a, b in zip(counters(), before)) == (
                1, 1, 1)
            for name, a, b_ in zip(("y", "dx", "dw", "db", "dr"),
                                   outs["cuda"], outs["cpu"]):
                assert (a is None) == (b_ is None), name
                if a is not None:
                    assert a.device.type == "cuda" and a.dtype == dtype
                    assert_close(a.cpu(), b_, dtype,
                                 (lay.spec, n, fuse, name), GRAD_TOL)


@pytest.mark.cuda
def test_cuda_sddmm_rejects_what_it_does_not_take():
    needs_card()
    lay = RBGP4Layout(design_rbgp4(256, 2048, 0.75, seed=0))
    tables = KernelTables.build(lay, "cuda")
    gy = torch.randn(4, lay.m, device="cuda")
    x = torch.randn(4, lay.k, device="cuda")
    with pytest.raises(TypeError):
        rbgp4_sddmm_rhs(tables, gy.half(), x.half())
    with pytest.raises(TypeError):
        rbgp4_sddmm_rhs(tables, gy, x.bfloat16())
    with pytest.raises(ValueError):
        rbgp4_sddmm_rhs(tables, gy.t().contiguous().t(), x)
    with pytest.raises(ValueError):
        rbgp4_sddmm_rhs(tables, gy[:3], x)
    assert np.isfinite(rbgp4_sddmm_rhs(tables, gy, x).cpu().numpy()).all()


# qwen2-moe-a2.7b's expert layouts: gate/up (C = 128) and down (C = 16)
EXPERT_WIDTH = [(1408, 2048), (2048, 1408)]


def stacked_cases():
    """(layout, E, N): the small sweep with 3 experts, and the full-width
    expert layouts with 60 (bf16 at 77 and 171 rows an expert on the
    tensor-core body, with 128- and 64-token tiles)."""
    out = [(lay, 3, n) for lay, n in cases()[:len(SWEEP)]]
    for m, k in EXPERT_WIDTH:
        lay = RBGP4Layout(design_rbgp4(m, k, 0.75, seed=0))
        out += [(lay, 60, n) for n in (1, 8, 77, 171)]
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_stacked_kernel_matches_plain_and_unstacked(dtype):
    """Y and Z of every expert against the plain version, and bit for bit
    against the unstacked launch of the body ``rhs_path`` picks on that
    expert's slice (the one device body they share: the bf16 tensor-core
    body from 16 rows an expert on, the FMA body otherwise)."""
    needs_card()
    g = torch.Generator(device="cuda").manual_seed(5)
    rnd = lambda *shape: torch.randn(*shape, device="cuda",
                                     generator=g).to(dtype)
    for lay, e, n in stacked_cases():
        tables = KernelTables.build(lay, "cuda")
        path = rhs_path(tables.dims, n, dtype)
        for act, bias, _ in EPILOGUES:
            x, w = rnd(e, n, lay.k), rnd(e, *lay.data_shape)
            b = rnd(e, lay.m) if bias else None
            before = (rbgp4mm_rhs_stacked.launches,
                      rbgp4mm_rhs_stacked.launches_mma)
            y, z = rbgp4mm_rhs_stacked(tables, x, w, bias=b, act=act,
                                       save_preact=True)
            torch.cuda.synchronize()
            assert (rbgp4mm_rhs_stacked.launches,
                    rbgp4mm_rhs_stacked.launches_mma) == (
                before[0] + 1, before[1] + (path == "mma"))
            wy, wz = rbgp4mm_rhs_stacked_reference(tables, x, w, bias=b,
                                                   act=act, save_preact=True)
            assert_close(y, wy, dtype, (lay.spec, e, n, act, "y"))
            assert_close(z, wz, dtype, (lay.spec, e, n, act, "z"))
            for i in (0, e - 1):
                bi = None if b is None else b[i]
                one = body_rhs(path, tables, x[i], w[i], bias=bi, act=act)
                assert torch.equal(y[i], one), (lay.spec, e, n, act, i, path)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_stacked_kernel_on_transposed_layouts(dtype):
    needs_card()
    g = torch.Generator(device="cuda").manual_seed(6)
    rnd = lambda *shape: torch.randn(*shape, device="cuda",
                                     generator=g).to(dtype)
    for lay, e, n in stacked_cases():
        tt = TransposeTables.build(lay, "cuda")
        wt = tt.values(rnd(e, *lay.data_shape))
        gy = rnd(e, n, lay.m)
        before = (rbgp4mm_rhs_stacked.launches,
                  rbgp4mm_rhs_stacked.launches_dx)
        got = rbgp4mm_rhs_stacked(tt.tables, gy, wt)
        torch.cuda.synchronize()
        assert (rbgp4mm_rhs_stacked.launches,
                rbgp4mm_rhs_stacked.launches_dx) == (before[0],
                                                     before[1] + 1)
        want = rbgp4mm_rhs_stacked_reference(tt.tables, gy, wt)
        assert_close(got, want, dtype, (lay.spec, e, n))
        path = rhs_path(tt.tables.dims, n, dtype)
        for i in (0, e - 1):
            assert torch.equal(got[i], body_rhs(path, tt.tables, gy[i],
                                                wt[i])), (lay.spec, e, n, i)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_stacked_sddmm_matches_plain_and_unstacked(dtype):
    needs_card()
    g = torch.Generator(device="cuda").manual_seed(7)
    rnd = lambda *shape: torch.randn(*shape, device="cuda",
                                     generator=g).to(dtype)
    for lay, e, n in stacked_cases():
        tables = KernelTables.build(lay, "cuda")
        gy, x = rnd(e, n, lay.m), rnd(e, n, lay.k)
        before = rbgp4_sddmm_rhs_stacked.launches
        got = rbgp4_sddmm_rhs_stacked(tables, gy, x)
        torch.cuda.synchronize()
        assert rbgp4_sddmm_rhs_stacked.launches == before + 1
        assert tuple(got.shape) == (e, *lay.data_shape)
        want = rbgp4_sddmm_rhs_stacked_reference(tables, gy, x)
        assert_close(got, want, dtype, (lay.spec, e, n))
        assert torch.equal(got, rbgp4_sddmm_rhs_stacked(tables, gy, x))
        path = sddmm_path(tables.dims, n, dtype)
        plan = (stacked_sddmm_mma_plan(tables.dims, e, n, _sm_count("cuda"))
                if path == "mma" else None)
        for i in (0, e - 1):
            assert torch.equal(got[i], body_sddmm(path, tables, gy[i], x[i],
                                                  plan)), (lay.spec, e, n, i)
            if path == "mma":
                assert_close(got[i], rbgp4_sddmm_rhs(tables, gy[i], x[i]),
                             dtype, (lay.spec, e, n, i, "mma"))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_linear_stacked_grads_match_plain_versions(dtype):
    """y, dX, dW and db of ``RBGP4LinearStacked`` on the card against the
    same inputs through the plain versions on the CPU."""
    needs_card()
    rng = np.random.default_rng(8)
    for lay, e, n in stacked_cases()[::2]:
        tables = {d: KernelTables.build(lay, d) for d in ("cuda", "cpu")}
        tt = {d: TransposeTables.build(lay, d) for d in ("cuda", "cpu")}
        for fuse, bias, _ in EPILOGUES:
            arrs = [rng.standard_normal(s).astype(np.float32) for s in
                    ((e, n, lay.k), (e, *lay.data_shape), (e, lay.m),
                     (e, n, lay.m))]
            counters = lambda: (rbgp4mm_rhs_stacked.launches,
                                rbgp4mm_rhs_stacked.launches_dx,
                                rbgp4_sddmm_rhs_stacked.launches)
            before = counters()
            outs = {}
            for d in ("cuda", "cpu"):
                x, w, b, gy = (torch.tensor(a, device=d).to(dtype)
                               for a in arrs)
                leaves = [x, w, b if bias else None]
                for t in leaves:
                    if t is not None:
                        t.requires_grad_()
                y = RBGP4LinearStacked.apply(*leaves, tables[d], tt[d], fuse)
                y.backward(gy)
                outs[d] = [y.detach()] + [None if t is None else t.grad
                                          for t in leaves]
            assert tuple(a - b for a, b in zip(counters(), before)) == (
                1, 1, 1)
            for name, a, b_ in zip(("y", "dx", "dw", "db"), outs["cuda"],
                                   outs["cpu"]):
                assert (a is None) == (b_ is None), name
                if a is not None:
                    assert a.device.type == "cuda" and a.dtype == dtype
                    assert_close(a.cpu(), b_, dtype,
                                 (lay.spec, e, n, fuse, name), GRAD_TOL)


@pytest.mark.cuda
def test_cuda_stacked_kernels_reject_what_they_do_not_take():
    needs_card()
    lay = RBGP4Layout(design_rbgp4(1408, 2048, 0.75, seed=0))
    tables = KernelTables.build(lay, "cuda")
    x = torch.randn(4, 3, lay.k, device="cuda")
    w = torch.randn(4, *lay.data_shape, device="cuda")
    gy = torch.randn(4, 3, lay.m, device="cuda")
    with pytest.raises(TypeError):
        rbgp4mm_rhs_stacked(tables, x, w.bfloat16())
    with pytest.raises(ValueError):
        rbgp4mm_rhs_stacked(tables, x.transpose(0, 1).contiguous()
                            .transpose(0, 1), w)
    with pytest.raises(ValueError):
        rbgp4mm_rhs_stacked(tables, x, w, bias=torch.randn(lay.m,
                                                           device="cuda"))
    with pytest.raises(ValueError):
        rbgp4mm_rhs_stacked(tables, x, w[:3])
    with pytest.raises(TypeError):
        rbgp4_sddmm_rhs_stacked(tables, gy.half(), x.half())
    with pytest.raises(ValueError):
        rbgp4_sddmm_rhs_stacked(tables, gy[:, :2], x)
    assert np.isfinite(rbgp4mm_rhs_stacked(tables, x, w).cpu().numpy()).all()


# deep chains: the three of tests/test_chain_executor.py (m, k, sparsity,
# factors) and tinyllama's four shapes under the hierarchical-block plan
_RAM = ("ramanujan", 0, 0, 0.5)
_AUTO = ("ramanujan", 0, 0, -1.0)
CHAINS = [
    (128, 128, 0.875, (_RAM,) * 3),
    (256, 256, 0.9375, (_RAM,) * 4),
    (128, 256, 0.875, (("complete", 4, 4, 0.0), _RAM, _RAM, _RAM,
                       ("complete", 2, 2, 0.0))),
] + [(m, k, 0.875, (("complete", 4, 4, 0.0), _AUTO, _AUTO, _AUTO,
                    ("complete", 8, 8, 0.0))) for m, k in FULL_WIDTH]


def chain_cases():
    for m, k, sp, factors in CHAINS:
        yield ChainLayout(design_rbgp(m, k, sp, factors=factors, seed=0))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_chain_kernels_match_plain_versions(dtype):
    """Each case one counted launch: the forward at N in {1, 8, 77}, on
    the transposed tables at N = 77 (dX, counted apart), dW at N = 77."""
    needs_card()
    g = torch.Generator(device="cuda").manual_seed(9)
    rnd = lambda *shape: torch.randn(*shape, device="cuda",
                                     generator=g).to(dtype)
    for lay in chain_cases():
        t = chain_tables(lay, "cuda")
        tt = chain_transpose_tables(lay, "cuda")
        w = rnd(*lay.data_shape)
        for n in (1, 8, 77):
            x = rnd(n, lay.k)
            before = chainmm_rhs.launches
            got = chainmm_rhs(t, x, w)
            torch.cuda.synchronize()
            assert chainmm_rhs.launches == before + 1
            assert_close(got, chainmm_rhs_reference(t, x, w), dtype,
                         (lay, n))
        gy, x = rnd(77, lay.m), rnd(77, lay.k)
        wt = tt.values(w)
        before = chainmm_rhs.launches, chainmm_rhs.launches_dx
        got = chainmm_rhs(tt.tables, gy, wt)
        torch.cuda.synchronize()
        assert (chainmm_rhs.launches, chainmm_rhs.launches_dx) == (
            before[0], before[1] + 1)
        assert_close(got, chainmm_rhs_reference(tt.tables, gy, wt), dtype,
                     (lay, "dx"))
        before = chain_sddmm_rhs.launches
        dw = chain_sddmm_rhs(t, gy, x)
        torch.cuda.synchronize()
        assert chain_sddmm_rhs.launches == before + 1
        assert_close(dw, chain_sddmm_rhs_reference(t, gy, x), dtype,
                     (lay, "dw"))
        # no atomics: a rerun gives the same bits
        assert torch.equal(dw, chain_sddmm_rhs(t, gy, x))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_chain_linear_grads_match_plain_versions(dtype):
    needs_card()
    g = torch.Generator(device="cuda").manual_seed(10)
    for lay in chain_cases():
        w = torch.randn(lay.data_shape, device="cuda", generator=g).to(dtype)
        x = torch.randn(33, lay.k, device="cuda", generator=g).to(dtype)
        gy = torch.randn(33, lay.m, device="cuda", generator=g).to(dtype)
        out = {}
        for dev in ("cuda", "cpu"):
            xa = x.detach().to(dev).clone().requires_grad_()
            wa = w.detach().to(dev).clone().requires_grad_()
            y = ChainLinear.apply(xa, wa, chain_tables(lay, dev),
                                  chain_transpose_tables(lay, dev))
            y.backward(gy.to(dev))
            out[dev] = (y.detach(), xa.grad, wa.grad)
        for a, b, what in zip(out["cuda"], out["cpu"], ("y", "dx", "dw")):
            assert_close(a.cpu(), b, dtype, (lay, what))


@pytest.mark.cuda
def test_cuda_chain_kernels_reject_what_they_do_not_take():
    needs_card()
    lay = next(chain_cases())
    t = chain_tables(lay, "cuda")
    x = torch.randn(4, lay.k, device="cuda")
    w = torch.randn(lay.data_shape, device="cuda")
    with pytest.raises(TypeError):
        chainmm_rhs(t, x.half(), w.half())
    with pytest.raises(TypeError):
        chain_sddmm_rhs(t, torch.randn(4, lay.m, device="cuda"), x.bfloat16())
    with pytest.raises(ValueError):
        chainmm_rhs(chain_tables(lay, "cpu"), x, w)
    with pytest.raises(ValueError):
        chainmm_rhs(t, x.t().contiguous().t(), w)


# feature-major layouts: test_kernels.py's G = C = 4; design_rbgp4 at
# WRN-40-4's 64 x 144 (C = 2; transposed G = 2), VGG19-CIFAR's 64 x 576
# (transposed G = 8, C = 16) and 512 x 4608 (C = 64; transposed G = 64);
# and two row groups rbgp4mm walks in more than one pass of row subsets:
# G = 9 (odd: one row a subset; transposed C = 9) and G = 256 (transposed
# C = 256, staged in passes of 64 columns)
FM_LAYOUTS = [(64, 144), (64, 576), (512, 4608)]
FM_SPECS = [((4, 4), (4, 4), (4, 4)), ((2, 4), (9, 4), (2, 4)),
            ((2, 4), (256, 2), (2, 2))]


def fm_layouts():
    specs = [RBGP4Spec(g_o=g_o, g_r=g_r, g_i=g_i, g_b=(1, 1), sp_o=0.5,
                       sp_i=0.5, seed=7) for g_o, g_r, g_i in FM_SPECS]
    return [RBGP4Layout(spec) for spec in specs] + [
        RBGP4Layout(design_rbgp4(m, k, 0.75, seed=0)) for m, k in FM_LAYOUTS]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_featmajor_kernels_match_plain_versions(dtype):
    """``rbgp4mm`` on forward and transposed tables and ``rbgp4_sddmm``
    (one slice of N, and many) against their plain versions; dW bit-equal
    on a rerun."""
    needs_card()
    g = torch.Generator(device="cuda").manual_seed(11)
    rnd = lambda *shape: torch.randn(*shape, device="cuda",
                                     generator=g).to(dtype)
    for lay in fm_layouts():
        tables = KernelTables.build(lay, "cuda")
        tt = TransposeTables.build(lay, "cuda")
        w = rnd(*lay.data_shape)
        wt = tt.values(w)
        for n in (1, 37, 300, 5000):
            x, gy = rnd(lay.k, n), rnd(lay.m, n)
            before = (rbgp4mm.launches, rbgp4mm.launches_dx,
                      rbgp4_sddmm.launches)
            o = rbgp4mm(tables, x, w)
            dx = rbgp4mm(tt.tables, gy, wt)
            dw = rbgp4_sddmm(tables, gy, x)
            torch.cuda.synchronize()
            assert (rbgp4mm.launches, rbgp4mm.launches_dx,
                    rbgp4_sddmm.launches) == tuple(b + 1 for b in before)
            assert o.dtype == dx.dtype == dw.dtype == dtype
            assert_close(o, rbgp4mm_reference(tables, x, w), dtype,
                         (lay.spec, n, "O"))
            assert_close(dx, rbgp4mm_reference(tt.tables, gy, wt), dtype,
                         (lay.spec, n, "dI"))
            assert_close(dw, rbgp4_sddmm_reference(tables, gy, x), dtype,
                         (lay.spec, n, "dW"))
            # a rerun gives the same bits: no atomics, slices added in order
            assert torch.equal(dw, rbgp4_sddmm(tables, gy, x))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_matmul_grads_match_plain_versions(dtype):
    """O, dW and dI of ``RBGP4Op.matmul`` on the card against the same
    inputs through the plain versions on the CPU."""
    needs_card()
    rng = np.random.default_rng(12)
    for lay in fm_layouts():
        ops = {d: RBGP4Op(lay, device=d) for d in ("cuda", "cpu")}
        arrs = [rng.standard_normal(s).astype(np.float32) for s in
                (lay.data_shape, (lay.k, 77), (lay.m, 77))]
        outs = {}
        for d, op in ops.items():
            w, x, gy = (torch.tensor(a, device=d).to(dtype) for a in arrs)
            w.requires_grad_()
            x.requires_grad_()
            o = op.matmul(w, x)
            o.backward(gy)
            outs[d] = (o.detach(), w.grad, x.grad)
        for name, a, b in zip(("O", "dW", "dI"), outs["cuda"], outs["cpu"]):
            assert a.device.type == "cuda" and a.dtype == dtype
            assert_close(a.cpu(), b, dtype, (lay.spec, name), GRAD_TOL)


@pytest.mark.cuda
def test_cuda_featmajor_kernels_reject_what_they_do_not_take():
    needs_card()
    lay = RBGP4Layout(design_rbgp4(64, 576, 0.75, seed=0))
    tables = KernelTables.build(lay, "cuda")
    x = torch.randn(lay.k, 8, device="cuda")
    w = torch.randn(lay.data_shape, device="cuda")
    gy = torch.randn(lay.m, 8, device="cuda")
    with pytest.raises(TypeError):
        rbgp4mm(tables, x.half(), w.half())
    with pytest.raises(TypeError):
        rbgp4mm(tables, x, w.bfloat16())
    with pytest.raises(ValueError):
        rbgp4mm(tables, x.t().contiguous().t(), w)
    with pytest.raises(TypeError):
        rbgp4_sddmm(tables, gy, x.bfloat16())
    with pytest.raises(ValueError):
        rbgp4_sddmm(tables, gy[:, :3], x)
    assert np.isfinite(rbgp4mm(tables, x, w).cpu().numpy()).all()
    assert np.isfinite(rbgp4_sddmm(tables, gy, x).cpu().numpy()).all()


# the int8 (scales=) paths: an odd G = 9, G = 128 (8 tokens a block), the
# small sweep's first layout and tinyllama's wk/wv at full width; the
# chains of the tests above (G = C = 1, a 2 x 2 leaf, and the full-width
# 8 x 8, 16 x 32 and 32 x 16 leaves)
INT8_SPECS = [((2, 4), (9, 4), (2, 4)), ((2, 4), (128, 4), (2, 2)),
              ((4, 4), (4, 4), (4, 4))]


def int8_layouts():
    specs = [RBGP4Spec(g_o=g_o, g_r=g_r, g_i=g_i, g_b=(1, 1), sp_o=0.5,
                       sp_i=0.5, seed=7) for g_o, g_r, g_i in INT8_SPECS]
    return [RBGP4Layout(spec) for spec in specs] + [
        RBGP4Layout(design_rbgp4(256, 2048, 0.75, seed=0))]


def int8_values(shape, G, C, g):
    from repro_torch.sparsity.quant import quantize_block_values

    return quantize_block_values(
        torch.randn(shape, device="cuda", generator=g), G, C)


def check_int8(fn, ref, dequant_fn, counter, dtype, what):
    """One counted int8 launch against its plain version; a rerun gives
    the same bits; in float32 the same bits as the f32 kernel on the
    dequantized values (same operands, same order: a wrong scale index
    shows here)."""
    before = (counter.launches, counter.launches_q)
    got = fn()
    torch.cuda.synchronize()
    assert (counter.launches, counter.launches_q) == (before[0],
                                                       before[1] + 1), what
    assert_close(got, ref(), dtype, what)
    assert torch.equal(got, fn()), what
    if dtype == torch.float32:
        assert torch.equal(got, dequant_fn()), what


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_int8_kernels_match_plain_versions(dtype):
    from repro_torch.kernels.ref import dequant_leaf_blocks
    from repro_torch.sparsity import leaf_block_dims

    needs_card()
    g = torch.Generator(device="cuda").manual_seed(13)
    rnd = lambda *shape: torch.randn(*shape, device="cuda",
                                     generator=g).to(dtype)
    for lay in int8_layouts():
        tables = KernelTables.build(lay, "cuda")
        G, C = leaf_block_dims(lay)
        q, s = int8_values(lay.data_shape, G, C, g)
        w = dequant_leaf_blocks(q, s, G, C)
        for n in (1, 8, 77):
            x = rnd(n, lay.k)
            check_int8(lambda: rbgp4mm_rhs(tables, x, q, scales=s),
                       lambda: rbgp4mm_rhs_reference(tables, x, q, scales=s),
                       lambda: rbgp4mm_rhs(tables, x, w), rbgp4mm_rhs,
                       dtype, (lay.spec, n))
        e = 3
        qe, se = int8_values((e, *lay.data_shape), G, C, g)
        we = dequant_leaf_blocks(qe, se, G, C)
        x = rnd(e, 21, lay.k)
        check_int8(
            lambda: rbgp4mm_rhs_stacked(tables, x, qe, scales=se),
            lambda: rbgp4mm_rhs_stacked_reference(tables, x, qe, scales=se),
            lambda: rbgp4mm_rhs_stacked(tables, x, we), rbgp4mm_rhs_stacked,
            dtype, (lay.spec, "stacked"))
    for lay in chain_cases():
        t = chain_tables(lay, "cuda")
        G, C = leaf_block_dims(lay)
        q, s = int8_values(lay.data_shape, G, C, g)
        w = dequant_leaf_blocks(q, s, G, C)
        for n in (1, 8, 77):
            x = rnd(n, lay.k)
            check_int8(lambda: chainmm_rhs(t, x, q, scales=s),
                       lambda: chainmm_rhs_reference(t, x, q, scales=s),
                       lambda: chainmm_rhs(t, x, w), chainmm_rhs, dtype,
                       (lay, n))


@pytest.mark.cuda
def test_cuda_quantized_layers_launch_only_the_int8_paths():
    """A quantized compact or chain ``SparseLinear`` (bias, activation and
    residual asked for) and quantized stacked experts launch the int8
    kernels and nothing else, under no_grad; with a gradient asked for
    they raise."""
    from repro_torch.models.moe import StackedExperts
    from repro_torch.sparsity import (SparseLinear, SparsityConfig,
                                      sparse_linear)

    needs_card()
    rbgp4 = SparsityConfig(pattern="rbgp4", sparsity=0.75, min_dim=1)
    chain = SparsityConfig(pattern="rbgp", sparsity=0.875, min_dim=1,
                           factors=CHAINS[2][3])
    counters = (rbgp4mm_rhs, rbgp4mm_rhs_stacked, chainmm_rhs)

    def counts():
        return [(c.launches, c.launches_dx, c.launches_q) for c in counters]

    for cfg, m, k, counter in ((rbgp4, 128, 256, 0), (chain, 128, 256, 2)):
        lin = SparseLinear(k, m, cfg, use_bias=True, device="cuda")
        assert lin.mode == ("compact", "compact", "chain")[counter]
        lin.b.data.normal_()
        x = torch.randn(5, k, device="cuda")
        r = torch.randn(5, m, device="cuda")
        want = sparse_linear(lin.weight(), x, fuse="silu", residual=r)
        lin.quantize_()
        before = counts()
        with torch.no_grad():
            y = lin(x, fuse="silu", residual=r)
        torch.cuda.synchronize()
        after = counts()
        for i, (a, b) in enumerate(zip(before, after)):
            moved = (0, 0, 1) if i == counter else (0, 0, 0)
            assert tuple(v - u for u, v in zip(a, b)) == moved, (cfg, i)
        assert y.shape == want.shape and torch.isfinite(y).all()
        with pytest.raises(RuntimeError, match="inference-only"):
            lin(x.clone().requires_grad_())
    experts = StackedExperts(4, 256, 128, rbgp4, device="cuda")
    experts.quantize_()
    before = counts()
    with torch.no_grad():
        out = experts(torch.randn(4, 6, 256, device="cuda"))
    torch.cuda.synchronize()
    assert [tuple(v - u for u, v in zip(a, b))
            for a, b in zip(before, counts())] == [(0, 0, 0), (0, 0, 3),
                                                   (0, 0, 0)]
    assert torch.isfinite(out).all()


@pytest.mark.cuda
def test_cuda_int8_kernels_reject_what_they_do_not_take():
    from repro_torch.sparsity import leaf_block_dims

    needs_card()
    g = torch.Generator(device="cuda").manual_seed(14)
    lay = int8_layouts()[0]
    tables = KernelTables.build(lay, "cuda")
    q, s = int8_values(lay.data_shape, *leaf_block_dims(lay), g)
    x = torch.randn(4, lay.k, device="cuda")
    with pytest.raises(ValueError, match="epilogue"):
        rbgp4mm_rhs(tables, x, q, scales=s, act="silu")
    with pytest.raises(TypeError):
        rbgp4mm_rhs(tables, x, q.float(), scales=s)
    with pytest.raises(ValueError):
        rbgp4mm_rhs(tables, x, q, scales=s[:, :1].contiguous())
    with pytest.raises(TypeError):
        rbgp4mm_rhs(tables, x, q, scales=s.double())
    with pytest.raises(TypeError):
        rbgp4mm_rhs(tables, x.half(), q, scales=s)
    with pytest.raises(ValueError):
        rbgp4mm_rhs_stacked(tables, x[None], q[None], scales=s)
    assert np.isfinite(rbgp4mm_rhs(tables, x, q, scales=s).cpu().numpy()).all()


# -- the bf16 tensor-core bodies of rbgp4mm_rhs and rbgp4_sddmm_rhs ---------

# small layouts with every (G, C) of G in {16, 64, 128}, C in {16, 64}:
# m, k, G, C, u_i, v_i, sp_o, sp_i (their transposed layouts add G = 16
# with C = 128, and G = 64 with C = 128)
MMA_SMALL = [
    (128, 128, 16, 16, 2, 2, 0.5, 0.5),
    (256, 512, 16, 64, 4, 2, 0.5, 0.5),
    (256, 256, 64, 16, 2, 4, 0.0, 0.5),
    (256, 256, 64, 64, 2, 2, 0.5, 0.0),
    (512, 256, 128, 16, 2, 4, 0.5, 0.5),
    (512, 128, 128, 64, 2, 1, 0.5, 0.0),
]
# the smallest mma launch, a half and a ragged 128-token tile, a ragged
# 1037
MMA_ROWS = (16, 64, 77, 1037)


def mma_layouts():
    out = [RBGP4Layout(RBGP4Spec(g_o=(m // (ui * G), k // (vi * C)),
                                 g_r=(G, C), g_i=(ui, vi), g_b=(1, 1),
                                 sp_o=sp_o, sp_i=sp_i, seed=7))
           for m, k, G, C, ui, vi, sp_o, sp_i in MMA_SMALL]
    return out + [RBGP4Layout(design_rbgp4(m, k, 0.75, seed=0))
                  for m, k in FULL_WIDTH]


@pytest.mark.cuda
def test_cuda_mma_bodies_match_plain_versions():
    """bf16 from N = 16 on: the forward (three epilogues, Y and Z), dX on
    the transposed tables and dW each take the tensor-core body, one
    counted launch each, and agree with the plain versions; dW again is
    bit-equal (token slices added in a fixed order, no atomics)."""
    needs_card()
    dt = torch.bfloat16
    g = torch.Generator(device="cuda").manual_seed(11)
    rnd = lambda *shape: torch.randn(*shape, device="cuda",
                                     generator=g).to(dt)
    for lay in mma_layouts():
        tables = KernelTables.build(lay, "cuda")
        tt = TransposeTables.build(lay, "cuda")
        w = rnd(*lay.data_shape)
        wt = tt.values(w)
        for n in MMA_ROWS:
            assert rhs_path(tables.dims, n, dt) == "mma"
            assert rhs_path(tt.tables.dims, n, dt) == "mma"
            assert sddmm_path(tables.dims, n, dt) == "mma"
            x, gy = rnd(n, lay.k), rnd(n, lay.m)
            for act, bias, residual in EPILOGUES:
                b = rnd(lay.m) if bias else None
                r = rnd(n, lay.m) if residual else None
                before = (rbgp4mm_rhs.launches, rbgp4mm_rhs.launches_mma)
                y, z = rbgp4mm_rhs(tables, x, w, bias=b, act=act,
                                   residual=r, save_preact=True)
                torch.cuda.synchronize()
                assert (rbgp4mm_rhs.launches, rbgp4mm_rhs.launches_mma) == (
                    before[0] + 1, before[1] + 1)
                wy, wz = rbgp4mm_rhs_reference(tables, x, w, bias=b, act=act,
                                               residual=r, save_preact=True)
                assert_close(y, wy, dt, (lay.spec, n, act, "y"))
                assert_close(z, wz, dt, (lay.spec, n, act, "z"))
            before = (rbgp4mm_rhs.launches_dx, rbgp4mm_rhs.launches_mma)
            dx = rbgp4mm_rhs(tt.tables, gy, wt)
            torch.cuda.synchronize()
            assert (rbgp4mm_rhs.launches_dx, rbgp4mm_rhs.launches_mma) == (
                before[0] + 1, before[1] + 1)
            assert_close(dx, rbgp4mm_rhs_reference(tt.tables, gy, wt), dt,
                         (lay.spec, n, "dx"))
            before = (rbgp4_sddmm_rhs.launches, rbgp4_sddmm_rhs.launches_mma)
            dw = rbgp4_sddmm_rhs(tables, gy, x)
            torch.cuda.synchronize()
            assert (rbgp4_sddmm_rhs.launches,
                    rbgp4_sddmm_rhs.launches_mma) == (before[0] + 1,
                                                      before[1] + 1)
            assert dw.dtype == dt and tuple(dw.shape) == lay.data_shape
            assert_close(dw, rbgp4_sddmm_rhs_reference(tables, gy, x), dt,
                         (lay.spec, n, "dw"))
            assert torch.equal(dw, rbgp4_sddmm_rhs(tables, gy, x))


@pytest.mark.cuda
def test_cuda_mma_bodies_leave_decode_float32_and_int8_to_fma():
    """N = 8 in bf16 and float32 at any N take the FMA bodies, unstacked,
    stacked and chain, forward and dW; so do the int8 entry points in
    bf16 at a training step's N, where the stacked forward, dX and dW
    take the tensor-core bodies: ``rbgp4mm_rhs_stacked.launches_mma``
    moves by two, ``rbgp4_sddmm_rhs_stacked.launches_mma`` by one, and
    nothing else."""
    from repro_torch.sparsity import leaf_block_dims

    needs_card()
    lay = RBGP4Layout(design_rbgp4(2048, 2048, 0.75, seed=0))
    tables = KernelTables.build(lay, "cuda")
    tt = TransposeTables.build(lay, "cuda")
    chain = next(iter(mma_chain_cases()))
    ct = chain_tables(chain, "cuda")
    g = torch.Generator(device="cuda").manual_seed(15)
    mma = lambda: (rbgp4mm_rhs.launches_mma, rbgp4_sddmm_rhs.launches_mma,
                   rbgp4mm_rhs_stacked.launches_mma,
                   rbgp4_sddmm_rhs_stacked.launches_mma,
                   chainmm_rhs.launches_mma, chain_sddmm_rhs.launches_mma)
    for n, dt in ((8, torch.bfloat16), (1037, torch.float32)):
        x = torch.randn(n, lay.k, device="cuda").to(dt)
        w = torch.randn(lay.data_shape, device="cuda").to(dt)
        gy = torch.randn(n, lay.m, device="cuda").to(dt)
        stack = lambda t: t[None].expand(2, -1, -1).contiguous()
        before = mma()
        rbgp4mm_rhs(tables, x, w)
        rbgp4_sddmm_rhs(tables, gy, x)
        rbgp4mm_rhs_stacked(tables, stack(x), stack(w))
        rbgp4_sddmm_rhs_stacked(tables, stack(gy), stack(x))
        cx = torch.randn(n, chain.k, device="cuda").to(dt)
        chainmm_rhs(ct, cx, torch.randn(chain.data_shape,
                                        device="cuda").to(dt))
        chain_sddmm_rhs(ct, torch.randn(n, chain.m, device="cuda").to(dt),
                        cx)
        torch.cuda.synchronize()
        assert mma() == before, (n, dt)
    dt, e, n = torch.bfloat16, 2, 1037
    x = torch.randn(e, n, lay.k, device="cuda").to(dt)
    w = torch.randn(e, *lay.data_shape, device="cuda").to(dt)
    gy = torch.randn(e, n, lay.m, device="cuda").to(dt)
    q, s = int8_values(lay.data_shape, *leaf_block_dims(lay), g)
    cq, cs = int8_values(chain.data_shape, ct.group_rows, ct.chunk_cols, g)
    before = (mma(), rbgp4mm_rhs_stacked.launches,
              rbgp4mm_rhs_stacked.launches_dx,
              rbgp4_sddmm_rhs_stacked.launches, rbgp4mm_rhs.launches_q,
              chainmm_rhs.launches_q)
    rbgp4mm_rhs_stacked(tables, x, w)
    rbgp4mm_rhs_stacked(tt.tables, gy, tt.values(w))
    rbgp4_sddmm_rhs_stacked(tables, gy, x)
    rbgp4mm_rhs(tables, x[0], q, scales=s)
    chainmm_rhs(ct, torch.randn(n, chain.k, device="cuda").to(dt), cq,
                scales=cs)
    torch.cuda.synchronize()
    b = before[0]
    want_mma = (b[0], b[1], b[2] + 2, b[3] + 1, b[4], b[5])
    assert (mma(), rbgp4mm_rhs_stacked.launches,
            rbgp4mm_rhs_stacked.launches_dx,
            rbgp4_sddmm_rhs_stacked.launches, rbgp4mm_rhs.launches_q,
            chainmm_rhs.launches_q) == (
        want_mma, before[1] + 1, before[2] + 1, before[3] + 1,
        before[4] + 1, before[5] + 1)


@pytest.mark.cuda
def test_cuda_mma_bodies_reject_misaligned_operands():
    """The tensor-core bodies load 16 bytes at a time: an operand whose
    data does not start on 16 bytes is refused, not run on another
    body."""
    needs_card()
    lay = RBGP4Layout(design_rbgp4(256, 2048, 0.75, seed=0))
    tables = KernelTables.build(lay, "cuda")
    n = 77
    flat = torch.randn(n * lay.k + 1, device="cuda").bfloat16()
    x_off = flat[1:].view(n, lay.k)
    assert x_off.is_contiguous() and x_off.data_ptr() % 16
    w = torch.randn(lay.data_shape, device="cuda").bfloat16()
    gy = torch.randn(n, lay.m, device="cuda").bfloat16()
    with pytest.raises(ValueError):
        rbgp4mm_rhs(tables, x_off, w)
    with pytest.raises(ValueError):
        rbgp4_sddmm_rhs(tables, gy, x_off)
    x = x_off.clone()
    assert np.isfinite(rbgp4mm_rhs(tables, x, w).float().cpu().numpy()).all()


@pytest.mark.cuda
def test_cuda_rbgp4_linear_mma_grads_match_dense_autograd():
    """``RBGP4Linear`` in bf16 at N = 1037 (every product on a
    tensor-core body) against float32 autograd through the dense matrix
    ``unpack_dense`` on the same bf16 values: y, dX, dW, db, dresidual."""
    needs_card()
    dt = torch.bfloat16
    n = 1037
    rng = np.random.default_rng(12)
    acts = {None: lambda z: z, "silu": torch.nn.functional.silu,
            "gelu": lambda z: torch.nn.functional.gelu(z,
                                                       approximate="tanh")}
    for lay in mma_layouts()[::2] + mma_layouts()[-1:]:
        tables = KernelTables.build(lay, "cuda")
        tt = TransposeTables.build(lay, "cuda")
        for fuse, bias, residual in EPILOGUES:
            arrs = [torch.tensor(rng.standard_normal(s).astype(np.float32))
                    .to(dt) for s in ((n, lay.k), lay.data_shape, (lay.m,),
                                      (n, lay.m), (n, lay.m))]
            x, w, b, r, gy = (a.cuda().requires_grad_() for a in arrs)
            leaves = [x, w, b if bias else None, r if residual else None]
            before = (rbgp4mm_rhs.launches_mma, rbgp4_sddmm_rhs.launches_mma)
            y = RBGP4Linear.apply(*leaves, tables, tt, fuse)
            y.backward(gy.detach())
            torch.cuda.synchronize()
            assert (rbgp4mm_rhs.launches_mma - before[0],
                    rbgp4_sddmm_rhs.launches_mma - before[1]) == (2, 1)
            xd, wd, bd, rd = (a.float().cuda().requires_grad_()
                              for a in arrs[:4])
            zd = xd @ unpack_dense(lay, wd).T
            if bias:
                zd = zd + bd
            yd = acts[fuse](zd)
            if residual:
                yd = yd + rd
            yd.backward(arrs[4].float().cuda())
            for name, a, b_ in (("y", y, yd), ("dx", x.grad, xd.grad),
                                ("dw", w.grad, wd.grad),
                                ("db", b.grad if bias else None, bd.grad),
                                ("dr", r.grad if residual else None,
                                 rd.grad)):
                if a is None:
                    continue
                assert a.dtype == dt
                assert_close(a, b_, dt, (lay.spec, fuse, name), GRAD_TOL)


# -- the bf16 tensor-core body of chain_sddmm_rhs over row-group classes ------

# chains whose leaves take the tensor-core body (G, C multiples of 8):
# leaves 8 x 16 (classes of 1 and 3 row groups; transposed 16 x 8), 16 x 8
# (transposed classes of 4 and 12), 128 x 64 (one 128-row group spans two
# 64-row tiles) and 8 x 8
MMA_CHAINS = [
    (256, 256, 0.75, (_RAM, _RAM, ("complete", 8, 16, 0.0))),
    (512, 1024, 0.875, (("complete", 2, 2, 0.0), _AUTO, _AUTO,
                        ("complete", 16, 8, 0.0))),
    (1024, 512, 0.75, (_AUTO, _AUTO, ("complete", 32, 16, 0.0))),
    (256, 512, 0.75, (("complete", 2, 2, 0.0), _AUTO, _AUTO,
                      ("complete", 8, 8, 0.0))),
]


def mma_chain_cases():
    """The small chains above and tinyllama's four under the
    hierarchical-block plan (the last entries of ``CHAINS``)."""
    for m, k, sp, factors in MMA_CHAINS + CHAINS[3:]:
        yield ChainLayout(design_rbgp(m, k, sp, factors=factors, seed=0))


@pytest.mark.cuda
def test_cuda_chain_mma_body_matches_plain_version():
    """bf16 from N = 16 on: dW on the forward and the transposed tables
    takes the tensor-core body, one counted launch (and one tensor-core
    launch) each, and agrees with the plain version; the FMA body on the
    same operands agrees too."""
    needs_card()
    dt = torch.bfloat16
    g = torch.Generator(device="cuda").manual_seed(16)
    rnd = lambda *shape: torch.randn(*shape, device="cuda",
                                     generator=g).to(dt)
    for lay in mma_chain_cases():
        for t in (chain_tables(lay, "cuda"),
                  chain_transpose_tables(lay, "cuda").tables):
            for n in MMA_ROWS:
                assert chain_sddmm_path(t, n, dt) == "mma"
                gy, x = rnd(n, t.m), rnd(n, t.k)
                before = (chain_sddmm_rhs.launches,
                          chain_sddmm_rhs.launches_mma)
                dw = chain_sddmm_rhs(t, gy, x)
                torch.cuda.synchronize()
                assert (chain_sddmm_rhs.launches,
                        chain_sddmm_rhs.launches_mma) == (before[0] + 1,
                                                          before[1] + 1)
                assert dw.dtype == dt and tuple(dw.shape) == (t.m,
                                                              t.data_cols)
                want = chain_sddmm_rhs_reference(t, gy, x)
                assert_close(dw, want, dt, (t.m, t.k, n, "mma"))
                fma = torch.empty_like(dw)
                _chain_sddmm_body("fma", t, gy, x, fma)
                assert_close(fma, want, dt, (t.m, t.k, n, "fma"))


@pytest.mark.cuda
def test_cuda_chain_mma_body_reruns_bit_equal():
    """No atomics, token slices added in a fixed order: a rerun of the
    tensor-core body gives the same bits, sliced (wq/wo, wk/wv at 4096
    tokens) or not."""
    needs_card()
    dt = torch.bfloat16
    g = torch.Generator(device="cuda").manual_seed(17)
    for lay in mma_chain_cases():
        t = chain_tables(lay, "cuda")
        for n in (77, 4096):
            gy = torch.randn(n, t.m, device="cuda", generator=g).to(dt)
            x = torch.randn(n, t.k, device="cuda", generator=g).to(dt)
            dw = chain_sddmm_rhs(t, gy, x)
            assert torch.equal(dw, chain_sddmm_rhs(t, gy, x)), (t.m, t.k, n)


@pytest.mark.cuda
def test_cuda_chain_linear_mma_grads_match_dense_autograd():
    """``ChainLinear`` in bf16 at N = 1037 (the forward, dX and dW on the
    tensor-core bodies) against float32 autograd through the dense matrix
    ``chain_unpack_dense`` on the same bf16 values: y, dX and dW."""
    needs_card()
    dt = torch.bfloat16
    n = 1037
    rng = np.random.default_rng(18)
    for lay in mma_chain_cases():
        arrs = [torch.tensor(rng.standard_normal(s).astype(np.float32))
                .to(dt).cuda() for s in ((n, lay.k), lay.data_shape,
                                         (n, lay.m))]
        x, w = (a.clone().requires_grad_() for a in arrs[:2])
        before = (chainmm_rhs.launches_mma, chain_sddmm_rhs.launches_mma)
        y = ChainLinear.apply(x, w, chain_tables(lay, "cuda"),
                              chain_transpose_tables(lay, "cuda"))
        y.backward(arrs[2])
        torch.cuda.synchronize()
        # the forward and dX on chainmm_rhs's tensor-core body, dW on
        # chain_sddmm_rhs's
        assert (chainmm_rhs.launches_mma - before[0],
                chain_sddmm_rhs.launches_mma - before[1]) == (2, 1)
        xd, wd = (a.float().requires_grad_() for a in arrs[:2])
        yd = xd @ chain_unpack_dense(lay, wd).T
        yd.backward(arrs[2].float())
        for name, a, b_ in (("y", y, yd), ("dx", x.grad, xd.grad),
                            ("dw", w.grad, wd.grad)):
            assert a.dtype == dt
            assert_close(a, b_, dt, (lay.m, lay.k, name), GRAD_TOL)


# -- the bf16 tensor-core body of chainmm_rhs over row-group classes ---------

@pytest.mark.cuda
def test_cuda_chain_rhs_mma_body_matches_plain_version():
    """bf16 from N = 16 on: the forward on forward tables and dX on
    transposed ones take the tensor-core body, one counted launch (and
    one tensor-core launch) each, agree with the plain version and give
    the same bits on a rerun (no atomics, one order of sums); the FMA body
    on the same operands agrees too."""
    needs_card()
    dt = torch.bfloat16
    g = torch.Generator(device="cuda").manual_seed(19)
    rnd = lambda *shape: torch.randn(*shape, device="cuda",
                                     generator=g).to(dt)
    for lay in mma_chain_cases():
        tt = chain_transpose_tables(lay, "cuda")
        w = rnd(*lay.data_shape)
        for t, wv, attr in ((chain_tables(lay, "cuda"), w, "launches"),
                            (tt.tables, tt.values(w), "launches_dx")):
            for n in MMA_ROWS:
                assert chain_rhs_path(t, n, dt) == "mma"
                x = rnd(n, t.k)
                before = (getattr(chainmm_rhs, attr),
                          chainmm_rhs.launches_mma)
                y = chainmm_rhs(t, x, wv)
                torch.cuda.synchronize()
                assert (getattr(chainmm_rhs, attr),
                        chainmm_rhs.launches_mma) == (before[0] + 1,
                                                      before[1] + 1)
                assert y.dtype == dt and tuple(y.shape) == (n, t.m)
                want = chainmm_rhs_reference(t, x, wv)
                assert_close(y, want, dt, (t.m, t.k, n, attr, "mma"))
                assert torch.equal(y, chainmm_rhs(t, x, wv)), (t.m, n)
                fma = torch.empty_like(y)
                _chain_rhs_body("fma", t, x, wv, fma)
                assert_close(fma, want, dt, (t.m, t.k, n, attr, "fma"))


@pytest.mark.cuda
def test_cuda_chain_rhs_mma_body_rejects_misaligned_operands():
    """The tensor-core body loads 16 bytes at a time: an X whose data
    does not start on 16 bytes is refused, not run on the FMA body; a
    leaf it cannot take (G = C = 1) runs the FMA body."""
    needs_card()
    lay = next(iter(mma_chain_cases()))
    t = chain_tables(lay, "cuda")
    n = 77
    flat = torch.randn(n * lay.k + 1, device="cuda").bfloat16()
    x_off = flat[1:].view(n, lay.k)
    assert x_off.is_contiguous() and x_off.data_ptr() % 16
    w = torch.randn(lay.data_shape, device="cuda").bfloat16()
    with pytest.raises(ValueError):
        chainmm_rhs(t, x_off, w)
    assert torch.isfinite(chainmm_rhs(t, x_off.clone(), w).float()).all()
    small = next(chain_cases())  # G = C = 1
    ts = chain_tables(small, "cuda")
    assert chain_rhs_path(ts, n, torch.bfloat16) == "fma"
    before = chainmm_rhs.launches_mma
    xs = torch.randn(n, small.k, device="cuda").bfloat16()
    ws = torch.randn(small.data_shape, device="cuda").bfloat16()
    assert_close(chainmm_rhs(ts, xs, ws), chainmm_rhs_reference(ts, xs, ws),
                 torch.bfloat16, "small chain")
    assert chainmm_rhs.launches_mma == before


# -- the stacked dW on the tensor-core body -----------------------------------

@pytest.mark.cuda
def test_cuda_stacked_sddmm_mma_body_is_the_unstacked_one():
    """bf16 from 16 rows an expert on, at qwen2-moe's expert layouts (60
    experts) and at few experts of many rows (token slices and their
    workspace): the stacked dW takes the tensor-core body (one counted
    launch, one tensor-core launch), agrees with the plain version, gives
    the same bits on a rerun, and each expert's dW is the bits of the
    unstacked mma launch of the stacked plan on that expert's slice."""
    needs_card()
    dt = torch.bfloat16
    g = torch.Generator(device="cuda").manual_seed(20)
    rnd = lambda *shape: torch.randn(*shape, device="cuda",
                                     generator=g).to(dt)
    cases = [(m, k, 60, n) for m, k in EXPERT_WIDTH for n in (16, 77, 171)]
    cases += [(2048, 1408, 2, 1037), (1408, 2048, 1, 4096)]
    for m, k, e, n in cases:
        tables = KernelTables.build(
            RBGP4Layout(design_rbgp4(m, k, 0.75, seed=0)), "cuda")
        d = tables.dims
        assert sddmm_path(d, n, dt) == "mma"
        gy, x = rnd(e, n, m), rnd(e, n, k)
        before = (rbgp4_sddmm_rhs_stacked.launches,
                  rbgp4_sddmm_rhs_stacked.launches_mma)
        dw = rbgp4_sddmm_rhs_stacked(tables, gy, x)
        torch.cuda.synchronize()
        assert (rbgp4_sddmm_rhs_stacked.launches,
                rbgp4_sddmm_rhs_stacked.launches_mma) == (before[0] + 1,
                                                          before[1] + 1)
        assert_close(dw, rbgp4_sddmm_rhs_stacked_reference(tables, gy, x),
                     dt, (m, k, e, n))
        assert torch.equal(dw, rbgp4_sddmm_rhs_stacked(tables, gy, x))
        plan = stacked_sddmm_mma_plan(d, e, n, _sm_count("cuda"))
        for i in sorted({0, e // 2, e - 1}):
            assert torch.equal(dw[i], body_sddmm("mma", tables, gy[i], x[i],
                                                 plan)), (m, k, e, n, i)


@pytest.mark.cuda
def test_cuda_stacked_sddmm_mma_body_refuses_what_it_cannot_take():
    """Misaligned g or x is refused (ValueError), not run on the FMA
    body; a layout the body cannot take (G = 8) or a plan whose slices
    do not cover the tokens is refused by the launcher (RuntimeError)."""
    needs_card()
    dt = torch.bfloat16
    lay = RBGP4Layout(design_rbgp4(2048, 1408, 0.75, seed=0))
    tables = KernelTables.build(lay, "cuda")
    e, n = 4, 77
    flat = torch.randn(e * n * lay.k + 1, device="cuda").to(dt)
    x_off = flat[1:].view(e, n, lay.k)
    assert x_off.is_contiguous() and x_off.data_ptr() % 16
    gy = torch.randn(e, n, lay.m, device="cuda").to(dt)
    with pytest.raises(ValueError):
        rbgp4_sddmm_rhs_stacked(tables, gy, x_off)
    x = x_off.clone()
    dw = torch.empty((e, *lay.data_shape), dtype=dt, device="cuda")
    plan = stacked_sddmm_mma_plan(tables.dims, e, n, _sm_count("cuda"))
    import dataclasses

    with pytest.raises(RuntimeError):
        _sddmm_stacked_body("mma", tables, gy, x, dw,
                            plan=dataclasses.replace(plan, slice_len=16))
    with pytest.raises(RuntimeError):
        _sddmm_stacked_body("mma", tables, gy, x, dw,
                            plan=dataclasses.replace(plan, stage_tokens=32))
    odd = RBGP4Layout(RBGP4Spec(g_o=(4, 4), g_r=(8, 16), g_i=(2, 2),
                                g_b=(1, 1), sp_o=0.5, sp_i=0.5, seed=7))
    to = KernelTables.build(odd, "cuda")
    assert sddmm_path(to.dims, n, dt) == "fma"
    go, xo = (torch.randn(e, n, s_, device="cuda").to(dt)
              for s_ in (odd.m, odd.k))
    with pytest.raises(RuntimeError):
        _sddmm_stacked_body("mma", to, go, xo,
                            torch.empty((e, *odd.data_shape), dtype=dt,
                                        device="cuda"), plan=plan)
    assert_close(rbgp4_sddmm_rhs_stacked(to, go, xo),
                 rbgp4_sddmm_rhs_stacked_reference(to, go, xo), dt, "odd")


# the feature-major tensor-core bodies: FM_LAYOUTS and 128 x 576, whose
# transposed tables have G = 8 (two slots, as 64 x 576's have one); N at
# the least N they take, and ragged 128-token tiles (1000, 4104)
FM_MMA_LAYOUTS = FM_LAYOUTS + [(128, 576)]
FM_MMA_N = (16, 1000, 4104)


def fm_mma_layouts():
    return [RBGP4Layout(design_rbgp4(m, k, 0.75, seed=0))
            for m, k in FM_MMA_LAYOUTS]


@pytest.mark.cuda
def test_cuda_fm_mma_bodies_match_plain_versions():
    """bf16 ``rbgp4mm`` (forward and transposed tables) and
    ``rbgp4_sddmm`` take the tensor-core bodies where ``fm_path`` /
    ``fm_sddmm_path`` say (every layout here but WRN's C = 2 and its
    transposed G = 2), each launch counted once and once more in
    ``launches_mma``, agree with the plain versions and, for dW, give the
    same bits on a rerun."""
    needs_card()
    from repro_torch.kernels import fm_path, fm_sddmm_path

    dt = torch.bfloat16
    g = torch.Generator(device="cuda").manual_seed(21)
    rnd = lambda *shape: torch.randn(*shape, device="cuda",
                                     generator=g).to(dt)
    n_mma = 0
    for (m, k), lay in zip(FM_MMA_LAYOUTS, fm_mma_layouts()):
        tables = KernelTables.build(lay, "cuda")
        tt = TransposeTables.build(lay, "cuda")
        d, d_t = tables.dims, tt.tables.dims
        w = rnd(*lay.data_shape)
        wt = tt.values(w)
        for n in FM_MMA_N:
            x, gy = rnd(k, n), rnd(m, n)
            mma = (fm_path(d, n, dt) == "mma", fm_path(d_t, n, dt) == "mma",
                   fm_sddmm_path(d, n, dt) == "mma")
            assert mma == (((m, k) != (64, 144)),) * 3, (m, k, n)
            before = (rbgp4mm.launches, rbgp4mm.launches_dx,
                      rbgp4mm.launches_mma, rbgp4_sddmm.launches,
                      rbgp4_sddmm.launches_mma)
            o = rbgp4mm(tables, x, w)
            dx = rbgp4mm(tt.tables, gy, wt)
            dw = rbgp4_sddmm(tables, gy, x)
            torch.cuda.synchronize()
            assert (rbgp4mm.launches, rbgp4mm.launches_dx,
                    rbgp4mm.launches_mma, rbgp4_sddmm.launches,
                    rbgp4_sddmm.launches_mma) == (
                before[0] + 1, before[1] + 1, before[2] + mma[0] + mma[1],
                before[3] + 1, before[4] + mma[2]), (m, k, n)
            n_mma += sum(mma)
            assert_close(o, rbgp4mm_reference(tables, x, w), dt,
                         (m, k, n, "O"))
            assert_close(dx, rbgp4mm_reference(tt.tables, gy, wt), dt,
                         (m, k, n, "dI"))
            assert_close(dw, rbgp4_sddmm_reference(tables, gy, x), dt,
                         (m, k, n, "dW"))
            assert torch.equal(dw, rbgp4_sddmm(tables, gy, x)), (m, k, n)
    assert n_mma == 3 * 3 * len(FM_MMA_N)


# VGG19-CIFAR's seven sparse layouts, at the paper's other Table 1
# sparsities: other G, C and class sizes, so other tiles of fm_mma_tile
FM_VGG19_LAYOUTS = [(64, 576), (128, 576), (128, 1152), (256, 1152),
                    (256, 2304), (512, 2304), (512, 4608)]


@pytest.mark.cuda
@pytest.mark.parametrize("sp", [0.5, 0.875, 0.9375])
def test_cuda_fm_mma_bodies_at_table1_sparsities(sp):
    """bf16 ``rbgp4mm`` (O and dI) and ``rbgp4_sddmm`` on VGG19's seven
    layouts at sparsity ``sp``: each launch takes the body ``fm_path`` /
    ``fm_sddmm_path`` name (counted once, and once more in
    ``launches_mma`` on the tensor-core body), with the tile
    ``fm_mma_tile`` names, and agrees with the plain version; dW gives
    the same bits on a rerun.  At 0.5, 512 x 2304's dI runs 32-row tiles
    of G = 64 row groups over 256 compact columns."""
    needs_card()
    from repro_torch.kernels import fm_path, fm_sddmm_path

    dt = torch.bfloat16
    g = torch.Generator(device="cuda").manual_seed(23)
    rnd = lambda *shape: torch.randn(*shape, device="cuda",
                                     generator=g).to(dt)
    for m, k in FM_VGG19_LAYOUTS:
        lay = RBGP4Layout(design_rbgp4(m, k, sp, seed=0))
        tables = KernelTables.build(lay, "cuda")
        tt = TransposeTables.build(lay, "cuda")
        d, d_t = tables.dims, tt.tables.dims
        w = rnd(*lay.data_shape)
        wt = tt.values(w)
        for n in FM_MMA_N:
            x, gy = rnd(k, n), rnd(m, n)
            mma = (fm_path(d, n, dt) == "mma", fm_path(d_t, n, dt) == "mma",
                   fm_sddmm_path(d, n, dt) == "mma")
            before = (rbgp4mm.launches_mma, rbgp4_sddmm.launches_mma)
            o = rbgp4mm(tables, x, w)
            dx = rbgp4mm(tt.tables, gy, wt)
            dw = rbgp4_sddmm(tables, gy, x)
            torch.cuda.synchronize()
            assert (rbgp4mm.launches_mma, rbgp4_sddmm.launches_mma) == (
                before[0] + mma[0] + mma[1], before[1] + mma[2]), (m, k, n)
            assert_close(o, rbgp4mm_reference(tables, x, w), dt,
                         (sp, m, k, n, "O"))
            assert_close(dx, rbgp4mm_reference(tt.tables, gy, wt), dt,
                         (sp, m, k, n, "dI"))
            assert_close(dw, rbgp4_sddmm_reference(tables, gy, x), dt,
                         (sp, m, k, n, "dW"))
            assert torch.equal(dw, rbgp4_sddmm(tables, gy, x)), (m, k, n)


@pytest.mark.cuda
def test_cuda_fm_mma_tiles_match_plain_versions():
    """Every tile of ``FM_MMA_TILES`` (O at G = 16, dI at G = 8 and 64)
    and every block of ``FM_SDDMM_TILES`` (with its own slice plan) agrees
    with the plain version at a ragged N, and each dW reruns bit-equal:
    the sweep that picks among them times only right answers."""
    needs_card()
    from repro_torch.kernels import (FM_MMA_TILES, FM_SDDMM_TILES,
                                     fm_sddmm_plan)
    from repro_torch.kernels.rbgp4mm import _fm_body, _fm_sddmm_body

    dt = torch.bfloat16
    g = torch.Generator(device="cuda").manual_seed(22)
    rnd = lambda *shape: torch.randn(*shape, device="cuda",
                                     generator=g).to(dt)
    n = 1000
    for m, k in ((64, 576), (512, 4608)):
        lay = RBGP4Layout(design_rbgp4(m, k, 0.75, seed=0))
        tables = KernelTables.build(lay, "cuda")
        tt = TransposeTables.build(lay, "cuda")
        w = rnd(*lay.data_shape)
        wt = tt.values(w)
        x, gy = rnd(k, n), rnd(m, n)
        want = (rbgp4mm_reference(tables, x, w),
                rbgp4mm_reference(tt.tables, gy, wt))
        for tile in FM_MMA_TILES:
            o = torch.empty((m, n), dtype=dt, device="cuda")
            dx = torch.empty((k, n), dtype=dt, device="cuda")
            _fm_body("mma", tables, x, w, o, tile=tile)
            _fm_body("mma", tt.tables, gy, wt, dx, tile=tile)
            assert_close(o, want[0], dt, (m, k, tile, "O"))
            assert_close(dx, want[1], dt, (m, k, tile, "dI"))
        ref = rbgp4_sddmm_reference(tables, gy, x)
        for bc in FM_SDDMM_TILES:
            plan = fm_sddmm_plan(tables.dims, n, _sm_count("cuda"), bc)
            dws = []
            for _ in range(2):
                dw = torch.empty(lay.data_shape, dtype=dt, device="cuda")
                _fm_sddmm_body("mma", tables, gy, x, dw, plan=plan)
                dws.append(dw)
            assert_close(dws[0], ref, dt, (m, k, bc, "dW"))
            assert torch.equal(dws[0], dws[1]), (m, k, bc)


@pytest.mark.cuda
def test_cuda_fm_mma_bodies_refuse_what_they_cannot_take():
    """float32, N not a multiple of 8, C = 2 (WRN-40-4's forward tables)
    and its transposed G = 2, a tile or plan the body has no template or
    slices for: the launcher refuses (RuntimeError), nothing runs on the
    other body; a misaligned operand is refused by the wrapper
    (ValueError)."""
    needs_card()
    import dataclasses

    from repro_torch.kernels import fm_sddmm_plan
    from repro_torch.kernels.rbgp4mm import _fm_body, _fm_sddmm_body

    def fm(tables, x, w, n, tile=(16, 4, 1)):
        o = torch.empty((tables.dims.m, n), dtype=x.dtype, device="cuda")
        _fm_body("mma", tables, x, w, o, tile=tile)
        return o

    def sddmm(tables, gy, x, plan):
        dw = torch.empty((tables.dims.m, tables.dims.data_cols),
                         dtype=x.dtype, device="cuda")
        _fm_sddmm_body("mma", tables, gy, x, dw, plan=plan)
        return dw

    lay = RBGP4Layout(design_rbgp4(64, 576, 0.75, seed=0))
    tables = KernelTables.build(lay, "cuda")
    tt = TransposeTables.build(lay, "cuda")
    sms = _sm_count("cuda")
    n = 1000
    for dt in (torch.float32, torch.bfloat16):
        x = torch.randn(lay.k, n, device="cuda").to(dt)
        w = torch.randn(lay.data_shape, device="cuda").to(dt)
        gy = torch.randn(lay.m, n, device="cuda").to(dt)
        plan = fm_sddmm_plan(tables.dims, n, sms)
        if dt == torch.float32:
            with pytest.raises(RuntimeError):
                fm(tables, x, w, n)
            with pytest.raises(RuntimeError):
                sddmm(tables, gy, x, plan)
            continue
        for bad in ((16, 3, 1), (16, 4, 3), (24, 4, 1), (128, 8, 1),
                    (64, 2, 4)):
            with pytest.raises(RuntimeError):
                fm(tables, x, w, n, tile=bad)
        for bad in (dict(block_cols=32), dict(stage_tokens=128),
                    dict(slice_len=plan.slice_len // 2 or 32)):
            with pytest.raises(RuntimeError):
                sddmm(tables, gy, x, dataclasses.replace(plan, **bad))
        # N not a multiple of 8
        x9, g9 = x[:, :999].contiguous(), gy[:, :999].contiguous()
        with pytest.raises(RuntimeError):
            fm(tables, x9, w, 999)
        with pytest.raises(RuntimeError):
            sddmm(tables, g9, x9, fm_sddmm_plan(tables.dims, 999, sms))
        # a misaligned operand
        flat = torch.randn(lay.k * n + 1, device="cuda").to(dt)
        x_off = flat[1:].view(lay.k, n)
        assert x_off.is_contiguous() and x_off.data_ptr() % 16
        with pytest.raises(ValueError):
            rbgp4mm(tables, x_off, w)
        with pytest.raises(ValueError):
            rbgp4_sddmm(tables, gy, x_off)
        # the transposed tables take it, G = 8
        assert_close(fm(tt.tables, gy, tt.values(w), n),
                     rbgp4mm_reference(tt.tables, gy, tt.values(w)), dt,
                     "G = 8")
    wrn = RBGP4Layout(design_rbgp4(64, 144, 0.75, seed=0))
    tw = KernelTables.build(wrn, "cuda")
    ttw = TransposeTables.build(wrn, "cuda")
    dt = torch.bfloat16
    x = torch.randn(wrn.k, n, device="cuda").to(dt)
    w = torch.randn(wrn.data_shape, device="cuda").to(dt)
    gy = torch.randn(wrn.m, n, device="cuda").to(dt)
    with pytest.raises(RuntimeError):
        fm(tw, x, w, n)
    with pytest.raises(RuntimeError):
        fm(ttw.tables, gy, ttw.values(w), n)
    with pytest.raises(RuntimeError):
        sddmm(tw, gy, x, fm_sddmm_plan(tw.dims, n, sms))


# -- the vision models' conv layouts (token-major, batch 256) -----------------

# (m, k) of VGG19-CIFAR's and WRN-40-4's sparse convs at 0.75: C 8 (64 x
# 576, 128 x 576; transposed G 8) and C 2 (64 x 144; transposed G 2) run
# dX and dW (and at C 2 the forward) on the FMA bodies
CONV_LAYOUTS = [(64, 144), (64, 576), (128, 576), (128, 1152), (256, 1152),
                (256, 2304), (512, 2304), (512, 4608)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_vision_conv_layouts_match_plain_versions(dtype):
    """``rbgp4mm_rhs`` (forward and transposed tables) and
    ``rbgp4_sddmm_rhs`` at the vision models' conv layouts, at a ragged N
    and at 64 x 144's and 64 x 576's own N at batch 256 (262144 tokens):
    each agrees with its plain version, moves ``launches_mma`` exactly when
    the path function names the tensor-core body, and dW reruns
    bit-equal."""
    needs_card()
    g = torch.Generator(device="cuda").manual_seed(31)
    rnd = lambda *shape: torch.randn(*shape, device="cuda",
                                     generator=g).to(dtype)
    for m, k in CONV_LAYOUTS:
        lay = RBGP4Layout(design_rbgp4(m, k, 0.75, seed=0))
        tables = KernelTables.build(lay, "cuda")
        tt = TransposeTables.build(lay, "cuda")
        d, d_t = tables.dims, tt.tables.dims
        w = rnd(*lay.data_shape)
        wt = tt.values(w)
        for n in (1037,) + ((262144,) if m == 64 else ()):
            x, gy = rnd(n, k), rnd(n, m)
            mma = (rhs_path(d, n, dtype) == "mma",
                   rhs_path(d_t, n, dtype) == "mma",
                   sddmm_path(d, n, dtype) == "mma")
            fma_k = (m, k) in ((64, 144), (64, 576), (128, 576))
            if dtype == torch.bfloat16:
                assert mma == ((m, k) != (64, 144), not fma_k, not fma_k)
            before = (rbgp4mm_rhs.launches_mma, rbgp4_sddmm_rhs.launches_mma)
            y = rbgp4mm_rhs(tables, x, w)
            dx = rbgp4mm_rhs(tt.tables, gy, wt)
            dw = rbgp4_sddmm_rhs(tables, gy, x)
            torch.cuda.synchronize()
            assert (rbgp4mm_rhs.launches_mma, rbgp4_sddmm_rhs.launches_mma) \
                == (before[0] + mma[0] + mma[1], before[1] + mma[2])
            assert_close(y, rbgp4mm_rhs_reference(tables, x, w), dtype,
                         (m, k, n, "Y"))
            assert_close(dx, rbgp4mm_rhs_reference(tt.tables, gy, wt), dtype,
                         (m, k, n, "dX"))
            assert_close(dw, rbgp4_sddmm_rhs_reference(tables, gy, x), dtype,
                         (m, k, n, "dW"))
            assert torch.equal(dw, rbgp4_sddmm_rhs(tables, gy, x)), (m, k, n)


@pytest.mark.cuda
@pytest.mark.parametrize("pattern", ["rbgp4", "unstructured"])
def test_cuda_vision_vgg19_step_matches_the_cpu(pattern):
    """One training step of full-width VGG19-CIFAR (RBGP4 compact, or the
    unstructured baseline in masked storage) at batch 4 in float32 on the
    card and on the CPU from the same weights: the loss within 1e-4
    relative, and every sparse conv's dW and dX of the card's backward
    within 1e-4 * max|ref| of the CPU's product on the card's own unfolded
    input and output gradient (``chip_smoke.ConvRecorder``)."""
    needs_card()
    import chip_smoke
    from repro_torch.data import GaussianClassImages
    from repro_torch.train import Trainer, classifier_loss

    models = {dev: chip_smoke.vision_model("vgg19-cifar", pattern, dev,
                                           torch.float32)
              for dev in ("cuda", "cpu")}
    models["cpu"].load_state_dict({k: v.cpu() for k, v in
                                   models["cuda"].state_dict().items()})
    data = GaussianClassImages(10, 4, seed=0)
    trainers = {dev: Trainer(m, chip_smoke.vision_train_config(1, lr=0.05),
                             data, checkpoint=False,
                             loss_fn=classifier_loss())
                for dev, m in models.items()}
    rec = chip_smoke.ConvRecorder(models["cuda"])
    card = trainers["cuda"].run(1)[0]["loss"]
    rec.remove()
    worst = chip_smoke.layer_parity(models["cpu"], rec.rec, "test", pattern)
    assert max(worst.values()) <= 1e-4
    cpu = trainers["cpu"].run(1)[0]["loss"]
    assert abs(card - cpu) <= 1e-4 * abs(cpu), (card, cpu)


# one layout per model of the budget plans the plan compiler solves at full
# width (solve_budget(model_matmul_shapes(cfg), target_density=0.25,
# min_dim=64)): tinyllama's wq/wo at 0.5 (G 16, C 128) on every tensor-core
# body, and qwen2-moe's experts.out at 0.875 (C 8; transposed G 8), whose
# stacked dX and dW keep the FMA bodies
PLAN_LAYOUTS = {"tinyllama-wq": (2048, 2048, 0.5, False),
                "qwen2-moe-experts-out": (2048, 1408, 0.875, True)}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", list(PLAN_LAYOUTS))
def test_cuda_plan_layouts_match_plain_versions(name, dtype):
    """The forward, dX (``TransposeTables``) and dW at a budget-plan
    layout against their plain versions (4 experts stacked for the MoE
    layout, 171 rows each; N = 1037 otherwise): ``launches_mma`` moves
    exactly as the path functions name the bodies (in bf16: all three on
    the tensor cores for tinyllama's, the forward alone for the experts'),
    and dW reruns bit-equal."""
    needs_card()
    m, k, sp, stacked = PLAN_LAYOUTS[name]
    lay = RBGP4Layout(design_rbgp4(m, k, sp, seed=0))
    tables = KernelTables.build(lay, "cuda")
    tt = TransposeTables.build(lay, "cuda")
    lead, n = ((4,), 171) if stacked else ((), 1037)
    fwd, dw_fn = ((rbgp4mm_rhs_stacked, rbgp4_sddmm_rhs_stacked) if stacked
                  else (rbgp4mm_rhs, rbgp4_sddmm_rhs))
    fwd_ref, dw_ref = ((rbgp4mm_rhs_stacked_reference,
                        rbgp4_sddmm_rhs_stacked_reference) if stacked
                       else (rbgp4mm_rhs_reference, rbgp4_sddmm_rhs_reference))
    g = torch.Generator(device="cuda").manual_seed(41)
    rnd = lambda *shape: torch.randn(*shape, device="cuda",
                                     generator=g).to(dtype)
    w = rnd(*lead, *lay.data_shape)
    wt = tt.values(w)
    x, gy = rnd(*lead, n, k), rnd(*lead, n, m)
    mma = (rhs_path(tables.dims, n, dtype) == "mma",
           rhs_path(tt.tables.dims, n, dtype) == "mma",
           sddmm_path(tables.dims, n, dtype) == "mma")
    if dtype == torch.bfloat16:
        assert mma == ((True, False, False) if stacked else (True,) * 3)
    else:
        assert mma == (False,) * 3
    before = (fwd.launches_mma, dw_fn.launches_mma)
    y = fwd(tables, x, w)
    dx = fwd(tt.tables, gy, wt)
    dw = dw_fn(tables, gy, x)
    torch.cuda.synchronize()
    assert (fwd.launches_mma, dw_fn.launches_mma) == \
        (before[0] + mma[0] + mma[1], before[1] + mma[2])
    assert_close(y, fwd_ref(tables, x, w), dtype, (name, "Y"))
    assert_close(dx, fwd_ref(tt.tables, gy, wt), dtype, (name, "dX"))
    assert_close(dw, dw_ref(tables, gy, x), dtype, (name, "dW"))
    assert torch.equal(dw, dw_fn(tables, gy, x)), name
