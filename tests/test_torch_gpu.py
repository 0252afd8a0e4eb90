"""Tests of the port that need a CUDA card and nvcc; they skip without one.
This file imports no jax, so it also runs on a machine that has none:

    PYTHONPATH=src python -m pytest -q tests/test_torch_gpu.py
"""
import pytest
import torch

from repro_torch.core import collectives as C
from repro_torch.kernels import collective_matmul as M
from repro_torch.kernels import ring_allgather as K
from repro_torch.launch.mesh import StackedMesh
from repro_torch.models import layers


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.gpu
@pytest.mark.parametrize("p", [2, 4, 8])
def test_ring_step_kernel_matches_plain(p):
    """The CUDA kernel equals the plain step bitwise and counts its launches."""
    _need_cuda()
    gen = torch.Generator(device="cuda").manual_seed(p)
    for n in (1, 7, 13824, 110595):
        for dtype in (torch.bfloat16, torch.float16, torch.float32):
            for kw in (dict(), dict(direction=-1), dict(split=n // 2),
                       dict(rounds=2, active_round=1)):
                for s in range(p - 1):
                    buf = torch.randn(2, p, p, n, device="cuda", generator=gen).to(dtype)
                    want = K.ring_step_plain(buf.clone(), s, **kw)
                    before = K.launches
                    got = K.ring_step(buf, s, **kw)
                    torch.cuda.synchronize()
                    assert K.launches == before + 1
                    assert torch.equal(got, want), (n, dtype, kw, s)


@pytest.mark.gpu
def test_ring_step_kernel_rejects_other_dtypes():
    _need_cuda()
    with pytest.raises(TypeError):
        K.ring_step(torch.zeros(4, 4, 3, dtype=torch.int32, device="cuda"), 0)


@pytest.mark.gpu
@pytest.mark.parametrize("mode,chains", [("ring", None), ("bidi", None), ("bcast", 2),
                                         ("bcast", 4)])
def test_stacked_allgather_on_cuda_equals_plain(mode, chains):
    _need_cuda()
    mesh = StackedMesh(data=8, model=1)
    for n in (1, 7, 4096):
        x = torch.randn(8, n, device="cuda").to(torch.bfloat16)
        want = C.make_allgather(mesh, "data", "xla")(x)
        assert torch.equal(C.make_allgather(mesh, "data", mode, n_chains=chains)(x), want)


@pytest.mark.gpu
@pytest.mark.parametrize("p", [2, 4, 8])
def test_ring_step_transpose_kernel_matches_plain(p):
    """The transposed step's kernel equals its plain version bitwise (f32,
    bf16 and f16 adds rounded once, in the same order) and counts launches."""
    _need_cuda()
    gen = torch.Generator(device="cuda").manual_seed(p)
    for n in (1, 7, 13824, 110595):
        for dtype in (torch.bfloat16, torch.float16, torch.float32):
            for kw in (dict(), dict(direction=-1), dict(split=n // 2),
                       dict(rounds=2, active_round=1)):
                for s in range(p - 1):
                    buf = torch.randn(2, p, p, n, device="cuda", generator=gen).to(dtype)
                    want = K.ring_step_transpose_plain(buf.clone(), s, **kw)
                    before = K.transpose_launches
                    got = K.ring_step_transpose(buf, s, **kw)
                    torch.cuda.synchronize()
                    assert K.transpose_launches == before + 1
                    assert torch.equal(got, want), (n, dtype, kw, s)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rmkn", [(1, 1, 576, 7), (8, 1, 576, 1536), (8, 33, 576, 192),
                                  (2, 300, 1536, 576), (2, 129, 576, 49152),
                                  (3, 576, 1000, 130)])
def test_matmul_kernel_matches_plain(dtype, rmkn):
    """Tails of every size, and the operands as the training path gives
    them: contiguous, transposed (the backward's W^T and X^T) and the tied
    head's embed^T view. f32 within 1e-5 of max|plain|, bf16 within 1e-2."""
    _need_cuda()
    r, m, k, n = rmkn
    gen = torch.Generator(device="cuda").manual_seed(m + k + n)
    x = torch.randn(r, m, k, device="cuda", generator=gen).to(dtype)
    w = torch.randn(r, k, n, device="cuda", generator=gen).to(dtype)
    xt = torch.randn(r, k, m, device="cuda", generator=gen).to(dtype).transpose(1, 2)
    wt = torch.randn(r, n, k, device="cuda", generator=gen).to(dtype).transpose(1, 2)
    # one element off a 16-byte boundary: the kernel copies element by element
    xo = torch.randn(r * m * k + 1, device="cuda", generator=gen).to(dtype)[1:].view(r, m, k)
    tol = 1e-2 if dtype == torch.bfloat16 else 1e-5
    for a, b in ((x, w), (xt, w), (x, wt), (xt, wt), (xo, w)):
        want = M.matmul_plain(a, b)
        before = M.launches
        got = M.matmul(a, b)
        torch.cuda.synchronize()
        assert M.launches == before + 1 and got.dtype == dtype and got.is_contiguous()
        err = (got.float() - want.float()).abs().max().item()
        assert err <= tol * want.float().abs().max().item(), (rmkn, a.stride(), b.stride(), err)
        assert torch.equal(M.matmul(a, b), got)   # deterministic


@pytest.mark.gpu
@pytest.mark.parametrize("mode,chains", [("ring", None), ("bidi", None), ("bcast", 2)])
def test_stacked_gather_gradient_on_cuda(mode, chains):
    """The gather's backward on the transposed-step kernel: bitwise equal to
    the same backward on the CPU (the same adds in the same order) and
    within f32 rounding of the plain gather's gradient (a sum over ranks)."""
    _need_cuda()
    mesh = StackedMesh(data=8, model=1)
    for n in (7, 4096):
        x = torch.randn(8, n)
        g = torch.randn(8, 8 * n)
        grads = {}
        for dev, m in (("cuda", mode), ("cpu", mode), ("cuda", "xla")):
            xd = x.to(dev).requires_grad_()
            y = C.make_allgather(mesh, "data", m, n_chains=chains)(xd)
            before = K.transpose_launches
            (grads[dev, m],) = torch.autograd.grad(y, xd, g.to(dev))
            if dev == "cuda" and m != "xla":
                assert K.transpose_launches > before
        assert torch.equal(grads["cuda", mode].cpu(), grads["cpu", mode])
        torch.testing.assert_close(grads["cuda", mode], grads["cuda", "xla"],
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.gpu
def test_rank_matmul_backward_on_cuda():
    """Forward and both backward products of a gathered-weight projection
    launch the kernel: three launches, results within f32 rounding of
    autograd through the plain product."""
    _need_cuda()
    gen = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn(8, 2, 64, 576, device="cuda", generator=gen).requires_grad_()
    w = torch.randn(8, 576, 1536, device="cuda", generator=gen).requires_grad_()
    g = torch.randn(8, 2, 64, 1536, device="cuda", generator=gen)
    before = M.launches
    gx, gw = torch.autograd.grad(layers.rank_matmul(x, w), (x, w), g)
    assert M.launches == before + 3
    x2, w2 = x.detach().clone().requires_grad_(), w.detach().clone().requires_grad_()
    y2 = torch.bmm(x2.reshape(8, -1, 576), w2).reshape(8, 2, 64, 1536)
    rx, rw = torch.autograd.grad(y2, (x2, w2), g)
    for got, want in ((gx, rx), (gw, rw)):
        assert (got - want).abs().max().item() <= 1e-5 * want.abs().max().item()
