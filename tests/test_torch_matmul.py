"""The port of ``matmul_pallas`` (kernels/collective_matmul.py) against the
JAX package's Pallas kernel, run as its own tests run it on the CPU
(interpret mode), over the sweep of ``tests/test_kernels.py``; and the
autograd Function every gathered-weight product goes through.

Tolerances are the reference's own: atol 2e-3 in f32, 0.5 in bf16 (the
Pallas kernel sums bf16 tiles in another order and rounds once).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.collective_matmul import matmul_pallas
from repro_torch.kernels import collective_matmul as M
from repro_torch.models import layers

SWEEP = [(128, 128, 128), (256, 384, 128), (512, 256, 256), (128, 512, 384)]


def _to_torch(a: np.ndarray, dtype) -> torch.Tensor:
    return torch.from_numpy(a).to({jnp.float32: torch.float32,
                                   jnp.bfloat16: torch.bfloat16}[dtype])


@pytest.mark.parametrize("mkn", SWEEP)
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_matmul_plain_matches_pallas(mkn, dtype):
    m, k, n = mkn
    rng = np.random.default_rng(m + k + n)
    x = rng.standard_normal((m, k)).astype(np.float32)
    w = rng.standard_normal((k, n)).astype(np.float32)
    want = matmul_pallas(jnp.asarray(x, dtype), jnp.asarray(w, dtype), interpret=True)
    got = M.matmul_plain(_to_torch(x, dtype)[None], _to_torch(w, dtype)[None])[0]
    assert got.dtype == _to_torch(x, dtype).dtype
    tol = 0.5 if dtype == jnp.bfloat16 else 2e-3
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), atol=tol)


@pytest.mark.parametrize("tiles", [(128, 128, 128), (64, 128, 128), (128, 64, 64)])
def test_matmul_plain_matches_pallas_tile_sweep(tiles):
    """The reference's tile sweep: its tiles change its sum order, never the
    port's result, which stays within the reference's tolerance of each."""
    bm, bk, bn = tiles
    rng = np.random.default_rng(0)
    x = rng.standard_normal((256, 256)).astype(np.float32)
    w = rng.standard_normal((256, 256)).astype(np.float32)
    want = matmul_pallas(jnp.asarray(x), jnp.asarray(w), bm=bm, bk=bk, bn=bn, interpret=True)
    got = M.matmul_plain(torch.from_numpy(x)[None], torch.from_numpy(w)[None])[0]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-3)


def test_matmul_rounds_once_from_f32():
    """bf16 inputs: the plain version sums in f32 and rounds once, so it
    equals the f32 product of the same values cast to bf16, bitwise; the
    wrapper runs it for CPU tensors and counts no launch."""
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal((3, 40, 576)).astype(np.float32)).bfloat16()
    w = torch.from_numpy(rng.standard_normal((3, 576, 24)).astype(np.float32)).bfloat16()
    want = torch.bmm(x.float(), w.float()).bfloat16()
    before = M.launches
    assert torch.equal(M.matmul(x, w), want)   # a CPU tensor takes the plain version
    assert M.launches == before


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rank_matmul_grads_match_autograd(dtype):
    """rank_matmul's backward (dY W^T and X^T dY on the matmul wrapper, with
    transposed views) against autograd through torch.bmm, at the ranks and
    tails of the training path (K = 576, N = 192 per rank)."""
    gen = torch.Generator().manual_seed(2)
    x = torch.randn(4, 2, 33, 576, generator=gen).to(dtype).requires_grad_()
    w = torch.randn(4, 576, 192, generator=gen).to(dtype).requires_grad_()
    g = torch.randn(4, 2, 33, 192, generator=gen).to(dtype)
    before = M.launches
    y = layers.rank_matmul(x, w)
    gx, gw = torch.autograd.grad(y, (x, w), g)
    assert M.launches == before   # CPU tensors take the plain version
    x32, w32 = x.detach().float().requires_grad_(), w.detach().float().requires_grad_()
    y32 = torch.bmm(x32.reshape(4, -1, 576), w32).reshape(4, 2, 33, 192)
    rx, rw = torch.autograd.grad(y32, (x32, w32), g.float())
    tol = dict(atol=0, rtol=1e-2) if dtype == torch.bfloat16 else dict(atol=1e-4, rtol=1e-5)
    torch.testing.assert_close(y.float(), y32.detach(), **tol)
    torch.testing.assert_close(gx.float(), rx, **tol)
    torch.testing.assert_close(gw.float(), rw, **tol)
    assert gx.dtype == gw.dtype == dtype


def test_matmul_takes_strided_views():
    """The tied head embed^T and the transposes of the backward are views;
    the result equals the product of their contiguous copies."""
    gen = torch.Generator().manual_seed(3)
    emb = torch.randn(2, 300, 64, generator=gen)
    h = torch.randn(2, 17, 64, generator=gen)
    head = emb.transpose(1, 2)
    assert not head.is_contiguous()
    torch.testing.assert_close(M.matmul(h, head), M.matmul(h, head.contiguous()),
                               rtol=0, atol=0)


@pytest.mark.parametrize("bad", [
    (torch.zeros(2, 3, 4), torch.zeros(2, 5, 6)),                       # k mismatch
    (torch.zeros(2, 3, 4), torch.zeros(3, 4, 6)),                       # rank mismatch
    (torch.zeros(3, 4), torch.zeros(4, 6)),                             # not 3-D
    (torch.zeros(2, 3, 4), torch.zeros(2, 4, 6, dtype=torch.bfloat16)),  # dtypes differ
    (torch.zeros(2, 3, 4, dtype=torch.float16), torch.zeros(2, 4, 6, dtype=torch.float16)),
    (torch.zeros(2, 0, 4), torch.zeros(2, 4, 6)),                       # empty
])
def test_matmul_rejects_what_the_kernel_does_not_take(bad):
    with pytest.raises((TypeError, ValueError)):
        M.matmul(*bad)
