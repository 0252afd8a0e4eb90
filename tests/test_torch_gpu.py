"""Tests of the port that need a CUDA card and nvcc; they skip without one.
This file imports no jax, so it also runs on a machine that has none:

    PYTHONPATH=src python -m pytest -q tests/test_torch_gpu.py
"""
import pytest
import torch

from repro_torch.core import collectives as C
from repro_torch.kernels import ring_allgather as K
from repro_torch.launch.mesh import StackedMesh


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
