"""The double-buffered drain of the PyTorch port
(``kernels/ring_allgather.local_double_buffer_drain``, TPU kernel #2) held
against the JAX package's Pallas kernel, run in interpret mode as its own
test runs it (tests/test_ring_ag_kernel.py:58-63). The drain is an
identity copy, so every comparison is bitwise."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ring_allgather import local_double_buffer_drain as ref_drain
from repro_torch.kernels import ring_allgather as K

# the reference test's shapes, then two odd ones
SHAPES = [(6, 8, 128), (3, 16, 64), (5, 7, 33), (1, 3, 1)]


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int32"])
def test_drain_matches_pallas_interpret(shape, dtype):
    rng = np.random.default_rng(sum(shape))
    staged = (rng.standard_normal(shape) * 100).astype(np.float32)
    want = np.asarray(ref_drain(jnp.asarray(staged, dtype), interpret=True).astype(jnp.float32))
    t = torch.from_numpy(staged).to(getattr(torch, dtype))
    before = K.drain_launches
    got = K.local_double_buffer_drain(t)
    assert K.drain_launches == before   # a CPU tensor takes the plain version
    assert got.dtype == t.dtype and got.shape == t.shape
    assert got.data_ptr() != t.data_ptr()
    np.testing.assert_array_equal(got.float().numpy(), want)
    assert torch.equal(got, t)


def test_drain_plain_copies_step_by_step():
    """Every byte of an unaligned uint8 view comes through, and the result
    is a new tensor: writing it leaves the input as it was."""
    base = torch.arange(1 + 4 * 5 * 7, dtype=torch.uint8)
    staged = base[1:].view(4, 5, 7)
    got = K.local_double_buffer_drain_plain(staged)
    assert torch.equal(got, staged)
    got.zero_()
    assert torch.equal(staged, base[1:].view(4, 5, 7))


@pytest.mark.parametrize("bad", [torch.zeros(4, 5), torch.zeros(4, 5, 6)[:, :, ::2]])
def test_drain_refuses_what_the_kernel_does_not_take(bad):
    with pytest.raises(ValueError):
        K.local_double_buffer_drain(bad)
