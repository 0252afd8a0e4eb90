"""The matmul kernel's two bf16 paths (csrc/matmul.cu) and the allgather-matmul
as one launch per group (kernels/collective_matmul.py).

On the CPU: the pure predicate that picks the path (``tma_layout``,
``path``) on contiguous, transposed, expanded and misaligned views; and the
one-launch view construction of the allgather-matmul, whose plain product
equals the ring schedule's plain result bitwise. Tests marked ``gpu`` hold
the wgmma + TMA kernel against the plain product on the card. Their inputs
are small integers, so every f32 sum is exact and each result must equal
the plain product bitwise; the tolerance tests use normal values within
1e-2 of max|plain|. This file imports no jax:

    PYTHONPATH=src python -m pytest -q tests/test_torch_wgmma.py
"""
import pytest
import torch

from repro_torch.kernels import collective_matmul as M
from repro_torch.kernels import ring_allgather as K

BF = torch.bfloat16


def _bf(*shape, gen=None) -> torch.Tensor:
    return torch.randn(*shape, generator=gen).to(BF)


def _off(*shape) -> torch.Tensor:
    """A bf16 view one element (2 bytes) off its buffer's 16-byte start."""
    n = 1
    for d in shape:
        n *= d
    return torch.zeros(n + 1, dtype=BF)[1:].view(*shape)


# --------------------------------------------------------- the predicate

LAYOUTS = {
    # name: (operand, k_dim, (k_major, outer stride, rank stride) or None)
    "A contiguous: K-major": (lambda: _bf(8, 1024, 576), 2, (True, 576, 1024 * 576)),
    "A transposed (X^T): MN-major": (lambda: _bf(8, 1024, 576).transpose(1, 2), 2,
                                     (False, 576, 1024 * 576)),
    "B contiguous (W): MN-major": (lambda: _bf(8, 576, 1536), 1, (False, 1536, 576 * 1536)),
    "B transposed (W^T, embed^T): K-major": (lambda: _bf(8, 49152, 576).transpose(1, 2), 1,
                                             (True, 576, 49152 * 576)),
    "B expanded over ranks": (lambda: _bf(576, 192).expand(8, 576, 192), 1, (False, 192, 0)),
    "A expanded over ranks (the allgather-matmul's rows)":
        (lambda: _bf(8 * 128, 576).expand(8, 8 * 128, 576), 2, (True, 576, 0)),
    "one rank": (lambda: _bf(1, 40, 64), 2, (True, 64, 0)),
    "one row (decode, M = 1)": (lambda: _bf(8, 1, 576), 2, (True, 576, 576)),
    "one row, any stride": (lambda: _bf(8, 3, 576)[:, 1:2], 2, (True, 576, 3 * 576)),
    "B K-major with N = 7": (lambda: _bf(2, 7, 64).transpose(1, 2), 1, (True, 64, 7 * 64)),
    "base off 16 bytes": (lambda: _off(8, 32, 64), 2, None),
    "K = 33": (lambda: _bf(8, 4, 33), 2, None),
    "B MN-major with N = 7": (lambda: _bf(8, 64, 7), 1, None),
    "rank stride not a multiple of 16 bytes":
        (lambda: _bf(8 * 516).as_strided((8, 64, 8), (516, 8, 1)), 2, None),
    "a row stride of 0": (lambda: _bf(1, 1, 64).expand(2, 5, 64), 2, None),
    "neither inner dim of unit stride": (lambda: _bf(2, 16, 32)[:, :, ::2], 2, None),
    "f32": (lambda: torch.randn(2, 16, 32), 2, None),
}


@pytest.mark.parametrize("name", list(LAYOUTS))
def test_tma_layout(name):
    """(k_major, outer stride, rank stride) as TMA reads each view, or None
    where TMA cannot describe it."""
    make, k_dim, want = LAYOUTS[name]
    assert M.tma_layout(make(), k_dim) == want


@pytest.mark.parametrize("a,b,want", [
    (lambda: _bf(8, 1024, 576), lambda: _bf(8, 576, 1536), "wgmma"),
    (lambda: _bf(8, 1024, 1536).transpose(1, 2), lambda: _bf(8, 1024, 576), "wgmma"),
    (lambda: _bf(8, 1, 576), lambda: _bf(8, 49152, 576).transpose(1, 2), "wgmma"),
    (lambda: _bf(8, 4, 33), lambda: _bf(8, 33, 64), "wmma"),
    (lambda: _bf(8, 4, 64), lambda: _bf(8, 64, 7), "wmma"),
    (lambda: _off(8, 32, 64), lambda: _bf(8, 64, 64), "wmma"),
    (lambda: _bf(8, 32, 64), lambda: _off(8, 64, 64), "wmma"),
    (lambda: torch.randn(8, 32, 64), lambda: torch.randn(8, 64, 64), "f32"),
])
def test_path_picks_the_kernel(a, b, want):
    assert M.path(a(), b()) == want


# ------------------------------------------- the allgather-matmul's views


@pytest.mark.parametrize("dtype", [torch.float32, BF])
@pytest.mark.parametrize("lead", [(), (2,), (2, 3)])
@pytest.mark.parametrize("p", [3, 4, 8])
def test_one_launch_equals_ring_schedule(p, lead, dtype):
    """The one-launch construction (every rank's A the group's P m rows at a
    rank stride of 0) with the plain product equals the ring schedule's
    plain result bitwise, with and without leading groups; one product per
    group, each on views of x and w, not copies."""
    gen = torch.Generator().manual_seed(p + len(lead))
    m, k, n = 5, 24, 40
    x = torch.randn(*lead, p, m, k, generator=gen).to(dtype)
    w = torch.randn(k, n, generator=gen).to(dtype)
    calls = []

    def mm(a, b, *, out):
        calls.append((a.shape, a.stride()[0], b.stride()[0], a.data_ptr(), b.data_ptr()))
        return M.matmul_plain(a, b, out=out)

    got = M._one_launch(x, w, mm)
    want = M._allgather_matmul(x, w, M.matmul_plain)
    assert got.shape == (*lead, p, p * m, n)
    assert torch.equal(got, want)
    groups = 1
    for d in lead:
        groups *= d
    assert len(calls) == groups
    group_bytes = p * m * k * x.element_size()
    for g, (shape, a_rank, b_rank, a_ptr, b_ptr) in enumerate(calls):
        assert (shape, a_rank, b_rank) == ((p, p * m, k), 0, 0)
        assert (a_ptr, b_ptr) == (x.data_ptr() + g * group_bytes, w.data_ptr())


def test_allgather_matmul_on_cpu_runs_the_ring_schedule():
    """On a CPU tensor the ring schedule runs (P - 1 plain ring steps), not
    the one launch, and no kernel counter moves."""
    x, w = torch.randn(4, 3, 16), torch.randn(16, 8)
    before = (K.launches, M.launches, M.launches_wmma, M.launches_f32, M.allgather_launches)
    got = M.allgather_matmul_local(x, w, bm=1, bk=1, bn=1)
    assert torch.equal(got, M._allgather_matmul(x, w, M.matmul_plain))
    assert (K.launches, M.launches, M.launches_wmma, M.launches_f32,
            M.allgather_launches) == before


# ------------------------------------------------------------ on the card


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def _ints(*shape, gen) -> torch.Tensor:
    """Integers in [-2, 2] as bf16 on the card: every f32 sum is exact."""
    return torch.randint(-2, 3, shape, generator=gen, device="cuda").to(BF)


def _operand(r, rows, cols, transposed, gen) -> torch.Tensor:
    if transposed:
        return _ints(r, cols, rows, gen=gen).transpose(1, 2)
    return _ints(r, rows, cols, gen=gen)


def _exact(a, b, out=None, kind="wgmma"):
    """One launch on ``kind``'s path, equal to the plain product bitwise."""
    assert M.path(a, b) == kind
    counters = ("launches", "launches_wmma", "launches_f32")
    before = [getattr(M, c) for c in counters]
    got = M.matmul(a, b, out=out)
    torch.cuda.synchronize()
    after = [getattr(M, c) for c in counters]
    want = [n + (c == {"wgmma": "launches", "wmma": "launches_wmma"}[kind])
            for n, c in zip(before, counters)]
    assert after == want
    plain = M.matmul_plain(a, b)
    assert torch.equal(got, plain), (got.float() - plain.float()).abs().max().item()
    return got


@pytest.mark.gpu
@pytest.mark.parametrize("a_t", [False, True], ids=["A K-major", "A MN-major"])
@pytest.mark.parametrize("b_t", [False, True], ids=["B MN-major", "B K-major"])
@pytest.mark.parametrize("k", [16, 64, 192])
def test_wgmma_one_tile_each_layout(a_t, b_t, k):
    """One 128 x 192 output tile in each of the four operand layouts: first
    one k step of 16, then one box, then three (the ring of stages)."""
    _need_cuda()
    gen = torch.Generator(device="cuda").manual_seed(k + 2 * a_t + b_t)
    _exact(_operand(1, 128, k, a_t, gen), _operand(1, k, 192, b_t, gen))


@pytest.mark.gpu
@pytest.mark.parametrize("a_t", [False, True], ids=["A K-major", "A MN-major"])
@pytest.mark.parametrize("b_t", [False, True], ids=["B MN-major", "B K-major"])
@pytest.mark.parametrize("rmkn", [(2, 136, 72, 200), (3, 72, 8, 392), (1, 1000, 520, 584),
                                  (8, 1024, 576, 1536), (8, 1024, 576, 192)])
def test_wgmma_ragged_edges(a_t, b_t, rmkn):
    """M, N and K that divide no tile (zero-filled on load, masked on store),
    over ranks, in every layout (a contiguous extent stays a multiple of 8,
    as TMA needs); and two training shapes, the second with fewer 128 x 192
    tiles (64) than the card has SMs."""
    _need_cuda()
    r, m, k, n = rmkn
    gen = torch.Generator(device="cuda").manual_seed(m + k + n)
    _exact(_operand(r, m, k, a_t, gen), _operand(r, k, n, b_t, gen))


@pytest.mark.gpu
def test_wgmma_odd_outer_extents():
    """Extents that are no multiple of 8 where they are not contiguous: M = 65
    rows of a K-major A, N = 7 columns of a K-major B."""
    _need_cuda()
    gen = torch.Generator(device="cuda").manual_seed(4)
    _exact(_operand(2, 65, 72, False, gen), _operand(2, 72, 7, True, gen))
    _exact(_operand(3, 1, 64, False, gen), _operand(3, 64, 193, True, gen))


@pytest.mark.gpu
def test_wgmma_long_k_and_single_rows():
    """The head's products: dY . embed (K = 49152, no split-K), x . embed^T
    at M = 1 per rank (prefill's head and decode), and x^T . dY (N = 49152)."""
    _need_cuda()
    gen = torch.Generator(device="cuda").manual_seed(5)
    emb = _ints(2, 49152, 576, gen=gen)
    _exact(_ints(2, 200, 49152, gen=gen), emb)
    _exact(_ints(8, 1, 576, gen=gen), _ints(8, 49152, 576, gen=gen).transpose(1, 2))
    _exact(_ints(2, 300, 576, gen=gen).transpose(1, 2), _ints(2, 300, 49152, gen=gen))


@pytest.mark.gpu
def test_wgmma_reads_expanded_operands():
    """A rank stride of 0 (a replicated weight; the allgather-matmul's rows)
    reads one matrix for every rank."""
    _need_cuda()
    gen = torch.Generator(device="cuda").manual_seed(6)
    x = _ints(1024, 576, gen=gen).expand(8, 1024, 576)
    w = _ints(576, 192, gen=gen).expand(8, 576, 192)
    got = _exact(x, w)
    assert all(torch.equal(got[r], got[0]) for r in range(8))
    _exact(_ints(8, 128, 576, gen=gen), _ints(1536, 576, gen=gen).t().expand(8, 576, 1536))


@pytest.mark.gpu
def test_wgmma_out_views():
    """``out=`` views, through each of the epilogue's stores: a transposed
    output (column stride not 1: element stores), one off a 4-byte boundary
    (element stores), rows 202 elements apart (element pairs: TMA needs
    multiples of 16 bytes), and a slice of a wider output (TMA stores); the
    rest of each output stays as it was."""
    _need_cuda()
    gen = torch.Generator(device="cuda").manual_seed(7)
    a, b = _ints(2, 130, 64, gen=gen), _ints(2, 64, 200, gen=gen)
    outs = [torch.zeros(2, 200, 130, dtype=BF, device="cuda").transpose(1, 2),
            torch.zeros(2 * 130 * 200 + 1, dtype=BF, device="cuda")[1:].view(2, 130, 200),
            torch.zeros(2, 130, 202, dtype=BF, device="cuda")[:, :, :200],
            torch.zeros(2, 130, 456, dtype=BF, device="cuda")[:, :, 256:]]
    for out in outs:
        _exact(a, b, out=out)
    assert not outs[2]._base[:, :, 200:].any()
    assert not outs[3]._base[:, :, :256].any()


@pytest.mark.gpu
def test_wmma_takes_what_tma_cannot():
    """K = 33, N = 7 and a base one element off 16 bytes go to the wmma
    kernel, bitwise on integer inputs."""
    _need_cuda()
    gen = torch.Generator(device="cuda").manual_seed(8)
    _exact(_ints(2, 40, 33, gen=gen), _ints(2, 33, 64, gen=gen), kind="wmma")
    _exact(_ints(2, 40, 64, gen=gen), _ints(2, 64, 7, gen=gen), kind="wmma")
    a = torch.zeros(2 * 40 * 64 + 1, dtype=BF, device="cuda")[1:].view(2, 40, 64)
    a.copy_(_ints(2, 40, 64, gen=gen))
    _exact(a, _ints(2, 64, 64, gen=gen), kind="wmma")


@pytest.mark.gpu
@pytest.mark.parametrize("rmkn", [(8, 1024, 576, 1536), (8, 1, 576, 49152),
                                  (2, 1024, 49152, 576)])
def test_wgmma_within_tolerance_and_deterministic(rmkn):
    """Normal values at the main path's shapes: within 1e-2 of max|plain|
    and the same bits on a second call."""
    _need_cuda()
    r, m, k, n = rmkn
    gen = torch.Generator(device="cuda").manual_seed(9)
    a = torch.randn(r, m, k, generator=gen, device="cuda").to(BF)
    b = torch.randn(r, k, n, generator=gen, device="cuda").to(BF)
    got = M.matmul(a, b)
    plain = M.matmul_plain(a, b)
    err = (got.float() - plain.float()).abs().max().item()
    assert err <= 1e-2 * plain.float().abs().max().item()
    assert torch.equal(M.matmul(a, b), got)
