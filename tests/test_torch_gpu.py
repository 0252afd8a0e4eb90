"""Tests of the port that need a CUDA card and nvcc; they skip without one.
This file imports no jax, so it also runs on a machine that has none:

    PYTHONPATH=src python -m pytest -q tests/test_torch_gpu.py
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import bridge
from repro_torch.configs import (CollectiveConfig, RunConfig, ShapeConfig, TrainConfig,
                                 get_model_config, reduced)
from repro_torch.core import collectives as C
from repro_torch.core import engine as E
from repro_torch.core import packet as PK
from repro_torch.core import protocol
from repro_torch.kernels import bitmap as BM
from repro_torch.kernels import build
from repro_torch.kernels import chunk_reassembly as CR
from repro_torch.kernels import collective_matmul as M
from repro_torch.kernels import pool as PL
from repro_torch.kernels import ring_allgather as K
from repro_torch.data.pipeline import SyntheticPipeline
from repro_torch.launch.mesh import StackedMesh
from repro_torch.models import layers
from repro_torch.runtime.train_loop import init_state, make_train_step
from repro_torch.sharding.ctx import use_ctx
from repro_torch.sharding.fsdp import at_use
from repro_torch.sharding.specs import tree_leaves

# csrc/bitmap.cu's kStripWords: a popcount row of up to this many words is
# one block, which stores its count; a longer one several, which add theirs
POPCOUNT_STRIP_WORDS = 4096


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def _matmul_launches() -> int:
    """Launches of the matmul kernels, every path (wgmma, wmma, f32)."""
    return M.launches + M.launches_wmma + M.launches_f32


@pytest.mark.gpu
@pytest.mark.parametrize("p", [2, 4, 8])
def test_ring_step_kernel_matches_plain(p):
    """The ring step, one entry of the gather's kernel launched in place,
    equals the plain step bitwise and counts its launches as ring steps."""
    _need_cuda()
    gen = torch.Generator(device="cuda").manual_seed(p)
    for n in (1, 7, 13824, 110595):
        for dtype in (torch.bfloat16, torch.float16, torch.float32):
            for kw in (dict(), dict(direction=-1), dict(split=n // 2),
                       dict(rounds=2, active_round=1)):
                for s in range(p - 1):
                    buf = torch.randn(2, p, p, n, device="cuda", generator=gen).to(dtype)
                    want = K.ring_step_plain(buf.clone(), s, **kw)
                    before = (K.launches, K.allgather_launches)
                    got = K.ring_step(buf, s, **kw)
                    torch.cuda.synchronize()
                    assert (K.launches, K.allgather_launches) == (before[0] + 1, before[1])
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
    """Each gather is one launch of the ring-allgather kernel and no ring
    step, and equals the plain gather."""
    _need_cuda()
    mesh = StackedMesh(data=8, model=1)
    for n in (1, 7, 4096):
        x = torch.randn(8, n, device="cuda").to(torch.bfloat16)
        want = C.make_allgather(mesh, "data", "xla")(x)
        before = (K.allgather_launches, K.launches)
        got = C.make_allgather(mesh, "data", mode, n_chains=chains)(x)
        assert (K.allgather_launches - before[0], K.launches - before[1]) == (1, 0)
        assert torch.equal(got, want)


def _mixed_schedule(n: int) -> tuple:
    """Entries of every kind in no schedule's order, at P = 8: whole slots,
    splits at 0, inside and at n, both directions, round masks."""
    return ((0, 1, None, 1, 0), (1, 1, n // 3, 1, 0), (2, -1, 0, 1, 0), (0, -1, n, 2, 1),
            (3, 1, n // 2, 4, 3), (6, -1, min(1, n), 1, 0), (5, 1, n, 8, 5))


PREFIX_SCHEDULES = ([("ring", p, None) for p in (2, 3, 5, 8, 33)]
                    + [("ring-", p, None) for p in (2, 3, 5, 8)]
                    + [("bidi", p, None) for p in (2, 3, 5, 8, 33)]
                    + [("bcast", 8, m) for m in (1, 2, 4)] + [("mixed", 8, None)]
                    + [("bcast", 16, 1)])   # 240 entries: two launches


def _prefix_schedule(mode: str, p: int, n: int, chains: int | None) -> tuple:
    return {"ring": lambda: C._ring_schedule(p), "ring-": lambda: C._ring_schedule(p, -1),
            "bidi": lambda: C._bidi_schedule(p, n),
            "bcast": lambda: C._bcast_schedule(p, chains),
            "mixed": lambda: _mixed_schedule(n)}[mode]()


@pytest.mark.gpu
@pytest.mark.parametrize("mode,p,chains", PREFIX_SCHEDULES)
def test_ring_allgather_every_prefix_matches_plain_steps(mode, p, chains):
    """For every prefix length k of a schedule, k = 0 included, one launch
    of the ring-allgather kernel on its first k entries equals the plain
    version: the shards installed on the diagonal, then k plain ring steps,
    on the same buffer, bitwise: every slot, reached or not, on a buffer of
    random values. A copy of every shard out of the diagonal fails at
    k = 1. bf16 and f32; n = 1, odd (element copies), 24 (a 16-byte vector
    that the bidi split cuts) and 41,472 (wq's shard at P = 8); one and
    two groups; P = 33 takes the kernel for more ranks than a warp has
    lanes, and bcast at P = 16 with one chain (240 entries) one launch per
    128 entries. Each call counts its launches and k entries."""
    _need_cuda()
    gen = torch.Generator(device="cuda").manual_seed(p)
    for dtype in (torch.bfloat16, torch.float32):
        for n in (1, 7, 24, 41472):
            sched = _prefix_schedule(mode, p, n, chains)
            for groups in (1, 2):
                x = torch.randn(groups, p, n, device="cuda", generator=gen).to(dtype)
                buf = torch.randn(groups, p, p, n, device="cuda", generator=gen).to(dtype)
                want = buf.clone()
                want.diagonal(dim1=-3, dim2=-2).copy_(x.transpose(-1, -2))
                for k in range(len(sched) + 1):
                    if k:
                        step, direction, split, rounds, active = sched[k - 1]
                        K.ring_step_plain(want, step, direction=direction, split=split,
                                          rounds=rounds, active_round=active)
                    before = (K.allgather_launches, sum(K.entries.values()))
                    got = K.ring_allgather(x, sched[:k], out=buf.clone())
                    torch.cuda.synchronize()
                    assert (K.allgather_launches - before[0],
                            sum(K.entries.values()) - before[1]) == (max(1, -(-k // 128)), k)
                    assert torch.equal(got, want), (mode, p, chains, dtype, n, groups, k)


@pytest.mark.gpu
@pytest.mark.parametrize("mode,p,chains", PREFIX_SCHEDULES)
def test_ring_allgather_transpose_every_prefix_matches_plain(mode, p, chains):
    """For every prefix length k of a schedule, k = 0 included, the
    transpose kernel on its first k entries equals the plain version (a
    copy of the cotangent, the plain transposed steps in reverse order, the
    diagonal) bitwise: bf16 and f32, and f16 at n = 24; n = 1, odd, 24 (a
    16-byte vector that the bidi split cuts) and 41,472 (wq's shard at P =
    8); one group, and two as a non-contiguous view. P = 33 and the mixed
    schedule take the in-place launches, bcast at P = 16 (240 entries) one
    launch per 128. Each call counts max(1, ceil(k / 128)) launches and k
    entries, and leaves the cotangent as it was."""
    _need_cuda()
    gen = torch.Generator(device="cuda").manual_seed(p + 1)
    for dtype, sizes in ((torch.bfloat16, (1, 7, 24, 41472)), (torch.float32, (1, 7, 24, 41472)),
                         (torch.float16, (24,))):
        for n in sizes:
            sched = _prefix_schedule(mode, p, n, chains)
            for groups in (1, 2):
                g = torch.randn(groups, p, n, p, device="cuda", generator=gen).to(dtype)
                g = g.transpose(-1, -2) if groups == 2 else g.transpose(-1, -2).contiguous()
                kept = g.clone()
                for k in range(len(sched) + 1):
                    want = K.ring_allgather_transpose_plain(g, sched[:k])
                    before = (K.allgather_transpose_launches, sum(K.transpose_entries.values()))
                    got = K.ring_allgather_transpose(g, sched[:k])
                    torch.cuda.synchronize()
                    assert (K.allgather_transpose_launches - before[0],
                            sum(K.transpose_entries.values()) - before[1]) == (
                                max(1, -(-k // 128)), k)
                    assert torch.equal(got, want), (mode, p, chains, dtype, n, groups, k)
                assert torch.equal(g, kept)


@pytest.mark.gpu
def test_ring_allgather_refuses_shards_it_cannot_read():
    """On the card the shards must be contiguous, and ``out`` the shards'
    buffer (..., P, P, n) of their dtype."""
    _need_cuda()
    x = torch.randn(8, 16, device="cuda")
    with pytest.raises(ValueError):
        K.ring_allgather(x[:, ::2], C._ring_schedule(8))
    with pytest.raises(ValueError):
        K.ring_allgather(x, C._ring_schedule(8), out=torch.empty(8, 8, 16, device="cuda",
                                                                 dtype=torch.bfloat16))
    with pytest.raises(ValueError):
        K.ring_allgather(x, C._ring_schedule(8), out=torch.empty(8, 4, 16, device="cuda"))


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
        before = _matmul_launches()
        got = M.matmul(a, b)
        torch.cuda.synchronize()
        assert _matmul_launches() == before + 1 and got.dtype == dtype and got.is_contiguous()
        err = (got.float() - want.float()).abs().max().item()
        assert err <= tol * want.float().abs().max().item(), (rmkn, a.stride(), b.stride(), err)
        assert torch.equal(M.matmul(a, b), got)   # deterministic


@pytest.mark.gpu
@pytest.mark.parametrize("mode,chains", [("ring", None), ("bidi", None), ("bcast", 2)])
def test_stacked_gather_gradient_on_cuda(mode, chains):
    """The gather's backward is one launch of the transpose kernel and no
    transposed step: bitwise equal to the same backward on the CPU (the
    same adds in the same order) and within f32 rounding of the plain
    gather's gradient (a sum over ranks)."""
    _need_cuda()
    mesh = StackedMesh(data=8, model=1)
    for n in (7, 4096):
        x = torch.randn(8, n)
        g = torch.randn(8, 8 * n)
        grads = {}
        for dev, m in (("cuda", mode), ("cpu", mode), ("cuda", "xla")):
            xd = x.to(dev).requires_grad_()
            y = C.make_allgather(mesh, "data", m, n_chains=chains)(xd)
            before = K.allgather_transpose_launches
            (grads[dev, m],) = torch.autograd.grad(y, xd, g.to(dev))
            if dev == "cuda" and m != "xla":
                assert K.allgather_transpose_launches - before == 1
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
    before = _matmul_launches()
    gx, gw = torch.autograd.grad(layers.rank_matmul(x, w), (x, w), g)
    assert _matmul_launches() == before + 3
    x2, w2 = x.detach().clone().requires_grad_(), w.detach().clone().requires_grad_()
    y2 = torch.bmm(x2.reshape(8, -1, 576), w2).reshape(8, 2, 64, 1536)
    rx, rw = torch.autograd.grad(y2, (x2, w2), g)
    for got, want in ((gx, rx), (gw, rw)):
        assert (got - want).abs().max().item() <= 1e-5 * want.abs().max().item()


@pytest.mark.gpu
@pytest.mark.parametrize("w", [1, 7, 8, 16, 1000, 1024])
def test_pool_kernel_matches_plain(w):
    """Bitwise in f64, ragged +inf-padded rows and tied arrivals included,
    at the kernel's tile edges (``tile_plan``) and around W; the mask's
    reference in the same tile, an earlier one and none; one launch per
    call."""
    _need_cuda()
    gen = torch.Generator(device="cuda").manual_seed(w)
    edge = PL.tile_plan(w)[2]
    for rows in (1, 7, 63, 511):
        for n in sorted({1, 31, w - 1, w + 1, 4096, 16384, 16389, edge - 1, edge + 1} - {0}):
            a = torch.rand(rows, n, device="cuda", dtype=torch.float64, generator=gen)
            a = torch.sort(torch.round(a * 40) / 4, dim=1).values
            a[rows // 2, n // 3:] = float("inf")
            for staging in (0, 3, 8192, n + 5):
                want = PL.pool_completion_rows_plain(a, w, 0.3, staging)
                before = PL.launches
                got = PL.pool_completion_rows(a, w, 0.3, staging)
                torch.cuda.synchronize()
                assert PL.launches == before + 1
                assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]), \
                    (rows, n, staging)
            assert torch.equal(PL.pool_scan_rows(a, w, 0.3), want[0])


def _flag_forms(flags: torch.Tensor, gen: torch.Generator) -> list[torch.Tensor]:
    """bool; uint8 of 2 to 255 where set; int32 of -1 or 1 << 31 where set;
    uint8 views 1, 4 and 8 bytes off 16 and an int32 view 4 bytes off."""
    big = torch.randint(2, 256, flags.shape, device="cuda", generator=gen, dtype=torch.uint8)
    sign = torch.randint(0, 2, flags.shape, device="cuda", generator=gen, dtype=torch.int32)
    forms = [flags, torch.where(flags, big, 0),
             torch.where(flags, torch.where(sign == 1, -1, -(1 << 31)), 0).to(torch.int32)]
    for f, offsets in ((forms[1], (1, 4, 8)), (forms[2], (1,))):
        for off in offsets:
            view = torch.empty(f.numel() + off, dtype=f.dtype, device="cuda")[off:].view(f.shape)
            view.copy_(f)
            forms.append(view)
    return forms


@pytest.mark.gpu
def test_bitmap_kernels_match_plain():
    """The pack on every flag form (any non-zero value sets its bit; bases
    off 16 bytes), rows of 32, 16,384 and 16,416 flags and the replay's
    single row; OR and popcount of the packed rows."""
    _need_cuda()
    gen = torch.Generator(device="cuda").manual_seed(0)
    for shape in ((32,), (16384,), (1, 32), (1, 16416), (1, 1 << 20), (5, 4096), (511, 16384),
                  (512, 16416)):
        flags = torch.rand(shape, device="cuda", generator=gen) < 0.2
        for f in _flag_forms(flags, gen):
            assert torch.equal(BM.bitmap_pack(f).view(torch.int32),
                               BM.bitmap_pack_plain(f).view(torch.int32)), (shape, f.dtype)
        if len(shape) == 1:
            continue
        words = BM.bitmap_pack(flags)
        assert torch.equal(BM.bitmap_or_rows(words), BM.bitmap_or_rows_plain(words))
        assert torch.equal(BM.bitmap_popcount_rows(words), BM.bitmap_popcount_rows_plain(words))
        assert int(BM.bitmap_popcount(words)) == int(flags.sum())


@pytest.mark.gpu
def test_bitmap_or_rows_is_one_launch_without_a_sync():
    """The OR of packed rows: one launch a call (0 rows included, which
    stores zeros), no host synchronisation, bitwise equal to the plain
    version on a base off 16 bytes and on word counts off the vector path."""
    _need_cuda()
    gen = torch.Generator(device="cuda").manual_seed(8)
    cases = []
    for rows in (0, 1, 33, 511, 4096):
        for n_words in (3, 512, 513):
            w = torch.randint(-(1 << 31), 1 << 31, (rows, n_words), generator=gen, device="cuda",
                              dtype=torch.int64).to(torch.int32)
            w *= torch.rand((rows, n_words), generator=gen, device="cuda") < 2 / max(rows, 1)
            base = torch.empty(rows * n_words + 1, dtype=torch.int32, device="cuda")
            off = base[1:].view(rows, n_words)
            off.copy_(w)
            cases += [w.view(torch.uint32), off.view(torch.uint32)]
    BM.bitmap_or_rows(cases[0])   # warm-up: the library loaded and bound
    torch.cuda.synchronize()
    before = BM.or_launches
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = [BM.bitmap_or_rows(w) for w in cases]
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert BM.or_launches - before == len(cases)
    for g, w in zip(got, cases):
        assert torch.equal(g.view(torch.int32), BM.bitmap_or_rows_plain(w).view(torch.int32)), \
            (tuple(w.shape), w.storage_offset())


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.uint8, torch.bfloat16, torch.float32, torch.int32])
def test_reassembly_kernel_matches_plain(dtype):
    """Duplicates (the later staged copy wins), n_valid below n_staged and
    0, a 4096-byte chunk (16-byte copies) and an odd width (byte copies),
    int64 and int32 PSNs read in place."""
    _need_cuda()
    gen = torch.Generator(device="cuda").manual_seed(1)
    for chunk in (4096 // torch.empty(0, dtype=dtype).element_size(), 1023):
        for n_staged, n_chunks, n_valid in ((20, 32, 15), (300, 100, 250), (10, 16, 0),
                                            (64, 64, 64)):
            staging = (torch.rand(n_staged, chunk, device="cuda", generator=gen) * 100).to(dtype)
            psn = torch.randint(0, n_chunks, (n_staged,), device="cuda", generator=gen)
            user = (torch.rand(n_chunks, chunk, device="cuda", generator=gen) * 100).to(dtype)
            for p in (psn, psn.to(torch.int32)):
                want = CR.chunk_reassembly_plain(staging, p, user.clone(), n_valid)
                got = CR.chunk_reassembly(staging, p, user.clone(), n_valid)
                torch.cuda.synchronize()
                assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.gpu
def test_reassembly_and_popcount_never_synchronise():
    """Under set_sync_debug_mode("error") any synchronising call raises:
    the reassembly (int64 and int32 PSNs) and the popcount (rows of one
    strip and of several) make none, and still equal their plain versions."""
    _need_cuda()
    gen = torch.Generator(device="cuda").manual_seed(8)
    staging = torch.randint(0, 256, (64, 4096), device="cuda", generator=gen, dtype=torch.uint8)
    psn = torch.randint(0, 32, (64,), device="cuda", generator=gen)
    users = [torch.zeros(32, 4096, device="cuda", dtype=torch.uint8) for _ in range(2)]
    words = [torch.randint(0, 1 << 30, (2, n), device="cuda", generator=gen,
                           dtype=torch.int32).view(torch.uint32)
             for n in (512, POPCOUNT_STRIP_WORDS + 1)]

    def calls():
        out = [CR.chunk_reassembly(staging, p, u, 60)
               for p, u in zip((psn, psn.to(torch.int32)), users)]
        return out + [(BM.bitmap_popcount(w), BM.bitmap_popcount_rows(w)) for w in words]

    calls()   # warm-up: the libraries loaded, the allocator's blocks cached
    for u in users:
        u.zero_()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = calls()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    want = CR.chunk_reassembly_plain(staging, psn, torch.zeros_like(users[0]), 60)
    for g in got[:2]:
        assert torch.equal(g[0], want[0]) and torch.equal(g[1], want[1])
    for (total, rows), w in zip(got[2:], words):
        assert torch.equal(rows, BM.bitmap_popcount_rows_plain(w))
        assert torch.equal(total, BM.bitmap_popcount_plain(w))


_OUT_OF_RANGE = """
import torch
from repro_torch.kernels import chunk_reassembly as CR
staging = torch.ones(4, 64, device="cuda", dtype=torch.uint8)
user = torch.zeros(6, 64, device="cuda", dtype=torch.uint8)
psn = torch.tensor([0, 1, {psn}, 2], device="cuda", dtype=torch.{dtype})
try:
    CR.chunk_reassembly(staging, psn, user)
    torch.cuda.synchronize()
except RuntimeError as e:
    print("CUDA error:", e)
    raise SystemExit(3)
print("no error")
"""


@pytest.mark.gpu
@pytest.mark.parametrize("psn,dtype", [(6, "int64"), (-1, "int32")])
def test_reassembly_out_of_range_psn_is_a_cuda_error(psn, dtype):
    """A PSN outside [0, n_chunks) traps the kernel: the call or the next
    synchronise raises a CUDA error. In a subprocess: a trap poisons the
    process's CUDA context."""
    _need_cuda()
    build.build(("chunk_reassembly",))   # the subprocess loads it, builds nothing
    src = Path(__file__).resolve().parents[1] / "src"
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        [str(src), *filter(None, [os.environ.get("PYTHONPATH")])])}
    run = subprocess.run([sys.executable, "-c", _OUT_OF_RANGE.format(psn=psn, dtype=dtype)],
                         capture_output=True, text=True, env=env, timeout=300)
    assert run.returncode == 3 and "CUDA error" in run.stdout, (run.stdout, run.stderr)


@pytest.mark.gpu
def test_popcount_kernel_matches_plain_across_threshold():
    """Rows on both sides of the one-strip limit (and empty rows), with no
    bit, one bit and random bits set: the stored counts of one-strip rows
    and the added counts of longer ones equal the plain counts, per row and
    in total, one launch a call."""
    _need_cuda()
    gen = torch.Generator(device="cuda").manual_seed(9)
    one = POPCOUNT_STRIP_WORDS
    for rows, n in ((1, one), (1, one + 1), (3, one), (2, one + 1), (4, 1), (2, 0)):
        zero = torch.zeros(rows, n, dtype=torch.int32, device="cuda")
        single = zero.clone()
        if n:
            single[:, -1] = -(1 << 31)   # bit 31 alone
        rand = torch.randint(-(1 << 31), 1 << 31, (rows, n), device="cuda", generator=gen,
                             dtype=torch.int64).to(torch.int32)
        for w in (zero, single, rand):
            words = w.view(torch.uint32)
            before = BM.popcount_launches
            got = (BM.bitmap_popcount_rows(words), BM.bitmap_popcount(words))
            assert BM.popcount_launches == before + 2
            assert got[1].shape == () and got[0].dtype == got[1].dtype == torch.int64
            assert torch.equal(got[0], BM.bitmap_popcount_rows_plain(words))
            assert torch.equal(got[1], BM.bitmap_popcount_plain(words))


@pytest.mark.gpu
@pytest.mark.parametrize("wk,loss", [(dict(n_recv_workers=8), 1e-3), (dict(), "ge")])
def test_packet_broadcast_on_cuda_equals_cpu(wk, loss):
    """The packet broadcast with its datapath on the card equals its CPU run
    field for field, and launches every receive-datapath kernel; every
    leaf's replay on the card rebuilds the root's buffer."""
    _need_cuda()
    out = {}
    before = (PL.launches, BM.pack_launches, BM.or_launches, BM.popcount_launches)
    for dev in ("cpu", "cuda"):
        lm = PK.GilbertElliottLoss.from_rate(0.01, mean_burst=8.0) if loss == "ge" else loss
        out[dev] = PK.simulate_packet_broadcast(64, 8 << 20, E.FabricParams(),
                                                E.WorkerParams(**wk), np.random.default_rng(0),
                                                loss=lm, collect_delivery=True, device=dev)
    a, b = out["cpu"], out["cuda"]
    after = (PL.launches, BM.pack_launches, BM.or_launches, BM.popcount_launches)
    assert all(x > y for x, y in zip(after, before)) and a.rounds
    assert np.array_equal(a.completion, b.completion) and a.phases == b.phases
    assert a.rounds == b.rounds
    for name in ("delivered_fast", "recovered", "rnr_drops", "duplicates", "completed",
                 "retransmit_wire_bytes"):
        assert getattr(a, name) == getattr(b, name), name
    for leaf, order in a.delivery_order.items():
        assert np.array_equal(order, b.delivery_order[leaf])
    src = protocol.segment(torch.randint(0, 256, (8 << 20,), dtype=torch.uint8, device="cuda"))
    before = CR.launches
    for leaf in b.delivery_order:
        user, flags = protocol.reassemble(b, src, leaf)
        assert torch.equal(user, src)
        assert int(BM.bitmap_popcount(BM.bitmap_pack(flags))) == src.shape[0]
    assert CR.launches == before + 2 * len(b.delivery_order)


# ------------------------------------------------ the collective layer


@pytest.mark.gpu
def test_drain_kernel_matches_plain():
    """Bitwise for any dtype: the allgather-matmul's received shards, the
    reference test's shapes, odd shapes, and views that start off a 16-byte
    boundary (byte-wise stores); one launch per call."""
    _need_cuda()
    gen = torch.Generator(device="cuda").manual_seed(0)
    cases = [torch.randn(8, 128, 576, device="cuda", generator=gen).bfloat16(),
             torch.randn(6, 8, 128, device="cuda", generator=gen),
             torch.randn(3, 16, 64, device="cuda", generator=gen),
             torch.randint(0, 256, (5, 7, 33), device="cuda", generator=gen).to(torch.uint8),
             torch.randint(-9, 9, (3, 1, 1), device="cuda", generator=gen).int(),
             torch.randint(0, 256, (1 + 4 * 300 * 77,), device="cuda", generator=gen)
             .to(torch.uint8)[1:].view(4, 300, 77),
             torch.randn(1 + 2 * 64 * 513, device="cuda", generator=gen)
             .bfloat16()[1:].view(2, 64, 513)]
    for staged in cases:
        before = K.drain_launches
        got = K.local_double_buffer_drain(staged)
        torch.cuda.synchronize()
        assert K.drain_launches == before + 1
        assert got.data_ptr() != staged.data_ptr()
        assert torch.equal(got, K.local_double_buffer_drain_plain(staged)), staged.shape


def _gather_then_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    p, m, k = x.shape
    rows = C.plain_allgather_local(x.reshape(p, m * k)).reshape(p, p * m, k)
    return M.matmul(rows, w.expand(p, k, w.shape[1]))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("p,m,k,n", [(8, 16, 64, 32), (8, 128, 576, 192), (8, 3, 33, 7),
                                     (4, 1, 33, 130), (3, 5, 576, 1536)])
def test_allgather_matmul_on_cuda(dtype, p, m, k, n):
    """Bitwise equal to the plain gather then the matmul kernel, within the
    matmul's limits of the plain product; no ring step and one matmul
    launch per call (every rank's product reads the shards in place);
    use_pallas=False launches no matmul."""
    _need_cuda()
    gen = torch.Generator(device="cuda").manual_seed(p + m + k + n)
    x = torch.randn(p, m, k, device="cuda", generator=gen).to(dtype)
    w = torch.randn(k, n, device="cuda", generator=gen).to(dtype)
    before = (K.launches, _matmul_launches(), M.allgather_launches)
    got = M.allgather_matmul_local(x, w, bm=1, bk=1, bn=1)
    torch.cuda.synchronize()
    assert (K.launches - before[0], _matmul_launches() - before[1],
            M.allgather_launches - before[2]) == (0, 1, 1)
    assert torch.equal(got, _gather_then_matmul(x, w))
    before = _matmul_launches()
    plain = M.allgather_matmul_local(x, w, use_pallas=False)
    assert _matmul_launches() == before
    tol = (1e-2 if dtype == torch.bfloat16 else 1e-5) * plain.float().abs().max().item()
    assert (got.float() - plain.float()).abs().max().item() <= tol
    mesh = StackedMesh(pod=2, data=4, model=1)
    if p == 8:
        y = M.make_allgather_matmul(mesh, "data", bm=1, bk=1, bn=1)(x, w)
        for r in range(8):
            assert torch.equal(y[r], _gather_then_matmul(x[r // 4 * 4:r // 4 * 4 + 4], w)[0])


@pytest.mark.gpu
def test_allgather_matmul_back_to_back():
    """50 calls with fresh inputs and no synchronisation between them (the
    caching allocator recycles the inputs' and outputs' memory): every
    result equals its gather-then-matmul."""
    _need_cuda()
    gen = torch.Generator(device="cuda").manual_seed(1)
    w = torch.randn(576, 192, device="cuda", generator=gen).bfloat16()
    inputs, outputs = [], []
    for i in range(50):
        x = torch.randn(8, 128, 576, device="cuda", generator=gen).bfloat16()
        inputs.append(x)
        outputs.append(M.allgather_matmul_local(x, w, bk=64, bn=64))
    torch.cuda.synchronize()
    for x, y in zip(inputs, outputs):
        assert torch.equal(y, _gather_then_matmul(x, w))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_matmul_out_into_diagonal_views(dtype):
    """``out=`` views with a rank stride of (P + 1) rows: each equals the
    product of contiguous copies, and nothing else of the output moves."""
    _need_cuda()
    gen = torch.Generator(device="cuda").manual_seed(2)
    p, m, k, n = 8, 128, 576, 192
    buf = torch.randn(p, p, m, k, device="cuda", generator=gen).to(dtype)
    w = torch.randn(k, n, device="cuda", generator=gen).to(dtype)
    out = torch.zeros(p, p, m, n, device="cuda", dtype=dtype)
    for a, y in zip(M._diagonals(buf, 3), M._diagonals(out, 3)):
        before = _matmul_launches()
        M.matmul(a, w.expand(a.shape[0], k, n), out=y)
        torch.cuda.synchronize()
        assert _matmul_launches() == before + 1
        assert torch.equal(y, M.matmul(a.contiguous(), w.expand(a.shape[0], k, n)))
    for d in range(p):
        for j in range(p):
            if j != (d - 3) % p:
                assert not out[d, j].any()


@pytest.mark.gpu
def test_broadcast_and_concurrent_ag_rs_on_cuda():
    """The broadcast equals root's row everywhere; concurrent AG/RS on two
    streams and on one equals the separate calls bitwise: its gather is one
    ring-allgather launch and no ring step, its reduce-scatter one launch of
    the gather's transpose."""
    _need_cuda()
    mesh = StackedMesh(data=8, model=1)
    gen = torch.Generator(device="cuda").manual_seed(3)
    x = torch.randn(8, 4096, device="cuda", generator=gen)
    for root, chunks in ((0, 8), (7, 64)):
        y = C.make_broadcast(mesh, "data", root=root, n_chunks=chunks)(x)
        assert torch.equal(y, x[root].expand(8, -1))
    ag = torch.randn(8, 1000, device="cuda", generator=gen)
    rs = torch.randn(8, 8 * 1000, device="cuda", generator=gen)
    for overlap in (True, False):
        before = (K.allgather_launches, K.launches, K.allgather_transpose_launches)
        got_ag, got_rs = C._concurrent_ag_rs(ag, rs, overlap=overlap)
        torch.cuda.synchronize()
        after = (K.allgather_launches, K.launches, K.allgather_transpose_launches)
        assert [a - b for a, b in zip(after, before)] == [1, 0, 1]
        assert torch.equal(got_ag, C.ring_allgather_local(ag))
        assert torch.equal(got_rs, C.ring_reduce_scatter_local(rs, direction=-1))
    assert torch.equal(got_rs.cpu(), C.ring_reduce_scatter_local(rs.cpu(), direction=-1))


@pytest.mark.gpu
def test_wrappers_launch_on_the_current_stream():
    """The drain, the ring step, the one-launch gather, its transpose and
    the matmul,
    called under a side stream while the default stream sleeps: each
    result, read on the side stream after synchronising that stream
    alone, equals the plain version. A launch on any other stream would
    still be queued behind the sleep."""
    _need_cuda()
    gen = torch.Generator(device="cuda").manual_seed(5)
    staged = torch.randn(8, 128, 576, device="cuda", generator=gen).bfloat16()
    buf = torch.randn(1, 8, 8, 41472, device="cuda", generator=gen).bfloat16()
    shards = torch.randn(1, 8, 41472, device="cuda", generator=gen).bfloat16()
    x = torch.randn(8, 128, 576, device="cuda", generator=gen).bfloat16()
    w = torch.randn(8, 576, 192, device="cuda", generator=gen).bfloat16()
    sched = C._bidi_schedule(8, 41472)
    calls = {"drain": (lambda: K.local_double_buffer_drain(staged),
                       K.local_double_buffer_drain_plain(staged)),
             "ring_step": (lambda: K.ring_step(buf.clone(), 3, split=100),
                           K.ring_step_plain(buf.clone(), 3, split=100)),
             "ring_allgather": (lambda: K.ring_allgather(shards, sched),
                                K.ring_allgather_plain(shards, sched)),
             "ring_allgather_transpose": (lambda: K.ring_allgather_transpose(buf[0], sched),
                                          K.ring_allgather_transpose_plain(buf[0], sched)),
             "matmul": (lambda: M.matmul(x, w), M.matmul_plain(x, w))}
    side = torch.cuda.Stream()
    for name, (call, want) in calls.items():
        torch.cuda.synchronize()
        torch.cuda._sleep(200_000_000)   # about 0.1 s on the default stream
        with torch.cuda.stream(side):
            got = call()
            side.synchronize()
            if name == "matmul":   # the plain product sums in f32 in another order
                err = (got.float() - want.float()).abs().max().item()
                assert err <= 1e-2 * want.float().abs().max().item(), name
            else:
                assert torch.equal(got, want), name
        torch.cuda.synchronize()


@pytest.mark.gpu
def test_cuda_tensor_never_reaches_a_plain_version(monkeypatch):
    """With every plain version replaced by one that raises, each wrapper
    still runs on CUDA tensors and counts its launch."""
    _need_cuda()

    def refuse(*args, **kwargs):
        raise AssertionError("a CUDA tensor reached a plain version")

    for mod, name in ((K, "ring_step_plain"), (K, "ring_step_transpose_plain"),
                      (K, "ring_allgather_plain"), (K, "ring_allgather_transpose_plain"),
                      (K, "local_double_buffer_drain_plain"),
                      (M, "matmul_plain"), (PL, "pool_scan_rows_plain"),
                      (PL, "pool_completion_rows_plain"), (BM, "bitmap_pack_plain"),
                      (BM, "bitmap_or_rows_plain"), (BM, "bitmap_popcount_rows_plain"),
                      (BM, "bitmap_popcount_plain"), (CR, "chunk_reassembly_plain")):
        monkeypatch.setattr(mod, name, refuse)
    gen = torch.Generator(device="cuda").manual_seed(6)
    buf = torch.randn(8, 8, 64, device="cuda", generator=gen)
    before = (K.launches, K.allgather_launches, K.allgather_transpose_launches,
              K.drain_launches, _matmul_launches(), PL.launches, BM.pack_launches,
              BM.or_launches, BM.popcount_launches, CR.launches)
    K.ring_step(buf, 0)
    K.ring_allgather(buf[0], C._ring_schedule(8))
    K.ring_allgather_transpose(buf, C._ring_schedule(8))
    K.local_double_buffer_drain(buf)
    M.matmul(buf, buf.transpose(1, 2))
    M.matmul(buf.bfloat16(), buf.bfloat16().transpose(1, 2))
    a = torch.sort(torch.rand(3, 64, device="cuda", dtype=torch.float64, generator=gen)).values
    PL.pool_scan_rows(a, 4, 0.3)
    PL.pool_completion_rows(a, 4, 0.3, 8)
    words = BM.bitmap_pack(torch.rand(4, 64, device="cuda", generator=gen) < 0.5)
    BM.bitmap_or_rows(words)
    BM.bitmap_popcount_rows(words)
    BM.bitmap_popcount(words)
    CR.chunk_reassembly(buf[0], torch.arange(8, device="cuda"), torch.zeros_like(buf[0]))
    C.concurrent_ag_rs_local(buf[0], buf[0].repeat(1, 8))   # one gather, one transpose
    BM.bitmap_or_rows(words[:0])                            # no rows: one launch stores zeros
    torch.cuda.synchronize()
    after = (K.launches, K.allgather_launches, K.allgather_transpose_launches,
             K.drain_launches, _matmul_launches(), PL.launches, BM.pack_launches,
             BM.or_launches, BM.popcount_launches, CR.launches)
    assert [a - b for a, b in zip(after, before)] == [1, 2, 2, 1, 2, 2, 1, 2, 2, 2]


@pytest.mark.gpu
@pytest.mark.parametrize("remat", ["none", "full", "dots"])
def test_prefetch_gathers_on_one_side_stream(monkeypatch, remat):
    """With prefetch every gather of a train step, the forward's and a
    checkpoint's recompute, launches on one side stream, never the current
    one, and so does every gather backward: autograd runs a backward op on
    its forward's stream and joins it to the streams around it itself.
    Without prefetch all of them launch on the current stream. The loss and
    every gradient are the same, bitwise, either way."""
    _need_cuda()
    cfg = reduced(get_model_config("smollm-135m"), layers=3)
    shape = ShapeConfig("t", "train", 64, 8)
    mesh = StackedMesh(data=8, model=1)
    tree = bridge.random_params(cfg, 7)
    batch = SyntheticPipeline(cfg, shape, device="cuda").next_batch(0)
    streams = {"gather": [], "transpose": []}

    def on_stream(name, fn):
        def call(*args, **kwargs):
            streams[name].append(torch.cuda.current_stream().cuda_stream)
            return fn(*args, **kwargs)
        return call

    monkeypatch.setattr(C, "ring_allgather", on_stream("gather", C.ring_allgather))
    monkeypatch.setattr(C, "ring_allgather_transpose",
                        on_stream("transpose", C.ring_allgather_transpose))
    out = {}
    for prefetch in (False, True):
        run = RunConfig(model=cfg, shape=shape, train=TrainConfig(remat=remat),
                        collective=CollectiveConfig(fsdp_mode="mcast", prefetch=prefetch))
        api, ctx, _ = make_train_step(run, mesh, device="cuda")
        state = init_state(run, mesh, tree, device="cuda")
        for seen in streams.values():
            seen.clear()
        main = torch.cuda.current_stream().cuda_stream
        with use_ctx(ctx):
            loss, _ = api.loss_fn(at_use(state.params, mesh.n_ranks, ("data",)), batch)
            grads = torch.autograd.grad(loss, [s.local for s in tree_leaves(state.params)])
        torch.cuda.synchronize()
        out[prefetch] = (loss, grads)
        gathers = 7 * (cfg.num_layers + (0 if remat == "none" else
                                         cfg.num_layers - 1 if prefetch else cfg.num_layers))
        assert (len(streams["gather"]), len(streams["transpose"])) == (gathers,
                                                                       7 * cfg.num_layers)
        used = set(streams["gather"]) | set(streams["transpose"])
        if prefetch:
            assert len(used) == 1 and main not in used
        else:
            assert used == {main}
    assert torch.equal(out[True][0], out[False][0])
    for a, b in zip(out[True][1], out[False][1]):
        assert torch.equal(a, b)
