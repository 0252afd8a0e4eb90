"""The port's receive-datapath kernels (pool scan, bitmap pack / OR /
popcount, chunk reassembly) against the JAX package, on the CPU: each plain
version against the Pallas kernel in interpret mode and against the numpy
twin or pure-jnp oracle, on the same numpy inputs, exactly (f64 for the
pool). The CUDA kernels are held against these plain versions on the card
(``tests/test_torch_gpu.py``, ``chip_smoke.py``).
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_support import run_reference

from repro.kernels import bitmap as ref_bitmap
from repro.kernels import ops as ref_ops
from repro.kernels import ref as ref_oracle
from repro.kernels.bitmap_np import (bitmap_pack_np, bitmap_pack_rows_np, bitmap_popcount_np,
                                     bitmap_popcount_rows_np, bitmap_unpack_np)
from repro.kernels.pool_np import pool_completion_rows_np
from repro_torch.kernels import bitmap, chunk_reassembly as cr, pool

# ---------------------------------------------------------------- pool scan

# (rows, n, n_workers, service, staging): the sweep of the JAX package's own
# pool test (ragged, aligned, W > n, one element, staging wider than W), then
# ragged +inf-padded rows with tied arrivals
POOL_CFGS = [
    (5, 17, 4, 0.3, 3),
    (8, 32, 8, 1.5, 2),
    (3, 7, 16, 0.01, 1),
    (1, 1, 2, 1.0, 4),
    (13, 40, 5, 0.7, 6),
    (7, 300, 8, 0.25, 10),
    (4, 129, 1, 0.5, 64),
]


def _pool_input(k: int) -> np.ndarray:
    rows, n, _, _, _ = POOL_CFGS[k]
    rng = np.random.default_rng(rows * 1000 + n)
    a = np.sort(rng.uniform(0.0, 10.0, (rows, n)), axis=1)
    if k >= 5:
        a = np.round(a * 4) / 4                      # ties
        for r in range(1, rows, 2):
            a[r, n // (r + 1):] = np.inf             # ragged rows, padded at the end
    return a


@pytest.fixture(scope="module")
def pallas_pool():
    """The Pallas pool kernel in interpret mode, in f64 (x64 on), once for
    every case: in a subprocess, so the global x64 flag stays out of this one."""
    body = f"""
jax.config.update("jax_enable_x64", True)
import jax.numpy as jnp
from repro.kernels import pool
for k, (rows, n, w, s, staging) in enumerate({POOL_CFGS!r}):
    d, m = pool.pool_completion_rows(jnp.asarray(IN[f"a{{k}}"]), w, s, staging, interpret=True)
    OUT[f"d{{k}}"], OUT[f"m{{k}}"] = np.asarray(d), np.asarray(m)
"""
    return run_reference(body, {f"a{k}": _pool_input(k) for k in range(len(POOL_CFGS))},
                         n_devices=1)


@pytest.mark.parametrize("k", range(len(POOL_CFGS)))
def test_pool_plain_matches_pallas_and_numpy_twin(pallas_pool, k):
    """Bitwise in f64: the plain scan and mask equal the Pallas kernel in
    interpret mode and the numpy twin the JAX package's engine runs."""
    _, _, w, s, staging = POOL_CFGS[k]
    a = _pool_input(k)
    done, mask = pool.pool_completion_rows(torch.from_numpy(a), w, s, staging)
    assert done.dtype == torch.float64
    d_np, m_np = pool_completion_rows_np(a, w, s, staging)
    np.testing.assert_array_equal(done.numpy(), d_np)
    np.testing.assert_array_equal(mask.numpy(), m_np)
    assert pallas_pool[f"d{k}"].dtype == np.float64
    np.testing.assert_array_equal(done.numpy(), pallas_pool[f"d{k}"])
    np.testing.assert_array_equal(mask.numpy(), pallas_pool[f"m{k}"])
    np.testing.assert_array_equal(pool.pool_scan_rows(torch.from_numpy(a), w, s).numpy(), d_np)


def test_pool_wrapper_dispatch():
    """CPU tensors run the plain version (no launch); another device raises."""
    a = torch.zeros(2, 8, dtype=torch.float64)
    before = pool.launches
    pool.pool_completion_rows(a, 2, 1.0, 3)
    assert pool.launches == before
    with pytest.raises(ValueError, match="cuda or cpu"):
        pool.pool_completion_rows(a.to("meta"), 2, 1.0, 3)
    with pytest.raises(ValueError, match=r"\(R, n\)"):
        pool.pool_scan_rows(torch.zeros(8, dtype=torch.float64), 2, 1.0)


# csrc/pool.cu's kThreads and kTile; pool.tile_plan mirrors its plan_for
POOL_THREADS, POOL_TILE = pool._THREADS, pool._TILE


def _keep_first(earlier: torch.Tensor, later: torch.Tensor) -> torch.Tensor:
    """pool.cu's max_keep_first: the earlier value on ties, NaN propagated."""
    return torch.where((earlier >= later) | torch.isnan(earlier), earlier, later)


def _pool_kernel_order(a: torch.Tensor, w: int, s: float, staging: int):
    """csrc/pool.cu's order of work, thread by thread as tensors over the
    threads (and rows): each tile copied into its shared-memory slots, the
    (lane, segment) serial maxima, the segment totals scanned in warp
    groups of ``span`` lanes (and over the warps' totals when S > 32)
    seeded with each lane's carry, the second serial pass into the done
    slots, then done and the mask read back element by element (the
    mask's reference from this tile's slots or from done of an earlier
    tile). Unwritten slots hold NaN, so a read of one shows."""
    rows, n = a.shape
    segs, seg_rows, c = pool.tile_plan(w)
    g_rows = seg_rows * segs
    rs = w if segs == 1 else segs * w + (w * (1 - segs)) % 16
    cap, t = POOL_TILE + 256, torch.arange(POOL_THREADS)
    e = torch.arange(c)
    r = e // w
    slot = (r % seg_rows) * rs + (r // seg_rows) * w + e % w
    done = torch.full_like(a, math.nan)
    mask = torch.zeros(a.shape, dtype=torch.bool)
    nan = torch.full((rows, cap), math.nan, dtype=a.dtype)
    carry = torch.full((rows, max(POOL_THREADS, w)), -math.inf, dtype=a.dtype)

    def shifted(x, i):   # a - i * s, i a tensor of row indices (rounded per op)
        return x - i.to(a.dtype) * s

    def finished(m, i):
        return m + (i.to(a.dtype) + 1.0) * s

    for t0 in range(0, n, c):
        i0, nv = t0 // w, min(c, n - t0)
        buf, dbuf = nan.clone(), nan.clone()
        buf[:, slot[:nv]] = a[:, t0:t0 + nv]
        if segs == 1:                       # a thread scans whole lanes
            lanes = torch.arange(w)
            for rr in range(g_rows):
                ok = t0 + rr * w + lanes < n
                sl = rr * rs + lanes
                m = _keep_first(carry[:, :w], shifted(buf[:, sl], torch.tensor(i0 + rr)))
                carry[:, :w] = torch.where(ok, m, carry[:, :w])
                dbuf[:, sl] = torch.where(ok, finished(m, torch.tensor(i0 + rr)), dbuf[:, sl])
        else:
            sw = segs * w
            tt = t[:sw]
            seg, lane_of = tt // w, tt % w
            m = torch.full((rows, sw), -math.inf, dtype=a.dtype)
            for k in range(seg_rows):
                rr = seg * seg_rows + k
                ok = t0 + rr * w + lane_of < n
                m = torch.where(ok, _keep_first(m, shifted(buf[:, k * rs + tt], i0 + rr)), m)
            tot = torch.full((rows, w * (segs + 1)), math.nan, dtype=a.dtype)
            tot[:, lane_of * (segs + 1) + seg] = m
            live = t < sw
            log_s = segs.bit_length() - 1
            ti = ((t >> log_s) * (segs + 1) + (t & (segs - 1))).clamp(max=tot.shape[1] - 1)
            v = torch.where(live, tot[:, ti], -math.inf)
            span, lane, warp = min(segs, 32), t & 31, t >> 5
            gl = lane & (span - 1)
            off = 1
            while off < span:
                o = v[:, (t - off).clamp(min=0)]
                v = torch.where(gl >= off, _keep_first(o, v), v)
                off *= 2
            before = torch.where(gl == 0, -math.inf, v[:, (t - 1).clamp(min=0)])
            if segs > 32:
                wt = v[:, 31::32]
                w0 = warp - ((t & (segs - 1)) >> 5)
                earlier = torch.full_like(v, -math.inf)
                lane_total = torch.full_like(v, -math.inf)
                for h in range(segs >> 5):
                    x = wt[:, (w0 + h).clamp(max=wt.shape[1] - 1)]
                    earlier = torch.where(w0 + h < warp, _keep_first(earlier, x), earlier)
                    lane_total = _keep_first(lane_total, x)
                before = _keep_first(earlier, before)
            else:
                lane_total = v[:, (t & ~(span - 1)) + span - 1]
            cur = carry[:, :POOL_THREADS]
            tot[:, ti[:sw]] = _keep_first(cur, before)[:, :sw]
            carry[:, :POOL_THREADS] = torch.where(live, _keep_first(cur, lane_total), cur)
            m = tot[:, lane_of * (segs + 1) + seg]
            for k in range(seg_rows):
                rr = seg * seg_rows + k
                ok = t0 + rr * w + lane_of < n
                m = torch.where(ok, _keep_first(m, shifted(buf[:, k * rs + tt], i0 + rr)), m)
                dbuf[:, k * rs + tt] = torch.where(ok, finished(m, i0 + rr), dbuf[:, k * rs + tt])
        done[:, t0:t0 + nv] = dbuf[:, slot[:nv]]
        for j in range(nv):
            k = t0 + j - staging
            if k >= 0:
                ref = dbuf[:, slot[k - t0]] if k >= t0 else done[:, k]
                mask[:, t0 + j] = ref > buf[:, slot[j]]
    return done, mask


def _tied_rows(rows: int, n: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    a = np.sort(np.round(rng.uniform(0.0, 10.0, (rows, n)) * 4) / 4, axis=1)   # ties
    if rows > 1:
        a[rows // 2, n // 3:] = np.inf                                        # a ragged row
    return a


@pytest.mark.parametrize("w", [1, 7, 8, 1000, 1024])
def test_pool_kernel_order_matches_plain(w):
    """The kernel's tile order (tiles, (lane, segment) serial maxima, the
    segment scan, the carry across tiles, the shared-memory slots) gives
    the plain scan and mask bitwise, with ties and +inf padding, at the
    tile edges of the kernel's plan and with the mask's reference in this
    tile, an earlier one and none."""
    c = pool.tile_plan(w)[2]
    for n in (1, w + 1, c - 1, c, c + 1, 2 * c + 1):
        a = torch.from_numpy(_tied_rows(3, n, n + w))
        for staging in (0, 3, c + 5, n):
            want = pool.pool_completion_rows_plain(a, w, 0.3, staging)
            got = _pool_kernel_order(a, w, 0.3, staging)
            assert torch.equal(got[0], want[0]), (w, n, staging)
            assert torch.equal(got[1], want[1]), (w, n, staging)


@pytest.mark.parametrize("w", [1, 3, 7, 8, 16, 100, 256, 257, 300, 512, 513, 1000, 1024])
def test_pool_tile_plan_fits_the_kernel(w):
    """pool.tile_plan (the kernel's plan_for): S the largest power of two
    with S * W <= 512, or 1 when W > 256 (a thread then owns one or two
    lanes), whole segments of 4 to 15 rows, tiles of at most 4,096 elements
    whose padded slots fit a 4,352-slot buffer, and every thread's share of
    a tile at most 8 elements."""
    segs, seg_rows, c = pool.tile_plan(w)
    assert segs & (segs - 1) == 0
    if 2 * w > POOL_THREADS:
        assert segs == 1 and w <= 2 * POOL_THREADS
    else:
        assert segs * w <= POOL_THREADS < 2 * segs * w
    assert 4 <= seg_rows <= 15 and c == seg_rows * segs * w <= POOL_TILE
    rs = w if segs == 1 else segs * w + (w * (1 - segs)) % 16
    assert rs % 16 == w % 16 and seg_rows * rs <= POOL_TILE + 256
    assert -(-c // POOL_THREADS) <= POOL_TILE // POOL_THREADS


# ------------------------------------------------------------------ bitmaps


@pytest.mark.parametrize("n", [32 * 8, 32 * 256, 32 * 1024])
def test_bitmap_plain_matches_pallas_and_numpy_twin(n):
    rng = np.random.default_rng(n)
    flags = rng.integers(0, 2, n).astype(np.uint32)
    words = bitmap.bitmap_pack(torch.from_numpy(flags.astype(np.int32)))
    assert words.dtype == torch.uint32
    pallas = np.asarray(ref_bitmap.bitmap_pack(jnp.asarray(flags), interpret=True))
    np.testing.assert_array_equal(words.numpy(), pallas)
    np.testing.assert_array_equal(words.numpy(), bitmap_pack_np(flags))
    np.testing.assert_array_equal(bitmap.bitmap_pack(torch.from_numpy(flags.astype(bool))).numpy(),
                                  pallas)
    total = int(bitmap.bitmap_popcount(words))
    blk = min(1024, n // 32)
    assert total == int(ref_bitmap.bitmap_popcount(jnp.asarray(pallas), block=blk,
                                                   interpret=True))
    assert total == bitmap_popcount_np(pallas) == int(flags.sum())
    np.testing.assert_array_equal(bitmap.bitmap_unpack(words).numpy(), bitmap_unpack_np(pallas))
    np.testing.assert_array_equal(bitmap.bitmap_unpack(words, n - 5).numpy(),
                                  bitmap_unpack_np(pallas, n - 5))


@pytest.mark.parametrize("rows,words", [(1, 1), (3, 7), (16, 512), (2, 4)])
def test_bitmap_rows_and_or_match_numpy_twins(rows, words):
    """Row packs, per-row popcounts and the OR across rows (the aggregated
    NACK) on the exact u32 wire words of the JAX package's packet engine."""
    rng = np.random.default_rng(rows * 100 + words)
    flags = rng.random((rows, words * 32)) < 0.1
    packed = bitmap.bitmap_pack(torch.from_numpy(flags))
    want = bitmap_pack_rows_np(flags)
    np.testing.assert_array_equal(packed.numpy(), want)
    np.testing.assert_array_equal(bitmap.bitmap_popcount_rows(packed).numpy(),
                                  bitmap_popcount_rows_np(want))
    agg = np.bitwise_or.reduce(want, axis=0)
    np.testing.assert_array_equal(bitmap.bitmap_or_rows(packed).numpy(), agg)


def _nonzero_flags(rows: int, n: int, seed: int) -> dict[str, np.ndarray]:
    """The same flag pattern as 0/1 bool, as uint8 of 2 to 255 where set,
    and as int32 of -1 or 1 << 31 (the sign bit alone) where set."""
    rng = np.random.default_rng(seed)
    on = rng.random((rows, n)) < 0.3
    return {"bool": on,
            "uint8": np.where(on, rng.integers(2, 256, (rows, n)), 0).astype(np.uint8),
            "int32": np.where(on, rng.choice(np.array([-1, -(1 << 31)]), (rows, n)),
                              0).astype(np.int32)}


@pytest.mark.parametrize("rows,n", [(1, 32), (3, 16384), (2, 16416)])
def test_bitmap_pack_plain_sets_a_bit_for_any_nonzero_flag(rows, n):
    """The pack's contract is flag != 0: uint8 flags of 2 to 255 and int32
    flags of -1 and 1 << 31 set their bits, as 0/1 flags do, in the words
    of the JAX package's numpy twin for the same pattern."""
    flags = _nonzero_flags(rows, n, rows * n)
    want = bitmap_pack_rows_np(flags["bool"])
    for name, f in flags.items():
        got = bitmap.bitmap_pack(torch.from_numpy(f))
        assert got.dtype == torch.uint32 and got.shape == (rows, n // 32)
        np.testing.assert_array_equal(got.numpy(), want, err_msg=name)


@pytest.mark.parametrize("offset", [1, 4, 8])
def test_bitmap_pack_plain_on_offset_views(offset):
    """A flag view whose storage starts ``offset`` bytes (or elements) into
    its buffer, off the 16-byte boundary the kernel's vector loads need
    (its C entry takes the warp-per-word kernel there), packs the same
    words as a fresh tensor of the same flags."""
    flags = _nonzero_flags(4, 4096, offset)
    for name, f in flags.items():
        base = torch.zeros(f.size + offset, dtype=torch.from_numpy(f).dtype)
        view = base[offset:].view(f.shape)
        view.copy_(torch.from_numpy(f))
        assert view.storage_offset() == offset and view.is_contiguous()
        np.testing.assert_array_equal(bitmap.bitmap_pack(view).numpy(),
                                      bitmap_pack_rows_np(flags["bool"]), err_msg=name)


def test_bitmap_wrappers_check_inputs():
    before = (bitmap.pack_launches, bitmap.or_launches, bitmap.popcount_launches)
    w = bitmap.bitmap_pack(torch.ones(64, dtype=torch.bool))
    bitmap.bitmap_or_rows(w[None])
    bitmap.bitmap_popcount(w)
    assert (bitmap.pack_launches, bitmap.or_launches, bitmap.popcount_launches) == before
    none = bitmap.bitmap_pack(torch.ones((0, 64), dtype=torch.bool))   # no rows: OR is 0
    assert none.shape == (0, 2) and bitmap.bitmap_or_rows(none).tolist() == [0, 0]
    with pytest.raises(ValueError, match="multiple of 32"):
        bitmap.bitmap_pack(torch.ones(33, dtype=torch.bool))
    with pytest.raises(TypeError, match="uint32"):
        bitmap.bitmap_popcount(torch.ones(4, dtype=torch.int32))
    with pytest.raises(ValueError, match="cuda or cpu"):
        bitmap.bitmap_pack(torch.ones(64, dtype=torch.bool, device="meta"))


# ----------------------------------------------------------- reassembly


@pytest.mark.parametrize("cfg", [
    # (n_chunks, chunk, n_staged, n_valid, dtype): the JAX package's cases
    (32, 256, 20, 15, "float32"),
    (64, 128, 64, 64, "float32"),
    (16, 512, 10, 0, "float32"),     # nothing valid
    (32, 256, 20, 20, "bfloat16"),
    (8, 1024, 8, 5, "int32"),
])
def test_reassembly_plain_matches_pallas_and_oracle(cfg):
    n_chunks, chunk, n_staged, n_valid, dtype = cfg
    rng = np.random.default_rng(n_chunks + n_staged)
    if dtype == "int32":
        staging = rng.integers(0, 1000, (n_staged, chunk)).astype(np.int32)
        user = np.zeros((n_chunks, chunk), np.int32) - 1
    else:
        staging = rng.standard_normal((n_staged, chunk)).astype(np.float32)
        user = np.zeros((n_chunks, chunk), np.float32) - 1.0
    psn = rng.permutation(n_chunks)[:n_staged].astype(np.int32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    u1, b1 = ref_ops.reassemble(jnp.asarray(staging, jdt), jnp.asarray(psn),
                                jnp.asarray(user, jdt), n_valid)
    u2, b2 = ref_oracle.chunk_reassembly_ref(jnp.asarray(staging, jdt), jnp.asarray(psn),
                                             jnp.asarray(user, jdt), n_valid)
    ut, bt = cr.chunk_reassembly(torch.from_numpy(staging).to(tdt), torch.from_numpy(psn),
                                 torch.from_numpy(user).to(tdt), n_valid)
    got = ut.float().numpy()
    np.testing.assert_array_equal(got, np.asarray(u1, np.float32))
    np.testing.assert_array_equal(got, np.asarray(u2, np.float32))
    np.testing.assert_array_equal(bt.numpy(), np.asarray(b1))
    np.testing.assert_array_equal(bt.numpy(), np.asarray(b2))


def test_reassembly_duplicates_last_wins():
    """Retransmitted duplicates: the later staged copy wins, untouched chunks
    keep their content, and the user buffer is updated in place."""
    n_chunks, chunk = 16, 128
    rng = np.random.default_rng(5)
    user = rng.standard_normal((n_chunks, chunk)).astype(np.float32)
    staging = rng.standard_normal((6, chunk)).astype(np.float32)
    psn = np.array([3, 9, 3, 0, 9, 12], np.int32)
    u1, b1 = ref_ops.reassemble(jnp.asarray(staging), jnp.asarray(psn), jnp.asarray(user))
    ut = torch.from_numpy(user.copy())
    out, bt = cr.chunk_reassembly(torch.from_numpy(staging), torch.from_numpy(psn), ut)
    assert out is ut
    np.testing.assert_array_equal(out.numpy(), np.asarray(u1))
    np.testing.assert_array_equal(out[1].numpy(), user[1])
    np.testing.assert_array_equal(bt.numpy(), np.asarray(b1))
    assert int(bt.sum()) == 4


def test_reassembly_checks_inputs():
    s, u = torch.zeros(4, 8), torch.zeros(6, 8)
    with pytest.raises(ValueError, match="PSNs"):
        cr.chunk_reassembly(s, torch.tensor([0, 1, 6, 2]), u)
    with pytest.raises(ValueError, match="n_valid"):
        cr.chunk_reassembly(s, torch.tensor([0, 1, 2, 3]), u, 5)
    with pytest.raises(TypeError):
        cr.chunk_reassembly(s, torch.tensor([0, 1, 2, 3]), u.double())
    before = cr.launches
    cr.chunk_reassembly(s, torch.tensor([0, 1, 2, 3]), u)
    assert cr.launches == before


@pytest.mark.parametrize("cfg", [
    # (n_chunks, chunk, n_staged, n_valid, duplicates)
    (32, 256, 20, 15, False),
    (16, 512, 10, 0, False),
    (16, 128, 40, 33, True),
    (64, 128, 64, 64, True),
])
def test_reassembly_int64_psns_match_pallas(cfg):
    """int64 PSNs (what ``randperm`` and the delivery replay's numpy orders
    give, read in place on the card) give the JAX package's result on the
    same values as int32, duplicates included: its oracle's always, its
    Pallas kernel's wherever no entry past n_valid repeats a valid PSN (the
    kernel in interpret mode lets such an entry write back the chunk's
    content from before the call; the oracle and the port drop it)."""
    n_chunks, chunk, n_staged, n_valid, dups = cfg
    rng = np.random.default_rng(n_chunks * 7 + n_staged)
    staging = rng.standard_normal((n_staged, chunk)).astype(np.float32)
    user = rng.standard_normal((n_chunks, chunk)).astype(np.float32)
    psn = (rng.integers(0, n_chunks, n_staged) if dups
           else rng.permutation(n_chunks)[:n_staged]).astype(np.int64)
    args = (jnp.asarray(staging), jnp.asarray(psn.astype(np.int32)), jnp.asarray(user), n_valid)
    want = [ref_oracle.chunk_reassembly_ref(*args)]
    if not np.isin(psn[n_valid:], psn[:n_valid]).any():
        want.append(ref_ops.reassemble(*args))
    assert len(want) == 2 or dups
    for p in (torch.from_numpy(psn), torch.from_numpy(psn.astype(np.int32))):
        ut, bt = cr.chunk_reassembly(torch.from_numpy(staging), p,
                                     torch.from_numpy(user.copy()), n_valid)
        for u1, b1 in want:
            np.testing.assert_array_equal(ut.numpy(), np.asarray(u1))
            np.testing.assert_array_equal(bt.numpy(), np.asarray(b1))


def test_reassembly_host_checks_read_no_values():
    """The checks both paths share read shapes, dtypes and devices only, so
    the card's path runs them without a synchronisation: on meta tensors
    (which hold no values) they pass, and still refuse bad shapes."""
    s, u = torch.empty(4, 8, device="meta"), torch.empty(6, 8, device="meta")
    for dtype in (torch.int32, torch.int64):
        assert cr._check(s, torch.empty(4, dtype=dtype, device="meta"), u, 3) == 3
    with pytest.raises(TypeError, match="int32 or int64"):
        cr._check(s, torch.empty(4, dtype=torch.int16, device="meta"), u, None)
    with pytest.raises(ValueError, match="do not match"):
        cr._check(s, torch.empty(5, dtype=torch.int64, device="meta"), u, None)


# csrc/bitmap.cu's kStripWords: a longer row is summed by several blocks
STRIP_WORDS = 4096


@pytest.mark.parametrize("rows,words", [(1, 1), (1, 512), (5, STRIP_WORDS - 1), (1, STRIP_WORDS),
                                        (1, STRIP_WORDS + 1), (2, 4 * STRIP_WORDS + 3), (3, 0),
                                        (0, 4)])
def test_popcount_plain_across_threshold(rows, words):
    """The plain counts on both sides of the kernel's one-strip rows and on
    empty rows equal the JAX package's numpy twin, per row and in total
    (0-d int64)."""
    rng = np.random.default_rng(rows + words)
    w = rng.integers(0, 1 << 32, (rows, words), dtype=np.uint64).astype(np.uint32)
    t = torch.from_numpy(w.view(np.int32)).view(torch.uint32)
    per_row = bitmap.bitmap_popcount_rows(t)
    assert per_row.dtype == torch.int64 and per_row.shape == (rows,)
    np.testing.assert_array_equal(per_row.numpy(), bitmap_popcount_rows_np(w))
    total = bitmap.bitmap_popcount(t)
    assert total.shape == () and total.dtype == torch.int64
    assert int(total) == int(bitmap_popcount_rows_np(w).sum())
