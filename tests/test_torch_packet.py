"""The port's packet-level reliable Broadcast against the JAX package's, on
the CPU: the same arguments and the same numpy generator seed go into both
``simulate_packet_broadcast``s, and every field of the result must be
equal exactly: completion times, phases, counters, every RoundTrace and
every leaf's staging-ring delivery order. The dataclasses of the two
packages are built from the same numbers.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.core import engine as ref_engine
from repro.core import packet as ref_packet
from repro.core import protocol as ref_protocol
from repro_torch.core import engine, packet, protocol
from repro_torch.kernels import bitmap

FAB = dict(jitter=0.0)
FABJ = dict()                      # default jitter 1e-6
WK = dict(n_recv_workers=8)        # pool rate > wire rate: no RNR
WK1 = dict()                       # 1 worker: RNR-prone
GE = ("ge", 0.01, 8.0)             # GilbertElliottLoss.from_rate(0.01, mean_burst=8)


def _loss(spec, mod):
    return mod.GilbertElliottLoss.from_rate(spec[1], mean_burst=spec[2]) \
        if isinstance(spec, tuple) else spec


def run_both(p, n, fab, wk, seed, loss=None, **kw):
    """(port, reference) results, and both generators afterwards."""
    rng_t, rng_r = np.random.default_rng(seed), np.random.default_rng(seed)
    got = packet.simulate_packet_broadcast(
        p, n, engine.FabricParams(**fab), engine.WorkerParams(**wk), rng_t,
        loss=_loss(loss, packet), device="cpu", **kw)
    want = ref_packet.simulate_packet_broadcast(
        p, n, ref_engine.FabricParams(**fab), ref_engine.WorkerParams(**wk), rng_r,
        loss=_loss(loss, ref_packet), **kw)
    return got, want, rng_t, rng_r


def assert_bcast_equal(a, b, ctx=""):
    """Every observable of PacketBcastResult, exactly (the reference's
    ``assert_bcast_equal``, across the two packages' dataclasses)."""
    np.testing.assert_array_equal(a.completion, b.completion, err_msg=ctx)
    assert dataclasses.astuple(a.phases) == dataclasses.astuple(b.phases), ctx
    for name in ("delivered_fast", "recovered", "rnr_drops", "bytes_fast", "bytes_recovery",
                 "bytes_total", "retransmit_wire_bytes", "duplicates", "completed",
                 "link_bytes"):
        assert getattr(a, name) == getattr(b, name), (ctx, name)
    assert [dataclasses.astuple(t) for t in a.rounds] == \
        [dataclasses.astuple(t) for t in b.rounds], ctx
    assert sorted(a.delivery_order) == sorted(b.delivery_order), ctx
    for leaf in a.delivery_order:
        np.testing.assert_array_equal(a.delivery_order[leaf], b.delivery_order[leaf],
                                      err_msg=f"{ctx} leaf={leaf}")


# the abstract-fabric rows of the JAX package's BCAST_GRID
# (tests/test_packet_vectorized.py: routed=False)
BCAST_GRID = [
    # (p, n_bytes, fab, wk, loss, seed)
    (4, 1 << 16, FAB, WK, None, 0),
    (4, 1 << 16, FABJ, WK, 0.02, 1),
    (16, 1 << 18, FAB, WK, 0.01, 0),
    (16, 1 << 18, FABJ, WK, None, 2),
    (16, 1 << 18, FABJ, WK1, 0.01, 3),       # RNR + loss + jitter
    (16, 1 << 18, FAB, WK, GE, 0),           # bursty chains
    (64, 1 << 18, FABJ, WK1, GE, 4),
    (512, 1 << 18, FAB, WK, 0.002, 0),
]


@pytest.mark.parametrize("p,n,fab,wk,loss,seed", BCAST_GRID)
def test_broadcast_matches_reference(p, n, fab, wk, loss, seed):
    got, want, rng_t, rng_r = run_both(p, n, fab, wk, seed, loss, collect_delivery=True)
    assert_bcast_equal(got, want, ctx=f"p={p} loss={loss}")
    assert rng_t.random() == rng_r.random()     # the generators end in one state


def test_broadcast_unaggregated_nacks_match():
    for seed in (0, 1):
        got, want, _, _ = run_both(16, 1 << 18, FABJ, WK, seed, 0.02, aggregate_nacks=False,
                                   collect_delivery=True)
        assert len(got.rounds) and got.rounds[0].root_nack_msgs > 1
        assert_bcast_equal(got, want, ctx=f"noagg seed={seed}")


def test_broadcast_heavy_loss_multi_round_matches():
    got, want, _, _ = run_both(32, 1 << 18, FABJ, WK1, 5, 0.2, collect_delivery=True)
    assert len(got.rounds) >= 2
    assert_bcast_equal(got, want, ctx="heavy loss")


@pytest.mark.parametrize("fab,loss", [(FABJ, 0.05), (FAB, None), (FAB, GE)])
def test_broadcast_staging_ring_overflow_matches(fab, loss):
    """A 64-chunk staging ring behind a 1-worker pool overflows on a
    200-chunk buffer: RNR drops join the missing sets and are recovered."""
    got, want, _, _ = run_both(8, 200 * 4096, fab, dict(staging_chunks=64), 3, loss,
                               collect_delivery=True)
    assert got.rnr_drops > 0 and got.completed
    assert_bcast_equal(got, want, ctx=f"rnr loss={loss}")


def test_broadcast_512_host_anchor_matches():
    got, want, _, _ = run_both(512, 1 << 22, FAB, WK, 0, 0.001)
    assert got.completed
    assert_bcast_equal(got, want, ctx="512-host anchor")


def test_broadcast_max_rounds_and_root_match():
    """A round cap leaves leaves incomplete; a root other than 0 serves the rest."""
    got, want, _, _ = run_both(16, 1 << 18, FABJ, WK1, 5, 0.3, max_rounds=1,
                               collect_delivery=True)
    assert not got.completed
    assert_bcast_equal(got, want, ctx="max_rounds=1")
    got, want, _, _ = run_both(9, 1 << 16, FABJ, WK, 7, 0.05, root=4, collect_delivery=True)
    assert_bcast_equal(got, want, ctx="root=4")


@pytest.mark.parametrize("p,n_bytes,seed", [(2, 1 << 20, 0), (16, 1 << 18, 3), (64, 3 << 20, 1)])
def test_broadcast_time_matches_reference(p, n_bytes, seed):
    assert protocol.broadcast_time(p, n_bytes, seed=seed, device="cpu") == \
        ref_protocol.broadcast_time(p, n_bytes, seed=seed)
    assert protocol.broadcast_time(p, n_bytes, seed=seed, loss=0.01, device="cpu") == \
        ref_protocol.broadcast_time(p, n_bytes, seed=seed, loss=0.01)


def test_delivery_replays_through_reassembly():
    """The JAX package's replay (tests/test_packet.py): a lossy run's
    staging order, scattered by the port's reassembly
    (``protocol.reassemble``), rebuilds the root's buffer with a complete
    bitmap, at every leaf."""
    mtu = 128
    fab = dict(jitter=0.0, mtu=mtu)
    got, want, _, _ = run_both(8, 64 * mtu, fab, WK, 11, 0.05, collect_delivery=True)
    assert got.completed and got.recovered > 0
    assert_bcast_equal(got, want, ctx="replay")
    buf = np.arange(64 * mtu, dtype=np.uint8).tobytes()
    src = protocol.segment(buf, mtu)
    assert len(ref_protocol.segment(buf, mtu)) == src.shape[0] == 64
    for leaf, order in got.delivery_order.items():
        assert sorted(order.tolist()) == list(range(64))     # exactly once
        user, flags = protocol.reassemble(got, src, leaf)
        assert torch.equal(user, src)
        assert int(bitmap.bitmap_popcount(bitmap.bitmap_pack(flags))) == 64


def test_reassemble_replays_one_leaf_into_a_given_buffer():
    """``reassemble`` writes into the buffer it is given, leaves the chunks
    a leaf never received as they were, and needs a collected delivery."""
    mtu = 64
    got, _, _, _ = run_both(4, 16 * mtu, FAB, WK, 2, 0.2, collect_delivery=True,
                            max_rounds=0)
    src = protocol.segment(np.arange(16 * mtu, dtype=np.uint8).tobytes(), mtu)
    for leaf, order in got.delivery_order.items():
        user = torch.full_like(src, 7)
        out, flags = protocol.reassemble(got, src, leaf, user)
        assert out is user
        want = torch.full_like(src, 7)
        want[torch.from_numpy(order)] = src[torch.from_numpy(order)]
        assert torch.equal(out, want)
        assert flags.view(torch.int32).nonzero()[:, 0].tolist() == sorted(set(order.tolist()))
    assert not got.completed
    lossless, _, _, _ = run_both(4, 16 * mtu, FAB, WK, 2)
    with pytest.raises(ValueError, match="collect_delivery"):
        protocol.reassemble(lossless, src, 1)


def test_segment_and_bitmap_bytes_match_reference():
    buf = bytes(range(256)) * 40 + b"xyz"
    for mtu in (64, 4096):
        rows = protocol.segment(buf, mtu)
        chunks = ref_protocol.segment(buf, mtu)
        assert rows.shape == (len(chunks), mtu) and rows.dtype == torch.uint8
        for c in chunks:
            assert rows[c.psn, :len(c.payload)].numpy().tobytes() == c.payload
        assert protocol.segment(torch.frombuffer(bytearray(buf), dtype=torch.uint8),
                                mtu).equal(rows)
    for n in (0, 1, 4096, 4097, 64 << 20):
        assert protocol.bitmap_bytes(n) == ref_protocol.bitmap_bytes(n)


def test_loss_models_and_flow_times_match_reference():
    """The loss processes draw the same masks from the same seed (GE bursts
    straddling calls), and the fluid flow gives the same chunk times."""
    for make in (lambda m: m.BernoulliLoss(0.1),
                 lambda m: m.GilbertElliottLoss.from_rate(0.05, mean_burst=4.0)):
        a = make(packet).fork(np.random.default_rng(3))
        b = make(ref_packet).fork(np.random.default_rng(3))
        for n in (1, 100, 1000):
            np.testing.assert_array_equal(a.sample(n), b.sample(n))
        assert a.mean_rate == b.mean_rate
    for eng_mod in (engine, ref_engine):
        eng = eng_mod.Engine()
        eng.add_link("l", 25e9)
        flows = [eng.submit("l", 1e6, t_start=1e-5), eng.submit("l", 3e5, t_start=2e-5)]
        eng.run()
        times = [f.chunk_times(100, 1e4) for f in flows]
        if eng_mod is engine:
            mine = times
        else:
            for x, y in zip(mine, times):
                np.testing.assert_array_equal(x, y)


def test_unported_options_raise():
    args = (8, 1 << 16, engine.FabricParams(), engine.WorkerParams(), np.random.default_rng(0))
    for kw in (dict(topology=object()), dict(hosts=list(range(8))),
               dict(dpa_fidelity="event"), dict(engine="reference")):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            packet.simulate_packet_broadcast(*args, device="cpu", **kw)
    with pytest.raises(NotImplementedError):
        protocol.broadcast_time(8, 1 << 16, fidelity="fluid", device="cpu")
    with pytest.raises(NotImplementedError):
        protocol.broadcast_time(8, 1 << 16, dpa=object(), device="cpu")
