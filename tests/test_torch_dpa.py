"""The port's DPA offload model (``core/dpa.py``), ``workers_from_dpa`` and
the rest of ``core/protocol.py`` against the JAX package's, on the CPU: the
same arguments into both, results exactly equal.

- ``dpa.py``: every function over Table I's transports, 1 to 256 threads,
  Fig. 15's chunk sizes and the 200 Gbit/s and 1.6 Tbit/s links;
- ``engine.workers_from_dpa`` (and its re-export from ``simulator``);
- the §III state machines (``Bitmap``, ``StagingRing``, ``LeafReceiver``,
  ``final_handshake_ok``) under seeded drop, duplicate and reorder patterns:
  user bytes, bitmap words, duplicates, RNR drops and ``fetch_recover``'s
  cost;
- the closed forms, the memory footprint and ``communicators_in_llc`` over
  a grid; ``broadcast_time`` / ``allgather_time`` with ``dpa=``.
"""
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro.core import dpa as ref_dpa
from repro.core import dpa_engine as ref_de
from repro.core import engine as ref_engine
from repro.core import protocol as ref_protocol
from repro.core import simulator as ref_simulator
from repro_torch.core import dpa, dpa_engine, engine, protocol, simulator

TRANSPORTS = ("UD", "UC")
CHUNKS = (64, 4096, 8192, 16384, 32768)
LINKS = (dpa.LINK_200G_BYTES, dpa.LINK_1600G_BYTES)


# ------------------------------------------------------------------- dpa.py


def test_constants_match_reference():
    names = ("GIB", "DPA_CORES", "DPA_THREADS_PER_CORE", "DPA_FREQ_HZ", "DPA_LLC_BYTES",
             "LINK_200G_BYTES", "LINK_1600G_BYTES", "TABLE1", "MT_SCALING_EXP",
             "CORE_CAP_CHUNKS_PER_S", "CPU_CORE_TPUT_GIB", "CPU_FREQ_HZ", "MEM_CONTENTION",
             "LLC_MISS_PENALTY", "REF_CHUNK_BYTES")
    for name in names:
        assert getattr(dpa, name) == getattr(ref_dpa, name), name
    assert dataclasses.astuple(dpa.DpaConfig()) == dataclasses.astuple(ref_dpa.DpaConfig())


@pytest.mark.parametrize("transport", TRANSPORTS)
def test_dpa_model_matches_reference(transport):
    """Every closed form at 1 to 256 threads, each chunk size and link."""
    for fn in ("single_thread_tput", "chunk_rate_per_thread"):
        assert getattr(dpa, fn)(transport) == getattr(ref_dpa, fn)(transport)
    assert dpa.cqe_service_cycles(transport) == ref_dpa.cqe_service_cycles(transport)
    assert dpa.cqe_service_cycles(transport, freq_hz=1e9, ref_chunk=8192) == \
        ref_dpa.cqe_service_cycles(transport, freq_hz=1e9, ref_chunk=8192)
    for t in range(1, 257):
        assert dpa.thread_scaling(t) == ref_dpa.thread_scaling(t)
        for chunk in CHUNKS:
            for link in LINKS:
                a = dpa.DpaConfig(transport, t, chunk, link)
                b = ref_dpa.DpaConfig(transport, t, chunk, link)
                for fn in ("pool_tput", "sustained_tput", "nack_rate", "sustained_chunk_rate"):
                    assert getattr(dpa, fn)(a) == getattr(ref_dpa, fn)(b), (fn, t, chunk, link)
    for chunk in CHUNKS:
        for link in LINKS:
            assert dpa.threads_to_saturate(transport, link, chunk) == \
                ref_dpa.threads_to_saturate(transport, link, chunk)
    for t in (1, 8, 16, 64, 128, 256):
        assert dpa.tbit_feasible(transport, t) == ref_dpa.tbit_feasible(transport, t)


def test_host_cycles_arrival_rate_and_economics_match_reference():
    for path in dpa.CPU_CORE_TPUT_GIB:
        assert dpa.host_cqe_service_cycles(path) == ref_dpa.host_cqe_service_cycles(path)
    for link in LINKS:
        for mtu in (64, 4096, 9000):
            assert dpa.link_chunk_arrival_rate(link, mtu) == \
                ref_dpa.link_chunk_arrival_rate(link, mtu)
    assert dpa.economics_summary() == ref_dpa.economics_summary()
    # the paper's claims the figures assert (benchmarks/paper_figs.py)
    assert dpa.threads_to_saturate("UC") <= 4 and 8 <= dpa.threads_to_saturate("UD") <= 16
    assert dpa.tbit_feasible("UD", 128)
    assert dpa.nack_rate(dpa.DpaConfig("UD", 16)) > 511


@pytest.mark.parametrize("cfg", [("UD", 1), ("UD", 16), ("UC", 4), ("UC", 17), ("UD", 128)])
def test_workers_from_dpa_matches_reference(cfg):
    got = engine.workers_from_dpa(dpa.DpaConfig(*cfg), staging_chunks=1024,
                                  rnr_barrier_hop=2e-6)
    want = ref_engine.workers_from_dpa(ref_dpa.DpaConfig(*cfg), staging_chunks=1024,
                                       rnr_barrier_hop=2e-6)
    assert dataclasses.astuple(got) == dataclasses.astuple(want)
    assert dataclasses.astuple(engine.workers_from_dpa(dpa.DpaConfig(*cfg))) == \
        dataclasses.astuple(ref_engine.workers_from_dpa(ref_dpa.DpaConfig(*cfg)))
    assert simulator.workers_from_dpa is engine.workers_from_dpa
    assert ref_simulator.workers_from_dpa is ref_engine.workers_from_dpa


# ------------------------------------------------------ logical state machines


def _receivers(n_bytes, staging, mtu):
    return (protocol.LeafReceiver(n_bytes, mtu, staging, device="cpu"),
            ref_protocol.LeafReceiver(n_bytes, mtu, staging))


def _same_receiver(a, b, ctx):
    assert bytes(a.user.numpy()) == bytes(b.user), ctx
    assert a.bitmap.words == b.bitmap.words and a.bitmap.n_chunks == b.bitmap.n_chunks, ctx
    assert a.duplicates == b.duplicates, ctx
    assert (a.staging.occupied, a.staging.rnr_drops) == \
        (b.staging.occupied, b.staging.rnr_drops), ctx
    assert a.complete() == b.complete() and a.bitmap.missing() == b.bitmap.missing(), ctx
    assert a.bitmap.popcount() == b.bitmap.popcount(), ctx


@pytest.mark.parametrize("seed,n_bytes,mtu,n_leaves", [
    (0, 1 << 16, 4096, 4), (1, 100_003, 4096, 5), (2, 9000, 1024, 3), (3, 64 * 4096, 4096, 8),
    (4, 1, 4096, 2), (5, 0, 4096, 2)])
def test_leaf_receivers_match_reference_under_drops(seed, n_bytes, mtu, n_leaves):
    """Each leaf gets the chunks in a random order with random drops and
    duplicates; then each recovers along the ring of its left neighbours,
    the root's buffer last. The port's segment is a padded tensor; a leaf's
    bytes, bitmap words, duplicates and the recovery cost equal the
    reference's."""
    rng = np.random.default_rng(seed)
    buf = rng.integers(0, 256, n_bytes, dtype=np.uint8).tobytes()
    rows = protocol.segment(buf, mtu)
    chunks = ref_protocol.segment(buf, mtu)
    assert rows.shape[0] == len(chunks)
    got, want = [], []
    for leaf in range(n_leaves):
        a, b = _receivers(n_bytes, 8192, mtu)
        order = rng.permutation(len(chunks))
        keep = order[rng.random(order.size) >= 0.3]
        again = keep[rng.random(keep.size) < 0.2]
        for psn in np.concatenate([keep, again]).tolist():
            assert a.deliver(psn, rows[psn]) == b.deliver(chunks[psn])
        _same_receiver(a, b, f"seed {seed} leaf {leaf} after delivery")
        got.append(a)
        want.append(b)
    root_t = torch.from_numpy(np.frombuffer(buf, dtype=np.uint8).copy())
    for leaf in range(n_leaves):
        peers_t = [got[(leaf - k) % n_leaves] for k in range(1, n_leaves)]
        peers_r = [want[(leaf - k) % n_leaves] for k in range(1, n_leaves)]
        root = root_t if leaf % 2 else buf            # a tensor or bytes
        assert got[leaf].fetch_recover(peers_t, root) == want[leaf].fetch_recover(peers_r, buf)
        _same_receiver(got[leaf], want[leaf], f"seed {seed} leaf {leaf} after recovery")
        assert got[leaf].complete()
    assert protocol.final_handshake_ok([r.complete() for r in got]) == \
        ref_protocol.final_handshake_ok([r.complete() for r in want]) is True
    if n_bytes:
        assert bytes(got[0].user.numpy()) == buf


def test_staging_ring_and_bitmap_match_reference():
    rng = np.random.default_rng(11)
    for cap in (0, 1, 3, 16):
        a, b = protocol.StagingRing(cap), ref_protocol.StagingRing(cap)
        for op in rng.integers(0, 3, 200).tolist():
            if op < 2:
                assert a.arrive() == b.arrive()
            elif b.occupied:
                k = int(rng.integers(1, b.occupied + 1))
                a.drain(k)
                b.drain(k)
            assert (a.occupied, a.rnr_drops) == (b.occupied, b.rnr_drops)
    # a full ring: every delivery is an RNR drop, the bitmap stays empty
    a, b = _receivers(1 << 14, 0, 4096)
    rows, chunks = protocol.segment(bytes(1 << 14)), ref_protocol.segment(bytes(1 << 14))
    for psn in range(4):
        assert a.deliver(psn, rows[psn]) is b.deliver(chunks[psn]) is False
    _same_receiver(a, b, "full staging ring")
    for n in (1, 63, 64, 65, 1000):
        x, y = protocol.Bitmap(n), ref_protocol.Bitmap(n)
        for psn in rng.integers(0, n, n // 2 + 1).tolist():
            x.set(psn)
            y.set(psn)
        assert x.words == y.words and x.missing() == y.missing()
        assert (x.popcount(), x.complete()) == (y.popcount(), y.complete())
    with pytest.raises(IndexError):
        protocol.Bitmap(4).set(4)


def test_leaf_receiver_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA"):
        protocol.LeafReceiver(1 << 12)


# ------------------------------------------------------------- closed forms


def test_closed_forms_match_reference():
    assert protocol.IMM_BITS == ref_protocol.IMM_BITS
    for bits in (8, 16, 24, 32):
        for mtu in (1024, 4096):
            assert protocol.max_addressable_buffer(bits, mtu) == \
                ref_protocol.max_addressable_buffer(bits, mtu)
    for q in (0.0, 1e-6, 1e-4, 1e-3, 1e-2, 0.1, 0.5, 0.9):
        for n_chunks in (0, 1, 7, 256, 1 << 14):
            assert protocol.analytic_expected_rounds(q, n_chunks) == \
                ref_protocol.analytic_expected_rounds(q, n_chunks)
            assert protocol.analytic_expected_rounds(q, n_chunks, target=0.1) == \
                ref_protocol.analytic_expected_rounds(q, n_chunks, target=0.1)
        for p in (2, 16, 188, 1024):
            for n in (1, 4096, 1 << 20, 64 << 20):
                args = (p, n, 25e9, 2e-6, q)
                assert protocol.analytic_recovery_time(*args) == \
                    ref_protocol.analytic_recovery_time(*args)
                kw = dict(n_tree_links=3 * p, link_loss=q / 3, mtu=1024, depth=4, alpha=1e-5)
                assert protocol.analytic_recovery_time(*args, **kw) == \
                    ref_protocol.analytic_recovery_time(*args, **kw)
                if q < 1.0:
                    for mtu in (1024, 4096):
                        assert protocol.analytic_ring_pipeline_bcast_time(
                            p, n, 25e9, 2e-6, loss_rate=q, mtu=mtu) == \
                            ref_protocol.analytic_ring_pipeline_bcast_time(
                                p, n, 25e9, 2e-6, loss_rate=q, mtu=mtu)
    assert protocol.analytic_ring_pipeline_bcast_time(8, 0, 25e9, 2e-6) == \
        ref_protocol.analytic_ring_pipeline_bcast_time(8, 0, 25e9, 2e-6)
    for bad in (-0.1, 1.0):
        with pytest.raises(ValueError):
            protocol.analytic_expected_rounds(bad, 16)
        with pytest.raises(ValueError):
            protocol.analytic_ring_pipeline_bcast_time(8, 1 << 20, 25e9, 2e-6, loss_rate=bad)


def test_memory_footprint_and_llc_match_reference():
    for n in (1, 1 << 20, 16 << 30):
        for staging in (64, 1024):
            kw = dict(mtu=4096, staging_chunks=staging, n_leaf_rc_qps=3, ctx_bytes=8 << 10)
            assert protocol.memory_footprint(n, **kw) == ref_protocol.memory_footprint(n, **kw)
        assert protocol.memory_footprint(n) == ref_protocol.memory_footprint(n)
    assert protocol.communicators_in_llc() == ref_protocol.communicators_in_llc() > 16
    for llc in (int(1.5e6), 1 << 22):
        for recv in (1 << 30, 16 << 30):
            for tracked in (4096, 32 << 10):
                kw = dict(llc_bytes=llc, recvbuf_bytes=recv, tracked_chunk=tracked)
                assert protocol.communicators_in_llc(**kw) == \
                    ref_protocol.communicators_in_llc(**kw)


@pytest.mark.parametrize("which", ["config", "params", "host"])
def test_timing_facades_with_dpa_match_reference(which):
    """``dpa=`` routes the facades to the event-level DPA, as the
    reference's do."""
    mine = {"config": dpa.DpaConfig("UD", 8), "params": dpa_engine.EventDpaParams.from_table1(
        "UC", 5), "host": dpa_engine.EventDpaParams.host_cpu(2)}[which]
    ref = {"config": ref_dpa.DpaConfig("UD", 8), "params": ref_de.EventDpaParams.from_table1(
        "UC", 5), "host": ref_de.EventDpaParams.host_cpu(2)}[which]
    wk = dict(workers=engine.WorkerParams(n_recv_workers=4))
    wr = dict(workers=ref_engine.WorkerParams(n_recv_workers=4))
    assert protocol.broadcast_time(16, 1 << 18, seed=3, dpa=mine, loss=0.01, device="cpu",
                                   **wk) == \
        ref_protocol.broadcast_time(16, 1 << 18, seed=3, dpa=ref, loss=0.01, **wr)
    assert protocol.allgather_time(8, 1 << 16, n_chains=3, seed=1, dpa=mine, loss=0.02,
                                   device="cpu", **wk) == \
        ref_protocol.allgather_time(8, 1 << 16, n_chains=3, seed=1, dpa=ref, loss=0.02, **wr)
    with pytest.raises(ValueError, match="packet"):
        protocol.broadcast_time(8, 1 << 16, fidelity="fluid", dpa=mine, device="cpu")


def test_dpa_paths_import_neither_jax_nor_repro():
    """The DPA model, the event engine, an event-mode Broadcast and
    Allgather, the host progress engine's FSDP step and a leaf receiver
    load no jax and no module of the JAX package."""
    code = (
        "import sys, numpy as np\n"
        "from repro_torch.core import dpa, dpa_engine, engine, packet, protocol\n"
        "d = dpa.DpaConfig('UD', 16)\n"
        "assert dpa.tbit_feasible() and dpa_engine.tbit_feasible_event()\n"
        "b = packet.simulate_packet_broadcast(8, 1 << 16, engine.FabricParams(),\n"
        "    engine.workers_from_dpa(d), np.random.default_rng(0), loss=0.05,\n"
        "    dpa_fidelity='event', dpa=d, device='cpu')\n"
        "a = packet.simulate_packet_allgather(8, 1 << 16, engine.FabricParams(),\n"
        "    engine.WorkerParams(), np.random.default_rng(0), 2, loss=0.05,\n"
        "    dpa_fidelity='event', device='cpu')\n"
        "assert b.recovered and a.recovered\n"
        "s = engine.simulate_fsdp_step(p=8, n_layers=2, progress_engine='host', device='cpu')\n"
        "assert s.datapath_tput > 0\n"
        "r = protocol.LeafReceiver(1 << 14, device='cpu')\n"
        "rows = protocol.segment(bytes(1 << 14))\n"
        "assert all(r.deliver(i, rows[i]) for i in range(4)) and r.complete()\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro')]\n"
        "assert not bad, bad\n")
    env = dict(os.environ)
    src = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src")
    env["PYTHONPATH"] = src + os.pathsep + env.get("PYTHONPATH", "")
    res = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-2000:]
