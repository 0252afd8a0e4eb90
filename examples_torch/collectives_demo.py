"""A guided tour of the paper's algorithms, on the PyTorch port.

1. The Appendix-A broadcast sequencer (chains, activation signals).
2. Fat-tree traffic counting: P2P vs multicast (Fig 2 / Fig 12).
3. The reliable-broadcast protocol under drops + reordering (§III).
4. The discrete-event simulator: phase breakdown (Fig 10).
5. The DPA offload model: thread scaling to 1.6 Tbit/s (Figs 13-16).
6. The Schedule IR: allreduce (RS ∘ AG) built once, lowered per fidelity.

    python examples_torch/collectives_demo.py                 (on the GPU)
    python examples_torch/collectives_demo.py --device cpu

The leaves' buffers of part 3 and the simulators' device work (the pool
scans, the max-min solves) run on ``--device``; the printed lines are those
of the JAX package's ``examples/collectives_demo.py``.
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src"))

import numpy as np  # noqa: E402

from repro_torch.core import cost_model as cm  # noqa: E402
from repro_torch.core import dpa, protocol, sched_ir, schedule  # noqa: E402
from repro_torch.core.simulator import (FabricParams, WorkerParams,  # noqa: E402
                                        simulate_broadcast)
from repro_torch.core.topology import FatTree  # noqa: E402
from repro_torch.device import device_of  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    device = device_of(ap.parse_args(argv).device)

    print("=" * 72)
    print("1. Broadcast sequencer (P=16, M=4 chains) — Appendix A")
    for st in schedule.allgather_schedule(16, 4):
        print(f"   step {st.index}: active roots G^{st.index} = {st.roots}")
    print(f"   activation edges: {schedule.activation_edges(16, 4)[:6]} ...")

    print("=" * 72)
    print("2. Fat-tree traffic (1024 nodes, radix 32) — Fig 2")
    tree = FatTree(k=32, n_hosts=1024)
    n = 1 << 20
    ring = cm.p2p_ring_allgather_traffic(tree, 1024, n)
    mc = cm.mcast_allgather_traffic(tree, 1024, n)
    print(f"   allgather P2P-ring : {ring/2**30:8.2f} GiB on fabric")
    print(f"   allgather multicast: {mc/2**30:8.2f} GiB  ({ring/mc:.2f}x less)")

    print("=" * 72)
    print("3. Reliable broadcast under 20% drops + reordering — §III")
    rng = np.random.default_rng(0)
    buf = bytes(rng.integers(0, 256, 1 << 16, dtype=np.uint8))
    chunks = protocol.segment(buf)
    leaves = [protocol.LeafReceiver(len(buf), device=device) for _ in range(4)]
    for leaf in leaves:
        for i in rng.permutation(len(chunks)):       # out-of-order
            if rng.random() > 0.2:                    # 20% drops
                leaf.deliver(int(i), chunks[i])
    missing = [len(l.bitmap.missing()) for l in leaves]
    print(f"   after fast path: missing per leaf = {missing}")
    for li, leaf in enumerate(leaves):
        peers = [leaves[(li - 1 - j) % 4] for j in range(3)]
        leaf.fetch_recover(peers, buf)
    ok = all(l.complete() and bytes(l.user.cpu().numpy()) == buf for l in leaves)
    print(f"   after fetch-ring recovery: all complete = {ok}")

    print("=" * 72)
    print("4. Protocol phase breakdown (188 nodes) — Fig 10")
    for size in (4096, 4 << 20):
        r = simulate_broadcast(188, size, FabricParams(b_link=56e9 / 8),
                               WorkerParams(n_recv_workers=2),
                               np.random.default_rng(1), device=device)
        ph = r.phases
        print(f"   N={size:>8d}B: rnr {ph.rnr_sync*1e6:7.1f}us | "
              f"mcast {ph.multicast*1e6:9.1f}us | hs {ph.handshake*1e6:5.1f}us")

    print("=" * 72)
    print("5. DPA offload scaling — Figs 13/16")
    for t in (1, 4, 16):
        for tr in ("UD", "UC"):
            g = dpa.sustained_tput(dpa.DpaConfig(tr, t)) / 2**30
            print(f"   {tr} x{t:2d} threads: {g:5.1f} GiB/s", end="")
        print()
    need = dpa.link_chunk_arrival_rate(dpa.LINK_1600G_BYTES) / 1e6
    got = dpa.sustained_chunk_rate(
        dpa.DpaConfig("UD", 128, 64, dpa.LINK_1600G_BYTES)) / 1e6
    print(f"   1.6 Tbit/s needs {need:.1f} Mchunks/s; 128 threads sustain "
          f"{got:.1f} -> feasible = {got >= need}")

    print("=" * 72)
    print("6. Schedule IR: Allreduce = RS ∘ AG from one schedule graph")
    # build once, lower onto any fidelity (sched_ir.execute)
    p, n = 16, 1 << 22
    fab = FabricParams(jitter=0.0)
    wk = WorkerParams(n_recv_workers=8)
    mc = sched_ir.execute(sched_ir.build_allreduce(p, n, m=p), fab, wk,
                          np.random.default_rng(0), device=device)
    ring = sched_ir.execute(sched_ir.build_allreduce(p, n), fab, wk,
                            np.random.default_rng(0), device=device)
    lb = sched_ir.execute(sched_ir.build_allreduce(p, n, m=p), fab, wk,
                          fidelity="analytic", device=device)
    print(f"   allreduce 4MiB x{p}: multicast-AG {mc.time*1e6:7.1f}us "
          f"(RS {mc.rs_time*1e6:.1f} + AG {mc.ag_time*1e6:.1f}) | "
          f"ring {ring.time*1e6:7.1f}us | analytic LB {lb*1e6:7.1f}us")
    best_m, times = sched_ir.autotune_chains(sched_ir.build_allgather,
                                             p=p, n_bytes=1 << 18,
                                             fabric=fab, workers=wk, device=device)
    print(f"   autotune_chains(allgather, flat fabric): best M = {best_m} "
          f"of {sorted(times)}")


if __name__ == "__main__":
    main()
