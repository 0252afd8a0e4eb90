"""Route-aware fabric engine tour, on the PyTorch port: what per-NIC models
cannot see.

1. Fig. 2/12 on the routed engine: the P2P ring vs multicast-composition
   Allgather, timing AND switch-port bytes from the same engine run.
2. FSDP policies as routed traffic on a fat-tree (naive / mcast / split).
3. Two FSDP jobs on disjoint hosts sharing the fabric core: isolated at
   full bisection, interfering under oversubscription.

    python examples_torch/fabric_contention.py                 (on the GPU)
    python examples_torch/fabric_contention.py --device cpu

The engines' max-min solves and the pool scans run on ``--device``; the
printed lines are those of the JAX package's
``examples/fabric_contention.py``.
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src"))

import numpy as np  # noqa: E402

from repro_torch.core import cost_model as cm  # noqa: E402
from repro_torch.core.engine import (FSDP_POLICIES, simulate_fsdp_step,  # noqa: E402
                                     simulate_multi_job)
from repro_torch.core.simulator import (FabricParams, WorkerParams,  # noqa: E402
                                        simulate_allgather)
from repro_torch.core.topology import FatTree  # noqa: E402
from repro_torch.device import device_of  # noqa: E402


def routed_fig2(device):
    print("=" * 72)
    print("1. Fig 2/12 on the routed engine (k=32 fat-tree, 64 KiB shards)")
    fab = FabricParams(p_drop=0.0, jitter=0.0)
    wk = WorkerParams(n_recv_workers=16)
    shard = 64 << 10
    for p in (128, 512):
        topo = FatTree(k=32, n_hosts=p, b_host=fab.b_link)
        ag = simulate_allgather(p, shard, fab, wk, np.random.default_rng(0),
                                n_chains=p, topology=topo, device=device)
        mc = sum(ag.link_bytes.values())
        t_ring, ring_lb = cm.routed_ring_allgather(topo, p, p * shard, fab, device=device)
        ring = sum(ring_lb.values())
        print(f"   P={p:4d}: ring {ring/2**30:6.2f} GiB / {t_ring*1e3:5.2f} ms"
              f"   mcast {mc/2**30:6.2f} GiB / {ag.time*1e3:5.2f} ms"
              f"   -> x{ring/mc:.2f} less traffic, earlier finish")


def routed_fsdp(device):
    print("=" * 72)
    print("2. FSDP policies as routed traffic (P=16 on a k=8 fat-tree)")
    topo = FatTree(k=8, n_hosts=16)
    for pol in FSDP_POLICIES:
        r = simulate_fsdp_step(n_layers=4, layer_bytes=256e6, p=16,
                               policy=pol, hw_flops=2e15, topology=topo,
                               device=device)
        busiest = max(r.link_utilization, key=r.link_utilization.get)
        print(f"   policy={pol:6s} step={r.step_time*1e3:7.2f} ms  "
              f"bubble={r.bubble_fraction:.3f}  busiest link "
              f"{busiest} @ {r.link_utilization[busiest]:.2f}")


def multi_job(device):
    print("=" * 72)
    print("3. Two FSDP jobs, disjoint hosts, one fabric (k=8, 32 hosts)")
    jobs = {"A": list(range(0, 32, 2)), "B": list(range(1, 32, 2))}
    slow = {}
    for o in (1.0, 2.0, 4.0):
        topo = FatTree(k=8, n_hosts=32, oversubscription=o)
        r = simulate_multi_job(topo, jobs, layer_bytes=128e6, n_layers=3,
                               policy="mcast", device=device)
        slow[o] = max(r.slowdown.values())
        print(f"   oversubscription {o:g}: solo "
              f"{min(r.solo_time.values())*1e3:6.2f} ms  contended "
              f"{max(r.contended_time.values())*1e3:6.2f} ms  slowdown "
              f"{slow[o]:.2f}x  (core traffic {r.core_bytes/1e9:.2f} GB)")
    assert slow[1.0] < 1.01 <= slow[4.0], slow
    print("   full bisection isolates the jobs; oversubscription makes their"
          " trees collide on shared agg/core links")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    device = device_of(ap.parse_args(argv).device)
    routed_fig2(device)
    routed_fsdp(device)
    multi_job(device)


if __name__ == "__main__":
    main()
