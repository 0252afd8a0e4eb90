"""Analytic cost models of the paper.

Port of ``src/repro/core/cost_model.py:24-213``:

- the traffic of P2P and multicast Broadcast / Allgather on a fat-tree
  (Fig. 2, Fig. 12), counted exactly by routing over ``core.topology``'s
  ``FatTree`` and adding per-link bytes (the software switch counters);
- ``routed_ring_allgather``: the P2P ring schedule as routed flows through
  the fluid engine (its solve on ``device``, default ``cuda``), the time and
  the per-link bytes from one run, the baseline multicast is held against;
- the concurrent-{AG,RS} speedup S = 2 - 2/P (Appendix B);
- the closed-form Broadcast and Allgather schedule times (Fig. 10 / 11).
"""
from __future__ import annotations

import math
from dataclasses import dataclass

from repro_torch.core.engine import Engine, FabricParams
from repro_torch.core.topology import FatTree
from repro_torch.device import device_of


# ------------------------------------------------------------- traffic (Fig 2)


def p2p_ring_allgather_traffic(tree: FatTree, p: int, nbytes: int) -> int:
    """Ring allgather: P-1 rounds; at round t rank i sends shard (i-t) to
    i+1, so every rank sends (P-1) * (N/P) bytes to its ring neighbour."""
    tree.reset()
    shard = nbytes // p
    for step in range(p - 1):
        for src in range(p):
            tree.unicast(src, (src + 1) % p, shard)
    return tree.counters.total()


def p2p_knomial_bcast_traffic(tree: FatTree, p: int, nbytes: int, k: int = 4) -> int:
    """k-nomial tree broadcast from rank 0: each holder forwards to k-1 new
    ranks a round."""
    tree.reset()
    have = [0]
    while len(have) < p:
        new = []
        for h in have:
            for j in range(1, k):
                t = h + j * len(have)
                if t < p:
                    tree.unicast(h, t, nbytes)
                    new.append(t)
        have += new
    return tree.counters.total()


def p2p_linear_allgather_traffic(tree: FatTree, p: int, nbytes: int) -> int:
    """Linear (direct) allgather: every rank sends its shard to P-1 peers."""
    tree.reset()
    shard = nbytes // p
    for src in range(p):
        for dst in range(p):
            if dst != src:
                tree.unicast(src, dst, shard)
    return tree.counters.total()


def p2p_ring_pipeline_bcast_traffic(tree: FatTree, p: int, nbytes: int) -> int:
    """Segment-pipelined ring broadcast: every rank forwards the whole
    buffer to its ring neighbour once."""
    tree.reset()
    for src in range(p - 1):
        tree.unicast(src, src + 1, nbytes)
    return tree.counters.total()


def mcast_bcast_traffic(tree: FatTree, p: int, nbytes: int, root: int = 0) -> int:
    tree.reset()
    tree.multicast(root, list(range(p)), nbytes)
    return tree.counters.total()


def mcast_allgather_traffic(tree: FatTree, p: int, nbytes: int) -> int:
    """Composition of broadcasts: every rank multicasts its shard once, and
    every byte crosses every tree link once (Insight 1)."""
    tree.reset()
    shard = nbytes // p
    members = list(range(p))
    for root in range(p):
        tree.multicast(root, members, shard)
    return tree.counters.total()


# ------------------------------------- routed-engine baselines (fabric sweep)


def routed_ring_allgather(topology, p: int, nbytes: int, fabric: FabricParams | None = None,
                          hosts=None, *, device=None) -> tuple[float, dict[str, float]]:
    """The P2P ring allgather as routed fluid flows: one flow per ring
    neighbour pair carrying the collective's forwarding traffic (P-1 rounds
    x N/P bytes) along its up-down ECMP path. Returns (completion time,
    per-link bytes) from the one engine run, whose max-min solve runs on
    ``device`` (default ``cuda``); the time adds the P-1 activation
    latencies the ring serialises on."""
    dev = device_of("cuda" if device is None else device)
    fabric = fabric or FabricParams()
    hosts = list(hosts) if hosts is not None else list(range(p))
    if len(hosts) != p:
        raise ValueError(f"{len(hosts)} hosts for {p} ranks")
    topology.reset()
    eng = Engine(device=dev)
    shard = nbytes // p
    flows = [eng.submit_route(topology.route(hosts[i], hosts[(i + 1) % p]), (p - 1) * shard,
                              tag="ring")
             for i in range(p)]
    t = eng.run()
    if not all(f.done for f in flows):
        raise RuntimeError("a ring flow never finished")
    return t + (p - 1) * fabric.latency, eng.link_bytes()


# ------------------------------------------------- Appendix B: speedup S(P)


def concurrent_ag_rs_speedup(p: int) -> float:
    """S = T_{ring,ring} / T_{mc,inc} = 2 - 2/P."""
    return 2.0 - 2.0 / p


@dataclass(frozen=True)
class NicShare:
    """NIC direction bandwidth shares for concurrently running AG+RS."""
    ag_send: float
    ag_recv: float
    rs_send: float
    rs_recv: float


def ring_ring_share() -> NicShare:
    # ring AG and ring RS each need both directions equally (Insight 2)
    return NicShare(0.5, 0.5, 0.5, 0.5)


def mc_inc_share(p: int) -> NicShare:
    # AG_mc is receive-bound, RS_inc is send-bound: no shared bottleneck
    return NicShare(1.0 / p, 1.0 - 1.0 / p, 1.0 - 1.0 / p, 1.0 / p)


def concurrent_completion_time(n: int, p: int, b_nic: float, mode: str) -> float:
    """Completion time of {AG, RS} issued together; N = the per-rank AG send
    buffer (= the RS receive shard). Both move N*(P-1) bytes through the
    bottleneck direction."""
    if mode == "ring_ring":
        share = ring_ring_share()
        return n * (p - 1) / (share.ag_recv * b_nic)
    if mode == "mc_inc":
        share = mc_inc_share(p)
        return n * (p - 1) / (share.ag_recv * b_nic)
    raise ValueError(mode)


# -------------------------------------------- Broadcast schedule-time models


def bcast_time_multicast(n: int, b_link: float, p: int, mtu: int = 4096,
                         alpha: float = 5e-6) -> float:
    """Constant-time pipelined multicast broadcast: the switch fans out, so
    T ~ N/B + sync (independent of P for a fixed N)."""
    return n / b_link + alpha * 2  # RNR barrier + final handshake, amortized


def bcast_time_binary_tree(n: int, b_link: float, p: int, alpha: float = 5e-6) -> float:
    """Non-pipelined binary-tree broadcast (store and forward a level):
    depth x N/B, the 4.75x-slower baseline of Fig. 11."""
    depth = math.ceil(math.log2(max(p, 2)))
    return depth * (n / b_link + alpha)


def bcast_time_knomial(n: int, b_link: float, p: int, k: int = 2, seg: int = 1 << 15,
                       alpha: float = 1.5e-6) -> float:
    """Segment-pipelined k-nomial broadcast: (k-1) x N/B plus per-segment
    posting and the pipeline fill, the ~1.3x baseline of Fig. 11."""
    depth = math.ceil(math.log(max(p, 2), max(k, 2)))
    n_segs = max(n // seg, 1)
    return (k - 1) * n / b_link + depth * (seg / b_link + alpha) + n_segs * alpha


def allgather_time_ring(n: int, b_link: float, p: int, alpha: float = 5e-6) -> float:
    """Receive-bound optimum: (P-1)/P * N_total / B, N_total = N*P."""
    return n * (p - 1) / b_link + (p - 1) * alpha


def allgather_time_multicast(n: int, b_link: float, p: int, m_chains: int | None = None,
                             alpha: float = 5e-6) -> float:
    """Multicast allgather, receive-bound by the N*(P-1) bytes arriving on
    the one receive path: the ring's bound, with ~P x less send traffic."""
    return n * (p - 1) / b_link + 2 * alpha


# ------------------------------------------------------ torus adaptation notes


def torus_ring_per_link_bytes(p: int, nbytes: int, *, bidi: bool) -> float:
    """Per-link bytes of a (bi)directional ring allgather on a torus ring:
    each byte crosses each link once per direction used."""
    shard = nbytes / p
    per_dir = shard * (p - 1)
    return per_dir / (2 if bidi else 1)
