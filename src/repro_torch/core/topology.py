"""Route-providing network topologies backed by the engine's Links.

Port of ``src/repro/core/topology.py:56-595``. A ``Topology`` owns one
``engine.Link`` per directed physical cable, and

  route(src, dst)               the ordered Link path (deterministic up-down
                                ECMP on the fat-tree, dimension-ordered
                                shortest ring paths on the torus);
  multicast_tree(root, members) the Link edge set of the switches'
                                multicast distribution tree;
  aggregation_tree(root, members) the reversed tree (in-network reduction);
  links()                       every directed link, with per-tier
                                capacities and an oversubscription factor.

Byte counters are the Links' own ``bytes_served``: an engine run over routed
flows is the traffic measurement (the switch port counters of Fig. 12);
``counters`` is a read-only view of them, and the static ``unicast`` /
``multicast`` helpers (the analytic Fig. 2 path, no timing) charge the same
Links. Link names, route order and tree edge order are the reference's, so
``link_bytes`` dicts compare key by key.

Topologies: ``FatTree`` (3-level, radix k; the paper's testbed and Fig. 2's
1,024 hosts at k = 32), ``IslandFatTree`` (the fat-tree plus NVLink-class
island rings) and ``Torus2D`` (bidirectional neighbour links).
"""
from __future__ import annotations

import math
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Protocol, Sequence, runtime_checkable

from repro_torch.core.engine import Link

#: default per-direction host link rate (200 Gbit/s, the paper's NIC)
DEFAULT_LINK_BYTES = 200e9 / 8

#: fabric link tiers, innermost first: inside one host, the island
#: interconnect between hosts of one island, and the multicast-capable
#: switched fat-tree between islands
LINK_TIERS = ("intra_host", "island", "switched")


@dataclass
class LinkCounters:
    """Read-only per-link byte view keyed by (src, dst) node names, built
    from the Links' ``bytes_served`` (``Topology.counters``)."""

    bytes_by_link: dict[tuple[str, str], float] = field(
        default_factory=lambda: defaultdict(float))

    def total(self) -> float:
        return sum(self.bytes_by_link.values())

    def max_link(self) -> float:
        return max(self.bytes_by_link.values(), default=0)

    def switch_port_total(self) -> float:
        """Sum over all switch ports (Fig. 12 counts every directed link
        endpoint at a switch)."""
        return self.total()


@runtime_checkable
class Topology(Protocol):
    """Route provider for the fluid engine: route and multicast_tree return
    the topology's own Links, so engine runs charge its counters."""

    def links(self) -> dict[tuple[str, str], Link]: ...

    def route(self, src: int, dst: int) -> list[Link]: ...

    def multicast_tree(self, root: int, members: Sequence[int]) -> list[Link]: ...

    def aggregation_tree(self, root: int, members: Sequence[int]) -> list[Link]: ...

    def reset(self) -> None: ...


@dataclass(frozen=True)
class Cut:
    """One fabric cut: the hosts inside a region and the aggregate capacity
    of the directed links crossing its boundary."""

    name: str
    hosts: frozenset[int]              # host ids inside the region
    cap_in: float                      # bytes/s entering the region
    cap_out: float                     # bytes/s leaving the region


class _LinkRegistry:
    """The directed-link table, and the check that every hop of a route or
    tree is a cable that exists."""

    def __init__(self):
        self._links: dict[tuple[str, str], Link] = {}
        self._tiers: dict[tuple[str, str], str] = {}

    def _add(self, a: str, b: str, capacity: float, *, tier: str = "switched") -> None:
        if tier not in LINK_TIERS:
            raise ValueError(f"tier must be one of {LINK_TIERS}, got {tier!r}")
        if (a, b) not in self._links:
            self._links[(a, b)] = Link(f"{a}->{b}", capacity, a, b)
            self._tiers[(a, b)] = tier

    def tier_of(self, a: str, b: str) -> str:
        """Fabric tier of the directed link a->b (see LINK_TIERS)."""
        self.link(a, b)
        return self._tiers[(a, b)]

    def tier_split(self, link_bytes: dict[str, float]) -> dict[str, float]:
        """An engine ``link_bytes()`` dict split into per-tier byte totals."""
        out: dict[str, float] = {}
        for (a, b), link in self._links.items():
            v = link_bytes.get(link.name)
            if v:
                t = self._tiers[(a, b)]
                out[t] = out.get(t, 0.0) + v
        return out

    def link(self, a: str, b: str) -> Link:
        """The directed Link a->b; raises if the cable does not exist."""
        link = self._links.get((a, b))
        if link is None:
            raise ValueError(f"nonexistent fabric link {a}->{b}")
        return link

    def _resolve(self, hops: Sequence[tuple[str, str]]) -> list[Link]:
        return [self.link(a, b) for a, b in hops]

    def links(self) -> dict[tuple[str, str], Link]:
        return self._links

    @property
    def counters(self) -> LinkCounters:
        """Live per-link bytes as a LinkCounters view."""
        c = LinkCounters()
        for (a, b), link in self._links.items():
            if link.bytes_served:
                c.bytes_by_link[(a, b)] = link.bytes_served
        return c

    def reset(self) -> None:
        for link in self._links.values():
            link.bytes_served = 0.0
            link.active = []

    # --- cuts
    def cut_capacity(self, inside: set[str]) -> tuple[float, float]:
        """(cap_in, cap_out) of the cut around the node names ``inside``."""
        cap_in = cap_out = 0.0
        for (a, b), link in self._links.items():
            if a not in inside and b in inside:
                cap_in += link.capacity
            elif a in inside and b not in inside:
                cap_out += link.capacity
        return cap_in, cap_out

    def _make_cut(self, name: str, hosts, inside: set[str]) -> Cut:
        cap_in, cap_out = self.cut_capacity(inside)
        return Cut(name, frozenset(hosts), cap_in, cap_out)

    # --- static counting (Fig. 2: traffic without timing)
    def unicast(self, src: int, dst: int, nbytes: float) -> None:
        for link in self.route(src, dst):
            link.bytes_served += nbytes

    def multicast(self, root: int, members: Sequence[int], nbytes: float) -> None:
        for link in self.multicast_tree(root, members):
            link.bytes_served += nbytes

    def aggregation_tree(self, root: int, members: Sequence[int]) -> list[Link]:
        """The reversed multicast tree: members send up, switches reduce, and
        each reversed edge carries the payload once."""
        return [self.link(l.dst, l.src) for l in self.multicast_tree(root, members)]


class FatTree(_LinkRegistry):
    """Full 3-level fat-tree, radix ``k``: k pods, k/2 edge + k/2 agg switches
    a pod, (k/2)^2 cores, (k/2)^2 hosts a pod; host ids 0..n_hosts-1. Core c
    hangs off agg c // (k/2) in every pod; links exist for the pods that hold
    hosts. ``oversubscription`` divides the capacity of the switch-to-switch
    tiers; host links stay at ``b_host``."""

    supports_packet = True
    supports_transport = False

    def __init__(self, k: int, n_hosts: int | None = None, *,
                 b_host: float = DEFAULT_LINK_BYTES, oversubscription: float = 1.0):
        super().__init__()
        if k % 2:
            raise ValueError(f"k must be even, got {k}")
        self.k = k
        h2 = k // 2
        self.max_hosts = k * h2 * h2
        self.n_hosts = n_hosts or self.max_hosts
        if self.n_hosts > self.max_hosts:
            raise ValueError(f"{self.n_hosts} hosts exceed the {self.max_hosts} of k={k}")
        if not oversubscription >= 1.0:
            raise ValueError(f"oversubscription must be >= 1, got {oversubscription}")
        self.b_host = float(b_host)
        self.oversubscription = float(oversubscription)
        b_up = self.b_host / self.oversubscription
        for h in range(self.n_hosts):
            self._add(self.host(h), self.edge_of(h), self.b_host)
            self._add(self.edge_of(h), self.host(h), self.b_host)
        n_pods = math.ceil(self.n_hosts / (h2 * h2))
        for pod in range(n_pods):
            for e in range(h2):
                for a in range(h2):
                    self._add(f"e{pod}.{e}", self.agg(pod, a), b_up)
                    self._add(self.agg(pod, a), f"e{pod}.{e}", b_up)
            for a in range(h2):
                for j in range(h2):
                    c = a * h2 + j          # core c // h2 == a by construction
                    self._add(self.agg(pod, a), self.core(c), b_up)
                    self._add(self.core(c), self.agg(pod, a), b_up)

    # --- naming
    def host(self, h: int) -> str:
        return f"h{h}"

    def edge_of(self, h: int) -> str:
        pod, esw = self._loc(h)
        return f"e{pod}.{esw}"

    def _loc(self, h: int) -> tuple[int, int]:
        per_pod = (self.k // 2) ** 2
        pod = h // per_pod
        esw = (h % per_pod) // (self.k // 2)
        return pod, esw

    def agg(self, pod: int, a: int) -> str:
        return f"a{pod}.{a}"

    def core(self, c: int) -> str:
        return f"c{c}"

    def core_links(self) -> list[Link]:
        """Agg<->core links in both directions."""
        return [l for (a, b), l in self._links.items()
                if a.startswith("c") or b.startswith("c")]

    # --- search introspection
    def signature(self) -> tuple:
        """Hashable identity of the fabric's shape."""
        return ("FatTree", self.k, self.n_hosts, self.b_host, self.oversubscription)

    def tier_capacities(self) -> dict[str, float]:
        return {"host": self.b_host, "up": self.b_host / self.oversubscription}

    def bottleneck_cuts(self) -> list[Cut]:
        """One host, one edge-switch group and one pod, each dropped where it
        holds every host."""
        h2 = self.k // 2
        per_pod = h2 * h2
        cuts = [self._make_cut("host0", [0], {self.host(0)})]
        edge_hosts = [h for h in range(self.n_hosts) if self.edge_of(h) == self.edge_of(0)]
        if len(edge_hosts) < self.n_hosts:
            cuts.append(self._make_cut(
                "edge0", edge_hosts, {self.host(h) for h in edge_hosts} | {self.edge_of(0)}))
        pod_hosts = [h for h in range(self.n_hosts) if h < per_pod]
        if len(pod_hosts) < self.n_hosts:
            inside = {self.host(h) for h in pod_hosts}
            inside |= {f"e0.{e}" for e in range(h2)}
            inside |= {self.agg(0, a) for a in range(h2)}
            cuts.append(self._make_cut("pod0", pod_hosts, inside))
        return cuts

    # --- deterministic ECMP up-down route
    def route(self, src: int, dst: int) -> list[Link]:
        """Ordered Link path; the ECMP choices hash (src, dst), and the up
        aggregation switch derives from the chosen core (a = c // h2)."""
        if src == dst:
            return []
        sp, se = self._loc(src)
        dp, de = self._loc(dst)
        h2 = self.k // 2
        hops = [(self.host(src), self.edge_of(src))]
        if (sp, se) == (dp, de):
            pass
        elif sp == dp:
            a = (src + dst) % h2
            hops += [(self.edge_of(src), self.agg(sp, a)),
                     (self.agg(sp, a), self.edge_of(dst))]
        else:
            c = (src * 31 + dst) % (h2 * h2)
            a = c // h2
            hops += [(self.edge_of(src), self.agg(sp, a)),
                     (self.agg(sp, a), self.core(c)),
                     (self.core(c), self.agg(dp, a)),
                     (self.agg(dp, a), self.edge_of(dst))]
        hops.append((self.edge_of(dst), self.host(dst)))
        return self._resolve(hops)

    # --- multicast spanning tree
    def multicast_tree(self, root: int, members: Sequence[int]) -> list[Link]:
        """Edges of the multicast tree: root -> its edge switch -> (agg ->
        core as needed) -> every member's edge switch -> hosts, each link
        once; both aggregation switches derive from the root's hashed core."""
        h2 = self.k // 2
        c = (root * 31) % (h2 * h2)
        a = c // h2
        rp, _ = self._loc(root)
        root_edge = self.edge_of(root)
        hops: dict[tuple[str, str], None] = {}   # ordered, deduplicated
        hops[(self.host(root), root_edge)] = None
        for m in members:
            if m == root:
                continue
            mp, me = self._loc(m)
            m_edge = self.edge_of(m)
            if m_edge != root_edge:
                hops[(root_edge, self.agg(rp, a))] = None
                if mp == rp:
                    hops[(self.agg(rp, a), m_edge)] = None
                else:
                    hops[(self.agg(rp, a), self.core(c))] = None
                    hops[(self.core(c), self.agg(mp, a))] = None
                    hops[(self.agg(mp, a), m_edge)] = None
            hops[(m_edge, self.host(m))] = None
        return self._resolve(list(hops))


class IslandFatTree(FatTree):
    """The FatTree's switched tier plus islands: consecutive groups of
    ``island_size`` hosts joined by a bidirectional neighbour ring of
    island-tier links at ``b_island`` (default 8x the NIC). ``transport``
    pins an op to a tier: "switched" the fat-tree (the only tier with
    multicast), "island" the ring (both hosts in one island), None the ring
    for island-local pairs and the fat-tree otherwise."""

    supports_packet = True
    supports_transport = True

    def __init__(self, k: int, n_hosts: int | None = None, *, island_size: int = 8,
                 b_island: float | None = None, b_host: float = DEFAULT_LINK_BYTES,
                 oversubscription: float = 1.0):
        super().__init__(k, n_hosts, b_host=b_host, oversubscription=oversubscription)
        if island_size < 2:
            raise ValueError("an island needs at least two hosts")
        if self.n_hosts % island_size:
            raise ValueError(f"islands of {island_size} must tile {self.n_hosts} hosts")
        self.island_size = island_size
        self.b_island = float(b_island if b_island is not None else 8 * self.b_host)
        g = island_size
        for i in range(self.n_islands):
            for j in range(g):
                a, b = i * g + j, i * g + (j + 1) % g
                if a != b:
                    self._add(self.host(a), self.host(b), self.b_island, tier="island")
                    self._add(self.host(b), self.host(a), self.b_island, tier="island")

    # --- island structure
    @property
    def n_islands(self) -> int:
        return self.n_hosts // self.island_size

    def island_of(self, h: int) -> int:
        return h // self.island_size

    def island_members(self, i: int) -> list[int]:
        g = self.island_size
        return list(range(i * g, (i + 1) * g))

    # --- search introspection
    def signature(self) -> tuple:
        return ("IslandFatTree", self.k, self.n_hosts, self.b_host, self.oversubscription,
                self.island_size, self.b_island)

    def tier_capacities(self) -> dict[str, float]:
        return {"island": self.b_island, "host": self.b_host,
                "up": self.b_host / self.oversubscription}

    def bottleneck_cuts(self) -> list[Cut]:
        """FatTree's cuts and the island-0 cut."""
        cuts = super().bottleneck_cuts()
        if self.island_size < self.n_hosts:
            members = self.island_members(0)
            cuts.append(self._make_cut("island0", members, {self.host(h) for h in members}))
        return cuts

    # --- transport-aware routing
    def _island_hops(self, src: int, dst: int) -> list[tuple[str, str]]:
        """Shortest intra-island ring path (ties toward +1)."""
        g = self.island_size
        base = self.island_of(src) * g
        s, d = src - base, dst - base
        step = Torus2D._dir(s, d, g)
        hops, x = [], s
        while x != d:
            nxt = (x + step) % g
            hops.append((self.host(base + x), self.host(base + nxt)))
            x = nxt
        return hops

    def route(self, src: int, dst: int, transport: str | None = None) -> list[Link]:
        if src == dst:
            return []
        local = self.island_of(src) == self.island_of(dst)
        if transport == "island" or (transport is None and local):
            if not local:
                raise ValueError(f"island transport across islands: {src} -> {dst}")
            return self._resolve(self._island_hops(src, dst))
        if transport not in (None, "switched"):
            raise ValueError(f"unknown transport {transport!r}")
        return super().route(src, dst)

    def multicast_tree(self, root: int, members: Sequence[int],
                       transport: str | None = None) -> list[Link]:
        if transport not in (None, "switched"):
            raise ValueError(f"multicast exists only on the switched tier, got {transport!r}")
        return super().multicast_tree(root, members)


class Torus2D(_LinkRegistry):
    """2-D torus with bidirectional neighbour links; node id = x * ny + y.
    Routes are dimension-ordered (x, then y) shortest ring paths, ties toward
    +1; a multicast tree is the union of the routes from the root."""

    supports_packet = True

    def __init__(self, nx: int, ny: int, *, b_link: float = DEFAULT_LINK_BYTES):
        super().__init__()
        self.nx, self.ny = nx, ny
        self.b_link = float(b_link)
        for x in range(nx):
            for y in range(ny):
                for dx, dy in ((1, 0), (-1, 0), (0, 1), (0, -1)):
                    a, b = self.node(x, y), self.node(x + dx, y + dy)
                    if a != b:
                        self._add(a, b, self.b_link, tier="island")

    def node(self, x: int, y: int) -> str:
        return f"t{x % self.nx}.{y % self.ny}"

    def coord(self, i: int) -> tuple[int, int]:
        return i // self.ny, i % self.ny

    def host(self, h: int) -> str:
        return self.node(*self.coord(h))

    # --- search introspection
    def signature(self) -> tuple:
        return ("Torus2D", self.nx, self.ny, self.b_link)

    def tier_capacities(self) -> dict[str, float]:
        return {"link": self.b_link}

    def bottleneck_cuts(self) -> list[Cut]:
        """One node, the first column ring and the first row ring."""
        cuts = [self._make_cut("node0", [0], {self.node(0, 0)})]
        if self.nx > 1:
            col_hosts = [self.ny * 0 + y for y in range(self.ny)]
            cuts.append(self._make_cut(
                "col0", col_hosts, {self.node(0, y) for y in range(self.ny)}))
        if self.ny > 1:
            row_hosts = [x * self.ny for x in range(self.nx)]
            cuts.append(self._make_cut(
                "row0", row_hosts, {self.node(x, 0) for x in range(self.nx)}))
        return cuts

    @staticmethod
    def _dir(a: int, b: int, n: int) -> int:
        """Shortest ring direction a -> b on a ring of size n (ties -> +1)."""
        fwd = (b - a) % n
        return +1 if fwd <= n - fwd else -1

    def _hops(self, src: int, dst: int) -> list[tuple[str, str]]:
        sx, sy = self.coord(src)
        dx, dy = self.coord(dst)
        hops = []
        x, y = sx, sy
        step = self._dir(sx, dx, self.nx)
        while x != dx:
            nxt = (x + step) % self.nx
            hops.append((self.node(x, y), self.node(nxt, y)))
            x = nxt
        step = self._dir(sy, dy, self.ny)
        while y != dy:
            nxt = (y + step) % self.ny
            hops.append((self.node(x, y), self.node(x, nxt)))
            y = nxt
        return hops

    def route(self, src: int, dst: int) -> list[Link]:
        return self._resolve(self._hops(src, dst))

    def multicast_tree(self, root: int, members: Sequence[int]) -> list[Link]:
        """Union of the dimension-ordered routes root -> member (the routes
        are confluent, so the union is a tree). A group of the root alone
        gives no edge, as in the reference."""
        hops: dict[tuple[str, str], None] = {}
        for m in members:
            if m == root:
                continue
            for hop in self._hops(root, m):
                hops[hop] = None
        return self._resolve(list(hops))

    # --- ring counting helpers (torus analytic path)
    def ring_x_link(self, x: int, y: int, direction: int = +1) -> tuple[str, str]:
        return (self.node(x, y), self.node(x + direction, y))

    def send_ring_x(self, x: int, y: int, nbytes: float, direction: int = +1) -> None:
        a, b = self.ring_x_link(x, y, direction)
        self.link(a, b).bytes_served += nbytes

    def ring_allgather_traffic(self, axis_len: int, shard_bytes: int, *, bidi: bool) -> None:
        """Count per-link bytes for a ring allgather over the x axis rings."""
        per_dir = shard_bytes // (2 if bidi else 1)
        for y in range(self.ny):
            for step in range(axis_len - 1 if not bidi else (axis_len - 1 + 1) // 2):
                for x in range(self.nx):
                    self.send_ring_x(x, y, per_dir, +1)
                    if bidi:
                        self.send_ring_x(x, y, per_dir, -1)
