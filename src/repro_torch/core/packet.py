"""Packet-level reliable Broadcast (paper §III) and the facade of the
M-chain Allgather, with the leaves' receive datapath on tensors.

Port of ``simulate_packet_broadcast`` (src/repro/core/packet.py:1058) with
the vectorized executor (``_VecBroadcastRun``, packet.py:760), on the
abstract fabric (``topology=None``) or a routed ``core/topology.py`` fabric
(``topology=``, ``hosts=``), at either DPA fidelity. Per Broadcast:

  1. The root's stream is cut into MTU chunks; their injection times come
     from one fluid flow (``core/engine.py``): on the root's send link, or
     on a topology the multicast tree ``multicast_tree(hosts[root],
     hosts)``.
  2. Every link samples a per-packet drop mask from its ``LossModel``; a
     leaf loses what any link of its root->leaf path dropped, so a drop on
     an upstream link is shared by every leaf below it. On the abstract
     fabric each leaf sits behind one carrier (its ejection hop) of its own.
     A leaf's hop latency is its path length times the link latency.
  3. The survivors, with arrival jitter, run through every leaf's worker
     pool; staging-ring (RNR) drops join the missing set.
  4. Recovery rounds: at the cutoff timer every incomplete leaf sends its
     missing bitmap as a NACK; the switches OR them (one aggregated NACK at
     the root, or one per leaf with ``aggregate_nacks=False``), and the root
     multicasts the union of missing chunks down the tree pruned to the
     NACKing leaves (a tree flow of the same engine on a topology). Repeat
     until complete.

Where the state lives. The fluid event loop and the random draws stay on
the host, in the reference's exact order: the per-link loss forks, one
mask per link per round (only the pruned tree's links in recovery), one
sized jitter draw per block of leaves, all from the caller's
``np.random.Generator`` and the links' own. The result is a function of
that stream. The leaves x chunks work runs on ``device``: a round's link
masks go there as one (links x chunks) matrix (pinned on the way to a
card) and are OR-ed along the leaves' paths one tree level at a time; the
arrival matrix, its stable sort, the pool pass (``csrc/pool.cu``), the
per-leaf missing flags and completion times, and the NACK union: every
nacker's missing row packed to u32 words (``csrc/bitmap.cu``), the rows
OR-ed, the union's size their popcount. A round is a fixed number of
launches whatever the number of leaves.

The DPA's two fidelities (``dpa_fidelity=``, reference packet.py:45):
``"scalar"``, the T-server worker pool above (``workers``, or
``engine.workers_from_dpa`` of a ``dpa.DpaConfig``), on the pool kernel;
``"event"``, the event-level progress engine of ``core/dpa_engine.py``
(``dpa=``: an ``EventDpaParams`` or a ``DpaConfig``; None gives a Table-I UD
pool with the workers' thread count). In event mode every leaf and the root
own a persistent ``DpaEventPool``: the root serves the NACKs and posts the
retransmissions on its pool, and each pass takes the sorted arrival rows
and their counts to the host once, runs the leaves' pools in leaf order
there and brings the latest done times and the staging-ring drops back. The
NACK unions stay on the card; no pool kernel runs for the leaves.

``simulate_packet_allgather`` (packet.py:1154) builds the Appendix-A
schedule graph and runs it at packet fidelity: R = ceil(P/M) generations of
up to M concurrent Broadcasts of this protocol, the round loop in
``core/sched_ir._packet_allgather``. ``recovery_overlay`` (packet.py:1183)
is the FSDP step's closed loss overlay (``core/engine.simulate_fsdp_step``).

Each result equals the reference's field for field
(``tests/test_torch_packet.py``, ``tests/test_torch_packet_allgather.py``,
``tests/test_torch_routed_packet.py`` on the CPU, ``chip_smoke.py`` on the
card against the CPU run). ``engine="reference"``, the reference's
per-leaf executor, is not ported and raises ``NotImplementedError``.
"""
from __future__ import annotations

import math
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Sequence

import numpy as np
import torch

from repro_torch.core import profiling, protocol
from repro_torch.core.dpa_engine import DpaEventPool, resolve_event_params
from repro_torch.core.engine import (Engine, FabricParams, WorkerParams,
                                     worker_pool_completion_rows)
from repro_torch.core.sched_ir import (PhaseBreakdown, _check_packet_options, _chunking,
                                      _event_rows, _rnr_barrier, _serve_nacks)
from repro_torch.device import device_of
from repro_torch.kernels import bitmap

DEFAULT_MAX_ROUNDS = 64

# Batched pool passes take leaves in blocks of at most this many matrix
# elements (rows x row length), as the reference does; its jitter draws are
# one per block.
_BLOCK_ELEMS = 1 << 24


# ------------------------------------------------------------------ loss models


class LossModel:
    """Per-link packet-loss process. A model given to a simulator is a
    template: ``fork(rng)`` derives an independently seeded per-link
    instance; ``sample(n)`` draws the drop mask of the next n packets."""

    def fork(self, rng: np.random.Generator) -> "LossModel":
        raise NotImplementedError

    def sample(self, n: int) -> np.ndarray:
        raise NotImplementedError

    def sample_runs(self, sizes: list[int]) -> np.ndarray:
        """The drop masks of consecutive ``sample`` calls of ``sizes``
        packets, concatenated."""
        if not sizes:
            return np.zeros(0, dtype=bool)
        return np.concatenate([self.sample(n) for n in sizes])

    @property
    def mean_rate(self) -> float:
        raise NotImplementedError


class BernoulliLoss(LossModel):
    """i.i.d. per-packet drops at a fixed rate."""

    def __init__(self, rate: float, rng: np.random.Generator | None = None):
        if not 0.0 <= rate < 1.0:
            raise ValueError(f"loss rate must be in [0, 1), got {rate}")
        self.rate = float(rate)
        self._rng = rng

    def fork(self, rng: np.random.Generator) -> "BernoulliLoss":
        return BernoulliLoss(self.rate, np.random.default_rng(int(rng.integers(1 << 62))))

    def sample(self, n: int) -> np.ndarray:
        if self.rate == 0.0:
            return np.zeros(n, dtype=bool)
        if self._rng is None:
            raise RuntimeError("sample() on an unforked template")
        return self._rng.random(n) < self.rate

    def sample_runs(self, sizes: list[int]) -> np.ndarray:
        # numpy's uniform fills split: one draw of the total is bitwise the
        # draws one after another
        return self.sample(sum(sizes))

    @property
    def mean_rate(self) -> float:
        return self.rate


class GilbertElliottLoss(LossModel):
    """Two-state bursty channel: GOOD drops with prob e_good, BAD with e_bad;
    per-packet transitions p_gb (good->bad) and p_bg (bad->good). Sojourns
    are geometric and sampled run by run; the state persists across
    ``sample`` calls, so bursts straddle recovery rounds."""

    def __init__(self, p_gb: float, p_bg: float, *, e_good: float = 0.0,
                 e_bad: float = 1.0, rng: np.random.Generator | None = None):
        if not (0.0 < p_gb <= 1.0 and 0.0 < p_bg <= 1.0):
            raise ValueError(f"transition probabilities must be in (0, 1], got {p_gb}, {p_bg}")
        if not (0.0 <= e_good <= 1.0 and 0.0 <= e_bad <= 1.0):
            raise ValueError(f"drop probabilities must be in [0, 1], got {e_good}, {e_bad}")
        self.p_gb, self.p_bg = float(p_gb), float(p_bg)
        self.e_good, self.e_bad = float(e_good), float(e_bad)
        self._rng = rng
        self._bad = False
        if rng is not None:  # start at the stationary distribution
            pi_bad = self.p_gb / (self.p_gb + self.p_bg)
            self._bad = bool(rng.random() < pi_bad)

    @classmethod
    def from_rate(cls, rate: float, mean_burst: float = 8.0,
                  e_good: float = 0.0) -> "GilbertElliottLoss":
        """Bursts with a target mean loss rate: BAD drops everything and
        lasts ``mean_burst`` packets on average."""
        if not (0.0 < rate < 1.0 and mean_burst >= 1.0):
            raise ValueError(f"need 0 < rate < 1 and mean_burst >= 1, got {rate}, {mean_burst}")
        p_bg = 1.0 / mean_burst
        p_gb = min(p_bg * rate / (1.0 - rate), 1.0)
        return cls(p_gb, p_bg, e_good=e_good, e_bad=1.0)

    def fork(self, rng: np.random.Generator) -> "GilbertElliottLoss":
        return GilbertElliottLoss(
            self.p_gb, self.p_bg, e_good=self.e_good, e_bad=self.e_bad,
            rng=np.random.default_rng(int(rng.integers(1 << 62))))

    def sample(self, n: int) -> np.ndarray:
        if self._rng is None:
            raise RuntimeError("sample() on an unforked template")
        drops = np.empty(n, dtype=bool)
        i = 0
        while i < n:
            leave = self.p_bg if self._bad else self.p_gb
            run = int(self._rng.geometric(leave))
            take = min(run, n - i)
            e = self.e_bad if self._bad else self.e_good
            if e <= 0.0:
                drops[i:i + take] = False
            elif e >= 1.0:
                drops[i:i + take] = True
            else:
                drops[i:i + take] = self._rng.random(take) < e
            i += take
            if take == run:          # the sojourn ended inside this block
                self._bad = not self._bad
        return drops

    @property
    def mean_rate(self) -> float:
        pi_bad = self.p_gb / (self.p_gb + self.p_bg)
        return (1.0 - pi_bad) * self.e_good + pi_bad * self.e_bad


def resolve_loss(loss, fabric: FabricParams) -> LossModel | None:
    """``loss=`` -> template: a LossModel passes through, a float is a
    Bernoulli rate, None falls back to fabric.p_drop (0 -> lossless)."""
    if loss is None:
        return BernoulliLoss(fabric.p_drop) if fabric.p_drop > 0 else None
    if isinstance(loss, LossModel):
        return loss
    rate = float(loss)
    return BernoulliLoss(rate) if rate > 0 else None


def rc_goodput_inflation(mean_rate: float, path_len: float) -> float:
    """Reliable-unicast (RC) transport retransmits in hardware (go-back-N),
    so loss is a deterministic goodput inflation: the extra wire-time
    fraction 1/(1-q_path) - 1 of a path crossing ``path_len`` lossy links of
    mean rate ``mean_rate`` (reference packet.py:248). The FSDP "naive"
    overlay and the ring schedules at packet fidelity share it."""
    q_path = 1.0 - (1.0 - mean_rate) ** path_len
    return 1.0 / (1.0 - q_path) - 1.0


def attach_loss(topology, template: LossModel, rng: np.random.Generator,
                predicate=None) -> int:
    """Fork ``template`` onto every fabric Link (or those whose name
    satisfies ``predicate``); returns the number of links armed. An armed
    link keeps its model, and a Gilbert-Elliott model its burst state,
    across simulator calls on the same fabric."""
    n = 0
    for link in topology.links().values():
        if predicate is None or predicate(link.name):
            link.loss = template.fork(rng)
            n += 1
    return n


class _AbstractCarrier:
    """Loss carrier of the abstract fabric: the one hop between the root's
    send link and one leaf."""

    __slots__ = ("loss",)

    def __init__(self):
        self.loss = None


# ------------------------------------------------------------- tree plumbing


def tree_paths(tree_links: Sequence, root_name: str,
               leaf_names: Sequence[str]) -> dict[str, list]:
    """Each leaf's ordered root->leaf Link path inside a multicast tree's
    edge set (an arborescence, so the path is unique; reference
    packet.py:276)."""
    children = defaultdict(list)
    for link in tree_links:
        if link.src is None or link.dst is None:
            raise ValueError(f"tree link without endpoints: {link}")
        children[link.src].append(link)
    want = set(leaf_names)
    paths: dict[str, list] = {}
    stack = [(root_name, [])]
    while stack:
        node, acc = stack.pop()
        if node in want:
            paths[node] = acc
        for link in children[node]:
            stack.append((link.dst, acc + [link]))
    missing = want - set(paths)
    if missing:
        raise ValueError(f"leaves unreachable in tree: {sorted(missing)}")
    return paths


def _sample_link_round(link_models: dict[int, LossModel | None],
                       n: int) -> dict[int, np.ndarray]:
    """One drop mask per distinct link for the round's n packets, in the
    dict's order: drawn once per link, not per leaf, so that a drop upstream
    is shared by every leaf below it."""
    if profiling.ENABLED:
        with profiling.phase("rng"):
            zeros = np.zeros(n, dtype=bool)
            return {lid: (m.sample(n) if m is not None else zeros)
                    for lid, m in link_models.items()}
    zeros = np.zeros(n, dtype=bool)
    return {lid: (m.sample(n) if m is not None else zeros) for lid, m in link_models.items()}


def _leaf_lost(path: list, masks: dict[int, np.ndarray], n: int) -> np.ndarray:
    """What one leaf lost: the OR of its path's link masks."""
    lost = np.zeros(n, dtype=bool)
    for link in path:
        lost |= masks[id(link)]
    return lost


def _mask_rows(n_rows: int, width: int, device: torch.device) -> torch.Tensor:
    """A zeroed (n_rows + 1, width) bool matrix on the host for link masks,
    pinned when it goes to a card; its last row stays zero, the padding of
    paths shorter than the deepest."""
    return torch.zeros((n_rows + 1, width), dtype=torch.bool,
                       pin_memory=device.type == "cuda")


def _jitter_on(rng: np.random.Generator, jitter: float, n: int,
               device: torch.device) -> torch.Tensor:
    """``rng.uniform(0.0, jitter, size=n)`` on ``device``, drawn into a host
    buffer that is pinned on the way to a card. numpy's uniform is ``0.0 +
    jitter * u`` of the generator's next doubles ``u``, so ``random(out=)``
    scaled by ``jitter`` is bitwise the same draws, the same stream
    consumed."""
    buf = torch.empty(n, dtype=torch.float64, pin_memory=device.type == "cuda")
    view = buf.numpy()
    if profiling.ENABLED:
        with profiling.phase("rng"):
            rng.random(out=view)
    else:
        rng.random(out=view)
    view *= jitter
    return buf.to(device, non_blocking=True)


def _or_levels(rows: torch.Tensor, idx: np.ndarray, device: torch.device) -> torch.Tensor:
    """OR of mask rows along paths, on ``device``: ``rows`` (R + 1, n) bool
    on the host, copied once; ``idx`` (..., D) each path's row per tree
    level, a shorter path padded with the zero row R. One gather and one OR
    a level. Returns (..., n)."""
    mat = rows.to(device, non_blocking=True)
    ix = torch.from_numpy(np.ascontiguousarray(idx)).to(device)
    lost = mat[ix[..., 0]]
    for d in range(1, idx.shape[-1]):
        lost |= mat[ix[..., d]]
    return lost


def _stacked_lost(paths: dict, masks: dict[int, np.ndarray], leaves, n: int,
                  device: torch.device | None = None) -> torch.Tensor:
    """(len(leaves), n) bool on ``device`` (default the CPU): row k is
    ``_leaf_lost(paths[leaves[k]])``, the reference's batch form
    (packet.py:371). The masks are stacked into one (links x chunks)
    matrix in the dict's order and OR-ed along every leaf's path one tree
    level at a time; the abstract fabric is the case of one carrier a
    leaf."""
    dev = torch.device("cpu") if device is None else device
    row_of = {lid: k for k, lid in enumerate(masks)}
    rows = _mask_rows(len(row_of), n, dev)
    view = rows.numpy()
    for k, m in enumerate(masks.values()):
        view[k] = m
    depth = max((len(paths[lf]) for lf in leaves), default=0)
    idx = np.full((len(leaves), max(depth, 1)), len(row_of), dtype=np.int64)
    for k, lf in enumerate(leaves):
        idx[k, :len(paths[lf])] = [row_of[id(link)] for link in paths[lf]]
    return _or_levels(rows, idx, dev)


def _models_on_paths(paths: dict, models: dict[int, LossModel | None],
                     leaves) -> dict[int, LossModel | None]:
    """The models of the links on the given leaves' paths, in first-seen
    order: the links a pruned retransmit tree crosses."""
    return {id(link): models[id(link)] for leaf in leaves for link in paths[leaf]}


def _link_models(paths: dict[str, list], template: LossModel | None,
                 rng: np.random.Generator,
                 cache: dict[int, LossModel | None] | None = None,
                 ) -> dict[int, LossModel | None]:
    """Each link's loss process (reference packet.py:404): a Link armed by
    ``attach_loss`` keeps its own; any other forks ``template`` once. The
    forks go in ``sorted(paths)`` order, and the keys are host names on a
    topology, so "h10" forks before "h2". ``cache`` shares the forks across
    callers: the M chains of an Allgather that cross one Link see one loss
    process, whose state persists across rounds and generations."""
    out: dict[int, LossModel | None] = {}
    for leaf in sorted(paths):
        for link in paths[leaf]:
            lid = id(link)
            if lid in out:
                continue
            if cache is not None and lid in cache:
                out[lid] = cache[lid]
                continue
            model = getattr(link, "loss", None)
            if model is None and template is not None:
                model = template.fork(rng)
            out[lid] = model
            if cache is not None:
                cache[lid] = model
    return out


# --------------------------------------------------------------- NACK + DPA


def _nack_wire_bytes(n_chunks: int, mtu: int) -> int:
    """One (aggregated) NACK on the wire: an MTU header datagram plus the
    packed missing bitmap (1 bit per chunk)."""
    return mtu + protocol.bitmap_bytes(n_chunks * mtu, mtu)


def _nack_service(n_chunks: int, workers: WorkerParams, mtu: int) -> float:
    """Scalar-DPA service time of one NACK message."""
    return _nack_wire_bytes(n_chunks, mtu) / workers.thread_tput


@dataclass
class RoundTrace:
    """One NACK/retransmission round of one Broadcast."""
    nack_leaves: int                  # receivers still incomplete
    root_nack_msgs: int               # NACKs the root DPA actually served
    union_chunks: int                 # |union of missing| = retransmit size
    t_nack_root: float                # aggregated NACK arrival at the root
    t_retx_start: float               # retransmit flow injection start
    t_end: float                      # last delivery of the round
    recovered: int                    # chunks recovered this round


@dataclass
class PacketBcastResult:
    """The reference's result: bytes_fast + bytes_recovery == bytes_total on
    completion, plus the per-round recovery trace. Host values (numpy)."""
    completion: np.ndarray
    phases: PhaseBreakdown
    delivered_fast: int
    recovered: int
    rnr_drops: int
    bytes_fast: int
    bytes_recovery: int
    bytes_total: int
    link_bytes: dict[str, float] = field(default_factory=dict)
    rounds: list[RoundTrace] = field(default_factory=list)
    retransmit_wire_bytes: int = 0    # root-injected recovery traffic
    duplicates: int = 0               # retransmitted chunks a leaf already had
    completed: bool = True
    delivery_order: dict[int, np.ndarray] = field(default_factory=dict)
    # ^ collect_delivery=True only: per-leaf PSNs in staging-ring arrival
    #   order (fast path, then recovery rounds): the scatter order that
    #   protocol.reassemble replays

    @property
    def time(self) -> float:
        return float(self.completion.max(initial=0.0))

    @property
    def recovery_time(self) -> float:
        return self.phases.reliability


# ------------------------------------------------------------ broadcast core


class _BroadcastRun:
    """One packet Broadcast: the fast path plus NACK/retransmission rounds
    on an Engine, the leaves' state as tensors on ``device``:

      missing  (L, n) bool   chunk j still missing at leaf row k
      tdone    (L,) f64      time the leaf's pool last drained

    Rows are the leaves in ascending rank order (the root excluded). Each
    leaf's path is its root->leaf links in the multicast tree on a
    topology, or its one carrier on the abstract fabric; ``models`` holds
    every link's loss process in the reference's order."""

    def __init__(self, p: int, n_bytes: int, fabric: FabricParams, workers: WorkerParams,
                 rng: np.random.Generator, root: int, eng: Engine, device: torch.device, *,
                 topology=None, hosts=None, loss=None, aggregate_nacks: bool = True,
                 tag: str = "mcast", collect_delivery: bool = False,
                 dpa_fidelity: str = "scalar", dpa=None):
        self.p, self.fabric, self.workers, self.rng = p, fabric, workers, rng
        self.root, self.eng, self.dev = root, eng, device
        self.topology, self.aggregate = topology, aggregate_nacks
        self.n_chunks, self.chunk = _chunking(n_bytes, fabric.mtu)
        self.service = self.chunk / workers.thread_tput
        self.tag = tag
        template = resolve_loss(loss, fabric)
        if topology is not None:
            self.hosts = list(hosts) if hosts is not None else list(range(p))
            if len(self.hosts) != p:
                raise ValueError(f"{len(self.hosts)} hosts for {p} ranks")
            self.tree = topology.multicast_tree(self.hosts[root], self.hosts)
            names = {leaf: topology.host(self.hosts[leaf]) for leaf in range(p) if leaf != root}
            by_name = tree_paths(self.tree, topology.host(self.hosts[root]),
                                 list(names.values()))
            self.paths = {leaf: by_name[name] for leaf, name in names.items()}
            # forked in the order of the leaves' host names (a string sort)
            self.models = _link_models({names[leaf]: self.paths[leaf] for leaf in names},
                                       template, rng)
        else:
            self.tree = None
            self.paths = {leaf: [_AbstractCarrier()] for leaf in range(p) if leaf != root}
            # one independent loss process per leaf, forked in leaf order
            self.models = {id(c): (template.fork(rng) if template is not None else None)
                           for leaf in sorted(self.paths) for c in self.paths[leaf]}
        self.leaf_ids = sorted(self.paths)
        n_leaves = len(self.leaf_ids)
        if dpa_fidelity == "event":
            # one DPA progress engine per NIC, persistent across rounds (leaf
            # rows, then the root's): the root's NACK service and retransmit
            # posting run on its contexts
            params = resolve_event_params(dpa, workers.n_recv_workers)
            self.pools = [DpaEventPool(params) for _ in self.leaf_ids]
            self.root_pool = DpaEventPool(params)
        else:
            self.pools = self.root_pool = None
        # a link armed by attach_loss carries loss without a template
        self._lossless = all(m is None for m in self.models.values())
        # after the forks the rng feeds only jitter draws; at jitter == 0 each
        # draw is exactly 0.0 and x + 0.0 == x, so they are skipped (the
        # reference's vectorized engine does the same)
        self._skip_jitter = fabric.jitter == 0.0
        # hop latency: the path's length in links (one abstract hop)
        self.hop = np.array([len(self.paths[leaf]) * fabric.latency for leaf in self.leaf_ids])
        self._hop = torch.from_numpy(self.hop).to(device)
        self.missing = torch.zeros((n_leaves, self.n_chunks), dtype=torch.bool, device=device)
        self.tdone = torch.zeros(n_leaves, dtype=torch.float64, device=device)
        self.rounds: list[RoundTrace] = []
        self.rnr_total = 0
        self.duplicates = 0
        self.retransmit_wire = 0
        self.t_fast_end = 0.0
        self.t_rel_end = 0.0
        self._cutoff = 0.0
        # per round: (leaf rows, PSNs delivered in arrival order with -1 for
        # what was not delivered), kept only on request
        self.delivery: list[tuple[np.ndarray, np.ndarray]] | None = (
            [] if collect_delivery else None)

    def _draw_jitter(self, total: int) -> torch.Tensor | None:
        if self._skip_jitter:
            return None
        return _jitter_on(self.rng, self.fabric.jitter, total, self.dev)

    def _receive(self, rows: torch.Tensor, cols: torch.Tensor, inject: torch.Tensor,
                 wanted: torch.Tensor, lost: torch.Tensor | None):
        """One pool pass for a block of leaf rows. Column c of the block is
        chunk ``cols[c]``, injected at ``inject[c]``; ``wanted`` (B, w) marks
        the chunks each row receives this round, ``lost`` (B, w) the ones its
        link dropped. Updates the rows' missing flags and returns (t_last
        (B,) with NaN for a row that received nothing, arrived (B,), rnr
        drops (B,))."""
        arrived = wanted if lost is None else wanted & ~lost
        counts = arrived.sum(1)
        arr = inject[None, :] + self._hop[rows][:, None]
        arr = torch.where(arrived, arr, math.inf)
        jit = self._draw_jitter(int(counts.sum()))
        if jit is not None:
            # the draws follow the arrivals in row-major order, as the
            # reference's flattened (row, psn) runs do
            arr[arrived] = arr[arrived] + jit
            key = arr
        else:
            # without jitter a row's arrivals ascend with the PSN already:
            # just move them to the front, in order
            key = (~arrived).to(torch.uint8)
        order = torch.sort(key, dim=1, stable=True).indices
        arr = arr.gather(1, order)
        if self.pools is None:
            done, rnr = worker_pool_completion_rows(arr, self.workers.n_recv_workers,
                                                    self.service, self.workers.staging_chunks)
            last = (counts - 1).clamp(min=0)
            t_last = torch.where(counts > 0, done.gather(1, last[:, None])[:, 0], math.nan)
        else:
            # the leaves' event pools, in leaf order on the host
            t_last, rnr = _event_rows([self.pools[r] for r in rows.cpu().tolist()], arr, counts,
                                      self.chunk, self.workers.staging_chunks)
        # staging-ring drops join what the link lost
        rnr_cols = torch.zeros_like(rnr).scatter_(1, order, rnr)
        still = rnr_cols if lost is None else (wanted & lost) | rnr_cols
        self.missing[rows[:, None], cols[None, :]] = still
        if self.delivery is not None:
            pos = torch.arange(arr.shape[1], device=self.dev)
            got = (pos[None, :] < counts[:, None]) & ~rnr
            psn = torch.where(got, cols[order], -1).to(torch.int32)
            self.delivery.append((rows.cpu().numpy(), psn.cpu().numpy()))
        return t_last, counts, rnr.sum(1)

    # -- round 0: the multicast fast path
    def submit_fast(self, t_start: float):
        nbytes = self.n_chunks * self.chunk
        if self.tree is not None:
            self.flow = self.eng.submit_tree(self.tree, nbytes, t_start=t_start, tag=self.tag)
        else:
            link = self.eng.add_link(f"{self.tag}.root{self.root}.send", self.fabric.b_link)
            self.flow = self.eng.submit(link, nbytes, t_start=t_start, tag=self.tag)
        self.t_start = t_start
        return self.flow

    def deliver_fast(self) -> None:
        """The engine has run: sample every leaf's drops, push the survivors
        through every leaf's pool, record the missing sets (call once)."""
        n, n_leaves = self.n_chunks, len(self.leaf_ids)
        inject_np = self.flow.chunk_times(n, self.chunk)
        inject = torch.from_numpy(inject_np).to(self.dev)
        self._cutoff = self.flow.t_end + self.fabric.alpha
        masks = _sample_link_round(self.models, n)
        cols = torch.arange(n, device=self.dev)
        if n_leaves and self._lossless and self._skip_jitter and self.pools is None:
            # no loss, no jitter, a memoryless pool: every leaf at one hop
            # latency sees the same arrival row, so one pool pass a distinct
            # latency serves all
            hops, group = np.unique(self.hop, return_inverse=True)
            done, rnr = worker_pool_completion_rows(
                inject[None, :] + torch.from_numpy(hops).to(self.dev)[:, None],
                self.workers.n_recv_workers, self.service, self.workers.staging_chunks)
            grp = torch.from_numpy(group).to(self.dev)
            t_last = done[:, -1]
            self.rnr_total += int(rnr.sum(1)[grp].sum())
            self.missing[:] = rnr[grp]
            if self.delivery is not None:
                psn = torch.where(rnr, -1, cols).to(torch.int32).cpu().numpy()
                self.delivery.append((np.arange(n_leaves), psn[group]))
            self.tdone[:] = t_last[grp]
            self.t_fast_end = max(self.t_fast_end, float(t_last.max()))
        else:
            lost_all = None if self._lossless else _stacked_lost(
                self.paths, masks, self.leaf_ids, n, self.dev)
            blk = max(1, _BLOCK_ELEMS // max(n, 1))
            wanted = torch.ones((min(blk, n_leaves), n), dtype=torch.bool, device=self.dev)
            for s0 in range(0, n_leaves, blk):
                s1 = min(s0 + blk, n_leaves)
                rows = torch.arange(s0, s1, device=self.dev)
                lost = None if lost_all is None else lost_all[s0:s1]
                t_last, _, rnr = self._receive(rows, cols, inject, wanted[: s1 - s0], lost)
                tdone = torch.where(torch.isnan(t_last), self.t_start, t_last)
                self.tdone[s0:s1] = tdone
                self.rnr_total += int(rnr.sum())
                self.t_fast_end = max(self.t_fast_end, float(tdone.max()))
        self.t_fast_end = max(self.t_fast_end, self.flow.t_end)

    # -- recovery rounds
    def incomplete(self) -> torch.Tensor:
        """Rows of the leaves still missing a chunk, ascending."""
        return self.missing.any(1).nonzero()[:, 0]

    def plan_retransmit(self):
        """This round's NACK aggregation and retransmit flow: None when every
        leaf is complete, else the meta tuple (flow first) for
        ``deliver_retransmit`` once the engine has run it."""
        nackers = self.incomplete()
        if nackers.numel() == 0:
            return None
        n = self.n_chunks
        # union of missing: every nacker's missing row packed to the u32
        # NACK wire words, the rows OR-ed (what the switches do hop by hop)
        flags = torch.zeros((nackers.numel(), n + (-n) % 32), dtype=torch.bool,
                            device=self.dev)
        flags[:, :n] = self.missing[nackers]
        if profiling.ENABLED:
            with profiling.phase("packing"):
                agg = bitmap.bitmap_or_rows(bitmap.bitmap_pack(flags))
        else:
            agg = bitmap.bitmap_or_rows(bitmap.bitmap_pack(flags))
        n_union = int(bitmap.bitmap_popcount(agg))
        union = bitmap.bitmap_unpack(agg, n).nonzero()[:, 0]
        # NACK ascent: a leaf declares loss at the cutoff timer (or when its
        # pool drained, if later) and sends its bitmap up the tree
        idx = nackers.cpu().numpy()
        t_send = np.maximum(self.tdone[nackers].cpu().numpy(), self._cutoff) + self.hop[idx]
        if self.aggregate:
            arrivals = np.array([t_send.max()])   # the root serves ONE aggregated NACK
        else:
            arrivals = np.sort(t_send)
        leaves = [self.leaf_ids[k] for k in idx.tolist()]
        return self._submit_retransmit(union, n_union, nackers, leaves, arrivals)

    def _submit_retransmit(self, union: torch.Tensor, n_union: int, nackers: torch.Tensor,
                           leaves: list[int], arrivals: np.ndarray):
        """Root side of a round: serve the NACK arrivals on the root's pool,
        then inject the union: a flow on the root's send link, or on a
        topology a tree flow down the tree pruned to the root and the
        nackers."""
        if n_union == 0:
            raise RuntimeError("a NACK round with an empty union")
        fab, wk = self.fabric, self.workers
        t_root_done, t_retx = _serve_nacks(
            self.root_pool, arrivals, wk, _nack_service(self.n_chunks, wk, fab.mtu),
            _nack_wire_bytes(self.n_chunks, fab.mtu), n_union, self.chunk, self.eng.now)
        if self.tree is not None:
            members = [self.hosts[self.root]] + [self.hosts[leaf] for leaf in leaves]
            rtree = self.topology.multicast_tree(self.hosts[self.root], members)
            flow = self.eng.submit_tree(rtree, n_union * self.chunk, t_start=t_retx,
                                        tag=f"{self.tag}.retx")
        else:
            flow = self.eng.submit(f"{self.tag}.root{self.root}.send", n_union * self.chunk,
                                   t_start=t_retx, tag=f"{self.tag}.retx")
        return (flow, union, n_union, nackers, leaves, arrivals, float(t_root_done))

    def deliver_retransmit(self, meta) -> None:
        flow, union, u, nackers, leaves, arrivals, t_root_done = meta
        inject = torch.from_numpy(flow.chunk_times(u, self.chunk)).to(self.dev)
        # sample ONLY the links of the pruned tree, the nackers' paths:
        # advancing a loss process (a GE chain) on a link that carries no
        # retransmission would shift its bursts
        pruned = _models_on_paths(self.paths, self.models, leaves)
        masks = _sample_link_round(pruned, u)
        lost_all = (_stacked_lost(self.paths, masks, leaves, u, self.dev)
                    if any(m is not None for m in pruned.values()) else None)
        recovered_round = 0
        t_round_end = t_root_done
        blk = max(1, _BLOCK_ELEMS // max(u, 1))
        for s0 in range(0, nackers.numel(), blk):
            s1 = min(s0 + blk, nackers.numel())
            rows = nackers[s0:s1]
            wanted = self.missing[rows][:, union]          # the union covers every miss
            self.duplicates += int((s1 - s0) * u - int(wanted.sum()))
            lost = None if lost_all is None else lost_all[s0:s1]
            t_last, counts, rnr = self._receive(rows, union, inject, wanted, lost)
            self.rnr_total += int(rnr.sum())
            recovered_round += int(counts.sum()) - int(rnr.sum())
            got = ~torch.isnan(t_last)
            self.tdone[rows[got]] = t_last[got]
            if bool(got.any()):
                t_round_end = max(t_round_end, float(t_last[got].max()))
        self._cutoff = flow.t_end + self.fabric.alpha
        self.t_rel_end = max(self.t_rel_end, t_round_end)
        self.rounds.append(RoundTrace(
            nack_leaves=int(nackers.numel()),
            root_nack_msgs=int(arrivals.shape[0]),
            union_chunks=u,
            t_nack_root=float(arrivals.max()),
            t_retx_start=float(flow.t_start),
            t_end=t_round_end,
            recovered=recovered_round,
        ))
        self.retransmit_wire += u * self.chunk

    def completion(self) -> np.ndarray:
        out = np.zeros(self.p)
        out[self.leaf_ids] = self.tdone.cpu().numpy()
        out[self.root] = self.flow.t_end
        return out

    def delivery_order(self) -> dict[int, np.ndarray]:
        parts: dict[int, list[np.ndarray]] = {leaf: [] for leaf in self.leaf_ids}
        for rows, psn in self.delivery:
            for k, row in zip(rows.tolist(), psn):
                parts[self.leaf_ids[k]].append(row[row >= 0].astype(np.intp))
        return {leaf: (np.concatenate(got) if got else np.empty(0, dtype=np.intp))
                for leaf, got in parts.items()}

    def stats(self) -> dict:
        n_total = (self.p - 1) * self.n_chunks
        recovered = sum(tr.recovered for tr in self.rounds)
        return {"delivered_fast": n_total - recovered - int(self.missing.sum()),
                "recovered": recovered}


def simulate_packet_broadcast(
        p: int, n_bytes: int, fabric: FabricParams, workers: WorkerParams,
        rng: np.random.Generator, root: int = 0, *, topology=None,
        hosts=None, loss=None, max_rounds: int = DEFAULT_MAX_ROUNDS,
        aggregate_nacks: bool = True, collect_delivery: bool = False,
        dpa_fidelity: str = "scalar", dpa=None, engine: str = "auto",
        device=None) -> PacketBcastResult:
    """Packet-fidelity reliable Broadcast on the abstract fabric or, with
    ``topology=`` (ranks on ``hosts``, default 0..P-1), routed down the
    multicast tree, equal field for field to the reference's on the same
    arguments and generator (``link_bytes`` the routed engine run's).
    ``dpa_fidelity="event"`` swaps the scalar worker pool for the event-level
    DPA progress engine (``dpa=``: its ``EventDpaParams`` or ``DpaConfig``).
    The leaves' receive datapath runs on ``device`` (default ``cuda``; pass
    ``device="cpu"`` for the plain versions)."""
    _check_packet_options(dpa_fidelity, dpa, engine)
    if not 0 <= root < p:
        raise ValueError(f"root {root} outside 0..{p - 1}")
    dev = device_of("cuda" if device is None else device)
    t_rnr = _rnr_barrier(p, fabric, workers)
    eng = Engine(device=dev)
    if topology is not None:
        topology.reset()
    run = _BroadcastRun(p, n_bytes, fabric, workers, rng, root, eng, dev, topology=topology,
                        hosts=hosts, loss=loss, aggregate_nacks=aggregate_nacks,
                        collect_delivery=collect_delivery, dpa_fidelity=dpa_fidelity, dpa=dpa)
    run.submit_fast(t_rnr)
    eng.run()
    run.deliver_fast()

    n_rounds = 0
    while n_rounds < max_rounds:
        meta = run.plan_retransmit()
        if meta is None:
            break
        eng.run()
        run.deliver_retransmit(meta)
        n_rounds += 1
    completed = run.incomplete().numel() == 0

    completion = run.completion()
    # final handshake: send final to the left, need final from the right (§III-C)
    completion = np.maximum(completion, np.roll(completion, -1)) + fabric.latency
    st = run.stats()
    phases = PhaseBreakdown(
        rnr_sync=t_rnr,
        multicast=run.t_fast_end - t_rnr,
        reliability=max(run.t_rel_end - run.t_fast_end, 0.0),
        handshake=fabric.latency,
    )
    return PacketBcastResult(
        completion=completion,
        phases=phases,
        delivered_fast=st["delivered_fast"],
        recovered=st["recovered"],
        rnr_drops=run.rnr_total,
        bytes_fast=st["delivered_fast"] * run.chunk,
        bytes_recovery=st["recovered"] * run.chunk,
        bytes_total=(p - 1) * run.n_chunks * run.chunk,
        link_bytes=eng.link_bytes() if topology is not None else {},
        rounds=run.rounds,
        retransmit_wire_bytes=run.retransmit_wire,
        duplicates=run.duplicates,
        completed=completed,
        delivery_order=run.delivery_order() if run.delivery is not None else {},
    )


# ------------------------------------------------------------ allgather


@dataclass
class PacketAllgatherResult:
    """The reference's result (packet.py:1137): the fields of its
    ``sched_ir.AllgatherResult`` plus the per-chain round traces. Host
    values."""
    time: float
    phases: PhaseBreakdown
    recovered: int
    bytes_fast: int
    bytes_recovery: int
    bytes_total: int
    per_rank_recv_tput: float
    link_bytes: dict[str, float] = field(default_factory=dict)
    rounds: list[RoundTrace] = field(default_factory=list)
    rnr_drops: int = 0
    retransmit_wire_bytes: int = 0
    completed: bool = True


def simulate_packet_allgather(
        p: int, n_bytes: int, fabric: FabricParams, workers: WorkerParams,
        rng: np.random.Generator, n_chains: int = 1, *, topology=None,
        hosts=None, loss=None, max_rounds: int = DEFAULT_MAX_ROUNDS,
        aggregate_nacks: bool = True, dpa_fidelity: str = "scalar",
        dpa=None, engine: str = "auto", device=None) -> PacketAllgatherResult:
    """Packet-fidelity M-chain Allgather on the abstract fabric or a routed
    topology (reference packet.py:1154): builds the Appendix-A schedule graph
    (``sched_ir.build_allgather``, uneven chains too) and executes it at
    packet fidelity (``sched_ir._packet_allgather``). Equal field for field
    to the reference's on the same arguments and generator.
    ``dpa_fidelity="event"`` gives every host a persistent event-level DPA; a
    chain root's NACK service and retransmit posting then run on the
    contexts that receive the other chains. The leaves' receive datapath
    runs on ``device`` (default ``cuda``; pass ``device="cpu"`` for the
    plain versions)."""
    from repro_torch.core import sched_ir

    sched = sched_ir.build_allgather(p, n_bytes, n_chains)
    return sched_ir.execute(sched, fabric, workers, rng, fidelity="packet",
                            topology=topology, hosts=hosts, loss=loss, max_rounds=max_rounds,
                            aggregate_nacks=aggregate_nacks, dpa_fidelity=dpa_fidelity,
                            dpa=dpa, engine=engine, device=device)


# --------------------------------------------- FSDP overlay (closed timing)


def recovery_overlay(paths: dict, models: dict[int, LossModel | None],
                     n_chunks: int, chunk: int, bottleneck_rate: float,
                     fabric: FabricParams, workers: WorkerParams,
                     rng: np.random.Generator, *,
                     max_rounds: int = DEFAULT_MAX_ROUNDS,
                     aggregate_nacks: bool = True) -> float:
    """The extra completion time a loss process adds to a tree flow that is
    already timed (reference packet.py:1183, the FSDP step's packet
    overlay): sampled NACK / retransmission rounds, the retransmit stream
    served at the tree's bottleneck rate, without entering the max-min
    allocation again. Host numpy: the masks of one tree's links, one
    round at a time."""
    missing = {}
    masks = _sample_link_round(models, n_chunks)
    for leaf, path in paths.items():
        lost = _leaf_lost(path, masks, n_chunks)
        if lost.any():
            missing[leaf] = lost
    extra = 0.0
    depth = max((len(p) for p in paths.values()), default=1)
    for _ in range(max_rounds):
        if not missing:
            break
        union = np.zeros(n_chunks, dtype=bool)
        for lost in missing.values():
            union |= lost
        n_union = int(union.sum())
        n_msgs = 1 if aggregate_nacks else len(missing)
        # ceil(msgs / workers) service batches: one aggregated NACK is one
        # full service on one worker
        batches = -(-n_msgs // max(workers.n_recv_workers, 1))
        t_nack = fabric.alpha + depth * fabric.latency \
            + batches * _nack_service(n_chunks, workers, fabric.mtu)
        t_retx = n_union * chunk / bottleneck_rate + depth * fabric.latency
        extra += t_nack + t_retx
        rmasks = _sample_link_round(_models_on_paths(paths, models, sorted(missing)), n_union)
        upos = np.nonzero(union)[0]
        nxt = {}
        for leaf, lost in missing.items():
            pos = np.searchsorted(upos, np.nonzero(lost)[0])
            still = _leaf_lost(paths[leaf], rmasks, n_union)[pos]
            if still.any():
                again = np.zeros(n_chunks, dtype=bool)
                again[np.nonzero(lost)[0][still]] = True
                nxt[leaf] = again
        missing = nxt
    return extra
