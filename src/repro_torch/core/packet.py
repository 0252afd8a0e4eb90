"""Packet-level reliable Broadcast (paper §III), with the leaves' receive
datapath on tensors.

Port of ``simulate_packet_broadcast`` (src/repro/core/packet.py:1058) in the
abstract-fabric mode (``topology=None``), scalar DPA fidelity and the
vectorized executor (``_VecBroadcastRun``, packet.py:760). Per Broadcast:

  1. The root's stream is cut into MTU chunks; their injection times come
     from one fluid flow on the root's send link (``core/engine.py``).
  2. Every leaf sits behind one pseudo-link of independent loss (its
     ejection hop): a per-leaf ``LossModel`` draws its drop mask.
  3. The survivors, with arrival jitter, run through every leaf's worker
     pool; staging-ring (RNR) drops join the missing set.
  4. Recovery rounds: at the cutoff timer every incomplete leaf sends its
     missing bitmap as a NACK; the switches OR them (one aggregated NACK at
     the root, or one per leaf with ``aggregate_nacks=False``), and the root
     multicasts the union of missing chunks. Repeat until complete.

Where the state lives. The fluid event loop and the random draws stay on
the host, in the reference's exact order: the per-leaf loss forks, one
mask per leaf per round, one sized jitter draw per block of leaves, all
from the caller's ``np.random.Generator``. The result is a function of that
stream. The leaves x chunks work runs on ``device``: the arrival matrix,
its stable sort, the pool pass (``csrc/pool.cu``), the per-leaf missing
flags (one (leaves, chunks) bool matrix) and completion times, and the NACK
union: every nacker's missing row packed to u32 words (``csrc/bitmap.cu``),
the rows OR-ed, the union's size their popcount. A round is a fixed number
of launches whatever the number of leaves.

The result equals the reference's field for field (``tests/test_torch_packet.py``
on the CPU, ``chip_smoke.py`` on the card against the CPU run). Options of
the reference that are not ported raise ``NotImplementedError``: routed
fabrics (``topology=``/``hosts=``), ``dpa_fidelity="event"`` and
``engine="reference"`` (ROADMAP.md).
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.core import protocol
from repro_torch.core.engine import Engine, FabricParams, WorkerParams, worker_pool_completion
from repro_torch.core.sched_ir import PhaseBreakdown, _chunking, _rnr_barrier
from repro_torch.device import device_of
from repro_torch.kernels import bitmap, pool

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


def _sample_link_round(models: list[LossModel | None], n: int) -> list[np.ndarray]:
    """One drop mask per link for the round's n packets, in link order."""
    zeros = np.zeros(n, dtype=bool)
    return [m.sample(n) if m is not None else zeros for m in models]


def _stacked_lost(masks: list[np.ndarray], n: int) -> np.ndarray:
    """(leaves, n) bool: row k is what leaf k lost. On the abstract fabric a
    leaf's path is its one ejection link, so the reference's OR along the
    tree levels is the stack of the links' masks (routed trees: ROADMAP)."""
    return np.stack(masks) if masks else np.zeros((0, n), dtype=bool)


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

    Rows are the leaves in ascending rank order (the root excluded)."""

    def __init__(self, p: int, n_bytes: int, fabric: FabricParams, workers: WorkerParams,
                 rng: np.random.Generator, root: int, eng: Engine, device: torch.device, *,
                 loss=None, aggregate_nacks: bool = True, tag: str = "mcast",
                 collect_delivery: bool = False):
        self.p, self.fabric, self.workers, self.rng = p, fabric, workers, rng
        self.root, self.eng, self.dev = root, eng, device
        self.aggregate = aggregate_nacks
        self.n_chunks, self.chunk = _chunking(n_bytes, fabric.mtu)
        self.service = self.chunk / workers.thread_tput
        self.tag = tag
        template = resolve_loss(loss, fabric)
        self.leaf_ids = [leaf for leaf in range(p) if leaf != root]
        # one independent loss process per leaf, forked in leaf order
        self.models = [template.fork(rng) if template is not None else None
                       for _ in self.leaf_ids]
        n_leaves = len(self.leaf_ids)
        self._lossless = template is None
        # after the forks the rng feeds only jitter draws; at jitter == 0 each
        # draw is exactly 0.0 and x + 0.0 == x, so they are skipped (the
        # reference's vectorized engine does the same)
        self._skip_jitter = fabric.jitter == 0.0
        self.hop = np.full(n_leaves, 1 * fabric.latency)   # one abstract hop
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
        jit = self.rng.uniform(0.0, self.fabric.jitter, size=total)
        return torch.from_numpy(jit).to(self.dev)

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
        done, rnr = pool.pool_completion_rows(arr, self.workers.n_recv_workers,
                                              self.service, self.workers.staging_chunks)
        last = (counts - 1).clamp(min=0)
        t_last = torch.where(counts > 0, done.gather(1, last[:, None])[:, 0], math.nan)
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
        link = self.eng.add_link(f"{self.tag}.root{self.root}.send", self.fabric.b_link)
        self.flow = self.eng.submit(link, self.n_chunks * self.chunk, t_start=t_start,
                                    tag=self.tag)
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
        if n_leaves and self._lossless and self._skip_jitter:
            # no loss, no jitter: every leaf (one hop each) sees the same
            # arrival row, so one pool pass serves all
            done, rnr = pool.pool_completion_rows((inject + self._hop[0])[None, :],
                                                  self.workers.n_recv_workers, self.service,
                                                  self.workers.staging_chunks)
            t_last = float(done[0, -1])
            self.rnr_total += int(rnr.sum()) * n_leaves
            self.missing[:] = rnr
            if self.delivery is not None:
                psn = torch.where(rnr[0], -1, cols).to(torch.int32).cpu().numpy()
                self.delivery.append((np.arange(n_leaves), np.broadcast_to(psn, (n_leaves, n))))
            self.tdone.fill_(t_last)
            self.t_fast_end = max(self.t_fast_end, t_last)
        else:
            lost_all = None if self._lossless else torch.from_numpy(
                _stacked_lost(masks, n)).to(self.dev)
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
        return self._submit_retransmit(union, n_union, nackers, arrivals)

    def _submit_retransmit(self, union: torch.Tensor, n_union: int, nackers: torch.Tensor,
                           arrivals: np.ndarray):
        """Root side of a round: serve the NACK arrivals on the root's pool,
        then inject the union as a flow on the root's send link."""
        if n_union == 0:
            raise RuntimeError("a NACK round with an empty union")
        fab, wk = self.fabric, self.workers
        done, _ = worker_pool_completion(arrivals, wk.n_recv_workers,
                                         _nack_service(self.n_chunks, wk, fab.mtu),
                                         wk.staging_chunks)
        t_root_done = float(done[-1])
        t_retx = max(t_root_done, self.eng.now)
        flow = self.eng.submit(f"{self.tag}.root{self.root}.send", n_union * self.chunk,
                               t_start=t_retx, tag=f"{self.tag}.retx")
        return (flow, union, n_union, nackers, arrivals, float(t_root_done))

    def deliver_retransmit(self, meta) -> None:
        flow, union, u, nackers, arrivals, t_root_done = meta
        inject = torch.from_numpy(flow.chunk_times(u, self.chunk)).to(self.dev)
        # sample ONLY the nackers' links: advancing a loss process (a GE
        # chain) on a link that carries no retransmission would shift its bursts
        pruned = [self.models[k] for k in nackers.cpu().tolist()]
        masks = _sample_link_round(pruned, u)
        lost_all = (torch.from_numpy(_stacked_lost(masks, u)).to(self.dev)
                    if any(m is not None for m in pruned) else None)
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
    """Packet-fidelity reliable Broadcast on the abstract fabric, equal
    field for field to the reference's on the same arguments and generator.
    The leaves' receive datapath runs on ``device`` (default ``cuda``; pass
    ``device="cpu"`` for the plain versions)."""
    if topology is not None or hosts is not None:
        raise NotImplementedError("topology=/hosts=: the routed FatTree mode is not "
                                  "ported yet (ROADMAP.md, after slice 4)")
    if dpa_fidelity != "scalar" or dpa is not None:
        raise NotImplementedError("dpa_fidelity='event' / dpa=: the event-level DPA is not "
                                  "ported yet (ROADMAP.md, after slice 4)")
    if engine == "reference":
        raise NotImplementedError("engine='reference': only the vectorized executor is "
                                  "ported (ROADMAP.md, after slice 4)")
    if engine not in ("auto", "vectorized"):
        raise ValueError(f"engine must be 'auto', 'vectorized' or 'reference', got {engine!r}")
    if not 0 <= root < p:
        raise ValueError(f"root {root} outside 0..{p - 1}")
    dev = device_of("cuda" if device is None else device)
    t_rnr = _rnr_barrier(p, fabric, workers)
    eng = Engine()
    run = _BroadcastRun(p, n_bytes, fabric, workers, rng, root, eng, dev, loss=loss,
                        aggregate_nacks=aggregate_nacks, collect_delivery=collect_delivery)
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
        link_bytes={},
        rounds=run.rounds,
        retransmit_wire_bytes=run.retransmit_wire,
        duplicates=run.duplicates,
        completed=completed,
        delivery_order=run.delivery_order() if run.delivery is not None else {},
    )
