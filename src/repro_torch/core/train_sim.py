"""GPT-scale training-step co-simulation: compute rooflines x collective engines.

``simulate_training_run`` predicts step time, bubble fraction and MFU for a
REGISTRY model (configs/registry.py) trained with FSDP over a real or
abstract fabric, at any of the three fidelities of the collective stack:

  analytic   a closed-form lower bound: the engine's prefetch/re-gather
             timeline recurrence with each AG/RS leg replaced by an
             admissible per-flow bound (single-flow bytes at the fabric's
             maximum link capacity) — analytic <= fluid <= packet by
             construction, mirroring sched_ir's fidelity ordering.
  fluid      engine.simulate_fsdp_step with heterogeneous per-layer
             profiles (LayerProfile): max-min fair flows on the abstract
             NIC or a routed core/topology.py fabric.
  packet     fluid + the per-layer NACK/retransmission loss overlay.

The per-layer profiles come from the same first-principles cost model the
roofline uses (launch/analytic_costs.py): per-layer FLOPs and HBM bytes at
the shape's token count give roofline fwd/bwd seconds at ``ChipConstants``
(``chip=H100``: the NVIDIA H100 SXM's 989 TFLOP/s bf16 and 3.35 TB/s HBM;
the default, ``TPU_V5E``, is the JAX reference's, kept so that every result
equals the reference's); per-layer parameter bytes give the FSDP AG/RS wire
volume. Layers are genuinely heterogeneous:
the input embedding rides with the first layer and the LM head (flops and
params) with the last, so the schedule sees real volume skew.

Parallelism mix: ``n_hosts`` fabric hosts are split into ``pp`` pipeline
stages of ``dp = n_hosts // pp`` FSDP ranks; ``tp`` chips per host split
every matmul (TP traffic stays on intra-host ICI and is not put on the
fabric — the fabric simulates the DP axis, the paper's setting). The
heaviest stage (max sum of fwd+bwd seconds) is co-simulated and the step
composes 1F1B-style: step = (grad_accum + pp - 1) * stage_micro_time,
pipeline bubble = (pp - 1) / (grad_accum + pp - 1). Each microbatch pays
the full AG+RS (a slight overcount for grad_accum > 1: real runs skip the
RS on non-final microbatches), which keeps MFU conservative.

MFU = useful model FLOPs per step / (step_time * n_devices * peak): always
in (0, 1] because every layer's roofline seconds are >= its implemented
FLOPs at peak and the simulated stage is the compute-heaviest one.

``search=`` drops the schedule searcher into the loop: the winning
searched allgather for the stage's largest layer projects an alternative
step time through the same analytic recurrence (searched_step_time), with
the full sched_search.SearchResult attached.

``device`` (default ``cuda``) is where the fluid and packet steps' engines
run their vectorized max-min solves (``engine.simulate_fsdp_step``) and
where ``search=`` evaluates its candidates (``sched_search.search``); every
result is the same on every device.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from repro_torch.core.engine import (FSDP_POLICIES, FabricParams, FsdpStepResult,
                                     LayerProfile, WorkerParams,
                                     simulate_fsdp_step)
from repro_torch.device import device_of

TRAIN_FIDELITIES = ("analytic", "fluid", "packet")


@dataclass(frozen=True)
class ChipConstants:
    """Roofline chip model: peak FLOP/s, HBM bytes/s and optimizer-state
    bytes per parameter of one accelerator. The field defaults are the JAX
    reference's chip (``TPU_V5E``), kept so that the port's results equal
    the reference's; ``H100`` is the NVIDIA H100 SXM."""
    name: str = "tpu_v5e"
    peak_flops: float = 197e12        # bf16 FLOP/s per chip
    hbm_bw: float = 819e9             # HBM bytes/s per chip
    opt_bytes_per_param: float = 8.0  # f32 Adam m+v (matches cell_cost)


TPU_V5E = ChipConstants()
#: NVIDIA H100 SXM: dense bf16 tensor FLOP/s and HBM3 bytes/s (data sheet)
H100 = ChipConstants("h100_sxm", 989e12, 3.35e12, 8.0)


@dataclass
class TrainingRunResult:
    model: str
    shape: str
    n_hosts: int
    dp: int
    tp: int
    pp: int
    grad_accum: int
    policy: str
    fidelity: str
    loss_rate: float | None
    step_time: float                  # full step: (ga + pp - 1) microbatches
    micro_time: float                 # one microbatch on the heaviest stage
    compute_time: float               # useful compute seconds per step
    bubble_fraction: float            # 1 - compute_time / step_time
    pipeline_bubble_fraction: float   # (pp - 1) / (ga + pp - 1)
    mfu: float                        # useful FLOPs / (step * devices * peak)
    model_flops_per_step: float       # useful (MODEL_FLOPS) per optimizer step
    n_devices: int                    # n_hosts * tp chips
    layer_profiles: list[LayerProfile] = field(repr=False, default_factory=list)
    stage_span: tuple[int, int] = (0, 0)   # [lo, hi) layer slice simulated
    fsdp: FsdpStepResult | None = field(repr=False, default=None)
    searched: object | None = field(repr=False, default=None)
    searched_step_time: float | None = None


def _resolve_model(model):
    if isinstance(model, str):
        from repro_torch.configs.registry import get_model_config  # lazy: configs

        return get_model_config(model)
    return model


def _resolve_shape(shape):
    if isinstance(shape, str):
        from repro_torch.configs.registry import get_shape  # lazy: configs

        return get_shape(shape)
    return shape


def derive_layer_profiles(model, shape="train_4k", *, dp: int, tp: int = 1,
                          grad_accum: int = 1, remat: str = "full",
                          chip: ChipConstants = TPU_V5E,
                          dtype_bytes: float = 2.0) -> list[LayerProfile]:
    """Per-layer (fwd_s, bwd_s, layer_bytes) from a registry model at a
    training shape — the analytic_costs.py formulas resolved per layer.

    Compute: one microbatch's tokens split over dp ranks and tp chips;
    fwd seconds = max(FLOPs/peak, HBM/bw) roofline, bwd = 2x FLOPs
    (+1x recompute under remat="full") with the backward's activation
    traffic. Comm: the layer's parameter bytes after the TP split (the
    FSDP-sharded volume of collective_cost's ``pbytes``); embedding rides
    with layer 0, the LM head with the last layer."""
    cfg = _resolve_model(model)
    shp = _resolve_shape(shape)
    assert shp.kind == "train", f"training shapes only, got {shp.kind!r}"
    assert dp >= 1 and tp >= 1 and grad_accum >= 1
    from repro_torch.launch.analytic_costs import _fwd_flops, _n_layers_eff  # lazy
    from repro_torch.models.model_builder import count_params_analytic  # lazy

    n_layers = _n_layers_eff(cfg)
    batch_micro = shp.global_batch / grad_accum
    toks_micro = batch_micro * shp.seq_len
    toks_local = toks_micro / dp

    # ---- FLOPs: split the implemented forward into body layers + LM head
    _, impl_fwd = _fwd_flops(cfg, shp.seq_len, batch_micro)
    head_flops = 2.0 * cfg.d_model * cfg.vocab_size * toks_micro
    body_flops_layer = max(impl_fwd - head_flops, 0.0) / n_layers
    bwd_mult = 2.0 + (1.0 if remat == "full" else 0.0)

    # ---- parameter bytes: body layers + embedding/head extremes
    params_total = count_params_analytic(cfg)
    emb_params = cfg.d_model * cfg.vocab_size * (1 if cfg.tie_embeddings
                                                 else 2)
    emb_params = min(emb_params, params_total // 2)   # smoke-model guard
    body_bytes_layer = (params_total - emb_params) / n_layers * dtype_bytes
    emb_half = emb_params / (1 if cfg.tie_embeddings else 2) * dtype_bytes

    bpe = dtype_bytes
    out: list[LayerProfile] = []
    for i in range(n_layers):
        flops = body_flops_layer
        lbytes = body_bytes_layer
        if i == 0:
            lbytes += emb_half                         # input embedding
        if i == n_layers - 1:
            flops += head_flops
            if not cfg.tie_embeddings:
                lbytes += emb_half                     # LM head
        lbytes /= tp                                   # TP split first
        fwd_flops_dev = flops / (dp * tp)
        # HBM per device: gathered weights re-read, ~2 activation passes
        # forward / ~6 backward (cell_cost's 8 total), optimizer r/w on
        # the local shard during the backward's update
        acts = toks_local * cfg.d_model * bpe
        hbm_fwd = lbytes + 2.0 * acts
        hbm_bwd = (lbytes * (2.0 if remat == "full" else 1.0) + 6.0 * acts
                   + lbytes / dp * (2.0 + chip.opt_bytes_per_param / bpe))
        fwd_s = max(fwd_flops_dev / chip.peak_flops, hbm_fwd / chip.hbm_bw)
        bwd_s = max(bwd_mult * fwd_flops_dev / chip.peak_flops,
                    hbm_bwd / chip.hbm_bw)
        out.append(LayerProfile(fwd_s, bwd_s, lbytes))
    return out


# ------------------------------------------------------- analytic timeline


def _fixed_timeline(fwd, bwd, t_ag, t_rs, sync: float) -> tuple[float, float]:
    """The engine's prefetch/re-gather recurrence with FIXED comm legs —
    the analytic fidelity (legs are admissible per-flow lower bounds) and
    the searched-allgather projection both reuse it. Returns
    (step_time, t_fwd_end)."""
    n = len(fwd)
    ready = [0.0] * n
    ready[0] = t_ag[0] + sync
    t = 0.0
    for i in range(n):
        start = max(t, ready[i])
        if i + 1 < n:
            ready[i + 1] = start + t_ag[i + 1] + sync
        t = start + fwd[i]
    t_fwd = t
    ready_b = [0.0] * n
    ready_b[n - 1] = t_fwd + t_ag[n - 1] + sync
    rs_done = t
    for i in range(n - 1, -1, -1):
        start = max(t, ready_b[i])
        if i - 1 >= 0:
            ready_b[i - 1] = start + t_ag[i - 1] + sync
        t = start + bwd[i]
        rs_done = max(rs_done, t + t_rs[i])
    return max(t, rs_done), t_fwd


def _analytic_legs(profiles, p: int, policy: str, fabric: FabricParams,
                   topology) -> tuple[list[float], list[float], float]:
    """(t_ag, t_rs, bw) per layer: single-flow bytes at the fabric's max
    link capacity. Every submitted AG/RS set contains a flow carrying at
    least these bytes and no flow can stream faster than the fastest link,
    so eng.wait(...) >= submit + leg — the fluid step dominates the fixed
    timeline leg-for-leg (analytic <= fluid)."""
    if topology is None:
        bw = fabric.b_link
        # abstract naive: the single shared-medium flow carries send+recv
        ag_mult = rs_mult = (2.0 if policy == "naive" else 1.0)
        ag_of = rs_of = (lambda g, s: g)
    else:
        bw = max(topology.tier_capacities().values())
        ag_mult = rs_mult = 1.0
        if policy == "naive":
            ag_of = rs_of = (lambda g, s: g)      # ring flows carry gather
        elif policy == "mcast":
            ag_of = (lambda g, s: s)              # one mcast tree: a shard
            rs_of = (lambda g, s: g)              # ring RS still gathers
        else:
            ag_of = rs_of = (lambda g, s: s)      # agg trees carry shards
    t_ag, t_rs = [], []
    for lp in profiles:
        g = (p - 1) / p * lp.layer_bytes
        s = lp.layer_bytes / p
        t_ag.append(ag_mult * ag_of(g, s) / bw)
        t_rs.append(rs_mult * rs_of(g, s) / bw)
    return t_ag, t_rs, bw


def _ag_sync(p: int, policy: str, n_chains: int, fabric: FabricParams) -> float:
    if policy == "naive":
        return (p - 1) * fabric.latency
    return max(p // max(n_chains, 1), 1) * fabric.latency


# ------------------------------------------------------------ entry point


def simulate_training_run(model, shape="train_4k", *, n_hosts: int,
                          policy: str = "split", tp: int = 1, pp: int = 1,
                          grad_accum: int = 1, remat: str = "full",
                          topology=None, hosts=None,
                          fabric: FabricParams | None = None,
                          workers: WorkerParams | None = None,
                          fidelity: str = "fluid", loss=None,
                          rng: np.random.Generator | None = None,
                          chip: ChipConstants = TPU_V5E, n_chains: int = 2,
                          dtype_bytes: float = 2.0,
                          progress_engine: str = "dpa",
                          host_cores: int = 2, host_total_cores: int = 108,
                          search=None, search_cache=None,
                          device="cuda") -> TrainingRunResult:
    """Co-simulate one optimizer step of ``model`` at ``shape`` on
    ``n_hosts`` fabric hosts (see module docstring for the model). With a
    degenerate mix (pp=1, grad_accum=1, dp>=2) the fluid/packet result is
    BIT-EXACT engine.simulate_fsdp_step on the derived profiles —
    tests/test_torch_train_sim.py pins it. Runs on ``device`` (module
    docstring); raises where it names CUDA and there is none."""
    assert policy in FSDP_POLICIES, policy
    assert fidelity in TRAIN_FIDELITIES, fidelity
    assert n_hosts >= 1 and pp >= 1 and grad_accum >= 1
    assert n_hosts % pp == 0, (n_hosts, pp)
    dp = n_hosts // pp
    dev = device_of(device)
    fabric = fabric or FabricParams()
    cfg = _resolve_model(model)
    shp = _resolve_shape(shape)

    profiles = derive_layer_profiles(cfg, shp, dp=dp, tp=tp,
                                     grad_accum=grad_accum, remat=remat,
                                     chip=chip, dtype_bytes=dtype_bytes)
    n_layers = len(profiles)
    assert pp <= n_layers, (pp, n_layers)

    # heaviest pipeline stage: contiguous slices of ceil(L/pp) layers;
    # its step_time bounds every stage's, which is what the 1F1B
    # composition (and the MFU <= 1 argument) needs
    per = -(-n_layers // pp)
    spans = [(lo, min(lo + per, n_layers)) for lo in range(0, n_layers, per)]
    lo, hi = max(spans, key=lambda sp: sum(p.fwd_s + p.bwd_s
                                           for p in profiles[sp[0]:sp[1]]))
    stage = profiles[lo:hi]

    fsdp_res: FsdpStepResult | None = None
    if dp == 1:
        # no data parallelism: nothing on the wire, every fidelity is the
        # pure-compute timeline
        micro = sum(p.fwd_s for p in stage) + sum(p.bwd_s for p in stage)
        stage_compute = micro
    elif fidelity == "analytic":
        t_ag, t_rs, _ = _analytic_legs(stage, dp, policy, fabric, topology)
        micro, _ = _fixed_timeline([p.fwd_s for p in stage],
                                   [p.bwd_s for p in stage],
                                   t_ag, t_rs,
                                   _ag_sync(dp, policy, n_chains, fabric))
        stage_compute = sum(p.fwd_s + p.bwd_s for p in stage)
    else:
        fsdp_res = simulate_fsdp_step(
            layers=stage, p=dp, fabric=fabric, policy=policy,
            n_chains=n_chains, topology=topology,
            hosts=hosts if hosts is not None else range(dp),
            fidelity=fidelity, loss=loss, rng=rng, workers=workers,
            progress_engine=progress_engine, host_cores=host_cores,
            host_total_cores=host_total_cores, device=dev)
        micro = fsdp_res.step_time
        stage_compute = fsdp_res.compute_time

    n_micro = grad_accum + pp - 1
    step_time = n_micro * micro if n_micro > 1 else micro
    compute_time = (grad_accum * stage_compute if grad_accum > 1
                    else stage_compute)

    from repro_torch.launch.analytic_costs import _fwd_flops  # lazy
    use_fwd, _ = _fwd_flops(cfg, shp.seq_len, shp.global_batch)
    model_flops = 3.0 * use_fwd                      # fwd + 2x bwd, useful
    n_devices = n_hosts * tp
    mfu = model_flops / (step_time * n_devices * chip.peak_flops)

    searched = searched_step = None
    if search and dp >= 2:
        from repro_torch.core import sched_search  # lazy: imports half of core

        ref = max(p.layer_bytes for p in stage)
        searched = sched_search.search(
            "allgather", dp, max(int(ref / dp), 1), topology=topology,
            validate_packet=False, cache=search_cache, device=dev)
        t_ag = [searched.winner_time * (p.layer_bytes / ref) for p in stage]
        _, t_rs, _ = _analytic_legs(stage, dp, policy, fabric, topology)
        s_micro, _ = _fixed_timeline([p.fwd_s for p in stage],
                                     [p.bwd_s for p in stage], t_ag, t_rs,
                                     0.0)
        searched_step = n_micro * s_micro if n_micro > 1 else s_micro

    return TrainingRunResult(
        model=cfg.name, shape=shp.name, n_hosts=n_hosts, dp=dp, tp=tp,
        pp=pp, grad_accum=grad_accum, policy=policy, fidelity=fidelity,
        loss_rate=(None if loss is None else getattr(loss, "mean_rate",
                                                     loss)),
        step_time=step_time, micro_time=micro, compute_time=compute_time,
        bubble_fraction=1.0 - compute_time / step_time,
        pipeline_bubble_fraction=(pp - 1) / n_micro,
        mfu=mfu, model_flops_per_step=model_flops, n_devices=n_devices,
        layer_profiles=profiles, stage_span=(lo, hi), fsdp=fsdp_res,
        searched=searched, searched_step_time=searched_step)


def sweep_training_runs(models, host_counts, *, policies=("naive", "split"),
                        shape="train_4k", fidelity="fluid", pp: int = 1,
                        **kw) -> list[TrainingRunResult]:
    """Grid helper (the reference's benchmarks/paper_figs.training_run_sweep)."""
    out = []
    for m in models:
        for n in host_counts:
            for pol in policies:
                out.append(simulate_training_run(
                    m, shape, n_hosts=n, policy=pol, pp=pp,
                    fidelity=fidelity, **kw))
    return out


def _is_pow2(x: int) -> bool:
    return x > 0 and (x & (x - 1)) == 0


def make_fabric(spec: str | None, n_hosts: int, *,
                oversubscription: float = 4.0, island_size: int = 8):
    """String-addressed fabric construction for the launch facade and the
    benchmark sweep: "abstract"/None, "fattree", "island", "torus"."""
    if spec in (None, "abstract"):
        return None
    from repro_torch.core.topology import FatTree, IslandFatTree, Torus2D  # lazy

    if spec == "fattree" or spec == "island":
        k = 4
        while k * k * k // 4 < n_hosts:
            k += 2
        if spec == "fattree":
            return FatTree(k=k, n_hosts=n_hosts,
                           oversubscription=oversubscription)
        return IslandFatTree(k, n_hosts, island_size=island_size,
                             oversubscription=oversubscription)
    if spec == "torus":
        nx = 1 << max((n_hosts.bit_length() - 1) // 2, 0)
        while nx * nx < n_hosts:
            nx *= 2
        ny = -(-n_hosts // nx)
        assert nx * ny == n_hosts and _is_pow2(n_hosts), \
            f"torus wants a power-of-two host count, got {n_hosts}"
        return Torus2D(nx, ny)
    raise ValueError(f"unknown fabric spec {spec!r}")
