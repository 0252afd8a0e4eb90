"""Exact analytic FLOP / HBM-byte models per (arch x shape) cell (a copy
of the JAX package's ``launch/analytic_costs.py``; the training-run
co-simulation, ``core/train_sim.py``, prices its layers with it).

Why analytic: XLA's cost_analysis() counts while-loop bodies ONCE (verified
empirically — a 10-step scanned matmul reports ~1 matmul of FLOPs), and every
model here is a scan over layers with scans inside (attention blocks, WKV
chunks, xent chunks). The roofline's compute/memory terms therefore come from
these first-principles formulas (the standard way LLM rooflines are built);
in the reference the raw cost_analysis numbers are recorded alongside as a
cross-check, and collective bytes come from the partitioned HLO.

Conventions:
  - FLOPs count multiply+add as 2.
  - train step FLOPs = fwd * (1 + 2) (+1 extra fwd when remat="full").
  - causal attention counts the lower triangle only as "useful"
    (MODEL_FLOPS); the baseline blockwise implementation actually computes
    the full masked rectangle — reported as compute_waste so the §Perf
    iteration can drive it down and be measured against a fixed target.
"""
from __future__ import annotations

from dataclasses import dataclass

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models.model_builder import count_params_analytic


@dataclass(frozen=True)
class CellCost:
    model_flops: float          # useful FLOPs (6*N*D + exact causal attention)
    impl_flops: float           # what the implementation actually executes
    hbm_bytes: float            # per-device HBM traffic per step
    params_total: int
    params_active: int

    @property
    def useful_ratio(self) -> float:
        return self.model_flops / max(self.impl_flops, 1.0)


def _attn_flops(cfg: ModelConfig, s: int, *, causal_frac: float) -> float:
    return 4.0 * s * s * cfg.num_heads * cfg.head_dim * causal_frac


def _attn_impl_flops(cfg: ModelConfig, s: int) -> float:
    """Blockwise attention computes the full masked rectangle (window layers
    slice a fixed kv span instead)."""
    win = cfg.attn_window or (cfg.rglru.window if cfg.rglru else None)
    if win is not None:
        span = min(win + cfg.attn_q_block, s)
        return 4.0 * s * span * cfg.num_heads * cfg.head_dim
    return 4.0 * s * s * cfg.num_heads * cfg.head_dim


def _layer_linear_flops_per_tok(cfg: ModelConfig) -> float:
    """All per-token matmul FLOPs of one layer (= 6 * params_layer / ... kept
    explicit per family)."""
    d, hd = cfg.d_model, cfg.head_dim
    if cfg.family in ("dense", "vlm", "encdec"):
        attn = 2 * d * (cfg.num_heads * hd) * 2 + 2 * d * (cfg.num_kv_heads * hd) * 2
        mlp = (6 if cfg.act == "swiglu" else 4) * d * cfg.d_ff
        return attn + mlp
    if cfg.family == "moe":
        m = cfg.moe
        attn = 2 * d * (cfg.num_heads * hd) * 2 + 2 * d * (cfg.num_kv_heads * hd) * 2
        router = 2 * d * m.n_routed_experts
        routed = 6 * d * m.d_ff_expert * m.top_k
        shared = 6 * d * m.d_ff_expert * m.n_shared_experts
        return attn + router + routed + shared
    if cfg.family == "rwkv":
        tm = 2 * d * d * 5  # r,k,v,g,o projections
        lora = 2 * d * (5 * cfg.rwkv.tokenshift_lora) * 2 + 2 * d * cfg.rwkv.decay_lora * 2
        c = cfg.rwkv.chunk_size
        wkv = 4 * d * (c + hd)  # intra-chunk scores/outputs + state terms
        cm = 2 * d * cfg.d_ff * 2 + 2 * d * d
        return tm + lora + wkv + cm
    if cfg.family == "hybrid":
        # averaged over the (rec, rec, attn) pattern
        w = cfg.rglru.lru_width
        rec = 2 * d * w * 2 + 2 * w * w * 2 + 2 * w * d + 2 * cfg.rglru.conv_width * w
        att = 2 * d * (cfg.num_heads * hd) * 2 + 2 * d * (cfg.num_kv_heads * hd) * 2
        mlp = 6 * d * cfg.d_ff
        n_rec = 2 * (cfg.num_layers // 3) + cfg.num_layers % 3
        n_att = cfg.num_layers // 3
        return ((rec + mlp) * n_rec + (att + mlp) * n_att) / cfg.num_layers
    raise ValueError(cfg.family)


def _n_layers_eff(cfg: ModelConfig) -> int:
    if cfg.family == "encdec":
        return cfg.encdec.enc_layers + cfg.encdec.dec_layers
    return cfg.num_layers


def _fwd_flops(cfg: ModelConfig, s: int, batch: int) -> tuple[float, float]:
    """(useful, implemented) forward FLOPs for a length-s batch."""
    toks = batch * s
    l = _n_layers_eff(cfg)
    lin = _layer_linear_flops_per_tok(cfg) * toks * l
    head = 2.0 * cfg.d_model * cfg.vocab_size * toks
    if cfg.family == "rwkv":
        return lin + head, lin + head
    if cfg.family == "hybrid":
        n_att = cfg.num_layers // 3
        att_use = _attn_flops(cfg, s, causal_frac=0.5) * batch * n_att
        att_impl = _attn_impl_flops(cfg, s) * batch * n_att
        # window attention useful = min(window, s)-bounded triangle
        w = cfg.rglru.window
        att_use = 4.0 * s * min(w, s) * cfg.num_heads * cfg.head_dim * 0.5 * batch * n_att
        return lin + head + att_use, lin + head + att_impl
    if cfg.family == "encdec":
        le, ld = cfg.encdec.enc_layers, cfg.encdec.dec_layers
        self_use = _attn_flops(cfg, s, causal_frac=1.0) * batch * le  # non-causal enc
        self_use += _attn_flops(cfg, s, causal_frac=0.5) * batch * ld
        cross = _attn_flops(cfg, s, causal_frac=1.0) * batch * ld
        impl = (
            _attn_impl_flops(cfg, s) * batch * (le + ld) + cross
            + 2 * cfg.d_model * (cfg.num_kv_heads * cfg.head_dim) * 2 * toks * ld
        )
        use = self_use + cross
        return lin + head + use, lin + head + impl
    att_use = _attn_flops(cfg, s, causal_frac=0.5) * batch * l
    att_impl = _attn_impl_flops(cfg, s) * batch * l
    return lin + head + att_use, lin + head + att_impl


def _cache_bytes(cfg: ModelConfig, s: int, batch: int) -> float:
    bpe = 2.0  # bf16
    if cfg.family == "rwkv":
        return cfg.num_layers * batch * (
            cfg.num_heads * cfg.head_dim * cfg.head_dim * 4.0 + 2 * cfg.d_model * bpe
        )
    if cfg.family == "hybrid":
        ng = cfg.num_layers // 3
        win = min(cfg.rglru.window, s)
        att = ng * batch * cfg.num_kv_heads * win * cfg.head_dim * 2 * bpe
        rec = (2 * ng + cfg.num_layers % 3) * batch * cfg.rglru.lru_width * (
            4.0 + (cfg.rglru.conv_width - 1) * bpe
        )
        return att + rec
    l = cfg.encdec.dec_layers if cfg.family == "encdec" else cfg.num_layers
    mult = 4 if cfg.family == "encdec" else 2  # + cross-attn caches
    if cfg.kv_cache_dtype == "int8":
        bpe = 1.0 + 4.0 / cfg.head_dim  # int8 payload + f32 scale per vector
    return l * batch * cfg.num_kv_heads * s * cfg.head_dim * mult * bpe


@dataclass(frozen=True)
class CollectiveCost:
    """Per-device ICI bytes per step, by stream (documented formulas below)."""
    fsdp_allgather: float      # weight gathers: params_dp_bytes*(dp-1)/dp*(fwd+bwd regather)
    grad_reduce_scatter: float  # f32 grads: params_dp*4*(dp-1)/dp
    tp_activations: float      # SP/TP act gathers+psums around attn/mlp per layer
    ep_all_to_all: float       # MoE dispatch/combine
    decode_psum: float          # flash-decoding LSE combines

    @property
    def total(self) -> float:
        return (self.fsdp_allgather + self.grad_reduce_scatter
                + self.tp_activations + self.ep_all_to_all + self.decode_psum)


def _dp_sharded_param_bytes(cfg: ModelConfig) -> float:
    """Bytes of params whose storage is dp(FSDP)-sharded (≈ all matrices; the
    tiny replicated leaves — norms, biases, loras — are excluded ≈ exactly)."""
    return count_params_analytic(cfg) * 2.0  # bf16


def collective_cost(cfg: ModelConfig, shape: ShapeConfig, *, dp: int, tp: int,
                    remat: str = "full", grad_accum: int = 1,
                    ep_crossing_factor: float = 1.0,
                    serve_replicated: bool = False) -> CollectiveCost:
    b, s = shape.global_batch, shape.seq_len
    bpe = 2.0
    dpf = (dp - 1) / dp if dp > 1 else 0.0
    tpf = (tp - 1) / tp if tp > 1 else 0.0
    pbytes = _dp_sharded_param_bytes(cfg) / tp  # TP split first, FSDP over the rest

    if shape.kind == "train":
        regather = 2.0 if remat == "full" else 1.0
        # per step: gathers repeat per microbatch but move the same bytes
        ag = pbytes * dpf * (1.0 + regather) * 1.0
        ag *= grad_accum
        rs = count_params_analytic(cfg) / tp * 4.0 * dpf
        toks_local = b * s / max(dp, 1)
        # 2 gather+psum pairs per layer, fwd+bwd
        tp_act = 2 * 2 * toks_local * cfg.d_model * bpe * tpf * _n_layers_eff(cfg)
        ep = 0.0
        if cfg.family == "moe":
            ep = (2 * toks_local * cfg.moe.top_k * cfg.d_model * bpe * tpf
                  * _n_layers_eff(cfg) * 2) * ep_crossing_factor
        return CollectiveCost(ag, rs, tp_act, ep, 0.0)

    if shape.kind == "prefill":
        ag = pbytes * dpf
        toks_local = b * s / max(dp, 1)
        tp_act = 2 * toks_local * cfg.d_model * bpe * tpf * _n_layers_eff(cfg)
        ep = 0.0
        if cfg.family == "moe":
            ep = (2 * toks_local * cfg.moe.top_k * cfg.d_model * bpe * tpf
                  * _n_layers_eff(cfg)) * ep_crossing_factor
        if serve_replicated:
            ag = 0.0
        return CollectiveCost(ag, 0.0, tp_act, ep, 0.0)

    # decode: FSDP-sharded weights must be gathered every token step (this is
    # the dominant term — and the motivation for replicating weights over dp
    # at serve time, a §Perf iteration)
    ag = 0.0 if serve_replicated else pbytes * dpf
    b_local = b / max(dp, 1) if b % dp == 0 else b
    psum = (
        3 * b_local * cfg.num_heads * cfg.head_dim * 4.0 * tpf * _n_layers_eff(cfg)
        if tp > 1 else 0.0
    )
    ep = 0.0
    if cfg.family == "moe":
        ep = 2 * b_local * cfg.moe.top_k * cfg.d_model * bpe * tpf * _n_layers_eff(cfg)
    return CollectiveCost(ag, 0.0, 0.0, ep, psum)


def cell_cost(cfg: ModelConfig, shape: ShapeConfig, n_devices: int,
              *, remat: str = "full", opt_bytes_per_param: float = 8.0,
              tp: int = 16, serve_replicated: bool = False) -> CellCost:
    n_total = count_params_analytic(cfg)
    n_active = count_params_analytic(cfg, active_only=True)
    b, s = shape.global_batch, shape.seq_len
    bpe = 2.0

    if shape.kind in ("train", "prefill"):
        use_f, impl_f = _fwd_flops(cfg, s, b)
        if shape.kind == "train":
            mult_use, mult_impl = 3.0, 3.0 + (1.0 if remat == "full" else 0.0)
            use_f, impl_f = use_f * mult_use, impl_f * mult_impl
        # HBM per device: weights are re-read per layer (+grads written,
        # +optimizer state r/w for train); activations make ~c passes.
        w_local = n_total * bpe / n_devices
        act_passes = 8.0 if shape.kind == "train" else 4.0
        acts = b * s * cfg.d_model * bpe / n_devices * _n_layers_eff(cfg) * act_passes
        if shape.kind == "train":
            hbm = w_local * (3.0 + opt_bytes_per_param / bpe) + acts
        else:
            hbm = w_local + acts + _cache_bytes(cfg, s, b) / n_devices
        return CellCost(use_f / n_devices * n_devices, impl_f, hbm, n_total, n_active)

    # decode: one token across the batch
    toks = float(b)
    l = _n_layers_eff(cfg)
    lin = _layer_linear_flops_per_tok(cfg) * toks * l
    head = 2.0 * cfg.d_model * cfg.vocab_size * toks
    if cfg.family == "rwkv":
        attn = 4.0 * cfg.d_model * cfg.head_dim * toks * l  # state update/read
    elif cfg.family == "hybrid":
        n_att = cfg.num_layers // 3
        attn = 4.0 * min(cfg.rglru.window, s) * cfg.num_heads * cfg.head_dim * toks * n_att
        attn += 4.0 * cfg.rglru.lru_width * toks * (cfg.num_layers - n_att)
    else:
        attn = 4.0 * s * cfg.num_heads * cfg.head_dim * toks * l
        if cfg.family == "encdec":
            attn *= 2  # + cross-attention over the encoder cache
    use_f = impl_f = lin + head + attn
    # decode HBM: read all local weights once + local cache once; with
    # serve-replicated weights each device holds 1/tp of the model instead
    # of 1/n_devices (more local reads, no per-token gather)
    w_div = tp if serve_replicated else n_devices
    hbm = n_total * bpe / w_div + _cache_bytes(cfg, s, b) / n_devices
    return CellCost(use_f, impl_f, hbm, n_total, n_active)
