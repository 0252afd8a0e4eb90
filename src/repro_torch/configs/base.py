"""Config system of the PyTorch port: a copy of ``repro.configs.base``.

The port keeps its own copy rather than importing the JAX package. Frozen
dataclasses; every architecture the port serves is a ``ModelConfig`` built in
its own module under ``repro_torch.configs`` and registered in
``repro_torch.configs.registry``.

Families:
  dense   — llama-style decoder (GQA/MQA, SwiGLU)
  moe     — dense skeleton + fine-grained routed experts (shared + top-k routed)
  rwkv    — RWKV6 "Finch": token-shift + data-dependent-decay WKV (attention-free)
  hybrid  — RecurrentGemma: RG-LRU recurrent blocks + local attention, 1:2 pattern
  encdec  — whisper-style encoder-decoder (audio-frame frontend stub)
  vlm     — phi-3-vision: decoder backbone + patch-embedding frontend stub
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any

Dtype = str  # "bfloat16" | "float32"


@dataclass(frozen=True)
class MoEConfig:
    n_routed_experts: int = 64
    n_shared_experts: int = 2
    top_k: int = 6
    d_ff_expert: int = 1408
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01
    router_z_coef: float = 1e-3
    # device-limited routing (DeepSeek-V3 style, beyond-paper §Perf knob):
    # experts are partitioned into ``routing_groups`` EP-aligned groups and
    # each token may only route into its top ``routing_group_topk`` groups,
    # bounding cross-device dispatch copies per token by the group count.
    routing_groups: int = 0          # 0 = unrestricted
    routing_group_topk: int = 2


@dataclass(frozen=True)
class RWKVConfig:
    head_size: int = 64
    # chunk length for the block-parallel WKV scan (training/prefill path);
    # bounds the exact per-pair decay tensor (B, c, c, H, hd) in VMEM/HBM
    chunk_size: int = 32
    # low-rank sizes for the data-dependent decay / token-shift mixers (Finch)
    decay_lora: int = 64
    tokenshift_lora: int = 32


@dataclass(frozen=True)
class RGLRUConfig:
    lru_width: int = 4096
    window: int = 2048          # local attention window
    pattern: tuple[str, ...] = ("rec", "rec", "attn")  # repeating block pattern
    conv_width: int = 4         # temporal conv in the recurrent block


@dataclass(frozen=True)
class EncDecConfig:
    enc_layers: int = 6
    dec_layers: int = 6
    # frontend stub: input_specs() supplies precomputed frame embeddings
    frame_dim: int = 512


@dataclass(frozen=True)
class VisionStubConfig:
    n_patches: int = 1024
    patch_dim: int = 1024  # pre-projection patch embedding dim (stubbed CLIP)


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                   # dense | moe | rwkv | hybrid | encdec | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int

    moe: MoEConfig | None = None
    rwkv: RWKVConfig | None = None
    rglru: RGLRUConfig | None = None
    encdec: EncDecConfig | None = None
    vision: VisionStubConfig | None = None

    act: str = "swiglu"           # swiglu | gelu
    norm_eps: float = 1e-5
    rope_theta: float = 10000.0
    tie_embeddings: bool = False
    attn_window: int | None = None  # None = full causal attention
    attn_logit_softcap: float | None = None

    # capabilities
    sub_quadratic: bool = False   # can run long_500k
    has_decoder: bool = True      # False only for pure encoders

    # numerics
    param_dtype: Dtype = "bfloat16"
    compute_dtype: Dtype = "bfloat16"
    # KV cache storage: "bf16" or "int8" (blockwise per-token/head symmetric
    # quantization — halves decode cache reads; §Perf iteration C2)
    kv_cache_dtype: str = "bf16"

    # attention chunking (online-softmax block sizes)
    attn_q_block: int = 512
    attn_kv_block: int = 1024

    def __post_init__(self):
        assert self.family in ("dense", "moe", "rwkv", "hybrid", "encdec", "vlm")
        if self.family == "moe":
            assert self.moe is not None
        if self.family == "rwkv":
            assert self.rwkv is not None
        if self.family == "hybrid":
            assert self.rglru is not None
        if self.family == "encdec":
            assert self.encdec is not None
        if self.family == "vlm":
            assert self.vision is not None
        if self.family not in ("rwkv",):
            assert self.num_heads % self.num_kv_heads == 0

    @property
    def q_per_kv(self) -> int:
        return self.num_heads // self.num_kv_heads

    def n_params(self) -> int:
        """Total parameter count (used for MODEL_FLOPS = 6*N*D roofline term)."""
        from repro_torch.models.model_builder import count_params_analytic

        return count_params_analytic(self)

    def n_active_params(self) -> int:
        """Active params per token (MoE: shared + top_k routed experts only)."""
        from repro_torch.models.model_builder import count_params_analytic

        return count_params_analytic(self, active_only=True)


@dataclass(frozen=True)
class ShapeConfig:
    name: str                    # train_4k | prefill_32k | decode_32k | long_500k
    kind: str                    # train | prefill | decode
    seq_len: int
    global_batch: int

    def __post_init__(self):
        assert self.kind in ("train", "prefill", "decode")


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", "train", 4_096, 256),
    "prefill_32k": ShapeConfig("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": ShapeConfig("decode_32k", "decode", 32_768, 128),
    "long_500k": ShapeConfig("long_500k", "decode", 524_288, 1),
}


@dataclass(frozen=True)
class MeshConfig:
    multi_pod: bool = False

    @property
    def shape(self) -> tuple[int, ...]:
        return (2, 16, 16) if self.multi_pod else (16, 16)

    @property
    def axes(self) -> tuple[str, ...]:
        return ("pod", "data", "model") if self.multi_pod else ("data", "model")

    @property
    def n_devices(self) -> int:
        n = 1
        for s in self.shape:
            n *= s
        return n


@dataclass(frozen=True)
class CollectiveConfig:
    """Configuration of the paper's collective layer (core/collectives.py)."""
    # fsdp_mode:
    #   "xla"   — parameters sharded, XLA inserts all-gather/reduce-scatter (baseline)
    #   "mcast" — explicit broadcast-composed allgather + bidirectional ring RS
    #             on flat padded buckets (the paper's schedule)
    fsdp_mode: str = "xla"
    # number of parallel broadcast chains M (paper Appendix A). 2 == the two
    # ring directions of a full-duplex ICI link (Fig. 1's two trees).
    n_chains: int = 2
    # chunk size (elements) for the pipelined broadcast; MTU analogue.
    chunk_elems: int = 65_536
    # direction-split concurrent AG/RS (Insight 2 analogue)
    direction_split: bool = True
    # serve-time weight layout: replicate params over the dp axes (decode is
    # otherwise collective-bound on per-token FSDP gathers — §Perf knob)
    serve_params_replicated: bool = False
    # explicit prefetch of layer i+1's FSDP gather during layer i's compute
    # (mcast modes only; train path)
    prefetch: bool = False


@dataclass(frozen=True)
class TrainConfig:
    steps: int = 100
    learning_rate: float = 3e-4
    warmup_steps: int = 10
    weight_decay: float = 0.1
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    grad_clip: float = 1.0
    # gradient accumulation: global_batch is split into this many microbatches
    grad_accum: int = 1
    # remat policy: "none" | "full" | "dots" (checkpoint_dots)
    remat: str = "full"
    seed: int = 0
    log_every: int = 10
    checkpoint_every: int = 0    # 0 = disabled
    checkpoint_dir: str = "/tmp/repro_ckpt"
    opt_dtype: Dtype = "float32"


@dataclass(frozen=True)
class RunConfig:
    model: ModelConfig
    shape: ShapeConfig
    mesh: MeshConfig = field(default_factory=MeshConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    collective: CollectiveConfig = field(default_factory=CollectiveConfig)

    def replace(self, **kw) -> "RunConfig":
        return dataclasses.replace(self, **kw)


def replace(cfg, **kw):
    return dataclasses.replace(cfg, **kw)


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def reduced(cfg: ModelConfig, *, layers: int | None = None) -> ModelConfig:
    """A tiny same-family variant of ``cfg`` for CPU smoke tests.

    Keeps the structural features (GQA ratio, MoE routing, hybrid pattern,
    enc/dec split, stub frontends) while shrinking every dimension.
    """
    kv = max(1, min(cfg.num_kv_heads, 2))
    heads = kv * min(cfg.q_per_kv, 2) if cfg.family != "rwkv" else 4
    d_model = 64
    head_dim = 16
    if cfg.family == "rwkv":
        head_dim = 16
        heads = d_model // head_dim
    upd: dict[str, Any] = dict(
        name=cfg.name + "-smoke",
        num_layers=layers if layers is not None else (3 if cfg.family == "hybrid" else 2),
        d_model=d_model,
        num_heads=heads,
        num_kv_heads=kv if cfg.family != "rwkv" else heads,
        head_dim=head_dim,
        d_ff=128,
        vocab_size=256,
        attn_q_block=32,
        attn_kv_block=32,
        param_dtype="float32",
        compute_dtype="float32",
    )
    if cfg.moe is not None:
        upd["moe"] = dataclasses.replace(
            cfg.moe, n_routed_experts=8, n_shared_experts=1, top_k=2, d_ff_expert=32
        )
    if cfg.rwkv is not None:
        upd["rwkv"] = dataclasses.replace(
            cfg.rwkv, head_size=head_dim, chunk_size=16, decay_lora=8, tokenshift_lora=8
        )
    if cfg.rglru is not None:
        upd["rglru"] = dataclasses.replace(
            cfg.rglru, lru_width=d_model, window=32, conv_width=4
        )
    if cfg.encdec is not None:
        upd["encdec"] = dataclasses.replace(
            cfg.encdec, enc_layers=2, dec_layers=2, frame_dim=d_model
        )
        upd["num_layers"] = 2
    if cfg.vision is not None:
        upd["vision"] = dataclasses.replace(cfg.vision, n_patches=8, patch_dim=32)
    if cfg.attn_window is not None:
        upd["attn_window"] = 32
    return dataclasses.replace(cfg, **upd)
