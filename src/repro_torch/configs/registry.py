"""Architecture registry: ``--arch <id>`` resolution, the training
co-simulation's sweep and the dry-run's (architecture x shape) cell grid
(copy of the JAX package's registry: every architecture of the
reference)."""
from __future__ import annotations

from typing import Callable, Iterator

from repro_torch.configs.base import (SHAPES, MeshConfig, ModelConfig, RunConfig, ShapeConfig,
                                      TrainConfig)

_REGISTRY: dict[str, Callable[[], ModelConfig]] = {}


def register(name: str):
    def deco(fn: Callable[[], ModelConfig]):
        _REGISTRY[name] = fn
        return fn

    return deco


def _ensure_loaded() -> None:
    # import arch modules for their side-effectful @register decorators
    from repro_torch.configs import (  # noqa: F401
        deepseek_moe_16b,
        granite_3_8b,
        granite_34b,
        moonshot_v1_16b_a3b,
        phi_3_vision_4_2b,
        recurrentgemma_9b,
        rwkv6_7b,
        smollm_135m,
        whisper_base,
        yi_9b,
    )


def arch_names() -> list[str]:
    _ensure_loaded()
    return sorted(_REGISTRY)


def get_model_config(name: str) -> ModelConfig:
    _ensure_loaded()
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name]()


def get_shape(name: str) -> ShapeConfig:
    if name not in SHAPES:
        raise KeyError(f"unknown shape {name!r}; known: {sorted(SHAPES)}")
    return SHAPES[name]


#: GPT-small -> 34B dense span swept by core/train_sim.py's
#: ``sweep_training_runs`` (the reference's training_run_sweep) and the
#: co-simulation's tests
TRAINING_SWEEP_ARCHS: tuple[str, ...] = ("smollm-135m", "yi-9b",
                                         "granite-34b")


def training_sweep_archs() -> tuple[str, ...]:
    _ensure_loaded()
    assert all(a in _REGISTRY for a in TRAINING_SWEEP_ARCHS)
    return TRAINING_SWEEP_ARCHS


def cell_supported(model: ModelConfig, shape: ShapeConfig) -> tuple[bool, str]:
    """Whether the (arch, shape) cell is runnable; (ok, reason-if-skipped)."""
    if shape.name == "long_500k" and not model.sub_quadratic:
        return False, (
            "long_500k requires sub-quadratic attention; "
            f"{model.name} is full-attention (skip per assignment)"
        )
    if shape.kind == "decode" and not model.has_decoder:
        return False, f"{model.name} is encoder-only; no decode step"
    return True, ""


def iter_cells(include_skipped: bool = False) -> Iterator[tuple[str, str, bool, str]]:
    """Yield (arch, shape, supported, skip_reason) for the 40-cell table."""
    for arch in arch_names():
        model = get_model_config(arch)
        for shape_name in ("train_4k", "prefill_32k", "decode_32k", "long_500k"):
            ok, why = cell_supported(model, SHAPES[shape_name])
            if ok or include_skipped:
                yield arch, shape_name, ok, why


def make_run_config(arch: str, shape: str, *, multi_pod: bool = False, **train_kw) -> RunConfig:
    return RunConfig(
        model=get_model_config(arch),
        shape=get_shape(shape),
        mesh=MeshConfig(multi_pod=multi_pod),
        train=TrainConfig(**train_kw) if train_kw else TrainConfig(),
    )
