"""Deterministic synthetic data pipeline (counterpart of
``repro.data.pipeline`` for the dense, moe, rwkv and hybrid families, whose
batches are the same: tokens and targets).

A reproducible token stream per (seed, step): the reference's numpy stream,
so the batches hold the same token ids as the reference's. The step index
is the only state. ``next_batch`` returns int64 tensors on the run's device.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.device import device_of
from repro_torch.models.model_builder import FAMILIES, batch_dims


@dataclass(frozen=True)
class DataConfig:
    seed: int = 1234
    # markov-ish structure so the loss has signal to descend on
    n_states: int = 64


class SyntheticPipeline:
    """next_batch(step) -> dict of tensors for the (model, shape) cell."""

    def __init__(self, model: ModelConfig, shape: ShapeConfig,
                 data: DataConfig = DataConfig(), *, device: str | torch.device = "cuda"):
        if model.family not in FAMILIES:
            raise NotImplementedError(f"family {model.family!r} is not ported; only {FAMILIES}")
        self.model = model
        self.shape = shape
        self.data = data
        self.device = device_of(device)
        self.dims = batch_dims(model, shape)

    def _host_tokens(self, step: int, lo: int, hi: int, seq: int) -> np.ndarray:
        """Deterministic pseudo-text: a noisy periodic walk over the vocab."""
        rng = np.random.default_rng(np.random.SeedSequence([self.data.seed, step, lo]))
        b = hi - lo
        v = self.model.vocab_size
        base = rng.integers(0, self.data.n_states, size=(b, 1))
        drift = np.cumsum(rng.integers(0, 3, size=(b, seq)), axis=1)
        noise = rng.integers(0, 2, size=(b, seq))
        return ((base + drift + noise) % v).astype(np.int32)

    def _full(self, name: str, step: int) -> np.ndarray:
        shp = self.dims[name]
        if name == "pos":
            return np.zeros(shp, np.int32)
        seq = shp[1] if len(shp) > 1 else 1
        toks = self._host_tokens(step, 0, shp[0], seq + 1)
        out = toks[:, 1:seq + 1] if name == "targets" else toks[:, :seq]
        return out if len(shp) > 1 else out[:, 0]

    def next_batch(self, step: int) -> dict[str, torch.Tensor]:
        return {name: torch.from_numpy(self._full(name, step)).long().to(self.device)
                for name in self.dims}
