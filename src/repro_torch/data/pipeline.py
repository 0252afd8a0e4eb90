"""Deterministic synthetic data pipeline (counterpart of
``repro.data.pipeline``).

A reproducible token stream per (seed, step): the reference's numpy stream,
so the batches hold the same token ids as the reference's; the ``vlm``
targets are -1 over the patches. The stub frontends' frames and patches
are N(0, 1) x 0.02, drawn in float32 as the reference draws them, from
``SeedSequence([seed, step, key])``, but with a stable key,
``zlib.crc32(name) & 0xFFFF``, where the reference takes ``hash(name) &
0xFFFF``: Python salts a str's hash per process, so the reference's frames
and patches change from one process to the next. The step index is the
only state. ``next_batch``
returns int64 ids, and the frames and patches in the compute dtype, on the
run's device.
"""
from __future__ import annotations

import zlib
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.device import device_of
from repro_torch.models.layers import dtype_of
from repro_torch.models.model_builder import batch_dims


@dataclass(frozen=True)
class DataConfig:
    seed: int = 1234
    # markov-ish structure so the loss has signal to descend on
    n_states: int = 64


def frame_key(name: str) -> int:
    """The stable 16-bit key of a frames or patches draw."""
    return zlib.crc32(name.encode()) & 0xFFFF


class SyntheticPipeline:
    """next_batch(step) -> dict of tensors for the (model, shape) cell."""

    def __init__(self, model: ModelConfig, shape: ShapeConfig,
                 data: DataConfig = DataConfig(), *, device: str | torch.device = "cuda"):
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
        if name in ("tokens", "targets", "token"):
            seq = shp[1] if len(shp) > 1 else 1
            toks = self._host_tokens(step, 0, shp[0], seq + 1)
            if name == "targets":
                out = toks[:, 1:seq + 1]
                if self.model.family == "vlm":
                    np_ = self.model.vision.n_patches
                    pad = np.full((shp[0], np_), -1, np.int32)
                    out = np.concatenate([pad, out[:, :shp[1] - np_]], axis=1)
                return out[:, :shp[1]]
            out = toks[:, :seq]
            return out if len(shp) > 1 else out[:, 0]
        if name == "pos":
            return np.zeros(shp, np.int32)
        # the reference keys on hash(name) (src/repro/data/pipeline.py:69),
        # which Python salts per process; crc32 gives every process one draw
        rng = np.random.default_rng(
            np.random.SeedSequence([self.data.seed, step, frame_key(name)]))
        return (rng.standard_normal(shp) * 0.02).astype(np.float32)

    def next_batch(self, step: int) -> dict[str, torch.Tensor]:
        out = {}
        for name in self.dims:
            a = torch.from_numpy(self._full(name, step))
            a = a.long() if name in ("tokens", "targets", "token", "pos") else \
                a.to(dtype_of(self.model.compute_dtype))
            out[name] = a.to(self.device)
        return out
