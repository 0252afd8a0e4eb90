"""Carries a parameter tree into the port.

``to_torch`` takes the JAX package's dense parameter tree as numpy arrays,
``{"embed", "final_ln", "blocks": {...stacked on L}}``, and returns the port's
tree of ``Stacked`` leaves: every leaf that ``param_pspecs`` shards over dp
is split into the stacked (R, *local) layout, rank r's shard at index r; a
leaf replicated over dp is one tensor expanded over the rank dim.

``to_numpy`` is the inverse: stacked leaves back to the global numpy tree,
so that tests can compare parameters and optimizer moments after steps.

``random_params`` draws such a tree from a seed with numpy, in the
reference's init scales (``repro.models.layers``), for runs without a
checkpoint.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.configs.base import MeshConfig, ModelConfig
from repro_torch.device import device_of
from repro_torch.launch.mesh import StackedMesh
from repro_torch.sharding.specs import (Stacked, _leaf_spec, dp_axes, is_sharded, tree_map,
                                       tree_map_with_path)

# norm scales stay float32 whatever the weights' dtype, as the reference
# initialises them
_F32_LEAVES = ("ln1", "ln2", "final_ln")


def _dp_entry(entry, dp: tuple[str, ...]) -> list[str]:
    axes = (entry,) if isinstance(entry, str) else (entry or ())
    return [ax for ax in axes if ax in dp]


def _rank_index(r: int, shape: tuple, spec, mesh: StackedMesh,
                dp: tuple[str, ...]) -> tuple:
    """The index of rank r's shard in a global array of ``shape``, ranks
    row-major over ``dp``."""
    sizes = [mesh.shape[ax] for ax in dp]
    coord = dict(zip(dp, np.unravel_index(r, sizes)))
    index = []
    for dim, entry in enumerate(spec):
        axes = _dp_entry(entry, dp)
        if not axes:
            index.append(slice(None))
            continue
        chunk = int(np.ravel_multi_index([coord[ax] for ax in axes],
                                         [mesh.shape[ax] for ax in axes]))
        size = shape[dim] // math.prod(mesh.shape[ax] for ax in axes)
        index.append(slice(chunk * size, (chunk + 1) * size))
    return tuple(index)


def _split(a: np.ndarray, spec, mesh: StackedMesh, dp: tuple[str, ...]) -> np.ndarray:
    """(*global) -> (R, *local): rank r's shard at index r."""
    return np.stack([a[_rank_index(r, a.shape, spec, mesh, dp)]
                     for r in range(mesh.n_ranks)])


def _unsplit(a: np.ndarray, spec, mesh: StackedMesh, dp: tuple[str, ...]) -> np.ndarray:
    """(R, *local) -> (*global), the inverse of ``_split``."""
    shape = list(a.shape[1:])
    for dim, entry in enumerate(spec):
        shape[dim] *= math.prod(mesh.shape[ax] for ax in _dp_entry(entry, dp))
    out = np.empty(shape, a.dtype)
    for r in range(mesh.n_ranks):
        out[_rank_index(r, tuple(shape), spec, mesh, dp)] = a[r]
    return out


def to_torch(tree, mesh: StackedMesh | None, mesh_cfg: MeshConfig, *,
             dtype: torch.dtype, device: str | torch.device = "cuda"):
    """numpy parameter tree -> tree of ``Stacked`` on ``device``. Weights are
    cast to ``dtype``; the norm scales stay float32."""
    dev = device_of(device)
    dp = dp_axes(mesh_cfg)
    if mesh is not None and mesh.rank_axes != dp:
        raise ValueError(f"{mesh} must stack exactly the dp axes {dp}")
    n = 1 if mesh is None else mesh.n_ranks

    def leaf(path, a):
        a = np.asarray(a)
        spec = () if mesh is None else _leaf_spec(path, a, mesh, dp)
        dt = torch.float32 if path[-1] in _F32_LEAVES else dtype
        if is_sharded(spec, dp):
            local = torch.from_numpy(_split(a, spec, mesh, dp))
            return Stacked(local.to(device=dev, dtype=dt), spec)
        full = torch.from_numpy(np.ascontiguousarray(a)).to(device=dev, dtype=dt)
        return Stacked(full.expand(n, *full.shape), spec)

    return tree_map_with_path(leaf, tree)


def to_numpy(params, mesh: StackedMesh | None, mesh_cfg: MeshConfig) -> dict:
    """The inverse of ``to_torch``: a tree of ``Stacked`` leaves (R, ...) ->
    the global numpy tree, float32 for floating leaves (numpy has no
    bfloat16). A replicated leaf is read from rank 0."""
    dp = dp_axes(mesh_cfg)

    def leaf(s: Stacked) -> np.ndarray:
        t = s.local.detach()
        a = (t.float() if t.is_floating_point() else t).cpu().numpy()
        if mesh is None or not is_sharded(s.spec, dp):
            return np.ascontiguousarray(a[0])
        return _unsplit(a, s.spec, mesh, dp)

    return tree_map(leaf, params)


def random_params(cfg: ModelConfig, seed: int) -> dict:
    """Dense parameter tree drawn with numpy from ``seed``, float32, in the
    reference's init scales (norm scales zero, as initialised there)."""
    if cfg.family != "dense":
        raise NotImplementedError(f"family {cfg.family!r} is not ported; only dense")
    rng = np.random.default_rng(seed)
    d, h, kvh, hd, f, n_l = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim,
                             cfg.d_ff, cfg.num_layers)

    def normal(shape, scale):
        return rng.standard_normal(shape, dtype=np.float32) * np.float32(scale)

    params = {
        "embed": normal((cfg.vocab_size, d), 0.02),
        "final_ln": np.zeros((d,), np.float32),
        "blocks": {
            "ln1": np.zeros((n_l, d), np.float32),
            "attn": {
                "wq": normal((n_l, d, h * hd), 1 / np.sqrt(d)),
                "wk": normal((n_l, d, kvh * hd), 1 / np.sqrt(d)),
                "wv": normal((n_l, d, kvh * hd), 1 / np.sqrt(d)),
                "wo": normal((n_l, h * hd, d), 1 / np.sqrt(h * hd)),
            },
            "ln2": np.zeros((n_l, d), np.float32),
            "mlp": {
                "w_gate": normal((n_l, d, f), 1 / np.sqrt(d)),
                "w_up": normal((n_l, d, f), 1 / np.sqrt(d)),
                "w_down": normal((n_l, f, d), 1 / np.sqrt(f)),
            },
        },
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = normal((d, cfg.vocab_size), 1 / np.sqrt(d))
    return params

