"""Checkpoints with async save and elastic restore (counterpart of
``repro.checkpoint.ckpt``), in the reference's layout, so that a checkpoint
that either package writes restores in the other:

    <dir>/step_<N:08d>/
        manifest.msgpack.zst   codec byte + msgpack: step, treedef, keys,
                               dtypes, metadata (``checkpoint.codec``)
        arrays.npz             one entry per leaf, its global array; the key
                               is the tree path with "/" -> "%"; bf16 stored
                               as a uint16 view

Leaves are named as the reference's ``_tree_paths`` names them: a dict's keys
sorted, a NamedTuple's fields in order, joined by "/" (``params/embed``,
``opt/m/blocks/attn/wq``, ``opt/step``). A leaf is a ``Stacked`` of the
trainable layout (``sharding.fsdp.trainable``: a split leaf its distinct
shards (N, *local) over the dp and ``model`` axes that split it, a
replicated one its global tensor), a tensor, or an int. The
optimizer's step, a Python int in the port and a 0-d int32 array in the
reference, is saved as a 0-d int32 and restored as an int.

Saves are atomic (written to ``.tmp``, then renamed). An async save copies
every leaf to the host before it returns, since the train step updates the
state in place; only the file writing runs on the thread pool.
"""
from __future__ import annotations

import concurrent.futures as cf
import os
import shutil

import numpy as np
import torch

from repro_torch.checkpoint.codec import compress_manifest, decompress_manifest, packb, unpackb
from repro_torch.configs.base import MeshConfig
from repro_torch.launch.mesh import StackedMesh
from repro_torch.sharding.fsdp import global_shape, global_tensor, split_global
from repro_torch.sharding.specs import Stacked, _leaf_spec, dp_axes

_EXEC = cf.ThreadPoolExecutor(max_workers=2)


def _is_node(tree) -> bool:
    return isinstance(tree, dict) or (isinstance(tree, tuple) and hasattr(tree, "_fields")
                                      and not isinstance(tree, Stacked))


def _children(tree) -> list[tuple[str, object]]:
    if isinstance(tree, dict):
        return [(k, tree[k]) for k in sorted(tree)]
    return list(zip(tree._fields, tree))


def _tree_paths(tree, prefix: tuple = ()) -> list[tuple[tuple, object]]:
    """(path, leaf) in the reference's order."""
    if not _is_node(tree):
        return [(prefix, tree)]
    return [item for k, v in _children(tree) for item in _tree_paths(v, prefix + (k,))]


def _rebuild(like, leaves: dict, prefix: tuple = ()):
    if not _is_node(like):
        return leaves[prefix]
    if isinstance(like, dict):
        return {k: _rebuild(v, leaves, prefix + (k,)) for k, v in like.items()}
    return type(like)(*(_rebuild(v, leaves, prefix + (k,)) for k, v in _children(like)))


def _describe(tree) -> str:
    """The tree's structure, leaves as "*"."""
    if not _is_node(tree):
        return "*"
    inner = ", ".join(f"{k}={_describe(v)}" for k, v in _children(tree))
    return f"{{{inner}}}" if isinstance(tree, dict) else f"{type(tree).__name__}({inner})"


def _to_host(leaf) -> tuple[np.ndarray, str]:
    """A leaf -> (its global array as stored, its dtype string): always a
    copy, never a view of the live state."""
    if isinstance(leaf, int):
        return np.asarray(leaf, np.int32), "int32"
    t = global_tensor(leaf) if isinstance(leaf, Stacked) else leaf.detach()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).to("cpu", copy=True).numpy().view(np.uint16), "bfloat16"
    a = t.to("cpu", copy=True).numpy()
    return a, str(a.dtype)


def host_arrays(state) -> dict[str, tuple[np.ndarray, str]]:
    """Every leaf's global array on the host, by key: what a save writes."""
    return {"/".join(path): _to_host(leaf) for path, leaf in _tree_paths(state)}


def save(state, directory: str, step: int, *, blocking: bool = True,
         metadata: dict | None = None):
    """Checkpoint ``state``. The leaves are on the host when this returns;
    with ``blocking=False`` the files are written on a worker thread and a
    future is returned."""
    host = host_arrays(state)
    keys = list(host)
    treedef = _describe(state)

    def _write():
        final = os.path.join(directory, f"step_{step:08d}")
        tmp = final + ".tmp"
        os.makedirs(tmp, exist_ok=True)
        np.savez(os.path.join(tmp, "arrays.npz"),
                 **{k.replace("/", "%"): a for k, (a, _) in host.items()})
        manifest = {
            "step": step,
            # the port's own description of the tree: the reference's restore
            # reads only "keys" and "dtypes", so either package restores the
            # other's checkpoints whatever this string says
            "treedef": treedef,
            "keys": keys,
            "dtypes": {k: dtype for k, (_, dtype) in host.items()},
            "metadata": metadata or {},
        }
        with open(os.path.join(tmp, "manifest.msgpack.zst"), "wb") as f:
            f.write(compress_manifest(packb(manifest)))
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
        return final

    if blocking:
        return _write()
    return _EXEC.submit(_write)


def latest_step(directory: str) -> int | None:
    if not os.path.isdir(directory):
        return None
    steps = [int(d.split("_")[1]) for d in os.listdir(directory)
             if d.startswith("step_") and not d.endswith(".tmp")]
    return max(steps) if steps else None


def from_host(raw: np.ndarray, dtype: str) -> torch.Tensor:
    """A stored array -> its tensor (a uint16 view of bf16 back to bf16)."""
    if dtype == "bfloat16":
        return torch.from_numpy(raw.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(raw)


def _like_shape(leaf) -> tuple[int, ...]:
    if isinstance(leaf, int):
        return ()
    return global_shape(leaf) if isinstance(leaf, Stacked) else tuple(leaf.shape)


def place(arrays: dict[str, torch.Tensor], like, *, mesh: StackedMesh | None = None,
          mesh_cfg: MeshConfig | None = None):
    """Global host tensors by key -> the structure of ``like``, each leaf on
    ``like``'s device, in its dtype and layout (``requires_grad`` too); with
    ``mesh``, a ``Stacked`` leaf is split as ``param_pspecs`` splits it on
    that mesh (``mesh_cfg`` names its dp axes)."""
    dp = None
    if mesh is not None:
        dp = dp_axes(mesh_cfg or MeshConfig())
        if mesh.dp_rank_axes != dp:
            raise ValueError(f"{mesh} must stack exactly the dp axes {dp}")
    leaves = {}
    for path, leaf in _tree_paths(like):
        key = "/".join(path)
        if key not in arrays:
            raise KeyError(f"checkpoint missing leaf {key!r}")
        arr = arrays[key]
        want = _like_shape(leaf)
        if tuple(arr.shape) != want:
            raise ValueError(f"{key}: checkpoint shape {tuple(arr.shape)} != {want}")
        if isinstance(leaf, int):
            leaves[path] = int(arr)
        elif isinstance(leaf, Stacked):
            t = arr.to(device=leaf.local.device, dtype=leaf.local.dtype)
            spec, on = leaf.spec, leaf.mesh
            if mesh is not None:
                spec, on = _leaf_spec(path, arr, mesh, dp), mesh
            t = split_global(t, spec, on if on is not None else leaf.local.shape[0])
            leaves[path] = Stacked(t.requires_grad_(leaf.local.requires_grad), spec, on)
        else:
            t = arr.to(device=leaf.device, dtype=leaf.dtype)
            leaves[path] = t.requires_grad_(leaf.requires_grad)
    return _rebuild(like, leaves)


def restore(directory: str, step: int, like, *, mesh: StackedMesh | None = None,
            mesh_cfg: MeshConfig | None = None):
    """Load step ``step`` into the structure of ``like`` (its values are not
    read). Each leaf comes back on ``like``'s device and in its dtype; a
    ``Stacked`` leaf in ``like``'s layout, or split for ``mesh`` where one is
    given (elastic restore: another mesh than the saver's). A leaf that the
    checkpoint lacks raises ``KeyError``; another global shape ``ValueError``.
    Returns (tree, manifest)."""
    final = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(final, "manifest.msgpack.zst"), "rb") as f:
        manifest = unpackb(decompress_manifest(f.read()))
    with np.load(os.path.join(final, "arrays.npz")) as npz:
        arrays = {key: from_host(npz[key.replace("/", "%")], dtype)
                  for key, dtype in manifest["dtypes"].items()}
    return place(arrays, like, mesh=mesh, mesh_cfg=mesh_cfg), manifest
