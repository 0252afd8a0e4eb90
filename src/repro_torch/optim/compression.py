"""Gradient compression for the reduce-scatter path, with error feedback
(counterpart of ``repro.optim.compression``).

Blockwise symmetric int8 with error feedback: each leaf's f32 gradient plus
the residual carried from the last step is cut into blocks of ``block``
elements in the leaf's global flat order (zero-padded at the end), each
block scaled by its largest magnitude / 127 (at least 1e-12), rounded half
to even and clipped to [-127, 127]; the dequantized gradient goes on, and
what the rounding lost is the next step's residual (EF-SGD). The numbers
are the reference's, op for op, in plain torch, as the reference computes
them in plain jnp. Nothing on the training path calls it; wrap the
gradients between backward and the optimizer:

    comp, err = make_compressor(state.params, block=256)
    grads, err = comp(grads, err)      # quantize -> dequantize, plus EF

The trees are the train state's trees of ``Stacked`` leaves
(``sharding.fsdp.trainable``), or of plain tensors. A leaf split over
the mesh holds its distinct shards, (N, *local), whose concatenation is not
the global flat order where the split dim is not the first (a block of 256
would straddle shards, or take elements from several rows of a shard), so
each leaf is quantized as its global tensor (``fsdp.global_tensor``) and
split back (``fsdp.split_global``): the blocks are the reference's blocks
on its global array. The residual is kept in the gradients' layout, in f32.

``compression_ratio`` is the bytes on the wire against the uncompressed
gradient's: an int8 payload and one f32 scale per block.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.sharding.fsdp import global_tensor, split_global
from repro_torch.sharding.specs import Stacked, tree_leaves, tree_map


def _quant_block_int8(x: torch.Tensor, block: int):
    """Blockwise symmetric int8: returns (q int8 (blocks, block), scale f32
    (blocks, 1), x.numel())."""
    n = x.numel()
    pad = (-n) % block
    flat = F.pad(x.reshape(-1), (0, pad)).reshape(-1, block)
    # a true division, as jnp's: CUDA divides by a CPU scalar as a product
    # with its reciprocal, one bit off; a 0-dim tensor on x's device is not one
    div = torch.full((), 127.0, dtype=flat.dtype, device=flat.device)
    scale = torch.amax(torch.abs(flat), dim=1, keepdim=True) / div
    scale = torch.clamp(scale, min=1e-12)
    q = torch.clamp(torch.round(flat / scale), -127, 127).to(torch.int8)
    return q, scale, n


def _dequant_block_int8(q: torch.Tensor, scale: torch.Tensor, n: int, shape) -> torch.Tensor:
    return (q.to(torch.float32) * scale).reshape(-1)[:n].reshape(shape)


def compress_leaf(g: torch.Tensor, err: torch.Tensor, block: int):
    """One EF-compressed round trip of a global tensor: returns (g_hat in
    g's dtype, the new f32 residual)."""
    g32 = g.to(torch.float32) + err
    q, scale, n = _quant_block_int8(g32, block)
    g_hat = _dequant_block_int8(q, scale, n, g32.shape)
    return g_hat.to(g.dtype), g32 - g_hat


def _compress_stacked(g: Stacked, err: Stacked, block: int) -> tuple[Stacked, Stacked]:
    """``compress_leaf`` on a leaf's global tensor, split back into its layout."""
    g_hat, new_err = compress_leaf(global_tensor(g), global_tensor(err), block)
    mesh = g.mesh
    return (g._replace(local=split_global(g_hat, g.spec, mesh) if mesh else g_hat),
            err._replace(local=split_global(new_err, err.spec, mesh) if mesh else new_err))


def make_compressor(params, *, block: int = 256):
    """Returns (compress_fn, zero_error_state): ``compress_fn(grads, err) ->
    (g_hat, new_err)`` over trees shaped like ``params``."""
    def zeros(leaf):
        if isinstance(leaf, Stacked):
            return leaf._replace(local=torch.zeros(leaf.local.shape, dtype=torch.float32,
                                                   device=leaf.local.device))
        return torch.zeros(leaf.shape, dtype=torch.float32, device=leaf.device)

    err0 = tree_map(zeros, params)

    def compress(grads, err_state):
        out = iter([_compress_stacked(g, e, block) if isinstance(g, Stacked)
                    else compress_leaf(g, e, block)
                    for g, e in zip(tree_leaves(grads), tree_leaves(err_state))])
        pairs = tree_map(lambda _: next(out), grads)
        return tree_map(lambda t: t[0], pairs), tree_map(lambda t: t[1], pairs)

    return compress, err0


def compression_ratio(dtype_bits: int = 32, block: int = 256) -> float:
    """Wire bytes ratio: int8 payload + one f32 scale per block."""
    return dtype_bits / (8 + 32 / block)
