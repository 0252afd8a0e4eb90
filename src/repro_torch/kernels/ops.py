"""The public wrappers of the port's kernels: the counterpart of
``repro.kernels.ops``, with the same names.

The reference jits its Pallas kernels here (interpret mode on the CPU). The
port runs eagerly: each name is the port's kernel wrapper, which launches
the CUDA kernel for CUDA tensors and runs the plain version for CPU ones.
Arguments that only pick the Pallas kernel's tiles (``block_words``,
``block``, ``bm``/``bk``/``bn``) are checked against the reference's
preconditions on them, so the same calls are refused, and change nothing
else. ``interpret`` is a Pallas mode that the port has no counterpart of:
anything but None raises.

- ``reassemble``: chunk reassembly, updating ``user`` in place (the
  reference aliases it).
- ``matmul`` / ``matmul_pallas``: the 2-D ``(m, k) @ (k, n)``, on the port's
  rank-batched kernel at one rank.
- ``pack_bitmap`` / ``popcount``: the packed arrival bitmap and its set-bit
  count (a 0-d int64 tensor; the reference's is uint32).
- ``allgather_matmul_local`` / ``make_allgather_matmul``: the allgather-fused
  matmul on the stacked backend (``kernels/collective_matmul.py``).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import bitmap, chunk_reassembly
from repro_torch.kernels import collective_matmul as cm
from repro_torch.kernels.collective_matmul import allgather_matmul_local, make_allgather_matmul


def _no_interpret(interpret) -> None:
    if interpret is not None:
        raise NotImplementedError("interpret mode is a Pallas option; the port runs its "
                                  "plain version for CPU tensors")


def reassemble(staging: torch.Tensor, psn: torch.Tensor, user: torch.Tensor,
               n_valid: int | None = None, *, interpret=None):
    """Staged chunks into ``user`` by PSN -> (user, bitmap)."""
    _no_interpret(interpret)
    return chunk_reassembly.chunk_reassembly(staging, psn, user, n_valid)


def matmul_pallas(x: torch.Tensor, w: torch.Tensor, *, bm: int = 128, bk: int = 128,
                  bn: int = 128, interpret=None) -> torch.Tensor:
    """(m, k) @ (k, n) summed in f32, in x.dtype."""
    _no_interpret(interpret)
    if x.dim() != 2 or w.dim() != 2:
        raise ValueError(f"matmul takes (m, k) and (k, n), got {tuple(x.shape)} and "
                         f"{tuple(w.shape)}")
    cm._check_tiles(x.shape[0], x.shape[1], w.shape[1], bm, bk, bn)
    return cm.matmul(x[None], w[None])[0]


matmul = matmul_pallas


def pack_bitmap(flags: torch.Tensor, *, block_words: int = 256, interpret=None) -> torch.Tensor:
    """(n,) 0/1 flags, n % 32 == 0 -> (n / 32,) u32 words."""
    _no_interpret(interpret)
    if flags.dim() != 1 or flags.shape[0] % 32:
        raise ValueError(f"flags must be (n,) with n % 32 == 0, got {tuple(flags.shape)}")
    cm.check_tile(flags.shape[0] // 32, block_words, "words")
    return bitmap.bitmap_pack(flags)


def popcount(words: torch.Tensor, *, block: int = 1024, interpret=None) -> torch.Tensor:
    """Total set bits of (n,) u32 words."""
    _no_interpret(interpret)
    if words.dim() != 1:
        raise ValueError(f"words must be (n,), got {tuple(words.shape)}")
    cm.check_tile(words.shape[0], block, "words")
    return bitmap.bitmap_popcount(words)


__all__ = [
    "allgather_matmul_local",
    "make_allgather_matmul",
    "matmul",
    "matmul_pallas",
    "pack_bitmap",
    "popcount",
    "reassemble",
]
