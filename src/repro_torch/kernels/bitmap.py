"""Packed arrival bitmaps: the reliability state of the broadcast protocol.

Port of ``bitmap_pack`` (src/repro/kernels/bitmap.py:40) and
``bitmap_popcount`` (src/repro/kernels/bitmap.py:78), with the row-batched
forms the packet engine uses (``bitmap_pack_rows_np``,
``bitmap_popcount_rows_np`` of the JAX package) and the OR of packed rows
that builds the aggregated NACK. The word format is the reference's: bit i
of word w is ``flag[32 * w + i]``; words are ``torch.uint32``.

- ``bitmap_pack(flags)``: (..., n) flags, n % 32 == 0 -> (..., n / 32)
  words; a flag is set when it is not 0 (a uint8 of 2 to 255, an int32 of
  -1 or ``1 << 31`` too). 1-D is one NACK bitmap, 2-D one per row.
- ``bitmap_or_rows(words)``: (R, w) -> (w,), the OR of every row.
- ``bitmap_popcount(words)``: total set bits of (..., w) words (0-d int64);
  ``bitmap_popcount_rows``: per row of (R, w) (int64).
- ``bitmap_unpack(words, n)``: the inverse of pack, plain torch (it is not a
  TPU kernel).

Each of the first three launches ``csrc/bitmap.cu`` for a CUDA tensor and
runs its plain version only for a CPU tensor. The plain versions compute
in int64 (torch's uint32 has no shifts on the CPU) and return the same
values. ``pack_launches``, ``or_launches`` and ``popcount_launches`` count
kernel launches. A popcount call is one ctypes call and one launch into
an output from ``torch.empty``: the C entry zeroes it itself where a row
is long enough to be summed by several blocks (``csrc/bitmap.cu``).

The pack is one ctypes call and one launch too. Its kernel reads 16-byte
vectors (bound by the flag bytes); a flag base off 16 bytes takes a
warp-per-word kernel, chosen by the C entry. The replay packs 511 single
rows of 16,384 flags, where a call costs its host path, so the wrapper
keeps that path short: one device test, ``contiguous()`` only when the
flags are not, the words allocated as ``torch.uint32``, and the C entry
bound once.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

pack_launches = 0
or_launches = 0
popcount_launches = 0

_FLAG_BYTES = {torch.bool: 1, torch.uint8: 1, torch.int32: 4, torch.uint32: 4}
_pack = None   # the bound C entry of the pack, at its first launch
_SHIFTS = torch.arange(32, dtype=torch.int64)
_ARG_PACK = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong,
             ctypes.c_void_p]
_ARG_ROWS = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
             ctypes.c_void_p]


def _as_int64(words: torch.Tensor) -> torch.Tensor:
    """u32 words as their int64 values."""
    return words.view(torch.int32).to(torch.int64) & 0xFFFFFFFF


def _check_flags(flags: torch.Tensor) -> int:
    """The flags' width in bytes; raises on a dtype or shape the pack refuses."""
    width = _FLAG_BYTES.get(flags.dtype)
    if width is None:
        raise TypeError(f"flags must be one of {list(_FLAG_BYTES)}, got {flags.dtype}")
    if flags.dim() < 1 or flags.shape[-1] % 32:
        raise ValueError(f"flags need a last dim that is a multiple of 32, got "
                         f"{tuple(flags.shape)}")
    return width


def _check_words(words: torch.Tensor, dims: tuple[int, ...]) -> None:
    if words.dtype != torch.uint32:
        raise TypeError(f"words must be torch.uint32, got {words.dtype}")
    if words.dim() not in dims:
        raise ValueError(f"words must have {' or '.join(map(str, dims))} dims, got "
                         f"{tuple(words.shape)}")


def _device(t: torch.Tensor, name: str) -> None:
    if not t.is_cuda:
        raise ValueError(f"{name} runs on cuda or cpu tensors, got {t.device}")


# ------------------------------------------------------------------- plain


def bitmap_pack_plain(flags: torch.Tensor) -> torch.Tensor:
    _check_flags(flags)
    f = (flags != 0).to(torch.int64).reshape(*flags.shape[:-1], flags.shape[-1] // 32, 32)
    words = (f << _SHIFTS.to(flags.device)).sum(-1)
    words = torch.where(words >= 1 << 31, words - (1 << 32), words)   # the same 32 bits
    return words.to(torch.int32).view(torch.uint32)


def bitmap_or_rows_plain(words: torch.Tensor) -> torch.Tensor:
    _check_words(words, (2,))
    return bitmap_pack_plain(bitmap_unpack(words).any(0))


def bitmap_popcount_rows_plain(words: torch.Tensor) -> torch.Tensor:
    _check_words(words, (2,))
    bits = (_as_int64(words).unsqueeze(-1) >> _SHIFTS.to(words.device)) & 1
    return bits.sum((1, 2))


def bitmap_popcount_plain(words: torch.Tensor) -> torch.Tensor:
    _check_words(words, tuple(range(1, 9)))
    return bitmap_popcount_rows_plain(words.reshape(1, -1))[0]


def bitmap_unpack(words: torch.Tensor, n_chunks: int | None = None) -> torch.Tensor:
    """Packed (..., w) u32 -> (..., 32 w) bool flags, truncated to
    ``n_chunks`` when given."""
    _check_words(words, tuple(range(1, 9)))
    flags = ((_as_int64(words).unsqueeze(-1) >> _SHIFTS.to(words.device)) & 1).bool()
    flags = flags.reshape(*words.shape[:-1], 32 * words.shape[-1])
    return flags if n_chunks is None else flags[..., :n_chunks]


# ----------------------------------------------------------------- kernels


def bitmap_pack(flags: torch.Tensor) -> torch.Tensor:
    """(..., n) flags -> (..., n / 32) u32 words. Launches the CUDA kernel
    for a CUDA tensor, runs the plain version for a CPU tensor."""
    global pack_launches, _pack
    if flags.is_cpu:
        return bitmap_pack_plain(flags)
    if not flags.is_cuda:
        raise ValueError(f"bitmap_pack runs on cuda or cpu tensors, got {flags.device}")
    width = _check_flags(flags)
    if not flags.is_contiguous():
        flags = flags.contiguous()
    shape = flags.shape
    words = torch.empty((*shape[:-1], shape[-1] >> 5), dtype=torch.uint32, device=flags.device)
    n_words = flags.numel() >> 5
    if n_words:
        if _pack is None:
            _pack = build.function("bitmap", "bitmap_pack", _ARG_PACK)
        build.launch(_pack, flags, flags.data_ptr(), width, words.data_ptr(), n_words)
        pack_launches += 1
    return words


def bitmap_or_rows(words: torch.Tensor) -> torch.Tensor:
    """(R, w) u32 words -> (w,) u32, the OR of every row (the aggregated
    NACK). Launches the CUDA kernel for a CUDA tensor; plain on the CPU."""
    global or_launches
    if words.is_cpu:
        return bitmap_or_rows_plain(words)
    _device(words, "bitmap_or_rows")
    _check_words(words, (2,))
    w = words.contiguous()
    out = torch.zeros(w.shape[1], dtype=torch.int32, device=w.device)
    if w.numel():
        build.launch(build.function("bitmap", "bitmap_or_rows", _ARG_ROWS), w, w.data_ptr(),
                     out.data_ptr(), w.shape[0], w.shape[1])
        or_launches += 1
    return out.view(torch.uint32)


def _popcount(w: torch.Tensor, out: torch.Tensor, rows: int, n_words: int) -> torch.Tensor:
    """One launch: the set bits of each of ``rows`` rows of ``n_words``
    contiguous words of ``w`` into int64 ``out``."""
    global popcount_launches
    build.launch(build.function("bitmap", "bitmap_popcount_rows", _ARG_ROWS), w, w.data_ptr(),
                 out.data_ptr(), rows, n_words)
    popcount_launches += 1
    return out


def bitmap_popcount_rows(words: torch.Tensor) -> torch.Tensor:
    """(R, w) u32 words -> (R,) int64 set-bit counts. Launches the CUDA
    kernel for a CUDA tensor; plain on the CPU."""
    if words.is_cpu:
        return bitmap_popcount_rows_plain(words)
    _device(words, "bitmap_popcount")
    _check_words(words, (2,))
    w = words.contiguous()
    out = torch.empty(w.shape[0], dtype=torch.int64, device=w.device)
    return _popcount(w, out, w.shape[0], w.shape[1]) if w.shape[0] else out


def bitmap_popcount(words: torch.Tensor) -> torch.Tensor:
    """Total set bits of (..., w) u32 words, a 0-d int64 tensor. Launches
    the CUDA kernel for a CUDA tensor; plain on the CPU."""
    if words.is_cpu:
        return bitmap_popcount_plain(words)
    _device(words, "bitmap_popcount")
    _check_words(words, tuple(range(1, 9)))
    w = words.contiguous()
    return _popcount(w, torch.empty((), dtype=torch.int64, device=w.device), 1, w.numel())
