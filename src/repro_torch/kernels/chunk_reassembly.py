"""Staging-ring to user-buffer scatter of the receive datapath.

Port of ``chunk_reassembly`` (src/repro/kernels/chunk_reassembly.py:41):
chunks staged in arrival order are copied to the user buffer at the offset
their PSN names, and the chunks written are marked in a per-chunk bitmap.

    staging (n_staged, chunk)  receive-ring contents, arrival order
    psn     (n_staged,)        destination chunk of each staged entry
    user    (n_chunks, chunk)  user buffer, updated IN PLACE
    n_valid                    staged entries [0, n_valid) are valid

returns ``(user, bitmap)``, bitmap (n_chunks,) u32 with 1 for every chunk
written. A later duplicate PSN wins, as in the reference's sequential grid.
Any dtype: the copy is bitwise.

``chunk_reassembly`` launches ``csrc/chunk_reassembly.cu`` for CUDA tensors
and runs ``chunk_reassembly_plain`` only for CPU tensors. On the card a
call is one ctypes call and no host synchronisation: the bitmap and the
winner scratch come from one ``torch.empty``, which the C entry zeroes on
the stream, and int32 or int64 PSNs are read in place. The PSNs' range is
checked on the device: a PSN outside ``[0, n_chunks)`` traps the kernel,
and the caller's next synchronise raises a CUDA error (the plain version
raises ``ValueError``). ``launches`` counts kernel launches, two per call
with a valid entry (the winner pass, then the scatter).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

launches = 0

_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_void_p]


def _check(staging: torch.Tensor, psn: torch.Tensor, user: torch.Tensor,
           n_valid: int | None) -> int:
    if staging.dim() != 2 or user.dim() != 2 or psn.dim() != 1:
        raise ValueError(f"need staging (n_staged, chunk), psn (n_staged,), user "
                         f"(n_chunks, chunk); got {tuple(staging.shape)}, "
                         f"{tuple(psn.shape)}, {tuple(user.shape)}")
    if staging.shape[1] != user.shape[1] or psn.shape[0] != staging.shape[0]:
        raise ValueError(f"shapes {tuple(staging.shape)}, {tuple(psn.shape)} and "
                         f"{tuple(user.shape)} do not match")
    if staging.shape[1] == 0:
        raise ValueError("chunks must not be empty")
    if staging.dtype != user.dtype:
        raise TypeError(f"staging is {staging.dtype}, user is {user.dtype}")
    if psn.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"psn must be int32 or int64, got {psn.dtype}")
    if not (staging.device == psn.device == user.device):
        raise ValueError(f"tensors on {staging.device}, {psn.device} and {user.device}")
    n_staged = staging.shape[0]
    n_valid = n_staged if n_valid is None else int(n_valid)
    if not 0 <= n_valid <= n_staged:
        raise ValueError(f"n_valid {n_valid} outside 0..{n_staged}")
    return n_valid


def chunk_reassembly_plain(staging: torch.Tensor, psn: torch.Tensor, user: torch.Tensor,
                           n_valid: int | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """The same scatter in plain torch: the last valid index per PSN wins."""
    n_valid = _check(staging, psn, user, n_valid)
    bitmap = torch.zeros(user.shape[0], dtype=torch.int32, device=user.device)
    if n_valid:
        # a read of the values on the host: the kernel checks on the device
        lo, hi = torch.aminmax(psn[:n_valid])
        if int(lo) < 0 or int(hi) >= user.shape[0]:
            raise ValueError(f"PSNs {int(lo)}..{int(hi)} outside 0..{user.shape[0] - 1}")
        p = psn[:n_valid].long()
        i = torch.arange(n_valid, device=p.device)
        winner = torch.full((user.shape[0],), -1, dtype=torch.long, device=p.device)
        winner.scatter_reduce_(0, p, i, "amax")
        won = winner[p] == i
        user[p[won]] = staging[:n_valid][won]
        bitmap[p] = 1
    return user, bitmap.view(torch.uint32)


def chunk_reassembly(staging: torch.Tensor, psn: torch.Tensor, user: torch.Tensor,
                     n_valid: int | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """Scatter staged chunks into ``user`` by PSN, in place; returns (user,
    bitmap). Launches the CUDA kernel for CUDA tensors (one ctypes call, no
    host synchronisation), runs the plain version for CPU tensors, and
    raises for any other device."""
    global launches
    if staging.is_cpu:
        return chunk_reassembly_plain(staging, psn, user, n_valid)
    if not staging.is_cuda:
        raise ValueError(f"chunk_reassembly runs on cuda or cpu tensors, got {staging.device}")
    n_valid = _check(staging, psn, user, n_valid)
    if not user.is_contiguous():
        raise ValueError("user must be contiguous: it is updated in place")
    if user.shape[0] >= 1 << 31 or staging.shape[0] >= 1 << 31:
        raise ValueError("more than 2^31 - 1 chunks")
    s, p = staging.contiguous(), psn.contiguous()
    n_chunks = user.shape[0]
    scratch = torch.empty(2 * n_chunks, dtype=torch.uint32, device=user.device)  # bitmap, winner
    build.launch(build.function("chunk_reassembly", "chunk_reassembly", _ARGTYPES), user,
                 s.data_ptr(), p.data_ptr(), p.element_size(), scratch.data_ptr(),
                 user.data_ptr(), n_valid, n_chunks, user.shape[1] * user.element_size())
    if n_valid:
        launches += 2   # winner_kernel, then the scatter
    return user, scratch[:n_chunks]
