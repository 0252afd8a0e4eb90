"""Rank-batched matmul kernel with an f32 accumulator: the port of
``matmul_pallas`` (src/repro/kernels/collective_matmul.py:43).

``matmul(x, w)`` computes ``(R, M, K) @ (R, K, N) -> (R, M, N)`` rank by rank,
summing in f32 and rounding once to ``x.dtype``, for bf16 and f32. It is the
product under every gathered weight: the FSDP hot loop that module names,
allgather(weights) -> matmul. Operands may be strided views (a transposed
weight, the tied head ``embed^T``), so the backward products need no copies;
the output is a new contiguous tensor. ``csrc/matmul.cu`` says how the
kernel is built and what bounds it.

``matmul`` launches the kernel for CUDA tensors and runs ``matmul_plain``
only for CPU tensors; ``launches`` counts kernel launches. ``RankMatmul``
is the autograd Function whose forward and both backward products go
through ``matmul``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

launches = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_RANKS = 65535        # gridDim.z
_MAX_ROWS = 65535 * 64    # gridDim.y times the smaller (f32) row tile
_ARGTYPES = [ctypes.c_int,
             ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong,
             ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong,
             ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
             ctypes.c_void_p]


def _check(x: torch.Tensor, w: torch.Tensor) -> None:
    if x.dim() != 3 or w.dim() != 3:
        raise ValueError(f"matmul takes (R, M, K) and (R, K, N), got {tuple(x.shape)} "
                         f"and {tuple(w.shape)}")
    if x.shape[0] != w.shape[0] or x.shape[2] != w.shape[1]:
        raise ValueError(f"shapes {tuple(x.shape)} and {tuple(w.shape)} do not multiply")
    if x.dtype != w.dtype or x.dtype not in _DTYPES:
        raise TypeError(f"matmul takes two tensors of one of {list(_DTYPES)}, "
                        f"got {x.dtype} and {w.dtype}")
    if x.device != w.device:
        raise ValueError(f"operands on {x.device} and {w.device}")
    if min(x.shape) < 1 or w.shape[2] < 1:
        raise ValueError("matmul operands must not be empty")


def matmul_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The same product in plain torch: f32 sums, rounded once to x.dtype."""
    _check(x, w)
    return torch.bmm(x.float(), w.float()).to(x.dtype)


def matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(R, M, K) @ (R, K, N) -> (R, M, N) in x.dtype. Launches the CUDA
    kernel for CUDA tensors, runs the plain version for CPU tensors, and
    raises for any other device."""
    global launches
    if x.device.type == "cpu" and w.device.type == "cpu":
        return matmul_plain(x, w)
    if x.device.type != "cuda":
        raise ValueError(f"matmul runs on cuda or cpu tensors, got {x.device}")
    _check(x, w)
    r, m, k = x.shape
    n = w.shape[2]
    if r > _MAX_RANKS or m > _MAX_ROWS:
        raise ValueError(f"{r} ranks x {m} rows exceed the kernel's grid")
    out = torch.empty((r, m, n), dtype=x.dtype, device=x.device)
    fn = build.load("matmul").matmul
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(_DTYPES[x.dtype], x.data_ptr(), *x.stride(), w.data_ptr(), *w.stride(),
                 out.data_ptr(), r, m, n, k, stream)
    if err:
        raise RuntimeError(f"matmul launch failed: cudaError {err}")
    launches += 1
    return out


class RankMatmul(torch.autograd.Function):
    """y = x @ w rank by rank; dx = dy @ w^T and dw = x^T @ dy, all three on
    ``matmul`` (the transposes are views)."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        ctx.save_for_backward(x, w)
        return matmul(x, w)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dy: torch.Tensor):
        x, w = ctx.saved_tensors
        dy = dy.to(x.dtype)
        dx = matmul(dy, w.transpose(1, 2)) if ctx.needs_input_grad[0] else None
        dw = matmul(x.transpose(1, 2), dy) if ctx.needs_input_grad[1] else None
        return dx, dw
