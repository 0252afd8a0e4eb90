"""Ring-step kernel of the stacked collective backend.

Replaces ``ring_allgather_tpu`` (src/repro/kernels/ring_allgather.py:46), the
Pallas kernel in which device d remote-DMAs shard ``(d - s) % P`` to device
``(d + 1) % P`` at grid step s of P - 1. On one GPU the P ranks are dim 1 of
a stacked buffer ``(G, P_rank, P_slot, n)`` and a launch of
``csrc/ring_step.cu`` does one step for every rank at once, following the
same ``ring_schedule``.

Bound: HBM bytes. A step reads and writes one slot per rank,
2 * P * n * itemsize bytes, with no arithmetic. The kernel copies 16-byte
vectors in a grid-stride loop over one rank's slot per block row, with a
scalar head and tail for spans off a 16-byte boundary. At the shapes of a
smollm-135m layer a step moves a few MB, about a microsecond at HBM speed,
so the launch itself dominates; fusing steps is later work.

``ring_step`` launches the kernel for a CUDA tensor and runs
``ring_step_plain`` only for a CPU tensor. ``launches`` counts kernel
launches. The kernel is compiled with ``nvcc`` into ``build/`` at the root
of the checkout at its first launch.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

launches = 0

_SRC = Path(__file__).resolve().parents[1] / "csrc" / "ring_step.cu"
_BUILD = Path(__file__).resolve().parents[3] / "build"
_DTYPES = (torch.bfloat16, torch.float16, torch.float32)
_MAX_ROWS = 65535  # gridDim.y
_lib = None


def ring_schedule(n_devices: int) -> list[list[tuple[int, int, int]]]:
    """The (sender, receiver, shard) triples per step of the ring allgather."""
    steps = []
    for s in range(n_devices - 1):
        trip = []
        for d in range(n_devices):
            src_shard = (d - s) % n_devices
            trip.append((d, (d + 1) % n_devices, src_shard))
        steps.append(trip)
    return steps


def _check(buf: torch.Tensor, step: int, direction: int, split: int | None,
           rounds: int, active_round: int) -> int:
    if buf.dim() < 3:
        raise ValueError(f"ring buffer must be (..., P, P, n), got {tuple(buf.shape)}")
    p, p2, n = buf.shape[-3:]
    if p != p2:
        raise ValueError(f"ring buffer needs P ranks x P slots, got {tuple(buf.shape)}")
    if buf.dtype not in _DTYPES:
        raise TypeError(f"ring_step supports {_DTYPES}, got {buf.dtype}")
    if not buf.is_contiguous():
        raise ValueError("ring buffer must be contiguous")
    if n < 1:
        raise ValueError("ring buffer slots are empty")
    if not 0 <= step < p - 1:
        raise ValueError(f"step {step} outside 0..{p - 2}")
    if direction not in (1, -1):
        raise ValueError(f"direction must be +1 or -1, got {direction}")
    if rounds < 1 or p % rounds or not 0 <= active_round < rounds:
        raise ValueError(f"bad round mask {active_round}/{rounds} for P={p}")
    split = n if split is None else split
    if not 0 <= split <= n:
        raise ValueError(f"split {split} outside 0..{n}")
    return split


def ring_step_plain(buf: torch.Tensor, step: int, *, direction: int = 1,
                    split: int | None = None, rounds: int = 1,
                    active_round: int = 0) -> torch.Tensor:
    """The same ring step in plain torch, in place on ``buf`` (..., P, P, n):
    ``buf[..., (d + dir) % P, src] = buf[..., d, src]`` with
    ``src = (d - dir * step) % P`` for elements [0, split) and the mirror
    step along ``-dir`` for [split, n); only slots with
    ``src % rounds == active_round`` move."""
    split = _check(buf, step, direction, split, rounds, active_round)
    p, n = buf.shape[-2], buf.shape[-1]
    d = torch.arange(p, device=buf.device)
    for lo, hi, dr in ((0, split, direction), (split, n, -direction)):
        if hi == lo:
            continue
        src = (d - dr * step) % p
        keep = src % rounds == active_round
        snd, src = d[keep], src[keep]
        rcv = (snd + dr) % p
        buf[..., rcv, src, lo:hi] = buf[..., snd, src, lo:hi]
    return buf


def _build() -> Path:
    """Compile csrc/ring_step.cu into build/ (named by its content hash)."""
    digest = hashlib.sha256(_SRC.read_bytes()).hexdigest()[:16]
    out = _BUILD / f"ring_step-{digest}.so"
    if out.exists():
        return out
    nvcc = shutil.which("nvcc") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    _BUILD.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD)
    os.close(fd)
    cmd = [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
           "-shared", "-Xcompiler", "-fPIC", "-o", tmp, str(_SRC)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n{res.stderr}")
    os.replace(tmp, out)  # atomic: concurrent builds all end with one file
    return out


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(_build()))
        lib.ring_step.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
            ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
            ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ]
        lib.ring_step.restype = ctypes.c_int
        _lib = lib
    return _lib


def ring_step(buf: torch.Tensor, step: int, *, direction: int = 1,
              split: int | None = None, rounds: int = 1,
              active_round: int = 0) -> torch.Tensor:
    """One ring step, in place on ``buf`` (..., P, P, n); see ``ring_step_plain``.
    Launches the CUDA kernel for a CUDA tensor, runs the plain version for a
    CPU tensor, and raises for any other device."""
    global launches
    if buf.device.type == "cpu":
        return ring_step_plain(buf, step, direction=direction, split=split,
                               rounds=rounds, active_round=active_round)
    if buf.device.type != "cuda":
        raise ValueError(f"ring_step runs on cuda or cpu tensors, got {buf.device}")
    split = _check(buf, step, direction, split, rounds, active_round)
    p, n = buf.shape[-2], buf.shape[-1]
    if split == 0:  # everything moves along -direction
        direction, split = -direction, n
    groups = buf.numel() // (p * p * n)
    if groups * p > _MAX_ROWS:
        raise ValueError(f"{groups} groups x {p} ranks exceed {_MAX_ROWS} block rows")
    lib = _library()
    with torch.cuda.device(buf.device):
        stream = torch.cuda.current_stream(buf.device).cuda_stream
        err = lib.ring_step(buf.data_ptr(), buf.element_size(), groups, p, n, step,
                            direction, split, rounds, active_round, stream)
    if err:
        raise RuntimeError(f"ring_step launch failed: cudaError {err}")
    launches += 1
    return buf
