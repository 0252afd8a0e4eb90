"""Pool-completion scan of the leaf receive pool, with its staging-ring mask.

Port of ``pool_scan_rows`` (src/repro/kernels/pool.py:53) and
``pool_completion_rows`` (src/repro/kernels/pool.py:86). A W-worker pool
with deterministic service s, fed sorted arrivals a, finishes chunk
e = i * W + lane at

    done[e] = (i + 1) * s + max_{j <= i} (a[j * W + lane] - j * s)

per row of an (R, n) matrix; ragged rows are padded at the end with +inf,
which comes back +inf. ``pool_completion_rows`` adds the staging-ring (RNR)
mask ``done[:, :n - staging] > a[:, staging:]`` (padded columns False).
Both are bitwise equal, in f64, to the JAX package's numpy twin
``pool_completion_rows_np`` that its packet engine runs.

``pool_scan_rows`` and ``pool_completion_rows`` launch ``csrc/pool.cu`` for
a CUDA tensor (f64, W <= 1024) and run the plain versions only for a CPU
tensor; ``launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes
import math

import torch
import torch.nn.functional as F

from repro_torch.kernels import build

launches = 0

_MAX_WORKERS = 1024   # one tile of the kernel holds every lane
_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
             ctypes.c_longlong, ctypes.c_int, ctypes.c_double, ctypes.c_longlong,
             ctypes.c_void_p]


def _check(arrivals: torch.Tensor) -> None:
    if arrivals.dim() != 2:
        raise ValueError(f"arrivals must be (R, n), got {tuple(arrivals.shape)}")
    if not arrivals.is_floating_point():
        raise TypeError(f"arrivals must be floating point, got {arrivals.dtype}")


def pool_scan_rows_plain(arrivals: torch.Tensor, n_workers: int,
                         service: float) -> torch.Tensor:
    """The scan in plain torch over the (R, n/W, W) view, in the arrivals'
    dtype: subtract ``i * s``, running max along i, add ``(i + 1) * s``."""
    _check(arrivals)
    rows, n = arrivals.shape
    if rows == 0 or n == 0:
        return torch.empty_like(arrivals)
    w = max(int(n_workers), 1)
    pad = (-n) % w
    n_per = (n + pad) // w
    a = F.pad(arrivals, (0, pad), value=math.inf) if pad else arrivals
    i = torch.arange(n_per, dtype=arrivals.dtype, device=arrivals.device).view(1, n_per, 1)
    x = a.reshape(rows, n_per, w) - i * service
    done = torch.cummax(x, dim=1).values + (i + 1.0) * service
    return done.reshape(rows, n_per * w)[:, :n].contiguous()


def rnr_mask_plain(done: torch.Tensor, arrivals: torch.Tensor, staging: int) -> torch.Tensor:
    """Chunk k is dropped when the chunk ``staging`` places ahead is still
    unserviced at k's arrival."""
    mask = torch.zeros(arrivals.shape, dtype=torch.bool, device=arrivals.device)
    n = arrivals.shape[1]
    if n > staging:
        mask[:, staging:] = done[:, : n - staging] > arrivals[:, staging:]
    return mask


def pool_completion_rows_plain(arrivals: torch.Tensor, n_workers: int, service: float,
                               staging: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(done, rnr mask) in plain torch."""
    done = pool_scan_rows_plain(arrivals, n_workers, service)
    return done, rnr_mask_plain(done, arrivals, staging)


def _launch(arrivals: torch.Tensor, n_workers: int, service: float,
            staging: int | None) -> tuple[torch.Tensor, torch.Tensor | None]:
    global launches
    if not arrivals.is_cuda:
        raise ValueError(f"the pool scan runs on cuda or cpu tensors, got {arrivals.device}")
    _check(arrivals)
    if arrivals.dtype != torch.float64:
        raise TypeError(f"the pool kernel takes float64 arrivals, got {arrivals.dtype}")
    w = max(int(n_workers), 1)
    if w > _MAX_WORKERS:
        raise ValueError(f"the pool kernel takes at most {_MAX_WORKERS} workers, got {w}")
    if staging is not None and staging < 0:
        raise ValueError(f"staging must be >= 0, got {staging}")
    a = arrivals.contiguous()
    rows, n = a.shape
    done = torch.empty_like(a)
    mask = (None if staging is None
            else torch.empty(a.shape, dtype=torch.bool, device=a.device))
    if rows == 0 or n == 0:
        return done, mask
    if rows >= 1 << 31:
        raise ValueError(f"{rows} rows exceed the kernel's grid")
    build.launch(build.function("pool", "pool_completion_rows", _ARGTYPES), a, a.data_ptr(),
                 done.data_ptr(), None if mask is None else mask.data_ptr(), rows, n, w,
                 float(service), 0 if staging is None else staging)
    launches += 1
    return done, mask


def pool_scan_rows(arrivals: torch.Tensor, n_workers: int, service: float) -> torch.Tensor:
    """(R, n) sorted arrival rows -> (R, n) pool completion times. Launches
    the CUDA kernel for a CUDA tensor, runs the plain version for a CPU
    tensor, and raises for any other device."""
    if arrivals.is_cpu:
        return pool_scan_rows_plain(arrivals, n_workers, service)
    return _launch(arrivals, n_workers, service, None)[0]


def pool_completion_rows(arrivals: torch.Tensor, n_workers: int, service: float,
                         staging: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Scan + staging-ring RNR mask of (R, n) sorted arrival rows, in one
    launch for a CUDA tensor; the plain version for a CPU tensor."""
    if arrivals.is_cpu:
        return pool_completion_rows_plain(arrivals, n_workers, service, staging)
    return _launch(arrivals, n_workers, service, staging)
