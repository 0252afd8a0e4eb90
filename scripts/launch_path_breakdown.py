#!/usr/bin/env python3
"""Host time of one kernel launch from Python, split into its parts, on one
CUDA card:

    python3 scripts/launch_path_breakdown.py

For the double-buffered drain at (8, 128, 576) bf16 and one ring step
(step 0) on wq's ring buffer at P = 8 (smollm-135m; a one-entry launch of
the gather's kernel, ``csrc/ring_allgather.cu``, that installs nothing),
it times each part of
a wrapper's call alone: the argument checks, the output's allocation (the
drain), the binding of the C entry point, the device guard, the stream
lookup and the ctypes call (which launches the kernel). Each of the last
four is timed two ways: ``after``, the shared launch path of
``src/repro_torch/kernels/build.py`` (``function`` binds once; ``launch``
reads the raw current stream and switches the device only when it
differs; the library a ``PyDLL``), and ``before``, as every wrapper took
them on each call until that path existed (``argtypes`` set per call,
``torch.cuda.device`` entered, the stream read from a
``torch.cuda.Stream``, the library a ``CDLL``). Then the whole wrapper both
ways (``before`` with those two functions swapped in), and ``clone()``
beside the drain. Host us are medians of 5 runs of 200 back-to-back calls;
ms per call are from CUDA events. Prints one JSON line per kernel and the
card's name and power limit. The kernels are built with ``nvcc`` into
``build/`` at the first call.
"""
from __future__ import annotations

import contextlib
import ctypes
import json
import os
import statistics
import subprocess
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

from repro_torch.core import collectives as C  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import ring_allgather as K  # noqa: E402

REPEATS = 5


def _host_us(fn, n: int = 200) -> float:
    """Median over REPEATS runs of the host us per call of ``fn``, n calls
    back to back in each run (synchronised before it)."""
    out = []
    for _ in range(REPEATS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        out.append((time.perf_counter() - t0) / n * 1e6)
    torch.cuda.synchronize()
    return statistics.median(out)


def _ms(fn, iters: int = 200) -> float:
    """ms per call from CUDA events around ``iters`` back-to-back calls,
    after a warm-up."""
    for _ in range(10):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


_CDLLS: dict[str, ctypes.CDLL] = {}


def _per_call_bind(lib: str, symbol: str, argtypes: list) -> ctypes._CFuncPtr:
    """Binding as every wrapper did it before ``build.function``: on each
    call, in the library opened as a ``CDLL``."""
    if lib not in _CDLLS:
        _CDLLS[lib] = ctypes.CDLL(str(build.build((lib,))[lib]))
    fn = getattr(_CDLLS[lib], symbol)
    fn.argtypes, fn.restype = argtypes, ctypes.c_int
    return fn


def _per_call_launch(fn: ctypes._CFuncPtr, t: torch.Tensor, *args) -> None:
    """The launch as every wrapper made it before ``build.launch``: inside
    ``torch.cuda.device``, the stream read from a ``torch.cuda.Stream``."""
    with torch.cuda.device(t.device):
        err = fn(*args, torch.cuda.current_stream(t.device).cuda_stream)
    if err:
        raise RuntimeError(f"{fn.__name__} launch failed: error {err}")


@contextlib.contextmanager
def _per_call_path():
    """The wrappers run with the per-call binding and launch swapped in."""
    function, launch = build.function, build.launch
    build.function, build.launch = _per_call_bind, _per_call_launch
    try:
        yield
    finally:
        build.function, build.launch = function, launch


def breakdown() -> dict:
    gen = torch.Generator(device="cuda").manual_seed(10)
    x = torch.randn((8, 128, 576), generator=gen, device="cuda").bfloat16()
    out_x = torch.empty_like(x)
    n = 576 * 576 // 8
    buf = C._ring_buffer(torch.randn((8, n), generator=gen, device="cuda").bfloat16())
    ((packed, _),), _ = K._packed(((0, 1, None, 1, 0),), 8, n)   # step 0, the whole slot
    dev = x.get_device()
    cases = {
        "double_buffer_drain": dict(
            lib=("double_buffer_drain", "double_buffer_drain", K._DRAIN_ARGTYPES), t=x,
            args=(x.data_ptr(), out_x.data_ptr(), 8, x.nbytes // 8),
            checks=lambda: (x.is_cpu, x.is_cuda, K._check_staged(x), x.shape[0] > K._MAX_ROWS,
                            x.numel() == 0),
            allocation=lambda: torch.empty_like(x),
            call=lambda: K.local_double_buffer_drain(x)),
        "ring_step": dict(
            lib=("ring_allgather", "ring_allgather", K._ALLGATHER_ARGTYPES), t=buf,
            args=(None, buf.data_ptr(), 1, 1, 8, n, packed, 1),
            checks=lambda: (buf.is_cpu, buf.is_cuda, K._check_buf(buf),
                            K._packed(((0, 1, None, 1, 0),), 8, n)),
            allocation=None,
            call=lambda: K.ring_step(buf, 0))}
    result = {}
    for name, c in cases.items():
        t, lib = c["t"], c["lib"]
        fn, cdll_fn = build.function(*lib), _per_call_bind(*lib)
        stream = torch._C._cuda_getCurrentRawStream(dev)

        def guard_before(t=t):
            with torch.cuda.device(t.device):
                pass

        row = {"checks_us": _host_us(c["checks"]),
               "allocation_us": _host_us(c["allocation"]) if c["allocation"] else 0.0,
               "binding_us_before": _host_us(lambda: _per_call_bind(*lib)),
               "binding_us_after": _host_us(lambda: build.function(*lib)),
               "device_guard_us_before": _host_us(guard_before),
               "device_guard_us_after": _host_us(
                   lambda: t.get_device() == torch._C._cuda_getDevice()),
               "stream_us_before": _host_us(
                   lambda: torch.cuda.current_stream(t.device).cuda_stream),
               "stream_us_after": _host_us(lambda: torch._C._cuda_getCurrentRawStream(dev)),
               "ctypes_call_us_before": _host_us(lambda: cdll_fn(*c["args"], stream)),
               "ctypes_call_us_after": _host_us(lambda: fn(*c["args"], stream)),
               "whole_us_after": _host_us(c["call"]),
               "ms_after": _ms(c["call"])}
        with _per_call_path():
            row["whole_us_before"] = _host_us(c["call"])
            row["ms_before"] = _ms(c["call"])
        row["whole_us_after_again"] = _host_us(c["call"])
        if name == "double_buffer_drain":
            row["clone_us"] = _host_us(lambda: x.clone())
            row["clone_ms"] = _ms(lambda: x.clone())
        parts = ("checks_us", "allocation_us", "binding_us_{}", "device_guard_us_{}",
                 "stream_us_{}", "ctypes_call_us_{}")
        for when in ("before", "after"):
            row[f"parts_sum_us_{when}"] = sum(row[k.format(when)] for k in parts)
        print(f"[launch_path] {name} " + json.dumps(row), flush=True)
        result[name] = row
    return result


def main() -> int:
    if not torch.cuda.is_available():
        print("launch_path_breakdown: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    build.build(("double_buffer_drain", "ring_allgather"))
    breakdown()
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
