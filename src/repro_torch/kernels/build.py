"""Builds the port's CUDA sources and loads them with ctypes.

Each ``csrc/<name>.cu`` exposes a plain C interface and compiles on its own
with ``nvcc`` for ``sm_90a`` into ``build/<name>-<hash>.so`` at the root of
the checkout, named by the hash of its source and flags, so an edited
source builds anew and an unchanged one is reused. ``pool.cu`` is built
with ``-fmad=false``: its f64 scan must round each multiply and add on its
own, as numpy does. ``build`` starts one ``nvcc`` per
missing library, all at once, and waits for them; ``load`` builds one
library if needed and opens it. Nothing is built when a module is imported.

Every wrapper launches through the two functions at the end: ``function``
binds a C entry point once (its ``argtypes`` and ``restype`` set at the
first call, then cached per library and symbol), and ``launch`` calls it
on the current raw stream of the tensor's device, switching the device
only when the tensor is not on the current one, and raises when the entry
point returns a CUDA error. A launch from Python then costs a dict lookup,
two integer queries and the ctypes call, where each wrapper used to set
``argtypes``, enter ``torch.cuda.device`` and build a ``torch.cuda.Stream``
on every call.
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

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD = Path(__file__).resolve().parents[3] / "build"
SOURCES = ("ring_allgather", "ring_allgather_transpose", "matmul", "pool", "bitmap",
           "chunk_reassembly", "double_buffer_drain")
_FLAGS = {"pool": ("-fmad=false",)}

_libs: dict[str, ctypes.PyDLL] = {}
_functions: dict[tuple[str, str], ctypes._CFuncPtr] = {}


def _target(name: str) -> Path:
    key = (CSRC / f"{name}.cu").read_bytes() + " ".join(_FLAGS.get(name, ())).encode()
    digest = hashlib.sha256(key).hexdigest()[:16]
    return BUILD / f"{name}-{digest}.so"


def _nvcc() -> str:
    return shutil.which("nvcc") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")


def build(names=SOURCES) -> dict[str, Path]:
    """Compile every source of ``names`` that has no library yet, one
    ``nvcc`` each, in parallel. Raises with nvcc's errors if any fails."""
    out = {name: _target(name) for name in names}
    todo = {name: path for name, path in out.items() if not path.exists()}
    if not todo:
        return out
    BUILD.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, path in todo.items():
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD)
        os.close(fd)
        cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
               "-shared", "-Xcompiler", "-fPIC", *_FLAGS.get(name, ()), "-o", tmp,
               str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                        text=True), tmp)
    errors = []
    for name, (proc, tmp) in procs.items():
        _, err = proc.communicate()
        if proc.returncode != 0:
            os.unlink(tmp)
            errors.append(f"nvcc failed on {name}.cu ({proc.returncode}):\n{err}")
        else:
            os.replace(tmp, todo[name])  # atomic: concurrent builds all end with one file
    if errors:
        raise RuntimeError("\n".join(errors))
    return out


def load(name: str) -> ctypes.PyDLL:
    """The library of ``csrc/<name>.cu``, built at its first use. Opened as
    a ``PyDLL``: its entry points only check their arguments and enqueue
    work on a stream, so a call keeps the GIL rather than releasing and
    taking it back around a few microseconds of C."""
    if name not in _libs:
        _libs[name] = ctypes.PyDLL(str(build((name,))[name]))
    return _libs[name]


def function(lib: str, symbol: str, argtypes: list) -> ctypes._CFuncPtr:
    """The C entry point ``symbol`` of ``csrc/<lib>.cu``, bound once: its
    ``argtypes`` set to ``argtypes`` and its ``restype`` to ``int`` (every
    entry point returns 0, or ``cudaGetLastError()``'s error, or a code of
    its own: the matmul's tensor-map encoder) at the first call, then
    cached per (lib, symbol). The last argument of every entry point is the
    stream, which ``launch`` supplies."""
    fn = _functions.get((lib, symbol))
    if fn is None:
        fn = getattr(load(lib), symbol)
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
        _functions[lib, symbol] = fn
    return fn


def launch(fn: ctypes._CFuncPtr, t: torch.Tensor, *args) -> None:
    """``fn(*args, stream)`` with the current raw stream of ``t``'s CUDA
    device, on that device: the current device is switched only when ``t``
    lies on another. Raises if ``fn`` returns an error (a refused launch
    never runs, and a synchronise would not report it)."""
    dev = t.get_device()
    if dev == torch._C._cuda_getDevice():
        err = fn(*args, torch._C._cuda_getCurrentRawStream(dev))
    else:
        with torch.cuda.device(dev):
            err = fn(*args, torch._C._cuda_getCurrentRawStream(dev))
    if err:
        raise RuntimeError(f"{fn.__name__} launch failed: error {err}")
