"""Builds the port's CUDA sources and loads them with ctypes.

Each ``csrc/<name>.cu`` exposes a plain C interface and compiles on its own
with ``nvcc`` for ``sm_90a`` into ``build/<name>-<hash>.so`` at the root of
the checkout, named by the hash of its source and flags, so an edited
source builds anew and an unchanged one is reused. ``pool.cu`` is built
with ``-fmad=false``: its f64 scan must round each multiply and add on its
own, as numpy does. ``build`` starts one ``nvcc`` per
missing library, all at once, and waits for them; ``load`` builds one
library if needed and opens it. Nothing is built when a module is imported.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD = Path(__file__).resolve().parents[3] / "build"
SOURCES = ("ring_step", "ring_step_transpose", "matmul", "pool", "bitmap", "chunk_reassembly",
           "double_buffer_drain")
_FLAGS = {"pool": ("-fmad=false",)}

_libs: dict[str, ctypes.CDLL] = {}


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


def load(name: str) -> ctypes.CDLL:
    """The library of ``csrc/<name>.cu``, built at its first use."""
    if name not in _libs:
        _libs[name] = ctypes.CDLL(str(build((name,))[name]))
    return _libs[name]
