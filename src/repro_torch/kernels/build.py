"""Builds the port's CUDA kernels with nvcc and loads them with ctypes.

Every ``src/repro_torch/kernels/csrc/<name>.cu`` is compiled on its own
into ``build/repro_torch/<name>-<hash>.so`` at the repository root, at
first use, with

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC

The hash covers the source and the flags, so an edited kernel rebuilds
and an unchanged one is loaded as built. `build_all()` starts one nvcc
per source at once and waits for all of them. The sources have a plain C
interface (no PyTorch headers), which keeps a build to seconds; each
entry point takes pointers and the stream as ``void*`` and returns
``cudaGetLastError()``, which the wrappers turn into an exception. Each
library built by nvcc and each loaded with ctypes counts as a kernel build
in `analysis.guards.track_compiles`.
Nothing here runs at import: this module is imported on machines with
no nvcc and no card.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

from repro_torch.analysis.guards import record_compile

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_LIBS: dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found on PATH or under CUDA_HOME; the "
                           "port's CUDA kernels are built from source")
    return str(path)


def sources() -> list[str]:
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def _target(name: str) -> Path:
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def _start(name: str):
    """Start nvcc for `name` unless its library is built; returns
    (process or None, tmp path, target path)."""
    target = _target(name)
    if target.exists():
        return None, None, target
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, target


def _finish(name: str, proc, tmp: Path, target: Path) -> None:
    if proc is None:
        return
    out, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {name}.cu "
                           f"(exit {proc.returncode}):\n{out}")
    os.replace(tmp, target)   # atomic: concurrent builders agree
    record_compile("kernel_builds")


def build_all() -> list[Path]:
    """Build every kernel source in parallel; returns the libraries."""
    with _LOCK:
        started = {n: _start(n) for n in sources()}
        for n, (proc, tmp, target) in started.items():
            _finish(n, proc, tmp, target)
        return [t for _, _, t in started.values()]


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu`` (built at first use)."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            proc, tmp, target = _start(name)
            _finish(name, proc, tmp, target)
            # analysis: allow=retrace-ctor -- loaded once a library, cached
            # in _LIBS
            lib = ctypes.CDLL(str(target))
            _LIBS[name] = lib
            record_compile("kernel_builds")
        return lib


def attributes(name: str, fields, d: int, entry: str | None = None) -> dict:
    """What ``<name>_attributes(d, out)`` (or the entry point `entry`) of
    ``csrc/<name>.cu`` reports of its kernel at width `d` on the current
    device, named by `fields`."""
    entry = entry or f"{name}_attributes"
    fn = getattr(load(name), entry)
    fn.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    out = (ctypes.c_int * len(fields))()
    check(fn(d, out), entry)
    return dict(zip(fields, out))


def check(err: int, what: str) -> None:
    """Raise on a non-zero cudaError_t returned by a C entry point."""
    if err != 0:
        raise RuntimeError(f"CUDA launch of {what} failed: cudaError {err}")
