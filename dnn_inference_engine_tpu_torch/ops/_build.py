"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface and compiles on its own
(with the shared ``csrc/*.cuh`` headers it includes)
with ``nvcc`` into ``build/kernels/lib<name>.so`` at the root of the
checkout, at first use; ``ctypes`` loads it. Nothing here runs at import
time, so the package imports on a machine with no CUDA toolkit.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, List, Optional

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (set CUDA_HOME or put nvcc on PATH)")


def _paths(name: str):
    return CSRC / f"{name}.cu", BUILD_DIR / f"lib{name}.so"


def _stale(name: str) -> bool:
    """The library is missing, or older than its source or any shared
    header (``csrc/*.cuh``)."""
    src, lib = _paths(name)
    if not lib.exists():
        return True
    newest = max(p.stat().st_mtime for p in [src, *CSRC.glob("*.cuh")])
    return lib.stat().st_mtime < newest


def _start(name: str) -> subprocess.Popen:
    src, lib = _paths(name)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def _finish(name: str, proc: subprocess.Popen) -> str:
    out, _ = proc.communicate()
    _, lib = _paths(name)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu "
                           f"(exit {proc.returncode}):\n{out}")
    os.replace(tmp, lib)
    return out


def kernel_names() -> List[str]:
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def build_all(force: bool = False) -> Dict[str, Optional[str]]:
    """Compile every stale kernel source, one ``nvcc`` per source, all
    started together. Returns each kernel's ``-Xptxas -v`` report (None
    where the library was already up to date)."""
    with _lock:
        names = [n for n in kernel_names() if force or _stale(n)]
        procs = {n: _start(n) for n in names}
        reports: Dict[str, Optional[str]] = dict.fromkeys(kernel_names())
        errors = []
        for n, p in procs.items():
            try:
                reports[n] = _finish(n, p)
            except RuntimeError as e:
                errors.append(str(e))
        if errors:
            raise RuntimeError("\n".join(errors))
        return reports


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if stale."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            if _stale(name):
                _finish(name, _start(name))
            lib = ctypes.CDLL(str(_paths(name)[1]))
            _libs[name] = lib
        return lib


def function(name: str, symbol: str, argtypes) -> ctypes._CFuncPtr:
    """The C entry ``symbol`` of ``csrc/<name>.cu``, typed: ``argtypes``
    (``c_void_p`` for pointers and the stream, ``c_int`` for ints), and a
    ``cudaError_t`` result as an int."""
    fn = getattr(load(name), symbol)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


def check(err: int, name: str) -> None:
    """Raise on a nonzero cudaError_t returned by a launch."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {err}")


def stream_ptr(device) -> int:
    import torch
    return torch.cuda.current_stream(device).cuda_stream
