"""Build and load the port's CUDA kernels, and the checks their wrappers share.

Each source ``csrc/<name>.cu`` has a plain C interface.  At first use it is
compiled by ``nvcc`` for ``sm_90a`` into its own shared library under
``kernels/build/`` and loaded with ``ctypes``.  ``build()`` starts one
``nvcc`` for every source that is not built yet, all at once, and waits for
them.  A library's file name carries a hash of its source and flags, so an
edited source is rebuilt and a stale library is never loaded.  The compiler's
output (``-Xptxas -v``: registers, shared memory, spills) is kept beside each
library as ``<name>.log``.

No kernel is built when a module is imported: the CPU tests import every
module on a machine without ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

CSRC = Path(__file__).with_name("csrc")
BUILD_DIR = Path(__file__).with_name("build")
SOURCES = ("lags_select", "decode_attention", "flash_attention",
           "flash_attention_wgmma", "ssm_scan", "flash_attention_bwd",
           "ssm_scan_bwd")
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
FLAGS = ("-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas",
         "-v")
# lags_select must not contract a*b + c into an FMA: its state is bit-equal
# to the plain version's separately rounded products and sums
EXTRA_FLAGS = {"lags_select": ("-fmad=false",)}

_LIBS: dict = {}
_TYPED: set = set()
_LOCK = threading.Lock()


def nvcc() -> str:
    home = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda"))
    if (home / "bin" / "nvcc").exists():
        return str(home / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (set CUDA_HOME): the CUDA kernels are built "
            "from csrc/ on a machine with the CUDA toolkit")
    return found


def _flags(name: str):
    return (*ARCH, *FLAGS, *EXTRA_FLAGS.get(name, ()))


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    tag = hashlib.sha256(src + " ".join(_flags(name)).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{tag[:16]}.so"


def build(names=SOURCES) -> dict:
    """Compile every named source whose library is missing, one ``nvcc``
    each, all started together.  Returns {name: seconds} for the builds it
    ran; raises with the compiler's output if one fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    started = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
        cmd = [nvcc(), *_flags(name), "-o", str(tmp), str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        started[name] = (proc, tmp, out, time.perf_counter())
    seconds, failed = {}, []
    for name, (proc, tmp, out, t0) in started.items():
        log, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        (BUILD_DIR / f"{name}.log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"nvcc failed on {name}.cu:\n{log}")
            continue
        os.replace(tmp, out)  # atomic: a concurrent loader sees all or none
    if failed:
        raise RuntimeError("\n".join(failed))
    return seconds


def library(name: str, signatures: dict) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed.
    ``signatures`` maps each C function to (argtypes, restype); pointers are
    ``c_void_p`` so that ctypes does not cut them to 32 bits.  Callers may
    name different functions of one library."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            build((name,))
            lib = _LIBS[name] = ctypes.CDLL(str(library_path(name)))
        for fn, (argtypes, restype) in signatures.items():
            if (name, fn) not in _TYPED:  # a function is typed once
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = restype
                _TYPED.add((name, fn))
        return lib


def device_of(*tensors) -> torch.device:
    """The one device all ``tensors`` lie on; raises if they differ."""
    devs = {t.device for t in tensors}
    if len(devs) != 1:
        raise ValueError(f"tensors lie on several devices: {sorted(map(str, devs))}")
    return devs.pop()


def check_status(name: str, status: int) -> None:
    """Raise on a nonzero status returned by a launch function: a
    ``cudaError_t``, or 1000 + the ``CUresult`` of a TMA tensor map that the
    CUDA driver refused."""
    if status >= 1000:
        raise RuntimeError(f"{name}: the CUDA driver refused a TMA tensor map, "
                           f"CUresult {status - 1000}")
    if status != 0:
        raise RuntimeError(
            f"{name}: CUDA launch failed with cudaError_t {status}")


def stream_ptr(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream
