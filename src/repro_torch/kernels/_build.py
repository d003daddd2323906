"""Build the CUDA kernels at first use and load them through ctypes.

Each ``csrc/<name>.cu`` exposes a plain C function and is compiled on its
own with ``nvcc -gencode arch=compute_90a,code=sm_90a`` into
``build/<name>-<hash>.so`` beside this module. The hash covers the
source and the flags, so an edited source rebuilds and an unchanged one
is loaded as it is. ``build()`` starts one ``nvcc`` per source, all
together, and waits for them. Nothing here runs at import time: the CPU
tests import every module on a machine with no ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD = Path(__file__).resolve().parent / "build"
KERNELS = ("decode_attention", "flash_attention", "wkv6", "rglru")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None and Path("/usr/local/cuda/bin/nvcc").exists():
        path = "/usr/local/cuda/bin/nvcc"
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def target(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return BUILD / f"{name}-{digest.hexdigest()[:16]}.so"


def log_path(name: str) -> Path:
    return BUILD / f"{name}.log"


def build(names: Iterable[str] = KERNELS) -> Dict[str, Path]:
    """Compile every named kernel whose library is missing, all at once.
    Raises with the compiler's output if any build fails."""
    BUILD.mkdir(parents=True, exist_ok=True)
    outs = {name: target(name) for name in names}
    procs = {}
    for name, out in outs.items():
        if out.exists():
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    failed = []
    for name, (tmp, proc) in procs.items():
        text, _ = proc.communicate()
        log_path(name).write_text(text)
        if proc.returncode != 0:
            failed.append(f"{name} (rc {proc.returncode}):\n{text}")
        else:
            os.replace(tmp, outs[name])
    if failed:
        raise RuntimeError("kernel build failed: " + "\n".join(failed))
    return outs


def load(name: str) -> ctypes.CDLL:
    """The loaded library of one kernel, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build([name])[name]))
            _libs[name] = lib
        return lib
