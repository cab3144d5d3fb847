"""Build the port's CUDA sources at first use and load them with ctypes.

Each `sgnn_tpu_torch/csrc/<name>.cu` compiles on its own with

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -Xptxas -v

into a shared library with a plain C interface, under `build/torch_kernels/`
at the root of the checkout, named by a hash of the sources and the flags:
an unchanged source is not compiled again.  No source includes PyTorch's
headers, so a build takes seconds.  Every pointer and the stream cross as
`ctypes.c_void_p`.  Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, Optional

from ...utils.logging import get_logger

log = get_logger("sgnn.cuda")

PKG_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR.parent / "build" / "torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


@dataclasses.dataclass(frozen=True)
class Built:
    """One loaded kernel library.  `seconds` is this process's nvcc time
    (0.0 when the library was already on disk); `log` holds nvcc's output,
    with ptxas's registers, shared memory and spills per kernel."""

    name: str
    path: Path
    lib: ctypes.CDLL
    seconds: float
    log: str


_built: Dict[str, Built] = {}
_lock = threading.Lock()


def find_nvcc() -> str:
    for cand in (Path("/usr/local/cuda/bin/nvcc"), shutil.which("nvcc")):
        if cand and Path(cand).is_file():
            return str(cand)
    raise RuntimeError("nvcc not found: the port's CUDA kernels are built "
                       "with the CUDA toolkit (/usr/local/cuda/bin/nvcc)")


def _lib_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    h.update((CSRC_DIR / f"{name}.cu").read_bytes())
    for hdr in sorted(CSRC_DIR.glob("*.cuh")):
        h.update(hdr.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build_all(names: Optional[Iterable[str]] = None) -> Dict[str, Built]:
    """Build (one nvcc per source, all started together) and load every
    kernel named, by default every `csrc/*.cu`.  Raises RuntimeError with
    nvcc's output if a build fails."""
    if names is None:
        names = sorted(p.stem for p in CSRC_DIR.glob("*.cu"))
    names = list(names)
    with _lock:
        todo = [n for n in names if n not in _built]
        if todo:
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            nvcc = find_nvcc() if any(not _lib_path(n).exists()
                                      for n in todo) else None
            procs = {}
            t0 = time.perf_counter()
            for n in todo:
                out = _lib_path(n)
                if out.exists():
                    continue
                tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
                cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp),
                       str(CSRC_DIR / f"{n}.cu")]
                procs[n] = (subprocess.Popen(
                    cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                    text=True), tmp, out)
            logs, failed = {}, []
            for n, (proc, tmp, out) in procs.items():
                logs[n] = proc.communicate()[0]
                if proc.returncode != 0:
                    failed.append(n)
                else:
                    os.replace(tmp, out)
            if failed:
                raise RuntimeError("nvcc failed for " + ", ".join(failed)
                                   + ":\n" + "\n".join(logs[n] for n in failed))
            seconds = time.perf_counter() - t0
            if procs:
                log.info("nvcc built %s in %.1f s", ", ".join(procs), seconds)
            for n in todo:
                path = _lib_path(n)
                _built[n] = Built(
                    name=n, path=path, lib=ctypes.CDLL(str(path)),
                    seconds=seconds if n in procs else 0.0,
                    log=logs.get(n, "cached"))
        return {n: _built[n] for n in names}


def build(name: str) -> Built:
    """Build and load one kernel (`csrc/<name>.cu`)."""
    return build_all([name])[name]
