"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Each source under ``csrc/`` is compiled on its own into a shared library
with a plain C interface::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
        -Xcompiler -fPIC -o build/repro_torch/lib<name>-<hash>.so csrc/<name>.cu

The library goes into ``build/repro_torch/`` under the checkout at first
use, and again whenever the source, a shared header (``csrc/*.cuh``) or
the flags change: the file name carries a hash of all three.  ``build`` starts one nvcc per missing library, all
together, and waits for them.  Nothing here runs when a module is imported.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import time
from pathlib import Path
from typing import Iterable, Optional

__all__ = ["SOURCES", "BUILD_DIR", "NVCC_FLAGS", "build", "load",
           "library_path"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"

#: kernel name -> source file under csrc/
SOURCES = {
    "rbgp4mm_rhs": "rbgp4mm_rhs.cu",
    "rbgp4_sddmm_rhs": "rbgp4_sddmm_rhs.cu",
    "chainmm_rhs": "chainmm_rhs.cu",
    "chain_sddmm_rhs": "chain_sddmm_rhs.cu",
    "rbgp4mm": "rbgp4mm.cu",
    "rbgp4_sddmm": "rbgp4_sddmm.cu",
}

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_LIBS: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (set CUDA_HOME); the "
                           "port's kernels are built with nvcc")
    nvcc = Path(CUDA_HOME) / "bin" / "nvcc"
    if not nvcc.exists():
        raise RuntimeError(f"nvcc not found at {nvcc}")
    return str(nvcc)


def library_path(name: str) -> Path:
    """Where kernel ``name``'s library lives: its file name hashes the
    source, every shared header under ``csrc/`` (a source may include any
    of them) and the flags, so an edit to any of them builds anew."""
    h = hashlib.sha256((CSRC / SOURCES[name]).read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names: Optional[Iterable[str]] = None, *,
          verbose: bool = False) -> dict[str, tuple[float, str]]:
    """Compile the libraries that are missing; returns {name: (seconds,
    compiler output)} for those built.

    ``verbose`` adds ``-Xptxas -v``, whose report gives each kernel's
    registers, shared memory and spills.  Raises with the compiler's output
    if any build fails.
    """
    names = list(SOURCES if names is None else names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    jobs = {}
    t0 = time.perf_counter()
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.parent / f"{out.stem}.{os.getpid()}.tmp.so"
        cmd = [nvcc, *NVCC_FLAGS, *(("-Xptxas", "-v") if verbose else ()),
               "-o", str(tmp), str(CSRC / SOURCES[name])]
        jobs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True),
                      tmp, out)
    built = {}
    failed = []
    for name, (proc, tmp, out) in jobs.items():
        log, _ = proc.communicate()
        built[name] = (time.perf_counter() - t0, log)
        if proc.returncode != 0:
            failed.append(f"{name} (nvcc exit {proc.returncode}):\n{log}")
            tmp.unlink(missing_ok=True)
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("kernel build failed: " + "\n".join(failed))
    return built


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if missing."""
    lib = _LIBS.get(name)
    if lib is None:
        path = library_path(name)
        if not path.exists():
            build([name])
        lib = _LIBS[name] = ctypes.CDLL(str(path))
    return lib
