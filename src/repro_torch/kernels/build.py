"""Build and load the port's CUDA C++ kernels.

Each kernel lives in ``kernels/<dir>/csrc/<lib>.cu`` behind a plain C
interface, where ``<dir>`` is the kernel's package (``kernel_dir``: its
own name, except for kernels that share a package with another, as
``flash_decode_kvq`` shares ``flash_decode``, as in the reference) and
``<lib>`` its library (``library``: its own name, except for an entry
compiled from another kernel's source, as ``flash_decode_paged`` is from
``flash_decode.cu``). At first use a library is compiled with ``nvcc`` for Hopper
(``-gencode arch=compute_90a,code=sm_90a``) into a shared library under
``build/repro_torch_kernels/`` at the repository root and loaded with
``ctypes``; the library name carries a hash of the source, the
repository headers it includes and the flags, so an edited source or
header rebuilds what uses it. Nothing here runs at import time.

Every C entry point takes raw device pointers and the CUDA stream as
``void*`` (``ctypes.c_void_p``) and sizes as ``int``, launches on that
stream, allocates nothing and returns ``cudaGetLastError()``; the Python
wrapper raises when it is non-zero (``check``).

A kernel may also be built as a timing-only variant: the same source
compiled with ``-DEVA_VARIANT=<k>`` (``VARIANTS`` names them), into a
library of its own. ``chip_smoke.py``'s breakdown phase times them; no
served path loads one.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Tuple

import torch

KERNEL_NAMES = ("fused_vq_matmul", "flash_decode", "dequant_gemv",
                "int8_gemm", "flash_decode_kvq", "vq_gemm", "oc_lookup",
                "flash_decode_paged", "flash_decode_kvq_paged")
# kernels whose package is named after another kernel
_SHARED_DIRS = {"flash_decode_kvq": "flash_decode",
                "flash_decode_paged": "flash_decode",
                "flash_decode_kvq_paged": "flash_decode"}
# entries compiled into another kernel's library (from its source)
_SHARED_LIBS = {"flash_decode_paged": "flash_decode",
                "flash_decode_kvq_paged": "flash_decode_kvq"}
# timing-only variants of a kernel, built with -DEVA_VARIANT=<index + 1>
VARIANTS = {
    **{name: ("no_lookup", "no_index", "no_o", "one_launch", "trace")
       for name in ("fused_vq_matmul", "oc_lookup")},
    "vq_gemm": ("no_store", "no_load", "empty"),
}
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_PKG = Path(__file__).resolve().parent
_INCLUDE = re.compile(r'^\s*#\s*include\s+"([^"]+)"', re.M)
BUILD_DIR = _PKG.parents[2] / "build" / "repro_torch_kernels"

_LIBS: Dict[Tuple[str, int], ctypes.CDLL] = {}
_BOUND: Dict[Tuple[str, str, int], object] = {}
_LOCK = threading.Lock()
# ptxas report (registers / shared memory / spills) of each build in this
# process, for logs
BUILD_LOG: Dict[str, str] = {}


def kernel_dir(name: str) -> str:
    """The package under ``kernels/`` that holds kernel ``name``."""
    return _SHARED_DIRS.get(name, name)


def library(name: str) -> str:
    """The library (and source) that holds kernel ``name``."""
    return _SHARED_LIBS.get(name, name)


def source_path(name: str) -> Path:
    return _PKG / kernel_dir(name) / "csrc" / f"{library(name)}.cu"


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME  # toolkit discovery; slow import

    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels are built at first "
                       "use and need the CUDA toolkit")


def variant_index(name: str, variant: str) -> int:
    """The ``EVA_VARIANT`` value of a named variant of kernel ``name``
    (0 is the kernel itself)."""
    if variant == "kernel":
        return 0
    if variant not in VARIANTS.get(name, ()):
        raise ValueError(f"{name} has no variant {variant!r}; it has "
                         f"{VARIANTS.get(name, ())}")
    return VARIANTS[name].index(variant) + 1


def _flags(variant: int) -> Tuple[str, ...]:
    return NVCC_FLAGS + ((f"-DEVA_VARIANT={variant}",) if variant else ())


def _local_includes(path: Path) -> List[Path]:
    """The repository headers ``path`` includes (``#include "..."``),
    directly or through another, each once."""
    found: List[Path] = []
    todo = [path]
    while todo:
        cur = todo.pop()
        for m in _INCLUDE.finditer(cur.read_text()):
            header = (cur.parent / m.group(1)).resolve()
            if header not in found:
                found.append(header)
                todo.append(header)
    return found


def _lib_path(name: str, variant: int = 0) -> Path:
    src = source_path(name)
    h = hashlib.sha256(src.read_bytes())
    for header in _local_includes(src):
        h.update(header.read_bytes())
    h.update(" ".join(_flags(variant)).encode())
    tag = f"-v{variant}" if variant else ""
    return BUILD_DIR / f"lib{library(name)}{tag}-{h.hexdigest()[:16]}.so"


def _start_build(name: str, variant: int = 0
                 ) -> Tuple[Path, Optional[subprocess.Popen], Path]:
    out = _lib_path(name, variant)
    if out.exists():
        return out, None, out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = [_nvcc(), *_flags(variant), "-o", str(tmp), str(source_path(name))]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return out, proc, tmp


def _finish_build(name: str, out: Path, proc: Optional[subprocess.Popen],
                  tmp: Path, variant: int = 0) -> None:
    if proc is None:
        return
    log, _ = proc.communicate()
    BUILD_LOG[name + (f"[v{variant}]" if variant else "")] = log
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for {source_path(name)}:\n{log}")
    os.replace(tmp, out)  # atomic: concurrent builders agree on the result


def build_all(names: Iterable[str] = KERNEL_NAMES) -> float:
    """Compile every kernel not yet built and its timing variants, one
    ``nvcc`` per library, all started together; load them. Returns the
    wall seconds spent."""
    t0 = time.perf_counter()
    libs = dict.fromkeys(library(n) for n in names)
    jobs = [(n, v) for n in libs
            for v in range(1 + len(VARIANTS.get(n, ())))]
    with _LOCK:
        started: List = [(n, v, *_start_build(n, v)) for n, v in jobs]
        for n, v, out, proc, tmp in started:
            _finish_build(n, out, proc, tmp, v)
    for n, v in jobs:
        load(n, v)
    return time.perf_counter() - t0


def load(name: str, variant: int = 0) -> ctypes.CDLL:
    """The loaded library of kernel ``name`` (or of its timing variant
    ``variant``), building it on first use."""
    name = library(name)
    with _LOCK:
        lib = _LIBS.get((name, variant))
        if lib is None:
            out, proc, tmp = _start_build(name, variant)
            _finish_build(name, out, proc, tmp, variant)
            lib = ctypes.CDLL(str(out))
            _LIBS[(name, variant)] = lib
        return lib


def bind(name: str, symbol: str, n_ptrs: int, n_ints: int, variant: int = 0):
    """``symbol`` of kernel ``name`` (or of its timing variant) with
    argtypes ``n_ptrs`` pointers, ``n_ints`` ints and a trailing stream
    pointer; restype int."""
    fn = _BOUND.get((name, symbol, variant))
    if fn is None:
        fn = getattr(load(name, variant), symbol)
        fn.argtypes = ([ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * n_ints
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _BOUND[(name, symbol, variant)] = fn
    return fn


def stream_of(t: torch.Tensor) -> int:
    """Handle of PyTorch's current CUDA stream on ``t``'s device."""
    return torch.cuda.current_stream(t.device).cuda_stream


@functools.lru_cache(maxsize=None)
def device_sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def check_vq_operands(kernel: str, X, vq, c_max: int = 4) -> None:
    """Raise ValueError unless the VQ kernels take these operands: x
    (M, V, 8), its dtype the caller's to check; a VQWeight with 1..c_max
    codebooks of 256 centroids, contiguous uint8 (C, V, N) indices, fp32
    (C, 8, 256) codebooks and (N,) scale, all on x's device."""
    M, V, d = X.shape
    C, N = vq.C, vq.N
    ok = (d == 8 and 1 <= C <= c_max
          and vq.idx.dtype == torch.uint8 and vq.idx.is_contiguous()
          and tuple(vq.idx.shape) == (C, V, N)
          and vq.codebooks.dtype == torch.float32
          and vq.codebooks.is_contiguous()
          and tuple(vq.codebooks.shape) == (C, 8, 256)
          and vq.scale.dtype == torch.float32
          and vq.scale.is_contiguous() and tuple(vq.scale.shape) == (N,)
          and vq.idx.device == vq.codebooks.device == vq.scale.device
          == X.device)
    if not ok:
        raise ValueError(
            f"{kernel}: the kernel takes x (M, V, 8) and a VQWeight with 1..{c_max} "
            f"codebooks of 256 centroids: contiguous uint8 (C, V, N) indices, "
            f"fp32 (C, 8, 256) codebooks, fp32 (N,) scale, all on x's device; "
            f"got x {tuple(X.shape)} on {X.device}, idx {vq.idx.dtype} "
            f"{tuple(vq.idx.shape)} on {vq.idx.device}, codebooks "
            f"{vq.codebooks.dtype} {tuple(vq.codebooks.shape)}, scale "
            f"{vq.scale.dtype} {tuple(vq.scale.shape)}")


def check(err: int, what: str) -> None:
    """Raise when a C entry point reported a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")
