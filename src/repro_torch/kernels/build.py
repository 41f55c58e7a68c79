"""Builds the CUDA kernels in ``csrc/`` and binds them with ``ctypes``.

At first use every ``csrc/*.cu`` is compiled for Hopper (``sm_90a``) by its
own ``nvcc`` process, all started together, and the objects are linked into
one shared library with a plain C interface.  The library lands in
``_build/`` beside the package (listed in ``.gitignore``) under a name that
hashes the sources and flags, so an unchanged tree reuses it and an edited
one rebuilds.  Nothing here runs at import time: the CPU tests import every
module on a machine with no ``nvcc``.

Every C entry point launches on the stream it is given and returns
``cudaGetLastError()``; the Python wrappers raise when that is not 0.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
# C signature of each entry point (all return cudaError_t as int)
SIGNATURES: Dict[str, Sequence] = {
    # q, k, v, out, lse, dtype, B, S, T, H, KH, D,
    # q strides (b, s, h), k strides (b, t, h), v strides (b, t, h),
    # scale, causal, stream
    "flash_attention_fwd": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                            _L, _L, _L, _L, _L, _L, _L, _L, _L, _F, _I, _P),
    # q, k, v, out, do, lse, delta (written), dq, dtype, B, S, T, H, KH, D,
    # q strides (b, s, h), k strides (b, t, h), v strides (b, t, h),
    # scale, causal, stream
    "flash_attention_bwd_dq": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                               _I, _I, _L, _L, _L, _L, _L, _L, _L, _L, _L, _F, _I,
                               _P),
    # q, k, v, do, lse, delta, dk, dv, dtype, B, S, T, H, KH, D,
    # q/k/v strides as above, scale, causal, stream
    "flash_attention_bwd_dkv": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                                _I, _I, _L, _L, _L, _L, _L, _L, _L, _L, _L, _F, _I,
                                _P),
    # q, k_pages, v_pages, block_tables, lengths, out, dtype,
    # B, KH, G, D, P, M, scale, stream
    "paged_attention_decode": (_P, _P, _P, _P, _P, _P, _I,
                               _I, _I, _I, _I, _I, _I, _F, _P),
    # w, out, dtype, rows, cols, axis, w0, stream
    "coalesce_pair": (_P, _P, _I, _L, _L, _I, _F, _P),
    # a, b, out, dtype, n, 1 - alpha, alpha, stream
    "interp_axpy": (_P, _P, _P, _I, _L, _F, _F, _P),
}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def find_nvcc() -> str:
    path = shutil.which("nvcc")
    if path:
        return path
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found (put it on PATH or set CUDA_HOME); "
                       "the CUDA kernels cannot be built")


def sources() -> List[Path]:
    return sorted(CSRC.glob("*.cu"))


def library_name(srcs: Sequence[Path]) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in srcs + sorted(CSRC.glob("*.cuh")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return f"libreprotorch_{h.hexdigest()[:16]}.so"


def compile_commands(nvcc: str, srcs: Sequence[Path], obj_dir: Path,
                     lib_path: Path) -> Tuple[List[List[str]], List[str]]:
    """(one compile command per source, the link command)."""
    objs = [str(obj_dir / (p.stem + ".o")) for p in srcs]
    compiles = [[nvcc, *NVCC_FLAGS, "-c", str(p), "-o", o]
                for p, o in zip(srcs, objs)]
    link = [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared",
            "-o", str(lib_path), *objs]
    return compiles, link


def build(build_dir: Path = BUILD_DIR) -> Tuple[Path, str]:
    """Compile (or reuse) the kernel library; returns (path, compiler log).

    The log holds ``ptxas -v`` output: registers, shared memory and spills
    per kernel.  A failed compile raises with the compiler's output.
    """
    srcs = sources()
    if not srcs:
        raise RuntimeError(f"no CUDA sources under {CSRC}")
    build_dir.mkdir(parents=True, exist_ok=True)
    lib_path = build_dir / library_name(srcs)
    log_path = lib_path.with_suffix(".log")
    if lib_path.exists() and log_path.exists():
        return lib_path, log_path.read_text()
    nvcc = find_nvcc()
    with tempfile.TemporaryDirectory(dir=build_dir) as tmp:
        tmp_lib = Path(tmp) / lib_path.name
        compiles, link = compile_commands(nvcc, srcs, Path(tmp), tmp_lib)
        procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for c in compiles]
        logs = []
        for c, p in zip(compiles, procs):
            out, _ = p.communicate()
            logs.append(f"$ {' '.join(c)}\n{out}")
        failed = [c for c, p in zip(compiles, procs) if p.returncode != 0]
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(logs))
        res = subprocess.run(link, stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True)
        logs.append(f"$ {' '.join(link)}\n{res.stdout}")
        if res.returncode != 0:
            raise RuntimeError("nvcc link failed:\n" + "\n".join(logs))
        log = "\n".join(logs)
        log_path.write_text(log)
        os.replace(tmp_lib, lib_path)  # atomic: concurrent builds agree
    return lib_path, log


def load_library() -> ctypes.CDLL:
    """The bound kernel library, built on first call."""
    global _lib
    with _lock:
        if _lib is None:
            path, _ = build()
            lib = ctypes.CDLL(str(path))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = list(argtypes)
                fn.restype = ctypes.c_int
            lib.reprotorch_error_string.argtypes = [ctypes.c_int]
            lib.reprotorch_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def check(err: int, name: str) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by an entry point."""
    if err != 0:
        what = _lib.reprotorch_error_string(err).decode() if _lib else "?"
        raise RuntimeError(f"CUDA kernel {name} failed: cudaError_t {err} ({what})")
