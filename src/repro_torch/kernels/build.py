"""Build and load the port's CUDA kernels.

Every `csrc/*.cu` source is compiled by `nvcc` for `sm_90a` (one process
per source, all started together), linked into one shared library with a
plain C interface, and loaded with ctypes. The library's name carries a
hash of the sources and flags, so an edited source is rebuilt and a
stale build is never loaded. The build directory `_build/` beside the
package sources is listed in `.gitignore`.

Nothing here runs at import time: `library()` builds on first use, which
only a CUDA tensor reaching a kernel wrapper triggers.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from ctypes import c_float, c_int, c_longlong, c_void_p
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
SOURCES = ("flash_attention.cu", "gossip_mix.cu", "mask_evolve.cu",
           "raw_gram.cu", "select_topk.cu", "wkv_chunked.cu")
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = ARCH_FLAGS + ("-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                           "-Xptxas", "-v")

# C entry points: name -> argtypes (every pointer and the stream are
# c_void_p so ctypes never truncates them to 32 bits). All return the
# cudaError_t of the launch as an int.
SIGNATURES = {
    "repro_flash_attention_f32": [
        c_void_p, c_void_p, c_void_p, c_void_p,          # q k v out
        c_int, c_int, c_int, c_int, c_int, c_int,        # b sq skv h kh hd
        c_int, c_int, c_int, c_float, c_void_p,          # causal window
    ],                                                   # q_offset scale
                                                         # stream
    "repro_flash_attention_wgmma": [
        c_void_p, c_void_p, c_void_p, c_void_p, c_int,   # q k v out dtype
        c_int, c_int, c_int, c_int, c_int, c_int,        # b sq skv h kh hd
        c_int, c_int, c_int, c_float, c_void_p,          # causal window
    ],                                                   # q_offset scale
                                                         # stream
    "repro_gossip_mix_f32": [
        c_void_p, c_void_p, c_void_p, c_void_p,          # x idx w out
        c_int, c_longlong, c_int, c_void_p,              # m f d stream
    ],
    "repro_mask_evolve_leaves": [
        c_void_p, c_int, c_void_p, c_void_p,             # table leaves
        c_int, c_int, c_void_p,                          # states thr grid
    ],                                                   # grid_deep stream
    "repro_raw_gram_f32": [
        c_void_p, c_void_p, c_void_p,                    # x out work
        c_int, c_int, c_int, c_int, c_int, c_void_p,     # m p tile splits
    ],                                                   # chunk stream
    "repro_select_topk_f32": [
        c_void_p, c_void_p, c_void_p, c_void_p, c_int,   # x work last sl t
        c_void_p, c_float, c_void_p,                     # cost cost_s cand
        c_void_p, c_void_p, c_void_p,                    # vals idx stats
        c_int, c_int, c_int,                             # m p k
        c_float, c_float,                                # alpha lam
        c_int, c_int, c_int, c_int, c_int,               # vec col_splits
        c_void_p,                                        # tiles_per_split
    ],                                                   # p_splits chunk
                                                         # stream
    "repro_wkv_chunked": [
        c_void_p, c_void_p, c_void_p, c_void_p, c_void_p,  # r k v w u
        c_void_p, c_void_p, c_void_p, c_void_p,            # s0 out s_fin
        c_int, c_int, c_int, c_int, c_int, c_void_p,       # s_chunks
    ],                                                     # dtype b seq h
                                                           # hd stream
}

_LIB = None          # the loaded library, once per process
BUILD_LOG = ""       # nvcc/ptxas output of this process's build, if any


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found on PATH or under CUDA_HOME; the "
                       "CUDA kernels cannot be built")


def library_path() -> Path:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES:
        digest.update((CSRC_DIR / name).read_bytes())
    return BUILD_DIR / f"libreprotorch_kernels-{digest.hexdigest()[:12]}.so"


def _run(procs):
    logs = []
    for cmd, proc in procs:
        out, _ = proc.communicate()
        logs.append(out)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({' '.join(cmd)}):\n{out}")
    return logs


def build() -> Path:
    """Compile the sources if this exact build is not on disk yet."""
    global BUILD_LOG
    so = library_path()
    if so.exists():
        return so
    nvcc = nvcc_path()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs, procs = [], []
        for name in SOURCES:
            obj = Path(tmp) / (Path(name).stem + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-c", str(CSRC_DIR / name), "-o",
                   str(obj)]
            procs.append((cmd, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
            objs.append(str(obj))
        logs = _run(procs)
        tmp_so = Path(tmp) / so.name
        link = [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp_so), *objs]
        logs += _run([(link, subprocess.Popen(
            link, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))])
        os.replace(tmp_so, so)
    BUILD_LOG = "".join(logs)
    return so


def library() -> ctypes.CDLL:
    """The kernels' shared library, built on first use."""
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = c_int
        lib.repro_cuda_error_string.argtypes = [c_int]
        lib.repro_cuda_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def check(code: int, what: str):
    """Raise if a C entry point reported a CUDA error."""
    if code != 0:
        msg = library().repro_cuda_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")
