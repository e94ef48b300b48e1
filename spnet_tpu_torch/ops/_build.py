"""Build and load the port's CUDA kernels.

The sources under `spnet_tpu_torch/csrc/` are compiled with `nvcc` into
one shared library with a plain C interface, loaded with `ctypes`: one
`nvcc -c` per source, all started together, then one link.  The build
happens at first use, into `spnet_tpu_torch/_build/` (git-ignored), and
again whenever the sources or the flags change: the library's file name
carries their hash.  Nothing here runs at import time, so the module
imports on hosts without `nvcc` or a card.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
SOURCES = ("sepconv.cu", "loss.cu", "activations.cu")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas=-v",
)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES:
        h.update((CSRC / name).read_bytes())
    return BUILD_DIR / f"libspnet_kernels_{h.hexdigest()[:16]}.so"


def build() -> tuple[Path, float]:
    """Compile the kernels unless a library of the current sources exists.

    Returns (library path, seconds spent compiling; 0.0 when cached).
    The library is written to a temporary name and renamed into place, so
    processes building it at the same time never load a half-written file.
    `build.log` keeps the compilers' output of the last build in this
    process (ptxas's registers, shared memory and spills per kernel)."""
    path = library_path()
    if path.exists():
        return path, 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    build.log = ""
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as work:
        objs = [os.path.join(work, f"{Path(name).stem}.o")
                for name in SOURCES]
        tmp = os.path.join(work, "lib.so")
        compiles = [[nvcc, *NVCC_FLAGS, "-c", str(CSRC / name), "-o", obj]
                    for name, obj in zip(SOURCES, objs)]
        link = [[nvcc, *NVCC_FLAGS, "-shared", *objs, "-o", tmp]]
        for stage in (compiles, link):
            procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True)
                     for cmd in stage]
            logs = [p.communicate()[0] for p in procs]
            failed = [f"{' '.join(cmd)}\n{log}" for cmd, p, log
                      in zip(stage, procs, logs) if p.returncode]
            if failed:
                raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
            build.log += "".join(logs)
        os.replace(tmp, path)
    return path, time.perf_counter() - t0


build.log = ""


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build if needed, load once per process, declare the C signatures."""
    path, _ = build()
    lib = ctypes.CDLL(str(path))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.spnet_sepconv_infer.argtypes = [p, p, p, p, p, p,
                                        i, i, i, i, i, i, i, i, i, i, i, p]
    lib.spnet_sepconv_infer.restype = i
    lib.spnet_sepconv_wgmma_smem.argtypes = [i, i, i]
    lib.spnet_sepconv_wgmma_smem.restype = i
    ll, f = ctypes.c_longlong, ctypes.c_float
    lib.spnet_loss.argtypes = [p, p, p, p, p, p, i, p, ll, f, f, f, f, f,
                               f, i, p]
    lib.spnet_loss.restype = i
    lib.spnet_loss_grad_scale.argtypes = [p, p, p, ll, p]
    lib.spnet_loss_grad_scale.restype = i
    lib.spnet_selective_sigmoid_fwd.argtypes = [p, p, ll, p]
    lib.spnet_selective_sigmoid_fwd.restype = i
    lib.spnet_selective_sigmoid_bwd.argtypes = [p, p, p, ll, p]
    lib.spnet_selective_sigmoid_bwd.restype = i
    return lib
