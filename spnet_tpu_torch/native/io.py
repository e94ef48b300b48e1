"""ctypes binding for the native C++ data loader (spnet_io.cpp).

Builds libspnet_io.so on first use (make, cached).  See
`spnet_tpu_torch/data/loader.py` for the dispatch layer that falls back to PIL
when the toolchain is unavailable.
"""

from __future__ import annotations

import ctypes
import os
import subprocess

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_LIB_PATH = os.path.join(_DIR, "libspnet_io.so")
_lib = None
_build_failed = False


def _ensure_built() -> bool:
    global _lib, _build_failed
    if _lib is not None:
        return True
    if _build_failed:
        return False
    src = os.path.join(_DIR, "spnet_io.cpp")
    if not os.path.exists(_LIB_PATH) or (
        os.path.getmtime(_LIB_PATH) < os.path.getmtime(src)
    ):
        try:
            subprocess.run(
                ["make", "-s", "libspnet_io.so"],
                cwd=_DIR,
                check=True,
                capture_output=True,
            )
        except Exception as e:
            print("[spnet_tpu_torch.native] build failed, falling back to "
                  f"PIL: {e}")
            _build_failed = True
            return False
    try:
        lib = ctypes.CDLL(_LIB_PATH)
        lib.spnet_load_images_ex.restype = ctypes.c_int
        lib.spnet_load_images_ex.argtypes = [
            ctypes.POINTER(ctypes.c_char_p),
            ctypes.c_int,
            ctypes.c_int,
            ctypes.POINTER(ctypes.c_float),
            ctypes.c_int,
            ctypes.POINTER(ctypes.c_uint8),
            ctypes.c_int,
        ]
        lib.spnet_png_dims.restype = ctypes.c_int
        lib.spnet_png_dims.argtypes = [
            ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int),
        ]
        _lib = lib
        return True
    except OSError as e:
        print(f"[spnet_tpu_torch.native] load failed: {e}")
        _build_failed = True
        return False


def available() -> bool:
    return _ensure_built()


def png_dims(path: str) -> tuple[int, int]:
    if not _ensure_built():
        raise RuntimeError("native loader unavailable")
    w = ctypes.c_int()
    h = ctypes.c_int()
    if _lib.spnet_png_dims(path.encode(), ctypes.byref(w),
                           ctypes.byref(h)) != 0:
        raise ValueError(f"cannot parse {path}")
    return w.value, h.value


FILTERS = {"box": 0, "lanczos3": 1}


def load_images(paths: list[str], size: int | None,
                n_threads: int = 0,
                method: str = "lanczos3") -> np.ndarray:
    """Decode + resize + Inception-normalize into (N, S, S, 1) float32.

    method 'lanczos3' (default) is the PIL-ANTIALIAS twin the reference
    resizes with (`utils.py:337`); 'box' = area averaging."""
    if not _ensure_built():
        raise RuntimeError("native loader unavailable")
    n = len(paths)
    if n == 0:
        raise ValueError("empty path list")
    if size is None or size <= 0:
        w, h = png_dims(paths[0])
        out = np.zeros((n, h, w, 1), np.float32)
        size_arg = 0
    else:
        out = np.zeros((n, size, size, 1), np.float32)
        size_arg = size
    arr = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
    status = np.zeros(n, np.uint8)
    ok = _lib.spnet_load_images_ex(
        arr, n, size_arg,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), n_threads,
        status.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        FILTERS[method],
    )
    if ok != n:
        # PNG variants outside the native subset (palette, 16-bit,
        # interlaced) or corrupt files: retry through PIL rather than
        # training on silently zero-filled frames paired with real labels.
        failed = np.flatnonzero(status == 0)
        print(f"[spnet_tpu_torch.native] {len(failed)}/{n} images outside the "
              f"native decode subset; retrying via PIL")
        from spnet_tpu_torch.data.dataset import load_image

        for i in failed:
            out[i] = load_image(paths[i], None if size_arg == 0 else
                                size_arg, method=method)
    return out
