"""Native data-loader bridge.

`native_build_x` dispatches image decode/resize/normalize to the C++
loader (`spnet_tpu_torch/native/`, built as libspnet_io.so) when present;
returns None when the library is unavailable so callers fall back to PIL.

It replaces the reference's multiprocessing + sharedctypes image reader
(`spnet/utils.py:323-421`).
"""

from __future__ import annotations



def native_build_x(img_files: list[str], size: int | None,
                   method: str = "lanczos3"):
    # the native decoder handles (non-interlaced 8-bit) PNG only; any
    # other format (e.g. the reference's .bmp movie frames) goes to PIL
    if not all(f.lower().endswith(".png") for f in img_files):
        return None
    try:
        from spnet_tpu_torch.native import io as native_io
    except Exception:
        return None
    if not native_io.available():
        return None
    return native_io.load_images(img_files, size, method=method)
