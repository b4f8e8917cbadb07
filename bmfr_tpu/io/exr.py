"""EXR input loading and PNG output writing.

Mirrors the reference's OpenImageIO-based loaders/writers
(``read_image_file``/``load_image`` at opencl/bmfr.cpp:145-172 and the PNG
writer loop at :519-553), including the shape/channel validation and the
half->float conversion note (opencl/bmfr.cpp:157-158).

Backends: the native C++ library (bmfr_tpu.io.native, threaded, no Python
in the per-frame path) when it is built, the pure-Python EXR reader
(bmfr_tpu.io.exr_py) and PNG writer (bmfr_tpu.io.png) otherwise.

All loaders return float32 HWC arrays.
"""

from __future__ import annotations

import numpy as np


class OperationResult:
    """``Operation_result`` equivalent (opencl/bmfr.cpp:137-143)."""

    def __init__(self, success: bool, error_message: str = ""):
        self.success = success
        self.error_message = error_message

    def __bool__(self):
        return self.success


def read_exr(path: str) -> np.ndarray:
    """Read an EXR into f32 HWC (RGB order).

    Backends: native C++ (preferred); pure-Python reader otherwise.
    """
    from . import native

    if native.available():
        return native.read_exr(path)
    from .exr_py import read_exr_py

    return read_exr_py(path)


def read_image_file(file_name: str, frame: int, expect_shape=None):
    """Open ``<file_name><frame>.exr`` with validation
    (opencl/bmfr.cpp:145-163). Returns (OperationResult, array|None)."""
    path = f"{file_name}{frame}.exr"
    try:
        img = read_exr(path)
    except Exception as e:  # noqa: BLE001 - mirrors reference error channel
        return OperationResult(False, f"Can't open image file or it has "
                               f"wrong type: {file_name} ({e})"), None
    if img.ndim != 3 or img.shape[2] != 3:
        return OperationResult(False, f"Can't open image file or it has "
                               f"wrong type: {file_name}"), None
    if expect_shape is not None and img.shape[:2] != tuple(expect_shape):
        return OperationResult(False, f"Can't open image file or it has "
                               f"wrong type: {file_name}"), None
    return OperationResult(True), np.ascontiguousarray(img, np.float32)


def write_png(path: str, img_hwc: np.ndarray):
    """Write an f32 HWC [0,1] image as PNG (opencl/bmfr.cpp:527-539)."""
    from . import native

    arr8 = np.clip(np.asarray(img_hwc, np.float32), 0.0, 1.0)
    arr8 = (arr8 * 255.0 + 0.5).astype(np.uint8)
    if native.available():
        native.write_png(path, arr8)
        return
    from .png import write_png as write_png_py

    write_png_py(path, arr8)


def write_exr(path: str, img_hwc: np.ndarray, half: bool = False):
    """Write an f32 HWC EXR (used by tests and fixture export). Requires
    the native library (no Python EXR writer is shipped)."""
    from . import native

    if not native.available():
        raise RuntimeError("EXR writing requires the native IO library "
                           "(make -C native)")
    native.write_exr(path, np.asarray(img_hwc, np.float32), half=half)
