"""ctypes bindings to the native C++ IO runtime (libbmfr_io.so).

The reference's host runtime is C++: OpenImageIO EXR/PNG IO driven by an
OpenMP-parallel frame loop (opencl/bmfr.cpp:252-313, :519-553). The rebuild
keeps that layer native: ``native/bmfr_io.cpp`` implements a minimal EXR
reader/writer (scanline, NONE/ZIP/ZIPS compression, half+float channels),
a zlib-based PNG writer, and a pthread-parallel dataset loader, exposed here
through ctypes (no pybind11 in this environment).

Build with ``make -C native`` (done automatically on first use if a
toolchain is present). All functions fall back gracefully when the library
is absent — pure-Python backends take over in bmfr_tpu.io.exr.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

_LIB = None
_TRIED = False
_LOCK = threading.Lock()

_NATIVE_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "native")
_SO_PATH = os.path.abspath(os.path.join(_NATIVE_DIR, "libbmfr_io.so"))


def _try_build():
    """Build the library under an exclusive file lock, so concurrent
    processes (test workers) never load a half-written file."""
    import fcntl

    try:
        with open(os.path.join(_NATIVE_DIR, ".build.lock"), "w") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)
            subprocess.run(
                ["make", "-s", "-C", os.path.abspath(_NATIVE_DIR)],
                check=True, capture_output=True, timeout=120)
        return os.path.exists(_SO_PATH)
    except Exception:
        return False


def _load():
    global _LIB, _TRIED
    with _LOCK:
        if _TRIED:
            return _LIB
        _TRIED = True
        if os.path.isdir(_NATIVE_DIR):
            # make no-ops when the .so is current; this also rebuilds a
            # stale library after source updates (new symbols).
            _try_build()
        if not os.path.exists(_SO_PATH):
            return None
        try:
            lib = ctypes.CDLL(_SO_PATH)
        except OSError:
            return None

        lib.bmfr_exr_read_header.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]
        lib.bmfr_exr_read_header.restype = ctypes.c_int
        lib.bmfr_exr_read.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_float),
            ctypes.c_int, ctypes.c_int, ctypes.c_int]
        lib.bmfr_exr_read.restype = ctypes.c_int
        lib.bmfr_exr_write.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_float),
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int]
        lib.bmfr_exr_write.restype = ctypes.c_int
        lib.bmfr_exr_write_ex.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_float),
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int]
        lib.bmfr_exr_write_ex.restype = ctypes.c_int
        lib.bmfr_png_write.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_uint8),
            ctypes.c_int, ctypes.c_int, ctypes.c_int]
        lib.bmfr_png_write.restype = ctypes.c_int
        lib.bmfr_png_probe.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int)]
        lib.bmfr_png_probe.restype = ctypes.c_int
        lib.bmfr_png_read.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_float),
            ctypes.c_int, ctypes.c_int]
        lib.bmfr_png_read.restype = ctypes.c_int
        lib.bmfr_load_frames.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,
            ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int]
        lib.bmfr_load_frames.restype = ctypes.c_int
        lib.bmfr_last_error.argtypes = []
        lib.bmfr_last_error.restype = ctypes.c_char_p
        _LIB = lib
        return _LIB


def available() -> bool:
    return _load() is not None


def _err(lib) -> str:
    msg = lib.bmfr_last_error()
    return msg.decode() if msg else "unknown native IO error"


def read_exr(path: str) -> np.ndarray:
    lib = _load()
    w = ctypes.c_int()
    h = ctypes.c_int()
    c = ctypes.c_int()
    if lib.bmfr_exr_read_header(path.encode(), w, h, c) != 0:
        raise IOError(f"{path}: {_err(lib)}")
    out = np.empty((h.value, w.value, c.value), np.float32)
    rc = lib.bmfr_exr_read(
        path.encode(), out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        w.value, h.value, c.value)
    if rc != 0:
        raise IOError(f"{path}: {_err(lib)}")
    return out


EXR_COMPRESSION = {"none": 0, "rle": 1, "zips": 2, "zip": 3}


def write_exr(path: str, img: np.ndarray, half: bool = False,
              compression: str = "zip"):
    lib = _load()
    img = np.ascontiguousarray(img, np.float32)
    h, w, c = img.shape
    rc = lib.bmfr_exr_write_ex(
        path.encode(), img.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        w, h, c, 1 if half else 0, EXR_COMPRESSION[compression])
    if rc != 0:
        raise IOError(f"{path}: {_err(lib)}")


def write_png(path: str, img_u8: np.ndarray):
    lib = _load()
    img_u8 = np.ascontiguousarray(img_u8, np.uint8)
    h, w, c = img_u8.shape
    rc = lib.bmfr_png_write(
        path.encode(), img_u8.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        w, h, c)
    if rc != 0:
        raise IOError(f"{path}: {_err(lib)}")


def read_png_rgb01(path: str) -> np.ndarray:
    """Read a PNG as float32 RGB in [0, 1] — the comparison domain for the
    OpenCL reference's tone-mapped outputs (opencl/bmfr.cpp:521-547)."""
    lib = _load()
    w = ctypes.c_int()
    h = ctypes.c_int()
    if lib.bmfr_png_probe(path.encode(), w, h) != 0:
        raise IOError(f"{path}: {_err(lib)}")
    out = np.empty((h.value, w.value, 3), np.float32)
    rc = lib.bmfr_png_read(
        path.encode(), out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        w.value, h.value)
    if rc != 0:
        raise IOError(f"{path}: {_err(lib)}")
    return out


def load_frames(paths, width, height, channels=3, threads=0) -> np.ndarray:
    """Threaded batch EXR load (the OpenMP parallel-for equivalent,
    opencl/bmfr.cpp:259-307). Returns f32 [N, H, W, C]."""
    lib = _load()
    n = len(paths)
    out = np.empty((n, height, width, channels), np.float32)
    arr = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
    rc = lib.bmfr_load_frames(
        arr, n, out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        width, height, channels, threads)
    if rc != 0:
        raise IOError(_err(lib))
    return out
