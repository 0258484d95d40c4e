"""ctypes bindings for the native (C++) threaded frame loader (a copy of
``topfusion_tpu/io/native_loader.py``: the port imports nothing of the JAX
package).  The library is the repository's ``native/libtfnative.so``
(``make -C native``; it links zlib), shared by both packages.

``native/libtfnative.so`` decodes 16-bit depth PNGs on a worker-thread pool
with bounded prefetch, keeping host IO off the fusion critical path (the
native-runtime analogue of the reference's OpenNI capture thread,
reference: tfusion/src/capture.cpp:205-245).  Falls back transparently to
imageio when the shared library hasn't been built (``make -C native``).
"""

from __future__ import annotations

import ctypes
import os
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np

_LIB_PATHS = [
    os.path.join(os.path.dirname(__file__), "..", "..", "native", "libtfnative.so"),
    os.path.join(os.path.dirname(__file__), "libtfnative.so"),
]

_lib = None


def _load_lib():
    global _lib
    if _lib is not None:
        return _lib
    for p in _LIB_PATHS:
        p = os.path.abspath(p)
        if os.path.exists(p):
            lib = ctypes.CDLL(p)
            lib.tf_loader_open.restype = ctypes.c_void_p
            lib.tf_loader_open.argtypes = [
                ctypes.POINTER(ctypes.c_char_p),
                ctypes.c_int,
                ctypes.c_double,
                ctypes.c_int,
                ctypes.c_int,
            ]
            lib.tf_loader_next.restype = ctypes.c_int
            lib.tf_loader_next.argtypes = [
                ctypes.c_void_p,
                ctypes.POINTER(ctypes.c_uint16),
                ctypes.c_int,
                ctypes.POINTER(ctypes.c_uint32),
                ctypes.POINTER(ctypes.c_uint32),
            ]
            lib.tf_loader_error.restype = ctypes.c_char_p
            lib.tf_loader_error.argtypes = [ctypes.c_void_p]
            lib.tf_loader_close.argtypes = [ctypes.c_void_p]
            lib.tf_decode_png.restype = ctypes.c_int
            lib.tf_decode_png.argtypes = [
                ctypes.c_char_p,
                ctypes.POINTER(ctypes.c_uint16),
                ctypes.c_int,
                ctypes.POINTER(ctypes.c_uint32),
                ctypes.POINTER(ctypes.c_uint32),
                ctypes.POINTER(ctypes.c_uint32),
            ]
            _lib = lib
            return lib
    return None


def native_available() -> bool:
    return _load_lib() is not None


def decode_png_native(path: str) -> Optional[np.ndarray]:
    """One-shot native PNG decode -> u16 array [H, W] or [H, W, C]."""
    lib = _load_lib()
    if lib is None:
        return None
    cap = 4096 * 4096 * 4
    buf = np.empty(cap, np.uint16)
    w = ctypes.c_uint32()
    h = ctypes.c_uint32()
    c = ctypes.c_uint32()
    ret = lib.tf_decode_png(
        path.encode(),
        buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
        cap,
        ctypes.byref(w),
        ctypes.byref(h),
        ctypes.byref(c),
    )
    if ret != 1:
        return None
    n = w.value * h.value * c.value
    arr = buf[:n].reshape(h.value, w.value, c.value).copy()
    return arr[..., 0] if c.value == 1 else arr


class NativeFrameLoader:
    """Ordered prefetching iterator over depth PNG paths -> u16 mm frames."""

    def __init__(
        self,
        paths: Sequence[str],
        units_per_meter: float = 5000.0,
        n_threads: int = 4,
        prefetch: int = 8,
    ):
        self._lib = _load_lib()
        self._paths = [os.path.abspath(p) for p in paths]
        self._units = units_per_meter
        self._handle = None
        if self._lib is not None:
            arr = (ctypes.c_char_p * len(self._paths))(
                *[p.encode() for p in self._paths]
            )
            # scale: stored units -> millimeters
            self._handle = ctypes.c_void_p(self._lib.tf_loader_open(
                arr, len(self._paths), 1000.0 / units_per_meter,
                n_threads, prefetch,
            ))
        self._buf = np.empty(4096 * 4096, np.uint16)

    def __iter__(self) -> Iterator[np.ndarray]:
        if self._handle is None:
            # Pure-python fallback.
            from .datasets import _read_depth_png

            for p in self._paths:
                yield _read_depth_png(p, self._units)
            return
        w = ctypes.c_uint32()
        h = ctypes.c_uint32()
        while True:
            ret = self._lib.tf_loader_next(
                self._handle,
                self._buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
                self._buf.size,
                ctypes.byref(w),
                ctypes.byref(h),
            )
            if ret == 0:
                return
            if ret < 0:
                err = self._lib.tf_loader_error(self._handle)
                raise IOError(f"native decode failed: {err.decode()}")
            yield (
                self._buf[: w.value * h.value]
                .reshape(h.value, w.value)
                .copy()
            )

    def close(self):
        if self._handle is not None and self._lib is not None:
            self._lib.tf_loader_close(self._handle)
            self._handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
