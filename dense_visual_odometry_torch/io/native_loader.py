"""ctypes bindings for the native prefetching PNG loader (``native/``).

Counterpart of ``dense_visual_odometry_tpu/io/native_loader.py``: the
library (``native/loader/dvo_loader.cpp``) decodes PNG frames with libpng
on a pool of worker threads, ``prefetch`` frames ahead of the consumer, so
host decoding overlaps the card's work.  This module

- builds ``native/lib/libdvo_loader.so`` on first use with ``make -C
  native`` (g++ and libpng's headers; ``native/lib/`` is not committed) and
  loads it by path, or raises :class:`NativeLoaderUnavailable` where it
  cannot (the failure is kept: later calls raise it again without
  rebuilding);
- exposes :func:`decode_rgb`, :func:`decode_depth` and
  :class:`NativeSequenceLoader`, an iterator over (rgb, depth) numpy arrays.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import tempfile
from pathlib import Path
from typing import Iterator, Optional, Tuple

import numpy as np

_REPO = Path(__file__).resolve().parents[2]
_LIB_PATH = _REPO / "native" / "lib" / "libdvo_loader.so"


class NativeLoaderUnavailable(RuntimeError):
    """The native loader cannot be built or loaded on this machine."""


_lib: Optional[ctypes.CDLL] = None
_unavailable: Optional[NativeLoaderUnavailable] = None


def _build() -> None:
    """``make -C native`` into a directory of its own, then the library moved
    into ``native/lib/`` in one rename: a process that finds the file there
    (this package's or the JAX package's, which builds the same library)
    never loads a half-written one."""
    _LIB_PATH.parent.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=_LIB_PATH.parent) as tmp:
        try:
            subprocess.run(
                ["make", "-C", str(_REPO / "native"), f"LIBDIR={tmp}"],
                check=True,
                capture_output=True,
                text=True,
                timeout=120,
            )
        except (subprocess.CalledProcessError, FileNotFoundError,
                subprocess.TimeoutExpired) as exc:
            detail = getattr(exc, "stderr", "") or str(exc)
            raise NativeLoaderUnavailable(f"could not build native loader: {detail}") from exc
        os.replace(Path(tmp) / _LIB_PATH.name, _LIB_PATH)


def load_library() -> ctypes.CDLL:
    """Load (building if needed) the native loader library."""
    global _lib, _unavailable
    if _lib is not None:
        return _lib
    if _unavailable is not None:
        raise _unavailable
    try:
        if not _LIB_PATH.exists():
            _build()
        lib = ctypes.CDLL(str(_LIB_PATH))
    except NativeLoaderUnavailable as exc:
        _unavailable = exc
        raise
    except OSError as exc:
        _unavailable = NativeLoaderUnavailable(f"could not load {_LIB_PATH}: {exc}")
        raise _unavailable from exc

    lib.dvo_png_dims.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)
    ]
    lib.dvo_png_dims.restype = ctypes.c_int
    lib.dvo_decode_rgb8.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_uint8), ctypes.c_int,
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
    ]
    lib.dvo_decode_rgb8.restype = ctypes.c_int
    lib.dvo_decode_depth16.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_uint16), ctypes.c_int,
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
    ]
    lib.dvo_decode_depth16.restype = ctypes.c_int
    lib.dvo_seq_open.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_char_p),
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ]
    lib.dvo_seq_open.restype = ctypes.c_void_p
    lib.dvo_seq_get.argtypes = [
        ctypes.c_void_p, ctypes.c_int,
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int,
        ctypes.POINTER(ctypes.c_uint16), ctypes.c_int,
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
    ]
    lib.dvo_seq_get.restype = ctypes.c_int
    lib.dvo_seq_size.argtypes = [ctypes.c_void_p]
    lib.dvo_seq_size.restype = ctypes.c_int
    lib.dvo_seq_close.argtypes = [ctypes.c_void_p]
    lib.dvo_seq_close.restype = None

    _lib = lib
    return lib


def decode_rgb(path) -> np.ndarray:
    """One-shot native decode -> (H, W, 3) uint8 RGB."""
    lib = load_library()
    w, h = ctypes.c_int(), ctypes.c_int()
    if lib.dvo_png_dims(str(path).encode(), ctypes.byref(w), ctypes.byref(h)) != 0:
        raise FileNotFoundError(f"cannot read PNG header: {path}")
    out = np.empty((h.value, w.value, 3), np.uint8)
    rc = lib.dvo_decode_rgb8(
        str(path).encode(),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        out.size, ctypes.byref(w), ctypes.byref(h),
    )
    if rc != 0:
        raise IOError(f"native RGB decode failed ({rc}): {path}")
    return out


def decode_depth(path) -> np.ndarray:
    """One-shot native decode -> (H, W) uint16 depth."""
    lib = load_library()
    w, h = ctypes.c_int(), ctypes.c_int()
    if lib.dvo_png_dims(str(path).encode(), ctypes.byref(w), ctypes.byref(h)) != 0:
        raise FileNotFoundError(f"cannot read PNG header: {path}")
    out = np.empty((h.value, w.value), np.uint16)
    rc = lib.dvo_decode_depth16(
        str(path).encode(),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
        out.size, ctypes.byref(w), ctypes.byref(h),
    )
    if rc != 0:
        raise IOError(f"native depth decode failed ({rc}): {path}")
    return out


class NativeSequenceLoader:
    """Prefetching iterator over an RGB-D sequence's frames.

    >>> loader = NativeSequenceLoader(seq.rgb_paths, seq.depth_paths)
    >>> for rgb, depth in loader: ...
    """

    def __init__(self, rgb_paths, depth_paths, prefetch: int = 4, workers: int = 2):
        if len(rgb_paths) != len(depth_paths):
            raise ValueError("rgb/depth path counts differ")
        self._lib = load_library()
        n = len(rgb_paths)
        rgb_arr = (ctypes.c_char_p * n)(*[str(p).encode() for p in rgb_paths])
        dep_arr = (ctypes.c_char_p * n)(*[str(p).encode() for p in depth_paths])
        self._handle = self._lib.dvo_seq_open(rgb_arr, dep_arr, n, prefetch, workers)
        if not self._handle:
            raise NativeLoaderUnavailable("dvo_seq_open failed")
        self._n = n
        # Probe dims from the first file header.
        w, h = ctypes.c_int(), ctypes.c_int()
        if self._lib.dvo_png_dims(str(rgb_paths[0]).encode(), ctypes.byref(w), ctypes.byref(h)) != 0:
            raise FileNotFoundError(rgb_paths[0])
        self._shape = (h.value, w.value)

    def __len__(self) -> int:
        return self._n

    def get(self, idx: int) -> Tuple[np.ndarray, np.ndarray]:
        h, w = self._shape
        rgb = np.empty((h, w, 3), np.uint8)
        depth = np.empty((h, w), np.uint16)
        ow, oh = ctypes.c_int(), ctypes.c_int()
        rc = self._lib.dvo_seq_get(
            self._handle, idx,
            rgb.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), rgb.size,
            depth.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)), depth.size,
            ctypes.byref(ow), ctypes.byref(oh),
        )
        if rc != 0:
            raise IOError(f"native frame fetch failed ({rc}) at index {idx}")
        return rgb, depth

    def __iter__(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        for i in range(self._n):
            yield self.get(i)

    def close(self) -> None:
        if self._handle:
            self._lib.dvo_seq_close(self._handle)
            self._handle = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):  # pragma: no cover - GC ordering
        try:
            self.close()
        except Exception:
            pass
