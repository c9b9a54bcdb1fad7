"""PNG files, and the route that reads and writes them.

A small PNG codec in numpy and ``zlib`` for the images of TUM RGB-D
sequences and of ``apps.make_dataset``: non-interlaced, 8-bit gray, RGB or
RGBA and 16-bit gray (the depth maps), all five row filters on reading,
filter 0 on writing.  Palette, interlaced and other bit depths are refused.

:func:`read_rgb`, :func:`read_depth` and :func:`write` take the first route
that works on the machine (:func:`route`): OpenCV where ``cv2`` imports,
else, for reading, the native libpng loader (``io/native_loader.py``, built
by ``make -C native``), else this codec.  The route taken is logged once per
process.
"""

from __future__ import annotations

import functools
import logging
import struct
import zlib
from pathlib import Path

import numpy as np

logger = logging.getLogger("dvo.png")

SIGNATURE = b"\x89PNG\r\n\x1a\n"
ROUTES = ("cv2", "native", "codec")
# Colour types: channels per pixel.
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}


def _chunks(data: bytes):
    pos = len(SIGNATURE)
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        yield kind, data[pos + 8:pos + 8 + length]
        pos += 12 + length


def _unfilter(raw: np.ndarray, height: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the per-row filters of (height, 1 + stride) scanlines: None and
    Up elementwise, Sub as a running sum over each of the bpp byte lanes,
    Average and Paeth byte by byte (a last-resort route: OpenCV and libpng
    read PNGs faster)."""
    rows = raw.reshape(height, stride + 1)
    out = np.zeros((height, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(height):
        kind = int(rows[y, 0])
        line = rows[y, 1:]
        if kind == 0:
            cur = line
        elif kind == 1:
            lanes = line.reshape(-1, bpp).astype(np.int64)
            cur = (np.cumsum(lanes, axis=0) & 0xFF).astype(np.uint8).reshape(-1)
        elif kind == 2:
            cur = line + prev  # uint8 arithmetic wraps modulo 256
        elif kind in (3, 4):
            cur_l = [0] * stride
            line_l, prev_l = line.tolist(), prev.tolist()
            for x in range(stride):
                a = cur_l[x - bpp] if x >= bpp else 0
                b = prev_l[x]
                if kind == 3:
                    pred = (a + b) >> 1
                else:
                    c = prev_l[x - bpp] if x >= bpp else 0
                    p = a + b - c
                    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                    pred = a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)
                cur_l[x] = (line_l[x] + pred) & 0xFF
            cur = np.asarray(cur_l, np.uint8)
        else:
            raise ValueError(f"PNG: unknown filter type {kind}")
        out[y] = cur
        prev = out[y]
    return out


def decode(path) -> np.ndarray:
    """A PNG file -> (H, W) for gray, (H, W, C) otherwise; uint8, or uint16
    at bit depth 16, channels in the file's order (RGB, RGBA)."""
    data = Path(path).read_bytes()
    if not data.startswith(SIGNATURE):
        raise ValueError(f"not a PNG file: {path}")
    header, idat = None, []
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError(f"PNG without a header: {path}")
    width, height, depth, colour, _, _, interlace = header
    if interlace or colour not in _CHANNELS or depth not in (8, 16):
        raise ValueError(f"PNG: unsupported layout (colour type {colour}, bit depth {depth}, "
                         f"interlace {interlace}): {path}")
    channels = _CHANNELS[colour]
    bpp = channels * depth // 8
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    pixels = _unfilter(raw, height, width * bpp, bpp)
    if depth == 16:
        pixels = pixels.view(">u2").astype(np.uint16)
    pixels = pixels.reshape(height, width, channels)
    return pixels[..., 0] if channels == 1 else pixels


def encode(path, image: np.ndarray) -> Path:
    """Write (H, W) gray or (H, W, 3) RGB, uint8 or (gray) uint16, as a
    PNG with filter 0 on every row."""
    image = np.ascontiguousarray(image)
    if image.dtype == np.uint8 and image.ndim == 3 and image.shape[2] == 3:
        depth, colour = 8, 2
    elif image.dtype in (np.uint8, np.uint16) and image.ndim == 2:
        depth, colour = image.dtype.itemsize * 8, 0
    else:
        raise ValueError(f"PNG: cannot write {image.dtype} of shape {image.shape}")
    height, width = image.shape[:2]
    rows = image.astype(">u2" if depth == 16 else np.uint8).reshape(height, -1).view(np.uint8)
    raw = np.concatenate([np.zeros((height, 1), np.uint8), rows], axis=1)

    def chunk(kind: bytes, body: bytes) -> bytes:
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))

    path = Path(path)
    path.write_bytes(
        SIGNATURE
        + chunk(b"IHDR", struct.pack(">IIBBBBB", width, height, depth, colour, 0, 0, 0))
        + chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
        + chunk(b"IEND", b""))
    return path


@functools.lru_cache(maxsize=None)
def route(write: bool = False) -> str:
    """The route PNGs are read (or written) by on this machine: "cv2",
    "native" (reading only) or "codec".  Logged the first time it is asked."""
    try:
        import cv2  # noqa: F401

        found = "cv2"
    except ImportError:
        found = "codec"
        if not write:
            from dense_visual_odometry_torch.io import native_loader

            try:
                native_loader.load_library()
                found = "native"
            except native_loader.NativeLoaderUnavailable as exc:
                logger.info("native PNG loader unavailable: %s", str(exc).splitlines()[0])
    logger.info("PNG %s route: %s", "write" if write else "read", found)
    return found


def read_rgb(path, via: str | None = None) -> np.ndarray:
    """-> (H, W, 3) uint8 RGB of an 8-bit PNG (gray replicated, alpha
    dropped), by ``via`` or the machine's :func:`route`."""
    via = via or route()
    if via == "cv2":
        import cv2

        img = cv2.imread(str(path), cv2.IMREAD_ANYCOLOR)
        if img is None:
            raise FileNotFoundError(f"could not read RGB image: {path}")
        return cv2.cvtColor(img, cv2.COLOR_BGR2RGB)
    if via == "native":
        from dense_visual_odometry_torch.io import native_loader

        return native_loader.decode_rgb(path)
    if not Path(path).exists():
        raise FileNotFoundError(f"could not read RGB image: {path}")
    img = decode(path)
    if img.dtype != np.uint8:
        raise ValueError(f"PNG: expected an 8-bit image: {path}")
    if img.ndim == 2:
        return np.repeat(img[..., None], 3, axis=2)
    return np.ascontiguousarray(img[..., :3]) if img.shape[2] >= 3 else np.repeat(
        img[..., :1], 3, axis=2)


def read_depth(path, via: str | None = None) -> np.ndarray:
    """-> (H, W) uint16 of a 16-bit gray PNG, by ``via`` or :func:`route`."""
    via = via or route()
    if via == "cv2":
        import cv2

        img = cv2.imread(str(path), cv2.IMREAD_UNCHANGED)
        if img is None:
            raise FileNotFoundError(f"could not read depth image: {path}")
        return img
    if via == "native":
        from dense_visual_odometry_torch.io import native_loader

        return native_loader.decode_depth(path)
    if not Path(path).exists():
        raise FileNotFoundError(f"could not read depth image: {path}")
    return decode(path)


def write(path, image: np.ndarray, via: str | None = None) -> Path:
    """Write an image by ``via`` or the machine's write :func:`route` (RGB
    arrays in RGB order either way)."""
    via = via or route(write=True)
    if via == "cv2":
        import cv2

        img = image[..., ::-1] if image.ndim == 3 else image
        if not cv2.imwrite(str(path), np.ascontiguousarray(img)):
            raise IOError(f"could not write {path}")
        return Path(path)
    return encode(path, image)
