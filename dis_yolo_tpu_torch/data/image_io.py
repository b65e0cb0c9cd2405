"""Reading and writing the split's images without a decoder library.

``read_image`` chooses the decoder by the file's first bytes, as
``cv2.imread`` does (not by its name): a binary PPM (``P6``, maxval 255)
is parsed here in numpy; anything else goes to OpenCV when it imports,
and raises a clear error when it does not (there is no other decoder to
fall back to).  A P6 file written under a ``.jpg`` name reads back the
same through both, so a split stored as P6 is read on a machine without
OpenCV or PIL, as the card's machine is.  ``write_png`` writes the
rendered overlays as lossless PNG with the standard library's ``zlib``.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_WHITESPACE = b" \t\n\r\v\f"


def _ppm_header(data: bytes):
    """(width, height, maxval, offset of the pixel bytes) of a P6 file;
    ``#`` comments in the header are skipped."""
    fields, pos = [], 2
    while len(fields) < 3:
        while pos < len(data) and (data[pos] in _WHITESPACE
                                   or data[pos] == ord("#")):
            if data[pos] == ord("#"):
                while pos < len(data) and data[pos] not in b"\r\n":
                    pos += 1
            else:
                pos += 1
        start = pos
        while pos < len(data) and data[pos] in b"0123456789":
            pos += 1
        if pos == start:
            raise ValueError("malformed PPM header")
        fields.append(int(data[start:pos]))
    if pos >= len(data) or data[pos] not in _WHITESPACE:
        raise ValueError("malformed PPM header")
    return fields[0], fields[1], fields[2], pos + 1


def read_image(path: str) -> np.ndarray:
    """The image at ``path`` as RGB uint8 [H, W, 3]."""
    try:
        with open(path, "rb") as f:
            data = f.read()
    except FileNotFoundError:
        data = b""      # left to the decoder's own error, as cv2 reports it
    if data[:2] == b"P6":
        w, h, maxval, offset = _ppm_header(data)
        if maxval == 255:
            pixels = np.frombuffer(data, np.uint8, 3 * w * h, offset)
            return pixels.reshape(h, w, 3).copy()
    try:
        import cv2
    except ImportError as e:
        raise RuntimeError(
            f"{path}: not a binary PPM (P6, maxval 255), and OpenCV, which "
            "would decode it, is not installed; store the split as P6 "
            "(data.image_io.write_ppm) to read it without OpenCV") from e
    bgr = cv2.imread(path)
    if bgr is None:
        raise FileNotFoundError(f"cannot read image {path}")
    return cv2.cvtColor(bgr, cv2.COLOR_BGR2RGB)


def write_ppm(path: str, rgb: np.ndarray) -> None:
    """Write RGB uint8 [H, W, 3] as a binary PPM (P6, maxval 255), under
    any file name."""
    rgb = np.ascontiguousarray(rgb, np.uint8)
    h, w = rgb.shape[:2]
    with open(path, "wb") as f:
        f.write(b"P6\n%d %d\n255\n" % (w, h))
        f.write(rgb.tobytes())


def _png_chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def write_png(path: str, rgb: np.ndarray) -> None:
    """Write RGB uint8 [H, W, 3] as an 8-bit truecolor PNG (no filter on
    any scanline, zlib level 6), readable by any PNG decoder."""
    rgb = np.ascontiguousarray(rgb, np.uint8)
    if rgb.ndim != 3 or rgb.shape[2] != 3:
        raise ValueError(f"write_png expects [H, W, 3] uint8, got "
                         f"{rgb.shape}")
    h, w = rgb.shape[:2]
    # each scanline starts with its filter type, 0 (none)
    rows = np.concatenate([np.zeros((h, 1), np.uint8),
                           rgb.reshape(h, w * 3)], axis=1)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(_png_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0,
                                                0, 0)))
        f.write(_png_chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)))
        f.write(_png_chunk(b"IEND", b""))
