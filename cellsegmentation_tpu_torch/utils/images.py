"""The image outputs the JAX package draws and writes with ``cv2``, in numpy
and the standard library, so that detection and the heatmaps run where
``cv2`` is not installed:

- ``write_png``: uint8 gray or RGB arrays as 8-bit PNG files (``zlib`` and
  ``struct``), which ``cv2.imread`` decodes to the pixels ``cv2.imwrite``
  of the same image (BGR-converted, for RGB) would give, and ``read_png``,
  which reads those files back;
- ``fill_circle``: the filled circle of ``cv2.circle(..., cv2.FILLED)``
  (8-connected, no sub-pixel shift), OpenCV's midpoint walk;
- ``COLORMAP_JET`` and ``apply_jet``: ``cv2.applyColorMap(gray,
  cv2.COLORMAP_JET)``, BGR, as OpenCV's 256-entry table;
- ``add_weighted_half``: ``cv2.addWeighted(a, 0.5, b, 0.5, 0)`` on uint8,
  round half to even.

Image *reading* (ROI files, point sets, WSIs) stays with ``cv2`` and
``openslide``, imported where a file is read.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

# cv2.applyColorMap(np.arange(256, dtype=np.uint8), cv2.COLORMAP_JET): one
# BGR triple per gray level
_JET_HEX = (
    "8000008400008800008c00009000009400009800009c0000a00000a40000a80000ac0000"
    "b00000b40000b80000bc0000c00000c40000c80000cc0000d00000d40000d80000dc0000"
    "e00000e40000e80000ec0000f00000f40000f80000fc0000ff0000ff0400ff0800ff0c00"
    "ff1000ff1400ff1800ff1c00ff2000ff2400ff2800ff2c00ff3000ff3400ff3800ff3c00"
    "ff4000ff4400ff4800ff4c00ff5000ff5400ff5800ff5c00ff6000ff6400ff6800ff6c00"
    "ff7000ff7400ff7800ff7c00ff8000ff8400ff8800ff8c00ff9000ff9400ff9800ff9c00"
    "ffa000ffa400ffa800ffac00ffb000ffb400ffb800ffbc00ffc000ffc400ffc800ffcc00"
    "ffd000ffd400ffd800ffdc00ffe000ffe400ffe800ffec00fff000fff400fff800fffc00"
    "feff02faff06f6ff0af2ff0eeeff12eaff16e6ff1ae2ff1edeff22daff26d6ff2ad2ff2e"
    "ceff32caff36c6ff3ac2ff3ebeff42baff46b6ff4ab2ff4eaeff52aaff56a6ff5aa2ff5e"
    "9eff629aff6696ff6a92ff6e8eff728aff7686ff7a82ff7e7eff827aff8676ff8a72ff8e"
    "6eff926aff9666ff9a62ff9e5effa25affa656ffaa52ffae4effb24affb646ffba42ffbe"
    "3effc23affc636ffca32ffce2effd22affd626ffda22ffde1effe21affe616ffea12ffee"
    "0efff20afff606fffa01fffe00fcff00f8ff00f4ff00f0ff00ecff00e8ff00e4ff00e0ff"
    "00dcff00d8ff00d4ff00d0ff00ccff00c8ff00c4ff00c0ff00bcff00b8ff00b4ff00b0ff"
    "00acff00a8ff00a4ff00a0ff009cff0098ff0094ff0090ff008cff0088ff0084ff0080ff"
    "007cff0078ff0074ff0070ff006cff0068ff0064ff0060ff005cff0058ff0054ff0050ff"
    "004cff0048ff0044ff0040ff003cff0038ff0034ff0030ff002cff0028ff0024ff0020ff"
    "001cff0018ff0014ff0010ff000cff0008ff0004ff0000ff0000fc0000f80000f40000f0"
    "0000ec0000e80000e40000e00000dc0000d80000d40000d00000cc0000c80000c40000c0"
    "0000bc0000b80000b40000b00000ac0000a80000a40000a000009c000098000094000090"
    "00008c000088000084000080"
)
COLORMAP_JET = np.frombuffer(bytes.fromhex(_JET_HEX), np.uint8).reshape(256, 3)


def apply_jet(gray: np.ndarray) -> np.ndarray:
    """uint8 [H, W] -> BGR uint8 [H, W, 3] through ``COLORMAP_JET``."""
    return COLORMAP_JET[np.asarray(gray, np.uint8)]


def add_weighted_half(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """(a + b) / 2 of two uint8 arrays, rounded half to even."""
    s = a.astype(np.float32) + b.astype(np.float32)
    return np.rint(s * np.float32(0.5)).astype(np.uint8)


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def write_png(path: str, img: np.ndarray) -> None:
    """Write uint8 gray [H, W] or RGB [H, W, 3] pixels to ``path`` as an
    8-bit PNG (unfiltered rows, zlib level 6)."""
    img = np.ascontiguousarray(img)
    if img.dtype != np.uint8 or img.ndim not in (2, 3) or (
            img.ndim == 3 and img.shape[2] != 3):
        raise ValueError(f"expected uint8 [H, W] or [H, W, 3], got {img.dtype} "
                         f"{img.shape}")
    h, w = img.shape[:2]
    color = 0 if img.ndim == 2 else 2
    rows = img.reshape(h, -1)
    raw = np.zeros((h, rows.shape[1] + 1), np.uint8)  # filter byte 0 per row
    raw[:, 1:] = rows
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n"
                + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0))
                + _chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
                + _chunk(b"IEND", b""))


def _circle_spans(radius: int):
    """(dy, dx_lo, dx_hi) row spans of OpenCV's filled midpoint circle."""
    spans = []
    err, dx, dy, plus, minus = 0, radius, 0, 1, 2 * radius - 1
    while dx >= dy:
        spans += [(-dy, -dx, dx), (dy, -dx, dx), (-dx, -dy, dy), (dx, -dy, dy)]
        dy += 1
        err += plus
        plus += 2
        mask = -1 if err > 0 else 0
        err -= minus & mask
        dx += mask
        minus -= mask & 2
    return spans


def fill_circle(img: np.ndarray, center_xy, radius: int, color) -> np.ndarray:
    """Paint ``cv2.circle(img, center_xy, radius, color, cv2.FILLED)`` in
    place (``center_xy`` is (column, row)) and return ``img``."""
    h, w = img.shape[:2]
    cx, cy = int(center_xy[0]), int(center_xy[1])
    for dy, lo, hi in _circle_spans(int(radius)):
        y = cy + dy
        x0, x1 = max(cx + lo, 0), min(cx + hi, w - 1)
        if 0 <= y < h and x0 <= x1:
            img[y, x0:x1 + 1] = color
    return img


def read_png(path: str) -> np.ndarray:
    """The pixels of a PNG file ``write_png`` wrote (8-bit gray or RGB,
    unfiltered rows): uint8 [H, W] or [H, W, 3]."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError(f"{path} is not a PNG file")
    pos, idat, hdr = 8, b"", None
    while pos < len(data):
        n, = struct.unpack(">I", data[pos:pos + 4])
        kind, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        if kind == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat += body
        pos += n + 12
    w, h, depth, color, _, _, interlace = hdr
    if depth != 8 or color not in (0, 2) or interlace:
        raise ValueError(f"{path}: only 8-bit gray or RGB PNGs are read")
    ch = 1 if color == 0 else 3
    raw = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, w * ch + 1)
    if raw[:, 0].any():
        raise ValueError(f"{path}: filtered rows are not read")
    img = raw[:, 1:].reshape(h, w, ch)
    return img[..., 0].copy() if ch == 1 else img.copy()
