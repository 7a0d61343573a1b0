"""Image decode, encode and resize of the port's host pipeline, on any
machine: with cv2, with PIL, or with neither.

- Resize: `cv2.resize(..., INTER_LINEAR)` where cv2 is installed, so the
  port's batches are byte-equal to the JAX package's. Without cv2, a
  bilinear resize with half-pixel centres and no antialias in PyTorch
  (`F.interpolate(mode="bilinear", align_corners=False)`, then rounded
  and clamped to uint8): the same sampling as cv2, which rounds in fixed
  point, so it differs from cv2 by at most 1 level on some values.
- Decode: cv2, then PIL, then the port's own reader of 8-bit
  non-interlaced PNG (grey, grey + alpha, RGB or RGBA; all five row
  filters), on stdlib `zlib` and numpy. PNG is lossless, so every route
  gives the same bytes. A file that no installed decoder can read (a JPEG
  without cv2 or PIL) raises `RuntimeError` naming the missing packages.
- Encode: `write_png` writes 8-bit RGB PNG with stdlib `zlib` alone
  (filter 0 on every row), so the synthetic fixture can be made anywhere.

`RESIZE_ROUTE` and `DECODE_ROUTE` name the routes this process takes.
"""

from __future__ import annotations

import struct
import zlib
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

try:
    import cv2
except ImportError:
    cv2 = None
try:
    from PIL import Image
except ImportError:
    Image = None

RESIZE_ROUTE = "cv2" if cv2 is not None else "torch-bilinear"
DECODE_ROUTE = ("cv2" if cv2 is not None
                else "PIL" if Image is not None else "own-png")

_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
#: PNG colour type -> channels, for the types the own reader handles
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}


def library_versions() -> dict:
    """{"cv2": version or "absent", "PIL": version or "absent"}."""
    pil = None
    if Image is not None:
        import PIL

        pil = PIL.__version__
    return {"cv2": cv2.__version__ if cv2 is not None else "absent",
            "PIL": pil or "absent"}


# -- resize -----------------------------------------------------------------
def resize_bilinear(img: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """Bilinear resize of an (H, W[, C]) image to `size` = (h, w), half-pixel
    centres, no antialias; uint8 in, uint8 out (rounded, clamped)."""
    h, w = size
    a = np.asarray(img)
    x = torch.from_numpy(np.ascontiguousarray(a)).to(torch.float32)
    x = x[..., None] if a.ndim == 2 else x
    y = F.interpolate(x.permute(2, 0, 1)[None], size=(h, w), mode="bilinear",
                      align_corners=False)[0].permute(1, 2, 0)
    if a.dtype == np.uint8:
        y = y.round().clamp(0, 255)
    out = y.to(torch.float32).numpy().astype(a.dtype)
    return out[..., 0] if a.ndim == 2 else out


def resize(img: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """Bilinear resize to `size` = (h, w): cv2 where installed, else
    `resize_bilinear`."""
    h, w = size
    if cv2 is not None:
        return cv2.resize(img, (w, h), interpolation=cv2.INTER_LINEAR)
    return resize_bilinear(img, size)


# -- PNG --------------------------------------------------------------------
def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def write_png(path: str, img: np.ndarray) -> None:
    """Write an (H, W, 3) uint8 RGB image as an 8-bit non-interlaced PNG,
    filter 0 on every row."""
    a = np.ascontiguousarray(np.asarray(img))
    if a.dtype != np.uint8 or a.ndim != 3 or a.shape[2] != 3:
        raise ValueError(f"write_png takes (H, W, 3) uint8, got {a.shape} "
                         f"{a.dtype}")
    h, w = a.shape[:2]
    rows = np.zeros((h, 1 + w * 3), np.uint8)     # filter byte 0 a row
    rows[:, 1:] = a.reshape(h, w * 3)
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(_PNG_SIGNATURE + _chunk(b"IHDR", ihdr)
                + _chunk(b"IDAT", zlib.compress(rows.tobytes()))
                + _chunk(b"IEND", b""))


def _paeth(a: int, b: int, c: int) -> int:
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    if pa <= pb and pa <= pc:
        return a
    return b if pb <= pc else c


def _unfilter(raw: bytes, h: int, stride: int, bpp: int) -> np.ndarray:
    """The (h, stride) uint8 scanlines of a PNG's inflated IDAT stream."""
    data = np.frombuffer(raw, np.uint8)
    if data.size != h * (stride + 1):
        raise ValueError(f"PNG data holds {data.size} bytes, the header "
                         f"needs {h * (stride + 1)}")
    data = data.reshape(h, stride + 1)
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(h):
        ftype, line = int(data[y, 0]), data[y, 1:]
        if ftype == 0:                                   # None
            cur = line.copy()
        elif ftype == 1:                                 # Sub
            cur = (np.cumsum(line.reshape(-1, bpp), axis=0, dtype=np.uint64)
                   % 256).astype(np.uint8).reshape(-1)
        elif ftype == 2:                                 # Up
            cur = line + prev                            # wraps mod 256
        elif ftype in (3, 4):                            # Average, Paeth
            cur = bytearray(line.tobytes())
            up = prev.tobytes()
            for i in range(stride):
                left = cur[i - bpp] if i >= bpp else 0
                if ftype == 3:
                    pred = (left + up[i]) >> 1
                else:
                    pred = _paeth(left, up[i], up[i - bpp] if i >= bpp else 0)
                cur[i] = (cur[i] + pred) & 0xFF
            cur = np.frombuffer(bytes(cur), np.uint8)
        else:
            raise ValueError(f"PNG row {y} has filter type {ftype}")
        out[y] = cur
        prev = out[y]
    return out


def read_png(path: str) -> np.ndarray:
    """Decode an 8-bit non-interlaced PNG (grey, grey + alpha, RGB or RGBA)
    to (H, W, 3) uint8 RGB: grey replicated, alpha dropped, as
    `PIL.Image.convert("RGB")` and `cv2.IMREAD_COLOR` do. Other PNGs raise
    `RuntimeError` naming the packages that read them."""
    with open(path, "rb") as f:
        blob = f.read()
    if not blob.startswith(_PNG_SIGNATURE):
        raise RuntimeError(
            f"cannot decode {path}: it is not a PNG, and neither cv2 "
            "(opencv-python) nor PIL (Pillow) is installed to read it")
    pos, header, idat = len(_PNG_SIGNATURE), None, []
    while pos + 8 <= len(blob):
        (n,), kind = struct.unpack(">I", blob[pos:pos + 4]), blob[pos + 4:pos + 8]
        body = blob[pos + 8:pos + 8 + n]
        pos += 12 + n
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError(f"{path}: PNG without an IHDR chunk")
    w, h, depth, ctype, _, _, interlace = header
    if depth != 8 or interlace != 0 or ctype not in _CHANNELS:
        raise RuntimeError(
            f"cannot decode {path}: the port's own PNG reader takes 8-bit "
            f"non-interlaced grey, grey + alpha, RGB or RGBA (this file: "
            f"bit depth {depth}, colour type {ctype}, interlace {interlace});"
            " install cv2 (opencv-python) or PIL (Pillow) to read it")
    ch = _CHANNELS[ctype]
    px = _unfilter(zlib.decompress(b"".join(idat)), h, w * ch, ch)
    px = px.reshape(h, w, ch)
    if ch <= 2:
        return np.ascontiguousarray(np.repeat(px[..., :1], 3, axis=2))
    return np.ascontiguousarray(px[..., :3])


def decode_rgb(path: str) -> Optional[np.ndarray]:
    """Decode an image file to (H, W, 3) uint8 RGB: cv2, else PIL, else
    `read_png`. None where cv2 finds the file unreadable (as
    `cv2.imread` returns it)."""
    if cv2 is not None:
        bgr = cv2.imread(path, cv2.IMREAD_COLOR)
        if bgr is None:
            return None
        return np.ascontiguousarray(bgr[:, :, ::-1])
    if Image is not None:
        with Image.open(path) as im:
            return np.asarray(im.convert("RGB"))
    return read_png(path)
