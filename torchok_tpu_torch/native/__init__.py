"""Image file decoding for the data pipeline (port of ``torchok_tpu.native``,
which decodes JPEG and PNG through libjpeg and libpng).

* PNG is decoded here with the standard library's ``zlib`` and numpy, to
  what libpng gives with ``png_set_expand``, ``png_set_strip_16``,
  ``png_set_gray_to_rgb`` and ``png_set_add_alpha(0xFF)``: 8-bit RGBA for
  every colour type (gray, gray + alpha, RGB, RGBA, palette) and depth
  (1 to 16 bits), ``tRNS`` turned into alpha, 16-bit samples cut to their
  high byte, all five row filters undone (Sub and Up vectorised, Average and
  Paeth a loop over the pixels). PNG is lossless, so the result is exact
  whatever the machine. Adam7-interlaced files raise.
* JPEG goes through libjpeg (``io_kernels.cpp``, built with g++ at first
  use, :mod:`.build`) to RGB; where libjpeg is missing it raises.
* Any other file raises: nothing falls back to another reader.
"""
from __future__ import annotations

import ctypes
import struct
import threading
import zlib

import numpy as np

_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}  # PNG colour type -> samples per pixel

_jpeg = None
_jpeg_lock = threading.Lock()


def probe(data: bytes) -> int:
    """1 = JPEG, 2 = PNG, 0 = neither."""
    if data[:3] == b"\xff\xd8\xff":
        return 1
    if data[:8] == _PNG_SIGNATURE:
        return 2
    return 0


# ------------------------------------------------------------------- PNG
def _chunks(data: bytes):
    at = 8
    while at + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[at:at + 8])
        yield kind, data[at + 8:at + 8 + length]
        at += 12 + length
        if kind == b"IEND":
            return


def _unfilter(raw: np.ndarray, height: int, row_bytes: int, bpp: int) -> np.ndarray:
    """Undo the per-row filters of a decompressed (non-interlaced) image.
    None and Sub rows depend on their own bytes only and are undone for all
    rows at once; Up, Average and Paeth rows then in order, each from the
    finished row above."""
    rows = raw[:height * (row_bytes + 1)].reshape(height, row_bytes + 1)
    kinds = rows[:, 0]
    if (kinds > 4).any():
        raise ValueError(f"PNG row {int(np.argmax(kinds > 4))} has an unknown filter type")
    out = rows[:, 1:].copy()
    sub = np.flatnonzero(kinds == 1)
    if len(sub):  # a running sum per byte lane, mod 256
        lanes = np.cumsum(out[sub].reshape(len(sub), -1, bpp).astype(np.uint64), axis=1)
        out[sub] = (lanes & 0xFF).astype(np.uint8).reshape(len(sub), -1)
    zero = np.zeros(row_bytes, np.uint8)
    for y in np.flatnonzero(kinds >= 2):
        prev = out[y - 1] if y else zero
        if kinds[y] == 2:  # Up
            out[y] += prev
            continue
        cur = out[y].astype(np.int32)
        up = prev.astype(np.int32)
        for i in range(row_bytes):
            a = cur[i - bpp] if i >= bpp else 0
            b = up[i]
            if kinds[y] == 3:  # Average
                cur[i] = (cur[i] + ((a + b) >> 1)) & 0xFF
            else:  # Paeth
                c = up[i - bpp] if i >= bpp else 0
                p = a + b - c
                pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
                cur[i] = (cur[i] + pred) & 0xFF
        out[y] = cur.astype(np.uint8)
    return out


def _samples(rows: np.ndarray, width: int, channels: int, depth: int) -> np.ndarray:
    """(H, W, channels) samples of the unfiltered rows: 8-bit as they are,
    16-bit as their value, below 8 bits unpacked (most significant first)."""
    h = rows.shape[0]
    if depth == 8:
        return rows[:, :width * channels].reshape(h, width, channels)
    if depth == 16:
        wide = rows[:, :width * channels * 2].reshape(h, width, channels, 2).astype(np.uint16)
        return (wide[..., 0] << 8) | wide[..., 1]
    shifts = np.arange(8 - depth, -1, -depth, dtype=np.uint8)
    unpacked = (rows[:, :, None] >> shifts) & ((1 << depth) - 1)
    return unpacked.reshape(h, -1)[:, :width * channels].reshape(h, width, channels)


def decode_png(data: bytes) -> np.ndarray:
    """8-bit RGBA (H, W, 4) of a PNG file's bytes, as libpng gives it."""
    header, palette, trns, idat = None, None, None, []
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"tRNS":
            trns = body
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError("PNG without an IHDR chunk")
    width, height, depth, color, _, _, interlace = header
    if interlace:
        raise NotImplementedError("Adam7-interlaced PNG files are not supported: "
                                  "re-save the file without interlacing")
    channels = _CHANNELS[color]
    row_bytes = (width * channels * depth + 7) // 8
    bpp = max(1, channels * depth // 8)
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    samples = _samples(_unfilter(raw, height, row_bytes, bpp), width, channels, depth)
    alpha = None
    if color == 3:  # palette: indices into PLTE, tRNS gives the alphas
        index = samples[..., 0]
        rgb = palette[index]
        table = np.full(256, 255, np.uint8)
        if trns is not None:
            table[:len(trns)] = np.frombuffer(trns, np.uint8)
        alpha = table[index]
    else:
        if trns is not None and color in (0, 2):  # one colour fully transparent
            key = np.array(struct.unpack(f">{channels}H", trns[:2 * channels]))
            alpha = np.where(np.all(samples == key, axis=-1), 0, 255).astype(np.uint8)
        if depth == 16:
            samples = (samples >> 8).astype(np.uint8)
        elif depth < 8:  # gray only: scaled to the full 8-bit range
            samples = (samples.astype(np.uint16) * (255 // ((1 << depth) - 1))).astype(np.uint8)
        samples = samples.astype(np.uint8)
        if color in (4, 6):
            alpha = samples[..., -1]
            samples = samples[..., :-1]
        rgb = np.repeat(samples, 3, axis=-1) if samples.shape[-1] == 1 else samples
    if alpha is None:
        alpha = np.full(rgb.shape[:2], 255, np.uint8)
    return np.ascontiguousarray(np.concatenate([rgb, alpha[..., None]], axis=-1))


def encode_png(image: np.ndarray, level: int = 6) -> bytes:
    """An 8-bit gray (H, W), RGB or RGBA (H, W, 3|4) image as PNG bytes
    (filter 0 on every row, zlib at ``level``)."""
    img = np.ascontiguousarray(image, np.uint8)
    if img.ndim == 2:
        img = img[..., None]
    h, w, c = img.shape
    color = {1: 0, 3: 2, 4: 6}[c]

    def chunk(kind: bytes, body: bytes) -> bytes:
        return struct.pack(">I", len(body)) + kind + body + \
            struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF)

    rows = np.concatenate([np.zeros((h, 1), np.uint8), img.reshape(h, w * c)], axis=1)
    return (_PNG_SIGNATURE + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(rows.tobytes(), level)) + chunk(b"IEND", b""))


# ------------------------------------------------------------------ JPEG
def _jpeg_library():
    global _jpeg
    with _jpeg_lock:
        if _jpeg is None:
            from torchok_tpu_torch.native.build import build_jpeg_library
            lib = ctypes.CDLL(str(build_jpeg_library()))
            lib.tkio_jpeg_info.restype = ctypes.c_int
            lib.tkio_jpeg_info.argtypes = [ctypes.c_char_p, ctypes.c_int64] + \
                [ctypes.POINTER(ctypes.c_int)] * 3
            lib.tkio_jpeg_decode.restype = ctypes.c_int
            lib.tkio_jpeg_decode.argtypes = [ctypes.c_char_p, ctypes.c_int64, ctypes.c_void_p,
                                             ctypes.c_int, ctypes.c_int]
            _jpeg = lib
        return _jpeg


def decode_jpeg(data: bytes) -> np.ndarray:
    """RGB (H, W, 3) uint8 of a JPEG file's bytes, through libjpeg."""
    lib = _jpeg_library()
    w, h, c = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    if lib.tkio_jpeg_info(data, len(data), ctypes.byref(w), ctypes.byref(h), ctypes.byref(c)):
        raise ValueError("libjpeg could not read the JPEG header")
    out = np.empty((h.value, w.value, 3), np.uint8)
    if lib.tkio_jpeg_decode(data, len(data), out.ctypes.data_as(ctypes.c_void_p), h.value,
                            w.value):
        raise ValueError("libjpeg could not decode the JPEG data")
    return out


def decode_image(data: bytes) -> np.ndarray:
    """A JPEG (-> RGB) or PNG (-> RGBA) file's bytes as a uint8 HWC array."""
    kind = probe(data)
    if kind == 1:
        return decode_jpeg(data)
    if kind == 2:
        return decode_png(data)
    raise ValueError("only JPEG and PNG files are read (the file starts with "
                     f"{data[:8]!r})")


def decode_file(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        data = f.read()
    try:
        return decode_image(data)
    except ValueError as e:
        raise ValueError(f"{path}: {e}") from e
