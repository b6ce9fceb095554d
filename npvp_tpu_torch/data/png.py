"""PNG reader and writer on ``zlib`` and numpy: the port's counterpart of
PIL's decode in the JAX package's ``load_frame``, for hosts without Pillow.

The reader parses the chunks (signature and every CRC checked), inflates
the concatenated IDATs and reverses the five row filters, then converts to
``"L"`` or ``"RGB"`` exactly as PIL's ``Image.convert`` does:

- RGB, RGBA and palette colours → L by PIL's fixed-point luma
  ``(19595 R + 38470 G + 7471 B + 0x8000) >> 16``;
- grey → RGB by replication;
- alpha is dropped, not composited.

It reads colour types 0 (grey), 2 (RGB), 4 (grey + alpha) and 6 (RGBA) at
bit depth 8, and 3 (palette) at 1, 2, 4 or 8 bits. Anything else
(interlaced images, 16-bit samples, a bad signature or CRC, a truncated
stream) raises ``ValueError`` naming the file.

Filters. Sub, Average and Paeth predict a byte from the one ``bpp`` bytes
to its left (a), the one above (b) and the one above-left (c), so the
unfiltered image is a recurrence along the rows and down the image. Every
dependency of pixel (r, c) lies on the anti-diagonals r + c − 1 and
r + c − 2, so :func:`unfilter` runs a wavefront: the image is skewed so
that each anti-diagonal is one contiguous slab, and one numpy step decodes
a whole anti-diagonal of every image in the batch (H + W − 1 steps for any
mix of row filters). Frames of one clip share their geometry and are
unfiltered together.

The writer (:func:`encode`, :func:`write_png`) emits any filter per row,
or picks one per row by the minimum sum of absolute signed bytes, the
heuristic of libpng and PIL; it builds test trees on hosts without PIL.
"""

from __future__ import annotations

import struct
import zlib
from pathlib import Path
from typing import NamedTuple, Optional, Sequence, Union

import numpy as np
from numpy.lib.stride_tricks import as_strided

SIGNATURE = b"\x89PNG\r\n\x1a\n"
# channels of each colour type, and the bit depths read for it
CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
BIT_DEPTHS = {0: (8,), 2: (8,), 3: (1, 2, 4, 8), 4: (8,), 6: (8,)}


class Header(NamedTuple):
    width: int
    height: int
    bit_depth: int
    color_type: int

    @property
    def bpp(self) -> int:
        """Bytes of one filter unit: a pixel, or one byte below 8 bits."""
        return max(1, CHANNELS[self.color_type] * self.bit_depth // 8)

    @property
    def stride(self) -> int:
        """Bytes of one unfiltered row."""
        return -(-self.width * CHANNELS[self.color_type] * self.bit_depth
                 // 8)


class Chunks(NamedTuple):
    header: Header
    idat: bytes                  # the concatenated, still deflated, IDATs
    palette: Optional[np.ndarray]  # (n, 3) uint8, colour type 3


def luma(rgb: np.ndarray) -> np.ndarray:
    """PIL's RGB → L: ``(19595 R + 38470 G + 7471 B + 0x8000) >> 16``."""
    rgb = rgb.astype(np.uint32)
    return ((19595 * rgb[..., 0] + 38470 * rgb[..., 1] + 7471 * rgb[..., 2]
             + 0x8000) >> 16).astype(np.uint8)


def read_chunks(data: bytes, name: str = "<bytes>") -> Chunks:
    """Walk the chunks of a PNG stream; raise ``ValueError`` naming
    ``name`` on a bad signature, a bad CRC, a truncated stream or an image
    this reader does not take."""
    if data[:8] != SIGNATURE:
        raise ValueError(f"{name}: not a PNG file (bad signature)")
    pos, header, palette, idat = 8, None, None, []
    while True:
        if pos + 8 > len(data):
            raise ValueError(f"{name}: truncated PNG (no IEND)")
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        crc = data[pos + 8 + length:pos + 12 + length]
        if len(body) != length or len(crc) != 4:
            raise ValueError(f"{name}: truncated {kind!r} chunk")
        if zlib.crc32(kind + body) != struct.unpack(">I", crc)[0]:
            raise ValueError(f"{name}: bad CRC in the {kind!r} chunk")
        pos += 12 + length
        if kind == b"IHDR":
            w, h, depth, ctype, comp, filt, interlace = struct.unpack(
                ">IIBBBBB", body)
            if ctype not in CHANNELS or depth not in BIT_DEPTHS[ctype]:
                raise ValueError(f"{name}: colour type {ctype} at bit depth "
                                 f"{depth} is not supported (8-bit grey, "
                                 "RGB, LA, RGBA; palette at 1-8 bits)")
            if interlace:
                raise ValueError(f"{name}: interlaced PNGs are not "
                                 "supported")
            if comp or filt or not w or not h:
                raise ValueError(f"{name}: bad IHDR")
            header = Header(w, h, depth, ctype)
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None or not idat:
        raise ValueError(f"{name}: no IHDR or no IDAT chunk")
    if header.color_type == 3 and palette is None:
        raise ValueError(f"{name}: palette image without a PLTE chunk")
    return Chunks(header, b"".join(idat), palette)


def inflate(chunks: Chunks, name: str = "<bytes>") -> np.ndarray:
    """The filtered rows, (H, 1 + stride) uint8: each row's filter type
    byte and its bytes."""
    h = chunks.header
    try:
        raw = zlib.decompress(chunks.idat)
    except zlib.error as e:
        raise ValueError(f"{name}: corrupt image data ({e})") from None
    if len(raw) != h.height * (1 + h.stride):
        raise ValueError(f"{name}: {len(raw)} bytes of image data, not "
                         f"{h.height * (1 + h.stride)}")
    return np.frombuffer(raw, np.uint8).reshape(h.height, 1 + h.stride)


def unfilter(rows: np.ndarray, bpp: int, name: str = "<bytes>"
             ) -> np.ndarray:
    """Reverse the row filters of a batch of images of one geometry:
    ``rows`` (N, H, 1 + stride) uint8 → (N, H, stride) uint8, by the
    anti-diagonal wavefront of the module docstring."""
    n, height, width1 = rows.shape
    units = (width1 - 1) // bpp
    kinds = rows[:, :, 0]
    if kinds.max(initial=0) > 4:
        raise ValueError(f"{name}: unknown filter type {kinds.max()}")
    data = rows[:, :, 1:].reshape(n, height, units, bpp)
    if not kinds.any():
        return data.reshape(n, height, units * bpp).copy()
    diagonals = height + units - 1
    # skewed: unit (r, c) of image i at [r + c + 2, r, i] (at row r + 1 of
    # ``out``, whose row 0 and slabs 0-1 are the zero neighbours of the top
    # row and the left column); each slab is contiguous, images innermost.
    # Rows padded with ``height`` zero units and read with a row stride one
    # unit short of theirs give the skew in one strided copy.
    padded = np.zeros((height + 1, units + height, n, bpp), np.int16)
    padded[:height, :units] = data.transpose(1, 2, 0, 3)
    unit = padded.strides[1]
    skewed = np.zeros((diagonals + 2, height, n, bpp), np.int16)
    skewed[2:] = as_strided(padded, (height, diagonals, n, bpp), (
        padded.strides[0] - unit, unit, *padded.strides[2:])
    ).transpose(1, 0, 2, 3)
    out = np.zeros((diagonals + 2, height + 1, n, bpp), np.int16)
    # per-row 0/1 weights of each filter's predictor: a multiply-add selects
    # faster in numpy than a masked copy
    shape = (height, n, bpp)
    weights = [np.broadcast_to((kinds == k).T[:, :, None], shape).astype(
        np.int16) for k in range(5)]
    used = [bool(w.any()) for w in weights]
    for e in range(2, diagonals + 2):
        d = e - 2
        r0, r1 = max(0, d - units + 1), min(height - 1, d) + 1
        a = out[e - 1, r0 + 1:r1 + 1]
        b = out[e - 1, r0:r1]
        pred = skewed[e, r0:r1].copy()
        if used[1]:
            pred += a * weights[1][r0:r1]
        if used[2]:
            pred += b * weights[2][r0:r1]
        if used[3]:
            avg = a + b
            avg >>= 1
            avg *= weights[3][r0:r1]
            pred += avg
        if used[4]:
            c = out[e - 2, r0:r1]
            bc, ac = b - c, a - c
            pa, pb = np.abs(bc), np.abs(ac)
            pc = np.abs(bc + ac)
            paeth = (pb <= pc) * bc           # b if pb <= pc, else c ...
            paeth += c
            take_a = (pa <= pb) & (pa <= pc)  # ... and a before both
            paeth += take_a * (a - paeth)
            paeth *= weights[4][r0:r1]
            pred += paeth
        pred &= 255
        out[e, r0 + 1:r1 + 1] = pred
    # unit (r, c) back from [r + c + 2, r + 1]: strides (slab + row, slab)
    slab, row = out.strides[:2]
    result = as_strided(out[2:, 1:], (height, units, n, bpp), (
        slab + row, slab, *out.strides[2:])).transpose(2, 0, 1, 3).astype(
            np.uint8)
    return result.reshape(n, height, units * bpp)


def to_mode(pixels: np.ndarray, header: Header,
            palette: Optional[np.ndarray], mode: str,
            name: str = "<bytes>") -> np.ndarray:
    """Unfiltered rows (..., H, stride) → (..., H, W) for ``"L"`` or
    (..., H, W, 3) for ``"RGB"``, as PIL's ``convert``."""
    if mode not in ("L", "RGB"):
        raise ValueError(f"mode {mode!r}: expected 'L' or 'RGB'")
    w, depth, ctype = header.width, header.bit_depth, header.color_type
    lead = pixels.shape[:-1]
    if ctype == 3:
        if depth < 8:
            per = 8 // depth
            shifts = (8 - depth * (1 + np.arange(per))).astype(np.uint8)
            idx = (pixels[..., None] >> shifts) & ((1 << depth) - 1)
            idx = idx.reshape(*lead, -1)[..., :w]
        else:
            idx = pixels
        if idx.max(initial=0) >= len(palette):
            raise ValueError(f"{name}: palette index {idx.max()} past the "
                             f"{len(palette)} colours of PLTE")
        table = palette if mode == "RGB" else luma(palette)
        return table[idx]
    px = pixels.reshape(*lead, w, CHANNELS[ctype])
    if ctype in (0, 4):  # grey, grey + alpha
        grey = px[..., 0]
        return grey if mode == "L" else np.repeat(grey[..., None], 3, -1)
    rgb = px[..., :3]  # RGB, RGBA: alpha dropped
    return luma(rgb) if mode == "L" else np.ascontiguousarray(rgb)


def decode(data: bytes, mode: str = "RGB", name: str = "<bytes>"
           ) -> np.ndarray:
    """One PNG stream → uint8 (H, W) for ``"L"``, (H, W, 3) for
    ``"RGB"``."""
    chunks = read_chunks(data, name)
    rows = unfilter(inflate(chunks, name)[None], chunks.header.bpp, name)[0]
    return to_mode(rows, chunks.header, chunks.palette, mode, name)


def read_png(path: Union[str, Path], mode: str = "RGB") -> np.ndarray:
    return decode(Path(path).read_bytes(), mode, str(path))


def read_pngs(paths: Sequence[Union[str, Path]], mode: str = "RGB"
              ) -> np.ndarray:
    """Frames of one geometry and palette → (N, H, W[, 3]) uint8, their
    filters reversed in one wavefront; frames that differ are decoded one
    by one (and must still share their size to stack)."""
    parsed = [read_chunks(Path(p).read_bytes(), str(p)) for p in paths]
    first = parsed[0]
    if all(c.header == first.header and (
            c.palette is None if first.palette is None
            else c.palette is not None and np.array_equal(
                c.palette, first.palette)) for c in parsed):
        rows = np.stack([inflate(c, str(p)) for c, p in zip(parsed, paths)])
        return to_mode(unfilter(rows, first.header.bpp, str(paths[0])),
                       first.header, first.palette, mode, str(paths[0]))
    return np.stack([
        to_mode(unfilter(inflate(c, str(p))[None], c.header.bpp, str(p))[0],
                c.header, c.palette, mode, str(p))
        for c, p in zip(parsed, paths)])


# -- writer -------------------------------------------------------------------

def _filter_rows(px: np.ndarray, bpp: int) -> np.ndarray:
    """All five filterings of rows ``px`` (H, stride): (5, H, stride)
    uint8, filter k in slab k."""
    x = px.astype(np.int16)
    a = np.zeros_like(x)
    a[:, bpp:] = x[:, :-bpp]
    b = np.zeros_like(x)
    b[1:] = x[:-1]
    c = np.zeros_like(x)
    c[1:, bpp:] = x[:-1, :-bpp]
    pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(a + b - 2 * c)
    paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
    preds = np.stack([np.zeros_like(x), a, b, (a + b) >> 1, paeth])
    return ((x[None] - preds) & 255).astype(np.uint8)


def encode(img: np.ndarray, filters: Union[str, int, Sequence[int]] =
           "adaptive", palette: Optional[np.ndarray] = None,
           bit_depth: int = 8, level: int = 6) -> bytes:
    """A PNG stream of ``img``: uint8 (H, W) or (H, W, 1) grey, (H, W, 2)
    grey + alpha, (H, W, 3) RGB, (H, W, 4) RGBA; with ``palette`` ((n, 3)
    uint8) ``img`` is (H, W) indices stored at ``bit_depth`` 1, 2, 4 or 8.
    ``filters``: one filter type for every row, one per row, or
    "adaptive" (per row, the least sum of absolute signed bytes)."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise ValueError(f"expected uint8 pixels, got {img.dtype}")
    if palette is not None:
        ctype = 3
        palette = np.asarray(palette, np.uint8).reshape(-1, 3)
        if img.ndim != 2 or bit_depth not in BIT_DEPTHS[3]:
            raise ValueError("a palette image is (H, W) indices at 1, 2, 4 "
                             "or 8 bits")
        if img.max(initial=0) >= min(len(palette), 1 << bit_depth):
            raise ValueError("palette index out of range")
        per = 8 // bit_depth
        h, w = img.shape
        padded = np.zeros((h, -(-w // per) * per), np.uint8)
        padded[:, :w] = img
        shifts = (8 - bit_depth * (1 + np.arange(per))).astype(np.uint8)
        px = (padded.reshape(h, -1, per) << shifts).sum(
            -1, dtype=np.uint16).astype(np.uint8)
    else:
        if img.ndim == 2:
            img = img[..., None]
        ctype = {1: 0, 2: 4, 3: 2, 4: 6}[img.shape[-1]]
        if bit_depth != 8:
            raise ValueError("only palette images take bit depths below 8")
        h, w = img.shape[:2]
        px = img.reshape(h, -1)
    header = Header(w, h, bit_depth, ctype)
    filtered = _filter_rows(px, header.bpp)
    if isinstance(filters, str):
        if filters != "adaptive":
            raise ValueError(f"filters={filters!r}")
        signed = filtered.astype(np.int16)
        cost = np.minimum(signed, 256 - signed).sum(-1)    # (5, H)
        kinds = cost.argmin(0)
    else:
        kinds = np.broadcast_to(np.asarray(filters, np.int64), (h,))
        if kinds.min() < 0 or kinds.max() > 4:
            raise ValueError(f"filter types must be 0-4, got {filters!r}")
    rows = np.concatenate([kinds[:, None].astype(np.uint8),
                           filtered[kinds, np.arange(h)]], axis=1)

    def chunk(kind: bytes, body: bytes) -> bytes:
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))

    out = SIGNATURE + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h,
                                                 bit_depth, ctype, 0, 0, 0))
    if palette is not None:
        out += chunk(b"PLTE", palette.tobytes())
    out += chunk(b"IDAT", zlib.compress(rows.tobytes(), level))
    return out + chunk(b"IEND", b"")


def write_png(path: Union[str, Path], img: np.ndarray,
              filters: Union[str, int, Sequence[int]] = "adaptive",
              palette: Optional[np.ndarray] = None,
              bit_depth: int = 8) -> None:
    Path(path).write_bytes(encode(img, filters, palette, bit_depth))
