"""The port's PNG reader and writer (npvp_tpu_torch/data/png.py) against
PIL, bit for bit: grey, RGB, RGBA, grey + alpha and palette images written
by PIL and by the port's writer with each filter type forced, decoded to
"L" and "RGB"; PIL reads the writer's files back equal; the wavefront
unfilter equals a byte-by-byte loop; and malformed or unsupported files
raise ValueError naming the file."""

import io
import struct
import zlib

import numpy as np
import pytest

pytest.importorskip("torch")
Image = pytest.importorskip("PIL.Image")

from npvp_tpu_torch.data import png  # noqa: E402

MODES = {"L": 1, "LA": 2, "RGB": 3, "RGBA": 4}


def _image(shape, seed):
    """Half noise, half smooth pattern, so PIL's adaptive choice and the
    port's vary their filters."""
    rng = np.random.default_rng(seed)
    h, w, c = shape
    y, x = np.mgrid[:h, :w]
    smooth = (np.sin(y[..., None] / 4 + np.arange(c)) * 90 + 2 * x[..., None]
              ) % 256
    noise = rng.integers(0, 256, shape)
    return np.where(rng.random(shape) < 0.5, noise, smooth).astype(np.uint8)


def _pil(arr, mode, palette=None, **save):
    im = Image.fromarray(arr[..., 0] if arr.ndim == 3 and arr.shape[-1] == 1
                         else arr, mode)
    if palette is not None:
        im.putpalette(palette.flatten().tolist())
    buf = io.BytesIO()
    im.save(buf, "PNG", **save)
    return im, buf.getvalue()


def _assert_decodes_like_pil(data, im):
    for mode in ("L", "RGB"):
        want = np.asarray(im.convert(mode))
        got = png.decode(data, mode)
        assert got.dtype == np.uint8 and got.shape == want.shape
        np.testing.assert_array_equal(got, want, err_msg=mode)


@pytest.mark.parametrize("mode", list(MODES))
def test_reader_equals_pil(mode):
    """PIL's own files (its adaptive filters) and the port's, each filter
    type forced on every row, then adaptive."""
    arr = _image((29, 43, MODES[mode]), seed=len(mode))
    im, data = _pil(arr, mode)
    _assert_decodes_like_pil(data, im)
    for filters in (0, 1, 2, 3, 4, "adaptive", np.arange(29) % 5):
        written = png.encode(arr, filters=filters)
        _assert_decodes_like_pil(written, im)
        back = np.asarray(Image.open(io.BytesIO(written)))
        np.testing.assert_array_equal(back, np.asarray(im))
        kinds = png.inflate(png.read_chunks(written))[:, 0]
        if not isinstance(filters, str):
            np.testing.assert_array_equal(kinds, np.broadcast_to(filters,
                                                                  (29,)))


@pytest.mark.parametrize("bits", [1, 2, 4, 8])
def test_palette_equals_pil(bits):
    rng = np.random.default_rng(bits)
    palette = rng.integers(0, 256, (1 << bits, 3)).astype(np.uint8)
    idx = rng.integers(0, 1 << bits, (17, 37)).astype(np.uint8)
    im, data = _pil(idx, "P", palette, **({"bits": bits} if bits < 8
                                          else {}))
    assert png.read_chunks(data).header.bit_depth == bits
    _assert_decodes_like_pil(data, im)
    for filters in (0, 1, 2, 3, 4, "adaptive"):
        written = png.encode(idx, filters, palette=palette, bit_depth=bits)
        _assert_decodes_like_pil(written, im)
        np.testing.assert_array_equal(
            np.asarray(Image.open(io.BytesIO(written))), idx)


def _unfilter_loop(rows, bpp):
    """The PNG specification's reverse filter, byte by byte."""
    out = np.zeros((rows.shape[0], rows.shape[1] - 1), np.int64)
    for r, row in enumerate(rows):
        kind, raw = int(row[0]), row[1:].astype(np.int64)
        for i in range(len(raw)):
            a = out[r, i - bpp] if i >= bpp else 0
            b = out[r - 1, i] if r else 0
            c = out[r - 1, i - bpp] if r and i >= bpp else 0
            if kind == 4:
                p = a + b - c
                pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
            else:
                pred = (0, a, b, (a + b) // 2)[kind]
            out[r, i] = (raw[i] + pred) % 256
    return out.astype(np.uint8)


@pytest.mark.parametrize("bpp", [1, 3, 4])
def test_wavefront_equals_the_byte_loop(bpp):
    """Random filtered bytes with random filter types per row, a batch of
    three images in one wavefront."""
    rng = np.random.default_rng(bpp)
    rows = rng.integers(0, 256, (3, 9, 1 + 7 * bpp)).astype(np.uint8)
    rows[:, :, 0] = rng.integers(0, 5, (3, 9))
    got = png.unfilter(rows, bpp)
    for i in range(3):
        np.testing.assert_array_equal(got[i], _unfilter_loop(rows[i], bpp))


def test_read_pngs_batches_frames(tmp_path):
    """Frames of one geometry share a wavefront; frames that differ in
    palette or colour type are decoded one by one; both equal PIL."""
    paths = []
    for i in range(4):
        arr = _image((12, 20, 3), seed=10 + i)
        paths.append(tmp_path / f"{i}.png")
        png.write_png(paths[-1], arr, filters=(np.arange(12) + i) % 5)
    grey = tmp_path / "grey.png"
    png.write_png(grey, _image((12, 20, 1), seed=3), filters=4)
    for group in (paths, paths[:2] + [grey]):
        for mode in ("L", "RGB"):
            want = np.stack([np.asarray(Image.open(p).convert(mode))
                             for p in group])
            np.testing.assert_array_equal(png.read_pngs(group, mode), want)


def _chunk(kind, body):
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body)))


def _raw_png(width, height, depth, ctype, interlace=0, data=b""):
    return (png.SIGNATURE + _chunk(b"IHDR", struct.pack(
        ">IIBBBBB", width, height, depth, ctype, 0, 0, interlace))
        + _chunk(b"IDAT", zlib.compress(data)) + _chunk(b"IEND", b""))


def test_reader_raises_naming_the_file(tmp_path):
    good = png.encode(_image((6, 5, 3), seed=1))
    crc_at = good.index(b"IDAT") + 4 + struct.unpack(
        ">I", good[good.index(b"IDAT") - 4:good.index(b"IDAT")])[0]
    bad_crc = good[:crc_at] + bytes([good[crc_at] ^ 1]) + good[crc_at + 1:]
    interlaced = _raw_png(5, 6, 8, 2, interlace=1, data=bytes(6 * 16))
    buf = io.BytesIO()
    Image.fromarray(np.full((6, 5), 40000, np.uint16)).save(buf, "PNG")
    deep = buf.getvalue()
    cases = {"interlaced": interlaced, "16-bit": deep,
             "16-bit RGB": _raw_png(5, 6, 16, 2, data=bytes(6 * 31)),
             "bad CRC": bad_crc, "signature": b"GIF89a" + good[6:],
             "truncated": good[:len(good) // 2],
             "short data": _raw_png(5, 6, 8, 2, data=bytes(10)),
             "filter type 7": _raw_png(1, 1, 8, 0, data=bytes([7, 0]))}
    for what, data in cases.items():
        path = tmp_path / f"{what.replace(' ', '_')}.png"
        path.write_bytes(data)
        with pytest.raises(ValueError, match=path.name):
            png.read_png(path)
    with pytest.raises(ValueError, match="interlaced"):
        png.decode(interlaced)
    with pytest.raises(ValueError, match="bit depth 16"):
        png.decode(deep)
    with pytest.raises(ValueError, match="bad CRC"):
        png.decode(bad_crc)
