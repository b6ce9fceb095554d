"""Stochastic Moving MNIST: procedural bouncing-digit clips (port of
``npvp_tpu/data/smmnist.py``).

Two digit sprites bounce inside the canvas; at a wall the normal velocity is
resampled away from it and the tangential one resampled (stochastic mode)
or both reflected (deterministic mode). As in the JAX package, a clip has
two renderers, each with its own random stream:

- per index (``ds[idx]``): clip ``idx`` draws from
  ``np.random.SeedSequence([idx, train])``, the JAX package's per-index
  stream;
- per batch (:meth:`StochasticMovingMNIST.get_batch`, which the batch
  loader calls when the dataset is not wrapped): the C++ library of
  ``data/native_bindings.py``, clip ``idx`` seeded with ``2·idx + train``,
  the JAX package's native stream; clip by clip as above where that
  library cannot be built.

The default sprites are the JAX package's glyph bank at the shipped digit
size (:func:`glyph_bank`), read from a fixture, so no image library is
needed; other sizes use a bitmap font (:func:`default_sprite_bank`).
Neither is MNIST: the JAX package reads a local torchvision MNIST where
one exists, and the repo holds none.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional

import numpy as np

from npvp_tpu_torch.data import native_bindings

# the JAX package's glyph banks at the shipped digit size, as uint8 levels
# (tests/make_torch_glyphs.py writes it, with Pillow 12.1.0)
GLYPH_FIXTURE = (Path(__file__).resolve().parents[1] / "testdata"
                 / "smmnist_glyphs.npz")
GLYPH_SIZE = 32

# 5 × 7 bitmaps of the digits 0-9, one string of rows each
_FONT = {
    0: "01110 10001 10011 10101 11001 10001 01110",
    1: "00100 01100 00100 00100 00100 00100 01110",
    2: "01110 10001 00001 00010 00100 01000 11111",
    3: "11110 00001 00001 01110 00001 00001 11110",
    4: "00010 00110 01010 10010 11111 00010 00010",
    5: "11111 10000 11110 00001 00001 10001 01110",
    6: "00110 01000 10000 11110 10001 10001 01110",
    7: "11111 00001 00010 00100 01000 01000 01000",
    8: "01110 10001 10001 01110 10001 10001 01110",
    9: "01110 10001 10001 01111 00001 00010 01100",
}


def glyph_bank(train: bool = True) -> np.ndarray:
    """The JAX package's default SMMNIST sprites (640, 32, 32) float32:
    ``_render_glyph_bank(32, seed=0 if train else 1)`` of
    ``npvp_tpu/data/smmnist.py``, PIL's default font drawn by Pillow 12.1.0
    (the version is stored in the fixture), read from
    ``testdata/smmnist_glyphs.npz``. Its digits are anti-aliased: a
    sprite's brightest pixel may be below 1."""
    with np.load(GLYPH_FIXTURE, allow_pickle=False) as f:
        return f["train" if train else "test"].astype(np.float32) / 255


def default_sprite_bank(digit_size: int, per_digit: int = 64,
                        seed: int = 0) -> np.ndarray:
    """(10·per_digit, digit_size, digit_size) float32 sprites in [0, 1]
    drawn from the bitmap font, at any size: each digit scaled by a seeded
    factor (nearest neighbour, with a soft edge) and placed at a seeded
    offset; every sprite reaches 1. Not the JAX package's glyphs
    (:func:`glyph_bank`), which the dataset uses at digit size 32."""
    rng = np.random.default_rng(seed)
    sprites = np.zeros((10 * per_digit, digit_size, digit_size), np.float32)
    for digit in range(10):
        glyph = np.array([[c == "1" for c in row]
                          for row in _FONT[digit].split()], np.float32)
        for j in range(per_digit):
            scale = rng.uniform(0.45, 0.75) * digit_size / 7.0
            gh = max(1, min(digit_size, int(round(7 * scale))))
            gw = max(1, min(digit_size, int(round(5 * scale))))
            rows = np.minimum((np.arange(gh) * 7 / gh).astype(int), 6)
            cols = np.minimum((np.arange(gw) * 5 / gw).astype(int), 4)
            big = glyph[rows][:, cols]
            soft = big.copy()  # a one-pixel soft edge, as a stroke has
            soft[1:] = np.maximum(soft[1:], 0.5 * big[:-1])
            soft[:, 1:] = np.maximum(soft[:, 1:], 0.5 * big[:, :-1])
            oy = int(rng.integers(0, digit_size - gh + 1))
            ox = int(rng.integers(0, digit_size - gw + 1))
            sprites[digit * per_digit + j, oy:oy + gh, ox:ox + gw] = soft
    return sprites


class StochasticMovingMNIST:
    """Bouncing-digit clips (T, S, S, 1) in [0, 1]; velocities in [-4, 4]."""

    def __init__(self, train: bool = True, num_past_frames: int = 5,
                 num_future_frames: int = 10, num_digits: int = 2,
                 image_size: int = 64, digit_size: int = 32,
                 deterministic: bool = False, length: Optional[int] = None,
                 transform=None, sprites: Optional[np.ndarray] = None):
        self.seq_len = num_past_frames + num_future_frames
        self.num_digits = num_digits
        self.image_size = image_size
        if digit_size >= image_size:
            # keep room for motion at frame sizes below the reference's 64
            digit_size = max(4, image_size // 2)
        self.digit_size = digit_size
        self.deterministic = deterministic
        self.transform = transform
        if sprites is None:
            # the JAX package's glyphs at the shipped size, which is all
            # the fixture holds; the bitmap font (not JAX's) at any other
            sprites = (glyph_bank(train) if digit_size == GLYPH_SIZE else
                       default_sprite_bank(digit_size, seed=0 if train else 1))
        if sprites.shape[1:] != (digit_size, digit_size):
            raise ValueError(f"sprites {sprites.shape[1:]} are not "
                             f"{digit_size}×{digit_size}")
        self.sprites = np.asarray(sprites, np.float32)
        self._length = length if length is not None else len(self.sprites)
        self._train = train

    def __len__(self):
        return self._length

    def get_batch(self, indices) -> np.ndarray:
        """Clips ``indices`` (N, T, S, S, 1) from the C++ library's stream
        (clip ``idx`` seeded with ``2·idx + train``), each then transformed
        with no generator, as the JAX package's ``get_batch`` does; clip by
        clip from the per-index stream where the library is
        unavailable."""
        if not native_bindings.native_available():
            return np.stack([self[int(i)] for i in indices])
        seeds = np.asarray([2 * int(i) + int(self._train) for i in indices],
                           np.uint64)
        out = native_bindings.synth_moving_sprites_batch(
            self.sprites, self.seq_len, self.image_size, self.num_digits,
            self.deterministic, seeds)
        if self.transform is not None:
            out = np.stack([self.transform(c, None) for c in out])
        return out

    def __getitem__(self, idx: int,
                    rng: Optional[np.random.Generator] = None) -> np.ndarray:
        """Clip ``idx``; ``rng``, the loader's per-sample generator, only
        reaches the transform (the clip's own draws follow ``idx``)."""
        r = np.random.default_rng(
            np.random.SeedSequence([idx, int(self._train)]))
        S, D = self.image_size, self.digit_size
        clip = np.zeros((self.seq_len, S, S, 1), np.float32)
        lim = S - D
        for _ in range(self.num_digits):
            sprite = self.sprites[int(r.integers(len(self.sprites)))]
            sx = int(r.integers(lim))
            sy = int(r.integers(lim))
            dx = int(r.integers(-4, 5))
            dy = int(r.integers(-4, 5))
            for t in range(self.seq_len):
                if sy < 0:
                    sy = 0
                    if self.deterministic:
                        dy = -dy
                    else:
                        dy = int(r.integers(1, 5))
                        dx = int(r.integers(-4, 5))
                elif sy >= lim:
                    sy = lim - 1
                    if self.deterministic:
                        dy = -dy
                    else:
                        dy = int(r.integers(-4, 0))
                        dx = int(r.integers(-4, 5))
                if sx < 0:
                    sx = 0
                    if self.deterministic:
                        dx = -dx
                    else:
                        dx = int(r.integers(1, 5))
                        dy = int(r.integers(-4, 5))
                elif sx >= lim:
                    sx = lim - 1
                    if self.deterministic:
                        dx = -dx
                    else:
                        dx = int(r.integers(-4, 0))
                        dy = int(r.integers(-4, 5))
                clip[t, sy:sy + D, sx:sx + D, 0] += sprite
                sy += dy
                sx += dx
        np.clip(clip, 0.0, 1.0, out=clip)
        if self.transform is not None:
            clip = self.transform(clip, rng)
        return clip
