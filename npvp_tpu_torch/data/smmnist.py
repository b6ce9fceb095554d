"""Stochastic Moving MNIST: procedural bouncing-digit clips (port of the
per-index renderer of ``npvp_tpu/data/smmnist.py``).

Two digit sprites bounce inside the canvas; at a wall the normal velocity is
resampled away from it and the tangential one resampled (stochastic mode)
or both reflected (deterministic mode). Clip ``idx`` draws from
``np.random.SeedSequence([idx, train])``, the same stream as the JAX
package's per-index renderer, so the two give the same clip from the same
sprites. The sprites are an argument; the default bank is drawn from a
small built-in bitmap font with a seeded shift and scale, so no MNIST copy
and no image library is needed.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

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


def default_sprite_bank(digit_size: int, per_digit: int = 64,
                        seed: int = 0) -> np.ndarray:
    """(10·per_digit, digit_size, digit_size) float32 sprites in [0, 1]:
    each digit of the bitmap font scaled by a seeded factor (nearest
    neighbour, with a soft edge) and placed at a seeded offset."""
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
            sprites = default_sprite_bank(digit_size, seed=0 if train else 1)
        if sprites.shape[1:] != (digit_size, digit_size):
            raise ValueError(f"sprites {sprites.shape[1:]} are not "
                             f"{digit_size}×{digit_size}")
        self.sprites = np.asarray(sprites, np.float32)
        self._length = length if length is not None else len(self.sprites)
        self._train = train

    def __len__(self):
        return self._length

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
