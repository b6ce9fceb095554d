"""Writes ``npvp_tpu_torch/testdata/smmnist_glyphs.npz``: the JAX package's
SMMNIST glyph banks, which the port reads as its default sprites at the
shipped digit size (``npvp_tpu_torch/data/smmnist.py``, ``glyph_bank``).

Run from the repo root: ``JAX_PLATFORMS=cpu python tests/make_torch_glyphs.py``.
``tests/test_torch_smmnist.py`` renders the banks again and checks that the
committed file equals them, where the installed Pillow is the one that
wrote it.

Contents:

- ``train``, ``test``: ``_render_glyph_bank(32, seed=0)`` and ``seed=1``
  of ``npvp_tpu/data/smmnist.py`` as uint8, (640, 32, 32). The banks are
  8-bit images divided by 255, so uint8 holds them exactly;
- ``pillow``: the Pillow version that drew them (``ImageFont.load_default``
  differs between versions).
"""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
FIXTURE = ROOT / "npvp_tpu_torch" / "testdata" / "smmnist_glyphs.npz"
DIGIT_SIZE = 32
SEEDS = {"train": 0, "test": 1}


def render():
    """The banks as the fixture stores them, and the Pillow version."""
    import PIL

    from npvp_tpu.data.smmnist import _render_glyph_bank

    banks = {}
    for split, seed in SEEDS.items():
        bank = _render_glyph_bank(DIGIT_SIZE, seed=seed)
        levels = np.rint(bank * 255).astype(np.uint8)
        if not np.array_equal(levels.astype(np.float32) / 255, bank):
            raise ValueError(f"the {split} bank is not 8-bit levels / 255")
        banks[split] = levels
    return banks, PIL.__version__


def main():
    banks, pillow = render()
    np.savez_compressed(FIXTURE, pillow=np.array(pillow), **banks)
    print(f"wrote {FIXTURE} ({FIXTURE.stat().st_size} bytes, Pillow "
          f"{pillow})")


if __name__ == "__main__":
    main()
