"""SMMNIST as the JAX package draws it: the port's default sprites are the
JAX package's glyph banks (the committed fixture equals
``_render_glyph_bank``), ``get_batch`` renders the JAX package's batch
stream, and ``DataModule``'s loaders over the shipped config with no dev
cut give JAX's batches: train (a ``deploy`` merge, clip by clip), val and
test (bare datasets, the batch stream).

Which stream the JAX package takes depends on whether its C++ library
loaded in this process; the port is put on the same path with a
monkeypatch of its own ``native_available``."""

from pathlib import Path

import numpy as np
import pytest
from _jax_native import jax_native_available
from make_torch_glyphs import FIXTURE, SEEDS, render

from npvp_tpu_torch.data import loader as tload
from npvp_tpu_torch.data import native_bindings as tnb
from npvp_tpu_torch.data import smmnist as tsm

ROOT = Path(__file__).resolve().parents[1]
YAML = ROOT / "npvp_tpu" / "configs" / "config_SMMNIST_Unified_NPVP-S.yaml"


@pytest.fixture(scope="module")
def jax_banks():
    """The banks as the installed Pillow draws them; skips where that
    Pillow is not the one that wrote the fixture."""
    import PIL

    with np.load(FIXTURE) as f:
        recorded = str(f["pillow"])
    if PIL.__version__ != recorded:
        pytest.skip(f"the fixture was drawn by Pillow {recorded}, this is "
                    f"Pillow {PIL.__version__}")
    return render()[0]


@pytest.fixture
def same_path(monkeypatch):
    """Put the port on the JAX package's path in this process: the batch
    stream where its library loaded, clip by clip where not."""
    streams = jax_native_available()
    if streams and not tnb.native_available():
        pytest.fail("the JAX package's C++ library loaded, the port's not")
    monkeypatch.setattr(tnb, "native_available", lambda: streams)
    return streams


@pytest.mark.parametrize("split", sorted(SEEDS))
def test_fixture_equals_jax_glyph_bank(jax_banks, split):
    with np.load(FIXTURE) as f:
        stored = f[split]
    assert stored.dtype == np.uint8 and stored.shape == (640, 32, 32)
    np.testing.assert_array_equal(stored, jax_banks[split])
    bank = tsm.glyph_bank(train=(split == "train"))
    assert bank.dtype == np.float32
    from npvp_tpu.data.smmnist import _render_glyph_bank

    np.testing.assert_array_equal(bank, _render_glyph_bank(
        32, seed=SEEDS[split]))


@pytest.mark.parametrize("train", [True, False])
def test_default_sprites_are_jax_sprites(jax_banks, train):
    """The datasets' default banks: JAX's at digit size 32; the bitmap font
    at another size."""
    from npvp_tpu.data.smmnist import StochasticMovingMNIST

    got = tsm.StochasticMovingMNIST(train=train)
    want = StochasticMovingMNIST("/nonexistent", train=train)
    assert len(got) == len(want) == 640
    np.testing.assert_array_equal(got.sprites, want.sprites)
    small = tsm.StochasticMovingMNIST(train=train, image_size=32)
    assert small.digit_size == 16
    np.testing.assert_array_equal(
        small.sprites, tsm.default_sprite_bank(16, seed=0 if train else 1))


@pytest.mark.parametrize("train,deterministic", [
    (True, False), (False, False), (False, True)])
def test_get_batch_equals_jax(same_path, train, deterministic):
    from npvp_tpu.data.smmnist import StochasticMovingMNIST

    kw = dict(train=train, deterministic=deterministic)
    want = StochasticMovingMNIST("/nonexistent", **kw)
    got = tsm.StochasticMovingMNIST(sprites=want.sprites, **kw)
    ids = [0, 7, 639, 3, 100, 5, 6, 11]
    batch = got.get_batch(ids)
    assert batch.shape == (8, 15, 64, 64, 1) and batch.dtype == np.float32
    np.testing.assert_array_equal(batch, want.get_batch(ids))
    if same_path:  # and the stream is the numpy twin's
        np.testing.assert_array_equal(batch, tnb.synth_moving_sprites_reference(
            got.sprites, 15, 64, 2, deterministic,
            np.array(ids, np.uint64) * 2 + train))


def test_get_batch_without_the_library(monkeypatch):
    """Clip by clip from the per-index stream, transformed, where the C++
    library is unavailable; the stream is another draw."""
    monkeypatch.setattr(tnb, "native_available", lambda: False)
    ds = tsm.StochasticMovingMNIST(
        train=False, image_size=32, num_past_frames=2, num_future_frames=3,
        transform=lambda clip, rng: clip * 2 - 1)
    batch = ds.get_batch([4, 1])
    np.testing.assert_array_equal(batch, np.stack([ds[4], ds[1]]))
    assert batch.min() == -1.0
    monkeypatch.undo()
    if tnb.native_available():
        assert not np.array_equal(ds.get_batch([4, 1]), batch)


@pytest.mark.parametrize("split", ["train", "val", "test"])
def test_data_module_equals_jax_without_a_dev_cut(jax_banks, same_path,
                                                  split):
    """A whole epoch of the shipped SMMNIST Unified config's loader, as its
    YAML stands (batch 8, no ``dev_set_size``): each batch equal."""
    from npvp_tpu.core.config import load_config as jload_config
    from npvp_tpu.data.loader import DataModule as JDM

    from npvp_tpu_torch.core.config import load_config

    assert load_config(YAML).Dataset.dev_set_size is None
    jdm, tdm = JDM(jload_config(YAML)), tload.DataModule(load_config(YAML))
    assert tdm.predictor_mode() == jdm.predictor_mode() == "rand_context"
    streamed = hasattr(tdm.dataset(split), "get_batch")
    assert streamed == (split != "train")  # train is the deploy merge
    want = getattr(jdm, f"{split}_loader")("rand_context")
    got = getattr(tdm, f"{split}_loader")("rand_context")
    assert len(got) == len(want) == {"train": 160, "val": 80,
                                     "test": 80}[split]
    for g, w in zip(got, want, strict=True):
        assert sorted(g) == sorted(w)
        for key in w:
            np.testing.assert_array_equal(g[key], w[key], err_msg=key)
