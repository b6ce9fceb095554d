"""The port's SMMNIST data pipeline against the JAX package's: clips from
one sprite array are equal, and the batch loader's shuffles, rand-context
masks, pairs/vfi splits and the data module's deploy merge and dev-set cut
give the same batches."""

import numpy as np
import pytest
from _torch_helpers import port_config, tiny_config

from npvp_tpu_torch.data import loader as tload
from npvp_tpu_torch.data import smmnist as tsm
from npvp_tpu_torch.data.transforms import build_transforms

SPRITES = tsm.default_sprite_bank(16, per_digit=3, seed=11)


def _jax_smmnist(**kw):
    """The JAX dataset with the port's sprites in place of its own bank."""
    from npvp_tpu.data.smmnist import StochasticMovingMNIST

    ds = StochasticMovingMNIST("/nonexistent", **kw)
    ds.sprites = SPRITES
    ds._length = kw.get("length") or len(SPRITES)
    return ds


def test_default_sprite_bank():
    bank = tsm.default_sprite_bank(32)
    assert bank.shape == (640, 32, 32) and bank.dtype == np.float32
    assert bank.min() == 0.0 and bank.max() == 1.0
    assert (bank.reshape(640, -1).max(axis=1) == 1.0).all()  # no blank
    np.testing.assert_array_equal(bank, tsm.default_sprite_bank(32))
    assert not np.array_equal(bank, tsm.default_sprite_bank(32, seed=1))


@pytest.mark.parametrize("train,deterministic,size", [
    (True, False, 32), (False, False, 32), (True, True, 32),
    (True, False, 20)])
def test_clips_equal_jax(train, deterministic, size):
    kw = dict(train=train, num_past_frames=3, num_future_frames=9,
              image_size=size, digit_size=16, deterministic=deterministic)
    want = _jax_smmnist(**kw)
    got = tsm.StochasticMovingMNIST(sprites=SPRITES, **kw)
    assert len(got) == len(want) == len(SPRITES)
    for idx in (0, 5, 29):
        clip = got[idx]
        assert clip.shape == (12, size, size, 1) and clip.dtype == np.float32
        np.testing.assert_array_equal(clip, want[idx])
        np.testing.assert_array_equal(clip, got[idx])


@pytest.mark.parametrize("mode", ["rand_context", "pairs", "vfi"])
def test_batch_loader_equals_jax(mode):
    """Two epochs of shuffled batches: the same clips, splits and masks
    (the JAX loader over a subset, which takes its per-index path)."""
    from npvp_tpu.data.datasets import SubsetDataset
    from npvp_tpu.data.loader import BatchLoader

    kw = dict(train=True, num_past_frames=3, num_future_frames=5,
              image_size=32, digit_size=16)
    n = 11
    lkw = dict(shuffle=True, num_past=3, num_future=5, mode=mode, min_lo=2,
               max_lo=6, to_idx=[0, 1, 7], tp_idx=[2, 3, 4, 5, 6], seed=4)
    want = BatchLoader(SubsetDataset(_jax_smmnist(**kw), range(n)), 3,
                       num_workers=1, **lkw)
    got = tload.BatchLoader(tload.SubsetDataset(tsm.StochasticMovingMNIST(
        sprites=SPRITES, **kw), range(n)), 3, **lkw)
    assert len(got) == len(want) == 3
    for epoch in (0, 1):
        want.set_epoch(epoch)
        got.set_epoch(epoch)
        pairs = list(zip(got, want, strict=True))
        assert len(pairs) == 3
        for g, w in pairs:
            assert sorted(g) == sorted(w)
            for key in w:
                np.testing.assert_array_equal(g[key], w[key], err_msg=key)
    if mode == "rand_context":
        masks = [b["obs_mask"] for b in got]
        assert all(2 <= m.sum() <= 6 for m in masks)
        assert len({m.tobytes() for m in masks}) > 1


def test_data_module_equals_jax(monkeypatch):
    """``phase: deploy`` merges train and val, ``dev_set_size`` cuts both,
    and the loaders follow the JAX module's seeds."""
    from npvp_tpu.data import loader as jload

    real = jload.StochasticMovingMNIST

    def with_sprites(*a, **kw):
        ds = real(*a, **kw)
        ds.sprites, ds._length = SPRITES, len(SPRITES)
        return ds

    monkeypatch.setattr(jload, "StochasticMovingMNIST", with_sprites)
    cfg = tiny_config()
    d, p = cfg.Dataset, cfg.Predictor
    d.batch_size, d.dev_set_size, d.num_workers = 2, 6, 1
    d.img_size, p.rand_context, p.min_lo, p.max_lo = 32, True, 2, 6
    jdm = jload.DataModule(cfg.validate())
    tdm = tload.DataModule(port_config(cfg),
                           sprites={"train": SPRITES, "test": SPRITES})
    assert tdm.predictor_mode() == jdm.predictor_mode() == "rand_context"
    for split in ("train", "val"):
        w = getattr(jdm, f"{split}_loader")("rand_context")
        g = getattr(tdm, f"{split}_loader")("rand_context")
        for gb, wb in zip(g, w, strict=True):
            for key in wb:
                np.testing.assert_array_equal(gb[key], wb[key])
    assert tdm.len_train_loader == jdm.len_train_loader == 3
    assert len(tdm.dataset("train")) == 6
    d.dev_set_size = None
    full = tload.DataModule(port_config(cfg), sprites={"train": SPRITES})
    assert len(full.dataset("train")) == 2 * len(SPRITES)  # train + val


def test_transforms():
    from npvp_tpu.data.transforms import build_transforms as jbuild

    clip = np.linspace(-0.5, 1.5, 24, dtype=np.float32).reshape(2, 3, 4, 1)
    tf, renorm = build_transforms("SMMNIST", True)
    jtf, jrenorm = jbuild("SMMNIST", True)
    np.testing.assert_array_equal(tf(clip), jtf(clip, None))
    np.testing.assert_array_equal(renorm(clip), jrenorm(clip))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        build_transforms("KTH", True)
