"""The port's preprocessing tools (``npvp_tpu_torch/tools/preprocessing.py``)
against the JAX package's on synthetic frames written by PIL: subsampling,
the empty-frame filter and zip extraction give the same files; the
Cityscapes crop and resize the same pixels within one grey level (OpenCV
resizes uint8 in fixed point, the port in float32 and rounds); the BAIR
tfrecord conversion the same frames; ffmpeg and tensorflow are named when
missing."""

import shutil
import sys
import zipfile

import numpy as np
import pytest
from PIL import Image

from npvp_tpu.tools import preprocessing as jpp

from npvp_tpu_torch.data.png import read_png
from npvp_tpu_torch.tools import preprocessing as tpp


def _write_frames(d, arrs):
    d.mkdir(parents=True, exist_ok=True)
    for i, a in enumerate(arrs):
        Image.fromarray(a).save(d / f"{i:04d}.png")


def _tree(root):
    return sorted(str(p.relative_to(root)) for p in root.rglob("*"))


def test_subsample_frames(tmp_path):
    _write_frames(tmp_path / "src", [np.full((4, 4), i, np.uint8)
                                     for i in range(10)])
    for pkg, out in ((tpp, "got"), (jpp, "want")):
        assert pkg.subsample_frames(tmp_path / "src", tmp_path / out, 3) == 4
    assert _tree(tmp_path / "got") == _tree(tmp_path / "want") == [
        "0000.png", "0003.png", "0006.png", "0009.png"]


@pytest.mark.parametrize("colour", [False, True])
def test_remove_empty_frames_equals_jax(tmp_path, colour):
    """A bright block crosses a noisy background in frames 4-7; a faint
    flicker in frame 9 sits near the threshold. Grey and RGB frames (PIL's
    luma on both sides)."""
    rng = np.random.default_rng(colour)
    shape = (32, 32, 3) if colour else (32, 32)
    bg = rng.integers(0, 30, shape, np.uint8)
    arrs = []
    for i in range(12):
        f = bg.copy()
        if 4 <= i < 8:
            f[8:24, 2 + 6 * (i - 4): 10 + 6 * (i - 4)] = (
                [220, 40, 90] if colour else 220)
        if i == 9:
            f[:12, :12] = np.minimum(f[:12, :12].astype(int) + 12, 255)
        arrs.append(f)
    _write_frames(tmp_path / "src", arrs)
    for threshold in (1.5, 1.6, 2.0):
        got = tpp.remove_empty_frames(tmp_path / "src",
                                      tmp_path / f"got{threshold}", threshold)
        want = jpp.remove_empty_frames(tmp_path / "src",
                                       tmp_path / f"want{threshold}",
                                       threshold)
        assert got == want
        assert _tree(tmp_path / f"got{threshold}") == _tree(
            tmp_path / f"want{threshold}")
    assert tpp.remove_empty_frames(tmp_path / "none", tmp_path / "x") == 0


@pytest.mark.parametrize("h,w,size", [(64, 128, 32), (61, 100, 37),
                                      (97, 61, 50), (40, 80, 64),
                                      (256, 512, 128)])
def test_crop_resize_within_one_level_of_opencv(h, w, size):
    cv2 = pytest.importorskip("cv2")
    rng = np.random.default_rng(h)
    img = rng.integers(0, 256, (h, w, 3), np.uint8)
    s = min(h, w)
    y0, x0 = (h - s) // 2, (w - s) // 2
    want = cv2.resize(img[y0:y0 + s, x0:x0 + s], (size, size),
                      interpolation=cv2.INTER_LINEAR)
    got = tpp.crop_resize(img, size)
    assert got.shape == want.shape and got.dtype == np.uint8
    assert np.abs(got.astype(int) - want).max() <= 1


def test_cityscapes_crop_resize_equals_jax(tmp_path):
    """RGB, grey and RGBA frames in a city/sequence layout: the same files,
    each decoded RGB within one level of the JAX package's (OpenCV reads
    BGR and writes BGR, so its PNGs are RGB on disk as the port's)."""
    pytest.importorskip("cv2")
    rng = np.random.default_rng(0)
    _write_frames(tmp_path / "in" / "aachen", [
        rng.integers(0, 256, (64, 128, 3), np.uint8) for _ in range(2)])
    _write_frames(tmp_path / "in" / "bonn", [
        rng.integers(0, 256, (48, 40), np.uint8),
        rng.integers(0, 256, (50, 90, 4), np.uint8)])
    assert tpp.cityscapes_crop_resize(tmp_path / "in", tmp_path / "got",
                                      size=32) == 4
    assert jpp.cityscapes_crop_resize(tmp_path / "in", tmp_path / "want",
                                      size=32) == 4
    assert _tree(tmp_path / "got") == _tree(tmp_path / "want")
    for f in sorted((tmp_path / "want").rglob("*.png")):
        want = np.asarray(Image.open(f).convert("RGB"))
        got = read_png(tmp_path / "got" / f.relative_to(tmp_path / "want"))
        assert got.shape == want.shape == (32, 32, 3)
        assert np.abs(got.astype(int) - want).max() <= 1


def test_extract_zip_and_cli(tmp_path):
    src = tmp_path / "src"
    _write_frames(src / "a", [np.zeros((2, 2), np.uint8)] * 3)
    with zipfile.ZipFile(tmp_path / "f.zip", "w") as z:
        for p in sorted(src.rglob("*.png")):
            z.write(p, p.relative_to(src))
    tpp.main(["unzip", str(tmp_path / "f.zip"), str(tmp_path / "got")])
    jpp.extract_zip(tmp_path / "f.zip", tmp_path / "want")
    assert _tree(tmp_path / "got") == _tree(tmp_path / "want") == [
        "a", "a/0000.png", "a/0001.png", "a/0002.png"]
    tpp.main(["subsample", str(src / "a"), str(tmp_path / "sub"),
              "--keep_every", "2"])
    assert _tree(tmp_path / "sub") == ["0000.png", "0002.png"]


def test_ffmpeg_is_named_when_missing(tmp_path, monkeypatch):
    monkeypatch.setattr(shutil, "which", lambda name: None)
    assert not tpp.has_ffmpeg() and not jpp.has_ffmpeg()
    for call in (lambda pkg: pkg.video_to_frames(tmp_path / "v.mp4",
                                                 tmp_path / "f"),
                 lambda pkg: pkg.frames_to_video(tmp_path, tmp_path / "o")):
        for pkg in (tpp, jpp):
            with pytest.raises(RuntimeError, match="ffmpeg not found"):
                call(pkg)


def test_bair_without_tensorflow(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "tensorflow", None)
    with pytest.raises(RuntimeError, match="needs the tensorflow package"):
        tpp.convert_bair_tfrecords(tmp_path, tmp_path / "out")


def test_bair_tfrecords_equal_jax(tmp_path):
    tf = pytest.importorskip("tensorflow")
    rng = np.random.default_rng(0)
    frames = rng.integers(0, 256, (2, 3, 8, 8, 3), np.uint8)
    with tf.io.TFRecordWriter(str(tmp_path / "a.tfrecord")) as w:
        for ex in frames:
            feature = {f"{t}/image_aux1/encoded": tf.train.Feature(
                bytes_list=tf.train.BytesList(value=[f.tobytes()]))
                for t, f in enumerate(ex)}
            feature["0/action"] = tf.train.Feature(
                float_list=tf.train.FloatList(value=[0.0]))
            w.write(tf.train.Example(features=tf.train.Features(
                feature=feature)).SerializeToString())
    assert tpp.convert_bair_tfrecords(tmp_path, tmp_path / "got", 8) == 2
    assert jpp.convert_bair_tfrecords(tmp_path, tmp_path / "want", 8) == 2
    assert _tree(tmp_path / "got") == _tree(tmp_path / "want")
    for e in range(2):
        for t in range(3):
            name = f"example_{e:06d}/{t:03d}.png"
            got = read_png(tmp_path / "got" / name)
            np.testing.assert_array_equal(got, frames[e, t])
            np.testing.assert_array_equal(
                got, np.asarray(Image.open(tmp_path / "want" / name)))
