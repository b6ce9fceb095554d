"""The port's C++ data library (``npvp_tpu_torch/data/native_bindings.py``):
its sprite stream is bit-equal to its numpy twin and to the JAX package's
build of the same source; its transform matches the port's CenterCrop,
Resize and Normalize; builds racing into one directory all load; a failed
build is reported once and leaves the library unavailable.

The port's library is built here with ``g++``; the tests that need it skip
only where it cannot be built, as ``tests/test_native.py`` does for the
JAX package's. The JAX package's library is loaded in the test's own
process through ``tests/_jax_native.py``, which builds it safely where
the test processes' racing ``make`` left this one without it."""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
from _jax_native import jax_native_available

from npvp_tpu_torch.data import native_bindings as nb
from npvp_tpu_torch.data.transforms import CenterCrop, Normalize, Resize

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture
def port_lib():
    if not nb.native_available():
        pytest.skip("the port's C++ data library cannot be built here")


def _sprites(n=7, size=16, seed=0):
    return np.random.default_rng(seed).random((n, size, size)).astype(
        np.float32)


# (deterministic, frames, image size, digits, sprites): the shipped SMMNIST
# geometry, and a smaller one with three digits and few sprites
STREAMS = [(False, 15, 64, 2, 32), (True, 15, 64, 2, 32),
           (False, 9, 40, 3, 12), (True, 9, 40, 3, 12)]


@pytest.mark.parametrize("deterministic,T,S,digits,D", STREAMS)
def test_stream_equals_numpy_twin(port_lib, deterministic, T, S, digits, D):
    sprites = _sprites(size=D)
    seeds = np.arange(16, dtype=np.uint64) * 2 + 1  # the test split's
    got = nb.synth_moving_sprites_batch(sprites, T, S, digits, deterministic,
                                        seeds, num_threads=3)
    want = nb.synth_moving_sprites_reference(sprites, T, S, digits,
                                             deterministic, seeds)
    assert got.shape == (16, T, S, S, 1) and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    assert got.max() == 1.0 and got.min() == 0.0  # overlaps clip at 1
    assert np.abs(np.diff(got, axis=1)).max() > 0  # the sprites move
    # large seeds wrap in uint64 as in C++
    big = np.array([2 ** 64 - 1, 2 ** 63 + 5], np.uint64)
    np.testing.assert_array_equal(
        nb.synth_moving_sprites_batch(sprites, T, S, digits, deterministic,
                                      big),
        nb.synth_moving_sprites_reference(sprites, T, S, digits,
                                          deterministic, big))


@pytest.mark.parametrize("deterministic,T,S,digits,D", STREAMS)
def test_stream_equals_jax(port_lib, deterministic, T, S, digits, D):
    from npvp_tpu.data import native_bindings as jnb

    if not jax_native_available():
        pytest.skip("the JAX package's C++ data library cannot be built "
                    "here")
    sprites = _sprites(size=D, seed=3)
    seeds = np.arange(16, dtype=np.uint64) * 2
    np.testing.assert_array_equal(
        nb.synth_moving_sprites_batch(sprites, T, S, digits, deterministic,
                                      seeds),
        jnb.synth_moving_sprites_batch(sprites, T, S, digits, deterministic,
                                       seeds))


def test_sprite_geometry_is_checked():
    with pytest.raises(ValueError, match="do not move"):
        nb.synth_moving_sprites_reference(_sprites(size=16), 4, 16, 2, False,
                                          np.zeros(1, np.uint64))
    with pytest.raises(ValueError, match="expected"):
        nb.synth_moving_sprites_reference(np.zeros((2, 4, 5), np.float32), 4,
                                          16, 2, False,
                                          np.zeros(1, np.uint64))


@pytest.mark.parametrize("crop,out", [((120, 120), (64, 64)), (None, (48, 80)),
                                      ((100, 140), (100, 140))])
def test_transform_matches_port_transforms(port_lib, crop, out):
    """Centre crop, bilinear resize (OpenCV's sampling) and normalise: the
    C++ path and the port's numpy transforms within 2e-6 (float32 weights
    computed from a float and from a double scale), flips exact."""
    rng = np.random.default_rng(0)
    clips = rng.random((3, 2, 120, 160, 1), np.float32)
    mean, std = 0.6013795, 2.7570653
    hflips, vflips = np.array([0, 1, 0]), np.array([0, 0, 1])
    got = nb.transform_batch(clips, crop, out, hflips, vflips, mean, std,
                             num_threads=2)
    assert got.shape == (3, 2, *out, 1)
    steps = ([CenterCrop(crop)] if crop else []) + [Resize(out),
                                                     Normalize(mean, std)]
    for n in range(3):
        want = clips[n]
        for step in steps:
            want = step(want)
        if hflips[n]:
            want = want[:, :, ::-1]
        if vflips[n]:
            want = want[:, ::-1]
        np.testing.assert_allclose(got[n], want, atol=2e-6, rtol=0)


def test_transform_equals_jax(port_lib):
    from npvp_tpu.data import native_bindings as jnb

    if not jax_native_available():
        pytest.skip("the JAX package's C++ data library cannot be built "
                    "here")
    clips = np.random.default_rng(1).random((2, 3, 30, 50, 3), np.float32)
    kw = dict(crop=(30, 30), out_size=(17, 17), hflips=np.array([1, 0]),
              vflips=np.array([1, 1]), mean=(0.1, 0.2, 0.3),
              std=(1.5, 2.0, 2.5))
    np.testing.assert_array_equal(nb.transform_batch(clips, **kw),
                                  jnb.transform_batch(clips, **kw))
    with pytest.raises(ValueError, match="flips"):
        nb.transform_batch(clips, **{**kw, "hflips": np.zeros(3)})


BUILD = """
import ctypes, sys
from pathlib import Path
from npvp_tpu_torch.data import native_bindings as nb
nb.BUILD_DIR = Path(sys.argv[1])
lib = ctypes.CDLL(str(nb.build()))
print(lib.synth_moving_sprites_batch is not None)
"""


def test_racing_builds_all_load(tmp_path):
    """Four processes build into one empty directory at once: each loads a
    whole library, and one file is left, named by the source's hash."""
    procs = [subprocess.Popen([sys.executable, "-c", BUILD, str(tmp_path)],
                              cwd=ROOT, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for _ in range(4)]
    outs = [p.communicate(timeout=300) for p in procs]
    if any("g++ not found" in err for _, err in outs):
        pytest.skip("no g++")
    assert [p.returncode for p in procs] == [0] * 4, outs
    assert all(out.strip() == "True" for out, _ in outs)
    assert [f.name for f in tmp_path.iterdir()] == [
        nb.build().name]  # no temporary file left behind


def test_failed_build_is_reported_once(tmp_path, monkeypatch):
    monkeypatch.setattr(nb, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(nb, "compiler", lambda: "/bin/false")
    monkeypatch.setattr(nb, "_state", {"lib": None, "error": None})
    with pytest.warns(RuntimeWarning, match="unavailable") as caught:
        assert not nb.native_available()
        assert not nb.native_available()
        assert nb.synth_moving_sprites_batch(_sprites(), 4, 32, 2, False,
                                             np.zeros(2, np.uint64)) is None
        assert nb.transform_batch(np.zeros((1, 1, 4, 4, 1)), None, (4, 4),
                                  [0], [0], 0.0, 1.0) is None
    assert len(caught) == 1 and "/bin/false failed" in str(caught[0].message)
    assert list(tmp_path.iterdir()) == []  # the temporary file is removed


def test_jax_library_recovers_from_a_lost_make_race(tmp_path, monkeypatch):
    """A process whose first load of the JAX package's library failed (a
    partial file, as a racing ``make`` leaves one) gets it through
    ``tests/_jax_native.py``: rebuilt into place through a temporary file,
    loaded, and nothing else left in the directory."""
    import shutil

    from npvp_tpu.data import native_bindings as jnb

    native = Path(jnb.__file__).parent / "native"
    for name in ("Makefile", "npvp_data.cpp"):
        shutil.copy(native / name, tmp_path / name)
    lib = tmp_path / "libnpvp_data.so"
    lib.write_bytes(b"\x7fELF" + bytes(60))  # a build cut short
    monkeypatch.setattr(jnb, "_NATIVE_DIR", tmp_path)
    monkeypatch.setattr(jnb, "_LIB_PATH", lib)
    monkeypatch.setattr(jnb, "_lib", None)
    monkeypatch.setattr(jnb, "_tried", False)
    assert not jnb.native_available()  # the lost race
    if shutil.which("g++") is None:
        pytest.skip("no g++")
    assert jax_native_available()
    assert jnb.native_available() and jnb._lib._name == str(lib)
    assert sorted(f.name for f in tmp_path.iterdir()) == [
        "Makefile", "libnpvp_data.so", "npvp_data.cpp"]
    sprites = _sprites(size=16, seed=4)
    seeds = np.arange(4, dtype=np.uint64)
    np.testing.assert_array_equal(
        jnb.synth_moving_sprites_batch(sprites, 6, 32, 2, False, seeds),
        nb.synth_moving_sprites_reference(sprites, 6, 32, 2, False, seeds))
