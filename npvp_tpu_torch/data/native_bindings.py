"""ctypes bindings to the C++ data library (port of
``npvp_tpu/data/native_bindings.py``).

``native/npvp_data.cpp`` is a copy of the JAX package's source: the fused
clip transform (centre crop → bilinear resize → flips → normalise) and the
stochastic moving-sprites renderer, which draws from a splitmix64 stream
seeded per clip, both threaded over a batch. :func:`build` compiles it with
the host's ``g++`` and the JAX package's flags into ``native/_build/``,
named by the hash of the source and the flags, through a temporary file
and an atomic rename, so processes building at once never load a
half-written library.

As in the JAX package, the library is built at first use, and an entry
point returns None when it cannot be built or loaded: the SMMNIST dataset
then renders clip by clip from its own per-index stream
(``data/smmnist.py``). A failed build is reported once, with the
compiler's output. :func:`synth_moving_sprites_reference` is the stream
in numpy, the oracle of the C++ build in the tests and on the card; no
data path uses it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
import warnings
from pathlib import Path
from typing import Optional

import numpy as np

NATIVE_DIR = Path(__file__).resolve().parent / "native"
SOURCE = NATIVE_DIR / "npvp_data.cpp"
BUILD_DIR = NATIVE_DIR / "_build"
# npvp_tpu/data/native/Makefile's flags: the same float sums and clip
CXX_FLAGS = ["-O3", "-fPIC", "-shared", "-std=c++17", "-pthread", "-Wall"]

# what the last build of this process did (compiler, seconds, library)
BUILD_INFO = {}
_state = {"lib": None, "error": None}


def compiler() -> str:
    found = shutil.which("g++")
    if found is None:
        raise RuntimeError("g++ not found: the C++ data library cannot be "
                           "built")
    return found


def build() -> Path:
    """Compile the library unless this source and these flags were built
    already, and return its path; raises with the compiler's output."""
    tag = hashlib.sha256(SOURCE.read_bytes()
                         + " ".join(CXX_FLAGS).encode()).hexdigest()[:16]
    out = BUILD_DIR / f"libnpvp_data_{tag}.so"
    if out.exists():
        BUILD_INFO.setdefault("library", str(out))
        return out
    cxx = compiler()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    t0 = time.perf_counter()
    try:
        proc = subprocess.run([cxx, *CXX_FLAGS, str(SOURCE), "-o", tmp],
                              capture_output=True, text=True, timeout=300)
        if proc.returncode != 0:
            raise RuntimeError(f"{cxx} failed ({proc.returncode}):\n"
                               f"{proc.stdout}\n{proc.stderr}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    version = subprocess.run([cxx, "--version"], capture_output=True,
                             text=True).stdout.splitlines()
    BUILD_INFO.update(library=str(out), seconds=time.perf_counter() - t0,
                      compiler=version[0] if version else cxx)
    return out


def _load() -> Optional[ctypes.CDLL]:
    """The loaded library, or None once a build or load has failed (the
    failure is warned about once, and not retried in this process)."""
    if _state["lib"] is not None or _state["error"] is not None:
        return _state["lib"]
    try:
        lib = ctypes.CDLL(str(build()))
    except (RuntimeError, OSError, subprocess.SubprocessError) as e:
        _state["error"] = str(e)
        warnings.warn(f"the C++ data library is unavailable; SMMNIST "
                      f"renders clip by clip: {e}", RuntimeWarning,
                      stacklevel=3)
        return None
    f32p = ctypes.POINTER(ctypes.c_float)
    i32p = ctypes.POINTER(ctypes.c_int)
    u64p = ctypes.POINTER(ctypes.c_uint64)
    i32 = ctypes.c_int
    lib.transform_batch.argtypes = [
        f32p, i32, i32, i32, i32, i32, f32p, i32, i32, i32, i32, i32p, i32p,
        f32p, f32p, i32]
    lib.transform_batch.restype = None
    lib.synth_moving_sprites_batch.argtypes = [
        f32p, i32, i32, f32p, i32, i32, i32, i32, i32, u64p, i32]
    lib.synth_moving_sprites_batch.restype = None
    _state["lib"] = lib
    return lib


def native_available() -> bool:
    return _load() is not None


def _fp(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def transform_batch(clips: np.ndarray, crop: Optional[tuple],
                    out_size: tuple, hflips: np.ndarray, vflips: np.ndarray,
                    mean, std, num_threads: int = 4) -> Optional[np.ndarray]:
    """Centre crop → bilinear resize → flips → normalise over a (N, T, H,
    W, C) batch; None when the library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    clips = np.ascontiguousarray(clips, np.float32)
    N, T, H, W, C = clips.shape
    outH, outW = out_size
    cropH, cropW = crop if crop else (0, 0)
    if cropH > H or cropW > W:
        raise ValueError(f"crop {crop} exceeds the frames' {H}×{W}")
    hf = np.ascontiguousarray(hflips, np.int32)
    vf = np.ascontiguousarray(vflips, np.int32)
    if hf.shape != (N,) or vf.shape != (N,):
        raise ValueError(f"flips {hf.shape}, {vf.shape} for {N} clips")
    mean = np.broadcast_to(np.asarray(mean, np.float32), (C,)).copy()
    std = np.broadcast_to(np.asarray(std, np.float32), (C,)).copy()
    out = np.empty((N, T, outH, outW, C), np.float32)
    lib.transform_batch(
        _fp(clips), N, T, H, W, C, _fp(out), cropH, cropW, outH, outW,
        hf.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
        vf.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
        _fp(mean), _fp(std), num_threads)
    return out


def _check_sprites(sprites: np.ndarray, image_size: int) -> None:
    if sprites.ndim != 3 or sprites.shape[1] != sprites.shape[2]:
        raise ValueError(f"sprites {sprites.shape}: expected (n, D, D)")
    if not 0 < sprites.shape[1] < image_size:
        raise ValueError(f"sprites of {sprites.shape[1]} do not move in "
                         f"frames of {image_size}")


def synth_moving_sprites_batch(sprites: np.ndarray, seq_len: int,
                               image_size: int, num_digits: int,
                               deterministic: bool, seeds: np.ndarray,
                               num_threads: int = 4) -> Optional[np.ndarray]:
    """N = len(seeds) bouncing-sprite clips (N, T, S, S, 1) in [0, 1],
    clip n drawn from splitmix64 seeded with ``seeds[n]``; None when the
    library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    sprites = np.ascontiguousarray(sprites, np.float32)
    _check_sprites(sprites, image_size)
    num_sprites, D, _ = sprites.shape
    seeds = np.ascontiguousarray(seeds, np.uint64)
    N = seeds.shape[0]
    out = np.empty((N, seq_len, image_size, image_size, 1), np.float32)
    lib.synth_moving_sprites_batch(
        _fp(sprites), num_sprites, D, _fp(out), N, seq_len, image_size,
        num_digits, int(deterministic),
        seeds.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)), num_threads)
    return out


_GOLDEN = np.uint64(0x9E3779B97F4A7C15)
_MIX1 = np.uint64(0xBF58476D1CE4E5B9)
_MIX2 = np.uint64(0x94D049BB133111EB)


class _SplitMix64:
    """One splitmix64 stream per clip, in lockstep: a draw advances only
    the clips that ``where`` selects (uint64 arrays wrap as C++ does)."""

    def __init__(self, seeds: np.ndarray):
        self.s = np.asarray(seeds, np.uint64) + _GOLDEN

    def randint(self, lo: int, hi: int, where=True) -> np.ndarray:
        """``lo + next() % (hi − lo)`` where selected (else ``lo``)."""
        self.s = np.where(where, self.s + _GOLDEN, self.s)
        z = (self.s ^ (self.s >> np.uint64(30))) * _MIX1
        z = (z ^ (z >> np.uint64(27))) * _MIX2
        z = z ^ (z >> np.uint64(31))
        return lo + (z % np.uint64(hi - lo)).astype(np.int64)


def synth_moving_sprites_reference(sprites: np.ndarray, seq_len: int,
                                   image_size: int, num_digits: int,
                                   deterministic: bool, seeds: np.ndarray
                                   ) -> np.ndarray:
    """:func:`synth_moving_sprites_batch` in numpy: the same draws in the
    same order, the same float32 sums and clip, so the two are
    bit-equal."""
    sprites = np.asarray(sprites, np.float32)
    _check_sprites(sprites, image_size)
    S, D = image_size, sprites.shape[1]
    lim = S - D
    N = len(seeds)
    out = np.zeros((N, seq_len, S, S, 1), np.float32)
    rng = _SplitMix64(seeds)
    for _ in range(num_digits):
        k = rng.randint(0, len(sprites))
        sx, sy = rng.randint(0, lim), rng.randint(0, lim)
        dx, dy = rng.randint(-4, 5), rng.randint(-4, 5)
        for t in range(seq_len):
            # rows first, then columns; each wall resamples (or reflects)
            # its normal velocity first and the tangential one second
            for pos, normal, other in ((sy, "dy", "dx"), (sx, "dx", "dy")):
                vel = {"dx": dx, "dy": dy}
                low, high = pos < 0, pos >= lim
                pos[low], pos[high] = 0, lim - 1
                if deterministic:
                    vel[normal] = np.where(low | high, -vel[normal],
                                           vel[normal])
                else:
                    for hit, lo, hi in ((low, 1, 5), (high, -4, 0)):
                        n_new = rng.randint(lo, hi, hit)
                        o_new = rng.randint(-4, 5, hit)
                        vel[normal] = np.where(hit, n_new, vel[normal])
                        vel[other] = np.where(hit, o_new, vel[other])
                dx, dy = vel["dx"], vel["dy"]
            for n in range(N):
                out[n, t, sy[n]:sy[n] + D, sx[n]:sx[n] + D, 0] += sprites[k[n]]
            sy, sx = sy + dy, sx + dx
    return np.minimum(out, np.float32(1.0))
