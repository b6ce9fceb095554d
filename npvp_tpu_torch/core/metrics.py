"""Metric aggregation and logging (port of ``npvp_tpu/core/metrics.py``):
running means that read device scalars only when asked, a JSON-lines scalar
log (the card's machine has no TensorBoard), and GT|prediction GIF strips
through a small GIF89a writer in numpy (it has no Pillow either)."""

from __future__ import annotations

import json
import time
from collections import defaultdict
from pathlib import Path
from typing import Dict

import numpy as np


class AverageMeters:
    """Running means keyed by name. Values may be 0-d tensors on the card;
    they are read back only in :meth:`averages`, so the training loop does
    not wait for the device at every step."""

    def __init__(self):
        self._values: Dict[str, list] = defaultdict(list)

    def update(self, metrics: Dict[str, object]) -> None:
        for k, v in metrics.items():
            self._values[k].append(v.detach() if hasattr(v, "detach") else v)

    def averages(self) -> Dict[str, float]:
        return {k: sum(float(x) for x in v) / len(v)
                for k, v in self._values.items()}


class MetricsLogger:
    """Appends one JSON object per call to ``<log_dir>/metrics.jsonl``."""

    def __init__(self, log_dir):
        self.log_dir = Path(log_dir)
        self.log_dir.mkdir(parents=True, exist_ok=True)
        self._file = open(self.log_dir / "metrics.jsonl", "a")

    def log_scalars(self, step: int, metrics: Dict[str, float]) -> None:
        record = {"step": int(step), "time": time.time(),
                  **{k: float(v) for k, v in metrics.items()}}
        self._file.write(json.dumps(record) + "\n")
        self._file.flush()

    def close(self) -> None:
        self._file.close()


# -- animated GIFs without an image library ----------------------------------

def _gif_palette_rgb332() -> np.ndarray:
    """(256, 3) uint8: index ``rrrgggbb`` → its colour, levels spread over
    0..255."""
    i = np.arange(256)
    return np.stack([(i >> 5) * 255 // 7, ((i >> 2) & 7) * 255 // 7,
                     (i & 3) * 255 // 3], axis=1).astype(np.uint8)


def gif_quantise(frames: np.ndarray):
    """(T, H, W, C) uint8 frames, C = 1 or 3 → (indices (T, H, W) uint8,
    palette (256, 3) uint8): one channel keeps its 256 grey levels; RGB
    maps onto the fixed 3-3-2 palette."""
    if frames.shape[-1] == 1:
        grey = np.arange(256, dtype=np.uint8)
        return frames[..., 0], np.stack([grey] * 3, axis=1)
    r, g, b = (frames[..., k].astype(np.uint16) for k in range(3))
    idx = ((r >> 5) << 5) | ((g >> 5) << 2) | (b >> 6)
    return idx.astype(np.uint8), _gif_palette_rgb332()


def _lzw_encode(indices: np.ndarray) -> bytes:
    """GIF's variable-width LZW (8-bit symbols, codes of up to 12 bits,
    least significant bit first), packed into sub-blocks of ≤ 255 bytes."""
    clear, end = 256, 257
    out = bytearray()
    acc = nbits = 0

    def emit(code, width):
        nonlocal acc, nbits
        acc |= code << nbits
        nbits += width
        while nbits >= 8:
            out.append(acc & 0xFF)
            acc >>= 8
            nbits -= 8

    table, next_code, width = {}, 258, 9
    emit(clear, width)
    data = indices.reshape(-1).tolist()
    prefix = data[0]
    for sym in data[1:]:
        key = (prefix, sym)
        code = table.get(key)
        if code is not None:
            prefix = code
            continue
        emit(prefix, width)
        if next_code < 4096:
            table[key] = next_code
            # the decoder widens its codes once the table reaches 2^width
            if next_code == (1 << width) and width < 12:
                width += 1
            next_code += 1
        else:
            emit(clear, width)
            table, next_code, width = {}, 258, 9
        prefix = sym
    emit(prefix, width)
    emit(end, width)
    if nbits:
        out.append(acc & 0xFF)
    blocks = bytearray()
    for i in range(0, len(out), 255):
        chunk = out[i:i + 255]
        blocks += bytes([len(chunk)]) + chunk
    return bytes(blocks) + b"\x00"


def write_gif(path, frames: np.ndarray, duration_ms: int = 125) -> None:
    """Write (T, H, W, C) uint8 frames (C = 1 or 3) as an animated GIF89a
    that loops forever, each frame shown ``duration_ms`` (GIF counts
    hundredths of a second)."""
    import struct

    T, H, W, _ = frames.shape
    indices, palette = gif_quantise(frames)
    head = bytearray(b"GIF89a")
    head += struct.pack("<HHBBB", W, H, 0xF7, 0, 0)  # 256-entry global table
    head += palette.tobytes()
    head += b"\x21\xFF\x0BNETSCAPE2.0\x03\x01\x00\x00\x00"  # loop 0
    delay = int(duration_ms) // 10
    body = bytearray()
    for t in range(T):
        body += b"\x21\xF9\x04\x00" + struct.pack("<H", delay) + b"\x00\x00"
        body += b"\x2C" + struct.pack("<HHHHB", 0, 0, W, H, 0)
        body += b"\x08" + _lzw_encode(indices[t])
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    Path(path).write_bytes(bytes(head + body) + b"\x3B")


def gif_frame_count(path) -> int:
    """Frames of a GIF89a file, found by walking its blocks; raises
    ``ValueError`` on a file that is not one."""
    data = Path(path).read_bytes()
    if data[:6] != b"GIF89a" or len(data) < 13:
        raise ValueError(f"{path} is not a GIF89a file")
    pos, flags = 13, data[10]
    if flags & 0x80:
        pos += 3 << ((flags & 7) + 1)

    def skip_blocks(pos):
        while data[pos]:
            pos += data[pos] + 1
        return pos + 1

    frames = 0
    while pos < len(data):
        tag = data[pos]
        if tag == 0x3B:
            return frames
        if tag == 0x21:
            pos = skip_blocks(pos + 2)
        elif tag == 0x2C:
            local = data[pos + 9]
            pos += 10
            if local & 0x80:
                pos += 3 << ((local & 7) + 1)
            pos = skip_blocks(pos + 1)
            frames += 1
        else:
            raise ValueError(f"{path}: unexpected block 0x{tag:02x}")
    raise ValueError(f"{path}: no trailer")


def save_clip_gifs(path, clips: Dict[str, np.ndarray], renorm=None,
                   duration_ms: int = 125) -> None:
    """Side-by-side animated GIF of named clips, each (T, H, W, C) float:
    ``renorm`` (model range → [0, 1]) if given, clipped to [0, 1], shorter
    clips padded by repeating their last frame, strips joined on the width,
    then ×255 truncated to uint8 (port of ``npvp_tpu/core/metrics.py``'s
    writer, without Pillow)."""
    arrays = []
    max_T = max(c.shape[0] for c in clips.values())
    for clip in clips.values():
        clip = np.asarray(clip, np.float32)
        if renorm is not None:
            clip = renorm(clip)
        clip = np.clip(clip, 0.0, 1.0)
        if clip.shape[0] < max_T:
            pad = np.repeat(clip[-1:], max_T - clip.shape[0], axis=0)
            clip = np.concatenate([clip, pad], axis=0)
        arrays.append(clip)
    strip = np.concatenate(arrays, axis=2)
    write_gif(path, (strip * 255).astype(np.uint8), duration_ms)
