"""Offline dataset preprocessing (port of ``npvp_tpu/tools/preprocessing.py``).

Video ↔ frames through ffmpeg, frame subsampling, the motion-energy filter
that drops KTH frames with nobody in view, the Cityscapes square crop and
resize, zip extraction and the BAIR tfrecord conversion. Frames are read
and written by the port's PNG codec (``data/png.py``) and resized by its
bilinear resize (``data/transforms.py``), so no image library is needed;
the readers take PNG files only.

    python -m npvp_tpu_torch.tools.preprocessing <command> ...
"""

from __future__ import annotations

import argparse
import shutil
import subprocess
import sys
import zipfile
from pathlib import Path

import numpy as np

from npvp_tpu_torch.data.png import read_png, write_png
from npvp_tpu_torch.data.transforms import Resize


def has_ffmpeg() -> bool:
    return shutil.which("ffmpeg") is not None


def video_to_frames(video_path: str | Path, out_dir: str | Path,
                    fps: float | None = None, quality: int = 2) -> int:
    """Extract a video's frames as ``%05d.png``; returns their count."""
    if not has_ffmpeg():
        raise RuntimeError("ffmpeg not found on PATH")
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    cmd = ["ffmpeg", "-y", "-i", str(video_path)]
    if fps:
        cmd += ["-vf", f"fps={fps}"]
    cmd += ["-q:v", str(quality), str(out_dir / "%05d.png")]
    subprocess.run(cmd, check=True, capture_output=True)
    return len(list(out_dir.glob("*.png")))


def frames_to_video(frames_dir: str | Path, out_path: str | Path,
                    fps: float = 25.0) -> None:
    """Assemble ``%05d.png`` frames into a video."""
    if not has_ffmpeg():
        raise RuntimeError("ffmpeg not found on PATH")
    subprocess.run(["ffmpeg", "-y", "-framerate", str(fps), "-i",
                    str(Path(frames_dir) / "%05d.png"), "-pix_fmt", "yuv420p",
                    str(out_path)], check=True, capture_output=True)


def subsample_frames(frames_dir: str | Path, out_dir: str | Path,
                     keep_every: int) -> int:
    """Copy every ``keep_every``-th file (in name order); returns the count
    kept."""
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    kept = 0
    for i, f in enumerate(sorted(Path(frames_dir).glob("*"))):
        if i % keep_every == 0:
            shutil.copy(f, out_dir / f.name)
            kept += 1
    return kept


def remove_empty_frames(frames_dir: str | Path, out_dir: str | Path,
                        energy_threshold: float = 1.5) -> int:
    """Copy the frames whose mean absolute difference to the clip's median
    frame, in grey levels (PIL's RGB → L), exceeds ``energy_threshold``:
    the frames in which someone moves. Returns the count kept."""
    files = sorted(Path(frames_dir).glob("*"))
    if not files:
        return 0
    frames = np.stack([read_png(f, "L").astype(np.float32) for f in files])
    median = np.median(frames, axis=0)
    energy = np.abs(frames - median).mean(axis=(1, 2))
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    kept = 0
    for f, e in zip(files, energy):
        if e > energy_threshold:
            shutil.copy(f, out_dir / f.name)
            kept += 1
    return kept


def crop_resize(img: np.ndarray, size: int) -> np.ndarray:
    """(H, W, 3) uint8 → its centred square, resized to (size, size, 3)
    uint8 by bilinear interpolation with OpenCV's sampling, rounded to the
    nearest level. OpenCV's uint8 resize interpolates in fixed point, so
    a pixel may be one level from its result."""
    h, w = img.shape[:2]
    s = min(h, w)
    y0, x0 = (h - s) // 2, (w - s) // 2
    square = img[None, y0:y0 + s, x0:x0 + s].astype(np.float32)
    out = Resize((size, size))(square)[0]
    return np.clip(np.rint(out), 0, 255).astype(np.uint8)


def cityscapes_crop_resize(in_dir: str | Path, out_dir: str | Path,
                           size: int = 128) -> int:
    """Every PNG under ``in_dir`` as RGB, centre-cropped square and resized
    (:func:`crop_resize`), to the same relative path under ``out_dir``;
    returns the count."""
    in_dir, out_dir = Path(in_dir), Path(out_dir)
    count = 0
    for f in sorted(in_dir.rglob("*.png")):
        dst = out_dir / f.relative_to(in_dir)
        dst.parent.mkdir(parents=True, exist_ok=True)
        write_png(dst, crop_resize(read_png(f, "RGB"), size))
        count += 1
    return count


def extract_zip(zip_path: str | Path, out_dir: str | Path) -> None:
    with zipfile.ZipFile(zip_path) as z:
        z.extractall(out_dir)


def convert_bair_tfrecords(tfrecord_dir: str | Path, out_dir: str | Path,
                           image_size: int = 64) -> int:
    """BAIR robot-push tfrecords → ``example_%06d/%03d.png`` frame folders
    of the ``image_aux1`` camera; returns the count of examples. Reading
    tfrecords needs the tensorflow package."""
    try:
        import tensorflow as tf
    except ImportError as e:
        raise RuntimeError(
            "convert_bair_tfrecords reads TensorFlow records and needs the "
            f"tensorflow package, which is not installed ({e})") from None

    out_dir = Path(out_dir)
    example_idx = 0
    for tfr in sorted(Path(tfrecord_dir).glob("*.tfrecord*")):
        for record in tf.data.TFRecordDataset(str(tfr)):
            ex = tf.train.Example()
            ex.ParseFromString(record.numpy())
            feats = ex.features.feature
            frame_keys = sorted(
                (k for k in feats if "image_aux1/encoded" in k),
                key=lambda k: int(k.split("/")[0]))
            if not frame_keys:
                continue
            ex_dir = out_dir / f"example_{example_idx:06d}"
            ex_dir.mkdir(parents=True, exist_ok=True)
            for t, key in enumerate(frame_keys):
                raw = feats[key].bytes_list.value[0]
                write_png(ex_dir / f"{t:03d}.png", np.frombuffer(
                    raw, np.uint8).reshape(image_size, image_size, 3))
            example_idx += 1
    return example_idx


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    sub = parser.add_subparsers(dest="cmd", required=True)
    p = sub.add_parser("video2frames")
    p.add_argument("video"), p.add_argument("out"), p.add_argument(
        "--fps", type=float)
    p = sub.add_parser("frames2video")
    p.add_argument("frames"), p.add_argument("out"), p.add_argument(
        "--fps", type=float, default=25)
    p = sub.add_parser("subsample")
    p.add_argument("frames"), p.add_argument("out"), p.add_argument(
        "--keep_every", type=int, required=True)
    p = sub.add_parser("remove_empty")
    p.add_argument("frames"), p.add_argument("out"), p.add_argument(
        "--threshold", type=float, default=1.5)
    p = sub.add_parser("cityscapes")
    p.add_argument("indir"), p.add_argument("out"), p.add_argument(
        "--size", type=int, default=128)
    p = sub.add_parser("bair")
    p.add_argument("tfrecords"), p.add_argument("out")
    p = sub.add_parser("unzip")
    p.add_argument("zip"), p.add_argument("out")

    args = parser.parse_args(argv)
    if args.cmd == "video2frames":
        print(video_to_frames(args.video, args.out, args.fps))
    elif args.cmd == "frames2video":
        frames_to_video(args.frames, args.out, args.fps)
    elif args.cmd == "subsample":
        print(subsample_frames(args.frames, args.out, args.keep_every))
    elif args.cmd == "remove_empty":
        print(remove_empty_frames(args.frames, args.out, args.threshold))
    elif args.cmd == "cityscapes":
        print(cityscapes_crop_resize(args.indir, args.out, args.size))
    elif args.cmd == "bair":
        print(convert_bair_tfrecords(args.tfrecords, args.out))
    elif args.cmd == "unzip":
        extract_zip(args.zip, args.out)


if __name__ == "__main__":
    main(sys.argv[1:])
