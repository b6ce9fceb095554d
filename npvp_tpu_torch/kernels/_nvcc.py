"""Building a kernel's CUDA source with ``nvcc`` into a shared library with a
plain C interface, loaded with ``ctypes`` by its wrapper."""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

from npvp_tpu_torch.core.device import BUILD_DIR

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


def nvcc_path() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found: the port's CUDA kernels cannot "
                           "be built")
    return found


def build(source: Path, stem: str, info: dict,
          flags=tuple(NVCC_FLAGS)) -> Path:
    """Compile ``source`` into ``kernels/_build/<stem>_<hash>.so`` (named by
    the source's and the flags' hash, so an edited source builds anew;
    written through a temporary file and a rename, so that processes
    building at once are safe) and return its path. ``info`` records the
    build time and ptxas' register report."""
    src = source.read_bytes()
    tag = hashlib.sha256(src + " ".join(flags).encode()).hexdigest()[:16]
    out = BUILD_DIR / f"{stem}_{tag}.so"
    if out.exists():
        info.setdefault("library", str(out))
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    t0 = time.perf_counter()
    proc = subprocess.run([nvcc_path(), *flags, "-o", tmp, str(source)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, out)
    info.update(library=str(out), seconds=time.perf_counter() - t0,
                ptxas=[line.strip() for line in proc.stderr.splitlines()
                       if any(w in line for w in (
                           "entry function", "registers", "spill"))])
    return out
