"""What the hand-written kernels' wrappers share: building a kernel's CUDA
source with ``nvcc`` into a shared library with a plain C interface, loading
it with ``ctypes``, launching on the current stream, and the rules every
wrapper keeps.

The rules, one for all kernels:

- a kernel has no backward, so its wrapper refuses inputs that autograd
  would differentiate (:func:`refuse_autograd`), before its op;
- each kernel is a torch op, so that ``torch.export`` keeps it in a serving
  bundle as one call: its CUDA side launches the kernel, its CPU side is the
  plain twin, its fake side gives a trace the output's shape and dtype;
- a plain CUDA tensor may launch the kernel without the op's dispatcher; a
  CPU tensor, or one that ``torch.export`` traces, goes through the op
  (:func:`direct`);
- a launch checks its shapes, runs on the current stream and raises with
  the CUDA error code and the shapes (:meth:`Library.launch`); nothing
  falls back.

Which call sites reach a wrapper at all is decided in one place,
``nn.layers.kernel_path``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Dict, Sequence

import torch

from npvp_tpu_torch.core.device import BUILD_DIR

CSRC = Path(__file__).resolve().parent / "csrc"

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


class Library:
    """One kernel's library: ``csrc/<source>`` built at first use (its build
    time and ptxas' report in :attr:`info`) and loaded with ``ctypes``, each
    exported function's argument types declared once (``functions``: name
    → argtypes; every function returns an int, 0 or a CUDA error code)."""

    def __init__(self, source: str, stem: str,
                 functions: Dict[str, Sequence]):
        self.source, self.stem = CSRC / source, stem
        self.functions = functions
        self.info = {}
        self._lib = None

    def build(self) -> Path:
        """Compile the source into ``kernels/_build/`` (named by its hash,
        so an edited source builds anew) and return the library path."""
        return build(self.source, self.stem, self.info)

    def load(self) -> ctypes.CDLL:
        if self._lib is None:
            lib = ctypes.CDLL(str(self.build()))
            for name, argtypes in self.functions.items():
                fn = getattr(lib, name)
                fn.argtypes, fn.restype = list(argtypes), ctypes.c_int
            self._lib = lib
        return self._lib

    def launch(self, name: str, dev, *args) -> None:
        """Call ``name(*args, stream)`` on ``dev``'s current stream; raises
        on a CUDA error with the call's non-pointer arguments (its
        shapes)."""
        err = getattr(self._lib or self.load(), name)(
            *args, torch.cuda.current_stream(dev).cuda_stream)
        if err != 0:
            shapes = [a for a, t in zip(args, self.functions[name])
                      if t is not ctypes.c_void_p]
            raise RuntimeError(f"{name} failed: CUDA error {err} "
                               f"(arguments {shapes})")


def refuse_autograd(op: str, *tensors) -> None:
    """Raise if autograd would differentiate any of ``tensors`` (None is
    skipped): the kernels have no backward."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{op} has no backward: its inputs require grad (run it under "
            "torch.no_grad(), or train on the plain path)")


def check_device(x) -> None:
    """The kernels' ops have a CUDA and a CPU side only."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {x.device}")


def direct(x) -> bool:
    """Whether a wrapper may launch its kernel on ``x`` without the op's
    dispatcher: a plain CUDA tensor. A CPU tensor, or a tensor that
    ``torch.export`` traces, goes through the op."""
    if type(x) is torch.Tensor and x.is_cuda:
        return True
    check_device(x)
    return False
