"""The JAX package's C++ data library in a test process, loaded reliably.

``npvp_tpu/data/native_bindings.py`` builds its git-ignored
``libnpvp_data.so`` at first use with ``make``, which writes the file where
it is then loaded. ``tests/test_native.py`` asks for the library while
pytest collects it, so every xdist worker runs that ``make`` at the same
moment; a worker that loads the file while another's build rewrites it
fails, and the JAX module then reports the library unavailable for the rest
of that process (its ``_tried`` stays set).

:func:`jax_native_available` loads it again in such a process. Under a lock
on the library's directory it clears the failed attempt and loads the file;
where there is none, or it does not load, it first compiles the source with
the Makefile's compiler and flags into a temporary file of that directory
and renames it into place, so that no reader ever sees a partial file. It
writes nothing but the build product JAX's own ``make`` writes."""

from __future__ import annotations

import fcntl
import os
import re
import shlex
import subprocess
import tempfile
from contextlib import contextmanager
from pathlib import Path


@contextmanager
def _locked(directory: Path):
    fd = os.open(directory, os.O_RDONLY)
    try:
        fcntl.flock(fd, fcntl.LOCK_EX)
        yield
    finally:
        os.close(fd)  # releases the lock


def _make_variable(makefile: str, name: str) -> str:
    """``name`` as ``make`` resolves ``NAME ?= value``: the environment's
    value first."""
    if os.environ.get(name):
        return os.environ[name]
    return re.search(rf"^{name}\s*\?=\s*(.*)$", makefile, re.M).group(1)


def build(directory: Path, target: Path) -> None:
    """Compile ``npvp_data.cpp`` as the Makefile does, into ``target``
    through a temporary file that matches the directory's ``*.so`` ignore
    rule."""
    makefile = (directory / "Makefile").read_text()
    fd, tmp = tempfile.mkstemp(prefix=".build-", suffix=".so", dir=directory)
    os.close(fd)
    try:
        subprocess.run([*shlex.split(_make_variable(makefile, "CXX")),
                        *shlex.split(_make_variable(makefile, "CXXFLAGS")),
                        str(directory / "npvp_data.cpp"), "-o", tmp],
                       check=True, capture_output=True, timeout=300)
        os.replace(tmp, target)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def jax_native_available(attempts: int = 3) -> bool:
    """Whether the JAX package's library is loaded in this process, after
    loading it (and building it, if need be) as the module docstring says."""
    from npvp_tpu.data import native_bindings as jnb

    if jnb._lib is not None:
        return True
    with _locked(jnb._NATIVE_DIR):
        for _ in range(attempts):
            if jnb._LIB_PATH.exists():  # never let _load run make itself
                jnb._tried = False
                if jnb._load() is not None:
                    return True
            try:
                build(jnb._NATIVE_DIR, jnb._LIB_PATH)
            except (OSError, subprocess.SubprocessError):
                return False  # no compiler here: unavailable, as in JAX
    return False
