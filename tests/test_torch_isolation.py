"""The port stands alone: no module of npvp_tpu_torch and no line of
chip_smoke.py imports jax, flax, optax, orbax or the JAX package
npvp_tpu, nor an image library (PIL, cv2): the card's hosts have none, and
the CPU tests must hold the decoder that the card runs. Nor does any of
them read a file of the JAX package: no string constant outside a
docstring names a path under ``npvp_tpu/`` (a ``file.py:line`` citation
of a TPU kernel, as the kernel record's ``replaces`` gives, reads
nothing and is allowed)."""

import ast
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def _sources():
    return sorted((ROOT / "npvp_tpu_torch").rglob("*.py")) + [
        ROOT / "chip_smoke.py"]


@pytest.mark.parametrize("path", _sources(), ids=lambda p: str(
    p.relative_to(ROOT)))
def test_no_jax_import(path):
    bad = [m for m in _imports(path)
           if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "orbax",
                                  "npvp_tpu", "PIL", "cv2")]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"
    text = path.read_text()
    assert "import_module(" not in text and "__import__(" not in text


CITATION = re.compile(r"^npvp_tpu/\S+\.py:\d+$")


def _docstrings(tree):
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef,
                             ast.AsyncFunctionDef)):
            body = node.body
            if (body and isinstance(body[0], ast.Expr)
                    and isinstance(body[0].value, ast.Constant)):
                yield body[0].value


@pytest.mark.parametrize("path", _sources(), ids=lambda p: str(
    p.relative_to(ROOT)))
def test_no_path_into_the_jax_package(path):
    tree = ast.parse(path.read_text(), str(path))
    docs = {id(c) for c in _docstrings(tree)}
    bad = [node.value for node in ast.walk(tree)
           if isinstance(node, ast.Constant) and isinstance(node.value, str)
           and id(node) not in docs
           and (node.value.strip("/") == "npvp_tpu"
                or node.value.startswith(("npvp_tpu/", "/npvp_tpu/")))
           and not CITATION.match(node.value)]
    assert not bad, f"{path.relative_to(ROOT)} names {bad}"
