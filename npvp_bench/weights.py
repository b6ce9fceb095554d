"""Weights and inputs drawn from the run's seed, on the device.

Every tensor of a model's state dict is drawn from ONE ``torch.randn`` of
all their elements (names sorted, so the layout does not depend on the
order in which a module registers them), then shaped by kind:

- a kernel (two or more axes): LeCun normal, ``N(0, 1) / √fan_in`` with
  ``fan_in`` the size of one slice along the first axis;
- a norm's scale: ``1 + 0.1·N``; a norm's or a layer's bias: ``0.05·N``;
- a BatchNorm's running mean ``0.1·N`` and variance ``exp(0.1·N)``;
- the coordinate MLP's Fourier matrix ``B``: ``10·N``;
- a residual gate (a 0-d tensor): ``0.5·N``.

Biases, norms and gates are drawn away from their usual initial values so
that a comparison sees every term they feed.
"""

from __future__ import annotations

import hashlib
import re
from typing import Dict, Iterable, Tuple

import torch

_NORM = re.compile(r"(^|\.)(\w*norm\d*|\w*bn)\.(weight|bias)$")


def sub_seed(seed: int, *tags) -> int:
    """A 63-bit seed derived from ``seed`` and ``tags``."""
    text = "/".join(str(t) for t in (int(seed),) + tags)
    digest = hashlib.blake2b(text.encode(), digest_size=8).digest()
    return int.from_bytes(digest, "little") & (2 ** 63 - 1)


def generator(seed: int, device, *tags) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(sub_seed(seed, *tags))


def _shape_leaf(name: str, x: torch.Tensor) -> torch.Tensor:
    if name.endswith("running_mean"):
        return 0.1 * x
    if name.endswith("running_var"):
        return torch.exp(0.1 * x)
    if x.dim() == 0:
        return 0.5 * x
    if name.split(".")[-1] == "B":
        return 10.0 * x
    norm = _NORM.search(name)
    if norm is not None:
        return 1.0 + 0.1 * x if norm.group(3) == "weight" else 0.05 * x
    if x.dim() >= 2:
        return x / (x[0].numel() ** 0.5)
    return 0.05 * x


def draw(specs: Iterable[Tuple[str, torch.Size]], seed: int, device,
         tag: str) -> Dict[str, torch.Tensor]:
    """float32 tensors for ``specs`` (name, shape), drawn on ``device``
    from ``seed`` and ``tag``."""
    specs = sorted((n, tuple(s)) for n, s in specs)
    sizes = [int(torch.Size(s).numel()) for _, s in specs]
    flat = torch.randn(sum(sizes), generator=generator(seed, device, tag),
                       device=device)
    out = {}
    for (name, shape), piece in zip(specs, flat.split(sizes)):
        out[name] = _shape_leaf(name, piece.reshape(shape))
    return out


def state_specs(module: torch.nn.Module):
    """(name, shape) of every parameter and buffer of ``module``."""
    return [(k, v.shape) for k, v in module.state_dict().items()]
