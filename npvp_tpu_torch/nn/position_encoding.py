"""Sine/cosine positional embeddings, 1-D, 2-D and 3-D (port of
``npvp_tpu/nn/position_encoding.py``): the reference's legacy DETR-style
codes, which the NRMLP's Fourier features replaced; no module of the model
uses them."""

from __future__ import annotations

import math

import torch


def _freq_terms(num_pos_feats: int, temperature: float) -> torch.Tensor:
    i = torch.arange(num_pos_feats, dtype=torch.float32)
    return temperature ** (2.0 * torch.floor(i / 2.0) / num_pos_feats)


def _interleave_sin_cos(pos: torch.Tensor) -> torch.Tensor:
    """(…, F) scaled positions → sin of the even features and cos of the
    odd ones, interleaved."""
    out = torch.stack([torch.sin(pos[..., 0::2]), torch.cos(pos[..., 1::2])],
                      dim=-1)
    return out.reshape(pos.shape[:-1] + (-1,))


def _axis_code(length: int, num_pos_feats: int, temperature: float,
               normalize: bool, scale: float) -> torch.Tensor:
    """(length, num_pos_feats) code of the positions 1 … length."""
    pos = torch.arange(1, length + 1, dtype=torch.float32)
    if normalize:
        pos = pos / (length + 1e-6) * scale
    dim_t = _freq_terms(num_pos_feats, temperature)
    return _interleave_sin_cos(pos[:, None] / dim_t[None, :])


def sine_position_encoding_1d(length: int, num_pos_feats: int = 64,
                              temperature: float = 10000.0,
                              normalize: bool = False,
                              scale: float = 2.0 * math.pi) -> torch.Tensor:
    """(length, num_pos_feats) sine embedding over a 1-D index range."""
    return _axis_code(length, num_pos_feats, temperature, normalize, scale)


def sine_position_encoding_2d(h: int, w: int, num_pos_feats: int = 64,
                              temperature: float = 10000.0,
                              normalize: bool = True,
                              scale: float = 2.0 * math.pi) -> torch.Tensor:
    """(h, w, 2·num_pos_feats): the y code, then the x code."""
    pe_y = _axis_code(h, num_pos_feats, temperature, normalize, scale)
    pe_x = _axis_code(w, num_pos_feats, temperature, normalize, scale)
    return torch.cat([pe_y[:, None, :].expand(h, w, -1),
                      pe_x[None, :, :].expand(h, w, -1)], dim=-1)


def sine_position_encoding_3d(t: int, h: int, w: int,
                              num_pos_feats: int = 64,
                              temperature: float = 10000.0,
                              normalize: bool = True,
                              scale: float = 2.0 * math.pi) -> torch.Tensor:
    """(t, h, w, 3·num_pos_feats): the 2-D spatial code, then a temporal
    code."""
    spatial = sine_position_encoding_2d(h, w, num_pos_feats, temperature,
                                        normalize, scale)
    temporal = sine_position_encoding_1d(t, num_pos_feats, temperature,
                                         normalize, scale)
    return torch.cat([spatial[None].expand(t, h, w, -1),
                      temporal[:, None, None, :].expand(t, h, w, -1)],
                     dim=-1)
