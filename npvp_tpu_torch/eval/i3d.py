"""InceptionI3d for FVD features (port of ``npvp_tpu/eval/i3d.py``).

Video (N, T, H, W, 3) in [−1, 1], channels last as in the JAX package →
the 400-d logits (spatially and temporally averaged, before the softmax).
Convolutions are ``nn.Conv3d`` run on channels-last views with TF-style
SAME padding (asymmetric where the total is odd); max pooling pads with
−inf in the same way; BatchNorm (eps 1e-5) always reads its running
statistics: FVD never trains the network. Submodule names follow the flax
module, so a converted flax checkpoint loads through
``npvp_tpu_torch.tools.weights.load_flax``.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from npvp_tpu_torch.nn.layers import BatchNorm


def _same_pads(sizes, window, strides) -> list:
    """F.pad amounts (last axis first) of TF-SAME over the (D, H, W) axes:
    the total ``max((ceil(size / s) − 1)·s + k − size, 0)``, its smaller
    half before."""
    pads = []
    for size, k, s in zip(sizes, window, strides):
        out = -(-size // s)
        total = max((out - 1) * s + k - size, 0)
        pads.append((total // 2, total - total // 2))
    return [p for pair in reversed(pads) for p in pair]


def _to_ncdhw(x):
    return x.permute(0, 4, 1, 2, 3)


def _to_ndhwc(x):
    return x.permute(0, 2, 3, 4, 1)


def max_pool_same(x, window, strides):
    """TF-SAME max pooling over (D, H, W) of an NDHWC tensor."""
    y = F.pad(_to_ncdhw(x), _same_pads(x.shape[1:4], window, strides),
              value=float("-inf"))
    return _to_ndhwc(F.max_pool3d(y, window, strides))


class Unit3D(nn.Module):
    """3D convolution (TF-SAME) → BatchNorm → ReLU."""

    def __init__(self, in_features: int, features: int,
                 kernel: Tuple[int, int, int] = (1, 1, 1),
                 strides: Tuple[int, int, int] = (1, 1, 1),
                 use_bn: bool = True, activation: bool = True,
                 use_bias: bool = False, dtype=torch.float32):
        super().__init__()
        self.kernel, self.strides = tuple(kernel), tuple(strides)
        self.activation, self.dtype = activation, dtype
        self.conv3d = nn.Conv3d(in_features, features, kernel, strides,
                                bias=use_bias)
        # normalised in fp32 and cast back, as the flax module does
        self.bn = (BatchNorm(features, eps=1e-5, dtype=torch.float32)
                   if use_bn else None)

    def forward(self, x):
        dt = self.dtype
        y = F.pad(_to_ncdhw(x.to(dt)),
                  _same_pads(x.shape[1:4], self.kernel, self.strides))
        bias = None if self.conv3d.bias is None else self.conv3d.bias.to(dt)
        y = _to_ndhwc(F.conv3d(y, self.conv3d.weight.to(dt), bias,
                               self.strides))
        if self.bn is not None:
            y = self.bn(y).to(dt)
        return torch.relu(y) if self.activation else y


class InceptionBlock(nn.Module):
    """Four branches: 1×1 | 1×1 → 3×3 | 1×1 → 3×3 | max-pool → 1×1."""

    def __init__(self, in_features: int, out_channels: Sequence[int],
                 dtype=torch.float32):
        super().__init__()
        c = out_channels
        self.b0 = Unit3D(in_features, c[0], dtype=dtype)
        self.b1a = Unit3D(in_features, c[1], dtype=dtype)
        self.b1b = Unit3D(c[1], c[2], (3, 3, 3), dtype=dtype)
        self.b2a = Unit3D(in_features, c[3], dtype=dtype)
        self.b2b = Unit3D(c[3], c[4], (3, 3, 3), dtype=dtype)
        self.b3b = Unit3D(in_features, c[5], dtype=dtype)

    def forward(self, x):
        b3 = max_pool_same(x, (3, 3, 3), (1, 1, 1))
        return torch.cat([self.b0(x), self.b1b(self.b1a(x)),
                          self.b2b(self.b2a(x)), self.b3b(b3)], dim=-1)


INCEPTION_CHANNELS = {
    "Mixed_3b": (64, 96, 128, 16, 32, 32),
    "Mixed_3c": (128, 128, 192, 32, 96, 64),
    "Mixed_4b": (192, 96, 208, 16, 48, 64),
    "Mixed_4c": (160, 112, 224, 24, 64, 64),
    "Mixed_4d": (128, 128, 256, 24, 64, 64),
    "Mixed_4e": (112, 144, 288, 32, 64, 64),
    "Mixed_4f": (256, 160, 320, 32, 128, 128),
    "Mixed_5b": (256, 160, 320, 32, 128, 128),
    "Mixed_5c": (384, 192, 384, 48, 128, 128),
}


class InceptionI3d(nn.Module):
    """Video (N, T, H, W, 3) in [−1, 1] → (N, num_classes) fp32 features."""

    def __init__(self, num_classes: int = 400, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.Conv3d_1a_7x7 = Unit3D(3, 64, (7, 7, 7), (2, 2, 2), dtype=dtype)
        self.Conv3d_2b_1x1 = Unit3D(64, 64, dtype=dtype)
        self.Conv3d_2c_3x3 = Unit3D(64, 192, (3, 3, 3), dtype=dtype)
        c = 192
        for name, chans in INCEPTION_CHANNELS.items():
            self.add_module(name, InceptionBlock(c, chans, dtype=dtype))
            c = chans[0] + chans[2] + chans[4] + chans[5]
        self.logits = Unit3D(c, num_classes, use_bn=False, activation=False,
                             use_bias=True, dtype=dtype)

    def forward(self, x):
        x = self.Conv3d_1a_7x7(x.to(self.dtype))
        x = max_pool_same(x, (1, 3, 3), (1, 2, 2))
        x = self.Conv3d_2c_3x3(self.Conv3d_2b_1x1(x))
        x = max_pool_same(x, (1, 3, 3), (1, 2, 2))
        x = self.Mixed_3c(self.Mixed_3b(x))
        x = max_pool_same(x, (3, 3, 3), (2, 2, 2))
        for name in ("Mixed_4b", "Mixed_4c", "Mixed_4d", "Mixed_4e",
                     "Mixed_4f"):
            x = getattr(self, name)(x)
        x = max_pool_same(x, (2, 2, 2), (2, 2, 2))
        x = self.Mixed_5c(self.Mixed_5b(x))
        # the reference head: AvgPool3d((2, 7, 7), stride 1, VALID), the
        # 1×1×1 logits convolution, then the mean over time and space (the
        # temporal window of 2 half-weights the end frames)
        window = (min(2, x.shape[1]), min(7, x.shape[2]), min(7, x.shape[3]))
        x = _to_ndhwc(F.avg_pool3d(_to_ncdhw(x).float(), window, 1))
        x = self.logits(x)
        return x.float().mean(dim=(1, 2, 3))
