"""Stage-1 per-frame ResNet autoencoder (port of ``npvp_tpu/nn/resnet_ae.py``).

Frames are processed with time folded into batch, (N, T, H, W, C) →
(N·T, H, W, C). With ``learn_3d`` each factorized block adds a temporal
conv1d and a 1-D non-local attention over the T axis of every (h, w)
site. The decoder's ``subpixel`` upsampling and ``s2d_head`` output head
are the same functions on the same parameters as its ConvTranspose and
direct 7×7 head (``npvp_tpu_torch.nn.upsample``).
"""

from __future__ import annotations

import warnings
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from npvp_tpu_torch.core.tracing import span
from npvp_tpu_torch.kernels import decoder_head as dh
from npvp_tpu_torch.kernels import nonlocal_attention as nla
from npvp_tpu_torch.nn.layers import (BatchNorm, ConvBNAct, kernel_path,
                                      linear, reflect_pad_2d,
                                      softmax_f32_stats)
from npvp_tpu_torch.nn.upsample import (subpixel_conv_same,
                                        subpixel_conv_transpose_3x3_s2)


class NonLocalAttention2D(nn.Module):
    """Global spatial attention with 2×2 max-pooled keys/values and a
    zero-initialised residual gate ``gamma``; logits are unscaled (SAGAN
    convention) and kept in the compute dtype with fp32 softmax statistics.
    Each call is one ``npvp.ae.nonlocal`` span. On
    :func:`~npvp_tpu_torch.nn.layers.kernel_path`, for a bf16 ``qkv``, the
    hand-written kernel's wrapper (``kernels/nonlocal_attention.py``)
    computes the attention between the fused projection and ``out_proj``;
    elsewhere its plain twin, the eager code, does. A shape the kernel does
    not take raises in the wrapper: it does not fall back. ``exec_mode`` is
    a plain attribute, not state."""

    def __init__(self, channels: int, attn_ratio: int = 8,
                 value_ratio: int = 2, dtype=torch.float32,
                 exec_mode: str = "xla"):
        super().__init__()
        C = channels
        self.attn_dim, self.dtype = C // attn_ratio, dtype
        self.exec_mode = exec_mode
        self.wq = nn.Linear(C, C // attn_ratio)
        self.wk = nn.Linear(C, C // attn_ratio)
        self.wv = nn.Linear(C, C // value_ratio)
        self.out_proj = nn.Linear(C // value_ratio, C)
        self.bn = BatchNorm(C, eps=1e-5, dtype=dtype)
        self.gamma = nn.Parameter(torch.zeros(()))

    def forward(self, x):
        with span("npvp.ae.nonlocal"):
            a, dt = self.attn_dim, self.dtype
            w3 = torch.cat([self.wq.weight, self.wk.weight, self.wv.weight])
            b3 = torch.cat([self.wq.bias, self.wk.bias, self.wv.bias])
            qkv = F.linear(x.to(dt), w3.to(dt), b3.to(dt))
            # the kernel is bf16 only; fp32 (the golden check) takes the twin
            if qkv.dtype == torch.bfloat16 and kernel_path(self, qkv):
                out = nla.nonlocal_attention(qkv, a)
            else:
                out = nla.nonlocal_attention_plain(qkv, a)
            out = torch.relu(self.bn(linear(out, self.out_proj, dt)))
            return x + self.gamma.to(x.dtype) * out


class NonLocalAttention1D(nn.Module):
    """Temporal non-local attention over (B, T, C) series (B = N·H·W
    sites): unscaled logits in the compute dtype with fp32 softmax
    statistics, output projection, BatchNorm over (B, T), ReLU and a
    zero-initialised residual gate ``gamma``."""

    def __init__(self, channels: int, attn_ratio: int = 8,
                 value_ratio: int = 2, dtype=torch.float32):
        super().__init__()
        C = channels
        self.dtype = dtype
        self.wq = nn.Linear(C, C // attn_ratio)
        self.wk = nn.Linear(C, C // attn_ratio)
        self.wv = nn.Linear(C, C // value_ratio)
        self.out_proj = nn.Linear(C // value_ratio, C)
        self.bn = BatchNorm(C, eps=1e-5, dtype=dtype)
        self.gamma = nn.Parameter(torch.zeros(()))

    def forward(self, x):
        dt = self.dtype
        q, k, v = (linear(x, layer, dt) for layer in (self.wq, self.wk,
                                                       self.wv))
        logits = torch.einsum("btc,bsc->bts", q.float(),
                              k.float()).to(x.dtype)
        weights = softmax_f32_stats(logits, (-1,))
        out = linear(torch.einsum("bts,bsc->btc", weights, v),
                     self.out_proj, dt)
        out = torch.relu(self.bn(out))
        return x + self.gamma.to(x.dtype) * out


class Factorized3DConvAttn(nn.Module):
    """Spatial conv (residual) then non-local 2D attention; with
    ``learn_3d`` then a temporal conv1d (kernel 3, zero-padded) with
    BatchNorm and ReLU (residual) and a 1-D non-local attention over each
    site's T frames; residual around the whole block."""

    def __init__(self, channels: int, learn_3d: bool = False,
                 dtype=torch.float32, exec_mode: str = "xla"):
        super().__init__()
        self.learn_3d, self.dtype = learn_3d, dtype
        self.spatial_conv = ConvBNAct(channels, channels, 3, use_bias=True,
                                      dtype=dtype)
        self.attn2d = NonLocalAttention2D(channels, dtype=dtype,
                                          exec_mode=exec_mode)
        if learn_3d:
            self.temporal_conv = nn.Conv1d(channels, channels, 3, padding=1)
            self.temporal_bn = BatchNorm(channels, eps=1e-5, dtype=dtype)
            self.attn1d = NonLocalAttention1D(channels, dtype=dtype)

    def forward(self, x, T: int):
        y = self.attn2d(self.spatial_conv(x) + x)
        if self.learn_3d:
            NT, H, W, C = y.shape
            N, dt = NT // T, self.dtype
            yt = y.reshape(N, T, H, W, C).permute(0, 2, 3, 1, 4).reshape(
                N * H * W, T, C)
            tc = self.temporal_conv
            conv = F.conv1d(yt.to(dt).permute(0, 2, 1), tc.weight.to(dt),
                            tc.bias.to(dt), padding=1).permute(0, 2, 1)
            yt = self.attn1d(torch.relu(self.temporal_bn(conv)) + yt)
            y = yt.reshape(N, H, W, T, C).permute(0, 3, 1, 2, 4).reshape(
                NT, H, W, C)
        return y + x


class ResnetBlock(nn.Module):
    """Two reflect-padded 3×3 ConvBN with a residual."""

    def __init__(self, channels: int, dtype=torch.float32):
        super().__init__()
        self.conv1 = ConvBNAct(channels, channels, 3, padding="VALID",
                               dtype=dtype)
        self.conv2 = ConvBNAct(channels, channels, 3, padding="VALID",
                               activation=None, dtype=dtype)

    def forward(self, x):
        y = self.conv1(reflect_pad_2d(x, 1))
        return x + self.conv2(reflect_pad_2d(y, 1))


class ResnetEncoder(nn.Module):
    """Frames (N, T, H, W, C_img) → ReLU'd features (N, T, H', W',
    ngf·2^n_downsampling). ``exec_mode`` goes to the non-local
    attentions."""

    def __init__(self, img_channels: int = 1, ngf: int = 64,
                 n_downsampling: int = 3, num_res_blocks: int = 2,
                 learn_3d: bool = False, dtype=torch.float32,
                 exec_mode: str = "xla"):
        super().__init__()
        self.dtype = dtype
        self.n_downsampling, self.num_res_blocks = (n_downsampling,
                                                    num_res_blocks)
        self.block0 = ConvBNAct(img_channels, ngf, 7, padding="VALID",
                                dtype=dtype)
        self.block1 = ConvBNAct(ngf, ngf * 2, 3, stride=2, dtype=dtype)
        c = ngf * 2
        for i in range(1, n_downsampling):
            self.add_module(f"block{i + 1}_attn", Factorized3DConvAttn(
                c, learn_3d, dtype=dtype, exec_mode=exec_mode))
            self.add_module(f"block{i + 1}_conv",
                            ConvBNAct(c, c * 2, 3, stride=2, dtype=dtype))
            c *= 2
        for i in range(num_res_blocks):
            self.add_module(f"res_attn_{i}", Factorized3DConvAttn(
                c, learn_3d, dtype=dtype, exec_mode=exec_mode))
            self.add_module(f"res_conv_{i}", ResnetBlock(c, dtype=dtype))

    def forward(self, x):
        N, T = x.shape[:2]
        x = x.reshape((N * T,) + x.shape[2:]).to(self.dtype)
        x = self.block1(self.block0(reflect_pad_2d(x, 3)))
        for i in range(1, self.n_downsampling):
            x = getattr(self, f"block{i + 1}_attn")(x, T)
            x = getattr(self, f"block{i + 1}_conv")(x)
        for i in range(self.num_res_blocks):
            x = getattr(self, f"res_conv_{i}")(
                getattr(self, f"res_attn_{i}")(x, T))
        x = torch.relu(x)
        return x.reshape((N, T) + x.shape[1:])


class ResnetDecoder(nn.Module):
    """Features (N, T, H', W', C) → frames (N, T, H, W, C_img) through
    ``ConvTranspose2d(k3, s2, p1, output_padding=1)`` upsampling and a 7×7
    head with Tanh or Sigmoid. ``subpixel`` computes each upsampling as its
    2×2 sub-pixel convolution, ``s2d_head`` the head as a stride-4
    sub-pixel convolution where the padded frame side is 2 mod 4 (with a
    warning, the direct head where it is not); same parameters either
    way. The tail (the last upsampling's BatchNorm and ReLU, the reflect
    pad, the direct head and its activation) is one ``npvp.ae.head`` span;
    on :func:`~npvp_tpu_torch.nn.layers.kernel_path`, for bf16, the
    hand-written kernel's wrapper (``kernels/decoder_head.py``) computes it,
    elsewhere its plain twin, the eager code, does. A shape the kernel does
    not take raises in the wrapper: it does not fall back. ``exec_mode`` is
    a plain attribute, not state."""

    def __init__(self, out_channels: int = 1, ngf: int = 64,
                 n_downsampling: int = 3, out_layer: str = "Tanh",
                 subpixel: bool = False, s2d_head: bool = False,
                 dtype=torch.float32, exec_mode: str = "xla"):
        super().__init__()
        if out_layer not in ("Tanh", "Sigmoid"):
            raise ValueError(f"unsupported out_layer {out_layer!r}")
        if n_downsampling < 1:
            raise ValueError(f"n_downsampling {n_downsampling}: the tail "
                             "needs an upsampling's BatchNorm")
        self.n_downsampling, self.out_layer, self.dtype = (
            n_downsampling, out_layer, dtype)
        self.subpixel, self.s2d_head = subpixel, s2d_head
        self.exec_mode = exec_mode
        c = ngf * 2 ** n_downsampling
        for i in range(n_downsampling):
            feats = ngf * 2 ** (n_downsampling - i) // 2
            self.add_module(f"up{i}_conv", nn.ConvTranspose2d(
                c, feats, 3, stride=2, padding=1, output_padding=1,
                bias=False))
            self.add_module(f"up{i}_bn", BatchNorm(feats, dtype=dtype))
            c = feats
        self.head = nn.Conv2d(c, out_channels, 7)

    def forward(self, x):
        N, T = x.shape[:2]
        dt = self.dtype
        x = x.reshape((N * T,) + x.shape[2:]).to(dt)
        for i in range(self.n_downsampling):
            up = getattr(self, f"up{i}_conv")
            if self.subpixel:
                y = subpixel_conv_transpose_3x3_s2(x, up.weight.to(dt))
            else:
                y = F.conv_transpose2d(x.permute(0, 3, 1, 2),
                                       up.weight.to(dt), None, 2, 1,
                                       1).permute(0, 2, 3, 1)
            if i < self.n_downsampling - 1:
                x = torch.relu(getattr(self, f"up{i}_bn")(y))
        with span("npvp.ae.head"):
            x = self._tail(y)
        return x.reshape((N, T) + x.shape[1:])

    def _tail(self, y):
        """Frames from the last upsampling's raw output ``y``."""
        dt = self.dtype
        bn = getattr(self, f"up{self.n_downsampling - 1}_bn")
        a, b = bn.scale_shift(y)
        weight, bias = self.head.weight.to(dt), self.head.bias.to(dt)
        s2d_ok = (y.shape[1] + 6) % 4 == (y.shape[2] + 6) % 4 == 2
        if self.s2d_head and not s2d_ok:
            warnings.warn(
                f"AE.s2d_head requested but padded spatial shape "
                f"{y.shape[1] + 6}x{y.shape[2] + 6} is not 2 mod 4 (img_size "
                "must be divisible by 4); using the direct 7x7 head",
                stacklevel=3)
        if self.s2d_head and s2d_ok:
            x = reflect_pad_2d(torch.relu(y.to(dt) * a + b), 3)
            x = subpixel_conv_same(x, weight, bias, factor=4)
            return torch.tanh(x) if self.out_layer == "Tanh" else (
                torch.sigmoid(x))
        if y.dtype == torch.bfloat16 and kernel_path(self, y, a, b, weight,
                                                     bias):
            return dh.decoder_head(y.contiguous(), a, b, weight, bias,
                                   self.out_layer)
        return dh.decoder_head_plain(y, a, b, weight, bias, self.out_layer)


class FrameAutoEncoder(nn.Module):
    """Encoder + decoder pair (``encoder``/``decoder`` as in flax);
    ``exec_mode`` goes to the encoder's non-local attentions and the
    decoder's tail."""

    def __init__(self, img_channels: int = 1, ngf: int = 64,
                 n_downsampling: int = 3, num_res_blocks: int = 2,
                 out_layer: str = "Tanh", learn_3d: bool = False,
                 s2d_head: bool = False, dtype=torch.float32,
                 exec_mode: str = "xla"):
        super().__init__()
        self.encoder = ResnetEncoder(img_channels, ngf, n_downsampling,
                                     num_res_blocks, learn_3d, dtype=dtype,
                                     exec_mode=exec_mode)
        self.decoder = ResnetDecoder(img_channels, ngf, n_downsampling,
                                     out_layer, s2d_head=s2d_head,
                                     dtype=dtype, exec_mode=exec_mode)

    def forward(self, x):
        feats = self.encoder(x)
        return self.decoder(feats), feats

    def encode(self, x):
        with span("npvp.ae.encode"):
            return self.encoder(x)

    def decode(self, feats):
        with span("npvp.ae.decode"):
            return self.decoder(feats)


def build_ae(cfg, dtype=torch.float32,
             exec_mode: Optional[str] = None) -> FrameAutoEncoder:
    """FrameAutoEncoder from a Config; ``exec_mode`` overrides
    ``cfg.Predictor.exec_mode`` as in ``build_predictor`` ("pallas": the
    non-local attentions' and the decoder tail's kernels in eval mode)."""
    return FrameAutoEncoder(
        img_channels=cfg.Dataset.img_channels, ngf=cfg.AE.ngf,
        n_downsampling=cfg.AE.n_downsampling,
        num_res_blocks=cfg.AE.num_res_blocks, out_layer=cfg.AE.out_layer,
        learn_3d=cfg.AE.learn_3d, s2d_head=cfg.AE.s2d_head, dtype=dtype,
        exec_mode=(exec_mode if exec_mode is not None
                   else cfg.Predictor.exec_mode))
