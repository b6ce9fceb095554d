"""Shared building blocks (port of ``npvp_tpu/nn/layers.py``).

Activations keep the JAX package's channels-last layouts: frames are
(N, H, W, C) and clips (N, T, H, W, C). A convolution views its input as
NCHW with channels-last strides (a ``permute``, no copy), which cuDNN runs
natively. Every module takes a compute ``dtype`` (bfloat16 when serving) and
holds float32 parameters that are cast where they are used, as the flax
modules do; normalisation statistics are taken in float32.

Submodule and parameter names follow the flax modules, so that
``npvp_tpu_torch.tools.weights`` can map a flax variable tree onto them.
A module's train/eval mode stands for flax's ``train``/``deterministic``
argument: in training mode BatchNorm normalises with the batch's statistics
and updates its running ones, and dropout and DropPath draw their masks
from an explicit :class:`Rng`.
"""

from __future__ import annotations

import hashlib
import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from npvp_tpu_torch.core.distributed import (all_reduce_sum, copy_to_model,
                                             reduce_from_model)
from npvp_tpu_torch.core.sequence_parallel import sp_param, span
from npvp_tpu_torch.kernels import layer_norm as ln_kernel
from npvp_tpu_torch.kernels.numerics import (  # noqa: F401 (re-exported)
    fp32_moments, reflect_pad_2d, softmax_f32_stats)
from npvp_tpu_torch.nn.quant import int8_contract


class Rng:
    """A random stream named by a 63-bit seed. Children are derived by name
    (``fold``), as ``jax.random.fold_in`` derives keys, so a draw depends
    only on where it is made, never on how many draws came before it: a
    block that ``torch.utils.checkpoint`` runs again draws the same masks.
    Every draw takes a ``torch.Generator`` seeded from the stream.

    Under data parallelism a rank holds some rows of the global batch
    (``core.distributed``: rows ``index::count``); a stream made by
    :meth:`for_rows` draws the global batch's shape and keeps this rank's
    rows, so that each row gets the noise the one-process run gives it.
    A draw's leading axis is the batch, flattened with the batch outermost
    (a (N·k, …) shape holds k entries per row). A draw for a tensor that
    tensor parallelism splits (attention heads, the FFN's hidden width)
    names the split, ``(dim, index, count)``, and keeps its slice of the
    whole tensor's draw."""

    def __init__(self, seed: int,
                 rows: Optional[Tuple[int, int, int]] = None):
        self.seed = int(seed) & (2 ** 63 - 1)
        self.rows = rows

    def fold(self, tag) -> "Rng":
        digest = hashlib.blake2b(f"{self.seed}/{tag}".encode(),
                                 digest_size=8).digest()
        return Rng(int.from_bytes(digest, "little"), self.rows)

    def for_rows(self, index: int, count: int, n_local: int) -> "Rng":
        """This stream, drawing for rows ``index::count`` of a global batch
        of ``n_local · count`` rows; itself when ``count`` is 1."""
        return self if count == 1 else Rng(self.seed, (index, count,
                                                       n_local))

    def generator(self, device) -> torch.Generator:
        return torch.Generator(device=device).manual_seed(self.seed)

    def _draw(self, make, shape, split):
        shape = tuple(shape)
        full = list(shape)
        if split is not None:
            dim, _, count = split
            full[dim] *= count
        if self.rows is not None:
            index, count, n = self.rows
            if full[0] % n:
                raise ValueError(f"draw {shape} does not lead with the "
                                 f"batch's {n} rows")
            k = full[0] // n
            full[0] *= count
            x = make(full).reshape((n, count, k) + tuple(full[1:]))
            x = x[:, index].reshape([n * k] + full[1:])
        else:
            x = make(full)
        if split is not None:
            dim, index, _ = split
            x = x.narrow(dim, index * shape[dim], shape[dim])
        return x

    def normal(self, shape, device, split=None) -> torch.Tensor:
        return self._draw(lambda s: torch.randn(
            s, generator=self.generator(device), device=device), shape,
            split)

    def bernoulli(self, shape, p: float, device, split=None) -> torch.Tensor:
        """float32 mask of ones with probability ``p``, else zeros."""
        return self._draw(lambda s: torch.empty(s, device=device).bernoulli_(
            p, generator=self.generator(device)), shape, split)


def fold(rng: Optional[Rng], tag) -> Optional[Rng]:
    """``rng.fold(tag)``, or None without a stream."""
    return None if rng is None else rng.fold(tag)


def _need(rng: Optional[Rng], what: str) -> Rng:
    if rng is None:
        raise ValueError(f"{what} in training mode needs an Rng")
    return rng


def dropout(x, rate: float, training: bool, rng: Optional[Rng], split=None):
    """Elementwise dropout, ``x / keep_prob`` where kept (flax
    ``nn.Dropout``); the identity at rate 0 or in eval mode. ``split``
    names the tensor-parallel split of ``x`` (:class:`Rng`)."""
    if not training or rate == 0.0:
        return x
    keep = _need(rng, "dropout").bernoulli(x.shape, 1.0 - rate, x.device,
                                           split)
    return x * (keep / (1.0 - rate)).to(x.dtype)


def scaled_dot_product_attention(q, k, v, mask=None, dropout_rate=0.0,
                                 rng: Optional[Rng] = None, split=None):
    """Attention over (..., L, num_heads, head_dim) tensors.

    ``mask`` is boolean with True = allowed, broadcastable to
    (..., num_heads, Lq, Lk); masked logits take ``finfo(float32).min`` (not
    -inf, so a fully masked row stays finite). Logits and softmax are fp32;
    the weights are cast to the compute dtype before the weighted sum. With
    ``dropout_rate`` > 0 the weights are dropped with a mask from ``rng``
    (``split``: the heads' tensor-parallel split, on the heads axis)."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    logits = torch.einsum("...qhd,...khd->...hqk", q.float(), k.float())
    logits = logits * scale
    if mask is not None:
        logits = torch.where(mask, logits,
                             torch.finfo(torch.float32).min)
    weights = torch.softmax(logits, dim=-1).to(q.dtype)
    weights = dropout(weights, dropout_rate, dropout_rate > 0.0, rng, split)
    return torch.einsum("...hqk,...khd->...qhd", weights, v)


def linear(x, layer: nn.Linear, dtype, quant: bool = False, sp=None):
    """``x @ W + b`` in the compute dtype, W and b cast from float32; with
    ``quant`` the product is the dynamic int8 one
    (:func:`~npvp_tpu_torch.nn.quant.int8_contract`) and the bias is added
    after it, as the JAX package's ``QuantDense`` does. ``sp``: ``x`` is a
    sequence-parallel shard (``core.sequence_parallel.sp_param``)."""
    weight = sp_param(layer.weight, sp)
    bias = (None if layer.bias is None
            else sp_param(layer.bias, sp).to(dtype))
    if quant:
        y = int8_contract(x, weight.t(), out_dtype=dtype)
        return y if bias is None else y + bias
    return F.linear(x.to(dtype), weight.to(dtype), bias)


def row_parallel(x, layer: nn.Linear, dtype, quant: bool = False, tp=None,
                 partial: bool = False):
    """:func:`linear` of a layer whose input columns tensor parallelism
    splits (``tp``: the model axis, ``core.distributed.AxisShard``): the
    partial products summed over the model axis, then the bias, added
    once. :func:`linear` itself without ``tp``. With ``partial`` the
    product alone, neither summed nor biased: the caller reduce-scatters
    it over sequence-parallel shards and adds the bias there."""
    if partial:
        if quant:
            return int8_contract(x, layer.weight.t(), out_dtype=dtype)
        return F.linear(x.to(dtype), layer.weight.to(dtype))
    if tp is None:
        return linear(x, layer, dtype, quant)
    y = reduce_from_model(F.linear(x.to(dtype), layer.weight.to(dtype)), tp)
    return y if layer.bias is None else y + layer.bias.to(dtype)


def tp_split(tp, dim: int):
    """The ``(dim, index, count)`` split of a tensor-parallel activation
    for :class:`Rng` draws; None without tensor parallelism."""
    return None if tp is None else (dim, tp.rank, tp.size)


def conv_nhwc(x, conv: nn.Conv2d, dtype):
    """``conv`` on an (N, H, W, C) tensor; returns (N, H', W', C')."""
    bias = None if conv.bias is None else conv.bias.to(dtype)
    y = F.conv2d(x.to(dtype).permute(0, 3, 1, 2), conv.weight.to(dtype),
                 bias, conv.stride, conv.padding, conv.dilation, conv.groups)
    return y.permute(0, 2, 3, 1)


class MultiHeadAttention(nn.Module):
    """q/k/v/output projections plus attention (port of the flax
    ``MultiHeadAttention``; its DenseGeneral kernels become ``nn.Linear``
    weights of shape (H·D, C) and (C, H·D)). In training mode the attention
    weights are dropped at rate ``dropout``. With ``quant`` the four
    projections are dynamic int8 products; the attention itself stays in
    the compute dtype.

    Under tensor parallelism (``tp``, set by
    ``core.tensor_parallel.shard_tensor_parallel``) the module holds
    ``num_heads`` of the heads: the rows of wq/wk/wv and the columns of wo
    that belong to them; their output is summed over the model axis."""

    def __init__(self, embed_dim: int, num_heads: int, dropout: float = 0.0,
                 dtype=torch.float32, quant: bool = False):
        super().__init__()
        self.num_heads, self.dropout, self.dtype = num_heads, dropout, dtype
        self.quant = quant
        self.tp = None
        self.wq = nn.Linear(embed_dim, embed_dim)
        self.wk = nn.Linear(embed_dim, embed_dim)
        self.wv = nn.Linear(embed_dim, embed_dim)
        self.wo = nn.Linear(embed_dim, embed_dim)

    @property
    def dropout_rate(self) -> float:
        """The attention-weight dropout rate in force: 0 in eval mode."""
        return self.dropout if self.training else 0.0

    def forward(self, q_in, k_in, v_in, mask=None,
                rng: Optional[Rng] = None, partial: bool = False):
        """``partial``: :func:`row_parallel`'s, for the output projection."""
        H, tp = self.num_heads, self.tp
        heads = lambda t: t.reshape(t.shape[:-1] + (H, -1))  # noqa: E731
        proj = lambda t, layer: linear(t, layer, self.dtype,  # noqa: E731
                                       self.quant)
        # one gradient all-reduce per distinct input tensor
        inputs = {}
        for t in (q_in, k_in, v_in):
            inputs.setdefault(id(t), copy_to_model(t, tp))
        q = heads(proj(inputs[id(q_in)], self.wq))
        k = heads(proj(inputs[id(k_in)], self.wk))
        v = heads(proj(inputs[id(v_in)], self.wv))
        out = scaled_dot_product_attention(q, k, v, mask, self.dropout_rate,
                                           rng, tp_split(tp, -3))
        return row_parallel(out.flatten(-2), self.wo, self.dtype, self.quant,
                            tp, partial)


class BatchNorm(nn.Module):
    """BatchNorm over the trailing channel axis, applied as a per-channel
    affine ``x·a + b`` in the compute dtype. Eval mode reads the running
    statistics. Training mode takes the batch's fp32 mean and *biased*
    variance (:func:`fp32_moments`) and moves the running statistics toward
    them with flax's rule, ``r = momentum·r + (1 − momentum)·s``, the biased
    variance included (``torch.nn.BatchNorm`` stores the unbiased one).

    Under data parallelism (``sync``, the data axis, set by
    :func:`sync_batchnorm`) the training statistics are the global
    batch's: (Σx, Σx², count) summed over the axis with the sum's gradient,
    as flax's BatchNorm computes them under JAX's sharded jit and as the
    reference's ``sync_batchnorm=True`` does; the running statistics then
    stay equal on every rank."""

    def __init__(self, channels: int, eps: float = 1e-5,
                 momentum: float = 0.9, dtype=torch.float32):
        super().__init__()
        self.eps, self.momentum, self.dtype = eps, momentum, dtype
        self.sync = None
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def scale_shift(self, x):
        """The per-channel ``(a, b)`` of ``x·a + b`` in the compute dtype:
        from the running statistics in eval mode; in training mode from
        ``x``'s batch statistics, moving the running ones toward them."""
        if self.training:
            dims = tuple(range(x.dim() - 1))
            if self.sync is None:
                mean, var = fp32_moments(x, dims, keepdim=False)
            else:
                xf = x.float()
                count = xf.new_full((1,), xf.numel() / xf.shape[-1])
                sums = all_reduce_sum(torch.cat(
                    [xf.sum(dims), (xf * xf).sum(dims), count]), self.sync)
                C = xf.shape[-1]
                mean = sums[:C] / sums[-1]
                var = torch.clamp(sums[C:2 * C] / sums[-1] - mean * mean,
                                  min=0.0)
            with torch.no_grad():
                m = self.momentum
                self.running_mean.mul_(m).add_((1.0 - m) * mean)
                self.running_var.mul_(m).add_((1.0 - m) * var)
        else:
            mean, var = self.running_mean, self.running_var
        a = self.weight * torch.rsqrt(var + self.eps)
        b = self.bias - mean * a
        return a.to(self.dtype), b.to(self.dtype)

    def forward(self, x):
        a, b = self.scale_shift(x)
        return x.to(self.dtype) * a + b


def sync_batchnorm(module: nn.Module, data_axis) -> nn.Module:
    """Give every :class:`BatchNorm` in ``module`` the data axis
    (``core.distributed.axis(mesh, "data")``) over which its training
    statistics are taken; None takes them per rank. Returns ``module``."""
    for m in module.modules():
        if isinstance(m, BatchNorm):
            m.sync = data_axis
    return module


def kernel_path(module: nn.Module, x, *more) -> bool:
    """Whether ``module`` hands ``x`` to its hand-written kernel (the
    attention's, a norm's, the AE's non-local attention's, the AE decoder's
    tail's): ``exec_mode "pallas"``, eval mode, and nothing that needs a
    gradient — ``x``, the other inputs ``more`` (the decoder tail's affine
    and head, cast from its submodules' parameters), or the module's own
    parameters (a norm's affine) — while autograd records, for the kernels
    have no backward. On any device: the kernel's wrapper launches it on a
    CUDA tensor and runs its plain twin on a CPU one. The rest (training,
    the xla and int8 modes, a forward under autograd) runs the eager code,
    which the JAX parity tests hold."""
    return (module.exec_mode == "pallas" and not module.training
            and not (torch.is_grad_enabled() and (any(
                t.requires_grad for t in (x, *more)) or any(
                p.requires_grad for p in module.parameters(False)))))


class TokenLayerNorm(nn.Module):
    """LayerNorm over the trailing channel axis with fp32 statistics and the
    affine applied in the compute dtype. Default eps 1e-6 as in flax; every
    VidHRFormer call site passes 1e-5. On :func:`kernel_path`, off a
    sequence-parallel shard, the hand-written kernel computes it, the affine
    in fp32 and one rounding to ``dtype``."""

    def __init__(self, channels: int, eps: float = 1e-6,
                 dtype=torch.float32, exec_mode: str = "xla"):
        super().__init__()
        self.eps, self.dtype, self.exec_mode = eps, dtype, exec_mode
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x, sp=None):
        """``sp``: ``x`` is a sequence-parallel shard."""
        # a sequence-parallel shard keeps the eager code, as LayerNormHWC
        # (whose statistics are summed over the ranks) does
        if sp is None and kernel_path(self, x):
            return ln_kernel.layer_norm(x.contiguous(), self.weight,
                                        self.bias, eps=self.eps,
                                        out_dtype=self.dtype)
        weight, bias = sp_param(self.weight, sp), sp_param(self.bias, sp)
        mean, var = fp32_moments(x, -1)
        inv = torch.rsqrt(var + self.eps)
        a = (inv * weight).to(self.dtype)
        b = (bias - mean * inv * weight).to(self.dtype)
        return x.to(self.dtype) * a + b


class LayerNormHWC(nn.Module):
    """LayerNorm over the trailing (H, W, C) axes with an (H, W, C) affine
    (the reference's ``nn.LayerNorm((C, H, W))`` in channels-last), with
    the GELU ``act`` ("gelu_tanh" or "gelu") after it when asked. On
    :func:`kernel_path`, off a sequence-parallel shard, the hand-written
    kernel computes both, the affine and the GELU in fp32 and one rounding
    to ``x.dtype``; elsewhere the eager code does, rounding at each step.

    On a sequence-parallel shard (``sp``: ``x`` holds rows ``rank·h`` …
    of H) the statistics are the whole sample's: (Σx, Σx², count) summed
    over the model axis in float32, with the sum's gradient; the affine
    is used at this shard's rows."""

    def __init__(self, shape, eps: float = 1e-5, exec_mode: str = "xla"):
        super().__init__()
        self.eps, self.exec_mode = eps, exec_mode
        self.weight = nn.Parameter(torch.ones(tuple(shape)))
        self.bias = nn.Parameter(torch.zeros(tuple(shape)))

    def forward(self, x, sp=None, act: Optional[str] = None):
        """``act``: the GELU after the norm ("gelu_tanh", "gelu"; None:
        none)."""
        # a shard's statistics are summed over the model axis in the eager
        # code
        if sp is None and kernel_path(self, x):
            return ln_kernel.layer_norm(x.contiguous(), self.weight,
                                        self.bias, eps=self.eps,
                                        out_dtype=x.dtype,
                                        act=act or "none")
        weight, bias = self.weight, self.bias
        if sp is None:
            mean, var = fp32_moments(x, (-3, -2, -1))
        else:
            xf, dims = x.float(), (-3, -2, -1)
            count = x.shape[-3] * x.shape[-2] * x.shape[-1] * sp.size
            with span("norm_stats"):
                sums = all_reduce_sum(torch.stack(
                    [xf.sum(dims), (xf * xf).sum(dims)], -1), sp) / count
            mean = sums[..., 0, None, None, None]
            var = torch.clamp(sums[..., 1, None, None, None] - mean * mean,
                              min=0.0)
            h = x.shape[-3]
            weight = sp_param(weight, sp).narrow(0, sp.rank * h, h)
            bias = sp_param(bias, sp).narrow(0, sp.rank * h, h)
        inv = torch.rsqrt(var + self.eps)
        a = (inv * weight).to(x.dtype)
        b = (bias - mean * inv * weight).to(x.dtype)
        y = x * a + b
        if act is None:
            return y
        return F.gelu(y, approximate="tanh" if act == "gelu_tanh" else "none")


class DropPath(nn.Module):
    """Stochastic depth per sample: each leading-axis sample is kept with
    probability 1 − rate and scaled by 1 / (1 − rate), or zeroed. The
    identity at rate 0 or in eval mode."""

    def __init__(self, rate: float = 0.0):
        super().__init__()
        self.rate = rate

    def forward(self, x, rng: Optional[Rng] = None):
        if not self.training or self.rate == 0.0:
            return x
        keep_prob = 1.0 - self.rate
        shape = (x.shape[0],) + (1,) * (x.dim() - 1)
        keep = _need(rng, "DropPath").bernoulli(shape, keep_prob, x.device)
        return x * (keep / keep_prob).to(x.dtype)


class ConvBNAct(nn.Module):
    """Conv → BatchNorm → activation on (N, H, W, C). ``"TORCH_SAME"``
    pads k//2 on both sides whatever the stride (torch ``Conv2d(padding=
    k//2)``); ``"VALID"`` pads nothing. The module's mode is flax's
    ``train`` flag: in training mode the BatchNorm uses and updates batch
    statistics."""

    def __init__(self, in_features: int, features: int, kernel_size=3,
                 stride: int = 1, padding: str = "TORCH_SAME",
                 use_bias: bool = False, activation: Optional[str] = "relu",
                 groups: int = 1, dtype=torch.float32):
        super().__init__()
        if padding not in ("TORCH_SAME", "VALID"):
            raise ValueError(f"unsupported padding {padding!r}")
        pad = kernel_size // 2 if padding == "TORCH_SAME" else 0
        self.conv = nn.Conv2d(in_features, features, kernel_size, stride,
                              pad, groups=groups, bias=use_bias)
        self.bn = BatchNorm(features, eps=1e-5, dtype=dtype)
        self.activation, self.dtype = activation, dtype

    def forward(self, x):
        x = self.bn(conv_nhwc(x, self.conv, self.dtype))
        return torch.relu(x) if self.activation == "relu" else x
