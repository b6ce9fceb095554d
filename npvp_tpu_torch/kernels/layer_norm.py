"""Row-wise LayerNorm with an optional GELU epilogue: the hand-written CUDA
kernel, its wrapper, and its plain PyTorch twin.

Replaces no TPU kernel: XLA fused the predictor's norms into their
neighbours on the TPU. Eagerly, each of the predictor's norms
(``nn.layers.TokenLayerNorm`` over C, ``nn.layers.LayerNormHWC`` over
(H, W, C)) ran as ~17 passes over its input; the kernel
(``csrc/layer_norm.cu``) reads each row once and writes it once. Each
contiguous row of length L = ``weight.numel()`` (the trailing axes that
``weight`` covers) is normalised with fp32 statistics in the form every norm
of the port shares (mean and E[x²] − mean², clamped at 0, then
``rsqrt(var + eps)``), the fp32 affine is applied in fp32, optionally
followed by the GELU of ``nn.vidhrformer._gelu_for`` (``"gelu_tanh"``, the
tanh form that bf16 takes, or ``"gelu"``, the exact form of fp32), and the
result is rounded once to ``out_dtype``. Input and output are float32 or
bfloat16.

The kernel is the torch op ``torch.ops.npvp.layer_norm``, under ``_nvcc``'s
rules: :func:`layer_norm` launches it on a plain CUDA tensor without the
op's dispatcher (its host cost would be paid 126 times a forward). The
norms reach it on ``nn.layers.kernel_path``.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from npvp_tpu_torch.kernels import _nvcc
from npvp_tpu_torch.kernels.numerics import fp32_moments

# Launches by the norm that asked: "hwc" (an (H, W, C) affine), "token" (a
# (C,) affine). The wrapper adds one per launch; nothing else touches them
# but a caller that resets them.
LAUNCHES = {"hwc": 0, "token": 0}

ACTS = {"none": 0, "gelu_tanh": 1, "gelu": 2}
LIB = _nvcc.Library("layer_norm.cu", "liblayer_norm", {
    "npvp_layer_norm_launch": [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4
    + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]})
# the kernel's longest row: a cluster of 16 blocks of 256 threads, 32
# elements a thread
MAX_LEN = 16 * 256 * 32


def layer_norm_plain(x, weight, bias, eps: float, out_dtype,
                     act: str = "none"):
    """The plain PyTorch twin of the kernel: the norms' eager code step by
    step (:func:`~npvp_tpu_torch.kernels.numerics.fp32_moments`, then the
    affine), with the affine and the GELU in fp32 and one rounding to
    ``out_dtype``. In float32 it is bit for bit the norms' eager path (and
    the GELU after it)."""
    mean, var = fp32_moments(x, tuple(range(-weight.dim(), 0)))
    inv = torch.rsqrt(var + eps)
    a = inv * weight
    b = bias - mean * inv * weight
    y = x.float() * a + b
    if act != "none":
        y = F.gelu(y, approximate="tanh" if act == "gelu_tanh" else "none")
    return y.to(out_dtype)


def layer_norm(x, weight, bias, *, eps: float, out_dtype,
               act: str = "none"):
    """LayerNorm of ``x`` over its trailing ``weight.dim()`` axes (which
    match ``weight.shape``) with the fp32 affine (``weight``, ``bias``) and
    the GELU ``act`` ("none", "gelu_tanh", "gelu"), rounded once to
    ``out_dtype``. Raises under autograd: call it under ``torch.no_grad()``
    or with inputs that need no gradient. A plain CUDA tensor goes to the
    kernel (:func:`launch`); anything else (a CPU tensor, a tensor that
    ``torch.export`` traces) to the op ``npvp::layer_norm``."""
    _nvcc.refuse_autograd("layer_norm", x, weight, bias)
    if _nvcc.direct(x):
        return launch(x, weight, bias, eps, out_dtype, act)
    return torch.ops.npvp.layer_norm(x, weight, bias, eps, out_dtype, act)


@torch.library.custom_op("npvp::layer_norm", mutates_args=(),
                         device_types="cuda")
def _layer_norm_op(x: torch.Tensor, weight: torch.Tensor,
                   bias: torch.Tensor, eps: float, out_dtype: torch.dtype,
                   act: str) -> torch.Tensor:
    return launch(x, weight, bias, eps, out_dtype, act)


@_layer_norm_op.register_kernel("cpu")
def _layer_norm_cpu(x, weight, bias, eps, out_dtype, act):
    return layer_norm_plain(x, weight, bias, eps, out_dtype, act)


@_layer_norm_op.register_fake
def _layer_norm_fake(x, weight, bias, eps, out_dtype, act):
    return x.new_empty(x.shape, dtype=out_dtype)


def _operand(t, dev):
    """An affine parameter as the kernel reads it: fp32, contiguous, on
    ``dev`` (the parameter itself where it already is)."""
    if t.device != dev:
        raise ValueError(f"parameter on {t.device}, input on {dev}")
    return t.detach().to(torch.float32).contiguous()


def launch(x, weight, bias, eps: float, out_dtype, act: str = "none"):
    """The kernel on a CUDA tensor, no dispatcher between: checks dtypes,
    shapes, contiguity and alignment, allocates the output, launches on the
    current stream, raises on a launch error and counts the launch. The
    op's CUDA implementation."""
    supported = (torch.float32, torch.bfloat16)
    if x.dtype not in supported or out_dtype not in supported:
        raise ValueError(f"unsupported dtypes {x.dtype} -> {out_dtype}")
    if act not in ACTS:
        raise ValueError(f"unknown activation {act!r}")
    nd = weight.dim()
    if (nd == 0 or x.dim() < nd or tuple(x.shape[-nd:]) != tuple(weight.shape)
            or bias.shape != weight.shape):
        raise ValueError(f"x {tuple(x.shape)}, weight {tuple(weight.shape)}, "
                         f"bias {tuple(bias.shape)} do not match")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    L = weight.numel()
    rows = x.numel() // L
    vec = 8 if x.dtype == torch.bfloat16 else 4
    if rows == 0 or L % vec or L > MAX_LEN or x.data_ptr() % 16:
        raise ValueError(f"unsupported shape: {rows} rows of {L} "
                         f"{x.dtype} (rows of a multiple of {vec}, at most "
                         f"{MAX_LEN}, 16-byte aligned)")
    dev = x.device
    w, b = _operand(weight, dev), _operand(bias, dev)
    out = torch.empty(x.shape, dtype=out_dtype, device=dev)
    LIB.launch("npvp_layer_norm_launch", dev, x.data_ptr(), w.data_ptr(),
               b.data_ptr(), out.data_ptr(), rows, L,
               int(x.dtype == torch.bfloat16), int(out_dtype == torch.bfloat16),
               float(eps), ACTS[act])
    LAUNCHES["token" if nd == 1 else "hwc"] += 1
    return out
