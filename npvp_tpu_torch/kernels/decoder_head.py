"""The AE decoder's tail: the hand-written CUDA kernel, its wrapper, and its
plain PyTorch twin.

Replaces no TPU kernel: XLA fused the decoder's output stage on the TPU.
Eagerly, ``nn.resnet_ae.ResnetDecoder`` passed over the last upsampling's
output, the AE's largest tensor, about six times (the BatchNorm's multiply
and add, the ReLU, the padded copy) and ran the 7×7 head in cuDNN with
tiles of 64 output channels for its 1 or 3. The kernel
(``csrc/decoder_head.cu``) reads that output once: it takes the last
transposed convolution's raw output ``y`` (N, H, W, C_in), applies the
BatchNorm's eval affine ``(a, b)`` and the ReLU, reflect-pads by 3 as it
reads, convolves with the head and adds its bias, applies Tanh or Sigmoid,
and writes (N, H, W, C_out), in the roundings of the twin
(:func:`decoder_head_plain`): the affine and ReLU bit-equal, the head's
products accumulated in fp32 and rounded once, the bias added and rounded,
the activation in fp32 and rounded once; only the order of the head's sum
differs. Two launches a call: a small pre-pass packs the head's weights
into mma fragments, then the tail.

The kernel is the torch op ``torch.ops.npvp.decoder_head``, under
``_nvcc``'s rules: :func:`decoder_head` launches it on a plain CUDA tensor
without the op's dispatcher. The decoder reaches it on
``nn.layers.kernel_path``.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from npvp_tpu_torch.kernels import _nvcc
from npvp_tpu_torch.kernels.numerics import reflect_pad_2d

# Calls by their frame size H·W. The wrapper adds one per call; nothing else
# touches it but a caller that resets it.
LAUNCHES = {}

LIB = _nvcc.Library("decoder_head.cu", "libdecoder_head", {
    "npvp_decoder_head_launch": [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6
    + [ctypes.c_void_p]})
IN_CHANNELS = (32, 64)
OUT_CHANNELS = (1, 3)
OUT_LAYERS = ("Tanh", "Sigmoid")
TAPS, PAD = 7, 3


def frag_words(in_channels: int, out_channels: int) -> int:
    """32-bit words of the head's weights packed as mma B fragments: 7 tap
    rows × C_in / 16 k steps × ceil(7·C_out / 8) n tiles × 64."""
    return TAPS * in_channels // 16 * -(-TAPS * out_channels // 8) * 64


def decoder_head_plain(y, a, b, weight, bias, out_layer: str):
    """The plain PyTorch twin of the kernel, and the decoder's eager tail:
    ``relu(y·a + b)`` in ``a``'s dtype (the BatchNorm's affine as it
    computes it), reflect-padded by 3, the 7×7 ``weight`` (C_out, C_in, 7,
    7) with ``bias``, then Tanh or Sigmoid; (N, H, W, C_out)."""
    x = reflect_pad_2d(torch.relu(y.to(a.dtype) * a + b), PAD)
    x = F.conv2d(x.permute(0, 3, 1, 2), weight, bias).permute(0, 2, 3, 1)
    return torch.tanh(x) if out_layer == "Tanh" else torch.sigmoid(x)


def takes(shape, weight_shape, out_layer: str) -> bool:
    """Whether the kernel takes a ``y`` of ``shape`` and a head of
    ``weight_shape``: C_in in {32, 64} (every published AE's last
    upsampling), C_out in {1, 3}, a 7×7 head, frames larger than the
    padding, Tanh or Sigmoid."""
    if len(shape) != 4 or len(weight_shape) != 4:
        return False
    N, H, W, C = shape
    co, ci, kh, kw = weight_shape
    return (C in IN_CHANNELS and ci == C and co in OUT_CHANNELS
            and kh == kw == TAPS and N > 0 and H > PAD and W > PAD
            and out_layer in OUT_LAYERS)


def decoder_head(y, a, b, weight, bias, out_layer: str):
    """The decoder's tail on the last upsampling's raw output ``y`` (N, H,
    W, C_in): (N, H, W, C_out) in ``y``'s dtype. Raises under autograd:
    call it under ``torch.no_grad()`` or with inputs that need no
    gradient. A plain CUDA tensor goes to the kernel (:func:`launch`);
    anything else (a CPU tensor, a tensor that ``torch.export`` traces) to
    the op ``npvp::decoder_head``."""
    _nvcc.refuse_autograd("decoder_head", y, a, b, weight, bias)
    if _nvcc.direct(y):
        return launch(y, a, b, weight, bias, out_layer)
    return torch.ops.npvp.decoder_head(y, a, b, weight, bias, out_layer)


@torch.library.custom_op("npvp::decoder_head", mutates_args=(),
                         device_types="cuda")
def _decoder_head_op(y: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                     weight: torch.Tensor, bias: torch.Tensor,
                     out_layer: str) -> torch.Tensor:
    return launch(y, a, b, weight, bias, out_layer)


@_decoder_head_op.register_kernel("cpu")
def _decoder_head_cpu(y, a, b, weight, bias, out_layer):
    return decoder_head_plain(y, a, b, weight, bias, out_layer)


@_decoder_head_op.register_fake
def _decoder_head_fake(y, a, b, weight, bias, out_layer):
    N, H, W, _ = y.shape
    return y.new_empty((N, H, W, weight.shape[0]))


def launch(y, a, b, weight, bias, out_layer: str):
    """The kernel on CUDA tensors, no dispatcher between: checks dtypes,
    shapes, contiguity and alignment, allocates the packed weights' scratch
    and the output, launches on the current stream, raises on a launch
    error and counts the call. The op's CUDA implementation."""
    tensors = (y, a, b, weight, bias)
    if any(t.dtype != torch.bfloat16 for t in tensors):
        raise ValueError(f"unsupported dtypes {[t.dtype for t in tensors]} "
                         "(bf16 only)")
    if not takes(tuple(y.shape), tuple(weight.shape), out_layer):
        raise ValueError(
            f"unsupported shape {tuple(y.shape)} with head "
            f"{tuple(weight.shape)} and {out_layer!r}: C_in in "
            f"{IN_CHANNELS}, C_out in {OUT_CHANNELS}, a {TAPS}x{TAPS} head, "
            f"H, W > {PAD}, out_layer in {OUT_LAYERS}")
    C, co = y.shape[3], weight.shape[0]
    if tuple(a.shape) != (C,) or tuple(b.shape) != (C,) or tuple(
            bias.shape) != (co,):
        raise ValueError(f"affine {tuple(a.shape)}, {tuple(b.shape)} and "
                         f"bias {tuple(bias.shape)} do not fit C_in {C}, "
                         f"C_out {co}")
    if any(t.device != y.device for t in tensors):
        raise ValueError("y, a, b, weight and bias must be on one device")
    if any(not t.is_contiguous() for t in tensors) or any(
            t.data_ptr() % 16 for t in (y, a, b)):
        raise ValueError("y, a, b, weight and bias must be contiguous, and "
                         "y, a and b 16-byte aligned")
    N, H, W, _ = y.shape
    frag = torch.empty(frag_words(C, co), dtype=torch.int32, device=y.device)
    out = torch.empty((N, H, W, co), dtype=y.dtype, device=y.device)
    LIB.launch("npvp_decoder_head_launch", y.device, y.data_ptr(),
               a.data_ptr(), b.data_ptr(), weight.data_ptr(),
               bias.data_ptr(), frag.data_ptr(), out.data_ptr(), N, H, W, C,
               co, OUT_LAYERS.index(out_layer))
    LAUNCHES[H * W] = LAUNCHES.get(H * W, 0) + 1
    return out
