"""The AE's non-local attention after its fused projection: the hand-written
CUDA kernel, its wrapper, and its plain PyTorch twin.

Replaces no TPU kernel: XLA fused the attention's einsums and softmax on the
TPU. Eagerly, ``nn.resnet_ae.NonLocalAttention2D`` wrote its (H·W)×(H·W/4)
logits to device memory in fp32 and passed over them about ten times; the
kernel (``csrc/nonlocal_attention.cu``) keeps them on chip. It takes the
fused projection's ``qkv`` (N, H, W, 2a + dv) as ``F.linear`` writes it
(q, k, v side by side on the last axis), pools k and v 2×2, and returns the
attention's output (N, H, W, dv) in bf16, in the roundings of the twin
(:func:`nonlocal_attention_plain`): logits accumulated in fp32 and rounded
once to bf16, the row max over the rounded logits, the subtraction rounded
once, exp and row sum in fp32, P·V accumulated in fp32; the one reordering
is that the kernel divides the P·V sum by the row sum where the twin rounds
the divided weights. Two launches a call (a pooling pre-pass, then the
attention).

The kernel is the torch op ``torch.ops.npvp.nonlocal_attention``, under
``_nvcc``'s rules: :func:`nonlocal_attention` launches it on a plain CUDA
tensor without the op's dispatcher. The module reaches it on
``nn.layers.kernel_path``.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from npvp_tpu_torch.kernels import _nvcc
from npvp_tpu_torch.kernels.numerics import softmax_f32_stats

# Calls by their query count H·W (one call = the pooling pre-pass and the
# attention kernel). The wrapper adds one per call; nothing else touches it
# but a caller that resets it.
LAUNCHES = {}

LIB = _nvcc.Library("nonlocal_attention.cu", "libnonlocal_attention", {
    "npvp_nonlocal_attention_launch": [ctypes.c_void_p] * 4
    + [ctypes.c_int] * 5 + [ctypes.c_void_p]})
ATTN_DIMS = (8, 16, 32, 64)
VALUE_DIMS = (32, 64, 128, 256)
MAX_SMEM = 232448  # dynamic shared memory a block may have on an H100


def max_pool_2x2(x):
    """2×2 max pool, stride 2, of a channels-last (N, H, W, C) tensor."""
    return F.max_pool2d(x.permute(0, 3, 1, 2), 2, 2).permute(0, 2, 3, 1)


def nonlocal_attention_plain(qkv, attn_dim: int):
    """The plain PyTorch twin of the kernel, and the module's eager path:
    q, k, v = the last axis of ``qkv`` cut at ``attn_dim`` and
    ``2·attn_dim``; k and v max-pooled 2×2; unscaled logits accumulated in
    fp32 and kept in ``qkv``'s dtype, softmax with fp32 statistics; the
    weighted sum of the pooled values."""
    a = attn_dim
    q, k, v = qkv[..., :a], qkv[..., a:2 * a], qkv[..., 2 * a:]
    k, v = max_pool_2x2(k), max_pool_2x2(v)
    logits = torch.einsum("nhwa,nija->nhwij", q.float(),
                          k.float()).to(qkv.dtype)
    weights = softmax_f32_stats(logits, (-2, -1))
    return torch.einsum("nhwij,nijv->nhwv", weights, v)


def _keys16(H: int, W: int) -> int:
    return -(-(H // 2) * (W // 2) // 16) * 16


def takes(shape, attn_dim: int) -> bool:
    """Whether the kernel takes a ``qkv`` of ``shape`` cut at
    ``attn_dim``: a in {8, 16, 32, 64}, dv in {32, 64, 128, 256}, at least
    one pooled key, and the image's pooled K (rows of a, padded by 8 above
    8) and V^T (rows of the padded key count plus 8) within one block's
    shared memory (every level of the KTH, SMMNIST and Cityscapes AEs)."""
    if len(shape) != 4:
        return False
    N, H, W, C3 = shape
    dv, k16 = C3 - 2 * attn_dim, _keys16(H, W)
    smem = 2 * (k16 * (attn_dim if attn_dim == 8 else attn_dim + 8)
                + dv * (k16 + 8))
    return (attn_dim in ATTN_DIMS and dv in VALUE_DIMS and N > 0
            and H >= 2 and W >= 2 and smem <= MAX_SMEM)


def nonlocal_attention(qkv, attn_dim: int):
    """The non-local attention of the fused projection's ``qkv`` (N, H, W,
    2·attn_dim + dv): (N, H, W, dv) in ``qkv``'s dtype. Raises under
    autograd: call it under ``torch.no_grad()`` or with an input that needs
    no gradient. A plain CUDA tensor goes to the kernel (:func:`launch`);
    anything else (a CPU tensor, a tensor that ``torch.export`` traces) to
    the op ``npvp::nonlocal_attention``."""
    _nvcc.refuse_autograd("nonlocal_attention", qkv)
    if _nvcc.direct(qkv):
        return launch(qkv, attn_dim)
    return torch.ops.npvp.nonlocal_attention(qkv, attn_dim)


@torch.library.custom_op("npvp::nonlocal_attention", mutates_args=(),
                         device_types="cuda")
def _nonlocal_attention_op(qkv: torch.Tensor,
                           attn_dim: int) -> torch.Tensor:
    return launch(qkv, attn_dim)


@_nonlocal_attention_op.register_kernel("cpu")
def _nonlocal_attention_cpu(qkv, attn_dim):
    return nonlocal_attention_plain(qkv, attn_dim)


@_nonlocal_attention_op.register_fake
def _nonlocal_attention_fake(qkv, attn_dim):
    N, H, W, C3 = qkv.shape
    return qkv.new_empty((N, H, W, C3 - 2 * attn_dim))


def launch(qkv, attn_dim: int):
    """The kernel on a CUDA tensor, no dispatcher between: checks the dtype,
    shape, contiguity and alignment, allocates the pooled K/V scratch and
    the output, launches both kernels on the current stream, raises on a
    launch error and counts the call. The op's CUDA implementation."""
    if qkv.dtype != torch.bfloat16:
        raise ValueError(f"unsupported dtype {qkv.dtype} (bf16 only)")
    if not takes(tuple(qkv.shape), attn_dim):
        raise ValueError(f"unsupported shape {tuple(qkv.shape)} at "
                         f"attn_dim {attn_dim}: a in {ATTN_DIMS}, dv in "
                         f"{VALUE_DIMS}, H, W >= 2, pooled K and V within "
                         f"{MAX_SMEM} B of shared memory")
    if not qkv.is_contiguous() or qkv.data_ptr() % 16:
        raise ValueError("qkv must be contiguous and 16-byte aligned")
    N, H, W, C3 = qkv.shape
    dv, k16 = C3 - 2 * attn_dim, _keys16(H, W)
    dev = qkv.device
    kp = torch.empty((N, k16, attn_dim), dtype=qkv.dtype, device=dev)
    vt = torch.empty((N, dv, k16), dtype=qkv.dtype, device=dev)
    out = torch.empty((N, H, W, dv), dtype=qkv.dtype, device=dev)
    LIB.launch("npvp_nonlocal_attention_launch", dev, qkv.data_ptr(),
               kp.data_ptr(), vt.data_ptr(), out.data_ptr(), N, H, W,
               attn_dim, dv)
    LAUNCHES[H * W] = LAUNCHES.get(H * W, 0) + 1
    return out
