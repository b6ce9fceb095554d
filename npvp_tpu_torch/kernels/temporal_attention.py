"""Per-site attention with the output projection fused: the hand-written
CUDA kernel, its wrapper, and its plain PyTorch twin.

Replaces ``npvp_tpu/kernels/temporal_attention.py`` (``_kernel_oproj`` and
``_kernel``, the two ``pl.pallas_call`` sites). Every (h, w) site — or every
attention window — attends over its own short token series: q (B, Tq, H·D),
k/v (B, Tk, H·D), an optional (Tq, Tk) fp32 additive bias of 0 or
``finfo.min`` shared by all sites, and optionally the output projection wo
(C, H·D) — ``nn.Linear.weight`` as it stands, the transpose of the JAX
kernel's (H·D, C) — and bo (C,). Per head: fp32 logits ``q_h·k_hᵀ/√hd +
bias``, fp32 softmax, weights cast to the compute dtype, ``ctx_h = w·v_h``
accumulated in fp32; then either ``ctx`` (B, Tq, H·D) or ``Σ_h ctx_h·wo_hᵀ
+ bo`` (B, Tq, C) accumulated in fp32, stored in the compute dtype (float32
or bfloat16).

The kernel is the torch op ``torch.ops.npvp.temporal_attention`` (both
variants: ``wo`` None or given), under ``_nvcc``'s rules; importing this
module registers it, and a serving bundle keeps it as one call. Unlike the
other wrappers, :func:`temporal_attention` calls the op on a CUDA tensor
too, so that a profiler records each call's shapes. The call sites reach it
on ``nn.layers.kernel_path``, as the JAX package reaches its kernel only
when ``deterministic``, and always fuse the output projection; the
attention-only variant stays reachable with ``wo=None``.
"""

from __future__ import annotations

import ctypes
import math
import weakref
from typing import Optional

import torch

from npvp_tpu_torch.kernels import _nvcc

NEG_INF = float(torch.finfo(torch.float32).min)

# Launches of each kernel variant; the wrapper adds one per launch, and
# nothing else touches them but a caller that resets them.
LAUNCHES = {"oproj": 0, "attn": 0}

LIB = _nvcc.Library("temporal_attention.cu", "libtemporal_attention", {
    "temporal_attention_launch": [ctypes.c_void_p] * 7 + [ctypes.c_int] * 8
    + [ctypes.c_void_p],
    "temporal_attention_smem_bytes": [ctypes.c_int] * 6})
# the kernel keeps a tile of sites whose tokens fit 64 rows
MAX_TOKENS = 64
# the bf16 kernel's heads are 64 wide (one 128-byte row) and its fused
# variant keeps the context of at most 8 heads in shared memory
HEAD_DIM_BF16, MAX_FUSED_HEADS_BF16 = 64, 8


def allow_to_bias(allow) -> torch.Tensor:
    """Boolean (Tq, Tk) allow matrix (True = attend) → fp32 additive bias."""
    zero = torch.zeros((), dtype=torch.float32, device=allow.device)
    return torch.where(allow, zero, torch.full_like(zero, NEG_INF))


def temporal_attention_plain(q, k, v, bias=None, *, num_heads: int, wo=None,
                             bo=None):
    """The plain PyTorch twin of the kernel: the same function, step by
    step, in ordinary tensor ops."""
    B, Tq, HD = q.shape
    Tk = k.shape[1]
    hd = HD // num_heads
    heads = lambda t, T: t.reshape(B, T, num_heads, hd).transpose(1, 2)  # noqa
    logits = heads(q, Tq).float() @ heads(k, Tk).float().transpose(-1, -2)
    logits = logits * (1.0 / math.sqrt(hd))
    if bias is not None:
        logits = logits + bias.float()
    w = torch.softmax(logits, dim=-1).to(q.dtype)
    ctx = (w.float() @ heads(v, Tk).float()).transpose(1, 2)
    ctx = ctx.reshape(B, Tq, HD).to(q.dtype)
    if wo is None:
        return ctx
    out = ctx.float() @ wo.to(q.dtype).float().t()
    if bo is not None:
        out = out + bo.float()
    return out.to(q.dtype)


def takes(HD: int, num_heads: int, dtype, C: Optional[int] = None,
          tokens: int = 1) -> bool:
    """Whether the kernel takes ``num_heads`` heads of H·D = ``HD`` in
    ``dtype`` over sites of at most ``tokens`` queries and keys, with the
    output projection to ``C`` channels fused (None: attention only): at
    most 64 tokens; in bfloat16 heads of 64 and, fused, at most 8 heads and
    C a multiple of 8 (the Hopper kernel's 128-byte rows, its shared memory
    and its TMA strides)."""
    bf16 = dtype == torch.bfloat16
    return (HD % num_heads == 0 and tokens <= MAX_TOKENS
            and not (bf16 and HD != HEAD_DIM_BF16 * num_heads)
            and not (bf16 and C is not None
                     and (num_heads > MAX_FUSED_HEADS_BF16 or C % 8)))


def smem_bytes(Tq: int, Tk: int, HD: int, num_heads: int, dtype,
               fuse: bool) -> int:
    """Dynamic shared memory of one block of the kernel, in bytes."""
    return LIB.load().temporal_attention_smem_bytes(
        Tq, Tk, HD, num_heads, 1 if dtype == torch.bfloat16 else 0,
        int(fuse))


def _ptr(t):
    return None if t is None else t.data_ptr()


# wo cast to the compute dtype, one entry per weight tensor, kept until the
# weight is freed
_WO_CAST = {}


def wo_operand(wo, dtype):
    """``wo`` in ``dtype``, contiguous: the tensor itself where it already
    is, else a copy made once per weight and value and reused, so that a
    serving forward casts no weight at its calls. A hit needs the same
    tensor, version and storage. A weight that is being trained (it
    requires grad) must also hold the same values: FSDP all-gathers such a
    weight into the same parameter before each forward and keeps its
    storage and version counter, so only the values show the change
    (compared on the device, one read of the weight and a wait for the
    result). A frozen weight, as served, is not read: the serving forward
    waits for nothing."""
    if wo.dtype == dtype and wo.is_contiguous():
        return wo
    key = (id(wo), dtype)
    hit = _WO_CAST.get(key)
    if (hit is not None and hit[0]() is wo and hit[1] == wo._version
            and hit[2] == wo.data_ptr()
            and (hit[3] is None or torch.equal(hit[3], wo))):
        return hit[4]
    values = wo.detach().clone() if wo.requires_grad else None
    cast = wo.detach().to(dtype).contiguous()
    ref = weakref.ref(wo, lambda _: _WO_CAST.pop(key, None))
    _WO_CAST[key] = (ref, wo._version, wo.data_ptr(), values, cast)
    return cast


def temporal_attention(q, k, v, bias=None, *, num_heads: int, wo=None,
                       bo=None):
    """Per-site attention: q (B, Tq, H·D), k/v (B, Tk, H·D) → (B, Tq, H·D),
    or (B, Tq, C) with the output projection wo (C, H·D) (``nn.Linear``'s
    weight), bo (C,) fused in. ``bias`` is an optional (Tq, Tk) additive
    mask (:func:`allow_to_bias`). Any B; Tq, Tk ≤ 64; in bfloat16 heads of
    64 and, fused, at most 8 heads and C a multiple of 8 (the Hopper
    kernel's 128-byte rows, its shared memory and its TMA strides).
    Raises under autograd: call it under ``torch.no_grad()`` or with inputs
    that need no gradient. Calls the op ``npvp::temporal_attention``: the
    kernel on a CUDA tensor, the plain twin on a CPU one."""
    _nvcc.refuse_autograd("temporal_attention", q, k, v, bias, wo, bo)
    _nvcc.check_device(q)
    return torch.ops.npvp.temporal_attention(q, k, v, bias, wo, bo,
                                             num_heads)


@torch.library.custom_op("npvp::temporal_attention", mutates_args=(),
                         device_types="cuda")
def _temporal_attention_op(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, bias: Optional[torch.Tensor],
                           wo: Optional[torch.Tensor],
                           bo: Optional[torch.Tensor],
                           num_heads: int) -> torch.Tensor:
    return launch(q, k, v, bias, wo, bo, num_heads)


@_temporal_attention_op.register_kernel("cpu")
def _temporal_attention_cpu(q, k, v, bias, wo, bo, num_heads):
    return temporal_attention_plain(q, k, v, bias, num_heads=num_heads,
                                    wo=wo, bo=bo)


@_temporal_attention_op.register_fake
def _temporal_attention_fake(q, k, v, bias, wo, bo, num_heads):
    C = q.shape[-1] if wo is None else wo.shape[0]
    return q.new_empty((q.shape[0], q.shape[1], C))


def launch(q, k, v, bias, wo, bo, num_heads: int):
    """The kernel on CUDA tensors, no dispatcher between: checks the
    shapes, casts ``wo`` once per weight (:func:`wo_operand`), allocates
    the output, launches on the current stream, raises on a launch error
    and counts the launch. The op's CUDA implementation."""
    B, Tq, HD = q.shape
    Tk = k.shape[1]
    if k.shape != (B, Tk, HD) or v.shape != k.shape:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} do not match")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"unsupported dtype {q.dtype}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError("q, k and v must share one dtype")
    if B == 0 or not takes(HD, num_heads, q.dtype,
                           None if wo is None else wo.shape[0], max(Tq, Tk)):
        raise ValueError(f"unsupported shape B={B} Tq={Tq} Tk={Tk} "
                         f"HD={HD} heads={num_heads}")
    dev = q.device
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    if bias is not None:
        if bias.shape != (Tq, Tk):
            raise ValueError(f"bias {tuple(bias.shape)} is not ({Tq}, {Tk})")
        bias = bias.to(device=dev, dtype=torch.float32).contiguous()
    C = HD
    if wo is not None:
        if wo.dim() != 2 or wo.shape[1] != HD or wo.device != dev:
            raise ValueError(f"wo {tuple(wo.shape)} on {wo.device} is not "
                             f"(C, {HD}) on {dev}")
        C = wo.shape[0]
        wo = wo_operand(wo, q.dtype)
        bo = (torch.zeros(C, device=dev) if bo is None
              else bo.to(device=dev, dtype=torch.float32).contiguous())
    out = torch.empty((B, Tq, C), dtype=q.dtype, device=dev)
    LIB.launch("temporal_attention_launch", dev, _ptr(q), _ptr(k), _ptr(v),
               _ptr(bias), _ptr(wo), _ptr(bo), _ptr(out), B, Tq, Tk, HD,
               num_heads, C, 1 if q.dtype == torch.bfloat16 else 0,
               0 if wo is None else 1)
    LAUNCHES["attn" if wo is None else "oproj"] += 1
    return out
