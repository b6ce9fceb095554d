"""Dynamic int8 quantization for the serving path (port of
``npvp_tpu/nn/quant.py``).

With ``exec_mode="int8"`` the predictor's projections and feed-forward
products run on int8 operands:

- activations are quantized per row (abs-max over the contracted features,
  one float32 scale per row);
- weights are quantized per output channel (abs-max over the fan-in);
- the product is int8×int8 → int32 (``torch._int_mm``, a library product,
  as the JAX package leaves its ``dot_general`` to XLA) and is rescaled by
  the two scale vectors.

Weights stay float32 in the modules (one parameter set for every execution
mode) and are quantized at each use. Rounding has no gradient, so under
autograd only the scales carry one, as in the JAX package.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

_EPS = 1e-8

# When set, every activation quantization uses this fixed scale instead of
# the per-row abs-max (the static-calibration experiment of the JAX
# package); read at call time.
STATIC_ACT_SCALE = None


def quantize_rowwise(x, n_contract: int = 1):
    """``(q, scale)``: ``x`` quantized to int8 with one scale per row, the
    trailing ``n_contract`` axes being the contracted ones. ``q =
    round(x / scale)`` clipped to [-127, 127]; ``scale`` is float32 with the
    row shape (keepdim). With :data:`STATIC_ACT_SCALE` set, ``scale`` is
    that constant, shaped ``(1,) * x.dim()``."""
    xf = x.float()
    if STATIC_ACT_SCALE is not None:
        scale = torch.full((1,) * x.dim(), float(STATIC_ACT_SCALE),
                           dtype=torch.float32, device=x.device)
    else:
        dims = tuple(range(x.dim() - n_contract, x.dim()))
        amax = xf.abs().amax(dim=dims, keepdim=True)
        scale = torch.clamp(amax, min=_EPS) / 127.0
    q = torch.clamp(torch.round(xf / scale), -127, 127)
    return q.to(torch.int8), scale


def quantize_colwise(w, n_contract: int = 1):
    """``(q, scale)``: a weight quantized to int8 with one scale per output
    channel, the *leading* ``n_contract`` axes being the fan-in; ``scale``
    is float32, keepdim over the fan-in."""
    wf = w.float()
    amax = wf.abs().amax(dim=tuple(range(n_contract)), keepdim=True)
    scale = torch.clamp(amax, min=_EPS) / 127.0
    q = torch.clamp(torch.round(wf / scale), -127, 127)
    return q.to(torch.int8), scale


def _pad_to(t, rows: int, cols: int):
    return F.pad(t, (0, cols - t.shape[1], 0, rows - t.shape[0]))


def int8_matmul(a, b):
    """int32 (M, N) product of int8 (M, K) and (K, N) matrices. On the card
    ``torch._int_mm`` takes M > 16 and K, N multiples of 8: smaller or
    ragged operands are padded with zeros, which add nothing to the
    sums."""
    M, K = a.shape
    N = b.shape[1]
    if a.device.type == "cuda":
        Mp, Kp, Np = max(M, 17), -(-K // 8) * 8, -(-N // 8) * 8
        if (Mp, Kp, Np) != (M, K, N):
            return torch._int_mm(_pad_to(a, Mp, Kp),
                                 _pad_to(b, Kp, Np))[:M, :N]
    return torch._int_mm(a.contiguous(), b.contiguous())


def int8_contract(x, w, n_contract: int = 1, out_dtype=torch.bfloat16):
    """``x · w`` with both operands dynamically quantized to int8: the
    trailing ``n_contract`` axes of ``x`` contract with the leading
    ``n_contract`` axes of ``w``; int32 sums rescaled by the row scale of
    ``x`` times the column scale of ``w``, in float32, then cast to
    ``out_dtype``."""
    qx, sx = quantize_rowwise(x, n_contract)
    qw, sw = quantize_colwise(w, n_contract)
    lead, out = x.shape[:x.dim() - n_contract], w.shape[n_contract:]
    K = math.prod(w.shape[:n_contract])
    acc = int8_matmul(qx.reshape(-1, K), qw.reshape(K, -1))
    y = acc.float() * sx.reshape(-1, 1) * sw.reshape(1, -1)
    return y.reshape(lead + out).to(out_dtype)
