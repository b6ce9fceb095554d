"""Operations and bytes: the attention kernel's per call, from its shapes,
and a whole forward's or train step's, counted on the plain reference.

Peaks are NVIDIA's H100 SXM data sheet (dense): 989 TFLOP/s in bf16 on
the tensor cores, 67 TFLOP/s in float32 outside them, 3.35 TB/s of HBM.
They assume the card's full 700 W; the result line names the card and its
power limit.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
PEAK_BYTES_S = 3.35e12


def attention_call(B: int, Tq: int, Tk: int, HD: int,
                   C: Optional[int] = None, masked: bool = False,
                   itemsize: int = 2):
    """(bytes, FLOPs) one call of the per-site attention needs: q (B, Tq,
    HD), k and v (B, Tk, HD) read once, the output (B, Tq, C or HD) written
    once, QKᵀ and P·V at 2 FLOPs a multiply-add; with the output
    projection fused (``C``), wo (C, HD) in the compute dtype and bo (C,)
    in float32 read once and its product counted; a (Tq, Tk) float32 mask
    read once."""
    flops = 4 * B * Tq * Tk * HD
    nbytes = itemsize * (B * Tq * HD + 2 * B * Tk * HD + B * Tq * (C or HD))
    if C is not None:
        nbytes += itemsize * HD * C + 4 * C
        flops += 2 * B * Tq * HD * C
    if masked:
        nbytes += 4 * Tq * Tk
    return nbytes, flops


def attention_call_from_shapes(shapes: Sequence[list], itemsize: int = 2):
    """:func:`attention_call` of one ``npvp::temporal_attention`` call, from
    its recorded input shapes (q, k, v, bias, wo, bo, num_heads)."""
    q, k = shapes[0], shapes[1]
    bias = shapes[3] if len(shapes) > 3 else []
    wo = shapes[4] if len(shapes) > 4 else []
    B, Tq, HD = q
    return attention_call(B, Tq, k[1], HD, wo[0] if wo else None,
                          bool(bias), itemsize)


def bound_s(nbytes: float, flops: float, dtype: str = "bfloat16") -> float:
    """The least time the chip could take: the larger of bytes over peak
    bandwidth and FLOPs over peak compute."""
    return max(nbytes / PEAK_BYTES_S, flops / PEAK_FLOPS[dtype])


def _conv_backward_flops(grad_out_shape, x_shape, w_shape, _bias, _stride,
                         _padding, _dilation, transposed, _output_padding,
                         _groups, output_mask, out_shape=None) -> int:
    """A convolution's backward: each gradient it computes (input,
    weight) costs what the forward did. (torch's own formula counts a
    grouped convolution's input gradient as a dense one.)"""
    from torch.utils.flop_counter import conv_flop_count

    forward = conv_flop_count(x_shape, w_shape, grad_out_shape, transposed)
    return forward * (int(output_mask[0]) + int(output_mask[1]))


def _counter():
    from torch.utils.flop_counter import FlopCounterMode
    return FlopCounterMode(display=False, custom_mapping={
        torch.ops.aten.convolution_backward: _conv_backward_flops})


def serve_forward_flops(config: dict, batch: int, to_list, tp_list) -> int:
    """FLOPs of one served forward (AE encode, predictor, AE decode) at
    these shapes, counted on the reference on the meta device."""
    from npvp_bench.reference import model as R

    d, p = config["Dataset"], config["Predictor"]
    ae, pred = R.build(config, device="meta")
    ae.eval(), pred.eval()
    S, C = d["img_size"], d["img_channels"]
    frames = torch.empty((batch, len(to_list), S, S, C), device="meta")
    eps = torch.empty((batch, p["max_H"], p["max_W"], p["embed_dim"]),
                      device="meta")
    grid = lambda t: R.coordinate_grid(t, p["max_T"], p["max_H"],  # noqa
                                       p["max_W"], "meta")
    with torch.no_grad(), _counter() as fc:
        out = pred(ae.encode(frames), grid(to_list), grid(tp_list), eps)
        ae.decode(out.pred_features)
    return int(fc.get_total_flops())


def train_step_flops(config: dict, batch: int) -> int:
    """FLOPs of one rand-context train step (frozen AE encode, predictor
    forward in training mode with both codings, AE decode, the losses, and
    the backward to the predictor's parameters), counted on the
    reference; the optimizer's elementwise update is not counted."""
    from npvp_bench.reference import model as R
    from npvp_bench.reference.train import Trainer

    d, p = config["Dataset"], config["Predictor"]
    ae, pred = R.build(config, device="meta")
    tr = Trainer(config, ae, pred, 1)
    T, S, C = p["max_T"], d["img_size"], d["img_channels"]
    obs = torch.zeros(T, dtype=torch.bool, device="meta")
    batch_ = {"clip": torch.empty((batch, T, S, S, C), device="meta"),
              "obs_mask": obs, "tgt_mask": ~obs}
    with _counter() as fc:
        loss = tr.loss(batch_, 0)["loss"]
        torch.autograd.grad(loss, [v for v in tr.params.values()],
                            allow_unused=True)
    return int(fc.get_total_flops())


def mfu(rec) -> Optional[float]:
    """% of the compute dtype's peak: the reference FLOPs of the window's
    requests or steps over the window's wall time."""
    if not rec.get("flops") or not rec.get("window_s"):
        return None
    peak = PEAK_FLOPS[rec.get("compute_dtype", "float32")]
    return 100.0 * rec["flops"] / rec["window_s"] / peak
