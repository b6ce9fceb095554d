"""VidHRFormer encoder and non-autoregressive decoder (port of
``npvp_tpu/nn/vidhrformer.py``).

Two equal paths over one parameter set, as in the JAX package:

- the generic path takes the positionally fused inputs (``pos_feat_fuse``)
  and projects q/k/v from them;
- the affine-fused path (``'layer'`` norm + ``'Add'`` fusion, every shipped
  config) folds the fusion through the projections: ``posfuse(x)·W =
  a·(x·W) + b·(1ᵀW) + β·W`` with per-frame scalars (a, b), so q, k and v
  come from one wide matmul of the raw input.

The blocks take the affine path in eval mode only, as JAX takes it only when
``deterministic``: training runs the generic path, with dropout and DropPath
drawn from an explicit :class:`~npvp_tpu_torch.nn.layers.Rng` and, with
``remat``, each block recomputed in the backward pass
(``torch.utils.checkpoint``). One rule, ``nn.layers.kernel_path``, sends a
module to its hand-written kernel: ``exec_mode="pallas"``, eval mode, and
nothing that needs a gradient. On it the affine path hands its (sites, T,
H·D) q/k/v to the attention kernel
(``npvp_tpu_torch.kernels.temporal_attention``), output projection included,
and the norms run as the LayerNorm kernel
(``npvp_tpu_torch.kernels.layer_norm``), the conv FFN's GELUs as its
epilogue; elsewhere the plain attention and the eager norms run. The
kernels have no backward, so nothing that is trained reaches them. On a CPU
tensor each kernel's wrapper runs its plain twin. With ``exec_mode="int8"``
every projection and feed-forward product of the input runs as a dynamic
int8 product (``npvp_tpu_torch.nn.quant``), the attention itself in the
compute dtype; the positional terms stay in the compute dtype, as in the
JAX package.

Under sequence parallelism (``core.sequence_parallel``) each stack splits
its activations on H over the model axis at entry and gathers its output
back; the blocks run on the H shards, each attention sublayer and the
linear FFN gather H at their input, and their outputs, partial sums over
the model ranks' heads, are reduce-scattered back to the shards.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from npvp_tpu_torch.kernels import temporal_attention as ta_kernel
from npvp_tpu_torch.core.distributed import copy_to_model, reduce_from_model
from npvp_tpu_torch.core.sequence_parallel import (gather_h, h_split,
                                                   halo_rows,
                                                   reduce_scatter_h,
                                                   split_h, sp_axis,
                                                   sp_param)
from npvp_tpu_torch.nn.layers import (DropPath, LayerNormHWC,
                                      MultiHeadAttention, Rng,
                                      TokenLayerNorm, dropout, fold,
                                      fp32_moments, kernel_path, linear,
                                      row_parallel,
                                      scaled_dot_product_attention, tp_split)
from npvp_tpu_torch.nn.neural_process import pos_feat_fuse
from npvp_tpu_torch.nn.quant import int8_contract


def _center_pad_amounts(size: int, window: int) -> Tuple[int, int]:
    pad = (-size) % window
    return pad // 2, pad - pad // 2


def window_partition(x, window: int):
    """(B, H, W, C) → (B·nH·nW, window², C), center-padding H and W up to
    multiples of ``window``."""
    B, H, W, C = x.shape
    ph_lo, ph_hi = _center_pad_amounts(H, window)
    pw_lo, pw_hi = _center_pad_amounts(W, window)
    if ph_lo or ph_hi or pw_lo or pw_hi:
        x = F.pad(x, (0, 0, pw_lo, pw_hi, ph_lo, ph_hi))
    Hp, Wp = H + ph_lo + ph_hi, W + pw_lo + pw_hi
    x = x.reshape(B, Hp // window, window, Wp // window, window, C)
    x = x.permute(0, 1, 3, 2, 4, 5)
    return x.reshape(B * (Hp // window) * (Wp // window), window * window, C)


def window_reverse(x, window: int, B: int, H: int, W: int):
    """Inverse of :func:`window_partition`, removing the center padding."""
    ph_lo, ph_hi = _center_pad_amounts(H, window)
    pw_lo, pw_hi = _center_pad_amounts(W, window)
    Hp, Wp = H + ph_lo + ph_hi, W + pw_lo + pw_hi
    C = x.shape[-1]
    x = x.reshape(B, Hp // window, Wp // window, window, window, C)
    x = x.permute(0, 1, 3, 2, 4, 5).reshape(B, Hp, Wp, C)
    return x[:, ph_lo:ph_lo + H, pw_lo:pw_lo + W, :]


def frame_affine_stats(x, eps: float = 1e-5):
    """``pos_feat_fuse('layer', 'Add')`` as an affine map: fp32 (a, b) per
    (n, t) frame, keepdims, with ``pos_feat_fuse(x, beta, 0) == a·x + b +
    beta``."""
    mean, var = fp32_moments(x, (2, 3, 4))
    inv = torch.rsqrt(var + eps)
    return inv, -mean * inv


def _qkv_weights(mha: MultiHeadAttention):
    """(C, 3·HD) concatenated q/k/v kernels, the flat q and k kernels, their
    column sums 1ᵀWq and 1ᵀWk, and the three biases."""
    wq, wk, wv = mha.wq.weight.t(), mha.wk.weight.t(), mha.wv.weight.t()
    w3 = torch.cat([wq, wk, wv], dim=-1)
    return (w3, (wq, wk), (wq.sum(0), wk.sum(0)),
            (mha.wq.bias, mha.wk.bias, mha.wv.bias))


def _mm(x, w, dtype, quant: bool = False):
    if quant:
        return int8_contract(x, w, out_dtype=dtype)
    return x.to(dtype) @ w.to(dtype)


def _attend(qf, kf, vf, owner: nn.Module, dtype, allow=None,
            rng: Optional[Rng] = None, partial: bool = False):
    """Per-site attention plus output projection of (..., Tq, HD) q and
    (..., Tk, HD) k/v whose leading axes are sites, by ``owner.attn``, a
    :class:`MultiHeadAttention`; ``allow`` is a boolean (Tq, Tk) mask.
    Returns (..., Tq, C). On :func:`~npvp_tpu_torch.nn.layers.kernel_path`
    of ``owner`` the kernel computes it, output projection included;
    elsewhere the plain attention, with its weight dropout in training.
    Under tensor parallelism q/k/v hold the local heads and the output is
    summed over the model axis: the kernel projects with wo's local
    columns, and model rank 0 alone adds bo. With ``partial`` the local
    heads' projection is returned unsummed and without bo
    (``nn.layers.row_parallel``)."""
    mha = owner.attn
    lead, Tq, HD = qf.shape[:-2], qf.shape[-2], qf.shape[-1]
    Tk = kf.shape[-2]
    nh, tp = mha.num_heads, mha.tp
    if kernel_path(owner, qf):
        bias = None if allow is None else ta_kernel.allow_to_bias(allow)
        own_bo = not partial and (tp is None or tp.rank == 0)
        out = ta_kernel.temporal_attention(
            qf.reshape(-1, Tq, HD), kf.reshape(-1, Tk, HD),
            vf.reshape(-1, Tk, HD), bias, num_heads=nh, wo=mha.wo.weight,
            bo=mha.wo.bias if own_bo else None)
        if not partial:
            out = reduce_from_model(out, tp)
        return out.reshape(lead + (Tq, -1))
    heads = lambda t: t.reshape(t.shape[:-1] + (nh, -1))  # noqa: E731
    out = scaled_dot_product_attention(heads(qf), heads(kf), heads(vf),
                                       allow, mha.dropout_rate, rng,
                                       tp_split(tp, -3))
    return row_parallel(out.flatten(-2), mha.wo, dtype, mha.quant, tp,
                        partial)


class SpatialWindowAttention(nn.Module):
    """Local-window spatial attention: q/k from the positionally fused input,
    v from the raw normalised features. The generic path takes the fused
    tensor; the affine path (``pos_beta`` given) takes the raw input."""

    def __init__(self, embed_dim: int, num_heads: int, window_size: int = 4,
                 dropout: float = 0.0, exec_mode: str = "xla",
                 dtype=torch.float32):
        super().__init__()
        self.window_size, self.exec_mode, self.dtype = (window_size,
                                                        exec_mode, dtype)
        self.attn = MultiHeadAttention(embed_dim, num_heads, dropout, dtype,
                                       quant=exec_mode == "int8")

    def forward(self, x, value, pos_beta=None, evt=None,
                rng: Optional[Rng] = None, partial: bool = False):
        N, T, H, W, C = x.shape
        ws, dt, q8 = self.window_size, self.dtype, self.attn.quant
        if pos_beta is None:
            xw = window_partition(x.reshape(N * T, H, W, C), ws)
            vw = window_partition(value.reshape(N * T, H, W, C), ws)
            out = self.attn(xw, xw, vw, rng=rng, partial=partial)
            return window_reverse(out, ws, N * T, H, W).reshape(N, T, H, W, C)

        # affine path: x is the raw normalised input (== value); windows are
        # cut once before the projection so q/k/v come out in window layout
        w3, (wq_f, wk_f), (ones_q, ones_k), (bq, bk, bv) = _qkv_weights(
            self.attn)
        HD = wq_f.shape[1]
        a, b = frame_affine_stats(x if evt is None else x + evt)
        xw = window_partition(x.reshape(N * T, H, W, C), ws)
        nW = xw.shape[0] // (N * T)
        P = _mm(xw, w3, dt, q8).reshape(N, T, nW, ws * ws, 3 * HD)
        pq, pk, pv = P[..., :HD], P[..., HD:2 * HD], P[..., 2 * HD:]
        if evt is not None:
            # the (N, 1, H, W, C) event map is the same at every target time
            evtw = window_partition(evt.reshape(N, H, W, C), ws)
            evt_qk = _mm(evtw, torch.cat([wq_f, wk_f], -1), dt,
                         q8).reshape(N, 1, nW, ws * ws, 2 * HD)
            pq = pq + evt_qk[..., :HD]
            pk = pk + evt_qk[..., HD:]
        beta_w = window_partition(pos_beta.reshape(T, H, W, C).to(dt), ws)
        pos_q = (_mm(beta_w, wq_f, dt).float() + bq).reshape(
            1, T, nW, ws * ws, HD)
        pos_k = (_mm(beta_w, wk_f, dt).float() + bk).reshape(
            1, T, nW, ws * ws, HD)
        a4 = a.reshape(N, T, 1, 1, 1).to(dt)
        b4 = b.reshape(N, T, 1, 1, 1)
        # the per-frame shift b·1ᵀW applies to real positions only: padded
        # window slots stay bias-only, as in the generic path, where the
        # fusion happens before the zero padding
        if H % ws or W % ws:
            pad_mask = window_partition(
                torch.ones((1, H, W, 1), dtype=dt, device=x.device), ws
            ).reshape(1, 1, nW, ws * ws, 1)
            b4 = b4 * pad_mask
        qf = a4 * pq + (b4 * ones_q + pos_q).to(dt)
        kf = a4 * pk + (b4 * ones_k + pos_k).to(dt)
        vf = pv + bv.to(dt)
        out = _attend(qf, kf, vf, self, dt, rng=rng, partial=partial)
        out = window_reverse(out.reshape(N * T * nW, ws * ws, C), ws, N * T,
                             H, W)
        return out.reshape(N, T, H, W, C)


def _gelu_for(dtype):
    """Exact GELU in fp32, tanh-approximated GELU in bf16 (the forms that
    ``MlpDWBN`` asks of its norms)."""
    approx = "tanh" if dtype == torch.bfloat16 else "none"
    return lambda x: F.gelu(x, approximate=approx)


class MlpDWBN(nn.Module):
    """Conv feed-forward: 1×1 → depthwise 3×3 → 1×1 with GELU and a
    per-sample (H, W, C) LayerNorm after each stage, dropout after the last
    two. The 1×1 convs are ``nn.Linear`` over the channel axis, dynamic
    int8 products with ``quant``; the depthwise conv stays in the compute
    dtype. Each GELU is its norm's ``act``: on the norms' kernel path the
    hand-written norm kernel's epilogue. On
    a sequence-parallel H shard (``sp``) the depthwise conv reads a one-row
    halo of each neighbour and the LayerNorms take the whole sample's
    statistics."""

    def __init__(self, in_features: int, hidden_features: int,
                 out_features: int, spatial: Tuple[int, int],
                 dropout: float = 0.0, dtype=torch.float32,
                 quant: bool = False, exec_mode: str = "xla"):
        super().__init__()
        H, W = spatial
        self.dropout, self.dtype, self.quant = dropout, dtype, quant
        self.fc1 = nn.Linear(in_features, hidden_features)
        self.norm1 = LayerNormHWC((H, W, hidden_features),
                                  exec_mode=exec_mode)
        self.dw3x3 = nn.Conv2d(hidden_features, hidden_features, 3,
                               padding=1, groups=hidden_features)
        self.norm2 = LayerNormHWC((H, W, hidden_features),
                                  exec_mode=exec_mode)
        self.fc2 = nn.Linear(hidden_features, out_features)
        self.norm3 = LayerNormHWC((H, W, out_features), exec_mode=exec_mode)

    def forward(self, x, rng: Optional[Rng] = None, sp=None):
        N, T, H, W, C = x.shape
        dt = self.dtype
        gelu = "gelu_tanh" if dt == torch.bfloat16 else "gelu"
        drop = lambda y, tag: dropout(y, self.dropout,  # noqa: E731
                                      self.training, fold(rng, tag),
                                      h_split(sp, 1))
        y = x.reshape(N * T, H, W, C)
        y = self.norm1(linear(y, self.fc1, dt, self.quant, sp), sp, gelu)
        dw, pad = self.dw3x3, (1, 1)
        if sp is not None:  # H's padding: the neighbours' rows
            y, pad = halo_rows(y, sp), (0, 1)
        y = F.conv2d(y.permute(0, 3, 1, 2), sp_param(dw.weight, sp).to(dt),
                     sp_param(dw.bias, sp).to(dt), 1, pad, 1,
                     dw.groups).permute(0, 2, 3, 1)
        y = drop(self.norm2(y, sp, gelu), "drop2")
        y = drop(self.norm3(linear(y, self.fc2, dt, self.quant, sp), sp,
                            gelu), "drop3")
        return y.reshape(N, T, H, W, -1)


def encoder_temporal_allow(T: int, obs_mask=None, device="cpu"):
    """Boolean (T, T) allow matrix of the encoder's temporal attention: the
    last time position is hidden from every earlier query. With an
    ``obs_mask``, keys are restricted to observed positions and "last" is
    the highest observed index."""
    q = torch.arange(T, device=device)[:, None]
    k = torch.arange(T, device=device)[None, :]
    if obs_mask is None:
        last = T - 1
        return ~((k == last) & (q != last))
    obs = obs_mask.to(device=device, dtype=torch.bool)
    idx = torch.arange(T, device=device)
    last = torch.where(obs, idx, torch.full_like(idx, -1)).max()
    return obs[None, :] & ~((k == last) & (q != last))


class TemporalAttention(nn.Module):
    """Attention over the T axis, batched over the (N, H, W) sites.

    Generic path: q_in/k_in are pre-fused. Affine path (``pos_beta_q``
    given): the inputs are raw; self-attention (``k_in is q_in``) projects
    q/k/v in one C→3·HD matmul, cross-attention projects q from the query
    and k/v from the memory, or takes the memory projection ``cross_pkv``
    that the decoder stack hoisted."""

    def __init__(self, embed_dim: int, num_heads: int, dropout: float = 0.0,
                 exec_mode: str = "xla", dtype=torch.float32):
        super().__init__()
        self.exec_mode, self.dtype = exec_mode, dtype
        self.attn = MultiHeadAttention(embed_dim, num_heads, dropout, dtype,
                                       quant=exec_mode == "int8")

    def forward(self, q_in, k_in, v_in, allow=None, pos_beta_q=None,
                pos_beta_kv=None, evt_q=None, cross_pkv=None,
                rng: Optional[Rng] = None, partial: bool = False):
        to_bt = lambda t: t.permute(0, 2, 3, 1, 4)  # noqa: E731
        dt, q8 = self.dtype, self.attn.quant
        if pos_beta_q is None:
            mask = None if allow is None else allow[None, None, None, None]
            out = self.attn(to_bt(q_in), to_bt(k_in), to_bt(v_in), mask=mask,
                            rng=rng, partial=partial)
            return out.permute(0, 3, 1, 2, 4)

        w3, (wq_f, wk_f), (ones_q, ones_k), (bq, bk, bv) = _qkv_weights(
            self.attn)
        HD = wq_f.shape[1]
        N, T, H, W, C = q_in.shape

        def posmm(beta, w, bias, Tn):  # → (1, H, W, Tn, HD) fp32
            bt = beta.reshape(Tn, H, W, C).permute(1, 2, 0, 3)
            return (_mm(bt, w, dt).float() + bias)[None]

        s_in = q_in if evt_q is None else q_in + evt_q
        if k_in is q_in:  # temporal self-attention
            a, b = frame_affine_stats(s_in)
            a5, b5 = to_bt(a).to(dt), to_bt(b)
            P = _mm(to_bt(q_in), w3, dt, q8)
            pq, pk, pv = P[..., :HD], P[..., HD:2 * HD], P[..., 2 * HD:]
            if evt_q is not None:
                evt_qk = _mm(to_bt(evt_q), torch.cat([wq_f, wk_f], -1), dt,
                             q8)
                pq = pq + evt_qk[..., :HD]
                pk = pk + evt_qk[..., HD:]
            qf = a5 * pq + (b5 * ones_q + posmm(pos_beta_q, wq_f, bq, T)
                            ).to(dt)
            kf = a5 * pk + (b5 * ones_k + posmm(pos_beta_q, wk_f, bk, T)
                            ).to(dt)
            vf = pv + bv.to(dt)
        else:  # encoder-decoder cross-attention: v_in is k_in, the memory
            aq, bq_s = frame_affine_stats(s_in)
            pq = _mm(to_bt(s_in), wq_f, dt, q8)
            qf = (to_bt(aq).to(dt) * pq
                  + (to_bt(bq_s) * ones_q + posmm(pos_beta_q, wq_f, bq, T)
                     ).to(dt))
            To = k_in.shape[1]
            ak, bk_s = frame_affine_stats(k_in)
            if cross_pkv is None:
                P = _mm(to_bt(k_in), torch.cat([wk_f, w3[:, 2 * HD:]], -1),
                        dt, q8)
                Pk, Pv = P[..., :HD], P[..., HD:]
            else:
                Pk, Pv = cross_pkv
            kf = (to_bt(ak).to(dt) * Pk
                  + (to_bt(bk_s) * ones_k
                     + posmm(pos_beta_kv, wk_f, bk, To)).to(dt))
            vf = Pv + bv.to(dt)
        out = _attend(qf, kf, vf, self, dt, allow, rng, partial)
        return out.permute(0, 3, 1, 2, 4)


class VidHRFormerBlockEnc(nn.Module):
    """Encoder block: window MHSA → conv FFN → masked temporal MHSA → linear
    FFN, pre-LN, with DropPath on the first two branches and dropout on the
    others. Eval mode takes the affine-fused path where it applies. Under
    tensor parallelism (``tp``) the linear FFN holds a slice of the hidden
    width: linear1's rows, linear2's columns. Under sequence parallelism
    (``sp``, given by the stack) ``x`` is an H shard: each sublayer gathers
    its normalised input (:meth:`_enter`) and hands back its rows of the
    output (:meth:`_leave`)."""

    n_norms = 4

    def __init__(self, embed_dim: int, num_heads: int, window_size: int = 4,
                 dropout: float = 0.0, drop_path: float = 0.0,
                 ffn_hidden_ratio: int = 4, dim_feedforward: int = 1024,
                 norm_type: str = "layer", affine_posfuse: bool = False,
                 exec_mode: str = "xla", spatial: Tuple[int, int] = (8, 8),
                 dtype=torch.float32):
        super().__init__()
        self.norm_type, self.affine, self.dtype = (norm_type, affine_posfuse,
                                                   dtype)
        self.dropout, self.quant = dropout, exec_mode == "int8"
        for i in range(1, self.n_norms + 1):
            # torch nn.LayerNorm's eps, as at every reference call site
            self.add_module(f"norm{i}", TokenLayerNorm(
                embed_dim, 1e-5, dtype=dtype, exec_mode=exec_mode))
        self.drop_path = DropPath(drop_path)
        self.slmhsa = SpatialWindowAttention(embed_dim, num_heads,
                                             window_size, dropout, exec_mode,
                                             dtype)
        self.spatial_ffn = MlpDWBN(embed_dim, ffn_hidden_ratio * embed_dim,
                                   embed_dim, spatial, dropout, dtype,
                                   self.quant, exec_mode)
        self.temporal_mhsa = TemporalAttention(embed_dim, num_heads, dropout,
                                               exec_mode, dtype)
        self.linear1 = nn.Linear(embed_dim, dim_feedforward)
        self.linear2 = nn.Linear(dim_feedforward, embed_dim)
        self.tp = None

    @property
    def fused(self) -> bool:
        """The affine-fused path: eval mode only (JAX: ``affine_posfuse and
        deterministic``)."""
        return self.affine and not self.training

    def _drop(self, x, rng, tag, split=None):
        return dropout(x, self.dropout, self.training, fold(rng, tag), split)

    def _enter(self, norm, x, sp):
        """``norm(x)``, whole: the input of an attention sublayer or the
        linear FFN."""
        return gather_h(norm(x, sp), sp)

    def _leave(self, y, layer: nn.Linear, tp, sp):
        """A sublayer's output at this shard's rows: under sequence
        parallelism ``y`` is its unbiased product (``partial``), summed
        over the model ranks when ``tp`` split it, and ``layer``'s bias is
        added here."""
        if sp is None:
            return y
        y = split_h(y, sp) if tp is None else reduce_scatter_h(y, sp)
        return y + sp_param(layer.bias, sp).to(y.dtype)

    def _attn_out(self, y, mha: MultiHeadAttention, sp):
        return self._leave(y, mha.wo, mha.tp, sp)

    def _linear_ffn(self, x, rng, sp=None):
        tp = self.tp
        y = _gelu_for(self.dtype)(linear(copy_to_model(x, tp), self.linear1,
                                         self.dtype, self.quant))
        y = self._drop(y, rng, "drop_ffn1", tp_split(tp, -1))
        y = row_parallel(y, self.linear2, self.dtype, self.quant, tp,
                         sp is not None)
        return self._drop(self._leave(y, self.linear2, tp, sp), rng,
                          "drop_ffn2", h_split(sp))

    def forward(self, x, pos_beta, pos_gamma, temporal_allow=None,
                rng: Optional[Rng] = None, sp=None):
        part = sp is not None
        x1 = self._enter(self.norm1, x, sp)
        if self.fused:
            attn = self.slmhsa(x1, x1, pos_beta=pos_beta, partial=part)
        else:
            attn = self.slmhsa(pos_feat_fuse(x1, pos_beta, pos_gamma,
                                             self.norm_type), x1,
                               rng=fold(rng, "slmhsa"), partial=part)
        attn = self._attn_out(attn, self.slmhsa.attn, sp)
        x = x + self.drop_path(attn, fold(rng, "drop_path1"))
        x = x + self.drop_path(self.spatial_ffn(self.norm2(x, sp),
                                                fold(rng, "spatial_ffn"),
                                                sp),
                               fold(rng, "drop_path2"))
        x1 = self._enter(self.norm3, x, sp)
        if temporal_allow is None:
            temporal_allow = encoder_temporal_allow(x.shape[1],
                                                    device=x.device)
        if self.fused:
            tattn = self.temporal_mhsa(x1, x1, x1, temporal_allow,
                                       pos_beta_q=pos_beta, partial=part)
        else:
            temp = pos_feat_fuse(x1, pos_beta, pos_gamma, self.norm_type)
            tattn = self.temporal_mhsa(temp, temp, x1, temporal_allow,
                                       rng=fold(rng, "temporal_mhsa"),
                                       partial=part)
        tattn = self._attn_out(tattn, self.temporal_mhsa.attn, sp)
        x = x + self._drop(tattn, rng, "drop_temporal", h_split(sp))
        return x + self._linear_ffn(self._enter(self.norm4, x, sp), rng, sp)


def _run_blocks(stack, blocks, x, args, rng, per_block=None):
    """Thread ``x`` through ``blocks``, each called as ``block(x, *args,
    rng=..., sp=..., **per_block[i])`` with its own stream; with
    ``stack.remat`` in training under grad, each block's activations are
    recomputed in the backward pass. The masks come from the block's
    stream, so the recomputation draws the same ones. Under sequence
    parallelism (:func:`~npvp_tpu_torch.core.sequence_parallel.sp_axis`)
    the blocks run on this rank's rows of H and the whole output is
    gathered at the end."""
    remat = stack.remat and stack.training and torch.is_grad_enabled()
    sp = sp_axis(x)
    x = split_h(x, sp)
    for i, block in enumerate(blocks):
        kw = dict(rng=fold(rng, f"layer_{i}"), sp=sp,
                  **(per_block[i] if per_block else {}))
        if remat:
            x = checkpoint(block, x, *args, use_reentrant=False, **kw)
        else:
            x = block(x, *args, **kw)
    return gather_h(x, sp)


class VidHRFormerEncoder(nn.Module):
    """Stack of encoder blocks (EVT-Former); the final norm is applied by the
    caller, whose parameters are shared with the decoder's."""

    def __init__(self, num_layers: int, embed_dim: int, num_heads: int,
                 remat: bool = False, **block_kw):
        super().__init__()
        self.num_layers, self.remat = num_layers, remat
        for i in range(num_layers):
            self.add_module(f"layer_{i}", VidHRFormerBlockEnc(
                embed_dim, num_heads, **block_kw))

    def forward(self, x, pos_beta, pos_gamma, temporal_allow=None,
                rng: Optional[Rng] = None):
        blocks = [getattr(self, f"layer_{i}") for i in range(self.num_layers)]
        return _run_blocks(self, blocks, x,
                           (pos_beta, pos_gamma, temporal_allow), rng)


class VidHRFormerBlockDecNAR(VidHRFormerBlockEnc):
    """NAR decoder block: window self-attention (+ event query) → conv FFN →
    temporal self-attention → linear FFN → encoder-decoder cross-attention
    → conv FFN. Holds the encoder block's modules plus ``norm5``,
    ``norm6``, ``enc_dec_attn`` and ``spatial_ffn1``. Under sequence
    parallelism ``tgt`` is an H shard; the event query and the memory
    stay whole."""

    n_norms = 6

    def __init__(self, embed_dim: int, num_heads: int, window_size: int = 4,
                 dropout: float = 0.0, drop_path: float = 0.0,
                 ffn_hidden_ratio: int = 4, dim_feedforward: int = 1024,
                 norm_type: str = "layer", affine_posfuse: bool = False,
                 exec_mode: str = "xla", spatial: Tuple[int, int] = (8, 8),
                 dtype=torch.float32):
        super().__init__(embed_dim, num_heads, window_size, dropout,
                         drop_path, ffn_hidden_ratio, dim_feedforward,
                         norm_type, affine_posfuse, exec_mode, spatial, dtype)
        self.enc_dec_attn = TemporalAttention(embed_dim, num_heads, dropout,
                                              exec_mode, dtype)
        self.spatial_ffn1 = MlpDWBN(embed_dim, ffn_hidden_ratio * embed_dim,
                                    embed_dim, spatial, dropout, dtype,
                                    self.quant, exec_mode)

    def forward(self, tgt, query_evt, memory, mem_pos, tgt_pos,
                self_allow=None, cross_allow=None, cross_pkv=None,
                rng: Optional[Rng] = None, sp=None):
        mem_beta, mem_gamma = mem_pos
        tgt_beta, tgt_gamma = tgt_pos
        part = sp is not None
        fuse = lambda t, b, g: pos_feat_fuse(t, b, g,  # noqa: E731
                                             self.norm_type)
        dp = lambda y, tag: self.drop_path(y, fold(rng, tag))  # noqa: E731
        tgt2 = self._enter(self.norm1, tgt, sp)
        if self.fused:
            attn = self.slmhsa(tgt2, tgt2, pos_beta=tgt_beta, evt=query_evt,
                               partial=part)
        else:
            attn = self.slmhsa(fuse(tgt2 + query_evt, tgt_beta, tgt_gamma),
                               tgt2, rng=fold(rng, "slmhsa"), partial=part)
        tgt2 = tgt + dp(self._attn_out(attn, self.slmhsa.attn, sp),
                        "drop_path1")
        tgt2 = tgt2 + dp(self.spatial_ffn(self.norm2(tgt2, sp),
                                          fold(rng, "spatial_ffn"), sp),
                         "drop_path2")

        t_in = self._enter(self.norm3, tgt2, sp)
        if self.fused:
            tattn = self.temporal_mhsa(t_in, t_in, t_in, self_allow,
                                       pos_beta_q=tgt_beta, partial=part)
        else:
            temp = fuse(t_in, tgt_beta, tgt_gamma)
            tattn = self.temporal_mhsa(temp, temp, t_in, self_allow,
                                       rng=fold(rng, "temporal_mhsa"),
                                       partial=part)
        tattn = self._attn_out(tattn, self.temporal_mhsa.attn, sp)
        tgt2 = tgt2 + self._drop(tattn, rng, "drop_temporal", h_split(sp))
        tgt2 = tgt2 + self._linear_ffn(self._enter(self.norm4, tgt2, sp),
                                       rng, sp)

        q_in = self._enter(self.norm5, tgt2, sp)
        if self.fused:
            cattn = self.enc_dec_attn(q_in, memory, memory, cross_allow,
                                      pos_beta_q=tgt_beta,
                                      pos_beta_kv=mem_beta, evt_q=query_evt,
                                      cross_pkv=cross_pkv, partial=part)
        else:
            cattn = self.enc_dec_attn(
                fuse(q_in + query_evt, tgt_beta, tgt_gamma),
                fuse(memory, mem_beta, mem_gamma), memory, cross_allow,
                rng=fold(rng, "enc_dec_attn"), partial=part)
        cattn = self._attn_out(cattn, self.enc_dec_attn.attn, sp)
        tgt2 = tgt2 + dp(cattn, "drop_path3")
        return tgt2 + dp(self.spatial_ffn1(self.norm6(tgt2, sp),
                                           fold(rng, "spatial_ffn1"), sp),
                         "drop_path4")


class VidHRFormerDecoderNAR(nn.Module):
    """Non-autoregressive decoder: the target starts at zeros and every
    target frame is generated in one pass. On the affine path (eval mode)
    the k/v projections of all layers' cross-attentions, which read the
    same memory, run as one (C → L·2·HD) matmul; in int8 too, where it is
    the same function (per-row and per-column scales), though the JAX
    package projects each layer's memory there. Under sequence parallelism
    the memory stays whole: every layer's cross-attention reads all of
    it."""

    def __init__(self, num_layers: int, embed_dim: int, num_heads: int,
                 remat: bool = False, **block_kw):
        super().__init__()
        self.num_layers, self.remat = num_layers, remat
        self.affine = block_kw.get("affine_posfuse", False)
        self.dtype = block_kw.get("dtype", torch.float32)
        self.quant = block_kw.get("exec_mode") == "int8"
        for i in range(num_layers):
            self.add_module(f"layer_{i}", VidHRFormerBlockDecNAR(
                embed_dim, num_heads, **block_kw))

    def forward(self, query_evt, memory, mem_pos, tgt_pos, self_allow=None,
                cross_allow=None, rng: Optional[Rng] = None):
        N, _, H, W, C = query_evt.shape
        TP = tgt_pos[0].shape[0] // (H * W)
        tgt = torch.zeros((N, TP, H, W, C), dtype=query_evt.dtype,
                          device=query_evt.device)
        blocks = [getattr(self, f"layer_{i}") for i in range(self.num_layers)]
        args = (query_evt, memory, mem_pos, tgt_pos, self_allow, cross_allow)
        if not (self.affine and not self.training):
            return _run_blocks(self, blocks, tgt, args, rng)
        pieces, HD = [], None
        for b in blocks:
            w3, (_, wk_f), _, _ = _qkv_weights(b.enc_dec_attn.attn)
            HD = wk_f.shape[1]
            pieces.append(torch.cat([wk_f, w3[:, 2 * HD:]], -1))
        P = _mm(memory.permute(0, 2, 3, 1, 4), torch.cat(pieces, -1),
                self.dtype, self.quant)
        pkvs = [{"cross_pkv": (P[..., l * 2 * HD:l * 2 * HD + HD],
                               P[..., l * 2 * HD + HD:(l + 1) * 2 * HD])}
                for l in range(len(blocks))]
        return _run_blocks(self, blocks, tgt, args, rng, pkvs)
