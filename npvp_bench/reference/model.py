"""Plain float32 reference of the NPVP model: the frame autoencoder, the
neural-process predictor (NPVP-D and NPVP-S) and the random streams that
its dropout, DropPath and latent noise draw from.

Plain PyTorch only, written from the model's equations: every projection
is a ``F.linear`` of the positionally fused input (no folding of the fusion
through the weights, no hoisted projections, no kernel, no parallelism),
every norm is ``F.layer_norm`` or a BatchNorm written out, every attention
a softmax of explicit logits. Parameter and buffer names follow the
measured program's state dicts (``encoder.block0.conv.weight``,
``decoder.layer_0.slmhsa.attn.wq.weight``, ...), so that one set of
weights drawn by the benchmark loads into both. Activations are
channels-last: frames (N, T, H, W, C).

``set_precision("fp8")`` rounds to float8 e4m3, with one scale a tensor,
both operands and the result of every product (linear, convolution,
attention), the output of every norm and softmax, and the gradients that
flow back through them: the model computed in float8 as the program
computes in its stated dtype, the control that a program computing below
that precision would read like.

Randomness comes from :class:`Rng`, a stream named by a 63-bit seed whose
children are derived by name (blake2b of ``"<seed>/<tag>"``), each draw a
``torch.Generator`` seeded from the stream, on the device of the tensor it
masks. The same step seed therefore gives the same masks and noise to any
implementation that derives them by the same names and shapes.
"""

from __future__ import annotations

import hashlib
import math
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch import nn

# ---------------------------------------------------------------- streams


class Rng:
    """A random stream named by a 63-bit seed; ``fold(tag)`` derives a
    child by name."""

    def __init__(self, seed: int):
        self.seed = int(seed) & (2 ** 63 - 1)

    def fold(self, tag) -> "Rng":
        digest = hashlib.blake2b(f"{self.seed}/{tag}".encode(),
                                 digest_size=8).digest()
        return Rng(int.from_bytes(digest, "little"))

    def _gen(self, device):
        return torch.Generator(device=device).manual_seed(self.seed)

    def normal(self, shape, device) -> torch.Tensor:
        if torch.device(device).type == "meta":
            return torch.zeros(shape, device=device)
        return torch.randn(tuple(shape), generator=self._gen(device),
                           device=device)

    def bernoulli(self, shape, p: float, device) -> torch.Tensor:
        if torch.device(device).type == "meta":
            return torch.ones(shape, device=device)
        return torch.empty(tuple(shape), device=device).bernoulli_(
            p, generator=self._gen(device))


def fold(rng: Optional[Rng], tag) -> Optional[Rng]:
    return None if rng is None else rng.fold(tag)


# ------------------------------------------------------- product precision


def _fp8_round(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 under one scale (its abs-max at 448),
    returned in float32."""
    if x.device.type == "meta":
        return x
    scale = x.detach().abs().amax().float().clamp(min=1e-30) / 448.0
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


class _Fp8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return _fp8_round(x)

    @staticmethod
    def backward(ctx, grad):
        return _fp8_round(grad)


class Precision:
    """``"fp32"`` leaves every value as it is; ``"fp8"`` rounds it (and
    its gradient) to float8 e4m3."""

    def __init__(self, name: str = "fp32"):
        if name not in ("fp32", "fp8"):
            raise ValueError(f"unknown precision {name!r}")
        self.name = name

    def __call__(self, x):
        return x if self.name == "fp32" else _Fp8.apply(x)


PREC = Precision()  # set by ``set_precision`` for the control


def set_precision(name: str) -> None:
    PREC.name = Precision(name).name


def lin(x, layer: nn.Linear):
    return PREC(F.linear(PREC(x), PREC(layer.weight),
                         None if layer.bias is None else layer.bias))


def conv(x, layer: nn.Conv2d):
    """``layer`` on an (N, H, W, C) tensor."""
    y = F.conv2d(PREC(x.permute(0, 3, 1, 2)), PREC(layer.weight),
                 layer.bias, layer.stride, layer.padding, layer.dilation,
                 layer.groups)
    return PREC(y.permute(0, 2, 3, 1))


def einsum(eq, a, b):
    return PREC(torch.einsum(eq, PREC(a), PREC(b)))


# ------------------------------------------------------------ basic layers


def dropout(x, rate: float, training: bool, rng: Optional[Rng]):
    if not training or rate == 0.0:
        return x
    keep = rng.bernoulli(x.shape, 1.0 - rate, x.device)
    return x * keep / (1.0 - rate)


class DropPath(nn.Module):
    def __init__(self, rate: float = 0.0):
        super().__init__()
        self.rate = rate

    def forward(self, x, rng: Optional[Rng] = None):
        if not self.training or self.rate == 0.0:
            return x
        shape = (x.shape[0],) + (1,) * (x.dim() - 1)
        keep = rng.bernoulli(shape, 1.0 - self.rate, x.device)
        return x * keep / (1.0 - self.rate)


class BatchNorm(nn.Module):
    """BatchNorm over the trailing channel axis. Training: the batch's mean
    and biased variance, running statistics moved by
    ``r = 0.9·r + 0.1·s``; eval: the running statistics."""

    def __init__(self, channels: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def forward(self, x):
        if self.training:
            dims = tuple(range(x.dim() - 1))
            var, mean = torch.var_mean(x, dim=dims, unbiased=False)
            with torch.no_grad():
                self.running_mean.mul_(0.9).add_(0.1 * mean)
                self.running_var.mul_(0.9).add_(0.1 * var)
        else:
            mean, var = self.running_mean, self.running_var
        return PREC((x - mean) / torch.sqrt(var + self.eps) * self.weight
                    + self.bias)


class TokenLayerNorm(nn.Module):
    def __init__(self, channels: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x):
        return PREC(F.layer_norm(x, x.shape[-1:], self.weight, self.bias,
                                 self.eps))


class LayerNormHWC(nn.Module):
    """LayerNorm over the trailing (H, W, C) axes with an (H, W, C)
    affine."""

    def __init__(self, shape, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(tuple(shape)))
        self.bias = nn.Parameter(torch.zeros(tuple(shape)))

    def forward(self, x):
        return PREC(F.layer_norm(x, x.shape[-3:], self.weight, self.bias,
                                 self.eps))


def reflect_pad(x, pad: int):
    """Reflection padding of the (H, W) axes of (B, H, W, C)."""
    y = F.pad(x.permute(0, 3, 1, 2), (pad,) * 4, mode="reflect")
    return y.permute(0, 2, 3, 1)


class ConvBNAct(nn.Module):
    def __init__(self, cin: int, cout: int, k: int = 3, stride: int = 1,
                 padding: str = "TORCH_SAME", use_bias: bool = False,
                 activation: Optional[str] = "relu", groups: int = 1):
        super().__init__()
        pad = k // 2 if padding == "TORCH_SAME" else 0
        self.conv = nn.Conv2d(cin, cout, k, stride, pad, groups=groups,
                              bias=use_bias)
        self.bn = BatchNorm(cout)
        self.activation = activation

    def forward(self, x):
        x = self.bn(conv(x, self.conv))
        return torch.relu(x) if self.activation == "relu" else x


def attention(q, k, v, mask=None, rate: float = 0.0,
              rng: Optional[Rng] = None):
    """Softmax attention of (..., L, heads, d) tensors; ``mask`` boolean,
    True = allowed, broadcast to (..., heads, Lq, Lk)."""
    logits = einsum("...qhd,...khd->...hqk", q, k) / math.sqrt(q.shape[-1])
    if mask is not None:
        logits = torch.where(mask, logits, torch.finfo(torch.float32).min)
    weights = dropout(PREC(torch.softmax(logits, dim=-1)), rate, rate > 0.0,
                      rng)
    return einsum("...hqk,...khd->...qhd", weights, v)


class MultiHeadAttention(nn.Module):
    def __init__(self, embed_dim: int, num_heads: int, dropout: float = 0.0):
        super().__init__()
        self.num_heads, self.dropout = num_heads, dropout
        self.wq = nn.Linear(embed_dim, embed_dim)
        self.wk = nn.Linear(embed_dim, embed_dim)
        self.wv = nn.Linear(embed_dim, embed_dim)
        self.wo = nn.Linear(embed_dim, embed_dim)

    def forward(self, q_in, k_in, v_in, mask=None,
                rng: Optional[Rng] = None):
        heads = lambda t: t.reshape(  # noqa: E731
            t.shape[:-1] + (self.num_heads, -1))
        out = attention(heads(lin(q_in, self.wq)), heads(lin(k_in, self.wk)),
                        heads(lin(v_in, self.wv)), mask,
                        self.dropout if self.training else 0.0, rng)
        return lin(out.flatten(-2), self.wo)


def gelu(x):
    return F.gelu(x)


# -------------------------------------------------------------- predictor


def _pad_amounts(size: int, window: int):
    pad = (-size) % window
    return pad // 2, pad - pad // 2


def window_partition(x, ws: int):
    """(B, H, W, C) → (B·nH·nW, ws², C), zero-padding H and W at both
    ends up to multiples of ``ws``."""
    B, H, W, C = x.shape
    (h0, h1), (w0, w1) = _pad_amounts(H, ws), _pad_amounts(W, ws)
    x = F.pad(x, (0, 0, w0, w1, h0, h1))
    Hp, Wp = H + h0 + h1, W + w0 + w1
    x = x.reshape(B, Hp // ws, ws, Wp // ws, ws, C).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, ws * ws, C)


def window_reverse(x, ws: int, B: int, H: int, W: int):
    (h0, h1), (w0, w1) = _pad_amounts(H, ws), _pad_amounts(W, ws)
    Hp, Wp = H + h0 + h1, W + w0 + w1
    x = x.reshape(B, Hp // ws, Wp // ws, ws, ws, -1).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(B, Hp, Wp, -1)[:, h0:h0 + H, w0:w0 + W]


def pos_feat_fuse(x, beta, gamma, eps: float = 1e-5):
    """Parameter-free fusion of (N, T, H, W, C) features with (T·H·W, C)
    modulation: per-frame layer norm over (H, W, C), then
    ``·(1 + gamma) + beta``."""
    N, T, H, W, C = x.shape
    y = F.layer_norm(x, (H, W, C), eps=eps)
    return PREC(y * (1.0 + gamma.reshape(T, H, W, C))
                + beta.reshape(T, H, W, C))


class SpatialWindowAttention(nn.Module):
    """Window self-attention: q and k from the fused input, v from the
    normalised features."""

    def __init__(self, embed_dim, num_heads, window_size=4, dropout=0.0):
        super().__init__()
        self.window_size = window_size
        self.attn = MultiHeadAttention(embed_dim, num_heads, dropout)

    def forward(self, x, value, rng=None):
        N, T, H, W, C = x.shape
        ws = self.window_size
        xw = window_partition(x.reshape(N * T, H, W, C), ws)
        vw = window_partition(value.reshape(N * T, H, W, C), ws)
        out = self.attn(xw, xw, vw, rng=rng)
        return window_reverse(out, ws, N * T, H, W).reshape(N, T, H, W, C)


class MlpDWBN(nn.Module):
    """1×1 → depthwise 3×3 → 1×1, each followed by a per-sample (H, W, C)
    layer norm and GELU; dropout after the last two."""

    def __init__(self, cin, hidden, cout, spatial, dropout=0.0):
        super().__init__()
        H, W = spatial
        self.dropout = dropout
        self.fc1 = nn.Linear(cin, hidden)
        self.norm1 = LayerNormHWC((H, W, hidden))
        self.dw3x3 = nn.Conv2d(hidden, hidden, 3, padding=1, groups=hidden)
        self.norm2 = LayerNormHWC((H, W, hidden))
        self.fc2 = nn.Linear(hidden, cout)
        self.norm3 = LayerNormHWC((H, W, cout))

    def forward(self, x, rng=None):
        N, T, H, W, C = x.shape
        drop = lambda y, tag: dropout(y, self.dropout,  # noqa: E731
                                      self.training, fold(rng, tag))
        y = gelu(self.norm1(lin(x.reshape(N * T, H, W, C), self.fc1)))
        y = drop(gelu(self.norm2(conv(y, self.dw3x3))), "drop2")
        y = drop(gelu(self.norm3(lin(y, self.fc2))), "drop3")
        return y.reshape(N, T, H, W, -1)


def encoder_temporal_allow(T: int, obs_mask=None, device="cpu"):
    """(T, T) allow matrix: the last (observed) frame is hidden from every
    other query; with ``obs_mask`` only observed keys are allowed."""
    q = torch.arange(T, device=device)[:, None]
    k = torch.arange(T, device=device)[None, :]
    if obs_mask is None:
        return ~((k == T - 1) & (q != T - 1))
    obs = obs_mask.to(device=device, dtype=torch.bool)
    idx = torch.arange(T, device=device)
    last = torch.where(obs, idx, torch.full_like(idx, -1)).max()
    return obs[None, :] & ~((k == last) & (q != last))


class TemporalAttention(nn.Module):
    """Attention over T at every (n, h, w) site."""

    def __init__(self, embed_dim, num_heads, dropout=0.0):
        super().__init__()
        self.attn = MultiHeadAttention(embed_dim, num_heads, dropout)

    def forward(self, q_in, k_in, v_in, allow=None, rng=None):
        to_bt = lambda t: t.permute(0, 2, 3, 1, 4)  # noqa: E731
        mask = None if allow is None else allow[None, None, None, None]
        out = self.attn(to_bt(q_in), to_bt(k_in), to_bt(v_in), mask, rng)
        return out.permute(0, 3, 1, 2, 4)


class BlockEnc(nn.Module):
    """Pre-LN encoder block: window MHSA → conv FFN → masked temporal MHSA
    → linear FFN."""

    n_norms = 4

    def __init__(self, embed_dim, num_heads, window_size=4, dropout=0.0,
                 drop_path=0.0, ffn_hidden_ratio=4, dim_feedforward=1024,
                 spatial=(8, 8)):
        super().__init__()
        self.dropout = dropout
        for i in range(1, self.n_norms + 1):
            self.add_module(f"norm{i}", TokenLayerNorm(embed_dim))
        self.drop_path = DropPath(drop_path)
        self.slmhsa = SpatialWindowAttention(embed_dim, num_heads,
                                             window_size, dropout)
        self.spatial_ffn = MlpDWBN(embed_dim, ffn_hidden_ratio * embed_dim,
                                   embed_dim, spatial, dropout)
        self.temporal_mhsa = TemporalAttention(embed_dim, num_heads, dropout)
        self.linear1 = nn.Linear(embed_dim, dim_feedforward)
        self.linear2 = nn.Linear(dim_feedforward, embed_dim)

    def _drop(self, x, rng, tag):
        return dropout(x, self.dropout, self.training, fold(rng, tag))

    def _linear_ffn(self, x, rng):
        y = self._drop(gelu(lin(x, self.linear1)), rng, "drop_ffn1")
        return self._drop(lin(y, self.linear2), rng, "drop_ffn2")

    def forward(self, x, beta, gamma, temporal_allow=None, rng=None):
        x1 = self.norm1(x)
        attn = self.slmhsa(pos_feat_fuse(x1, beta, gamma), x1,
                           fold(rng, "slmhsa"))
        x = x + self.drop_path(attn, fold(rng, "drop_path1"))
        x = x + self.drop_path(self.spatial_ffn(self.norm2(x),
                                                fold(rng, "spatial_ffn")),
                               fold(rng, "drop_path2"))
        x1 = self.norm3(x)
        if temporal_allow is None:
            temporal_allow = encoder_temporal_allow(x.shape[1],
                                                    device=x.device)
        temp = pos_feat_fuse(x1, beta, gamma)
        tattn = self.temporal_mhsa(temp, temp, x1, temporal_allow,
                                   fold(rng, "temporal_mhsa"))
        x = x + self._drop(tattn, rng, "drop_temporal")
        return x + self._linear_ffn(self.norm4(x), rng)


class BlockDecNAR(BlockEnc):
    """Decoder block: window MHSA over target + event query → conv FFN →
    temporal self-attention → linear FFN → cross-attention to the memory →
    conv FFN."""

    n_norms = 6

    def __init__(self, embed_dim, num_heads, window_size=4, dropout=0.0,
                 drop_path=0.0, ffn_hidden_ratio=4, dim_feedforward=1024,
                 spatial=(8, 8)):
        super().__init__(embed_dim, num_heads, window_size, dropout,
                         drop_path, ffn_hidden_ratio, dim_feedforward,
                         spatial)
        self.enc_dec_attn = TemporalAttention(embed_dim, num_heads, dropout)
        self.spatial_ffn1 = MlpDWBN(embed_dim, ffn_hidden_ratio * embed_dim,
                                    embed_dim, spatial, dropout)

    def forward(self, tgt, query_evt, memory, mem_pos, tgt_pos,
                self_allow=None, cross_allow=None, rng=None):
        (mb, mg), (tb, tg) = mem_pos, tgt_pos
        dp = lambda y, tag: self.drop_path(y, fold(rng, tag))  # noqa: E731
        t2 = self.norm1(tgt)
        attn = self.slmhsa(pos_feat_fuse(t2 + query_evt, tb, tg), t2,
                           fold(rng, "slmhsa"))
        t2 = tgt + dp(attn, "drop_path1")
        t2 = t2 + dp(self.spatial_ffn(self.norm2(t2),
                                      fold(rng, "spatial_ffn")), "drop_path2")
        t_in = self.norm3(t2)
        temp = pos_feat_fuse(t_in, tb, tg)
        tattn = self.temporal_mhsa(temp, temp, t_in, self_allow,
                                   fold(rng, "temporal_mhsa"))
        t2 = t2 + self._drop(tattn, rng, "drop_temporal")
        t2 = t2 + self._linear_ffn(self.norm4(t2), rng)
        q_in = self.norm5(t2)
        cattn = self.enc_dec_attn(pos_feat_fuse(q_in + query_evt, tb, tg),
                                  pos_feat_fuse(memory, mb, mg), memory,
                                  cross_allow, fold(rng, "enc_dec_attn"))
        t2 = t2 + dp(cattn, "drop_path3")
        return t2 + dp(self.spatial_ffn1(self.norm6(t2),
                                         fold(rng, "spatial_ffn1")),
                       "drop_path4")


class Stack(nn.Module):
    """``num_layers`` blocks ``layer_0`` …, each with its own stream."""

    def __init__(self, block, num_layers, *args, **kw):
        super().__init__()
        self.num_layers = num_layers
        for i in range(num_layers):
            self.add_module(f"layer_{i}", block(*args, **kw))

    def forward(self, x, *args, rng=None):
        for i in range(self.num_layers):
            x = getattr(self, f"layer_{i}")(x, *args,
                                            rng=fold(rng, f"layer_{i}"))
        return x


class NRMLP(nn.Module):
    """Fourier features of (M, 3) coordinates through a 4-layer MLP →
    (beta, gamma); the 'Add' fusion has gamma = 0."""

    def __init__(self, out_channels, d_model=256, mlp_layers=4):
        super().__init__()
        self.mlp_layers = mlp_layers
        self.B = nn.Parameter(torch.zeros(d_model, 3))
        self.mlp_0 = nn.Linear(2 * d_model, d_model)
        for i in range(mlp_layers - 2):
            self.add_module(f"mlp_{i + 1}", nn.Linear(d_model, d_model))
        self.mlp_beta = nn.Linear(d_model, out_channels)

    def forward(self, coords):
        proj = (2.0 * math.pi * coords) @ self.B.t()
        x = torch.cat([torch.cos(proj), torch.sin(proj)], dim=-1)
        x = torch.relu(lin(x, self.mlp_0))
        for i in range(self.mlp_layers - 2):
            x = torch.relu(lin(x, getattr(self, f"mlp_{i + 1}")))
        beta = lin(x, self.mlp_beta)
        return beta, torch.zeros_like(beta)


class EventEncoder(nn.Module):
    """(N, H, W, C) event coding → latent mean, log-variance and
    ``z = mu + exp(logvar / 2)·eps``."""

    def __init__(self, channels, hidden, n_layers=1, stochastic=True):
        super().__init__()
        self.n_layers, self.stochastic = n_layers, stochastic
        self.conv1 = ConvBNAct(channels, channels, 3, groups=channels)
        self.conv2 = ConvBNAct(channels, hidden, 3)
        for i in range(n_layers):
            self.add_module(f"mlp_{i}", ConvBNAct(hidden, hidden, 1))
        self.mu_net = nn.Conv2d(hidden, channels, 1)
        if stochastic:
            self.logvar_net = nn.Conv2d(hidden, channels, 1)

    def forward(self, x, eps=None):
        x = self.conv2(self.conv1(x))
        for i in range(self.n_layers):
            x = getattr(self, f"mlp_{i}")(x)
        mu = conv(x, self.mu_net)
        if not self.stochastic:
            return mu
        logvar = conv(x, self.logvar_net)
        z = mu if eps is None else mu + torch.exp(0.5 * logvar) * eps
        return z, mu, logvar


class PredictorOutput(NamedTuple):
    pred_features: torch.Tensor
    mu_o: Optional[torch.Tensor] = None
    logvar_o: Optional[torch.Tensor] = None
    mu_p: Optional[torch.Tensor] = None
    logvar_p: Optional[torch.Tensor] = None


class Predictor(nn.Module):
    """Coordinates → NRMLP (beta, gamma); observed features → EVT-Former →
    event coding (temporal mean) → latent; latent as event query → NAR
    decoder from zeros, cross-attending the EVT-Former's output; one final
    LayerNorm shared by both stacks' outputs, then ReLU.

    Static mode: observed and target tensors have their own lengths.
    Masked mode (``obs_mask``/``tgt_mask``, boolean (T,)): both are the
    full clip and the masks select."""

    def __init__(self, embed_dim=512, num_heads=8, window_size=4,
                 transformer_layers=8, evt_former_num_layers=4,
                 evt_hidden_channels=256, stochastic=False, dropout=0.0,
                 drop_path=0.0, ffn_hidden_ratio=4, dim_feedforward=1024,
                 spatial=(8, 8)):
        super().__init__()
        kw = dict(window_size=window_size, dropout=dropout,
                  drop_path=drop_path, ffn_hidden_ratio=ffn_hidden_ratio,
                  dim_feedforward=dim_feedforward, spatial=tuple(spatial))
        self.stochastic = stochastic
        self.nrmlp = NRMLP(embed_dim)
        self.evt_former_stack = Stack(BlockEnc, evt_former_num_layers,
                                      embed_dim, num_heads, **kw)
        self.evt_posterior = EventEncoder(embed_dim, evt_hidden_channels, 1,
                                          stochastic)
        if stochastic:
            self.evt_prior = EventEncoder(embed_dim, evt_hidden_channels, 1,
                                          True)
        self.decoder = Stack(BlockDecNAR, transformer_layers, embed_dim,
                             num_heads, **kw)
        self.final_norm = TokenLayerNorm(embed_dim)

    def event_coding(self, feats, beta, gamma, mask=None, rng=None):
        if mask is not None:
            feats = feats * mask.float()[None, :, None, None, None]
        allow = encoder_temporal_allow(feats.shape[1], mask, feats.device)
        x = self.final_norm(self.evt_former_stack(feats, beta, gamma, allow,
                                                  rng=rng))
        if mask is None:
            return x, x.mean(dim=1)
        m = mask.float()
        return x, ((x * m[None, :, None, None, None]).sum(dim=1)
                   / torch.clamp(m.sum(), min=1.0))

    def _latent(self, encoder, coding, eps, rng, tag):
        if eps is None and rng is not None:
            eps = rng.fold(tag).normal(coding.shape, coding.device)
        return encoder(coding, eps)

    def forward(self, feats, obs_coords, tgt_coords, eps_prior=None, *,
                target_feats_gt=None, obs_mask=None, tgt_mask=None,
                rng: Optional[Rng] = None) -> PredictorOutput:
        ob, og = self.nrmlp(obs_coords)
        pb, pg = self.nrmlp(tgt_coords)
        memory, coding = self.event_coding(feats, ob, og, obs_mask,
                                           fold(rng, "observe"))
        N, To, H, W, _ = feats.shape
        TP = tgt_coords.shape[0] // (H * W)
        self_allow = (None if tgt_mask is None
                      else tgt_mask.bool()[None, :].expand(TP, TP))
        cross_allow = (None if obs_mask is None
                       else obs_mask.bool()[None, :].expand(TP, To))
        mu_o = logvar_o = mu_p = logvar_p = None
        if self.stochastic:
            z, mu_o, logvar_o = self._latent(self.evt_prior, coding,
                                             eps_prior, rng, "latent_prior")
            if target_feats_gt is not None:
                _, pcoding = self.event_coding(target_feats_gt, pb, pg,
                                               tgt_mask, fold(rng, "predict"))
                zp, mu_p, logvar_p = self._latent(
                    self.evt_posterior, pcoding, None, rng, "latent_post")
                if self.training:
                    z = zp
        else:
            z = self.evt_posterior(coding)
        tgt = torch.zeros((N, TP, H, W, feats.shape[-1]), device=feats.device)
        out = self.decoder(tgt, z[:, None], memory, (ob, og), (pb, pg),
                           self_allow, cross_allow, rng=fold(rng, "decoder"))
        return PredictorOutput(torch.relu(self.final_norm(out)), mu_o,
                               logvar_o, mu_p, logvar_p)


# -------------------------------------------------------------------- AE


class NonLocal2D(nn.Module):
    """Global spatial attention over 2×2 max-pooled keys and values,
    unscaled logits, output projection, BatchNorm, ReLU and a residual
    gate ``gamma``."""

    def __init__(self, C, attn_ratio=8, value_ratio=2):
        super().__init__()
        self.wq = nn.Linear(C, C // attn_ratio)
        self.wk = nn.Linear(C, C // attn_ratio)
        self.wv = nn.Linear(C, C // value_ratio)
        self.out_proj = nn.Linear(C // value_ratio, C)
        self.bn = BatchNorm(C)
        self.gamma = nn.Parameter(torch.zeros(()))

    def forward(self, x):
        pool = lambda t: F.max_pool2d(  # noqa: E731
            t.permute(0, 3, 1, 2), 2, 2).permute(0, 2, 3, 1)
        q = lin(x, self.wq)
        k, v = pool(lin(x, self.wk)), pool(lin(x, self.wv))
        N, h, w, _ = q.shape
        logits = einsum("nhwa,nija->nhwij", q, k).reshape(N, h, w, -1)
        weights = PREC(torch.softmax(logits, dim=-1)).reshape(
            N, h, w, k.shape[1], k.shape[2])
        out = einsum("nhwij,nijv->nhwv", weights, v)
        return x + self.gamma * torch.relu(self.bn(lin(out, self.out_proj)))


class ConvAttn(nn.Module):
    """Residual 3×3 ConvBN, then the non-local attention; a residual
    around both."""

    def __init__(self, C):
        super().__init__()
        self.spatial_conv = ConvBNAct(C, C, 3, use_bias=True)
        self.attn2d = NonLocal2D(C)

    def forward(self, x):
        return self.attn2d(self.spatial_conv(x) + x) + x


class ResnetBlock(nn.Module):
    def __init__(self, C):
        super().__init__()
        self.conv1 = ConvBNAct(C, C, 3, padding="VALID")
        self.conv2 = ConvBNAct(C, C, 3, padding="VALID", activation=None)

    def forward(self, x):
        return x + self.conv2(reflect_pad(self.conv1(reflect_pad(x, 1)), 1))


class Encoder(nn.Module):
    def __init__(self, img_channels=1, ngf=64, n_down=3, n_res=2):
        super().__init__()
        self.n_down, self.n_res = n_down, n_res
        self.block0 = ConvBNAct(img_channels, ngf, 7, padding="VALID")
        self.block1 = ConvBNAct(ngf, ngf * 2, 3, stride=2)
        c = ngf * 2
        for i in range(1, n_down):
            self.add_module(f"block{i + 1}_attn", ConvAttn(c))
            self.add_module(f"block{i + 1}_conv",
                            ConvBNAct(c, c * 2, 3, stride=2))
            c *= 2
        for i in range(n_res):
            self.add_module(f"res_attn_{i}", ConvAttn(c))
            self.add_module(f"res_conv_{i}", ResnetBlock(c))

    def forward(self, x):
        N, T = x.shape[:2]
        x = x.reshape((N * T,) + x.shape[2:])
        x = self.block1(self.block0(reflect_pad(x, 3)))
        for i in range(1, self.n_down):
            x = getattr(self, f"block{i + 1}_conv")(
                getattr(self, f"block{i + 1}_attn")(x))
        for i in range(self.n_res):
            x = getattr(self, f"res_conv_{i}")(
                getattr(self, f"res_attn_{i}")(x))
        x = torch.relu(x)
        return x.reshape((N, T) + x.shape[1:])


class Decoder(nn.Module):
    def __init__(self, out_channels=1, ngf=64, n_down=3, out_layer="Tanh"):
        super().__init__()
        self.n_down, self.out_layer = n_down, out_layer
        c = ngf * 2 ** n_down
        for i in range(n_down):
            f = ngf * 2 ** (n_down - i) // 2
            self.add_module(f"up{i}_conv", nn.ConvTranspose2d(
                c, f, 3, stride=2, padding=1, output_padding=1, bias=False))
            self.add_module(f"up{i}_bn", BatchNorm(f))
            c = f
        self.head = nn.Conv2d(c, out_channels, 7)

    def forward(self, x):
        N, T = x.shape[:2]
        x = x.reshape((N * T,) + x.shape[2:])
        for i in range(self.n_down):
            up = getattr(self, f"up{i}_conv")
            y = PREC(F.conv_transpose2d(PREC(x.permute(0, 3, 1, 2)),
                                        PREC(up.weight), None, 2, 1, 1))
            x = torch.relu(getattr(self, f"up{i}_bn")(y.permute(0, 2, 3, 1)))
        x = conv(reflect_pad(x, 3), self.head)
        x = torch.tanh(x) if self.out_layer == "Tanh" else torch.sigmoid(x)
        return x.reshape((N, T) + x.shape[1:])


class AutoEncoder(nn.Module):
    def __init__(self, img_channels=1, ngf=64, n_down=3, n_res=2,
                 out_layer="Tanh"):
        super().__init__()
        self.encoder = Encoder(img_channels, ngf, n_down, n_res)
        self.decoder = Decoder(img_channels, ngf, n_down, out_layer)

    def encode(self, x):
        return self.encoder(x)

    def decode(self, feats):
        return self.decoder(feats)


def build(config: dict, device="cpu"):
    """(AutoEncoder, Predictor) of a configuration dict (the groups
    ``Dataset``, ``AE``, ``Predictor`` as the benchmark's configuration
    files hold them), in float32 on ``device``."""
    d, a, p = config["Dataset"], config["AE"], config["Predictor"]
    if a.get("learn_3d") or p.get("fuse_method", "Add") != "Add" or \
            p.get("param_free_norm_type", "layer") != "layer" or \
            not p.get("evt_former", True):
        raise ValueError("the reference covers learn_3d=False, Add fusion, "
                         "layer norm and the EVT-Former only")
    with torch.device(device):
        ae = AutoEncoder(d["img_channels"], a["ngf"], a["n_downsampling"],
                         a["num_res_blocks"], a["out_layer"])
        pred = Predictor(
            p["embed_dim"], p["num_heads"], p["window_size"],
            p["transformer_layers"], p["evt_former_num_layers"],
            p["evt_hidden_channels"], p["stochastic"], p["dropout"],
            p["drop_path"], p["Spatial_FFN_hidden_ratio"],
            p["dim_feedforward"], (p["max_H"], p["max_W"]))
    return ae, pred


def coordinate_grid(t_list, max_T, max_H, max_W, device="cpu"):
    """(T·H·W, 3) grid of (t/max_T, h/max_H, w/max_W) over the full
    spatial grid."""
    t = torch.as_tensor([float(v) for v in t_list],
                        dtype=torch.float32) / max_T
    h = torch.arange(max_H, dtype=torch.float32) / max_H
    w = torch.arange(max_W, dtype=torch.float32) / max_W
    T, H, W = len(t), max_H, max_W
    grid = torch.stack([t[:, None, None].expand(T, H, W),
                        h[None, :, None].expand(T, H, W),
                        w[None, None, :].expand(T, H, W)], -1)
    return grid.reshape(-1, 3).to(device)
