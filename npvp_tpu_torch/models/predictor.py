"""NP-based video predictor, NPVP-D and NPVP-S (port of
``npvp_tpu/models/predictor.py``).

Observed frame features plus continuous (t, h, w) coordinates → predicted
target-frame features, non-autoregressively, for any (fractional) target
times. Two modes, as in the JAX package:

- **static mode**: observed/target tensors have their own (To, TP) lengths
  and coordinates are given explicitly (serving, fixed-split training);
- **masked mode** (rand-context training): tensors keep the full ``max_T``
  layout and boolean (T,) ``obs_mask``/``tgt_mask`` select the split;
  attention masks and masked means make it equal to the compact
  computation.

The module's mode is flax's ``train`` flag: in training mode dropout and
DropPath are active, the EventEncoders' BatchNorms use and update batch
statistics, and NPVP-S decodes from the posterior latent; in eval mode it
decodes from the prior.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
from torch import nn

from npvp_tpu_torch.core.tracing import span
from npvp_tpu_torch.nn.layers import Rng, TokenLayerNorm, fold
from npvp_tpu_torch.nn.neural_process import (NRMLP, EventEncoder,
                                              pos_feat_fuse)
from npvp_tpu_torch.nn.vidhrformer import (VidHRFormerDecoderNAR,
                                           VidHRFormerEncoder,
                                           encoder_temporal_allow)


class PredictorOutput(NamedTuple):
    pred_features: torch.Tensor                 # (N, TP, H, W, C), ReLU'd
    mu_o: Optional[torch.Tensor] = None         # prior mean (N, H, W, C)
    logvar_o: Optional[torch.Tensor] = None
    mu_p: Optional[torch.Tensor] = None         # posterior mean
    logvar_p: Optional[torch.Tensor] = None


class NPPredictor(nn.Module):
    """NRMLP coordinate conditioning → EVT-Former event coding → latent
    (prior and posterior for NPVP-S) → event query → NAR decoder. One
    LayerNorm (``final_norm``) is shared by the EVT-Former output and the
    decoder output, as in the reference."""

    def __init__(self, embed_dim: int = 512, num_heads: int = 8,
                 window_size: int = 4, transformer_layers: int = 8,
                 evt_former: bool = True, evt_former_num_layers: int = 4,
                 evt_hidden_channels: int = 256, evt_n_layers: int = 1,
                 stochastic: bool = False, fuse_method: str = "Add",
                 norm_type: str = "layer", dropout: float = 0.0,
                 drop_path: float = 0.0, ffn_hidden_ratio: int = 4,
                 dim_feedforward: int = 1024, exec_mode: str = "xla",
                 remat: bool = False, spatial=(8, 8), dtype=torch.float32):
        super().__init__()
        if exec_mode not in ("xla", "pallas", "int8"):
            raise ValueError(f"unknown exec_mode {exec_mode!r}")
        # the positional fusion folds through the projections when it is an
        # affine map of the input: 'layer' norm + 'Add' fusion
        affine = fuse_method == "Add" and norm_type == "layer"
        self.evt_former, self.stochastic, self.norm_type = (
            evt_former, stochastic, norm_type)
        self.exec_mode, self.dtype = exec_mode, dtype
        block_kw = dict(window_size=window_size, dropout=dropout,
                        drop_path=drop_path,
                        ffn_hidden_ratio=ffn_hidden_ratio,
                        dim_feedforward=dim_feedforward, norm_type=norm_type,
                        affine_posfuse=affine, exec_mode=exec_mode,
                        spatial=tuple(spatial), dtype=dtype)
        self.nrmlp = NRMLP(embed_dim, fuse_method=fuse_method, dtype=dtype)
        if evt_former:
            self.evt_former_stack = VidHRFormerEncoder(
                evt_former_num_layers, embed_dim, num_heads, remat=remat,
                **block_kw)
        self.evt_posterior = EventEncoder(embed_dim, evt_hidden_channels,
                                          evt_n_layers, stochastic,
                                          dtype=dtype)
        if stochastic:
            self.evt_prior = EventEncoder(embed_dim, evt_hidden_channels,
                                          evt_n_layers, True, dtype=dtype)
        self.decoder = VidHRFormerDecoderNAR(
            transformer_layers, embed_dim, num_heads, remat=remat,
            **block_kw)
        self.final_norm = TokenLayerNorm(embed_dim, 1e-5, dtype=dtype,
                                         exec_mode=exec_mode)

    def event_coding(self, feats, pos_beta, pos_gamma, mask=None,
                     rng: Optional[Rng] = None):
        """EVT-Former over the context features → (per-frame features, the
        event coding: their temporal mean, over the frames of ``mask``
        only when one is given)."""
        if mask is not None:
            feats = feats * mask.to(feats.dtype)[None, :, None, None, None]
        if self.evt_former:
            allow = encoder_temporal_allow(feats.shape[1], mask,
                                           device=feats.device)
            x = self.final_norm(self.evt_former_stack(feats, pos_beta,
                                                      pos_gamma, allow, rng))
        else:
            x = pos_feat_fuse(feats, pos_beta, pos_gamma, self.norm_type)
        if mask is None:
            return x, x.mean(dim=1)
        m = mask.to(x.dtype)
        coding = (x * m[None, :, None, None, None]).sum(dim=1)
        return x, coding / torch.clamp(m.sum(), min=1.0)

    def _latent(self, encoder, coding, eps, sample_latent, rng, tag):
        """(z, mu, logvar) of a stochastic EventEncoder: ``eps`` as given,
        else drawn from ``rng`` when there is one; no noise (z = mu) when
        ``sample_latent`` is False or neither is given."""
        if not sample_latent:
            eps = None
        elif eps is None and rng is not None:
            eps = rng.fold(tag).normal(coding.shape, coding.device)
        return encoder(coding, eps)

    def forward(self, observed_feats, obs_coords, tgt_coords,
                eps_prior: Optional[torch.Tensor] = None, *,
                target_feats_gt: Optional[torch.Tensor] = None,
                obs_mask: Optional[torch.Tensor] = None,
                tgt_mask: Optional[torch.Tensor] = None,
                sample_latent: bool = True,
                eps_post: Optional[torch.Tensor] = None,
                rng: Optional[Rng] = None) -> PredictorOutput:
        """observed_feats (N, To, H, W, C); obs_coords / tgt_coords
        (To·H·W, 3) / (TP·H·W, 3) normalised grids (in masked mode To == TP
        == max_T, and ``obs_mask``/``tgt_mask`` are boolean (T,) tensors).

        NPVP-S: ``eps_prior``/``eps_post`` are the float32 latent noise of
        shape (N, H, W, C) of the prior and the posterior; when absent they
        are drawn from ``rng``, and without ``rng`` the means are taken.
        ``target_feats_gt`` (the target frames' features) feeds the
        posterior, which training decodes from. ``rng`` also feeds dropout
        and DropPath in training mode."""
        with span("npvp.predictor"):
            with span("npvp.predictor.nrmlp"):
                op_beta, op_gamma = self.nrmlp(obs_coords)
                pp_beta, pp_gamma = self.nrmlp(tgt_coords)
            with span("npvp.predictor.encoder"):
                memory, coding = self.event_coding(
                    observed_feats, op_beta, op_gamma, obs_mask,
                    fold(rng, "observe"))
            N, To, H, W, _ = observed_feats.shape
            TP = tgt_coords.shape[0] // (H * W)
            self_allow = cross_allow = None
            if tgt_mask is not None:
                self_allow = tgt_mask.bool()[None, :].expand(TP, TP)
            if obs_mask is not None:
                cross_allow = obs_mask.bool()[None, :].expand(TP, To)
            mu_o = logvar_o = mu_p = logvar_p = None
            with span("npvp.predictor.latent"):
                if self.stochastic:
                    z, mu_o, logvar_o = self._latent(
                        self.evt_prior, coding, eps_prior, sample_latent,
                        rng, "latent_prior")
                    if target_feats_gt is not None:
                        _, pcoding = self.event_coding(
                            target_feats_gt, pp_beta, pp_gamma, tgt_mask,
                            fold(rng, "predict"))
                        zp, mu_p, logvar_p = self._latent(
                            self.evt_posterior, pcoding, eps_post,
                            sample_latent, rng, "latent_post")
                        if self.training:
                            z = zp
                else:
                    z = self.evt_posterior(coding)
            with span("npvp.predictor.decoder"):
                out = self.decoder(z[:, None], memory, (op_beta, op_gamma),
                                   (pp_beta, pp_gamma), self_allow,
                                   cross_allow, fold(rng, "decoder"))
            return PredictorOutput(torch.relu(self.final_norm(out)), mu_o,
                                   logvar_o, mu_p, logvar_p)


def build_predictor(cfg, dtype=torch.float32,
                    exec_mode: Optional[str] = None) -> NPPredictor:
    """NPPredictor from a Config; ``exec_mode`` overrides
    ``cfg.Predictor.exec_mode`` ("xla": plain PyTorch ops, "pallas": the
    hand-written attention kernel in eval mode, "int8": dynamic int8
    projections and feed-forward products, the plain attention)."""
    p = cfg.Predictor
    return NPPredictor(
        embed_dim=p.embed_dim, num_heads=p.num_heads,
        window_size=p.window_size,
        transformer_layers=p.transformer_layers, evt_former=p.evt_former,
        evt_former_num_layers=p.evt_former_num_layers,
        evt_hidden_channels=p.evt_hidden_channels, stochastic=p.stochastic,
        fuse_method=p.fuse_method, norm_type=p.param_free_norm_type,
        dropout=p.dropout, drop_path=p.drop_path,
        ffn_hidden_ratio=p.Spatial_FFN_hidden_ratio,
        dim_feedforward=p.dim_feedforward,
        exec_mode=exec_mode if exec_mode is not None else p.exec_mode,
        remat=p.remat, spatial=(p.max_H, p.max_W), dtype=dtype)
