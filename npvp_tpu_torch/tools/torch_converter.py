"""Reference (PyTorch Lightning) checkpoint → flax variable trees (port of
``npvp_tpu/tools/torch_converter.py``).

Ingests the NPVP authors' released checkpoints (stage-1 ``LitAE`` and
stage-2 ``LitPredictor`` Lightning ``.ckpt`` files, plus the I3D weights
used for FVD) and emits the flax-shaped numpy trees of ``FrameAutoEncoder``
/ ``NPPredictor`` / ``InceptionI3d`` that both packages take: the JAX
modules directly, the port's through ``npvp_tpu_torch.tools.weights.
load_flax``. So one mapping serves both, and published results reproduce
without retraining.

A Lightning checkpoint pickles objects of its training run's classes
(hyper-parameters, callbacks) that need not be installed where it is
converted. :func:`load_lightning_state_dict` reads it with
``torch.load(weights_only=True)``, each such class standing in as an empty
mapping, so no code of the checkpoint's runs and ``pytorch_lightning`` is
never imported.

Layout conversions (held numerically against torch layers in
tests/test_torch_tools.py):

- Conv2d (O, I, kh, kw) → HWIO; depthwise groups keep the same permute.
- ConvTranspose2d (I, O, kh, kw) → flax ``transpose_kernel=True`` (kh, kw, O, I).
- Linear (O, I) → (I, O).
- nn.MultiheadAttention packed ``in_proj_weight`` (3C, C) → wq/wk/wv
  DenseGeneral kernels (C, heads, head_dim); ``out_proj`` → wo
  (heads, head_dim, C).
- LayerNorm over (C, H, W) → LayerNormHWC affine (H, W, C).
- BatchNorm weight/bias → scale/bias params; running stats → batch_stats.
"""

from __future__ import annotations

import collections
import re
import sys
from typing import Dict, Tuple

import numpy as np
import torch


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.detach().cpu().numpy()
    return np.asarray(t)


# --- leaf-level converters --------------------------------------------------

def conv2d_kernel(w) -> np.ndarray:
    return _np(w).transpose(2, 3, 1, 0)  # OIHW → HWIO


def conv3d_kernel(w) -> np.ndarray:
    return _np(w).transpose(2, 3, 4, 1, 0)  # OIDHW → DHWIO


def conv_transpose2d_kernel(w) -> np.ndarray:
    return _np(w).transpose(2, 3, 1, 0)  # IOHW → HW-O-I (transpose_kernel)


def linear_kernel(w) -> np.ndarray:
    return _np(w).T


def layernorm_chw(w) -> np.ndarray:
    return _np(w).transpose(1, 2, 0)  # (C, H, W) → (H, W, C)


def mha_params(sd: Dict, prefix: str, num_heads: int) -> Dict:
    """Packed torch MultiheadAttention → {wq, wk, wv, wo} DenseGeneral trees."""
    prefix = prefix + "." if prefix else ""
    w = _np(sd[f"{prefix}in_proj_weight"])
    b = _np(sd[f"{prefix}in_proj_bias"])
    C = w.shape[1]
    hd = C // num_heads
    wq, wk, wv = w[:C], w[C:2 * C], w[2 * C:]
    bq, bk, bv = b[:C], b[C:2 * C], b[2 * C:]
    out = {}
    for name, wi, bi in (("wq", wq, bq), ("wk", wk, bk), ("wv", wv, bv)):
        out[name] = {"kernel": wi.T.reshape(C, num_heads, hd),
                     "bias": bi.reshape(num_heads, hd)}
    wo = _np(sd[f"{prefix}out_proj.weight"])
    out["wo"] = {"kernel": wo.T.reshape(num_heads, hd, C),
                 "bias": _np(sd[f"{prefix}out_proj.bias"])}
    return out


def _conv(sd, key, bias=True, transpose=False, conv3d=False) -> Dict:
    kernel = (conv_transpose2d_kernel(sd[f"{key}.weight"]) if transpose
              else conv3d_kernel(sd[f"{key}.weight"]) if conv3d
              else conv2d_kernel(sd[f"{key}.weight"]))
    out = {"kernel": kernel}
    if bias and f"{key}.bias" in sd:
        out["bias"] = _np(sd[f"{key}.bias"])
    return out


def _linear(sd, key) -> Dict:
    out = {"kernel": linear_kernel(sd[f"{key}.weight"])}
    if f"{key}.bias" in sd:
        out["bias"] = _np(sd[f"{key}.bias"])
    return out


def _bn(sd, key) -> Tuple[Dict, Dict]:
    params = {"scale": _np(sd[f"{key}.weight"]),
              "bias": _np(sd[f"{key}.bias"])}
    stats = {"mean": _np(sd[f"{key}.running_mean"]),
             "var": _np(sd[f"{key}.running_var"])}
    return params, stats


def _ln(sd, key) -> Dict:
    return {"scale": _np(sd[f"{key}.weight"]),
            "bias": _np(sd[f"{key}.bias"])}


def _ln_chw(sd, key) -> Dict:
    return {"scale": layernorm_chw(sd[f"{key}.weight"]),
            "bias": layernorm_chw(sd[f"{key}.bias"])}


# --- module-level assemblers ------------------------------------------------

class _Tree:
    """Accumulates params/batch_stats at slash-separated paths."""

    def __init__(self):
        self.params: Dict = {}
        self.stats: Dict = {}

    def put(self, path: str, leaf_tree: Dict, stats: bool = False):
        root = self.stats if stats else self.params
        node = root
        parts = path.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node.setdefault(parts[-1], {}).update(leaf_tree)

    def conv_bn_act(self, sd, torch_conv, torch_bn, path, bias=False):
        self.put(f"{path}/conv", _conv(sd, torch_conv, bias=bias))
        p, s = _bn(sd, torch_bn)
        self.put(f"{path}/bn", p)
        self.put(f"{path}/bn", s, stats=True)

    def nonlocal_attn(self, sd, torch_prefix, path):
        for t_name, f_name in (("Wq", "wq"), ("Wk", "wk"), ("Wv", "wv"),
                               ("out_proj", "out_proj")):
            self.put(f"{path}/{f_name}", _linear(sd, f"{torch_prefix}.{t_name}"))
        p, s = _bn(sd, f"{torch_prefix}.norm_func")
        self.put(f"{path}/bn", p)
        self.put(f"{path}/bn", s, stats=True)
        self.put(path, {"gamma": _np(sd[f"{torch_prefix}.gamma"])})

    def variables(self) -> Dict:
        return {"params": self.params, "batch_stats": self.stats}


def convert_ae(sd: Dict, n_downsampling: int = 3, num_res_blocks: int = 2,
               learn_3d: bool = False) -> Dict:
    """LitAE state_dict (keys VPTR_Enc.* / VPTR_Dec.*) → FrameAutoEncoder
    variables (reference models/ResNetAutoEncoder.py structure)."""
    t = _Tree()
    E = "VPTR_Enc"
    enc = "encoder"
    t.conv_bn_act(sd, f"{E}.block0.1", f"{E}.block0.2", f"{enc}/block0")
    t.conv_bn_act(sd, f"{E}.block1.0", f"{E}.block1.1", f"{enc}/block1")

    def fact_attn(torch_prefix, path):
        t.conv_bn_act(sd, f"{torch_prefix}.spatial_conv.0",
                      f"{torch_prefix}.spatial_conv.1",
                      f"{path}/spatial_conv", bias=True)
        t.nonlocal_attn(sd, f"{torch_prefix}.attn2d", f"{path}/attn2d")
        if learn_3d:
            t.put(f"{path}/temporal_conv",
                  {"kernel": _np(sd[f"{torch_prefix}.temporal_conv.0.weight"]
                                 ).transpose(2, 1, 0),
                   "bias": _np(sd[f"{torch_prefix}.temporal_conv.0.bias"])})
            p, s = _bn(sd, f"{torch_prefix}.temporal_conv.1")
            t.put(f"{path}/temporal_bn", p)
            t.put(f"{path}/temporal_bn", s, stats=True)
            t.nonlocal_attn(sd, f"{torch_prefix}.attn1d", f"{path}/attn1d")

    for i in range(1, n_downsampling):
        fact_attn(f"{E}.block{i + 1}_3dConvAttn", f"{enc}/block{i + 1}_attn")
        t.conv_bn_act(sd, f"{E}.block{i + 1}_conv.0",
                      f"{E}.block{i + 1}_conv.1", f"{enc}/block{i + 1}_conv")
    for i in range(num_res_blocks):
        fact_attn(f"{E}.res_3dConvAttn_{i}", f"{enc}/res_attn_{i}")
        t.conv_bn_act(sd, f"{E}.res_conv_{i}.conv_block.1",
                      f"{E}.res_conv_{i}.conv_block.2",
                      f"{enc}/res_conv_{i}/conv1")
        t.conv_bn_act(sd, f"{E}.res_conv_{i}.conv_block.5",
                      f"{E}.res_conv_{i}.conv_block.6",
                      f"{enc}/res_conv_{i}/conv2")

    D = "VPTR_Dec"
    dec = "decoder"
    for i in range(n_downsampling):
        t.put(f"{dec}/up{i}_conv",
              _conv(sd, f"{D}.model.{3 * i}", bias=False, transpose=True))
        p, s = _bn(sd, f"{D}.model.{3 * i + 1}")
        t.put(f"{dec}/up{i}_bn", p)
        t.put(f"{dec}/up{i}_bn", s, stats=True)
    t.put(f"{dec}/head", _conv(sd, f"{D}.model.{3 * n_downsampling + 1}"))
    return t.variables()


def _mlp_dwbn(t: _Tree, sd, torch_prefix, path):
    t.put(f"{path}/fc1", _conv(sd, f"{torch_prefix}.fc1"))
    t.put(f"{path}/norm1", _ln_chw(sd, f"{torch_prefix}.norm1"))
    t.put(f"{path}/dw3x3", _conv(sd, f"{torch_prefix}.dw3x3"))
    t.put(f"{path}/norm2", _ln_chw(sd, f"{torch_prefix}.norm2"))
    t.put(f"{path}/fc2", _conv(sd, f"{torch_prefix}.fc2"))
    t.put(f"{path}/norm3", _ln_chw(sd, f"{torch_prefix}.norm3"))


def _former_block(t: _Tree, sd, tp, path, num_heads, decoder=False):
    t.put(f"{path}/slmhsa/attn", mha_params(sd, f"{tp}.SLMHSA.attn",
                                            num_heads))
    _mlp_dwbn(t, sd, f"{tp}.SpatialFFN", f"{path}/spatial_ffn")
    for i in range(1, 5):
        t.put(f"{path}/norm{i}", _ln(sd, f"{tp}.norm{i}"))
    t.put(f"{path}/temporal_mhsa/attn",
          mha_params(sd, f"{tp}.temporal_MHSA", num_heads))
    t.put(f"{path}/linear1", _linear(sd, f"{tp}.linear1"))
    t.put(f"{path}/linear2", _linear(sd, f"{tp}.linear2"))
    if decoder:
        t.put(f"{path}/enc_dec_attn/attn",
              mha_params(sd, f"{tp}.EncDecAttn", num_heads))
        _mlp_dwbn(t, sd, f"{tp}.SpatialFFN1", f"{path}/spatial_ffn1")
        t.put(f"{path}/norm5", _ln(sd, f"{tp}.norm5"))
        t.put(f"{path}/norm6", _ln(sd, f"{tp}.norm6"))


def _event_encoder(t: _Tree, sd, tp, path, n_layers=1, stochastic=True):
    t.put(f"{path}/conv1/conv", _conv(sd, f"{tp}.conv1.0", bias=False))
    p, s = _bn(sd, f"{tp}.conv1.1")
    t.put(f"{path}/conv1/bn", p)
    t.put(f"{path}/conv1/bn", s, stats=True)
    t.put(f"{path}/conv2/conv", _conv(sd, f"{tp}.conv2.0", bias=False))
    p, s = _bn(sd, f"{tp}.conv2.1")
    t.put(f"{path}/conv2/bn", p)
    t.put(f"{path}/conv2/bn", s, stats=True)
    for i in range(n_layers):
        t.put(f"{path}/mlp_{i}/conv", _conv(sd, f"{tp}.MLP_{i}.0",
                                            bias=False))
        p, s = _bn(sd, f"{tp}.MLP_{i}.1")
        t.put(f"{path}/mlp_{i}/bn", p)
        t.put(f"{path}/mlp_{i}/bn", s, stats=True)
    t.put(f"{path}/mu_net", _conv(sd, f"{tp}.mu_net"))
    if stochastic and f"{tp}.logvar_net.weight" in sd:
        t.put(f"{path}/logvar_net", _conv(sd, f"{tp}.logvar_net"))


def convert_predictor(sd: Dict, num_heads: int = 8,
                      evt_former_num_layers: int = 4,
                      transformer_layers: int = 8, evt_n_layers: int = 1,
                      stochastic: bool = True, fuse_method: str = "Add"
                      ) -> Dict:
    """Predictor state_dict → NPPredictor variables
    (reference models/Predictor.py:265-359 structure)."""
    t = _Tree()
    t.put("nrmlp", {"B": _np(sd["nrmlp.B"])})
    mlp_count = 0
    for i in range(0, 100, 2):
        if f"nrmlp.MLP.{i}.weight" not in sd:
            break
        t.put(f"nrmlp/mlp_{mlp_count}", _linear(sd, f"nrmlp.MLP.{i}"))
        mlp_count += 1
    t.put("nrmlp/mlp_beta", _linear(sd, "nrmlp.mlp_beta"))
    if fuse_method == "SPADE" and "nrmlp.mlp_gamma.weight" in sd:
        t.put("nrmlp/mlp_gamma", _linear(sd, "nrmlp.mlp_gamma"))

    for i in range(evt_former_num_layers):
        _former_block(t, sd, f"EVT_Former.layers.{i}",
                      f"evt_former_stack/layer_{i}", num_heads)
    for i in range(transformer_layers):
        _former_block(t, sd, f"transformer.layers.{i}", f"decoder/layer_{i}",
                      num_heads, decoder=True)
    # shared final norm: EVT_Former.norm and transformer.norm are the same
    # tensor in the reference (models/Predictor.py:270 default-arg sharing)
    norm_key = ("transformer.norm" if "transformer.norm.weight" in sd
                else "EVT_Former.norm")
    t.put("final_norm", _ln(sd, norm_key))

    _event_encoder(t, sd, "evt_posterior", "evt_posterior", evt_n_layers,
                   stochastic)
    if stochastic and "evt_prior.mu_net.weight" in sd:
        _event_encoder(t, sd, "evt_prior", "evt_prior", evt_n_layers, True)
    return t.variables()


def strip_prefix(sd: Dict, prefix: str) -> Dict:
    out = {}
    for k, v in sd.items():
        if k.startswith(prefix + "."):
            out[k[len(prefix) + 1:]] = v
    return out


class _Opaque:
    """Stands in for a class of the checkpoint that is not allowlisted:
    unpickled, it is an empty ``OrderedDict`` (a type the weights-only
    unpickler fills and builds), whatever its arguments were."""

    def __new__(cls, *args, **kwargs):
        return collections.OrderedDict()


def load_lightning_state_dict(path: str) -> Dict:
    """Read a Lightning .ckpt (or bare state_dict) file with
    ``torch.load(weights_only=True)``: every global of its pickle that
    torch does not allow (Lightning's ``AttributeDict``, OmegaConf nodes,
    callbacks) is read as an empty ``OrderedDict`` (:class:`_Opaque`), so
    its class need not be installed and none of its code runs. Returns the
    ``state_dict`` with DDP's ``module.`` prefixes removed."""
    names = torch.serialization.get_unsafe_globals_in_checkpoint(path)
    with torch.serialization.safe_globals([(_Opaque, n) for n in names]):
        blob = torch.load(path, map_location="cpu", weights_only=True)
    sd = blob.get("state_dict", blob) if isinstance(blob, dict) else blob
    # legacy DDP prefixes (reference utils/train_summary.py:82-110)
    return {re.sub(r"^module\.", "", k): v for k, v in sd.items()}


def convert_lightning_ae(path: str, cfg) -> Dict:
    sd = load_lightning_state_dict(path)
    return convert_ae(sd, cfg.AE.n_downsampling, cfg.AE.num_res_blocks,
                      cfg.AE.learn_3d)


def convert_lightning_predictor(path: str, cfg) -> Tuple[Dict, Dict]:
    """LitPredictor ckpt → (predictor_vars, ae_vars) — the Lightning module
    also embeds the frozen AE (reference models/Predictor.py:18-25)."""
    sd = load_lightning_state_dict(path)
    p = cfg.Predictor
    pred_vars = convert_predictor(
        strip_prefix(sd, "predictor"), p.num_heads, p.evt_former_num_layers,
        p.transformer_layers, 1, p.stochastic, p.fuse_method)
    ae_vars = None
    if any(k.startswith("VPTR_Enc.") for k in sd):
        ae_vars = convert_ae(sd, cfg.AE.n_downsampling, cfg.AE.num_res_blocks,
                             cfg.AE.learn_3d)
    return pred_vars, ae_vars


# --- I3D (FVD) --------------------------------------------------------------

_I3D_BRANCH = {"b0": "b0", "b1a": "b1a", "b1b": "b1b", "b2a": "b2a",
               "b2b": "b2b", "b3b": "b3b"}


def convert_i3d(sd: Dict) -> Dict:
    """pytorch-i3d state_dict (reference utils/pytorch_i3d.py naming:
    ``Conv3d_1a_7x7.conv3d.weight``, ``Mixed_3b.b0.conv3d.weight``,
    ``...bn.weight`` …) → InceptionI3d variables."""
    t = _Tree()

    def unit(torch_prefix, path, bn=True):
        t.put(f"{path}/conv3d", _conv(sd, f"{torch_prefix}.conv3d",
                                      conv3d=True))
        if bn and f"{torch_prefix}.bn.weight" in sd:
            p, s = _bn(sd, f"{torch_prefix}.bn")
            t.put(f"{path}/bn", p)
            t.put(f"{path}/bn", s, stats=True)

    for name in ("Conv3d_1a_7x7", "Conv3d_2b_1x1", "Conv3d_2c_3x3"):
        unit(name, name)
    for mixed in ("Mixed_3b", "Mixed_3c", "Mixed_4b", "Mixed_4c", "Mixed_4d",
                  "Mixed_4e", "Mixed_4f", "Mixed_5b", "Mixed_5c"):
        for branch in _I3D_BRANCH:
            unit(f"{mixed}.{branch}", f"{mixed}/{branch}")
    unit("logits", "logits", bn=False)
    return t.variables()


def tf_hub_i3d_name(name: str) -> str:
    """Map a TF-hub Kinetics-I3D variable name to our module path (reference
    utils/convert_tf_pretrained.py:9-60 semantics, targeting the Flax tree):

    ``RGB/inception_i3d/Mixed_3b/Branch_1/Conv3d_0a_1x1/conv_3d/w:0`` →
    ``Mixed_3b/b1a/conv3d/kernel``.
    """
    leaf_map = {"w:0": "kernel", "b:0": "bias", "beta:0": "bias",
                "gamma:0": "scale", "moving_mean:0": "mean",
                "moving_variance:0": "var"}
    segs = [s for s in name.split("/") if s not in ("RGB", "inception_i3d")]
    out = []
    i = 0
    while i < len(segs):
        seg = segs[i]
        if seg.startswith("Mixed"):
            out.append(seg)
        elif seg.startswith("Branch"):
            branch = int(seg.split("_")[-1])
            i += 1
            conv = segs[i]
            # TF-hub's Mixed_5b branch 2 has swapped 0a/0b suffixes (typo in
            # the original release; reference handles it the same way)
            if "Mixed_5b" in name and branch == 2:
                out.append(f"b{branch}a" if "1x1" in conv else f"b{branch}b")
            elif "_0a_" in conv or conv.endswith("a_1x1"):
                out.append("b0" if branch == 0 else f"b{branch}a")
            else:
                out.append(f"b{branch}b")
        elif seg.startswith("Conv3d") or seg.startswith("Conv2d"):
            out.append(seg)
        elif seg == "Logits":
            out.append("logits")
            i += 1  # skip the inner Conv3d_0c_1x1 segment
        elif seg == "conv_3d":
            out.append("conv3d")
        elif seg == "batch_norm":
            out.append("bn")
        elif seg in leaf_map:
            out.append(leaf_map[seg])
        else:
            raise ValueError(f"unrecognized segment {seg!r} in {name!r}")
        i += 1
    return "/".join(out)


def convert_tf_hub_i3d(tf_vars: Dict[str, np.ndarray]) -> Dict:
    """TF-hub i3d-kinetics variable dict → InceptionI3d variables (reference
    utils/convert_tf_pretrained.py). TF conv kernels are already DHWIO —
    no permute; BN beta → bias with implicit scale = 1 (TF I3D uses
    center-only batch norm)."""
    t = _Tree()
    bn_dims: Dict[str, int] = {}
    for name, value in tf_vars.items():
        path = tf_hub_i3d_name(name)
        parts = path.split("/")
        leaf = parts[-1]
        value = np.asarray(value)
        stats = leaf in ("mean", "var")
        t.put("/".join(parts[:-1]), {leaf: value.reshape(value.shape[-1:])
                                     if leaf != "kernel" else value},
              stats=stats)
        if parts[-2] == "bn":
            bn_dims["/".join(parts[:-1])] = value.shape[-1]
    # TF I3D batch norm is affine-free in scale; our flax BN expects both
    for bn_path, dim in bn_dims.items():
        node = t.params
        for p in bn_path.split("/"):
            node = node.setdefault(p, {})
        node.setdefault("scale", np.ones(dim, np.float32))
        node.setdefault("bias", np.zeros(dim, np.float32))
    return t.variables()


def main(argv=None):
    """Write the converted tree, pickled, to ``--out``: ``load_flax`` (and
    for I3D ``npvp_tpu_torch.eval.fvd.FVD.from_checkpoint``) reads it, as
    the JAX package's modules do."""
    import argparse
    import pickle
    from pathlib import Path

    from npvp_tpu_torch.core.config import load_config

    parser = argparse.ArgumentParser(
        description="Convert reference PyTorch checkpoints to flax-shaped "
                    "numpy trees")
    parser.add_argument("--kind",
                        choices=["ae", "predictor", "i3d", "i3d_tf"],
                        required=True)
    parser.add_argument("--ckpt", required=True,
                        help="Lightning/pytorch .ckpt, or for i3d_tf a TF "
                             "checkpoint prefix / SavedModel variables file "
                             "(reference utils/convert_tf_pretrained.py)")
    parser.add_argument("--config_path")
    parser.add_argument("--out", required=True)
    args = parser.parse_args(argv)

    if args.kind == "i3d_tf":
        # direct TF-hub Kinetics-I3D ingestion — no torch intermediate
        try:
            import tensorflow as tf
        except ImportError as e:
            raise SystemExit(
                "--kind i3d_tf reads a TensorFlow checkpoint and needs the "
                f"tensorflow package, which is not installed ({e}); "
                "convert the pytorch-i3d weights with --kind i3d instead, "
                "or call convert_tf_hub_i3d on the variables read "
                "elsewhere") from None

        reader = tf.train.load_checkpoint(args.ckpt)
        tf_vars = {name: reader.get_tensor(name)
                   for name in reader.get_variable_to_shape_map()
                   if "Adam" not in name and "global_step" not in name}
        # checkpoint tensor names lack the ':0' suffix the hub module
        # variable names carry; normalize to the mapping's expectation
        tf_vars = {(n if n.endswith(":0") else n + ":0"): v
                   for n, v in tf_vars.items()}
        variables = convert_tf_hub_i3d(tf_vars)
    elif args.kind == "i3d":
        sd = load_lightning_state_dict(args.ckpt)
        variables = convert_i3d(sd)
    else:
        cfg = load_config(args.config_path)
        if args.kind == "ae":
            variables = convert_lightning_ae(args.ckpt, cfg)
        else:
            variables = convert_lightning_predictor(args.ckpt, cfg)[0]
    Path(args.out).write_bytes(pickle.dumps(variables))
    print(f"wrote {args.out}")


if __name__ == "__main__":
    main(sys.argv[1:])
