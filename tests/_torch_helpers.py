"""Shared helpers of the PyTorch-port parity tests: random flax variables as
numpy trees, the tiny configuration the slice tests run, flax variables
written as the reference's (PyTorch Lightning) state dicts for the
converter's tests and ``chip_smoke.py`` (these import no JAX), and two
datasets for the loader's worker processes (light to import): one whose
item 5 fails, one that sleeps in every fetch."""

from __future__ import annotations

import numpy as np


def random_variables(init, *args, seed: int = 0):
    """Random flax variables of the module whose ``init`` is given, as a
    numpy tree: shapes from ``jax.eval_shape`` (a trace, no compile), values
    from ``seed`` with every leaf nonzero, so that a wrong kernel, bias,
    scale or statistic mapping shows. Kernels ~ N(0, 1/fan_in), biases and
    means ~ N(0, 0.1²), norm scales ~ 1 + N(0, 0.1²), variances in
    [0.5, 1.5], NRMLP's B ~ N(0, 10²), gates ~ N(0, 0.5²)."""
    import jax

    shapes = jax.eval_shape(init, *args)
    rng = np.random.default_rng(seed)

    def leaf(name, shape):
        n = lambda s=1.0: s * rng.standard_normal(shape)  # noqa: E731
        if name == "kernel":
            return n(1.0 / np.sqrt(max(1, int(np.prod(shape[:-1])))))
        if name == "var":
            return rng.uniform(0.5, 1.5, shape)
        if name == "scale":
            return 1.0 + n(0.1)
        if name == "B":
            return n(10.0)
        if name == "gamma":
            return n(0.5)
        return n(0.1)

    def walk(node, name=""):
        if hasattr(node, "items"):
            return {k: walk(v, k) for k, v in node.items()}
        return np.asarray(leaf(name, tuple(node.shape)), np.float32)

    return walk(shapes)


def tiny_config(stochastic: bool = False):
    """32×32×1 frames, AE ngf 4 with 3 downsamplings (4×4×32 latent),
    embed 32, 4 heads, window 2, 2 decoder + 2 EVT-Former layers, max_T 8;
    built on the JAX package's Config (the port's schema is a copy)."""
    from npvp_tpu.core.config import Config

    cfg = Config()
    d, a, p = cfg.Dataset, cfg.AE, cfg.Predictor
    d.img_size, d.img_channels = 32, 1
    d.num_past_frames = d.num_future_frames = 4
    a.ngf, a.n_downsampling, a.num_res_blocks = 4, 3, 1
    p.embed_dim, p.num_heads, p.window_size = 32, 4, 2
    p.transformer_layers = p.evt_former_num_layers = 2
    p.dim_feedforward, p.evt_hidden_channels = 64, 16
    p.Spatial_FFN_hidden_ratio = 2
    p.max_T, p.max_H, p.max_W = 8, 4, 4
    p.stochastic, p.exec_mode = stochastic, "pallas"
    return cfg.validate()


def parallel_config(dropout=0.0, stochastic=True, layers=2):
    """tiny_config for training at a global batch of 4, fp32, the eval step
    through the attention op (its CPU twin); ``layers`` EVT-Former and
    decoder layers."""
    cfg = tiny_config(stochastic)
    d, p = cfg.Dataset, cfg.Predictor
    p.transformer_layers = p.evt_former_num_layers = layers
    d.batch_size, cfg.Env.compute_dtype = 4, "float32"
    p.dropout = p.drop_path = dropout
    p.rand_context, p.min_lo, p.max_lo = True, 2, 6
    p.predictor_lr, p.max_grad_norm, p.scheduler_T0 = 1e-3, 0.05, 1
    return cfg.validate()


def port_config(jax_cfg):
    """The same configuration in the port's own schema."""
    import dataclasses

    from npvp_tpu_torch.core.config import from_dict

    return from_dict(dataclasses.asdict(jax_cfg)).validate()


def _ref(a):
    """A flax leaf as a float32 torch tensor (a contiguous copy)."""
    import torch

    return torch.from_numpy(np.array(a, np.float32))


def _ref_conv(sd, key, node):
    """A conv kernel (…, I, O) → torch (O, I, …), bias if present."""
    k = np.asarray(node["kernel"])
    sd[f"{key}.weight"] = _ref(k.transpose((k.ndim - 1, k.ndim - 2)
                                           + tuple(range(k.ndim - 2))))
    if "bias" in node:
        sd[f"{key}.bias"] = _ref(node["bias"])


def _ref_linear(sd, key, node):
    sd[f"{key}.weight"] = _ref(np.asarray(node["kernel"]).T)
    sd[f"{key}.bias"] = _ref(node["bias"])


def _ref_bn(sd, key, params, stats):
    import torch

    sd[f"{key}.weight"] = _ref(params["scale"])
    sd[f"{key}.bias"] = _ref(params["bias"])
    sd[f"{key}.running_mean"] = _ref(stats["mean"])
    sd[f"{key}.running_var"] = _ref(stats["var"])
    sd[f"{key}.num_batches_tracked"] = torch.tensor(0)


def _ref_ln(sd, key, node, chw=False):
    for t, f in (("weight", "scale"), ("bias", "bias")):
        v = np.asarray(node[f])
        sd[f"{key}.{t}"] = _ref(v.transpose(2, 0, 1) if chw else v)


def _ref_mha(sd, key, node):
    """wq/wk/wv (C, H, D) and wo (H, D, C) → torch's packed
    ``nn.MultiheadAttention`` (in_proj_weight (3C, C), out_proj)."""
    C = node["wq"]["kernel"].shape[0]
    sd[f"{key}.in_proj_weight"] = _ref(np.concatenate(
        [np.asarray(node[n]["kernel"]).reshape(C, -1).T
         for n in ("wq", "wk", "wv")]))
    sd[f"{key}.in_proj_bias"] = _ref(np.concatenate(
        [np.asarray(node[n]["bias"]).reshape(-1) for n in ("wq", "wk",
                                                           "wv")]))
    wo = np.asarray(node["wo"]["kernel"])
    sd[f"{key}.out_proj.weight"] = _ref(wo.reshape(-1, wo.shape[-1]).T)
    sd[f"{key}.out_proj.bias"] = _ref(node["wo"]["bias"])


def reference_ae_state_dict(variables, n_downsampling: int,
                            num_res_blocks: int, learn_3d: bool = False):
    """Flax FrameAutoEncoder variables → a state dict in the reference's
    key names and layouts (``VPTR_Enc.*``/``VPTR_Dec.*`` of its LitAE):
    the inverse of ``torch_converter.convert_ae``. Imports no JAX."""
    P, S = variables["params"], variables["batch_stats"]
    sd = {}

    def conv_bn(tconv, tbn, p, s):
        _ref_conv(sd, tconv, p["conv"])
        _ref_bn(sd, tbn, p["bn"], s["bn"])

    def nonlocal_(tp, p, s):
        for t, f in (("Wq", "wq"), ("Wk", "wk"), ("Wv", "wv"),
                     ("out_proj", "out_proj")):
            _ref_linear(sd, f"{tp}.{t}", p[f])
        _ref_bn(sd, f"{tp}.norm_func", p["bn"], s["bn"])
        sd[f"{tp}.gamma"] = _ref(p["gamma"])

    def fact(tp, p, s):
        conv_bn(f"{tp}.spatial_conv.0", f"{tp}.spatial_conv.1",
                p["spatial_conv"], s["spatial_conv"])
        nonlocal_(f"{tp}.attn2d", p["attn2d"], s["attn2d"])
        if learn_3d:
            _ref_conv(sd, f"{tp}.temporal_conv.0", p["temporal_conv"])
            _ref_bn(sd, f"{tp}.temporal_conv.1", p["temporal_bn"],
                    s["temporal_bn"])
            nonlocal_(f"{tp}.attn1d", p["attn1d"], s["attn1d"])

    E, pe, se = "VPTR_Enc", P["encoder"], S["encoder"]
    conv_bn(f"{E}.block0.1", f"{E}.block0.2", pe["block0"], se["block0"])
    conv_bn(f"{E}.block1.0", f"{E}.block1.1", pe["block1"], se["block1"])
    for i in range(1, n_downsampling):
        a, c = f"block{i + 1}_attn", f"block{i + 1}_conv"
        fact(f"{E}.block{i + 1}_3dConvAttn", pe[a], se[a])
        conv_bn(f"{E}.{c}.0", f"{E}.{c}.1", pe[c], se[c])
    for i in range(num_res_blocks):
        a, r = f"res_attn_{i}", f"res_conv_{i}"
        fact(f"{E}.res_3dConvAttn_{i}", pe[a], se[a])
        for j, n in ((1, "conv1"), (5, "conv2")):
            conv_bn(f"{E}.{r}.conv_block.{j}", f"{E}.{r}.conv_block.{j + 1}",
                    pe[r][n], se[r][n])
    D, pd, sdec = "VPTR_Dec", P["decoder"], S["decoder"]
    for i in range(n_downsampling):
        _ref_conv(sd, f"{D}.model.{3 * i}", pd[f"up{i}_conv"])
        _ref_bn(sd, f"{D}.model.{3 * i + 1}", pd[f"up{i}_bn"],
                sdec[f"up{i}_bn"])
    _ref_conv(sd, f"{D}.model.{3 * n_downsampling + 1}", pd["head"])
    return sd


def reference_predictor_state_dict(variables, prefix: str = ""):
    """Flax NPPredictor variables → a state dict in the reference's key
    names and layouts (its ``Predictor``: packed attention projections,
    (C, H, W) LayerNorms, the final norm under both the EVT-Former's and
    the transformer's name), each key behind ``prefix``: the inverse of
    ``torch_converter.convert_predictor``. Imports no JAX."""
    P, S = variables["params"], variables.get("batch_stats", {})
    sd = {}
    pre = prefix
    sd[f"{pre}nrmlp.B"] = _ref(P["nrmlp"]["B"])
    i = 0
    while f"mlp_{i}" in P["nrmlp"]:
        _ref_linear(sd, f"{pre}nrmlp.MLP.{2 * i}", P["nrmlp"][f"mlp_{i}"])
        i += 1
    for name in ("mlp_beta", "mlp_gamma"):
        if name in P["nrmlp"]:
            _ref_linear(sd, f"{pre}nrmlp.{name}", P["nrmlp"][name])

    def mlp_dwbn(tp, p):
        for n in ("fc1", "dw3x3", "fc2"):
            _ref_conv(sd, f"{tp}.{n}", p[n])
        for n in ("norm1", "norm2", "norm3"):
            _ref_ln(sd, f"{tp}.{n}", p[n], chw=True)

    def block(tp, p, decoder):
        _ref_mha(sd, f"{tp}.SLMHSA.attn", p["slmhsa"]["attn"])
        mlp_dwbn(f"{tp}.SpatialFFN", p["spatial_ffn"])
        for n in range(1, 7 if decoder else 5):
            _ref_ln(sd, f"{tp}.norm{n}", p[f"norm{n}"])
        _ref_mha(sd, f"{tp}.temporal_MHSA", p["temporal_mhsa"]["attn"])
        _ref_linear(sd, f"{tp}.linear1", p["linear1"])
        _ref_linear(sd, f"{tp}.linear2", p["linear2"])
        if decoder:
            _ref_mha(sd, f"{tp}.EncDecAttn", p["enc_dec_attn"]["attn"])
            mlp_dwbn(f"{tp}.SpatialFFN1", p["spatial_ffn1"])

    i = 0
    while f"layer_{i}" in P.get("evt_former_stack", {}):
        block(f"{pre}EVT_Former.layers.{i}",
              P["evt_former_stack"][f"layer_{i}"], False)
        i += 1
    i = 0
    while f"layer_{i}" in P["decoder"]:
        block(f"{pre}transformer.layers.{i}", P["decoder"][f"layer_{i}"],
              True)
        i += 1
    for n in ("EVT_Former.norm", "transformer.norm"):
        _ref_ln(sd, f"{pre}{n}", P["final_norm"])

    for enc in ("evt_posterior", "evt_prior"):
        if enc not in P:
            continue
        p, s, tp = P[enc], S[enc], f"{pre}{enc}"
        for n in ("conv1", "conv2") + tuple(
                k for k in sorted(p) if k.startswith("mlp_")):
            tn = n.upper() if n.startswith("mlp_") else n
            _ref_conv(sd, f"{tp}.{tn}.0", p[n]["conv"])
            _ref_bn(sd, f"{tp}.{tn}.1", p[n]["bn"], s[n]["bn"])
        for n in ("mu_net", "logvar_net"):
            if n in p:
                _ref_conv(sd, f"{tp}.{n}", p[n])
    return sd


def reference_i3d_state_dict(variables):
    """Flax InceptionI3d variables → pytorch-i3d's key names and layouts
    (``<unit>.conv3d.weight`` OIDHW, ``<unit>.bn.*``): the inverse of
    ``torch_converter.convert_i3d``. Imports no JAX."""
    P, S = variables["params"], variables["batch_stats"]
    sd = {}

    def walk(p, s, key):
        if "conv3d" in p:
            _ref_conv(sd, f"{key}.conv3d", p["conv3d"])
            if "bn" in p:
                _ref_bn(sd, f"{key}.bn", p["bn"], s["bn"])
            return
        for name in p:
            walk(p[name], s.get(name, {}), f"{key}.{name}" if key else name)

    walk(P, S, "")
    return sd


class RaisingDataset:
    """16 clips (4, 2, 2, 1) filled with their index; item 5 fails, as a
    corrupt frame would."""

    def __len__(self):
        return 16

    def __getitem__(self, i, rng=None):
        if i == 5:
            raise ValueError(f"frame {i}: bad CRC")
        return np.full((4, 2, 2, 1), i, np.float32)


class SleepyDataset:
    """16 clips (4, 2, 2, 1) filled with their index, each fetch taking
    ``delay`` seconds."""

    def __init__(self, delay: float):
        self.delay = delay

    def __len__(self):
        return 16

    def __getitem__(self, i, rng=None):
        import time

        time.sleep(self.delay)
        return np.full((4, 2, 2, 1), i, np.float32)
