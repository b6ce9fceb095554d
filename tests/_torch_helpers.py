"""Shared helpers of the PyTorch-port parity tests: random flax variables as
numpy trees, the tiny configuration the slice tests run, and two datasets
for the loader's worker processes (light to import): one whose item 5
fails, one that sleeps in every fetch."""

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


def port_config(jax_cfg):
    """The same configuration in the port's own schema."""
    import dataclasses

    from npvp_tpu_torch.core.config import from_dict

    return from_dict(dataclasses.asdict(jax_cfg)).validate()


def to_flax(module, template: dict) -> dict:
    """The inverse of ``npvp_tpu_torch.tools.weights.load_flax``: the
    module's parameters and running statistics as a flax variable tree of
    numpy arrays, shaped as ``template`` (a tree of the same module)."""
    import copy

    from torch import nn

    from npvp_tpu_torch.nn.layers import (BatchNorm, LayerNormHWC,
                                          TokenLayerNorm)

    out = copy.deepcopy(template)
    np_ = lambda t: t.detach().cpu().numpy().astype(np.float32)  # noqa: E731
    for name, mod in module.named_modules():
        if not list(mod.parameters(recurse=False)):
            continue
        params, stats = out["params"], out.get("batch_stats", {})
        for part in (name.split(".") if name else []):
            params, stats = params[part], stats.get(part, {})
        if isinstance(mod, (nn.Conv2d, nn.ConvTranspose2d)):
            params["kernel"] = np_(mod.weight).transpose(2, 3, 1, 0)
            if mod.bias is not None:
                params["bias"] = np_(mod.bias)
        elif isinstance(mod, nn.Linear):
            params["kernel"] = np_(mod.weight).T.reshape(
                params["kernel"].shape)
            params["bias"] = np_(mod.bias).reshape(params["bias"].shape)
        elif isinstance(mod, (BatchNorm, TokenLayerNorm, LayerNormHWC)):
            params["scale"], params["bias"] = np_(mod.weight), np_(mod.bias)
            if isinstance(mod, BatchNorm):
                stats["mean"] = np_(mod.running_mean)
                stats["var"] = np_(mod.running_var)
        else:
            for leaf, value in mod.named_parameters(recurse=False):
                params[leaf] = np_(value).reshape(np.shape(params[leaf]))
    return out


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
