"""Helpers of the report tools' parity tests (``test_torch_reports.py``,
``test_torch_frontier.py``): the JAX package's root tools as modules, a
JAX-written weights archive and the YAML that names it, both packages'
SMMNIST test clips from one sprite bank, and the tolerances."""

import dataclasses
import importlib.util
import math
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import yaml
from _torch_helpers import random_variables, tiny_config

from npvp_tpu_torch.data import loader as tload
from npvp_tpu_torch.data import native_bindings as tnb
from npvp_tpu_torch.data import smmnist as tsm

ROOT = Path(__file__).resolve().parents[1]
SPRITES = tsm.default_sprite_bank(16, per_digit=3, seed=11)


def jax_tool(name):
    """The JAX package's root ``tools/<name>.py`` as a module."""
    spec = importlib.util.spec_from_file_location(
        f"jax_tools_{name}", ROOT / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def write_archive(tmp, cfg, seed=60):
    """An NPVP-D weights archive of random flax variables for ``cfg`` (a
    JAX Config), written by the JAX package; → (path, ae_vars,
    pred_vars)."""
    from npvp_tpu.models.predictor import build_predictor
    from npvp_tpu.tools.export_weights import save_weights
    from npvp_tpu.train.stage1_ae import build_ae

    p = cfg.Predictor
    ae_vars = random_variables(build_ae(cfg, jnp.float32).init,
                               jax.random.key(0),
                               np.zeros((1, 2, 32, 32, 1)), seed=seed)
    pred = build_predictor(cfg, jnp.float32)
    feats0 = np.zeros((1, 2, p.max_H, p.max_W, p.embed_dim))
    oc = np.zeros((2 * p.max_H * p.max_W, 3))
    pred_vars = random_variables(
        lambda *a: pred.init(*a, num_target=2), {"params": jax.random.key(1)},
        feats0, oc, oc, seed=seed + 1)
    path = Path(tmp) / "weights.npz"
    save_weights(path, ae_vars, pred_vars)
    return path, ae_vars, pred_vars


def report_config(tmp, transformer_layers=2):
    """The tiny NPVP-D config as a YAML both packages read, naming a
    JAX-written archive: test clips of 4 → 4 (max_T 8, so VFP is one
    window), batch 2, the plain attention path."""
    cfg = tiny_config()
    d, p = cfg.Dataset, cfg.Predictor
    d.batch_size, d.num_workers = 2, 1
    d.test_num_past_frames = d.test_num_future_frames = 4
    p.transformer_layers = transformer_layers
    p.exec_mode = "xla"
    cfg.validate()
    path, _, _ = write_archive(tmp, cfg)
    p.ckpt_save_dir = p.resume_AE_ckpt = str(path)
    yml = Path(tmp) / "config.yaml"
    yml.write_text(yaml.safe_dump(dataclasses.asdict(cfg)))
    return yml


def share_clips(monkeypatch):
    """Both packages render the test clips from one sprite bank, clip by
    clip (the batch streams of their C++ libraries are off)."""
    from npvp_tpu.data import loader as jload
    from npvp_tpu.data import native_bindings

    jreal, treal = jload.StochasticMovingMNIST, tload.StochasticMovingMNIST

    def jax_sprites(*a, **kw):
        ds = jreal(*a, **kw)
        ds.sprites, ds._length = SPRITES, len(SPRITES)
        return ds

    monkeypatch.setattr(jload, "StochasticMovingMNIST", jax_sprites)
    monkeypatch.setattr(native_bindings, "synth_moving_sprites_batch",
                        lambda *a, **k: None)
    monkeypatch.setattr(tload, "StochasticMovingMNIST",
                        lambda *a, **kw: treal(*a, **{**kw,
                                                      "sprites": SPRITES}))
    monkeypatch.setattr(tnb, "native_available", lambda: False)


def close_rows(got, want, tags, ssim=dict(atol=0, rtol=1e-4)):
    """Per-timestep rows and their means: PSNR atol 1e-3 dB, SSIM and MSE
    rtol 1e-4 (``ssim`` replaces the SSIM bound)."""
    for tag in tags:
        for metric, kw in (("PSNR", dict(atol=1e-3, rtol=0)),
                           ("SSIM", ssim),
                           ("MSE", dict(atol=0, rtol=1e-4))):
            for name in (f"{metric}{tag}_per_t", f"{metric}{tag}"):
                if name in want:
                    np.testing.assert_allclose(got[name], want[name],
                                               err_msg=name, **kw)


def finite(tree):
    if isinstance(tree, dict):
        return all(finite(v) for v in tree.values())
    if isinstance(tree, list):
        return all(finite(v) for v in tree)
    return not isinstance(tree, float) or math.isfinite(tree)
