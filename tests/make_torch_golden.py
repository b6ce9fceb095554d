"""Writes ``npvp_tpu_torch/testdata/golden_tiny.npz``: a tiny NPVP model's
flax variables and the JAX package's fp32 outputs on them, which the port
is held against where JAX is absent (``chip_smoke.py`` on the card).

Run from the repo root: ``JAX_PLATFORMS=cpu python tests/make_torch_golden.py``.
``tests/test_torch_golden.py`` regenerates the arrays and checks that the
committed file is not stale.

Contents (weights in the layout of ``npvp_tpu/tools/export_weights.py``,
stored as float16 and used as the float32 values of those float16 numbers,
so the file stays under 1 MiB):

- ``vars/ae/...`` and ``vars/pred/...``: the AE and the NPVP-D predictor,
  random flax variables from a seed (``_torch_helpers.random_variables``);
- ``vars/pred_s/...``: NPVP-S's ``evt_prior`` and (stochastic)
  ``evt_posterior``; NPVP-S is NPVP-D's variables with these two in place of
  NPVP-D's ``evt_posterior`` (one transformer stored for both);
- ``frames`` (2, 4, 32, 32, 1) of 8-bit levels k/128 (stored float16,
  exactly), ``eps`` (2, 4, 4, 32): the inputs;
- ``{vfp,hvrc}_{d,s}``: JAX outputs of VFP 4→2 and of an HVRC task with
  fractional target times (``hvrc_to``, ``hvrc_tp``), run with
  ``exec_mode="pallas"`` (the Pallas kernel in interpret mode) and, for
  NPVP-S, the latent noise ``eps``;
- ``__meta__``: the configuration as JSON.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import json
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
GOLDEN = ROOT / "npvp_tpu_torch" / "testdata" / "golden_tiny.npz"
HVRC_TO = np.array([0.0, 2.0, 4.0, 6.0], np.float32)
HVRC_TP = np.array([2.5, 7.75], np.float32)


@contextlib.contextmanager
def _injected_latent_noise(eps):
    """The flax EventEncoder draws its noise with ``jax.random.normal``;
    hand it ``eps`` instead, for the length of the block (flax also calls
    initialisers abstractly to check parameter shapes: those go through)."""
    import jax
    import jax.numpy as jnp

    real = jax.random.normal
    jax.random.normal = lambda key, shape, dtype=jnp.float32: (
        jnp.asarray(eps, dtype) if tuple(shape) == eps.shape
        else real(key, shape, dtype))
    try:
        yield
    finally:
        jax.random.normal = real


def _flatten(tree, prefix, out):
    for k, v in tree.items():
        if isinstance(v, dict):
            _flatten(v, f"{prefix}/{k}", out)
        else:
            out[f"{prefix}/{k}"] = v


def _f16(tree):
    if isinstance(tree, dict):
        return {k: _f16(v) for k, v in tree.items()}
    return np.asarray(tree, np.float32).astype(np.float16).astype(np.float32)


def golden_arrays() -> dict:
    """Every array of the golden file, computed afresh (weights as the
    float32 values of float16 numbers)."""
    for path in (ROOT, ROOT / "tests"):
        if str(path) not in sys.path:
            sys.path.insert(0, str(path))
    import jax
    import jax.numpy as jnp

    from _torch_helpers import random_variables, tiny_config
    from npvp_tpu.kernels import temporal_attention as ta_kernel
    from npvp_tpu.models.coords import coordinate_grid, spatial_index_lists
    from npvp_tpu.models.predictor import build_predictor
    from npvp_tpu.nn.resnet_ae import FrameAutoEncoder
    from npvp_tpu.train.stage1_ae import build_ae

    cfg_d, cfg_s = tiny_config(False), tiny_config(True)
    d, p = cfg_d.Dataset, cfg_d.Predictor
    ae = build_ae(cfg_d, jnp.float32)
    ae_vars = _f16(random_variables(
        ae.init, jax.random.key(0),
        np.zeros((1, 2, d.img_size, d.img_size, d.img_channels)), seed=1))
    feats0 = np.zeros((1, 2, p.max_H, p.max_W, p.embed_dim))
    oc0 = np.zeros((2 * p.max_H * p.max_W, 3))
    rngs = {"params": jax.random.key(1), "latent": jax.random.key(2)}
    init = lambda cfg, seed, **kw: random_variables(  # noqa: E731
        functools.partial(build_predictor(cfg, jnp.float32).init,
                          num_target=2, **kw), rngs, feats0, oc0, oc0,
        seed=seed)
    pred_d = _f16(init(cfg_d, 2))
    # the target features make flax create NPVP-S's posterior
    vars_s = init(cfg_s, 3, target_feats_gt=feats0)
    latent_s = _f16({k: {m: vars_s[k][m]
                         for m in ("evt_prior", "evt_posterior")}
                     for k in ("params", "batch_stats")})
    pred_s = {k: {**pred_d[k], **latent_s[k]}
              for k in ("params", "batch_stats")}

    rng = np.random.default_rng(4)
    frames = (rng.integers(-128, 128, (2, 4, d.img_size, d.img_size,
                                       d.img_channels)) / 128
              ).astype(np.float32)
    eps = rng.standard_normal((2, p.max_H, p.max_W, p.embed_dim)
                              ).astype(np.float32)
    h, w = spatial_index_lists(p.max_H, p.max_W)
    grid = lambda t: coordinate_grid(jnp.asarray(t), h, w, p.max_T,  # noqa
                                     p.max_H, p.max_W)
    out = {}
    real_block = ta_kernel.BLOCK_SITES
    ta_kernel.BLOCK_SITES = 8  # so the kernel serves every call site here
    try:
        for tag, cfg, pv in (("d", cfg_d, pred_d), ("s", cfg_s, pred_s)):
            model = build_predictor(cfg, jnp.float32, exec_mode="pallas")

            @jax.jit
            def pipeline(pv, frames, oc, tc):
                feats = ae.apply(ae_vars, frames,
                                 method=FrameAutoEncoder.encode)
                pred = model.apply(pv, feats, oc, tc, tc.shape[0] // (
                    p.max_H * p.max_W), rngs={"latent": jax.random.key(5)})
                return ae.apply(ae_vars, pred.pred_features,
                                method=FrameAutoEncoder.decode)

            for task, to, tp in (("vfp", np.arange(4), np.arange(4, 6)),
                                 ("hvrc", HVRC_TO, HVRC_TP)):
                with _injected_latent_noise(eps):
                    out[f"{task}_{tag}"] = np.asarray(pipeline(
                        pv, frames, grid(to), grid(tp)), np.float32)
    finally:
        ta_kernel.BLOCK_SITES = real_block

    arrays = {"frames": frames, "eps": eps, "hvrc_to": HVRC_TO,
              "hvrc_tp": HVRC_TP, **out}
    _flatten(ae_vars, "vars/ae", arrays)
    _flatten(pred_d, "vars/pred", arrays)
    _flatten(latent_s, "vars/pred_s", arrays)
    meta = json.dumps(dataclasses.asdict(cfg_d))
    arrays["__meta__"] = np.frombuffer(meta.encode(), np.uint8)
    return arrays


def main():
    arrays = golden_arrays()
    stored = {k: (v.astype(np.float16) if k.startswith("vars/")
                  or k == "frames" else v) for k, v in arrays.items()}
    GOLDEN.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(GOLDEN, **stored)
    print(f"wrote {GOLDEN}: {GOLDEN.stat().st_size} bytes")


if __name__ == "__main__":
    main()
