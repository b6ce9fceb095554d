"""Reader of the golden fixture ``npvp_tpu_torch/testdata/golden_tiny.npz``:
a tiny NPVP model's flax variables, its inputs, and the JAX package's fp32
outputs on them (written by ``tests/make_torch_golden.py``)."""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np

from npvp_tpu_torch.core.config import from_dict
from npvp_tpu_torch.tools.weights import unflatten

GOLDEN = Path(__file__).resolve().parents[1] / "testdata" / "golden_tiny.npz"


def load_golden(path=GOLDEN) -> dict:
    """→ {"cfg": {"d": Config, "s": Config}, "ae_vars", "pred_vars": {"d",
    "s"}, plus the arrays frames, eps, hvrc_to, hvrc_tp and the JAX outputs
    {vfp,hvrc}_{d,s}}; every float comes back float32."""
    with np.load(path) as data:
        flat = {k: data[k].astype(np.float32) for k in data.files
                if k.startswith("vars/")}
        out = {k: data[k].astype(np.float32) for k in data.files
               if not k.startswith(("vars/", "__meta__"))}
        meta = json.loads(bytes(data["__meta__"]))
    tree = unflatten(flat)["vars"]
    pred_s = {k: {**tree["pred"][k], **tree["pred_s"][k]}
              for k in ("params", "batch_stats")}
    cfg_d, cfg_s = from_dict(meta).validate(), from_dict(meta)
    cfg_s.Predictor.stochastic = True
    out.update(cfg={"d": cfg_d, "s": cfg_s.validate()}, ae_vars=tree["ae"],
               pred_vars={"d": tree["pred"], "s": pred_s})
    return out
