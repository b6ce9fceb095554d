"""The experiment config matrix (port of ``npvp_tpu/configs/generate.py``).

The same 23 experiment YAMLs as the JAX package ships in
``npvp_tpu/configs/``, built from one table of per-dataset settings and
per-variant overlays. The port keeps its own copy of them beside this
module (``npvp_tpu_torch/configs/config_*.yaml``, byte-equal to the
JAX package's); this module writes the matrix for a changed table or a
new dataset:

    python -m npvp_tpu_torch.configs.generate --out_dir <dir>
"""

from __future__ import annotations

import argparse
from pathlib import Path

import yaml

# per-dataset table (reference configs; differences verified against
# config_{KTH,SMMNIST,BAIR,Cityscapes,KITTI}_*.yaml)
DATASETS = {
    "KTH": dict(img_channels=1, img_size=64, num_past=10, num_future=10,
                test_past=10, test_future=20, batch_size=8, ngf=64,
                n_down=3, res_blocks=2, out_layer="Tanh", kl_beta=1e-8,
                min_lo=4, max_lo=16, vfi=(5, 5, 10), pred_epochs=600),
    "SMMNIST": dict(img_channels=1, img_size=64, num_past=5, num_future=10,
                    test_past=5, test_future=10, batch_size=8, ngf=64,
                    n_down=3, res_blocks=2, out_layer="Sigmoid",
                    kl_beta=1e-6, min_lo=5, max_lo=10, vfi=(5, 5, 5),
                    pred_epochs=600),
    "BAIR": dict(img_channels=3, img_size=64, num_past=2, num_future=10,
                 test_past=2, test_future=28, batch_size=8, ngf=64,
                 n_down=3, res_blocks=2, out_layer="Tanh", kl_beta=1e-6,
                 min_lo=2, max_lo=10, vfi=(2, 2, 8), pred_epochs=500),
    "Cityscapes": dict(img_channels=3, img_size=128, num_past=2,
                       num_future=10, test_past=2, test_future=28,
                       batch_size=8, ngf=32, n_down=4, res_blocks=3,
                       out_layer="Tanh", kl_beta=1e-8, min_lo=2, max_lo=10,
                       vfi=(2, 2, 8), pred_epochs=500),
    "KITTI": dict(img_channels=3, img_size=128, num_past=4, num_future=5,
                  test_past=4, test_future=5, batch_size=16, ngf=32,
                  n_down=4, res_blocks=3, out_layer="Tanh", kl_beta=1e-8,
                  min_lo=3, max_lo=6, vfi=(2, 2, 5), pred_epochs=500),
}

# variants: (suffix, stochastic, rand_context, vfi_mode)
VARIANTS = [
    ("Autoencoder", None, None, None),
    ("VFP_NPVP-D", False, False, False),
    ("VFP_NPVP-S", True, False, False),
    ("VFI_NPVP-D", False, False, True),
    ("VFI_NPVP-S", True, False, True),
    ("Unified_NPVP-D", False, True, False),
    ("Unified_NPVP-S", True, True, False),
]

# which variants each dataset ships (the reference matrix — VFI only for
# KTH + SMMNIST, Unified only for KTH — plus SMMNIST Unified beyond the
# reference: SM-MNIST is procedurally generated, so it is the one dataset on
# which the five-task unified protocol can train/evaluate hermetically)
SHIPPED = {
    "KTH": ["Autoencoder", "VFP_NPVP-D", "VFP_NPVP-S", "VFI_NPVP-D",
            "VFI_NPVP-S", "Unified_NPVP-D", "Unified_NPVP-S"],
    "SMMNIST": ["Autoencoder", "VFP_NPVP-D", "VFP_NPVP-S", "VFI_NPVP-D",
                "VFI_NPVP-S", "Unified_NPVP-D", "Unified_NPVP-S"],
    "BAIR": ["Autoencoder", "VFP_NPVP-D", "VFP_NPVP-S"],
    "Cityscapes": ["Autoencoder", "VFP_NPVP-D", "VFP_NPVP-S"],
    "KITTI": ["Autoencoder", "VFP_NPVP-D", "VFP_NPVP-S"],
}


def build_config(ds_name: str, variant: str) -> dict:
    d = DATASETS[ds_name]
    suffix, stochastic, rand_context, vfi = next(
        (v for v in VARIANTS if v[0] == variant))
    max_T = d["num_past"] + d["num_future"]
    ckpt_root = f"./NPVP_ckpts/{ds_name}"
    cfg = {
        "Env": {"rand_seed": 3047, "visual_callback": True,
                "compute_dtype": "bfloat16"},
        "Dataset": {
            "name": ds_name, "dir": f"./data/{ds_name}",
            "num_workers": 16, "img_channels": d["img_channels"],
            "img_size": d["img_size"],
            "num_past_frames": d["num_past"],
            "num_future_frames": d["num_future"],
            "test_num_past_frames": d["test_past"],
            "test_num_future_frames": d["test_future"],
            "batch_size": d["batch_size"], "phase": "deploy",
        },
        "AE": {
            "ckpt_save_dir": f"{ckpt_root}_ResnetAE",
            "tensorboard_save_dir": f"{ckpt_root}_ResnetAE_tb",
            "epochs": 500, "AE_lr": 1e-4, "ngf": d["ngf"],
            "n_downsampling": d["n_down"],
            "num_res_blocks": d["res_blocks"],
            "out_layer": d["out_layer"], "learn_3d": False,
            "log_per_epochs": 2,
        },
        "Predictor": {
            "ckpt_save_dir": f"{ckpt_root}_Predictor_{suffix}",
            "tensorboard_save_dir": f"{ckpt_root}_Predictor_{suffix}_tb",
            "resume_AE_ckpt": f"{ckpt_root}_ResnetAE",
            "epochs": d["pred_epochs"], "log_per_epochs": 5,
            "rand_context": bool(rand_context),
            "min_lo": d["min_lo"], "max_lo": d["max_lo"],
            "VFI": bool(vfi),
            "context_num_p": d["vfi"][0], "context_num_f": d["vfi"][1],
            "num_interpolate": d["vfi"][2],
            "max_H": 8, "max_W": 8, "max_T": max_T,
            "embed_dim": d["ngf"] * 2 ** d["n_down"],
            "fuse_method": "Add", "param_free_norm_type": "layer",
            "evt_former": True, "evt_former_num_layers": 4,
            "evt_hidden_channels": 256,
            "stochastic": bool(stochastic),
            "transformer_layers": 8,
            "predictor_lr": 1e-4, "max_grad_norm": 1.0,
            "use_cosine_scheduler": True, "scheduler_eta_min": 1e-7,
            "scheduler_T0": 150,
            "lam_PF_L1": 0.01, "KL_beta": d["kl_beta"],
        },
    }
    return cfg


def write_configs(out_dir) -> list:
    """Write every shipped config to ``out_dir/config_<dataset>_<variant>
    .yaml`` and return the paths."""
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    paths = []
    for ds_name, variants in SHIPPED.items():
        for variant in variants:
            path = out_dir / f"config_{ds_name}_{variant}.yaml"
            path.write_text(yaml.safe_dump(build_config(ds_name, variant),
                                           sort_keys=False))
            paths.append(path)
    return paths


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out_dir", required=True,
                        help="directory to write the YAMLs into")
    args = parser.parse_args(argv)
    paths = write_configs(args.out_dir)
    print(f"wrote {len(paths)} configs to {args.out_dir}")


if __name__ == "__main__":
    main()
