"""The port's config generator (``npvp_tpu_torch/configs/generate.py``)
against the JAX package's: each shipped experiment's dict equals JAX's
``build_config`` and the committed YAML and validates through the port's
``Config``; ``main`` writes the committed YAMLs, byte for byte, into the
directory it is given and nowhere else; the port's own copies of the
YAMLs (``npvp_tpu_torch/configs/config_*.yaml``) are exactly the
generator's output and JAX's committed files."""

from pathlib import Path

import pytest
import yaml

from npvp_tpu_torch.configs import generate as tgen
from npvp_tpu_torch.core.config import from_dict

ROOT = Path(__file__).resolve().parents[1]
CONFIGS = ROOT / "npvp_tpu" / "configs"
PORT_CONFIGS = ROOT / "npvp_tpu_torch" / "configs"
SHIPPED = [(ds, v) for ds, variants in tgen.SHIPPED.items() for v in variants]


def test_tables_equal_jax():
    from npvp_tpu.configs import generate as jgen

    assert tgen.DATASETS == jgen.DATASETS
    assert tgen.VARIANTS == jgen.VARIANTS
    assert tgen.SHIPPED == jgen.SHIPPED
    assert len(SHIPPED) == 23


@pytest.mark.parametrize("ds_name,variant", SHIPPED,
                         ids=[f"{d}_{v}" for d, v in SHIPPED])
def test_config_equals_jax_and_committed_yaml(ds_name, variant):
    from npvp_tpu.configs import generate as jgen

    built = tgen.build_config(ds_name, variant)
    assert built == jgen.build_config(ds_name, variant)
    path = CONFIGS / f"config_{ds_name}_{variant}.yaml"
    assert yaml.safe_load(path.read_text()) == built
    cfg = from_dict(built).validate()
    assert cfg.Dataset.name == ds_name
    assert cfg.Predictor.stochastic == variant.endswith("-S")


def test_main_writes_into_out_dir(tmp_path, capsys):
    before = {p: p.stat().st_mtime_ns for p in CONFIGS.glob("*.yaml")}
    tgen.main(["--out_dir", str(tmp_path / "cfgs")])
    assert "wrote 23 configs" in capsys.readouterr().out
    written = sorted((tmp_path / "cfgs").iterdir())
    assert [p.name for p in written] == sorted(
        f"config_{d}_{v}.yaml" for d, v in SHIPPED)
    for p in written:
        assert p.read_bytes() == (CONFIGS / p.name).read_bytes()
    assert {p: p.stat().st_mtime_ns for p in CONFIGS.glob("*.yaml")} == before
    with pytest.raises(SystemExit):
        tgen.main([])  # --out_dir is required


@pytest.mark.parametrize("ds_name,variant", SHIPPED,
                         ids=[f"{d}_{v}" for d, v in SHIPPED])
def test_port_keeps_its_own_yaml(ds_name, variant):
    name = f"config_{ds_name}_{variant}.yaml"
    own = PORT_CONFIGS / name
    assert yaml.safe_load(own.read_text()) == tgen.build_config(ds_name,
                                                                 variant)
    assert own.read_bytes() == (CONFIGS / name).read_bytes()


def test_port_holds_exactly_the_shipped_yamls():
    assert sorted(p.name for p in PORT_CONFIGS.glob("*.yaml")) == sorted(
        f"config_{d}_{v}.yaml" for d, v in SHIPPED)
