"""The plain reference against the port's plain path, on the CPU at a tiny
size, in float32: the same state-dict names and shapes, the same served
frames, the same three train steps (losses, gradients as AdamW took them,
parameters). The reference itself imports nothing of the port, of the JAX
package or of JAX."""

import ast
from pathlib import Path

import numpy as np
import pytest
import torch

from npvp_bench import weights as W
from npvp_bench.reference import model as R
from npvp_bench.reference.train import Trainer
from npvp_bench.tests._tiny import ROOT, tiny_context

REFERENCE = ROOT / "npvp_bench" / "reference"


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


@pytest.mark.parametrize("path", sorted(REFERENCE.glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    tops = {m.split(".")[0] for m in _imports(path)}
    assert not tops & {"npvp_tpu_torch", "npvp_tpu", "jax", "jaxlib",
                       "flax"}, tops
    assert tops <= {"npvp_bench", "torch", "hashlib", "math", "typing",
                    "__future__"}, tops


def _port_modules(cfg_dict, exec_mode="xla"):
    from npvp_tpu_torch.core.config import from_dict
    from npvp_tpu_torch.models.predictor import build_predictor
    from npvp_tpu_torch.nn.resnet_ae import build_ae

    cfg = from_dict(cfg_dict).validate()
    return cfg, build_ae(cfg, torch.float32), build_predictor(
        cfg, torch.float32, exec_mode)


def _loaded(cfg_dict, seed=5, exec_mode="xla"):
    cfg, ae_p, pr_p = _port_modules(cfg_dict, exec_mode)
    ae_r, pr_r = R.build(cfg_dict)
    for port, ref, tag in ((ae_p, ae_r, "ae"), (pr_p, pr_r, "predictor")):
        w = W.draw(W.state_specs(ref), seed, "cpu", tag)
        port.load_state_dict(w)
        ref.load_state_dict(w)
    return cfg, ae_p, pr_p, ae_r, pr_r


@pytest.mark.parametrize("workload", ["kth_serve_vfp_b64",
                                      "smmnist_train_b8"])
def test_same_state_dict_names_and_shapes(workload):
    cfg_dict = tiny_context(workload).model_config
    _, ae_p, pr_p = _port_modules(cfg_dict)
    ae_r, pr_r = R.build(cfg_dict)
    for port, ref in ((ae_p, ae_r), (pr_p, pr_r)):
        a, b = port.state_dict(), ref.state_dict()
        assert sorted(a) == sorted(b)
        assert all(a[k].shape == b[k].shape for k in a)


@pytest.mark.parametrize("exec_mode", ["xla", "pallas"])
@pytest.mark.parametrize("to,tp", [
    (list(range(10)), list(range(10, 20))),
    (list(range(10, 20)), list(range(10))),
    ([0, 1, 2, 3, 4, 15, 16, 17, 18, 19], list(range(5, 15))),
    (list(range(10)), [10.25, 11.5, 12.0, 13.75, 15.0, 15.25, 16.5, 17.0,
                       18.75, 19.0])], ids=["VFP", "VPE", "VFI", "HVRC"])
def test_served_frames_match_the_port(exec_mode, to, tp):
    from npvp_tpu_torch.models.inference import VideoPredictor

    cfg_dict = tiny_context("kth_serve_vfp_b64").model_config
    cfg, ae_p, pr_p, ae_r, pr_r = _loaded(cfg_dict, exec_mode=exec_mode)
    vp = VideoPredictor(cfg, ae_p, pr_p, device="cpu")
    g = torch.Generator().manual_seed(0)
    frames = torch.rand((3, len(to), 32, 32, 1), generator=g) * 2 - 1
    eps = torch.randn((3, 8, 8, 32), generator=g)
    got = vp.predict(frames, np.asarray(to, np.float32),
                     np.asarray(tp, np.float32), eps=eps)
    ae_r.eval(), pr_r.eval()
    with torch.no_grad():
        grid = lambda t: R.coordinate_grid(t, 20, 8, 8)  # noqa: E731
        want = ae_r.decode(pr_r(ae_r.encode(frames), grid(to), grid(tp),
                                eps).pred_features)
    assert want.std() > 0.05
    torch.testing.assert_close(got, want, atol=2e-5, rtol=0)


def test_train_steps_match_the_port():
    from npvp_tpu_torch.core.optim import (is_decoder_param,
                                           make_predictor_optimizer,
                                           predictor_schedule)
    from npvp_tpu_torch.core.train_state import TrainState
    from npvp_tpu_torch.nn.layers import Rng
    from npvp_tpu_torch.train.stage2_predictor import make_steps

    ctx = tiny_context("smmnist_train_b8")
    cfg_dict = ctx.model_config
    cfg, ae_p, pr_p, ae_r, pr_r = _loaded(cfg_dict)
    ae_p.eval().requires_grad_(False)
    p = cfg.Predictor
    state = TrainState(pr_p, make_predictor_optimizer(pr_p.parameters(),
                                                      p.predictor_lr),
                       predictor_schedule(p.predictor_lr, True,
                                          p.scheduler_eta_min,
                                          p.scheduler_T0 * 7),
                       p.max_grad_norm, is_decoder_param)
    steps = make_steps(cfg, ae_p, "rand_context", torch.device("cpu"))
    ref = Trainer(cfg_dict, ae_r, pr_r, 7)
    rs = np.random.default_rng(0)
    base = Rng(1234)
    for s in range(3):
        obs = np.zeros(15, bool)
        obs[rs.permutation(15)[:6]] = True
        batch = {"clip": rs.random((2, 15, 32, 32, 1)).astype(np.float32),
                 "obs_mask": obs, "tgt_mask": ~obs}
        got = steps.train(state, steps.place(batch), base.fold(s))
        want = ref.step({k: torch.from_numpy(v) for k, v in batch.items()},
                        base.fold(s).seed)
        for k in want:
            assert float(got[k]) == pytest.approx(want[k], rel=1e-5,
                                                  abs=1e-7), k
        if s == 0:
            for name, param in pr_p.named_parameters():
                g = state.optimizer.state[param]["exp_avg"] / 0.1
                torch.testing.assert_close(g, ref.grads[name], atol=1e-6,
                                           rtol=1e-4)
    for name, param in pr_p.named_parameters():
        torch.testing.assert_close(param.detach(), ref.params[name],
                                   atol=1e-5, rtol=0)


def test_rng_streams_match_the_port():
    from npvp_tpu_torch.nn.layers import Rng

    port, ref = Rng(2 ** 40 + 17).fold("decoder"), R.Rng(
        2 ** 40 + 17).fold("decoder")
    assert port.seed == ref.seed
    torch.testing.assert_close(port.fold("x").normal((4, 5), "cpu"),
                               ref.fold("x").normal((4, 5), "cpu"))
    torch.testing.assert_close(port.fold("y").bernoulli((64,), 0.9, "cpu"),
                               ref.fold("y").bernoulli((64,), 0.9, "cpu"))


def test_fp8_precision_is_coarser():
    x = torch.randn(1000, generator=torch.Generator().manual_seed(0))
    y = R._fp8_round(x)
    rel = float((y - x).norm() / x.norm())
    assert 1e-3 < rel < 0.1
    assert torch.equal(R._fp8_round(y), y)
