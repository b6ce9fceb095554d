"""Tensor parallelism, four ranks and the trainers' plumbing on the CPU
(gloo ranks spawned at the tiny test width, fp32; the companion of
``test_torch_parallel.py``, whose helpers they share):

- model 2 (training with its collectives in the backward pass, the eval
  step through the attention op) and ``VideoPredictor.shard`` at model 2
  against the one-process runs;
- data 2 × model 2 with FSDP on 4 ranks against the one-process run;
- the tensor-parallel guards, ``Env.steps_per_dispatch``, the ``wo`` cast
  cache under a rewrite that keeps the version counter, ``Rng``'s row and
  split draws, and a ``torchrun`` drive of the trainer CLI.

Tolerances as in ``test_torch_parallel.py`` (``_torch_parallel``).
"""

import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import numpy as np  # noqa: E402
import _torch_parallel as P  # noqa: E402
from _torch_helpers import parallel_config, port_config, tiny_config  # noqa: E402

from npvp_tpu_torch.core.checkpoint import CheckpointManager  # noqa: E402
from npvp_tpu_torch.kernels import temporal_attention as ta  # noqa: E402
from npvp_tpu_torch.models.predictor import build_predictor  # noqa: E402
from npvp_tpu_torch.nn import layers as tl  # noqa: E402
from npvp_tpu_torch.train import stage2_predictor as s2  # noqa: E402

REPO = Path(__file__).resolve().parents[1]


# -- tensor parallelism ------------------------------------------------------

@pytest.fixture(scope="module")
def model2(tmp_path_factory):
    """2 ranks at model 2: training (the generic path, its collectives in
    the backward pass) with the eval step through the attention op, and
    serving; against the one-process runs."""
    tmp = tmp_path_factory.mktemp("model2")
    cfg = port_config(parallel_config(dropout=0.1))
    ae_sd, pred_sd = P.port_weights(cfg, 60)
    rng = np.random.default_rng(4)
    runs = dict(
        train=(P.train_scenario, dict(cfg=cfg, ae_sd=ae_sd, pred_sd=pred_sd,
                                      batches=P.batches(8))),
        serve=(P.serve_scenario, dict(
            cfg=cfg, ae_sd=ae_sd, pred_sd=pred_sd,
            frames=rng.uniform(0, 1, (2, 4, 32, 32, 1)).astype(np.float32),
            stream=rng.uniform(0, 1, (2, 2, 4, 32, 32, 1)).astype(
                np.float32),
            odd=rng.uniform(0, 1, (1, 4, 32, 32, 1)).astype(np.float32))))
    got = P.spawn(tmp, 2, [(fn, dict(kw, mesh_shape=(1, 2)))
                           for fn, kw in runs.values()])
    want = [fn(**kw) for fn, kw in runs.values()]
    return dict(zip(runs, zip(got, want)))


def test_tensor_parallel_training_equals_one_process(model2):
    P.assert_runs_equal(*model2["train"])


def test_video_predictor_shard_model2_equals_predict(model2):
    got, want = model2["serve"]
    P.assert_serving(got, want)
    assert not any("does not divide" in w for w in got["warnings"])


def test_data2_model2_fsdp_on_four_ranks_equals_one_process(tmp_path):
    cfg = port_config(parallel_config(dropout=0.1))
    ae_sd, pred_sd = P.port_weights(cfg, 70)
    kw = dict(cfg=cfg, ae_sd=ae_sd, pred_sd=pred_sd, batches=P.batches(9))
    (got,) = P.spawn(tmp_path, 4, [(P.train_scenario, dict(
        kw, mesh_shape=(2, 2), fsdp=True))])
    P.assert_runs_equal(got, P.train_scenario(**kw))


def test_tensor_parallel_guards_and_refusals():
    """A kernel in bf16 takes heads of 64: a model axis that leaves other
    heads raises; int8 is not split; without a mesh nothing changes."""
    from npvp_tpu_torch.core.tensor_parallel import (_check_kernel_heads,
                                                     shard_tensor_parallel)

    cfg = port_config(tiny_config())
    model = build_predictor(cfg, torch.bfloat16, exec_mode="pallas")
    mha = model.decoder.layer_0.slmhsa.attn
    with pytest.raises(ValueError, match="heads of 64"):
        _check_kernel_heads(model, mha, ta, 2)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    assert shard_tensor_parallel(model, None).plan == {}
    assert all(torch.equal(before[k], v)
               for k, v in model.state_dict().items())


# -- one process --------------------------------------------------------------

def _trainer_cfg(tmp_path, K):
    cfg = port_config(parallel_config(dropout=0.1))
    d, p = cfg.Dataset, cfg.Predictor
    d.batch_size, d.dev_set_size, d.num_workers = 2, 8, 1
    cfg.Env.platform, cfg.Env.steps_per_dispatch = "cpu", K
    cfg.Env.visual_callback = False
    p.epochs, p.transformer_layers, p.evt_former_num_layers = 1, 1, 1
    p.ckpt_save_dir = str(tmp_path / f"ckpt{K}")
    p.tensorboard_save_dir = str(tmp_path / f"log{K}")
    p.resume_AE_ckpt = str(s2.write_random_ae(cfg, tmp_path))
    return cfg


def test_steps_per_dispatch_gives_the_losses_of_one_step(tmp_path):
    """K = 3 runs the 4 steps of an epoch as chunks of 3 and 1 and fetches
    their metrics after each chunk: the losses of K = 1."""
    seen = {}
    for K in (1, 3):
        runs = seen[K] = []
        s2.train(_trainer_cfg(tmp_path, K), on_step=lambda kind, i, m: (
            runs.append((kind, i, {k: float(v) for k, v in m.items()
                                   if k != "data_wait_ms"}))))
    assert [(k, i) for k, i, _ in seen[1]] == [(k, i) for k, i, _ in seen[3]]
    assert [i for k, i, _ in seen[1] if k == "train"] == [1, 2, 3, 4]
    for (_, _, a), (_, _, b) in zip(seen[1], seen[3]):
        assert a == b


def test_wo_operand_sees_a_rewrite_that_keeps_the_version():
    """FSDP all-gathers a weight being trained into the same parameter
    before each forward under ``_unsafe_preserve_version_counter``: same
    tensor, same version, same storage, new values; the cached cast must
    follow. A frozen (served) weight is cached by object and version."""
    frozen = torch.nn.Linear(8, 4).weight.requires_grad_(False)
    assert ta.wo_operand(frozen, torch.bfloat16) is ta.wo_operand(
        frozen, torch.bfloat16)
    w = torch.nn.Linear(8, 4).weight
    cast = ta.wo_operand(w, torch.bfloat16)
    assert ta.wo_operand(w, torch.bfloat16) is cast
    version, ptr = w._version, w.data_ptr()
    with torch.no_grad(), torch.autograd._unsafe_preserve_version_counter(w):
        w.copy_(torch.full_like(w, 3.0))
    assert (w._version, w.data_ptr()) == (version, ptr)
    fresh = ta.wo_operand(w, torch.bfloat16)
    torch.testing.assert_close(fresh, torch.full_like(fresh, 3.0))


def test_rng_for_rows_draws_the_global_rows():
    """A rank's draw is its rows (``index::count``) of the one-process
    draw, with k entries per row and on a tensor-parallel slice."""
    rng = tl.Rng(5)
    whole = rng.bernoulli((6 * 3, 4, 8), 0.5, "cpu")
    rows = whole.reshape(6, 3, 4, 8)
    for r in range(2):
        got = rng.for_rows(r, 2, 3).bernoulli((3 * 3, 4, 8), 0.5, "cpu")
        torch.testing.assert_close(got, rows[r::2].reshape(9, 4, 8))
        part = rng.for_rows(r, 2, 3).bernoulli((3 * 3, 4, 4), 0.5, "cpu",
                                               split=(-1, 1, 2))
        torch.testing.assert_close(part, rows[r::2].reshape(9, 4, 8)[..., 4:])
    assert rng.for_rows(0, 1, 6) is rng


def test_torchrun_cli_writes_one_checkpoint_directory(tmp_path):
    """``torchrun --standalone --nproc_per_node=2 -m
    npvp_tpu_torch.train.stage2_predictor --smoke --override
    Env.platform=cpu``: both ranks train, rank 0 alone writes the
    checkpoint directory (one step file, its index, the config) and the
    log."""
    cfg = port_config(parallel_config(stochastic=False))
    d, p = cfg.Dataset, cfg.Predictor
    d.num_workers, cfg.Env.visual_callback = 1, False
    p.transformer_layers = p.evt_former_num_layers = 1
    p.ckpt_save_dir = str(tmp_path / "ckpt")
    p.tensorboard_save_dir = str(tmp_path / "log")
    p.resume_AE_ckpt = str(tmp_path / "absent")
    cfg.save(tmp_path / "cfg.json")
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join([str(REPO)] + sys.path))
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node=2", "-m", "npvp_tpu_torch.train.stage2_predictor",
         "--config_path", str(tmp_path / "cfg.json"), "--smoke",
         "--override", "Env.platform=cpu"],
        capture_output=True, text=True, env=env, cwd=tmp_path, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.count("epoch 0:") == 1  # rank 0 alone prints
    assert "mesh=DeviceMesh" in proc.stdout
    files = sorted(x.name for x in (tmp_path / "ckpt").iterdir())
    assert files == ["checkpoints.json", "config.json", "step_00000002.pt"]
    assert CheckpointManager(tmp_path / "ckpt").latest_step() == 2
    assert len((tmp_path / "log" / "metrics.jsonl").read_text()
               .splitlines()) == 1
