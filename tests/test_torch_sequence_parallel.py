"""Sequence parallelism of the port on the CPU (gloo ranks spawned with
``_torch_parallel.spawn``, fp32), against the JAX package and against the
port's one-process run:

- the forward of ``tests/test_mesh_parallel.py:14-25``'s tiny model (embed
  16, 4 heads, window 4, 1 + 1 layers, H = W = 8) at data 2 × model 4 (2
  rows a shard: windows straddle the shards) and at model 2: eval mode
  (the affine path and the decoder's k/v hoist), the generic path (SPADE
  fusion), NPVP-S with injected noise, H = 6, which model 4 does not
  divide (the stacks run whole) and model 2 does (3 rows a shard, windows
  padded centrally), and 2 heads, which model 4 leaves whole; JAX's
  outputs at atol 1e-4, the one-process port's at JAX's own 2e-5
  (``test_sp_forward_matches_single_device``);
- the gradients of a training-mode forward against one process: the
  generic path at model 2, and 2 whole heads at data 2 × model 4;
- 2 train steps at data 2 × model 2 with dropout and DropPath, alone, with
  FSDP and with ``remat`` (``_torch_parallel``'s bounds: losses rtol 1e-5,
  parameters atol 2e-5);
- the halo exchange and the (H, W, C) LayerNorm's reduction, forward and
  gradients, against the whole-tensor ops (atol 1e-5 + rtol 1e-5), and
  the reduce-scatter in both of its forms;
- the trainer CLI under ``torchrun`` with ``Env.sequence_parallel``.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import _torch_parallel as P  # noqa: E402
from _torch_helpers import parallel_config, port_config  # noqa: E402

from npvp_tpu_torch.models.predictor import NPPredictor  # noqa: E402
from npvp_tpu_torch.nn import layers as tl  # noqa: E402
from npvp_tpu_torch.tools.weights import load_flax  # noqa: E402
from npvp_tpu_torch.train import stage2_predictor as s2  # noqa: E402

REPO = Path(__file__).resolve().parents[1]

TINY = dict(embed_dim=16, num_heads=4, window_size=4, transformer_layers=1,
            evt_former_num_layers=1, evt_hidden_channels=8,
            dim_feedforward=32, dropout=0.0, drop_path=0.0)
VARIANTS = {  # name: (model arguments, H = W)
    "affine": (TINY, 8),
    "generic": (dict(TINY, fuse_method="SPADE"), 8),
    "stochastic": (dict(TINY, stochastic=True), 8),
    "h6": (TINY, 6),
    # 2 heads: model 4 leaves the attentions whole (tensor parallelism's
    # guard) while the FFN splits; model 2 splits both
    "heads2": (dict(TINY, num_heads=2), 8),
}


def _jax_run(kw, H, seed, monkeypatch):
    """JAX's tiny model at H = W: its variables, inputs and eval-mode
    features (NPVP-S with the injected ``eps``)."""
    from npvp_tpu.models.coords import coordinate_grid, spatial_index_lists
    from npvp_tpu.models.predictor import NPPredictor as JaxPredictor

    model = JaxPredictor(**kw)
    T = 4
    h, w = spatial_index_lists(H, H)
    oc = coordinate_grid(jnp.arange(2, dtype=jnp.float32), h, w, T, H, H)
    tc = coordinate_grid(jnp.arange(2, 4, dtype=jnp.float32), h, w, T, H, H)
    rng = np.random.default_rng(seed)
    obs = rng.uniform(0, 1, (8, 2, H, H, 16)).astype(np.float32)
    eps = rng.standard_normal((8, H, H, 16)).astype(np.float32)
    variables = model.init({"params": jax.random.key(seed),
                            "latent": jax.random.key(1)}, obs, oc, tc, 2,
                           target_feats_gt=obs if kw.get("stochastic")
                           else None)
    real = jax.random.normal
    monkeypatch.setattr(jax.random, "normal", lambda key, shape, dtype=None: (
        jnp.asarray(eps) if tuple(shape) == eps.shape
        else real(key, shape, dtype or jnp.float32)))
    want = np.asarray(model.apply(variables, obs, oc, tc, 2,
                                  rngs={"latent": jax.random.key(3)})
                      .pred_features)
    monkeypatch.undo()
    port_kw = dict(kw, spatial=(H, H))
    state = load_flax(NPPredictor(**port_kw), jax.tree.map(
        np.asarray, variables)).state_dict()
    inputs = dict(obs=torch.from_numpy(obs),
                  oc=torch.from_numpy(np.array(oc)),
                  tc=torch.from_numpy(np.array(tc)))
    if kw.get("stochastic"):
        inputs["eps"] = torch.from_numpy(eps)
    return port_kw, state, inputs, want


@pytest.fixture(scope="module")
def forwards(tmp_path_factory):
    """Every variant's JAX features, the one-process port's, and the
    port's under sequence parallelism at data 2 × model 4 (8 ranks) and
    at model 2 (2 ranks, with a training-mode forward's gradients)."""
    mp = pytest.MonkeyPatch()
    runs = {}
    for i, (name, (kw, H)) in enumerate(VARIANTS.items()):
        port_kw, state, inputs, want = _jax_run(kw, H, 20 + i, mp)
        runs[name] = dict(model_kw=port_kw, state=state, inputs=inputs,
                          jax=want)
    one = {name: P.sp_forward_scenario(r["model_kw"], r["state"],
                                       r["inputs"])
           for name, r in runs.items()}
    train = {mesh: dict(model_kw=runs[name]["model_kw"],
                        state=runs[name]["state"],
                        inputs=runs[name]["inputs"], train=True)
             for mesh, name in (((1, 2), "generic"), ((2, 4), "heads2"))}
    one["train"] = {mesh: P.sp_forward_scenario(**kw)
                    for mesh, kw in train.items()}
    got = {}
    for mesh in ((2, 4), (1, 2)):
        scen = [(P.sp_forward_scenario, dict(
            model_kw=r["model_kw"], state=r["state"], inputs=r["inputs"],
            mesh_shape=mesh)) for r in runs.values()]
        scen.append((P.sp_forward_scenario, dict(train[mesh],
                                                 mesh_shape=mesh)))
        out = P.spawn(tmp_path_factory.mktemp(f"sp{mesh[1]}"),
                      mesh[0] * mesh[1], scen)
        got[mesh] = dict(zip(list(runs) + ["train"], out))
    return dict(runs=runs, one=one, got=got)


@pytest.mark.parametrize("mesh", [(2, 4), (1, 2)],
                         ids=["data2_model4", "model2"])
@pytest.mark.parametrize("name", list(VARIANTS))
def test_sp_forward_matches_jax_and_one_process(forwards, mesh, name):
    got = forwards["got"][mesh][name]
    _, H = VARIANTS[name]
    # H = 6: model 4 runs both stacks whole, model 2 splits them
    assert got["splits"] == (0 if H % mesh[1] else 2)
    feats = got["features"].numpy()
    np.testing.assert_allclose(feats, forwards["runs"][name]["jax"],
                               atol=1e-4, rtol=0)
    np.testing.assert_allclose(
        feats, forwards["one"][name]["features"].numpy(), atol=2e-5,
        rtol=0)


@pytest.mark.parametrize("mesh", [(2, 4), (1, 2)],
                         ids=["data2_model4_heads2", "model2"])
def test_sp_training_forward_gradients_equal_one_process(forwards, mesh):
    """Training mode: the generic path at model 2, and 2 heads at data 2
    × model 4 (the attentions whole on every rank, the FFN split; the
    data ranks' gradients summed): features at 2e-5 and every parameter's
    gradient of Σ features² within 1e-5 of the largest gradient element,
    and within 1e-4 of its own largest (the sums' order over ranks
    differs; the attention's k bias, whose true gradient is zero by the
    softmax's shift invariance, holds rounding noise only)."""
    got, want = forwards["got"][mesh]["train"], forwards["one"]["train"][
        mesh]
    assert got["splits"] == 2
    np.testing.assert_allclose(got["features"].numpy(),
                               want["features"].numpy(), atol=2e-5)
    assert sorted(got["grads"]) == sorted(want["grads"])
    top = max(w.abs().max().item() for w in want["grads"].values())
    for k, w in want["grads"].items():
        own = w.abs().max().item()
        atol = 1e-5 * top if k.endswith("wk.bias") else 1e-4 * own
        np.testing.assert_allclose(got["grads"][k].numpy(), w.numpy(),
                                   atol=min(atol, 1e-5 * top), rtol=0,
                                   err_msg=k)


@pytest.fixture(scope="module")
def training(tmp_path_factory):
    """2 train steps at data 2 × model 2 under sequence parallelism with
    dropout and DropPath 0.1: alone, with FSDP, with remat; and the
    one-process runs."""
    cfg = port_config(parallel_config(dropout=0.1))
    remat = port_config(parallel_config(dropout=0.1))
    remat.Predictor.remat = True
    ae_sd, pred_sd = P.port_weights(cfg, 80)
    kw = dict(ae_sd=ae_sd, pred_sd=pred_sd, batches=P.batches(11))
    runs = dict(sp=dict(kw, cfg=cfg), fsdp=dict(kw, cfg=cfg, fsdp=True),
                remat=dict(kw, cfg=remat))
    got = P.spawn(tmp_path_factory.mktemp("sp_train"), 4, [
        (P.train_scenario, dict(r, mesh_shape=(2, 2), sp=True))
        for r in runs.values()])
    want = {"cfg": P.train_scenario(**runs["sp"]),
            "remat": P.train_scenario(**runs["remat"])}
    return dict(zip(runs, got)), want


@pytest.mark.parametrize("arm", ["sp", "fsdp", "remat"])
def test_sp_training_equals_one_process(training, arm):
    got, want = training
    P.assert_runs_equal(got[arm], want["remat" if arm == "remat" else "cfg"])


def pieces_inputs():
    rng = np.random.default_rng(5)
    return tuple(torch.from_numpy(rng.standard_normal((3, 8, 5, 6)).astype(
        np.float32)) for _ in range(2))


@pytest.fixture(scope="module")
def pieces(tmp_path_factory):
    x, g = pieces_inputs()
    norm = tl.LayerNormHWC((8, 5, 6))
    with torch.no_grad():
        norm.weight.uniform_(0.5, 1.5)
        norm.bias.uniform_(-0.5, 0.5)
    kw = dict(x=x, g=g, norm_state=norm.state_dict())
    got = {}
    for m in (2, 4):
        (got[m],) = P.spawn(tmp_path_factory.mktemp(f"pieces{m}"), m, [
            (P.sp_pieces_scenario, dict(kw, mesh_shape=(1, m)))])
    return got, P.sp_pieces_scenario(**kw)


@pytest.mark.parametrize("model", [2, 4])
def test_halo_and_layernorm_reduction_equal_whole_ops(pieces, model):
    """Rows of 8 over model 2 (4 a shard) and 4 (2 a shard): the
    halo-padded depthwise conv and the LayerNorm equal the whole-tensor
    ops, forward and every gradient (input, conv and norm parameters), at
    atol 1e-5 + rtol 1e-5: fp32 sums over ~10² terms taken in another
    order (the parameter gradients reach ~50)."""
    got, want = pieces
    for key, w in want.items():
        np.testing.assert_allclose(got[model][key].numpy(), w.numpy(),
                                   atol=1e-5, rtol=1e-5, err_msg=key)


@pytest.mark.parametrize("model", [2, 4])
@pytest.mark.parametrize("way", ["gloo", "tensor"])
def test_reduce_scatter_h_both_ways(pieces, model, way):
    """The reduce-scatter of the ranks' partials (rank + 1)·x in gloo's
    form (all-reduce and slice) and in NCCL's (the tensor reduce-scatter
    and its chunk layout, run here on gloo) is Σ(r + 1)·x (rtol 1e-6: a
    few fp32 additions), and its gradient is the whole upstream gradient
    on every rank (bit-equal: an all-gather)."""
    got, _ = pieces
    x, g = pieces_inputs()
    np.testing.assert_allclose(got[model][f"rs_{way}"].numpy(),
                               (model * (model + 1) / 2 * x[:, None]).numpy(),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(got[model]["rs_grad"].numpy(),
                                  g[:, None].numpy())


def test_dropout_on_an_h_shard_is_the_one_process_mask():
    """A shard's draw (``Rng`` split on H) is its rows of the whole draw,
    also with data rows."""
    rng = tl.Rng(3).fold("drop")
    whole = rng.bernoulli((4 * 2, 8, 5), 0.5, "cpu")
    for r in range(2):
        part = rng.for_rows(r, 2, 2).bernoulli((2 * 2, 4, 5), 0.5, "cpu",
                                               split=(1, 1, 2))
        want = whole.reshape(4, 2, 8, 5)[r::2].reshape(4, 8, 5)[:, 4:]
        torch.testing.assert_close(part, want)


def test_torchrun_cli_with_sequence_parallel(tmp_path):
    """``torchrun --nproc_per_node=2`` of the stage-2 trainer at model 2
    with ``Env.sequence_parallel``: it says it runs on H shards and logs
    the one-process run's epoch losses (rtol 1e-5)."""
    cfg = port_config(parallel_config(stochastic=False))
    d, p = cfg.Dataset, cfg.Predictor
    d.num_workers, cfg.Env.visual_callback = 1, False
    cfg.Env.platform = "cpu"
    p.transformer_layers = p.evt_former_num_layers = 1
    p.ckpt_save_dir = str(tmp_path / "ckpt")
    p.tensorboard_save_dir = str(tmp_path / "log")
    p.resume_AE_ckpt = str(s2.write_random_ae(cfg, tmp_path))
    cfg.save(tmp_path / "cfg.json")
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join([str(REPO)] + sys.path))
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node=2", "-m", "npvp_tpu_torch.train.stage2_predictor",
         "--config_path", str(tmp_path / "cfg.json"), "--smoke",
         "--override", "Env.sequence_parallel=true",
         "Env.mesh_shape=[[data,1],[model,2]]"],
        capture_output=True, text=True, env=env, cwd=tmp_path, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "sequence_parallel=True" in proc.stdout
    got = json.loads((tmp_path / "log" / "metrics.jsonl").read_text()
                     .splitlines()[0])
    cfg.Dataset.dev_set_size = 2 * d.batch_size
    cfg.Predictor.epochs = 1
    p.ckpt_save_dir = str(tmp_path / "ckpt1")
    p.tensorboard_save_dir = str(tmp_path / "log1")
    s2.train(cfg, max_steps=10)
    want = json.loads((tmp_path / "log1" / "metrics.jsonl").read_text()
                      .splitlines()[0])
    keys = [k for k in want if k.endswith(("_train", "_val"))
            and not k.startswith("data_wait")]
    assert keys
    for k in keys:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, err_msg=k)
