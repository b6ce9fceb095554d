"""Data and fully-sharded parallelism of the port on the CPU, with gloo
ranks spawned at the tiny test width (2 + 2 layers, embed 32, 4 heads,
fp32), against the JAX package and against the port's one-process run at
the same global batch (tensor parallelism, four ranks and the trainers'
plumbing are in ``test_torch_parallel_tp.py``):

- the mesh's axis sizes and the tensor-parallel split of every parameter
  against ``npvp_tpu.core.mesh``;
- the loaders' split by process against the JAX loader's;
- 2 ranks at data 2 against JAX's trainer on the 4-row global batch
  (NPVP-S, rand-context, BatchNorm in training mode, the latent noise
  drawn as zeros in both packages, which cannot draw the same noise; one
  layer each side, since JAX's compile of a step is the cost);
- data 2, with dropout and DropPath, and with FSDP against the
  one-process port: losses, gradients, the clip's global norm, eval
  losses and outputs, parameters and statistics after 2 steps; the AE
  trainer at data 2 in DDP and FSDP;
- a 2-rank FSDP checkpoint restored into one process;
- ``VideoPredictor.shard`` at data 2 against ``predict``.

Tolerances: losses and norms rtol 1e-5 (fp32, sums over ranks in another
order); parameters atol 1e-5 against JAX (PR 5's bound) and 2e-5 against
the one-process port (``_torch_parallel.PARAM_ATOL``), BatchNorm
statistics atol 1e-6 + rtol 1e-5; gradients and outputs atol 1e-5.
"""

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import _torch_parallel as P  # noqa: E402
from _torch_helpers import (parallel_config, port_config,  # noqa: E402
                            random_variables, tiny_config)

from npvp_tpu_torch.core import distributed as D  # noqa: E402
from npvp_tpu_torch.core.checkpoint import CheckpointManager  # noqa: E402
from npvp_tpu_torch.core.tensor_parallel import tensor_parallel_plan  # noqa: E402
from npvp_tpu_torch.data import loader as tload  # noqa: E402
from npvp_tpu_torch.models.predictor import build_predictor  # noqa: E402
from npvp_tpu_torch.nn import layers as tl  # noqa: E402
from npvp_tpu_torch.nn.resnet_ae import build_ae  # noqa: E402
from npvp_tpu_torch.tools.weights import load_flax, to_flax  # noqa: E402
from npvp_tpu_torch.train import stage2_predictor as s2  # noqa: E402



# -- the mesh and the split table against JAX --------------------------------

@pytest.mark.parametrize("n, data, model, batch", [
    (8, -1, 1, None), (8, -1, 2, None), (8, 2, 4, None), (8, -1, 1, 4),
    (8, -1, 1, 6), (8, 4, 2, 6), (4, -1, 4, 3), (2, -1, 1, 3), (4, 2, 2, 16),
    (6, -1, 4, None), (4, 3, 2, None),
])
def test_mesh_axis_sizes_match_jax(n, data, model, batch):
    from npvp_tpu.core.mesh import make_mesh

    try:
        want = make_mesh(data, model, devices=jax.devices()[:n],
                         batch_size=batch).devices.shape
    except ValueError:
        with pytest.raises(ValueError):
            D.mesh_axis_sizes(n, data, model, batch)
        return
    assert D.mesh_axis_sizes(n, data, model, batch) == want


@pytest.mark.parametrize("model", [2, 4, 8])
def test_tensor_parallel_split_matches_jax_param_spec(model):
    """For every parameter of a tiny NPVP-S predictor, the port's split
    (dimension, or none) is where JAX's ``param_spec`` puts the model axis
    once its guard has run: each flax leaf is filled with its index along
    the axis JAX shards, carried into the port's layout by the weight
    bridge, and the port tensor must vary along the port's split dimension
    alone. At model 8 the 4 heads stay whole and the FFN splits."""
    from npvp_tpu.core.mesh import MODEL_AXIS, tree_shardings
    from npvp_tpu.core.mesh import make_mesh as jmesh

    from npvp_tpu.models.predictor import build_predictor as jbuild

    cfg = tiny_config(stochastic=True)
    p = cfg.Predictor
    feats = np.zeros((1, 2, p.max_H, p.max_W, p.embed_dim))
    oc = np.zeros((2 * p.max_H * p.max_W, 3))
    pred = jbuild(cfg, jnp.float32)
    variables = random_variables(
        lambda *a: pred.init(*a, num_target=2, target_feats_gt=feats,
                             train=True),
        {k: jax.random.key(i) for i, k in enumerate(
            ("params", "latent", "dropout", "droppath"))}, feats, oc, oc)
    specs = tree_shardings(jmesh(1, model, devices=jax.devices()[:model]),
                           variables["params"])

    def index(spec, leaf):
        axes = [i for i, a in enumerate(spec.spec) if a == MODEL_AXIS]
        if not axes:
            return np.zeros_like(leaf)
        shape = [1] * leaf.ndim
        shape[axes[0]] = leaf.shape[axes[0]]
        ids = np.arange(leaf.shape[axes[0]], dtype=np.float32).reshape(shape)
        return np.broadcast_to(ids, leaf.shape).copy()

    ids = jax.tree.map(index, specs, variables["params"])
    port = build_predictor(port_config(cfg))
    load_flax(port, {"params": ids,
                     "batch_stats": variables["batch_stats"]})
    plan = tensor_parallel_plan(port, model)
    assert plan, "nothing is split"
    for name, t in port.named_parameters():
        t = t.detach()
        varies = [d for d in range(t.dim())
                  if not torch.equal(t, t.narrow(d, 0, 1).expand_as(t))]
        assert varies == ([plan[name]] if name in plan else []), name
    heads_split = any(".attn.wq." in k for k in plan)
    assert heads_split == (model <= 4)
    assert any("linear1" in k for k in plan)


# -- the loaders' split by process -------------------------------------------

class _Index:
    """Sample i is a clip of 8 frames filled with i."""

    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i, rng=None):
        return np.full((8, 2, 2, 1), i, np.float32)


@pytest.mark.parametrize("count", [2, 3])
def test_loader_split_by_process_matches_jax(count):
    """Two epochs of each process's batches: the samples of JAX's
    ``idx[i::count]`` split, batch by batch; the rand-context masks equal
    on every process and equal to the one-process loader's (JAX's process
    0); the processes' rows, interleaved, are the one-process batch."""
    from npvp_tpu.data.loader import BatchLoader

    kw = dict(shuffle=True, num_past=3, num_future=5, mode="rand_context",
              min_lo=2, max_lo=6, seed=4)
    ds = _Index(12 * count)
    one = tload.BatchLoader(ds, 2 * count, num_workers=1, **kw)
    for epoch in (0, 1):
        one.set_epoch(epoch)
        whole = list(one)
        ranks = []
        for i in range(count):
            want = BatchLoader(ds, 2, num_workers=1, process_index=i,
                               process_count=count, **kw)
            got = tload.BatchLoader(ds, 2, num_workers=1, process_index=i,
                                    process_count=count, **kw)
            want.set_epoch(epoch)
            got.set_epoch(epoch)
            assert len(got) == len(want) == len(one) == 6
            pairs = list(zip(got, want, strict=True))
            for g, w in pairs:
                np.testing.assert_array_equal(g["clip"], w["clip"])
                if i == 0:
                    np.testing.assert_array_equal(g["obs_mask"],
                                                  w["obs_mask"])
            ranks.append([g for g, _ in pairs])
        for b, batch in enumerate(whole):
            rows = np.stack([r[b]["clip"] for r in ranks], 1).reshape(
                batch["clip"].shape)
            np.testing.assert_array_equal(rows, batch["clip"])
            for r in ranks:
                np.testing.assert_array_equal(r[b]["obs_mask"],
                                              batch["obs_mask"])
            local = D.shard_batch(_FakeMesh(1, count), batch)
            np.testing.assert_array_equal(local["clip"], ranks[1][b]["clip"])


def test_data_module_gives_each_process_its_rows():
    cfg = port_config(tiny_config())
    cfg.Dataset.batch_size, cfg.Dataset.dev_set_size = 4, 8
    dm = tload.DataModule(cfg, process_index=1, process_count=2)
    loader = dm.train_loader("rand_context")
    assert (loader.batch_size, loader.process_index,
            loader.process_count) == (2, 1, 2)
    assert len(loader) == dm.len_train_loader == 2
    with pytest.raises(ValueError, match="split"):
        tload.DataModule(cfg, process_count=3)


class _FakeMesh:
    """A mesh's data axis as ``shard_batch`` reads it, without a group."""

    def __init__(self, rank, size):
        self._rank, self._size = rank, size

    def __getitem__(self, name):
        return self

    def size(self):
        return self._size

    def get_group(self, name):
        return None

    def get_local_rank(self, name):
        return self._rank


# -- two ranks at data 2 ------------------------------------------------------

def _jax_two_steps(cfg, ae_vars, pred_vars, batches):
    """JAX's ``make_steps`` on the global batches, the latent noise drawn
    as zeros; → (metrics per step, final variables)."""
    from npvp_tpu.core.mesh import make_mesh
    from npvp_tpu.core.optim import make_predictor_optimizer
    from npvp_tpu.core.train_state import TrainState
    from npvp_tpu.models.predictor import build_predictor as jbuild
    from npvp_tpu.train.stage1_ae import build_ae as jbuild_ae
    from npvp_tpu.train.stage2_predictor import make_steps

    p = cfg.Predictor
    tx = make_predictor_optimizer(p.predictor_lr, p.max_grad_norm,
                                  p.use_cosine_scheduler,
                                  p.scheduler_eta_min, p.scheduler_T0 * 3)
    pred = jbuild(cfg, jnp.float32)
    state = TrainState.create(
        apply_fn=pred.apply,
        params=jax.tree.map(jnp.asarray, pred_vars["params"]),
        batch_stats=pred_vars["batch_stats"], tx=tx)
    mesh = make_mesh(data=1, devices=jax.devices()[:1])
    train_step, _, place, *_ = make_steps(
        cfg, pred, jbuild_ae(cfg, jnp.float32), ae_vars, mesh,
        "rand_context")
    normal = jax.random.normal
    jax.random.normal = lambda key, shape=(), dtype=jnp.float32: jnp.zeros(
        shape, dtype)
    try:
        metrics = []
        for i, batch in enumerate(batches):
            state, m = train_step(state, place(batch), jax.random.key(i))
            metrics.append({k: float(v) for k, v in m.items()})
    finally:
        jax.random.normal = normal
    f32 = lambda t: jax.tree.map(lambda a: np.asarray(a, np.float32), t)  # noqa
    return metrics, {"params": f32(state.params),
                     "batch_stats": f32(state.batch_stats)}


@pytest.fixture(scope="module")
def data2(tmp_path_factory):
    """One spawn of 2 ranks at data 2: the JAX-comparison run, dropout and
    DropPath at the shipped 0.1, FSDP with a checkpoint, and serving; with
    the one-process runs they must equal."""
    tmp = tmp_path_factory.mktemp("data2")
    jcfg = parallel_config(layers=1)  # JAX's compile of a step is slow
    cfg = port_config(jcfg)
    from npvp_tpu.models.predictor import build_predictor as jbuild
    from npvp_tpu.train.stage1_ae import build_ae as jbuild_ae

    d, p = jcfg.Dataset, jcfg.Predictor
    ae_vars = random_variables(jbuild_ae(jcfg, jnp.float32).init,
                               jax.random.key(0), np.zeros(
                                   (1, 2, d.img_size, d.img_size,
                                    d.img_channels)), seed=40)
    feats0 = np.zeros((1, 2, p.max_H, p.max_W, p.embed_dim))
    oc0 = np.zeros((2 * p.max_H * p.max_W, 3))
    pred = jbuild(jcfg, jnp.float32)
    pred_vars = random_variables(
        lambda *a: pred.init(*a, num_target=2, target_feats_gt=feats0,
                             train=True),
        {k: jax.random.key(i) for i, k in enumerate(
            ("params", "latent", "dropout", "droppath"))},
        feats0, oc0, oc0, seed=41)
    ae_sd = load_flax(build_ae(cfg), ae_vars).state_dict()
    pred_sd = load_flax(build_predictor(cfg), pred_vars).state_dict()
    batches = P.batches()

    drop_cfg = port_config(parallel_config(dropout=0.1))
    drop_w = P.port_weights(drop_cfg, 50)
    cfg2 = port_config(parallel_config())
    ae2, pred2 = P.port_weights(cfg2, 55)
    rng = np.random.default_rng(3)
    frames = rng.uniform(0, 1, (4, 4, 32, 32, 1)).astype(np.float32)
    stream = rng.uniform(0, 1, (2, 4, 4, 32, 32, 1)).astype(np.float32)
    odd = frames[:3]
    serve = dict(cfg=cfg2, ae_sd=ae2, pred_sd=pred2, frames=frames,
                 stream=stream, odd=odd)
    clips = [{"past": b["clip"][:, :4], "future": b["clip"][:, 4:]}
             for b in batches]
    runs = dict(
        jax=(P.train_scenario, dict(cfg=cfg, ae_sd=ae_sd, pred_sd=pred_sd,
                                    batches=batches, zero_latent=True)),
        stage1_ddp=(P.stage1_scenario, dict(cfg=cfg2, ae_sd=ae2,
                                            batches=clips)),
        stage1_fsdp=(P.stage1_scenario, dict(cfg=cfg2, ae_sd=ae2,
                                             batches=clips, fsdp=True)),
        dropout=(P.train_scenario, dict(cfg=drop_cfg, ae_sd=drop_w[0],
                                        pred_sd=drop_w[1], batches=batches)),
        fsdp=(P.train_scenario, dict(cfg=cfg2, ae_sd=ae2, pred_sd=pred2,
                                     batches=batches, fsdp=True)),
        serve=(P.serve_scenario, serve))
    ckpt = tmp / "ckpt"
    scenarios = []
    for name, (fn, kw) in runs.items():
        kw = dict(kw, mesh_shape=(2, 1))
        if name == "fsdp":
            kw["ckpt_dir"] = str(ckpt)
        scenarios.append((fn, kw))
    got = dict(zip(runs, P.spawn(tmp, 2, scenarios)))
    want = {name: fn(**kw) for name, (fn, kw) in runs.items()}
    jax_metrics, jax_vars = _jax_two_steps(jcfg, ae_vars, pred_vars,
                                           batches)
    return dict(got=got, want=want, jax=(jax_metrics, jax_vars), cfg=cfg,
                cfg2=cfg2, ckpt=ckpt, ae_sd=ae2, batches=batches)


def test_two_ranks_equal_jax_trainer_on_the_global_batch(data2):
    """Losses rtol 1e-5; parameters atol 1e-5 and the global BatchNorm
    statistics atol 1e-6 + rtol 1e-5 after 2 steps (the EventEncoders'
    BatchNorms in training mode: a rank-local update would differ)."""
    metrics, variables = data2["jax"]
    got = data2["got"]["jax"]
    for g, w in zip(got["metrics"], metrics, strict=True):
        assert sorted(g) == sorted(w)
        P.close(g, w, atol=0.0, rtol=1e-5, what="loss")
    want = load_flax(build_predictor(data2["cfg"]), variables).state_dict()
    P.assert_states(got["model"], want)
    assert any(k.endswith("running_var") for k in want)


def test_two_ranks_equal_one_process(data2):
    """The same run in one process: losses, gradients, norms, eval losses
    and outputs, and the state after 2 steps."""
    P.assert_runs_equal(data2["got"]["jax"], data2["want"]["jax"])


def test_dropout_and_drop_path_draw_the_one_process_noise(data2):
    got, want = data2["got"]["dropout"], data2["want"]["dropout"]
    P.assert_runs_equal(got, want)
    # the masks matter: the run without them differs
    assert abs(got["metrics"][0]["loss"]
               - data2["want"]["jax"]["metrics"][0]["loss"]) > 1e-4


def test_fsdp_equals_one_process(data2):
    P.assert_runs_equal(data2["got"]["fsdp"], data2["want"]["fsdp"])


def test_fsdp_checkpoint_restores_in_one_process(data2):
    """The 2-rank FSDP run's checkpoint (rank 0's files, gathered) in a
    one-process state: the one-process run's weights, moments and eval
    losses, and the same ``to_flax`` tree."""
    cfg = data2["cfg2"]
    mngr = CheckpointManager(data2["ckpt"])
    assert mngr.latest_step() == 2
    assert sorted(p.name for p in data2["ckpt"].iterdir()) == [
        "checkpoints.json", "step_00000002.pt"]
    state = s2.init_predictor_state(cfg, build_predictor(cfg), 3)
    mngr.restore(state)
    want = data2["want"]["fsdp"]
    P.assert_states(state.model.state_dict(), want["model"], atol=P.PARAM_ATOL)
    ae = build_ae(cfg)
    ae.load_state_dict(data2["ae_sd"])
    steps = s2.make_steps(cfg, ae.eval().requires_grad_(False),
                          "rand_context", "cpu")
    evals = steps.eval(state, steps.place(data2["batches"][0]), tl.Rng(99))
    P.close({k: float(v) for k, v in evals.items()}, want["evals"],
           atol=1e-7, rtol=1e-5, what="eval")
    one = build_predictor(cfg)
    one.load_state_dict(want["model"])
    got_tree, want_tree = to_flax(state.model), to_flax(one)
    flat = lambda t: {"/".join(str(k.key) for k in path): v  # noqa: E731
                      for path, v in jax.tree_util.tree_flatten_with_path(
                          t)[0]}
    g, w = flat(got_tree), flat(want_tree)
    assert sorted(g) == sorted(w)
    P.close(g, w, atol=P.PARAM_ATOL, what="to_flax")
    moments = state.optimizer.state_dict()["state"]
    for i, st in want["optimizer"]["state"].items():
        np.testing.assert_allclose(moments[i]["exp_avg"].numpy(),
                                   st["exp_avg"].numpy(), atol=1e-6)


@pytest.mark.parametrize("arm", ["stage1_ddp", "stage1_fsdp"])
def test_stage1_data_parallel_equals_one_process(data2, arm):
    """The AE trainer at data 2, in DDP and fully sharded: the L1 of each
    step, the first update's gradients and the global BatchNorm
    statistics of the first step. (Later parameters and statistics are not
    held: biases before a batch-statistics BatchNorm have gradients of
    exactly zero up to rounding, Adam moves such an element by ~lr
    whatever its size, and the running mean follows the bias.)"""
    got, want = data2["got"][arm], data2["want"][arm]
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-5)
    P.close({k: v.numpy() for k, v in got["grads"].items()},
           {k: v.numpy() for k, v in want["grads"].items()}, atol=1e-5,
           what="grad")
    assert want["stats"] and sorted(got["stats"]) == sorted(want["stats"])
    for k, w in want["stats"].items():
        np.testing.assert_allclose(got["stats"][k].numpy(), w.numpy(),
                                   atol=1e-6, rtol=1e-5, err_msg=k)


def test_video_predictor_shard_data2_equals_predict(data2):
    """``predict``, ``freeze_task`` and ``predict_stream`` at data 2 equal
    the one-process calls; a batch of 3 warns and runs whole."""
    got, want = data2["got"]["serve"], data2["want"]["serve"]
    P.assert_serving(got, want)
    split = lambda run: [w for w in run["warnings"]  # noqa: E731
                         if "does not divide" in w]
    assert split(want) == [] and len(split(got)) == 1


