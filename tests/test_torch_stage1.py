"""Stage-1 AE training in the port against the JAX package's trainer, fp32
on the CPU at the tiny test size, and the repairs of the stage-2 trainer:

- one and two ``make_steps`` train steps from the same flax variables and
  batches: losses (rtol 1e-5), parameters (atol 1e-5) and BatchNorm
  statistics (atol 1e-6) through the flax → torch bridge; the eval step's
  L1 (1e-6);
- the trainer and its ``--smoke`` CLI on the CPU, with the GIF of the
  visual callback, and stage 2 training over that checkpoint directory as
  its frozen AE, with its own GIF;
- resume from a checkpoint directory and warm start from a weights archive;
- the D→S warm start of stage 2 from an NPVP-D weights archive;
- the ``Env`` fields that the port does not honour are named at start.
"""

import functools

import pytest

torch = pytest.importorskip("torch")
# tiny tensors: one thread per test worker, not one per core
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from _torch_helpers import (port_config, random_variables,  # noqa: E402
                            tiny_config)

from npvp_tpu_torch.core.checkpoint import CheckpointManager  # noqa: E402
from npvp_tpu_torch.core.metrics import gif_frame_count  # noqa: E402
from npvp_tpu_torch.models.predictor import build_predictor  # noqa: E402
from npvp_tpu_torch.nn.resnet_ae import build_ae  # noqa: E402
from npvp_tpu_torch.tools.weights import (load_flax, random_init,  # noqa
                                          to_flax)
from npvp_tpu_torch.train import stage1_ae as s1  # noqa: E402
from npvp_tpu_torch.train import stage2_predictor as s2  # noqa: E402
from npvp_tpu_torch.train.common import restore_state  # noqa: E402


def _cfg():
    """tiny_config for stage 1: batch 2, fp32, a rate that shows in two
    steps."""
    cfg = tiny_config()
    cfg.Dataset.batch_size, cfg.Env.compute_dtype = 2, "float32"
    cfg.AE.AE_lr = 1e-3
    return cfg.validate()


def _batches():
    rng = np.random.default_rng(5)
    out = []
    for _ in range(2):
        clip = rng.uniform(0, 1, (2, 8, 32, 32, 1)).astype(np.float32)
        out.append({"past": clip[:, :4], "future": clip[:, 4:]})
    return out


def _np_tree(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


@pytest.fixture(scope="module")
def two_steps():
    """Two steps of each trainer from flax's own init (the JAX trainer's
    starting point), and, at each step, JAX's forward, gradients and
    statistics update from the port's state before that step, and optax's
    Adam fed the port's own gradients."""
    import optax

    from npvp_tpu.core.mesh import make_mesh
    from npvp_tpu.core.optim import make_ae_optimizer
    from npvp_tpu.core.train_state import TrainState
    from npvp_tpu.nn.losses import l1_loss as jl1
    from npvp_tpu.train.stage1_ae import build_ae as jbuild
    from npvp_tpu.train.stage1_ae import make_steps

    cfg = _cfg()
    ae = jbuild(cfg, jnp.float32)
    variables = _np_tree(ae.init(jax.random.key(cfg.Env.rand_seed),
                                 np.zeros((1, 2, 32, 32, 1), np.float32)))
    tx = make_ae_optimizer(cfg.AE.AE_lr)
    state = TrainState.create(
        apply_fn=ae.apply, params=jax.tree.map(jnp.asarray,
                                               variables["params"]),
        batch_stats=variables["batch_stats"], tx=tx)
    mesh = make_mesh(data=1, devices=jax.devices()[:1])
    train_step, eval_step, *_ = make_steps(ae, mesh)
    trainer_losses = []
    for batch in _batches():
        state, m = train_step(state, batch)
        trainer_losses.append(float(m["L1_loss_train"]))

    @jax.jit
    def loss_and_grads(params, stats, x):
        def loss_fn(params):
            (rec, _), mut = ae.apply({"params": params, "batch_stats": stats},
                                     x, train=True, mutable=["batch_stats"])
            return jl1(rec, x), mut["batch_stats"]
        return jax.value_and_grad(loss_fn, has_aux=True)(params)

    tcfg = port_config(cfg)
    tae = build_ae(tcfg)
    tstate = s1.init_state(tcfg, tae)
    load_flax(tae, variables)  # init drew random weights over them
    grads = []
    apply = tstate.apply_gradients

    def capture():  # the gradients the trainer's update receives
        grads.append({n: p.grad.clone() for n, p in tae.named_parameters()})
        apply()

    tstate.apply_gradients = capture
    steps = s1.make_steps("cpu")
    rows = []
    opt_params = jax.tree.map(jnp.asarray, variables["params"])
    opt_state = tx.init(opt_params)
    for batch in _batches():
        before = to_flax(tae)
        x = np.concatenate([batch["past"], batch["future"]], axis=1)
        (loss, stats), jgrads = loss_and_grads(
            jax.tree.map(jnp.asarray, before["params"]),
            before["batch_stats"], x)
        got = float(steps.train(tstate, steps.place(batch))["L1_loss_train"])
        upd, opt_state = tx.update(
            to_flax(_grad_module(tae, grads[-1]))["params"],
            opt_state, opt_params)
        opt_params = optax.apply_updates(opt_params, upd)
        rows.append(dict(
            loss=float(loss), got=got, grads=grads[-1],
            want_grads=dict(load_flax(build_ae(tcfg), {
                "params": _np_tree(jgrads),
                "batch_stats": variables["batch_stats"]}).named_parameters()),
            stats=load_flax(build_ae(tcfg), {
                "params": variables["params"],
                "batch_stats": _np_tree(stats)}).state_dict(),
            adam=load_flax(build_ae(tcfg), {
                "params": _np_tree(opt_params),
                "batch_stats": variables["batch_stats"]}).state_dict(),
            state={k: v.clone() for k, v in tae.state_dict().items()}))
    batch = _batches()[0]
    got_eval = float(steps.eval(tstate, steps.place(batch))["L1_loss_valid"])
    want_eval = float(eval_step(
        state.replace(**{k: jax.tree.map(jnp.asarray, v) for k, v in
                         to_flax(tae).items()
                         if k in ("params", "batch_stats")}),
        batch)["L1_loss_valid"])
    return dict(trainer_losses=trainer_losses, rows=rows,
                want_eval=want_eval, got_eval=got_eval, tstate=tstate)


def _grad_module(module, grads):
    """A copy of ``module`` whose parameters hold ``grads``."""
    import copy

    out = copy.deepcopy(module)
    with torch.no_grad():
        for name, p in out.named_parameters():
            p.copy_(grads[name])
    return out


def test_train_steps_losses_match_jax(two_steps):
    """The losses of the two steps against the JAX trainer's (rtol 1e-5)
    and against JAX's forward from the port's state before each step."""
    assert two_steps["tstate"].step == 2
    got = [r["got"] for r in two_steps["rows"]]
    np.testing.assert_allclose(got, two_steps["trainer_losses"], rtol=1e-5)
    np.testing.assert_allclose(got, [r["loss"] for r in two_steps["rows"]],
                               rtol=1e-5)


@pytest.mark.parametrize("step", [0, 1])
def test_train_step_gradients_match_jax(two_steps, step):
    """The gradients each update receives against JAX's from the same state:
    atol 1e-4 of the tensor's largest magnitude (at least 1e-4), rtol 1e-3,
    the bound of the stage-2 gradient test. (Parameters are not held to
    JAX's after the step at a fixed atol: a conv bias feeding a
    batch-statistics BatchNorm has a gradient of exactly zero, and many
    weights have elements near zero, so Adam's first steps, which move each
    element by about ±lr whatever its size, turn rounding noise into
    different moves in either package.)"""
    row = two_steps["rows"][step]
    for name, g in row["grads"].items():
        want = row["want_grads"][name].detach().numpy()
        np.testing.assert_allclose(
            g.numpy(), want, rtol=1e-3,
            atol=1e-4 * max(1.0, np.abs(want).max()), err_msg=name)


@pytest.mark.parametrize("step", [0, 1])
def test_train_step_updates_match_jax(two_steps, step):
    """Parameters after one and two steps equal optax's Adam(0.5, 0.999)
    fed the same gradients (atol 1e-6); the running statistics of every
    BatchNorm (the ConvBNActs' and the non-local attention's) equal flax's
    update from the same state, atol 1e-6 plus rtol 1e-5: the non-local
    attention's output is nearly constant over a clip, so its BatchNorm's
    fp32 E[x²] − E[x]² (both packages' form) keeps about five digits."""
    row = two_steps["rows"][step]
    stats = [k for k in row["stats"]
             if k.endswith(("running_mean", "running_var"))]
    assert any("attn2d.bn" in k for k in stats)
    for key, value in row["state"].items():
        want = row["stats"][key] if key in stats else row["adam"][key]
        np.testing.assert_allclose(value.numpy(), want.numpy(),
                                   rtol=1e-5 if key in stats else 0,
                                   atol=1e-6, err_msg=key)


def test_eval_step_matches_jax(two_steps):
    """The eval step's L1 (running statistics, eval mode) against the JAX
    trainer's eval step on the port's state after the two steps."""
    np.testing.assert_allclose(two_steps["got_eval"], two_steps["want_eval"],
                               rtol=0, atol=1e-6)


def _trainer_cfg(tmp_path, **env):
    cfg = port_config(_cfg())
    a = cfg.AE
    cfg.Dataset.dev_set_size, cfg.Env.platform = 4, "cpu"
    a.epochs, a.log_per_epochs = 2, 1
    a.ckpt_save_dir, a.tensorboard_save_dir = (str(tmp_path / "ae"),
                                               str(tmp_path / "ae_log"))
    for k, v in env.items():
        setattr(cfg.Env, k, v)
    return cfg


def test_trainer_runs_on_the_cpu_and_feeds_stage2(tmp_path):
    """Two epochs of two steps, each validated, checkpointed (best by
    ``L1_loss_valid``) and drawn into a GIF; stage 2 then trains over that
    directory as its frozen AE, which holds the trained weights, and draws
    its own GIF."""
    cfg = _trainer_cfg(tmp_path)
    seen = []
    state = s1.train(cfg, on_step=lambda kind, i, m: seen.append(
        (kind, float(next(iter(m.values()))))))
    assert state.step == 4
    assert [k for k, _ in seen] == (["train"] * 2 + ["eval"] * 2) * 2
    assert np.isfinite([v for _, v in seen]).all()
    mngr = CheckpointManager(tmp_path / "ae", monitor="L1_loss_valid")
    assert mngr.latest_step() == 4 and mngr.best_step() in (2, 4)
    assert (tmp_path / "ae" / "config.json").exists()
    for epoch in (0, 1):  # GT | reconstruction, 8 frames each
        assert gif_frame_count(tmp_path / "ae_log" / f"epoch_{epoch}.gif") \
            == 8

    cfg2 = port_config(tiny_config())
    p = cfg2.Predictor
    cfg2.Dataset.batch_size, cfg2.Dataset.dev_set_size = 2, 4
    cfg2.Env.platform, cfg2.Env.compute_dtype = "cpu", "float32"
    p.resume_AE_ckpt = str(tmp_path / "ae")
    p.epochs, p.log_per_epochs, p.rand_context = 1, 1, True
    p.min_lo, p.max_lo = 2, 6
    p.ckpt_save_dir, p.tensorboard_save_dir = (str(tmp_path / "pred"),
                                               str(tmp_path / "pred_log"))
    frozen = s2.load_frozen_ae(cfg2, torch.float32, "cpu")
    for key, value in frozen.state_dict().items():
        assert torch.equal(value, state.model.state_dict()[key]), key
    s2.train(cfg2)
    assert CheckpointManager(tmp_path / "pred").latest_step() == 2
    assert gif_frame_count(tmp_path / "pred_log" / "epoch_0.gif") == 8


def test_cli_smoke_and_resume(tmp_path, capsys):
    """``--smoke``: one epoch of the two-batch dev set; then a resumed run
    (``AE.resume_ckpt``) starts from that step, model and optimizer."""
    cfg = _trainer_cfg(tmp_path)
    cfg.Dataset.batch_size = 2
    cfg.save(tmp_path / "cfg.json")
    s1.main(["--config_path", str(tmp_path / "cfg.json"), "--smoke",
             "--override", "Env.platform=cpu"])
    out = capsys.readouterr().out
    assert "AE parameters" in out and "epoch 0: L1_loss_train=" in out
    mngr = CheckpointManager(tmp_path / "ae")
    assert mngr.latest_step() == 2
    saved = mngr.load()
    cfg.AE.resume_ckpt, cfg.AE.epochs = str(tmp_path / "ae"), 1
    state = s1.train(cfg)  # epoch 1 of 1 already done: only the restore
    assert state.step == 2
    for key, value in saved["model"].items():
        assert torch.equal(state.model.state_dict()[key], value), key


def test_warm_start_from_a_weights_archive(tmp_path):
    """An ``.npz`` in ``AE.resume_ckpt``: its AE half, its ``ae_step``, and
    fresh optimizer moments."""
    from npvp_tpu.tools.export_weights import save_weights

    from npvp_tpu.train.stage1_ae import build_ae as jbuild

    cfg = _trainer_cfg(tmp_path)
    variables = random_variables(jbuild(_cfg(), jnp.float32).init,
                                 jax.random.key(0),
                                 np.zeros((1, 2, 32, 32, 1)), seed=41)
    save_weights(tmp_path / "w.npz", variables, {}, {"ae_step": 6})
    state = s1.init_state(cfg, build_ae(cfg))
    restore_state(state, str(tmp_path / "w.npz"), "ae")
    assert state.step == 6 and not state.optimizer.state
    from npvp_tpu_torch.tools.weights import load_weights

    want = load_flax(build_ae(cfg), load_weights(tmp_path / "w.npz")[0])
    for key, value in want.state_dict().items():
        assert torch.equal(state.model.state_dict()[key], value), key


def test_det_to_sto_warm_start_from_a_weights_archive(tmp_path):
    """``Predictor.init_det_ckpt_for_vae`` naming an NPVP-D ``.npz``: the
    NPVP-S predictor takes every parameter it shares with the archive
    (atol 0); its prior, its posterior's log-variance head and every
    running statistic keep their init."""
    from npvp_tpu.models.predictor import build_predictor as jbuild
    from npvp_tpu.tools.export_weights import save_weights

    jcfg = tiny_config(stochastic=False)
    p = jcfg.Predictor
    pred = jbuild(jcfg, jnp.float32)
    feats = np.zeros((1, 2, p.max_H, p.max_W, p.embed_dim))
    oc = np.zeros((2 * p.max_H * p.max_W, 3))
    init = functools.partial(pred.init, num_target=2)
    det_vars = random_variables(init, {"params": jax.random.key(0)}, feats,
                                oc, oc, seed=42)
    save_weights(tmp_path / "d.npz", {}, det_vars)

    cfg = port_config(tiny_config(stochastic=True))
    cfg.Env.platform, cfg.Env.compute_dtype = "cpu", "float32"
    cfg.Dataset.batch_size, cfg.Dataset.dev_set_size = 2, 4
    p = cfg.Predictor
    p.epochs = 0  # the initialisation alone
    p.ckpt_save_dir = str(tmp_path / "ckpt")
    p.tensorboard_save_dir = str(tmp_path / "log")
    p.init_det_ckpt_for_vae = str(tmp_path / "d.npz")
    p.resume_AE_ckpt = str(s2.write_random_ae(cfg, tmp_path))
    got = s2.train(cfg).model.state_dict()

    from npvp_tpu_torch.tools.weights import load_weights

    dcfg = port_config(tiny_config(stochastic=False))
    det = load_flax(build_predictor(dcfg),
                    load_weights(tmp_path / "d.npz")[1]).state_dict()
    fresh = random_init(build_predictor(cfg),
                        cfg.Env.rand_seed).state_dict()
    params = dict(build_predictor(cfg).named_parameters())
    shared = [k for k in params if k in det and det[k].shape == got[k].shape]
    assert any(k.startswith("decoder.") for k in shared)
    for key in got:
        want = det[key] if key in shared else fresh[key]
        assert torch.equal(got[key], want), key
    assert any(k.startswith("evt_prior.") for k in got if k not in shared)
    assert "evt_posterior.logvar_net.weight" not in shared


@pytest.mark.parametrize("trainer", ["stage1", "stage2"])
def test_unhonoured_env_fields_are_named(tmp_path, capsys, trainer):
    """Both trainers honour every ``Env`` field, ``sequence_parallel``
    included (``core.sequence_parallel``), so a config that sets them all
    names none as not honoured, as a config that sets none; in one process
    sequence parallelism stays off (no mesh)."""
    from npvp_tpu_torch.core import sequence_parallel as sp

    env = dict(fsdp=True, steps_per_dispatch=4, debug_nans=True,
               mesh_shape=[["data", 2], ["model", 4]],
               sequence_parallel=True)
    if trainer == "stage1":
        cfg = _trainer_cfg(tmp_path, **env)
        cfg.AE.epochs = 0
        run = s1.train
    else:
        cfg = port_config(tiny_config())
        cfg.Env.platform, cfg.Dataset.batch_size = "cpu", 2
        for k, v in env.items():
            setattr(cfg.Env, k, v)
        p = cfg.Predictor
        p.epochs, p.resume_AE_ckpt = 0, str(s2.write_random_ae(cfg,
                                                               tmp_path))
        p.ckpt_save_dir = str(tmp_path / "ckpt")
        p.tensorboard_save_dir = str(tmp_path / "log")
        run = s2.train
    run(cfg)
    out = capsys.readouterr().out
    assert "not honoured" not in out
    assert sp._SP_MESH is None
    if trainer == "stage2":
        assert "sequence_parallel=False" in out
    defaults = type(cfg.Env)()
    for k in env:
        setattr(cfg.Env, k, getattr(defaults, k))
    run(cfg)
    assert "not honoured" not in capsys.readouterr().out
