"""The port's frame-folder data layer (npvp_tpu_torch/data/datasets.py,
transforms.py, loader.py) against the JAX package's, on seeded trees in the
datasets' on-disk layouts written by the port's PNG writer (the JAX side
reads them with PIL and resizes with cv2):

- ``load_frame``, each clip builder's path lists, each transform with the
  same generator (resize atol 1e-6, flips and crops bit-equal),
  ``build_transforms`` for all six names (train and test, 1e-6) and
  ``mean_std_compute``;
- ``DataModule`` for KTH, BAIR, Cityscapes, KITTI and MovingMNIST in
  ``pairs``, ``vfi`` and ``rand_context`` modes over two epochs, with
  ``deploy`` and ``dev_set_size``: batches atol 1e-6, and equal for 1 and 4
  worker threads; producer failures reach the consumer;
- the slice: the first KTH batches of both modules through one train step
  of both trainers (losses rtol 1e-5, parameters atol 1e-5), the AE at the
  Cityscapes geometry against flax, and both trainers on tiny trees on the
  CPU, with ``Env.profile_dir`` and ``Env.debug_nans``.
"""

import pytest

torch = pytest.importorskip("torch")
# small tensors: one thread per test worker, not one per core
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from _torch_helpers import port_config, random_variables, tiny_config  # noqa: E402

from npvp_tpu.data import datasets as JD  # noqa: E402
from npvp_tpu.data import loader as JL  # noqa: E402
from npvp_tpu.data import transforms as JT  # noqa: E402
from npvp_tpu_torch.data import datasets as TD  # noqa: E402
from npvp_tpu_torch.data import loader as TL  # noqa: E402
from npvp_tpu_torch.data import synthetic  # noqa: E402
from npvp_tpu_torch.data import transforms as TT  # noqa: E402

NAMES = ["KTH", "KITTI", "BAIR", "Cityscapes", "SMMNIST", "MovingMNIST"]


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    """One small tree of each dataset."""
    root = tmp_path_factory.mktemp("trees")
    synthetic.kth_tree(root / "kth", persons=(1, 2, 5, 17),
                       actions=("boxing", "walking_no_empty"), frames=19,
                       seed=1)
    # an .avi entry beside the frame folders is skipped
    (root / "kth" / "boxing" / "person03_boxing_d1.avi").mkdir()
    synthetic.bair_tree(root / "bair", {"train": 20, "test": 2}, frames=9,
                        seed=2, size=16)
    synthetic.cityscapes_tree(root / "cityscapes", {"train": 2, "val": 1,
                                                    "test": 1},
                              frames=7, seed=3, size=16)
    synthetic.kitti_tree(root / "kitti", drives=15, frames=7, seed=4,
                         size=(12, 30))
    synthetic.moving_mnist_npz(root / "mmnist", frames=6, clips=5, seed=5,
                               size=16)
    return root


def test_load_frame_equals_jax(trees):
    path = sorted((trees / "kth" / "boxing").glob("*/*.png"))[3]
    for mode in ("grey_scale", "RGB"):
        got, want = TD.load_frame(path, mode), JD.load_frame(path, mode)
        assert got.dtype == np.float32 and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
    clip = TD.ClipDataset([sorted(path.parent.glob("*.png"))[:4]], None,
                          "RGB")[0]
    np.testing.assert_array_equal(clip, np.stack([JD.load_frame(p, "RGB") for
                                                  p in sorted(path.parent.glob(
                                                      "*.png"))[:4]]))


def test_clip_builders_equal_jax(trees):
    kth = trees / "kth"
    for persons in ([1, 2], [5], [17, 3]):
        for length in (8, 5):
            assert TD.kth_clips(kth, length, persons) == JD.kth_clips(
                kth, length, persons)
    assert len(TD.kth_clips(kth, 8, [1, 2])) == 2 * 2 * 2
    files = sorted((kth / "boxing" / "person01_boxing_d1").glob("*"))
    for centre in (True, False):
        assert TD.chunk_into_clips(files, 6, centre) == \
            JD.chunk_into_clips(files, 6, centre)
    for stride in (None, 2):
        assert TD.folder_clips(trees / "bair" / "train", 4, stride) == \
            JD.folder_clips(trees / "bair" / "train", 4, stride)
    for length in (3, 7):
        got = TD.cityscapes_clips(trees / "cityscapes" / "train", length)
        assert got == JD.cityscapes_clips(trees / "cityscapes" / "train",
                                          length)
        assert all(len({f.stem.split("_")[1] for f in c}) == 1 for c in got)
    for train in (True, False):
        assert TD.kitti_clips(trees / "kitti", 3, train=train) == \
            JD.kitti_clips(trees / "kitti", 3, train=train)
    assert len(TD.kitti_clips(trees / "kitti", 7, train=False)) == 4


@pytest.mark.parametrize("src,dst", [((120, 120), (64, 64)),
                                     ((375, 1242), (128, 128)),
                                     ((16, 24), (40, 40))])
def test_resize_equals_jax(src, dst):
    clip = np.random.default_rng(0).random((2, *src, 3), np.float32)
    got = TT.Resize(dst)(clip)
    assert got.shape == (2, *dst, 3) and got.dtype == np.float32
    np.testing.assert_allclose(got, JT.Resize(dst)(clip), atol=1e-6, rtol=0)
    np.testing.assert_array_equal(TT.Resize(src)(clip), clip)


def test_flips_crops_and_pad_equal_jax():
    clip = np.random.default_rng(1).random((3, 10, 14, 3), np.float32)
    for seed in range(6):
        for flip in ("RandomHorizontalFlip", "RandomVerticalFlip"):
            g, w = (np.random.default_rng(seed) for _ in range(2))
            got = getattr(TT, flip)(0.5)(clip, g)
            np.testing.assert_array_equal(got, getattr(JT, flip)(0.5)(clip,
                                                                      w))
            assert g.random() == w.random()  # the same draws were made
    for t, j in ((TT.CenterCrop((6, 9)), JT.CenterCrop((6, 9))),
                 (TT.Crop(2, 3, (5, 7)), JT.Crop(2, 3, (5, 7))),
                 (TT.Pad(2, 1), JT.Pad(2, 1))):
        np.testing.assert_array_equal(t(clip), j(clip))


@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("name", NAMES + ["CityScapes"])
def test_build_transforms_equal_jax(name, train):
    channels = 1 if name in ("KTH", "SMMNIST", "MovingMNIST") else 3
    size = {"KTH": (120, 160), "KITTI": (37, 124)}.get(name, (16, 16))
    clip = np.random.default_rng(2).random((4, *size, channels), np.float32)
    tf, renorm = TT.build_transforms(name, train)
    jtf, jrenorm = JT.build_transforms(name, train)
    for seed in range(3):
        got = tf(clip, np.random.default_rng(seed))
        want = jtf(clip, np.random.default_rng(seed))
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
        np.testing.assert_allclose(renorm(got), jrenorm(want), atol=1e-6,
                                   rtol=0)


def test_mean_std_compute_equals_jax():
    rng = np.random.default_rng(3)
    clips = [rng.normal(0.4, 0.3, (3, 5, 5, 3)).astype(np.float32)
             for _ in range(6)]
    for got, want in zip(TT.mean_std_compute(iter(clips), 3),
                         JT.mean_std_compute(iter(clips), 3)):
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


# name, mode, subdir, channels, (past, future, test past, test future),
# phase, dev_set_size, batch
MODULES = {
    "KTH": ("rand_context", "kth", 1, (4, 4, 3, 5), "deploy", None, 2),
    "BAIR": ("pairs", "bair", 3, (2, 2, 2, 2), "debug", 3, 2),
    "Cityscapes": ("vfi", "cityscapes", 3, (2, 3, 2, 5), "deploy", 5, 2),
    "KITTI": ("pairs", "kitti", 3, (1, 2, 2, 1), "debug", None, 2),
    "MovingMNIST": ("pairs", "mmnist", 1, (2, 3, 2, 3), "deploy", None, 2),
}


def _module_config(name, trees, workers):
    mode, sub, channels, (p, f, tp, tf), phase, dev, batch = MODULES[name]
    cfg = tiny_config()
    d, pr = cfg.Dataset, cfg.Predictor
    d.name, d.dir, d.img_channels = name, str(trees / sub), channels
    d.num_past_frames, d.num_future_frames = p, f
    d.test_num_past_frames, d.test_num_future_frames = tp, tf
    d.phase, d.dev_set_size, d.batch_size = phase, dev, batch
    d.num_workers = workers
    pr.max_T, pr.min_lo, pr.max_lo = p + f, 1, p + f - 1
    pr.rand_context = mode == "rand_context"
    pr.VFI = mode == "vfi"
    pr.context_num_p, pr.context_num_f, pr.num_interpolate = 1, 1, p + f - 2
    return cfg.validate(), mode


def _batches(dm, split, mode, epoch):
    loader = getattr(dm, f"{split}_loader")(mode)
    loader.set_epoch(epoch)
    return list(loader)


@pytest.mark.parametrize("name", list(MODULES))
def test_data_module_equals_jax(name, trees, monkeypatch):
    # every batch of the 4-worker module on worker processes, however cheap
    monkeypatch.setattr(TL, "POOL_MIN_FETCH_MS", 0.0)
    cfg, mode = _module_config(name, trees, workers=1)
    jdm = JL.DataModule(cfg, 0, 1)
    tdm = TL.DataModule(port_config(cfg))
    four = TL.DataModule(port_config(_module_config(name, trees, 4)[0]))
    assert tdm.predictor_mode() == jdm.predictor_mode() == mode
    for split, epochs in (("train", (0, 1)), ("val", (0,)), ("test", (0,))):
        for epoch in epochs:
            want = _batches(jdm, split, mode if split != "test" else "pairs",
                            epoch)
            got = _batches(tdm, split, mode if split != "test" else "pairs",
                           epoch)
            again = _batches(four, split, mode if split != "test"
                             else "pairs", epoch)
            assert len(got) == len(want) == len(again) > 0, (split, epoch)
            for g, a, w in zip(got, again, want):
                assert sorted(g) == sorted(w)
                for key in w:
                    np.testing.assert_allclose(g[key], w[key], atol=1e-6,
                                               rtol=0, err_msg=key)
                    np.testing.assert_array_equal(a[key], g[key])
    assert tdm.len_train_loader == jdm.len_train_loader
    assert len(tdm.dataset("train")) == len(jdm.dataset("train"))


@pytest.mark.parametrize("workers", [1, 3])
def test_producer_failure_reaches_the_consumer(workers, monkeypatch):
    """A failing sample, fetched in the producer thread (1 worker) or in a
    worker process (3), fails the epoch after the batches before it."""
    from _torch_helpers import RaisingDataset

    monkeypatch.setattr(TL, "POOL_MIN_FETCH_MS", 0.0)

    loader = TL.BatchLoader(RaisingDataset(), 2, shuffle=False, num_past=2,
                            num_future=2, num_workers=workers)
    it = iter(loader)
    assert [float(next(it)["past"][0, 0, 0, 0, 0]) for _ in range(2)] == [
        0.0, 2.0]
    with pytest.raises(RuntimeError, match="data producer failed at epoch "
                       "0") as err:
        list(it)
    assert isinstance(err.value.__cause__, ValueError)
    # a consumer that stops early releases the producer
    first = next(iter(TL.BatchLoader(RaisingDataset(), 2, shuffle=True,
                                     num_past=2,
                                     num_future=2, num_workers=workers,
                                     seed=3)))
    assert first["past"].shape == (2, 2, 2, 2, 1)


def test_worker_pool_only_for_slow_fetches():
    """The first batch, fetched in the producer thread, decides: a cheap
    dataset stays there; one whose batch takes POOL_MIN_FETCH_MS or more
    moves to worker processes, with the same batches."""
    from _torch_helpers import SleepyDataset

    kw = dict(shuffle=True, num_past=2, num_future=2, num_workers=2, seed=5)
    fast = TL.BatchLoader(SleepyDataset(0.0), 2, **kw)
    want = list(fast)
    assert fast._pool is None and len(want) == 8
    slow = TL.BatchLoader(SleepyDataset(TL.POOL_MIN_FETCH_MS / 1e3), 2, **kw)
    got = list(slow)
    assert slow._pool is not None
    slow.set_epoch(1)
    assert len(list(slow)) == 8  # the pool serves the next epoch
    slow.close()
    assert slow._pool is None
    for g, w in zip(got, want, strict=True):
        np.testing.assert_array_equal(g["past"], w["past"])


def test_slice_kth_batches_through_one_train_step(trees):
    """The first two KTH rand-context batches of both data modules agree;
    the first goes through the JAX trainer's and the port's train step from
    one set of variables (NPVP-D, one layer, 64×64 frames): losses rtol
    1e-5, parameters atol 1e-5 plus Adam's amplification of a 1e-10
    gradient difference (float32 rounding on sums of this size). Adam's
    first update is lr·g/(|g| + eps), eps = 1e-8, with slope
    lr·eps/(|g| + eps)² in g: near |g| = 0 the slope reaches lr/eps, so
    an element with |g| = 3e-9 (one here) moves ~1e-5 on a rounding-level
    gradient difference. Elsewhere the added term is far below 1e-5."""
    from test_torch_train import _cfg, _jax_model, _jax_steps, _port_model

    from npvp_tpu_torch.models.predictor import build_predictor
    from npvp_tpu_torch.nn.layers import Rng
    from npvp_tpu_torch.tools.weights import load_flax
    from npvp_tpu_torch.train import stage2_predictor as s2

    cfg = _cfg("rand_context", layers=1)
    d, p = cfg.Dataset, cfg.Predictor
    d.name, d.dir, d.img_size, d.num_workers = "KTH", str(trees / "kth"), 64, 1
    p.max_H = p.max_W = 8
    cfg.validate()
    want_batches = list(JL.DataModule(cfg, 0, 1).train_loader(
        "rand_context"))[:2]
    got_batches = list(TL.DataModule(port_config(cfg)).train_loader(
        "rand_context"))[:2]
    assert len(got_batches) == 2
    for g, w in zip(got_batches, want_batches):
        assert g["clip"].shape == (2, 8, 64, 64, 1)
        for key in w:
            np.testing.assert_allclose(g[key], w[key], atol=1e-6, rtol=0)

    ae, ae_vars, pred, pred_vars = _jax_model(cfg, seed=30)
    want, want_vars = _jax_steps(cfg, "rand_context", ae, ae_vars, pred,
                                 pred_vars, batches=want_batches[:1])
    tcfg, tae, tpred = _port_model(cfg, ae_vars, pred_vars)
    state = s2.init_predictor_state(tcfg, tpred, 3)
    load_flax(tpred, pred_vars)
    grads = {}
    apply = state.apply_gradients

    def keep_gradients():
        grads.update({n: q.grad.clone() for n, q in tpred.named_parameters()
                      if q.grad is not None})
        return apply()

    state.apply_gradients = keep_gradients
    steps = s2.make_steps(tcfg, tae, "rand_context", "cpu")
    got = steps.train(state, steps.place(got_batches[0]), Rng(0))
    for key in want[0]:
        np.testing.assert_allclose(float(got[key]), want[0][key], rtol=1e-5,
                                   err_msg=key)
    ref = load_flax(build_predictor(tcfg), want_vars).state_dict()
    lr, eps = p.predictor_lr, 1e-8
    for key, value in state.model.state_dict().items():
        diff = np.abs(value.numpy() - ref[key].numpy())
        if key.endswith(("running_mean", "running_var")):
            assert diff.max() <= 1e-6, key
            continue
        g = grads[key].abs().numpy() if key in grads else np.zeros(
            diff.shape)
        tol = 1e-5 + lr * eps * 1e-10 / (g + eps) ** 2
        assert (diff <= tol).all(), (key, diff.max())


def test_ae_at_the_cityscapes_geometry_matches_flax():
    """ngf 8, 4 downsamplings, 3 residual blocks, 3 channels, 128²: encode
    and decode against flax (atol 1e-4)."""
    from npvp_tpu.train.stage1_ae import build_ae as jbuild_ae
    from npvp_tpu_torch.nn.resnet_ae import build_ae
    from npvp_tpu_torch.tools.weights import load_flax

    cfg = tiny_config()
    d, a = cfg.Dataset, cfg.AE
    d.img_size, d.img_channels = 128, 3
    a.ngf, a.n_downsampling, a.num_res_blocks = 8, 4, 3
    ae = jbuild_ae(cfg, jnp.float32)
    frames = np.tanh(np.random.default_rng(4).standard_normal(
        (1, 2, 128, 128, 3))).astype(np.float32)
    variables = random_variables(ae.init, jax.random.key(0), frames, seed=5)
    feats, rec = jax.jit(lambda v, x: ae.apply(v, x))(variables, frames)[::-1]
    port = load_flax(build_ae(port_config(cfg)), variables).eval()
    with torch.no_grad():
        got_feats = port.encode(torch.from_numpy(frames))
        got_rec = port.decode(torch.from_numpy(np.array(feats)))
    assert got_feats.shape == (1, 2, 8, 8, 128)
    assert got_rec.shape == (1, 2, 128, 128, 3)
    for got, want in ((got_feats, feats), (got_rec, rec)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                                   rtol=1e-4)


def _tiny_cityscapes(trees, tmp_path):
    cfg = tiny_config()
    d, a, p = cfg.Dataset, cfg.AE, cfg.Predictor
    d.name, d.dir, d.img_size, d.img_channels = ("CityScapes",
                                                 str(trees / "cityscapes"),
                                                 16, 3)
    d.num_past_frames, d.num_future_frames = 2, 2
    d.test_num_past_frames, d.test_num_future_frames = 2, 5
    d.batch_size, d.num_workers, d.phase = 2, 2, "debug"
    a.ngf, a.n_downsampling = 4, 2
    a.ckpt_save_dir = str(tmp_path / "ae")
    a.tensorboard_save_dir = str(tmp_path / "ae_log")
    a.epochs = 1
    p.max_T, p.embed_dim, p.max_H, p.max_W = 4, 16, 4, 4
    p.num_heads, p.stochastic, p.exec_mode = 4, True, "pallas"
    p.resume_AE_ckpt = str(tmp_path / "ae")
    p.ckpt_save_dir = str(tmp_path / "pred")
    p.tensorboard_save_dir = str(tmp_path / "pred_log")
    p.epochs, p.min_lo, p.max_lo = 1, 1, 3
    cfg.Env.platform, cfg.Env.visual_callback = "cpu", False
    return port_config(cfg)


def test_trainers_and_evaluate_on_tiny_trees(trees, tmp_path):
    """Stage 1 on a Cityscapes tree (RGB, the ``CityScapes`` alias), stage 2
    (VFP NPVP-S) over its checkpoint, then ``evaluate`` VFP 2 → 5 past
    max_T 4 (windowed), on the CPU; every step logs its wait for data."""
    from npvp_tpu_torch.core.checkpoint import CheckpointManager
    from npvp_tpu_torch.eval.evaluate import evaluate
    from npvp_tpu_torch.train import stage1_ae as s1
    from npvp_tpu_torch.train import stage2_predictor as s2

    cfg = _tiny_cityscapes(trees, tmp_path)
    seen = []
    s1.train(cfg, on_step=lambda kind, i, m: seen.append((kind, m)))
    train_metrics = [m for kind, m in seen if kind == "train"]
    assert len(train_metrics) == 2  # 2 cities × 2 sequences, batch 2
    assert all(m["data_wait_ms"] >= 0 and np.isfinite(float(
        m["L1_loss_train"])) for m in train_metrics)
    assert CheckpointManager(tmp_path / "ae").latest_step() == 2
    state = s2.train(cfg)
    assert state.step == 2
    res = evaluate(cfg, device="cpu", max_batches=1)
    assert len(res["PSNR_per_t"]) == 5 and np.isfinite(res["PSNR"])


def test_profile_dir_writes_a_trace(trees, tmp_path):
    from npvp_tpu_torch.train import stage1_ae as s1
    from npvp_tpu_torch.train.common import StepProfiler

    cfg = _tiny_cityscapes(trees, tmp_path)
    cfg.Env.profile_dir = str(tmp_path / "trace")
    s1.train(cfg)  # two steps: the window 10-14 never opens
    assert not (tmp_path / "trace").exists()
    window = StepProfiler(str(tmp_path / "trace"), start_step=1,
                          num_steps=2)
    calls = [window.maybe_start_profiler(step) for step in range(4)]
    assert calls == [None, "started", None, "stopped"]
    traces = list((tmp_path / "trace").glob("trace_steps_1-2.json"))
    assert len(traces) == 1 and traces[0].stat().st_size > 0
    window.maybe_start_profiler(1)
    assert window.stop_profiler().name == "trace_steps_1-1.json"
    cfg.AE.epochs, cfg.Dataset.dev_set_size = 12, 2
    s1.train(cfg)  # steps 0-11: teardown closes the window opened at 10
    assert (tmp_path / "trace" / "trace_steps_10-11.json").stat().st_size


def test_debug_nans_raises_on_a_nan_loss(trees, tmp_path):
    from npvp_tpu_torch.train import stage1_ae as s1
    from npvp_tpu_torch.train import stage2_predictor as s2

    cfg = _tiny_cityscapes(trees, tmp_path)
    cfg.Env.debug_nans = True
    cfg.AE.AE_lr = float("inf")  # the first update leaves no weight finite
    with pytest.raises(FloatingPointError, match="train step 1: "
                       "L1_loss_train"):
        s1.train(cfg)
    assert torch.is_anomaly_enabled()
    cfg.AE.AE_lr, cfg.AE.epochs = 1e-4, 1
    s1.train(cfg)
    cfg.Predictor.predictor_lr = float("inf")
    with pytest.raises(FloatingPointError, match="train step 1: loss"):
        s2.train(cfg)
    cfg.Env.debug_nans = False
    cfg.Predictor.epochs = 0
    s2.train(cfg)
    assert not torch.is_anomaly_enabled()
