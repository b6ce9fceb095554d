"""The port's spans (``npvp_tpu_torch.core.tracing``) on the CPU, at the tiny
size of the port's other tests:

- off by default, and while off a span enters no ``record_function`` and
  records nothing;
- within one ``predict`` (and one frozen task's call) the spans nest, name
  their parents and share the request's root; a train step's phases and a
  placed batch give the spans of the table in ``core/tracing.py``'s users;
- the loader's producer thread records its ``npvp.loader.produce`` spans;
- outputs and losses are bit-identical with tracing on and off;
- a span's start lines up with its ``record_function`` event's start under
  a ``torch.profiler`` (the profiler's clock);
- ``take()`` clears, and the cap keeps the newest records.
"""

import collections
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from npvp_tpu_torch.core import tracing  # noqa: E402
from npvp_tpu_torch.core.config import Config  # noqa: E402
from npvp_tpu_torch.core.optim import (is_decoder_param,  # noqa: E402
                                       make_predictor_optimizer,
                                       predictor_schedule)
from npvp_tpu_torch.core.train_state import TrainState  # noqa: E402
from npvp_tpu_torch.data.loader import BatchLoader  # noqa: E402
from npvp_tpu_torch.models.inference import VideoPredictor  # noqa: E402
from npvp_tpu_torch.models.predictor import build_predictor  # noqa: E402
from npvp_tpu_torch.nn.layers import Rng  # noqa: E402
from npvp_tpu_torch.nn.resnet_ae import build_ae  # noqa: E402
from npvp_tpu_torch.tools.weights import random_init  # noqa: E402
from npvp_tpu_torch.train.common import StepProfiler  # noqa: E402
from npvp_tpu_torch.train.stage2_predictor import make_steps  # noqa: E402

T = 8
# the encoder's non-local attentions: one a ConvAttn block of the tiny AE
# (n_downsampling − 1 + num_res_blocks), each inside its npvp.ae.encode
NONLOCAL, NONLOCAL_CALLS = "npvp.ae.nonlocal", 3
# the decoder's tail, one inside each npvp.ae.decode
HEAD = "npvp.ae.head"
SERVE = {"npvp.serve.request", "npvp.ae.encode", "npvp.predictor",
         "npvp.predictor.nrmlp", "npvp.predictor.encoder",
         "npvp.predictor.latent", "npvp.predictor.decoder", "npvp.ae.decode",
         NONLOCAL, HEAD}
PREDICTOR_PARTS = {"npvp.predictor.nrmlp", "npvp.predictor.encoder",
                   "npvp.predictor.latent", "npvp.predictor.decoder"}
TRAIN = {"npvp.train.step", "npvp.train.forward", "npvp.train.backward",
         "npvp.train.optimizer", "npvp.train.clip", "npvp.ae.encode",
         "npvp.predictor", "npvp.ae.decode", NONLOCAL,
         HEAD} | PREDICTOR_PARTS


def _counts_as_expected(by):
    """One span a name, and one a non-local attention of the encoder."""
    return all(len(v) == (NONLOCAL_CALLS if k == NONLOCAL else 1)
               for k, v in by.items())


def tiny_config(stochastic=True):
    """The tiny test model (``tests/_torch_helpers.tiny_config``) in the
    port's own schema, float32, for training on the CPU."""
    cfg = Config()
    d, a, p = cfg.Dataset, cfg.AE, cfg.Predictor
    d.img_size, d.img_channels = 32, 1
    d.num_past_frames = d.num_future_frames = 4
    d.batch_size, cfg.Env.compute_dtype = 2, "float32"
    a.ngf, a.n_downsampling, a.num_res_blocks = 4, 3, 1
    p.embed_dim, p.num_heads, p.window_size = 32, 4, 2
    p.transformer_layers = p.evt_former_num_layers = 2
    p.dim_feedforward, p.evt_hidden_channels = 64, 16
    p.Spatial_FFN_hidden_ratio = 2
    p.max_T, p.max_H, p.max_W = T, 4, 4
    p.stochastic, p.exec_mode = stochastic, "xla"
    p.dropout = p.drop_path = 0.1
    p.rand_context, p.min_lo, p.max_lo = True, 2, 6
    p.predictor_lr, p.max_grad_norm, p.scheduler_T0 = 1e-3, 0.05, 1
    return cfg.validate()


@pytest.fixture(autouse=True)
def tracing_off():
    """Every test starts and ends with tracing off and nothing kept."""
    tracing.disable()
    tracing.take()
    yield
    tracing.disable()
    tracing.take()


@pytest.fixture(scope="module")
def vp():
    return VideoPredictor.from_random_init(tiny_config(), dtype=torch.float32,
                                           seed=3, device="cpu")


def _request(seed=0):
    g = torch.Generator().manual_seed(seed)
    frames = torch.rand((1, 4, 32, 32, 1), generator=g)
    eps = torch.randn((1, 4, 4, 32), generator=g)
    return frames, eps


def _by_name(records):
    out = collections.defaultdict(list)
    for r in records:
        out[r.name].append(r)
    return out


def _annotations(prof):
    return [e for e in prof.profiler.kineto_results.events()
            if e.name().startswith(tracing.PREFIX)]


def test_off_by_default_enters_no_record_function_and_keeps_nothing(vp):
    from torch.profiler import ProfilerActivity, profile

    assert not tracing.enabled()
    assert tracing.span("npvp.x") is tracing.span("npvp.y")
    frames, eps = _request()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        vp.predict(frames, [0, 1, 2, 3], [4, 5, 6], eps=eps)
    assert _annotations(prof) == []
    assert tracing.take() == []


def test_a_span_off_passes_exceptions_through():
    with pytest.raises(KeyError):
        with tracing.span("npvp.x"):
            raise KeyError("x")


def test_names_start_with_the_prefix():
    tracing.enable()
    with pytest.raises(ValueError):
        tracing.span("predictor")


def _check_tree(records, root_name):
    """One root named ``root_name``; every other span inside its parent's
    interval, on the root's thread, with the root's id as its root."""
    ids = {r.id: r for r in records}
    (root,) = [r for r in records if r.parent is None]
    assert root.name == root_name and root.root == root.id
    for r in records:
        assert r.root == root.id and r.thread == root.thread
        assert r.start_ns <= r.end_ns and 0 <= r.thread_cpu_ns
        if r.parent is not None:
            p = ids[r.parent]
            assert p.start_ns <= r.start_ns and r.end_ns <= p.end_ns
    return root


@pytest.mark.parametrize("entry", ["predict", "freeze_task"])
def test_the_spans_of_one_request_nest_and_share_its_root(vp, entry):
    frames, eps = _request()
    fn = (vp.freeze_task([0, 1, 2, 3], [4, 5, 6]) if entry == "freeze_task"
          else None)
    tracing.enable()
    if fn is None:
        vp.predict(frames, [0, 1, 2, 3], [4, 5, 6], eps=eps)
    else:
        fn(frames, eps=eps)
    tracing.disable()
    records = tracing.take()
    by = _by_name(records)
    assert set(by) == SERVE and _counts_as_expected(by)
    root = _check_tree(records, "npvp.serve.request")
    parent = {r.name: r.parent for r in records}
    pred = by["npvp.predictor"][0].id
    for name in ("npvp.ae.encode", "npvp.predictor", "npvp.ae.decode"):
        assert parent[name] == root.id
    for name in PREDICTOR_PARTS:
        assert parent[name] == pred
    assert {r.parent for r in by[NONLOCAL]} == {by["npvp.ae.encode"][0].id}
    assert parent[HEAD] == by["npvp.ae.decode"][0].id


def _train_program(seed=5):
    cfg = tiny_config()
    ae = random_init(build_ae(cfg, torch.float32), seed).eval()
    ae.requires_grad_(False)
    pred = random_init(build_predictor(cfg, torch.float32), seed + 1)
    p = cfg.Predictor
    state = TrainState(pred, make_predictor_optimizer(pred.parameters(),
                                                      p.predictor_lr),
                       predictor_schedule(p.predictor_lr, False, 0.0, 1),
                       p.max_grad_norm, is_decoder_param)
    return state, make_steps(cfg, ae, "rand_context", torch.device("cpu"))


def _batch():
    rng = np.random.default_rng(11)
    obs = np.array([1, 0, 1, 1, 0, 0, 1, 0], bool)
    return {"clip": rng.uniform(0, 1, (2, T, 32, 32, 1)).astype(np.float32),
            "obs_mask": obs, "tgt_mask": ~obs}


def test_a_train_step_gives_its_phases():
    state, steps = _train_program()
    tracing.enable()
    placed = steps.place(_batch())
    steps.train(state, placed, Rng(0))
    records = tracing.take()
    by = _by_name(records)
    (place,) = by.pop("npvp.train.place")
    assert place.parent is None and place.root == place.id
    step_records = [r for r in records if r.name != "npvp.train.place"]
    assert set(by) == TRAIN and _counts_as_expected(by)
    root = _check_tree(step_records, "npvp.train.step")
    parent = {r.name: r.parent for r in step_records}
    for name in ("npvp.train.forward", "npvp.train.backward",
                 "npvp.train.optimizer"):
        assert parent[name] == root.id
    assert parent["npvp.train.clip"] == by["npvp.train.optimizer"][0].id
    assert parent["npvp.predictor"] == by["npvp.train.forward"][0].id


def test_outputs_and_losses_are_the_same_with_tracing_on(vp):
    frames, eps = _request(1)
    off = vp.predict(frames, [0, 1, 2, 3], [4, 5.5, 6], eps=eps)
    tracing.enable()
    on = vp.predict(frames, [0, 1, 2, 3], [4, 5.5, 6], eps=eps)
    tracing.disable()
    assert torch.equal(off, on)

    results = []
    for traced in (False, True):
        state, steps = _train_program()
        if traced:
            tracing.enable()
        losses = [float(steps.train(state, steps.place(_batch()),
                                    Rng(k))["loss"]) for k in range(2)]
        tracing.disable()
        results.append((losses, {k: v.detach().clone() for k, v in
                                 state.module.state_dict().items()}))
    (l_off, s_off), (l_on, s_on) = results
    assert l_off == l_on
    assert all(torch.equal(s_off[k], s_on[k]) for k in s_off)


class _Clips:
    """A dataset of random clips (the loader's ``__getitem__(i, rng)``)."""

    def __len__(self):
        return 6

    def __getitem__(self, i, rng):
        return rng.uniform(0, 1, (T, 8, 8, 1)).astype(np.float32)


def test_the_producer_thread_records_its_batches():
    loader = BatchLoader(_Clips(), 2, shuffle=False, num_past=4,
                         num_future=4, mode="rand_context", min_lo=2,
                         max_lo=6, num_workers=1)
    tracing.enable()
    batches = list(loader)
    loader.close()
    by = _by_name(tracing.take())
    main = threading.get_ident()
    assert len(batches) == 3
    assert len(by["npvp.loader.produce"]) == 3
    assert {r.thread for r in by["npvp.loader.produce"]} != {main}
    assert all(r.parent is None for r in by["npvp.loader.produce"])
    # the consumer's waits: one a batch and one for the end of the epoch
    assert len(by["npvp.loader.wait"]) == 4
    assert {r.thread for r in by["npvp.loader.wait"]} == {main}


def test_a_span_starts_on_the_profilers_clock(vp):
    from torch.profiler import ProfilerActivity, profile

    frames, eps = _request()
    tracing.enable()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(2):
            vp.predict(frames, [0, 1, 2, 3], [4, 5, 6], eps=eps)
    records = sorted(tracing.take(), key=lambda r: r.start_ns)
    events = sorted(_annotations(prof), key=lambda e: e.start_ns())
    assert [r.name for r in records] == [e.name() for e in events]
    gaps = [abs(r.start_ns - e.start_ns()) for r, e in zip(records, events)]
    per_request = len(SERVE) - 1 + NONLOCAL_CALLS
    assert len(gaps) == 2 * per_request and max(gaps) < 1e6, gaps


def test_the_step_profilers_window_traces_the_spans(tmp_path):
    import json

    state, steps = _train_program()
    window = StepProfiler(str(tmp_path), start_step=0, num_steps=1)
    assert window.maybe_start_profiler(0) == "started"
    assert tracing.enabled()
    steps.train(state, steps.place(_batch()), Rng(0))
    path = window.stop_profiler()
    assert not tracing.enabled() and tracing.take() == []
    names = {e.get("name") for e in json.loads(path.read_text())[
        "traceEvents"]}
    assert TRAIN | {"npvp.train.place"} <= names


def test_a_window_leaves_tracing_on_where_it_found_it(tmp_path):
    tracing.enable()
    window = StepProfiler(str(tmp_path), start_step=0, num_steps=1)
    window.maybe_start_profiler(0)
    with tracing.span("npvp.kept"):
        pass
    window.stop_profiler()
    assert tracing.enabled()
    assert [r.name for r in tracing.take()] == ["npvp.kept"]


def test_take_clears_and_the_cap_keeps_the_newest(monkeypatch):
    monkeypatch.setattr(tracing, "_records", collections.deque(maxlen=5))
    tracing.enable()
    for i in range(8):
        with tracing.span(f"npvp.{i}"):
            pass
    assert [r.name for r in tracing.take()] == [f"npvp.{i}"
                                                for i in range(3, 8)]
    assert tracing.take() == []
