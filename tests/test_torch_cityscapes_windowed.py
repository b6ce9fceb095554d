"""Cityscapes-shaped serving beyond the predictor's horizon, on the CPU at a
tiny size: ``VideoPredictor.vfp`` past ``max_T`` rolls the prediction
forward through ``vfp_windowed`` (each window encode → predictor →
decode, its decoded frames the next window's context), and in float32 it
gives the frames of the benchmark's plain reference rollout
(``npvp_bench/reference/windowed.py``) on the same seeded weights, with a
4-downsampling AE on 3-channel frames. Its spans (one request, one
``npvp.serve.window`` a window, one ``npvp.ae.nonlocal`` a non-local
attention) and the window counter; with tracing off the spans keep
nothing and the frames are the same."""

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from npvp_bench import weights as W  # noqa: E402
from npvp_bench.reference import model as R  # noqa: E402
from npvp_bench.reference.windowed import rollout  # noqa: E402
from npvp_tpu_torch.core import tracing  # noqa: E402
from npvp_tpu_torch.core.config import Config  # noqa: E402
from npvp_tpu_torch.models import inference  # noqa: E402
from npvp_tpu_torch.models.inference import VideoPredictor  # noqa: E402
from npvp_tpu_torch.models.predictor import build_predictor  # noqa: E402
from npvp_tpu_torch.nn.resnet_ae import build_ae  # noqa: E402

P, FUTURE, MAX_T = 2, 8, 5           # windows of 3: 3, 3 and a truncated 2
WINDOWS = 3
N_DOWN, N_RES, SIZE, HW = 4, 3, 64, 4
NONLOCAL_A_WINDOW = N_DOWN - 1 + N_RES  # the encoder's ConvAttn blocks
# float32 on both sides, the same equations in another order (the port's
# fused q/k/v and hoisted projections, the reference's explicit ones):
# sound readings are ~2e-7 after three windows; 2e-5 leaves the room of
# the benchmark's own port-against-reference test, far below any fault
ATOL = 2e-5


def tiny_config(exec_mode="xla"):
    """Cityscapes VFP NPVP-S's shape (3 channels, 4 downsamplings, 3 res
    blocks, P 2) cut to a few channels, a 4×4 latent and ``max_T`` 5."""
    cfg = Config()
    d, a, p = cfg.Dataset, cfg.AE, cfg.Predictor
    d.img_size, d.img_channels = SIZE, 3
    d.num_past_frames, d.num_future_frames = P, MAX_T - P  # training's
    d.test_num_past_frames, d.test_num_future_frames = P, FUTURE
    cfg.Env.compute_dtype = "float32"
    a.ngf, a.n_downsampling, a.num_res_blocks = 4, N_DOWN, N_RES
    p.embed_dim, p.num_heads, p.window_size = 4 * 2 ** N_DOWN, 4, 2
    p.transformer_layers = p.evt_former_num_layers = 2
    p.dim_feedforward, p.evt_hidden_channels = 64, 16
    p.Spatial_FFN_hidden_ratio = 2
    p.max_T, p.max_H, p.max_W = MAX_T, HW, HW
    p.stochastic, p.exec_mode = True, exec_mode
    return cfg.validate()


def _models(exec_mode, seed=7):
    """The port's VideoPredictor and the reference's modules, loaded with
    one set of weights drawn from ``seed``."""
    cfg = tiny_config(exec_mode)
    ae_p = build_ae(cfg, torch.float32)
    pr_p = build_predictor(cfg, torch.float32, exec_mode)
    ae_r, pr_r = R.build(cfg.to_dict())
    for port, ref, tag in ((ae_p, ae_r, "ae"), (pr_p, pr_r, "predictor")):
        w = W.draw(W.state_specs(ref), seed, "cpu", tag)
        port.load_state_dict(w)
        ref.load_state_dict(w)
    return (VideoPredictor(cfg, ae_p, pr_p, device="cpu"),
            ae_r.eval(), pr_r.eval())


def _request(seed=0, n=2):
    g = torch.Generator().manual_seed(seed)
    frames = torch.rand((n, P, SIZE, SIZE, 3), generator=g) * 2 - 1
    eps = [torch.randn((n, HW, HW, 4 * 2 ** N_DOWN), generator=g)
           for _ in range(WINDOWS)]
    return frames, eps


@pytest.fixture(autouse=True)
def tracing_off():
    tracing.disable()
    tracing.take()
    yield
    tracing.disable()
    tracing.take()


@pytest.mark.parametrize("exec_mode", ["xla", "pallas"])
def test_windowed_frames_match_the_plain_reference(exec_mode):
    vp, ae_r, pr_r = _models(exec_mode)
    frames, eps = _request()
    got = vp.vfp(frames, FUTURE, eps=eps)
    with torch.no_grad():
        want = rollout(ae_r, pr_r, frames, FUTURE, eps, MAX_T, HW, HW,
                       block=1)
    assert got.shape == (2, FUTURE, SIZE, SIZE, 3)
    assert want.std() > 0.05
    torch.testing.assert_close(got, want, atol=ATOL, rtol=0)
    # each window's own frames, the truncated last one included
    for lo in range(0, FUTURE, MAX_T - P):
        torch.testing.assert_close(got[:, lo:lo + MAX_T - P],
                                   want[:, lo:lo + MAX_T - P], atol=ATOL,
                                   rtol=0)


def test_each_window_takes_its_own_noise_and_the_last_decoded_frames():
    """A window's noise moves only its own frames and the later windows'
    (through the frames handed on): the rollout does not reuse one
    sample."""
    vp, _, _ = _models("xla")
    frames, eps = _request(1)
    base = vp.vfp(frames, FUTURE, eps=eps)
    moved = vp.vfp(frames, FUTURE, eps=[eps[0], eps[1] + 1.0, eps[2]])
    chunk = MAX_T - P
    assert torch.equal(base[:, :chunk], moved[:, :chunk])
    assert not torch.allclose(base[:, chunk:2 * chunk],
                              moved[:, chunk:2 * chunk])


def test_spans_and_the_window_counter():
    vp, _, _ = _models("xla")
    frames, eps = _request()
    before = inference.WINDOWS["run"]
    tracing.enable()
    vp.vfp(frames, FUTURE, eps=eps)
    tracing.disable()
    assert inference.WINDOWS["run"] - before == WINDOWS
    records = tracing.take()
    by = {}
    for r in records:
        by.setdefault(r.name, []).append(r)
    (request,) = by["npvp.serve.request"]
    assert request.parent is None
    windows = by["npvp.serve.window"]
    assert len(windows) == WINDOWS
    assert all(w.parent == request.id for w in windows)
    assert [w.start_ns for w in windows] == sorted(w.start_ns
                                                   for w in windows)
    for name in ("npvp.ae.encode", "npvp.predictor", "npvp.ae.decode"):
        assert sorted(r.parent for r in by[name]) == sorted(
            w.id for w in windows), name
    encodes = {r.id for r in by["npvp.ae.encode"]}
    nonlocal_ = by["npvp.ae.nonlocal"]
    assert len(nonlocal_) == WINDOWS * NONLOCAL_A_WINDOW
    assert {r.parent for r in nonlocal_} == encodes


def test_spans_off_keep_nothing_and_leave_the_frames_alone():
    from torch.profiler import ProfilerActivity, profile

    vp, _, _ = _models("xla")
    frames, eps = _request(2)
    assert not tracing.enabled()
    for name in ("npvp.serve.window", "npvp.ae.nonlocal"):
        assert tracing.span(name) is tracing.span("npvp.serve.request")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        off = vp.vfp(frames, FUTURE, eps=eps)
    assert not [e for e in prof.profiler.kineto_results.events()
                if e.name().startswith(tracing.PREFIX)]
    assert tracing.take() == []
    tracing.enable()
    on = vp.vfp(frames, FUTURE, eps=eps)
    tracing.disable()
    assert torch.equal(off, on)
