"""The yardstick's arithmetic: the attention kernel's bytes and FLOPs per
call, the forward's and the train step's FLOPs counted on the reference,
the kernel categories, and the device's busy time as the union of
intervals."""

import pytest
import torch

from npvp_bench import flops
from npvp_bench import trace as T
from npvp_bench.reference import model as R
from npvp_bench.tests._tiny import manifest
from npvp_bench import harness

# the flagship forward's call sites (KTH Unified NPVP-S, batch 64, VFP
# 10 -> 10): (sites, Tq, Tk, masked, calls): windows of 4x4 tokens over
# 64 clips x 10 frames x 4 windows, in 4 encoder and 8 decoder layers;
# the encoder's temporal attention (last frame hidden) over the 64 x 8x8
# sites; the decoder's self- and cross-attention
SITES = [(2560, 16, 16, False, 12), (4096, 10, 10, True, 4),
         (4096, 10, 10, False, 8), (4096, 10, 10, False, 8)]
HD = C = 512


def _kth():
    return harness.make_context(manifest(), "kth_serve_vfp_b64", 0, 1.0,
                                False, "cpu", 0.0).model_config


@pytest.mark.parametrize("site,want", [
    # 2·(B·Tq·HD + 2·B·Tk·HD + B·Tq·C) + 2·HD·C + 4·C bytes;
    # 4·B·Tq·Tk·HD + 2·B·Tq·HD·C FLOPs
    ((2560, 16, 16, False), (168_298_496, 22_817_013_760)),
    ((4096, 10, 10, True), (168_298_896, 22_313_697_280)),
    ((4096, 10, 10, False), (168_298_496, 22_313_697_280))],
    ids=["window", "temporal_enc", "temporal_dec_and_cross"])
def test_kernel_bytes_and_flops_at_the_flagship_sites(site, want):
    B, Tq, Tk, masked = site
    assert flops.attention_call(B, Tq, Tk, HD, C, masked) == want
    shapes = [[B, Tq, HD], [B, Tk, HD], [B, Tk, HD],
              [Tq, Tk] if masked else [], [C, HD], [C], []]
    assert flops.attention_call_from_shapes(shapes) == want


def test_flagship_forward_bound():
    """The 32 calls' least time, 1.608 ms, all of it bytes: the bound that
    the port's kernel table gives."""
    total = sum(n * flops.bound_s(*flops.attention_call(B, Tq, Tk, HD, C, m))
                for B, Tq, Tk, m, n in SITES)
    assert total == pytest.approx(1.608e-3, rel=1e-3)
    assert all(flops.bound_s(*flops.attention_call(B, Tq, Tk, HD, C, m))
               == flops.attention_call(B, Tq, Tk, HD, C, m)[0]
               / flops.PEAK_BYTES_S for B, Tq, Tk, m, _ in SITES)


def _shared_flops(cfg, to, tp):
    """FLOPs of the coordinate MLP, which no clip of the batch repeats."""
    from torch.utils.flop_counter import FlopCounterMode

    p = cfg["Predictor"]
    _, pred = R.build(cfg, device="meta")
    with torch.no_grad(), FlopCounterMode(display=False) as fc:
        for t in (to, tp):
            pred.nrmlp(R.coordinate_grid(t, p["max_T"], p["max_H"],
                                         p["max_W"], "meta"))
    return fc.get_total_flops()


def test_forward_flops_scale_with_the_batch():
    cfg = _kth()
    to, tp = list(range(10)), list(range(10, 20))
    one = flops.serve_forward_flops(cfg, 1, to, tp)
    b64 = flops.serve_forward_flops(cfg, 64, to, tp)
    shared = _shared_flops(cfg, to, tp)
    assert 0 < shared < one / 100
    assert b64 - shared == 64 * (one - shared)


def attention_products_flops(config: dict, batch: int, to_list,
                             tp_list) -> int:
    """FLOPs of the predictor's attention products alone (QKᵀ and P·V of
    every attention site), counted on the reference."""
    d, p = config["Dataset"], config["Predictor"]
    _, pred = R.build(config, device="meta")
    pred.eval()
    S = d["img_size"] // 2 ** config["AE"]["n_downsampling"]
    feats = torch.empty((batch, len(to_list), S, S, p["embed_dim"]),
                        device="meta")
    eps = torch.empty((batch, p["max_H"], p["max_W"], p["embed_dim"]),
                      device="meta")
    grid = lambda t: R.coordinate_grid(t, p["max_T"], p["max_H"],  # noqa
                                       p["max_W"], "meta")
    counted = []
    orig = R.attention

    def counting(q, k, v, *a, **kw):
        with flops._counter() as fc:
            out = orig(q, k, v, *a, **kw)
        counted.append(fc.get_total_flops())
        return out

    R.attention = counting
    try:
        with torch.no_grad():
            pred(feats, grid(to_list), grid(tp_list), eps)
    finally:
        R.attention = orig
    return int(sum(counted))


def test_attention_products_equal_the_kernel_count():
    cfg = _kth()
    got = attention_products_flops(cfg, 64, list(range(10)),
                                   list(range(10, 20)))
    want = sum(n * flops.attention_call(B, Tq, Tk, HD)[1]
               for B, Tq, Tk, _, n in SITES)
    assert got == want


def test_train_step_flops_count_the_backward():
    cfg = harness.make_context(manifest(), "smmnist_train_b8", 0, 1.0,
                               False, "cpu", 0.0).model_config
    step = flops.train_step_flops(cfg, 8)
    fwd = flops.serve_forward_flops(cfg, 8, list(range(15)),
                                    list(range(15)))
    # two codings in training, and a backward of about twice the forward
    assert 2.5 * fwd < step < 5 * fwd


def test_grouped_convolution_backward_is_counted_as_its_forward():
    conv = torch.nn.Conv2d(64, 64, 3, padding=1, groups=64, device="meta")
    x = torch.empty((2, 64, 8, 8), device="meta", requires_grad=True)
    with flops._counter() as fc:
        y = conv(x)
    fwd = fc.get_total_flops()
    with flops._counter() as fc:
        torch.autograd.grad(y.sum(), [x, conv.weight])
    assert fwd == 2 * 2 * 64 * 8 * 8 * 9
    assert fc.get_total_flops() == 2 * fwd


@pytest.mark.parametrize("name,cat", [
    ("void temporal_attention_hopper<true>(CUtensorMap)",
     "temporal_attention kernel"),
    ("sm90_xmma_fprop_implicit_gemm_bf16", "convolution (cuDNN)"),
    ("nvjet_tst_128x64_64x4_1x2_h_bz_coopA_NNT", "matmul (cuBLAS)"),
    ("void at::native::reduce_kernel<512, 1>", "reduction"),
    ("void at::native::vectorized_elementwise_kernel<4>", "elementwise"),
    ("Memcpy HtoD (Pageable -> Device)", "other")])
def test_kernel_categories(name, cat):
    assert T.category(name) == cat


def test_busy_time_is_the_union_of_overlapping_intervals():
    iv = [(0, 10), (5, 15), (20, 30), (22, 25), (29, 31), (40, 41)]
    assert T.union_length(iv) == 15 + 11 + 1
    assert T.gaps(iv, 0, 50) == [(15, 20), (31, 40), (41, 50)]
    assert T.union_length([]) == 0


class _Event:
    """A profiler event as torch before ``activity_type`` gives it."""

    def __init__(self, name, start, end, cuda=False, corr=0,
                 annotation=False, shapes=()):
        self._v = (name, start, end, cuda, corr, annotation, list(shapes))

    def name(self):
        return self._v[0]

    def start_ns(self):
        return self._v[1]

    def end_ns(self):
        return self._v[2]

    def device_type(self):
        return (torch.autograd.DeviceType.CUDA if self._v[3]
                else torch.autograd.DeviceType.CPU)

    def correlation_id(self):
        return self._v[4]

    def is_user_annotation(self):
        return self._v[5]

    def shapes(self):
        return self._v[6]


def test_summary_of_a_synthetic_trace():
    ev = [_Event("bench.request.call", 0, 100, annotation=True),
          _Event("bench.predictor", 10, 60, annotation=True),
          _Event("cudaLaunchKernel", 12, 13, corr=7),
          _Event("cudaLaunchKernel", 20, 21, corr=8),
          _Event("cudaLaunchKernel", 70, 71, corr=9),
          _Event("npvp::temporal_attention", 19, 25,
                 shapes=[[2, 3, 4], [2, 3, 4], [2, 3, 4], [], [4, 4], [4],
                         []]),
          _Event("gemm_a", 15, 35, cuda=True, corr=7),
          _Event("temporal_attention_hopper", 30, 50, cuda=True, corr=8),
          _Event("unlinked_elementwise", 51, 55, cuda=True, corr=0),
          _Event("elementwise_b", 80, 90, cuda=True, corr=9),
          _Event("Memcpy DtoH", 90, 95, cuda=True, corr=10)]
    t = T.summarize(ev, 100e-9, ["npvp::temporal_attention"])
    assert t.busy_s == pytest.approx((35 + 4 + 15) * 1e-9)
    assert t.kernel_s == pytest.approx((20 + 20 + 4 + 10) * 1e-9)
    assert t.range_device_s["bench.predictor"] == pytest.approx(40e-9)
    assert t.range_counts["bench.request.call"] == 1
    assert t.op_shapes["npvp::temporal_attention"][0][0] == [2, 3, 4]
    assert t.kernels_matching("temporal_attention") == (
        pytest.approx(20e-9), 1)
    assert T.idle_share({"device_trace": t}) == pytest.approx(46.0)
    assert set(t.idle_by_range_s) <= {"bench.predictor",
                                      "bench.request.call",
                                      "window edges (host only)"}
    b = T.breakdown(t, t)
    assert b["device_ops"][0][0].startswith("matmul (cuBLAS): gemm_a")
    assert len(b["device_ops"]) <= 10 and len(b["idle_gaps"]) <= 10


def test_pace_counts_items_and_collections_by_stretch():
    import gc

    pace = T.Pace(seconds=1.0)
    for t in (0.1, 0.5, 0.9, 1.2, 3.4):
        pace.tick(t)
    gc.collect()
    pace.close()
    items = [row[0] for row in pace.rows]
    assert items == [3, 1, 0, 1]
    assert sum(row[4] for row in pace.rows) >= 1  # the collection above
    assert all(row[1] >= 0 and row[2] >= 0 for row in pace.rows)
    assert pace.describe().startswith("items [3, 1, 0, 1]")
    assert pace._on_gc not in gc.callbacks
