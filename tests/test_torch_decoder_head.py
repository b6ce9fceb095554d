"""The decoder-tail kernel's twin and call site, on the CPU
(``npvp_tpu_torch/kernels/decoder_head.py``; the kernel itself runs on the
card, ``tests/test_torch_decoder_head_cuda.py``; its op, wrapper and the
kernel-path rule with the other kernels' in
``tests/test_torch_kernel_seam.py``):

- the plain twin, which the decoder's eager path calls, is the decoder's
  former eager tail bit for bit, at every published (C_in, C_out,
  out_layer), in float32 and bfloat16, on both paths;
- the reflect padding's coordinates at the borders of 64- and 128-pixel
  frames are the ones the kernel computes;
- ``kernel_path`` sends training mode, a forward under autograd and the
  xla and int8 modes to the eager code, and an s2d head keeps its own;
- the kernel side raises on a shape it does not take;
- ``LAUNCHES`` counts one a decode on the kernel path, by H·W;
- ``BatchNorm.scale_shift`` is what its forward applies;
- ``build_ae`` hands ``exec_mode`` to the decoder, whose state dict is the
  same in every mode.
"""

import collections

import pytest

torch = pytest.importorskip("torch")
# small tensors: one thread per test worker, not one per core
torch.set_num_threads(1)

import torch.nn.functional as F  # noqa: E402

from npvp_tpu_torch.core.config import Config  # noqa: E402
from npvp_tpu_torch.kernels import _nvcc  # noqa: E402
from npvp_tpu_torch.kernels import decoder_head as dh  # noqa: E402
from npvp_tpu_torch.nn import resnet_ae as tae  # noqa: E402
from npvp_tpu_torch.nn.layers import BatchNorm, reflect_pad_2d  # noqa: E402
from npvp_tpu_torch.tools.weights import random_init  # noqa: E402

BF16 = torch.bfloat16


def _former_eager_forward(dec, x):
    """``ResnetDecoder.forward`` as it was before the kernel, inlined: every
    upsampling's BatchNorm and ReLU, the reflect pad, the direct head."""
    N, T = x.shape[:2]
    dt = dec.dtype
    x = x.reshape((N * T,) + x.shape[2:]).to(dt)
    for i in range(dec.n_downsampling):
        up = getattr(dec, f"up{i}_conv")
        y = F.conv_transpose2d(x.permute(0, 3, 1, 2), up.weight.to(dt), None,
                               2, 1, 1).permute(0, 2, 3, 1)
        x = torch.relu(getattr(dec, f"up{i}_bn")(y))
    x = F.pad(x.permute(0, 3, 1, 2), (3, 3, 3, 3), mode="reflect")
    x = F.conv2d(x, dec.head.weight.to(dt), dec.head.bias.to(dt))
    x = x.permute(0, 2, 3, 1)
    x = torch.tanh(x) if dec.out_layer == "Tanh" else torch.sigmoid(x)
    return x.reshape((N, T) + x.shape[1:])


def _decoder(c_in, c_out, out_layer, dtype, exec_mode="xla", seed=0):
    """A ResnetDecoder whose last upsampling has ``c_in`` channels (two
    upsamplings from 4·c_in), in eval mode, with running statistics,
    BatchNorm affines and head bias away from their init values, frozen."""
    dec = random_init(tae.ResnetDecoder(c_out, c_in, 2, out_layer,
                                        dtype=dtype, exec_mode=exec_mode),
                      seed)
    g = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for m in dec.modules():
            if isinstance(m, BatchNorm):
                c = m.running_mean.numel()
                m.running_mean.copy_(0.2 * torch.randn(c, generator=g))
                m.running_var.copy_(1 + 0.3 * torch.rand(c, generator=g))
                m.weight.add_(0.2 * torch.randn(c, generator=g))
                m.bias.add_(0.2 * torch.randn(c, generator=g))
        dec.head.bias.copy_(0.2 * torch.randn(c_out, generator=g))
    return dec.eval().requires_grad_(False)


def _feats(c_in, dtype=torch.float32, seed=0, clips=2, side=3):
    g = torch.Generator().manual_seed(seed)
    return torch.relu(torch.randn((clips, 2, side, side, 4 * c_in),
                                  generator=g)).to(dtype)


# every published AE's last upsampling: Cityscapes and KITTI, BAIR, KTH,
# SMMNIST
PUBLISHED = [(32, 3, "Tanh"), (64, 3, "Tanh"), (64, 1, "Tanh"),
             (64, 1, "Sigmoid")]


@pytest.mark.parametrize("c_in,c_out,out_layer", PUBLISHED)
@pytest.mark.parametrize("dtype", [torch.float32, BF16])
@pytest.mark.parametrize("mode", ["xla", "pallas"])
def test_twin_is_the_former_eager_tail(c_in, c_out, out_layer, dtype, mode):
    dec = _decoder(c_in, c_out, out_layer, dtype, mode)
    x = _feats(c_in)
    with torch.no_grad():
        got = dec(x)
        want = _former_eager_forward(dec, x)
    assert got.dtype == want.dtype == dtype
    assert got.shape == (2, 2, 12, 12, c_out)
    assert torch.equal(got, want)


def test_twin_in_training_mode_is_the_former_eager_tail():
    """Batch statistics, and one move of the running ones, as before."""
    dec = _decoder(32, 3, "Tanh", torch.float32).train()
    former = _decoder(32, 3, "Tanh", torch.float32).train()
    x = _feats(32)
    with torch.no_grad():
        got, want = dec(x), _former_eager_forward(former, x)
    assert torch.equal(got, want)
    for name, buf in dec.state_dict().items():
        assert torch.equal(buf, former.state_dict()[name]), name


def _reflected(i, n):
    """The kernel's reflected coordinate (``csrc/decoder_head.cu``
    ``reflect``) of padded index ``i`` − 3 on a side of ``n``."""
    i = -i if i < 0 else i
    return 2 * n - 2 - i if i >= n else i


@pytest.mark.parametrize("side", [64, 128])
def test_reflected_border_coordinates(side):
    """The padded frame's row and column k are the frame's
    ``_reflected(k − 3)``: 3, 2, 1, 0, 1, ... at the top and left, ...,
    n − 2, n − 3, n − 4 at the bottom and right."""
    g = torch.Generator().manual_seed(side)
    x = torch.randn((2, side, side + 2, 4), generator=g)
    padded = reflect_pad_2d(x, 3)
    rows = [_reflected(k - 3, side) for k in range(side + 6)]
    cols = [_reflected(k - 3, side + 2) for k in range(side + 8)]
    assert rows[:4] == [3, 2, 1, 0] and rows[-3:] == [side - 2, side - 3,
                                                       side - 4]
    assert torch.equal(padded, x[:, rows][:, :, cols])


@pytest.fixture
def counted(monkeypatch):
    """Every call of the wrapper, counted by its frame size H·W."""
    calls = collections.Counter()
    real = dh.decoder_head

    def counting(y, *args):
        calls[y.shape[1] * y.shape[2]] += 1
        return real(y, *args)

    monkeypatch.setattr(dh, "decoder_head", counting)
    return calls


@pytest.mark.parametrize("case", ["train", "grad", "xla", "int8", "s2d"])
def test_kernel_path_sends_to_the_eager_tail(counted, case):
    """Training mode, an input that needs a gradient under autograd (the
    forward and its backward run), the xla and int8 modes and an s2d head
    never reach the wrapper."""
    mode = case if case in ("xla", "int8") else "pallas"
    dec = _decoder(32, 3, "Tanh", BF16, mode)
    if case == "s2d":
        dec.s2d_head = True
    if case == "train":
        dec.train()
    x = _feats(32, side=4)
    if case == "grad":
        x.requires_grad_()
        dec(x).float().sum().backward()
        assert x.grad is not None
    else:
        with torch.no_grad():
            dec(x)
    assert not counted


def test_kernel_path_is_open_in_eval_mode(counted):
    """``pallas`` in eval mode with nothing that needs a gradient: one call
    a decode, under ``torch.no_grad()`` or not."""
    dec = _decoder(64, 1, "Sigmoid", BF16, "pallas")
    x = _feats(64)
    with torch.no_grad():
        got = dec(x)
    assert dict(counted) == {144: 1}
    assert torch.equal(dec(x), got)
    assert dict(counted) == {144: 2}


@pytest.mark.parametrize("y_shape,w_shape,out_layer", [
    ((2, 8, 8, 16), (3, 16, 7, 7), "Tanh"),     # C_in 16
    ((2, 8, 8, 128), (3, 128, 7, 7), "Tanh"),   # C_in 128
    ((2, 8, 8, 32), (2, 32, 7, 7), "Tanh"),     # C_out 2
    ((2, 8, 8, 32), (3, 32, 5, 5), "Tanh"),     # a 5x5 head
    ((2, 3, 8, 32), (3, 32, 7, 7), "Tanh"),     # H within the padding
    ((2, 8, 8, 32), (3, 32, 7, 7), "ReLU")])
def test_the_kernel_side_raises_on_a_shape_it_does_not_take(y_shape, w_shape,
                                                            out_layer):
    """``launch`` refuses before it touches a device: no silent eager
    path."""
    C, co = y_shape[3], w_shape[0]
    y = torch.zeros(y_shape, dtype=BF16)
    args = (torch.ones(C, dtype=BF16), torch.zeros(C, dtype=BF16),
            torch.zeros(w_shape, dtype=BF16), torch.zeros(co, dtype=BF16))
    launches = dict(dh.LAUNCHES)
    assert not dh.takes(y_shape, w_shape, out_layer)
    with pytest.raises(ValueError, match="unsupported shape"):
        dh.launch(y, *args, out_layer)
    assert dh.LAUNCHES == launches


@pytest.mark.parametrize("c_in,c_out,out_layer", PUBLISHED)
def test_the_kernel_takes_every_published_tail(c_in, c_out, out_layer):
    for side in (64, 128):
        assert dh.takes((8, side, side, c_in), (c_out, c_in, 7, 7),
                        out_layer)


class _NoLaunch:
    """A library whose launch does nothing: the wrapper's checks and count
    run on CPU tensors as on CUDA ones."""

    def launch(self, *args):
        pass


@pytest.mark.parametrize("side,c_in,c_out,out_layer", [
    (128, 32, 3, "Tanh"), (64, 64, 1, "Tanh"), (64, 64, 1, "Sigmoid")])
def test_launches_count_one_a_decode(monkeypatch, side, c_in, c_out,
                                     out_layer):
    dec = _decoder(c_in, c_out, out_layer, BF16, "pallas")
    monkeypatch.setattr(_nvcc, "direct", lambda x: True)
    monkeypatch.setattr(dh, "LIB", _NoLaunch())
    monkeypatch.setattr(dh, "LAUNCHES", {})
    with torch.no_grad():
        out = dec(_feats(c_in, side=side // 4, clips=1))
    assert out.shape == (1, 2, side, side, c_out)
    assert dh.LAUNCHES == {side * side: 1}


@pytest.mark.parametrize("training", [False, True])
def test_batchnorm_scale_shift_is_its_forward(training):
    bn = BatchNorm(8, dtype=BF16)
    g = torch.Generator().manual_seed(4)
    with torch.no_grad():
        bn.running_mean.copy_(torch.randn(8, generator=g))
        bn.running_var.copy_(1 + torch.rand(8, generator=g))
        bn.weight.add_(0.3 * torch.randn(8, generator=g))
        bn.bias.add_(0.3 * torch.randn(8, generator=g))
    bn.train(training)
    x = torch.randn((4, 5, 6, 8), generator=g)
    twin = BatchNorm(8, dtype=BF16).train(training)
    twin.load_state_dict(bn.state_dict())
    a, b = bn.scale_shift(x)
    assert a.dtype == b.dtype == BF16 and a.shape == b.shape == (8,)
    assert torch.equal(twin(x), x.to(BF16) * a + b)
    # the running statistics moved once each, alike
    assert torch.equal(bn.running_mean, twin.running_mean)
    assert torch.equal(bn.running_var, twin.running_var)


def _ae_config(exec_mode):
    cfg = Config()
    d, a = cfg.Dataset, cfg.AE
    d.img_size, d.img_channels = 32, 3
    a.ngf, a.n_downsampling, a.num_res_blocks = 32, 4, 3
    cfg.Predictor.exec_mode = exec_mode
    return cfg


def test_build_ae_hands_exec_mode_to_the_decoder():
    for mode in ("xla", "pallas", "int8"):
        assert tae.build_ae(_ae_config(mode)).decoder.exec_mode == mode
        assert tae.build_ae(_ae_config(mode),
                            exec_mode="xla").decoder.exec_mode == "xla"
    want = list(tae.build_ae(_ae_config("xla")).state_dict())
    assert list(tae.build_ae(_ae_config("pallas")).state_dict()) == want
    assert not [k for k in want if "exec_mode" in k]


def test_a_cityscapes_structured_decode_calls_the_wrapper_once(counted):
    """The Cityscapes AE's structure (ngf 32, four upsamplings, colour) on
    32×32 frames: one call a decode, the frames the eager tail's."""
    ae = random_init(tae.build_ae(_ae_config("pallas"), BF16), 2)
    ae.eval().requires_grad_(False)
    g = torch.Generator().manual_seed(5)
    feats = torch.relu(torch.randn((1, 3, 2, 2, 512), generator=g))
    with torch.no_grad():
        got = ae.decode(feats)
        ae.decoder.exec_mode = "xla"
        want = ae.decode(feats)
    assert dict(counted) == {1024: 1}
    assert torch.equal(got, want)
