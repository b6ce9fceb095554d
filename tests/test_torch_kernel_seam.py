"""The seam between the port's modules and its four hand-written kernels, on
the CPU, one case per kernel (the kernels themselves run on the card:
``tests/test_torch_*_cuda.py``):

- each kernel's op has a CPU side that is its plain twin and a fake side
  that gives a trace the output's shape and dtype;
- each wrapper refuses inputs that autograd would differentiate before it
  reaches the op, and under ``torch.no_grad()`` gives the twin's output;
- ``torch.export`` keeps one op node for each call of a wrapper, and the
  exported program gives the eager module's output;
- a CPU tensor goes through the op: no library is loaded, no launch
  counted;
- ``nn.layers.kernel_path``, the one rule of the call sites, is shut in
  training mode, under the ``xla`` and ``int8`` modes and for an input that
  needs a gradient (and, at the non-local attention's and the decoder
  tail's sites, for fp32), and
  open in eval mode under ``pallas`` when nothing needs a gradient, where
  each module's output is the plain path's;
- no module under ``npvp_tpu_torch/kernels/`` imports from the layers above
  it.
"""

import ast
import collections
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
# tiny tensors: one thread per test worker, not one per core
torch.set_num_threads(1)

from torch._subclasses.fake_tensor import FakeTensorMode  # noqa: E402

from npvp_tpu_torch.kernels import decoder_head as dh  # noqa: E402
from npvp_tpu_torch.kernels import layer_norm as ln  # noqa: E402
from npvp_tpu_torch.kernels import nonlocal_attention as nla  # noqa: E402
from npvp_tpu_torch.kernels import temporal_attention as ta  # noqa: E402
from npvp_tpu_torch.nn import layers as tl  # noqa: E402
from npvp_tpu_torch.nn import resnet_ae as tae  # noqa: E402
from npvp_tpu_torch.nn import vidhrformer as tv  # noqa: E402
from npvp_tpu_torch.tools.weights import random_init  # noqa: E402

BF16 = torch.bfloat16
KERNELS = ["temporal_attention", "layer_norm", "nonlocal_attention",
           "decoder_head"]
MODULE = {"temporal_attention": ta, "layer_norm": ln,
          "nonlocal_attention": nla, "decoder_head": dh}


def _rand(shape, seed=0, dtype=torch.float32, scale=1.0):
    g = torch.Generator().manual_seed(seed)
    return (scale * torch.randn(shape, generator=g)).to(dtype)


def _op_args(kernel):
    """(wrapper args, wrapper kwargs, op args, twin) for one call."""
    if kernel == "temporal_attention":
        q, k, v = (_rand((6, T, 32), seed=T) for T in (5, 7, 7))
        allow = torch.rand(5, 7, generator=torch.Generator().manual_seed(1))
        bias = ta.allow_to_bias(allow > 0.3)
        wo, bo = _rand((24, 32), 2, scale=0.2), _rand((24,), 3)
        return ((q, k, v, bias), dict(num_heads=4, wo=wo, bo=bo),
                (q, k, v, bias, wo, bo, 4),
                lambda: ta.temporal_attention_plain(q, k, v, bias,
                                                    num_heads=4, wo=wo,
                                                    bo=bo))
    if kernel == "layer_norm":
        x = 0.5 + _rand((6, 4, 2, 8), 4, scale=2.0)
        w, b = 1 + _rand((4, 2, 8), 5, scale=0.3), _rand((4, 2, 8), 6)
        x = x.to(BF16)
        return ((x, w, b), dict(eps=1e-5, out_dtype=torch.float32,
                                act="gelu_tanh"),
                (x, w, b, 1e-5, torch.float32, "gelu_tanh"),
                lambda: ln.layer_norm_plain(x, w, b, 1e-5, torch.float32,
                                            "gelu_tanh"))
    if kernel == "nonlocal_attention":
        qkv = _rand((2, 6, 4, 96), 7, BF16, 2.0)
        return ((qkv, 16), {}, (qkv, 16),
                lambda: nla.nonlocal_attention_plain(qkv, 16))
    y = _rand((3, 6, 5, 8), 8, BF16)
    a, b = (1 + _rand((8,), 9, BF16, 0.2), _rand((8,), 10, BF16, 0.3))
    w, c = _rand((3, 8, 7, 7), 11, BF16, 0.1), _rand((3,), 12, BF16)
    return ((y, a, b, w, c, "Tanh"), {}, (y, a, b, w, c, "Tanh"),
            lambda: dh.decoder_head_plain(y, a, b, w, c, "Tanh"))


@pytest.mark.parametrize("kernel", KERNELS)
def test_op_cpu_and_fake_implementations(kernel):
    _, _, args, twin = _op_args(kernel)
    op = getattr(torch.ops.npvp, kernel)
    with torch.no_grad():
        got, want = op(*args), twin()
    assert torch.equal(got, want)
    with FakeTensorMode() as mode:
        fake = op(*(mode.from_tensor(a) if isinstance(a, torch.Tensor)
                    else a for a in args))
    assert tuple(fake.shape) == tuple(want.shape)
    assert fake.dtype == want.dtype
    # on meta tensors too (what a trace of a CUDA program sees)
    meta = op(*(a.to("meta") if isinstance(a, torch.Tensor) else a
                for a in args))
    assert tuple(meta.shape) == tuple(want.shape)
    assert meta.device.type == "meta"


@pytest.mark.parametrize("kernel", KERNELS)
def test_wrapper_refuses_autograd_before_the_op(kernel, monkeypatch):
    args, kw, _, twin = _op_args(kernel)
    wrapper = getattr(MODULE[kernel], kernel)
    first = args[0].detach().requires_grad_()
    monkeypatch.setattr(torch.ops.npvp, kernel, None, raising=False)
    with pytest.raises(RuntimeError, match="no backward"):
        wrapper(first, *args[1:], **kw)
    monkeypatch.undo()
    with torch.no_grad():  # no gradient asked: the op's CPU side, the twin
        assert torch.equal(wrapper(first, *args[1:], **kw), twin())
    if kernel != "nonlocal_attention":  # another input that needs one
        with pytest.raises(RuntimeError, match="no backward"):
            wrapper(*args[:2], args[2].detach().requires_grad_(),
                    *args[3:], **kw)


@pytest.mark.parametrize("kernel", KERNELS)
def test_a_cpu_tensor_loads_no_library_and_counts_no_launch(kernel,
                                                            monkeypatch):
    mod = MODULE[kernel]
    args, kw, _, twin = _op_args(kernel)
    monkeypatch.setattr(mod.LIB, "load",
                        lambda: pytest.fail("kernel library loaded"))
    launches = dict(mod.LAUNCHES)
    with torch.no_grad():
        got = getattr(mod, kernel)(*args, **kw)
    assert torch.equal(got, twin())
    assert mod.LAUNCHES == launches


def test_a_failed_launch_names_the_call_and_its_shapes(monkeypatch):
    """``Library.launch`` passes the current stream last and raises on a
    CUDA error code with the call's non-pointer arguments."""
    import types

    from npvp_tpu_torch.kernels import _nvcc

    seen = []

    def fake_launch(*args):
        seen.append(args)
        return 700

    lib = _nvcc.Library("layer_norm.cu", "liblayer_norm",
                        ln.LIB.functions)
    lib._lib = types.SimpleNamespace(npvp_layer_norm_launch=fake_launch)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev: types.SimpleNamespace(cuda_stream=7))
    with pytest.raises(RuntimeError, match=r"npvp_layer_norm_launch failed: "
                       r"CUDA error 700 \(arguments \[640, 512, 1, 1, "
                       r"1e-05, 1\]\)"):
        lib.launch("npvp_layer_norm_launch", "cuda", 11, 12, 13, 14, 640,
                   512, 1, 1, 1e-5, 1)
    assert seen == [(11, 12, 13, 14, 640, 512, 1, 1, 1e-5, 1, 7)]


class _Attend(torch.nn.Module):
    def __init__(self, fuse):
        super().__init__()
        self.wo = torch.nn.Linear(32, 24) if fuse else None

    def forward(self, q, k, v, bias):
        return ta.temporal_attention(
            q, k, v, bias, num_heads=4,
            wo=None if self.wo is None else self.wo.weight,
            bo=None if self.wo is None else self.wo.bias)


def _decoder(exec_mode, dtype=BF16):
    """A decoder of one upsampling to 3 channels, its tail on the kernel
    path under ``pallas``."""
    return tae.ResnetDecoder(3, 4, 1, dtype=dtype, exec_mode=exec_mode)


def _export_case(case):
    """(module, inputs, op calls a forward) of each export case."""
    if case.startswith("temporal_attention"):
        args, _, _, _ = _op_args("temporal_attention")
        return _Attend(case.endswith("fused")).eval(), args, 1
    if case == "layer_norm":  # three norms, the GELU as their epilogue
        mlp = tv.MlpDWBN(8, 16, 8, (4, 2), exec_mode="pallas").eval()
        return mlp, (_rand((2, 3, 4, 2, 8), 1),), 3
    if case == "decoder_head":
        mod = random_init(_decoder("pallas"), 0)
        return mod.eval(), (_rand((2, 2, 4, 4, 8), 0),), 1
    mod = random_init(tae.NonLocalAttention2D(64, dtype=BF16,
                                              exec_mode="pallas"), 0)
    return mod.eval(), (_rand((1, 4, 4, 64), 0, BF16, 2.0),), 1


@pytest.mark.parametrize("case", ["temporal_attention_fused",
                                  "temporal_attention", "layer_norm",
                                  "nonlocal_attention", "decoder_head"])
def test_export_keeps_one_op_node_per_call(case):
    module, args, calls = _export_case(case)
    kernel = case.replace("_fused", "")
    with torch.no_grad():
        program = torch.export.export(module, args)
        want = module(*args)
    nodes = [n for n in program.graph.nodes if n.op == "call_function"
             and f"npvp.{kernel}" in str(n.target)]
    assert len(nodes) == calls
    if isinstance(module, _Attend):  # its own output
        assert tuple(nodes[0].meta["val"].shape) == tuple(want.shape)
    with torch.inference_mode():
        assert torch.equal(program.module()(*args), want)


def _site(kernel, exec_mode, dtype=BF16):
    """A module whose forward reaches ``kernel``'s wrapper on its kernel
    path, in eval mode with frozen random parameters, and its input."""
    if kernel == "temporal_attention":
        mod = tv.VidHRFormerEncoder(1, 32, 4, window_size=2,
                                    ffn_hidden_ratio=2, dim_feedforward=64,
                                    affine_posfuse=True, exec_mode=exec_mode,
                                    spatial=(4, 4))
        beta = _rand((3 * 16, 32), 1, scale=0.3)
        args = (_rand((2, 3, 4, 4, 32)), beta, torch.zeros_like(beta))
    elif kernel == "layer_norm":
        mod = tv.MlpDWBN(8, 16, 8, (4, 2), exec_mode=exec_mode)
        args = (_rand((2, 3, 4, 2, 8), 1),)
    elif kernel == "nonlocal_attention":
        mod = tae.NonLocalAttention2D(64, dtype=dtype, exec_mode=exec_mode)
        args = (_rand((2, 4, 4, 64), 0, dtype, 2.0),)
    else:
        mod = _decoder(exec_mode, dtype)
        args = (_rand((2, 2, 4, 4, 8), 0),)
    mod = random_init(mod, 3)
    with torch.no_grad():  # the norms away from their identity init
        for m in mod.modules():
            if isinstance(m, (tl.TokenLayerNorm, tl.LayerNormHWC)):
                m.weight.add_(_rand(m.weight.shape, 4, scale=0.2))
                m.bias.add_(_rand(m.bias.shape, 5, scale=0.1))
            if isinstance(m, tae.NonLocalAttention2D):
                m.gamma.fill_(0.75)
            if isinstance(m, tl.BatchNorm):  # statistics away from init
                m.running_mean.copy_(_rand(m.running_mean.shape, 6,
                                           scale=0.1))
                m.running_var.add_(_rand(m.running_var.shape, 7).abs())
                m.bias.add_(_rand(m.bias.shape, 8, scale=0.2))
    return mod.eval().requires_grad_(False), args


@pytest.fixture
def counted(monkeypatch):
    """Every call of each kernel's wrapper, counted by kernel."""
    calls = collections.Counter()
    for kernel, mod in MODULE.items():
        real = getattr(mod, kernel)

        def counting(*a, _real=real, _kernel=kernel, **kw):
            calls[_kernel] += 1
            return _real(*a, **kw)

        monkeypatch.setattr(mod, kernel, counting)
    return calls


@pytest.mark.parametrize("kernel,case", [
    (k, c) for k in KERNELS for c in ("train", "xla", "int8", "grad")] + [
    ("nonlocal_attention", "fp32"), ("decoder_head", "fp32")])
def test_kernel_path_is_shut(counted, kernel, case):
    """Off the kernel path no wrapper is called (the attention's site, an
    encoder block, holds norms too) and nothing launches: training, the xla
    and int8 modes, an input that needs a gradient under autograd (the
    forward and its backward run), and the non-local attention's and the
    decoder tail's fp32 (their kernels are bf16 only)."""
    mode = case if case in ("xla", "int8") else "pallas"
    mod, args = _site(kernel, mode,
                      torch.float32 if case == "fp32" else BF16)
    launches = dict(MODULE[kernel].LAUNCHES)
    if case == "train":
        mod.train()
    if case == "grad":
        x = args[0].detach().requires_grad_()
        mod(x, *args[1:]).float().sum().backward()
        assert x.grad is not None
    else:
        with torch.no_grad():
            mod(*args)
    assert not counted
    assert MODULE[kernel].LAUNCHES == launches


@pytest.mark.parametrize("kernel,calls,exact", [
    ("temporal_attention", 2, False),   # a window and a temporal attention
    ("layer_norm", 3, True),
    ("nonlocal_attention", 1, True),
    ("decoder_head", 1, True)])
def test_kernel_path_is_open_in_eval_mode(counted, kernel, calls, exact):
    """``pallas`` in eval mode with nothing that needs a gradient, under
    ``torch.no_grad()`` or not: each call goes to the wrapper (the op's
    CPU side, the twin), and the output is the ``xla`` module's (bit for
    bit for the norm, the non-local attention and the decoder's tail, whose
    twins are their eager code; within 2e-5 for the attention, whose plain
    path is the library's)."""
    mod, args = _site(kernel, "pallas")
    plain, _ = _site(kernel, "xla")
    with torch.no_grad():
        got, want = mod(*args), plain(*args)
    assert counted[kernel] == calls
    torch.testing.assert_close(got, want, atol=0 if exact else 2e-5, rtol=0)
    assert torch.equal(mod(*args), got)  # grad mode on, nothing needs one
    assert counted[kernel] == 2 * calls


LAYERS_ABOVE = ("nn", "models", "train", "eval", "tools")


def test_the_kernels_import_nothing_above_them():
    """``kernels/`` sits below ``nn/``: none of its modules imports ``nn``,
    ``models``, ``train``, ``eval`` or ``tools`` of the port, at module
    level or inside a function."""
    root = Path(__file__).resolve().parents[1] / "npvp_tpu_torch"
    found = []
    for path in sorted((root / "kernels").glob("*.py")):
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.ImportFrom):
                base = ["npvp_tpu_torch", "kernels"][:3 - node.level] if (
                    node.level) else []
                mod = ".".join(base + [node.module] if node.module else base)
                names = [mod] + [f"{mod}.{a.name}" for a in node.names]
            elif isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            else:
                continue
            found += [(path.name, n) for n in names
                      if n.split(".")[:2] in (["npvp_tpu_torch", layer]
                                              for layer in LAYERS_ABOVE)]
    assert (root / "kernels" / "_nvcc.py").exists()
    assert not found
