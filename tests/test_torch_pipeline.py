"""GPipe (``npvp_tpu_torch.core.pipeline``) and the multi-card dry run
(``npvp_tpu_torch.tools.dryrun_multichip``) on the CPU, with gloo ranks
spawned by ``_torch_parallel.spawn``, fp32:

- JAX's MLP cases (L, S, M) ∈ {(8, 4, 4), (8, 8, 3), (4, 2, 1)} against
  the sequential stack (atol 1e-6, ``tests/test_pipeline.py``'s bound);
- 4 decoder blocks of flax variables through 4 stages, the whole target
  as one microbatch and 2 microbatches carrying their own event query and
  memory, against JAX's sequential blocks (atol 1e-4);
- PP×DP on 4 ranks (2 stages × data 2) against the sequential stack;
- ``dryrun_multichip(4, device="cpu")`` at a narrow width (embed 128)
  prints its three OK lines; at the flagship width it is marked slow.
"""

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import _torch_parallel as P  # noqa: E402

from npvp_tpu_torch.nn.vidhrformer import VidHRFormerBlockDecNAR  # noqa: E402
from npvp_tpu_torch.tools.dryrun_multichip import (  # noqa: E402
    dryrun_multichip)
from npvp_tpu_torch.tools.weights import load_flax  # noqa: E402

CASES = [(8, 4, 4), (8, 8, 3), (4, 2, 1)]


def _mlp_case(L, M, B=2, D=16, seed=0):
    rng = np.random.default_rng(seed)
    layers = [{"w": torch.from_numpy(rng.standard_normal((D, D)).astype(
        np.float32) * 0.2), "b": torch.from_numpy(rng.standard_normal(
            (D,)).astype(np.float32))} for _ in range(L)]
    x = torch.from_numpy(np.random.default_rng(seed + 1).standard_normal(
        (M, B, D)).astype(np.float32))
    want = x
    for p in layers:
        want = P.mlp(p, want)
    return layers, x, want


def _jax_blocks():
    """``tests/test_pipeline.py``'s 4 decoder blocks (C 16, 4 heads,
    window 4, H = W = 4): flax variables, inputs and JAX's sequential
    outputs, whole and per batch row."""
    from npvp_tpu.nn.vidhrformer import VidHRFormerBlockDecNAR as JaxBlock

    C, heads, ws, L = 16, 4, 4, 4
    N, To, TP, H, W = 2, 2, 2, 4, 4
    block = JaxBlock(C, heads, ws, 0.0, 0.0, 2, 32, "layer",
                     dtype=jnp.float32)
    rng = np.random.default_rng(3)
    f32 = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa
    inputs = dict(query_evt=f32(N, 1, H, W, C), memory=f32(N, To, H, W, C),
                  mem_pos=(f32(To * H * W, C), f32(To * H * W, C)),
                  tgt_pos=(f32(TP * H * W, C), f32(TP * H * W, C)),
                  tgt0=f32(N, TP, H, W, C))
    args = [inputs[k] for k in ("tgt0", "query_evt", "memory", "mem_pos",
                                "tgt_pos")]
    variables = [block.init(jax.random.key(i), *args) for i in range(L)]
    want = args[0]
    for v in variables:
        want = block.apply(v, want, *args[1:], deterministic=True)
    block_args = (C, heads, ws, 0.0, 0.0, 2, 32, "layer", False, "xla",
                  (H, W))
    states = [load_flax(VidHRFormerBlockDecNAR(*block_args),
                        jax.tree.map(np.asarray, v)).state_dict()
              for v in variables]
    torch_in = {k: (tuple(torch.from_numpy(t) for t in v)
                    if isinstance(v, tuple) else torch.from_numpy(v))
                for k, v in inputs.items()}
    return block_args, states, torch_in, np.asarray(want)


@pytest.fixture(scope="module")
def pipelines(tmp_path_factory):
    cases = {c: _mlp_case(c[0], c[2]) for c in CASES}
    dp = _mlp_case(8, 4, B=4, seed=2)
    block_args, states, inputs, jax_want = _jax_blocks()
    got = {}
    for world in (2, 4, 8):
        scen = [(P.pipeline_mlp_scenario, dict(layers=cases[c][0],
                                               x=cases[c][1], stages=c[1]))
                for c in CASES if c[1] == world]
        names = [c for c in CASES if c[1] == world]
        if world == 4:
            scen += [(P.pipeline_blocks_scenario, dict(
                block_args=block_args, states=states, inputs=inputs,
                stages=4)), (P.pipeline_mlp_scenario, dict(
                    layers=dp[0], x=dp[1], stages=2, data=2))]
            names += ["blocks", "ppxdp"]
        got.update(zip(names, P.spawn(tmp_path_factory.mktemp(f"pp{world}"),
                                      world, scen)))
    return got, cases, dp[2], jax_want


@pytest.mark.parametrize("case", CASES, ids=lambda c: "L{}_S{}_M{}".format(*c))
def test_pipeline_matches_sequential_mlp(pipelines, case):
    got, cases, _, _ = pipelines
    np.testing.assert_allclose(got[case].numpy(), cases[case][2].numpy(),
                               atol=1e-6, rtol=0)


def test_pipeline_decoder_blocks_match_jax(pipelines):
    got, _, _, jax_want = pipelines
    for key in ("whole", "microbatched"):
        np.testing.assert_allclose(got["blocks"][key].numpy(), jax_want,
                                   atol=1e-4, rtol=0, err_msg=key)


def test_pipeline_composes_with_data_parallelism(pipelines):
    got, _, want, _ = pipelines
    np.testing.assert_allclose(got["ppxdp"].numpy(), want.numpy(),
                               atol=1e-6, rtol=0)


def _ok_lines(out):
    return [line for line in out.splitlines()
            if line.startswith("dryrun_multichip(4)") and
            line.endswith("OK")]


def test_dryrun_multichip_on_four_cpu_ranks(capfd):
    """At embed 128 (2 heads of 64), depth 8 + 4, bf16: the train step on
    data 2 × model 2 with sequence parallelism and FSDP, serving on that
    mesh, and GPipe at 2 stages × data 2."""
    dryrun_multichip(4, device="cpu", embed_dim=128)
    lines = _ok_lines(capfd.readouterr().out)
    assert len(lines) == 3, lines
    assert "train OK" in lines[0] and "'model': 2" in lines[0]
    assert "GPipe" in lines[2]


@pytest.mark.slow
def test_dryrun_multichip_flagship_width_on_four_cpu_ranks(capfd):
    dryrun_multichip(4, device="cpu")
    assert len(_ok_lines(capfd.readouterr().out)) == 3
