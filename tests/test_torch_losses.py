"""The port's exported losses and sine position encodings against the JAX
package, fp32 on the CPU: ``mse_loss``, ``gdl_loss``,
``temporal_diff_loss`` and ``bi_patch_nce_loss`` (values rtol 1e-5, their
gradients in both inputs against ``jax.grad`` at atol 1e-6 · the largest
element; the patch-NCE's negatives carry no gradient in either), and the
1-D, 2-D and 3-D encodings (atol 1e-5: sines of arguments up to ~2π·10⁴
ulps apart)."""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from npvp_tpu_torch.nn import losses as tls  # noqa: E402
from npvp_tpu_torch.nn import position_encoding as tpe  # noqa: E402


def _pair(shape, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape).astype(np.float32),
            rng.standard_normal(shape).astype(np.float32))


CASES = {
    "mse": (lambda m: m.mse_loss, {}),
    "mse_weighted": (lambda m: m.mse_loss, {"temporal_weight": "w"}),
    "gdl": (lambda m: m.gdl_loss, {}),
    "gdl_alpha2": (lambda m: m.gdl_loss, {"alpha": 2.0}),
    "temporal_diff": (lambda m: m.temporal_diff_loss, {"shift": 1}),
    "temporal_diff_back": (lambda m: m.temporal_diff_loss,
                           {"shift": -2, "lam": 0.5}),
    "bi_patch_nce": (lambda m: m.bi_patch_nce_loss, {}),
    "bi_patch_nce_t": (lambda m: m.bi_patch_nce_loss,
                       {"temperature": 0.5, "lam": 2.0}),
}


@pytest.mark.parametrize("name", list(CASES))
def test_loss_and_gradients_match_jax(name):
    from npvp_tpu.nn import losses as jls

    pick, kw = CASES[name]
    a, b = _pair((2, 3, 4, 5, 6), seed=len(name))
    weight = np.array([0.5, 1.0, 2.0], np.float32)
    jkw = {k: (jnp.asarray(weight) if v == "w" else v)
           for k, v in kw.items()}
    tkw = {k: (torch.from_numpy(weight) if v == "w" else v)
           for k, v in kw.items()}
    want, (ga, gb) = jax.value_and_grad(
        lambda x, y: pick(jls)(x, y, **jkw), argnums=(0, 1))(
            jnp.asarray(a), jnp.asarray(b))
    ta = torch.from_numpy(a).requires_grad_(True)
    tb = torch.from_numpy(b).requires_grad_(True)
    got = pick(tls)(ta, tb, **tkw)
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    for g, w in ((ta.grad, ga), (tb.grad, gb)):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w,
                                   atol=1e-6 * max(1.0, np.abs(w).max()))


@pytest.mark.parametrize("kw", [{}, {"normalize": True}, {
    "num_pos_feats": 10, "temperature": 100.0, "normalize": True,
    "scale": 3.0}])
def test_sine_position_encodings_match_jax(kw):
    from npvp_tpu.nn import position_encoding as jpe

    pairs = [(jpe.sine_position_encoding_1d, tpe.sine_position_encoding_1d,
              (10,)),
             (jpe.sine_position_encoding_2d, tpe.sine_position_encoding_2d,
              (8, 6)),
             (jpe.sine_position_encoding_3d, tpe.sine_position_encoding_3d,
              (4, 8, 6))]
    for jf, tf, args in pairs:
        want = np.asarray(jf(*args, **kw))
        got = tf(*args, **kw)
        assert got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5,
                                   err_msg=jf.__name__)
