"""The port's FVD pipeline against the JAX package's, fp32 on the CPU:
``preprocess_videos`` (atol 1e-5), the I3D's features from one set of
random flax variables through the weight bridge on a small odd-sized clip
(rtol 1e-4, atol 1e-4), ``frechet_distance`` (1e-9), and the checkpoint
reader."""

import pickle

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from _torch_helpers import random_variables  # noqa: E402

from npvp_tpu_torch.eval import fvd as tfvd  # noqa: E402
from npvp_tpu_torch.eval.i3d import InceptionI3d  # noqa: E402
from npvp_tpu_torch.tools.weights import load_flax  # noqa: E402


@pytest.mark.parametrize("shape", [(2, 3, 20, 30, 1), (1, 2, 64, 48, 3),
                                   (1, 2, 224, 224, 3)])
def test_preprocess_matches_jax(shape):
    from npvp_tpu.eval.fvd import preprocess_videos

    videos = np.random.default_rng(0).uniform(0, 1, shape).astype(np.float32)
    want = np.asarray(preprocess_videos(videos))
    got = tfvd.preprocess_videos(videos)
    assert tuple(got.shape) == want.shape == shape[:2] + (224, 224, 3)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


@pytest.fixture(scope="module")
def i3d_vars():
    from npvp_tpu.eval.i3d import InceptionI3d as JaxI3d

    x = np.random.default_rng(1).uniform(-1, 1, (2, 5, 37, 29, 3)).astype(
        np.float32)
    model = JaxI3d(dtype=jnp.float32)
    variables = random_variables(model.init, jax.random.key(0), x, seed=70)
    return model, variables, x


def test_i3d_features_match_jax(i3d_vars):
    """Every TF-SAME pad of the network is asymmetric somewhere on a
    5 × 37 × 29 clip; the head's pooling window shrinks to the 1 × 2 × 1
    volume left."""
    model, variables, x = i3d_vars
    want = np.asarray(jax.jit(model.apply)(variables, x))
    port = load_flax(InceptionI3d(), variables).eval()
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, 400)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_fvd_reads_a_converted_checkpoint(i3d_vars, tmp_path):
    _, variables, x = i3d_vars
    (tmp_path / "i3d.pkl").write_bytes(pickle.dumps(variables))
    fvd = tfvd.FVD.from_checkpoint(tmp_path / "i3d.pkl", torch.float32,
                                   device="cpu")
    videos = (x[:, :3, :16, :16] + 1) / 2
    feats = fvd.features(videos, batch_size=1)
    with torch.no_grad():
        want = fvd.model(tfvd.preprocess_videos(videos)).numpy()
    np.testing.assert_allclose(feats, want, rtol=1e-5, atol=1e-5)
    assert fvd(videos, videos) == pytest.approx(0.0, abs=1e-3)
    with pytest.raises(ValueError, match=".pkl"):
        tfvd.FVD.from_checkpoint(tmp_path / "i3d.npz", device="cpu")
    rand = tfvd.FVD(torch.float32, device="cpu").init_random(3)
    assert np.isfinite(rand.features(videos)).all()


def test_frechet_distance_matches_jax():
    from npvp_tpu.eval.fvd import frechet_distance

    rng = np.random.default_rng(2)
    a = rng.standard_normal((40, 12))
    b = rng.standard_normal((40, 12)) * 1.3 + 0.2
    assert tfvd.frechet_distance(a, b) == pytest.approx(
        frechet_distance(a, b), rel=1e-9, abs=1e-9)
    assert tfvd.frechet_distance(a, a) == pytest.approx(0.0, abs=1e-9)
