"""PyTorch/CUDA port of NPVP-TPU for NVIDIA Hopper.

The JAX package ``npvp_tpu`` beside it is the reference: each module here
holds the same math on the same parameters (carried across by
``npvp_tpu_torch.tools.weights``), and the TPU kernel of its serving path is
a hand-written CUDA kernel (``npvp_tpu_torch.kernels``). Ported so far: the
serving path (``VideoPredictor``), the stage-1 and stage-2 trainers
(``npvp_tpu_torch.train``), the evaluation (``npvp_tpu_torch.eval``) and
inference CLIs, and the data of every shipped config
(``npvp_tpu_torch.data``). This package imports torch and nothing of jax
or ``npvp_tpu``.

The names below load on first use, so that the data loader's worker
processes, which import only ``npvp_tpu_torch.data``, start without torch.
"""


def __getattr__(name):
    if name in ("Config", "flagship_config", "load_config"):
        from npvp_tpu_torch.core import config

        return getattr(config, name)
    if name == "VideoPredictor":
        from npvp_tpu_torch.models.inference import VideoPredictor

        return VideoPredictor
    raise AttributeError(f"module 'npvp_tpu_torch' has no attribute {name!r}")
