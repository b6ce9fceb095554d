"""PyTorch/CUDA port of NPVP-TPU for NVIDIA Hopper.

The JAX package ``npvp_tpu`` beside it is the reference: each module here
holds the same math on the same parameters (carried across by
``npvp_tpu_torch.tools.weights``), and the TPU kernel of its serving path is
a hand-written CUDA kernel (``npvp_tpu_torch.kernels``). Ported so far: the
serving path (``VideoPredictor``), the stage-1 and stage-2 trainers
(``npvp_tpu_torch.train``) with their SMMNIST data, and the evaluation
(``npvp_tpu_torch.eval``) and inference CLIs. This package imports torch
and nothing of jax or ``npvp_tpu``.
"""

from npvp_tpu_torch.core.config import (Config, flagship_config,  # noqa: F401
                                        load_config)
from npvp_tpu_torch.models.inference import VideoPredictor  # noqa: F401
