"""The benchmark of the PyTorch and CUDA port of NPVP (``npvp_tpu_torch``)."""
