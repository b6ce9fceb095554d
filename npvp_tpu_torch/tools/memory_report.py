"""Per-rank train-state memory under the parallel layouts (port of the JAX
package's root ``tools/memory_report.py``).

Computes, without allocating (the predictor built on the ``meta``
device), the bytes a rank holds of the flagship stage-2 train state
(``core.config.flagship_config()``, 8 decoder + 4 EVT-former layers):
the parameters, AdamW's two moments (they take each parameter's layout)
and the BatchNorms' running statistics, under

- replicated data parallelism (DDP);
- tensor parallelism over ``model`` (``core.tensor_parallel``'s plan:
  heads and FFN widths split where the model axis divides them);
- FSDP over ``data`` (``core.distributed.wrap_data_parallel``: FSDP2
  shards every parameter of one or more dimensions on its first
  dimension, padded to a multiple of the axis; 0-d parameters and the
  running statistics stay whole);
- both.

The JAX package's FSDP rule differs: it shards only leaves of at least
2^15 elements, on their largest free dimension that the axis divides, so
its FSDP rows are not this tool's.

    python -m npvp_tpu_torch.tools.memory_report [--data 4] [--model 2] \\
        [--device cpu]

On a card it prints the card's memory beside the rows.
"""

from __future__ import annotations

import argparse
import math
import sys

import torch

from npvp_tpu_torch.core.config import flagship_config
from npvp_tpu_torch.core.device import resolve_device
from npvp_tpu_torch.core.tensor_parallel import tensor_parallel_plan
from npvp_tpu_torch.models.predictor import build_predictor
from npvp_tpu_torch.tools._cli import add_run_args

# AdamW's per-parameter moments (exp_avg, exp_avg_sq), in the parameter's
# layout and dtype
MOMENTS = 2


def _shard_bytes(shape, itemsize: int, tp_dim, model: int, fsdp: int):
    """Bytes one rank holds of a tensor of ``shape``: its tensor-parallel
    slice on ``tp_dim`` (None: whole), then its FSDP shard of dimension 0
    over ``fsdp`` ranks (1: whole)."""
    shape = list(shape)
    if tp_dim is not None:
        shape[tp_dim] //= model
    if fsdp > 1 and shape:
        shape[0] = math.ceil(shape[0] / fsdp)
    return math.prod(shape) * itemsize


def state_bytes(predictor, data: int, model: int, fsdp: bool, tp: bool):
    """Per-rank bytes of ``predictor``'s train state in one layout."""
    plan = tensor_parallel_plan(predictor, model) if tp and model > 1 else {}
    total = 0
    for name, p in predictor.named_parameters():
        total += (1 + MOMENTS) * _shard_bytes(
            p.shape, p.element_size(), plan.get(name), model,
            data if fsdp else 1)
    for _, b in predictor.named_buffers():
        total += b.numel() * b.element_size()
    return total


def rows(data: int, model: int):
    """[(layout, MB a rank)] of the flagship stage-2 train state."""
    cfg = flagship_config()
    with torch.device("meta"):
        predictor = build_predictor(cfg, torch.bfloat16)
    mb = lambda **kw: state_bytes(predictor, data, model, **kw) / 2**20  # noqa
    return [("replicated (plain DP)", mb(fsdp=False, tp=False)),
            (f"TP over model={model}", mb(fsdp=False, tp=True)),
            (f"FSDP over data={data}", mb(fsdp=True, tp=False)),
            ("TP + FSDP", mb(fsdp=True, tp=True))]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--data", type=int, default=4)
    ap.add_argument("--model", type=int, default=2)
    add_run_args(ap, out_dir=False)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    print(f"flagship stage-2 train state, mesh data={args.data} "
          f"model={args.model}:")
    for name, mb in rows(args.data, args.model):
        print(f"  {name:<24} {mb:8.1f} MB/device")
    if device.type == "cuda":
        total = torch.cuda.get_device_properties(device).total_memory
        print(f"  ({torch.cuda.get_device_name(device)}: "
              f"{total / 2**20:.1f} MB)")


if __name__ == "__main__":
    main(sys.argv[1:])
