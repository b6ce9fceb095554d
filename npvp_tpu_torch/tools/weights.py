"""Flax variables ↔ the port's modules, the weights archive's reader and
writer, and the port's random init.

A flax variable tree is a nested dict ``{"params": ..., "batch_stats": ...}``
of numpy arrays, as ``npvp_tpu`` models produce and as the committed weights
archives store it (``npvp_tpu/tools/export_weights.py``: keys
``vars/{ae,pred}/{params,batch_stats}/<module path>/<leaf>``). The port's
modules carry the flax submodule names, so a module's dotted path is its
flax path; the layouts are the inverse of
``npvp_tpu/tools/torch_converter.py``:

- ``nn.Conv2d``: kernel HWIO → weight OIHW (depthwise kernels too);
- ``nn.Conv1d`` (the AE's ``temporal_conv``): kernel WIO → weight OIW;
- ``nn.Conv3d`` (the I3D of FVD): kernel DHWIO → weight OIDHW;
- ``nn.ConvTranspose2d``: kernel (kh, kw, O, I) → weight (I, O, kh, kw);
- ``nn.Linear``: Dense (I, O), DenseGeneral (C, H, D) / (H, D, C) and 1×1
  conv (1, 1, I, O) kernels → weight (O, I); bias flattened;
- BatchNorm: scale/bias → weight/bias, batch_stats mean/var →
  running_mean/running_var;
- LayerNorms: scale/bias → weight/bias, (H, W, C) kept as it is;
- any other parameter (NRMLP ``B``, the attention gate ``gamma``) by name.

:func:`save_weights` writes the modules back in that format, so that the
JAX package's ``load_weights`` and ``VideoPredictor.from_weights`` read
the archive unchanged.
"""

from __future__ import annotations

import json
import re
from pathlib import Path
from typing import Dict, Iterable, Optional, Tuple

import numpy as np
import torch
from torch import nn

from npvp_tpu_torch.core.checkpoint import load_model_state
from npvp_tpu_torch.nn.layers import (BatchNorm, LayerNormHWC,
                                      MultiHeadAttention, TokenLayerNorm)
from npvp_tpu_torch.nn.neural_process import NRMLP
from npvp_tpu_torch.nn.resnet_ae import (NonLocalAttention1D,
                                         NonLocalAttention2D)
from npvp_tpu_torch.nn.vidhrformer import MlpDWBN

SEP = "/"
META_KEY = "__meta__"
# a block of a VidHRFormer stack in an archive: a config of smaller depth
# serves the archive without it, as flax ignores the unused parameters
_STACK_LAYER = re.compile(r"^(evt_former_stack|decoder)/layer_(\d+)/")
_F16_MAX = 60000.0  # stay clear of float16 inf (65504), as the JAX writer


def unflatten(flat: Dict[str, np.ndarray]) -> dict:
    tree: dict = {}
    for path, value in flat.items():
        node = tree
        *parents, leaf = path.split(SEP)
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = value
    return tree


def load_weights(path) -> Tuple[dict, dict, dict]:
    """Read a weights archive → (ae_vars, pred_vars, meta); floats come back
    float32 (the reader of ``npvp_tpu/tools/export_weights.py``)."""
    with np.load(path) as data:
        meta = json.loads(bytes(data[META_KEY])) if META_KEY in data else {}
        flat = {}
        for key in data.files:
            if key == META_KEY:
                continue
            v = data[key]
            if v.dtype in (np.float16, np.float64):
                v = v.astype(np.float32)
            flat[key] = v
    tree = unflatten(flat).get("vars", {})
    halves = [{k: tree.get(h, {}).get(k, {}) for k in ("params", "batch_stats")}
              for h in ("ae", "pred")]
    return halves[0], halves[1], meta


def _leaves(module: nn.Module, params: dict, stats: dict):
    """(torch name, flax path below the module, value) of one module's
    parameters and buffers."""
    if isinstance(module, (nn.Conv2d, nn.ConvTranspose2d)):
        yield "weight", "kernel", params["kernel"].transpose(3, 2, 0, 1)
        if module.bias is not None:
            yield "bias", "bias", params["bias"]
    elif isinstance(module, nn.Conv3d):
        yield "weight", "kernel", params["kernel"].transpose(4, 3, 0, 1, 2)
        if module.bias is not None:
            yield "bias", "bias", params["bias"]
    elif isinstance(module, nn.Conv1d):
        yield "weight", "kernel", params["kernel"].transpose(2, 1, 0)
        yield "bias", "bias", params["bias"]
    elif isinstance(module, nn.Linear):
        yield "weight", "kernel", params["kernel"].reshape(
            module.in_features, module.out_features).T
        yield "bias", "bias", params["bias"].reshape(-1)
    elif isinstance(module, (BatchNorm, TokenLayerNorm, LayerNormHWC)):
        yield "weight", "scale", params["scale"]
        yield "bias", "bias", params["bias"]
        if isinstance(module, BatchNorm):
            yield "running_mean", "mean", stats["mean"]
            yield "running_var", "var", stats["var"]
    else:
        for name in module._parameters:
            yield name, name, params[name]


def _subtree(tree: dict, path: Iterable[str]):
    node = tree
    for p in path:
        node = node.get(p, {}) if isinstance(node, dict) else {}
    return node


def _flat_keys(tree: dict, prefix: str = "") -> list:
    out = []
    for k, v in tree.items():
        if isinstance(v, dict):
            out += _flat_keys(v, f"{prefix}{k}/")
        else:
            out.append(f"{prefix}{k}")
    return out


def _beyond_depth(module: nn.Module, key: str) -> bool:
    """Whether flax leaf ``key`` lies in a trailing block of a VidHRFormer
    stack that ``module`` holds at a smaller depth: ``evt_former_stack/
    layer_{k}`` or ``decoder/layer_{k}`` with k at or past the stack's
    ``num_layers``."""
    m = _STACK_LAYER.match(key)
    if m is None:
        return False
    depth = getattr(getattr(module, m.group(1), None), "num_layers", None)
    return isinstance(depth, int) and int(m.group(2)) >= depth


def load_flax(module: nn.Module, variables: dict,
              ignore: Tuple[str, ...] = ()) -> nn.Module:
    """Copy flax ``variables`` into ``module`` in place.

    Raises if a parameter or buffer of ``module`` finds no flax value, if a
    shape differs, or if a flax leaf is left over outside the module paths
    in ``ignore`` (subtrees this module does not hold) and outside the
    trailing blocks of a stack that ``module`` holds at a smaller depth
    (a depth-cut config serving a full archive, as flax serves it)."""
    params = variables.get("params", {})
    stats = variables.get("batch_stats", {})
    own = module.state_dict()
    used = set()
    for name, mod in module.named_modules():
        if not list(mod.parameters(recurse=False)) and not list(
                mod.buffers(recurse=False)):
            continue
        path = name.split(".") if name else []
        base = "/".join(path + [""])
        try:
            leaves = list(_leaves(mod, _subtree(params, path),
                                  _subtree(stats, path)))
        except KeyError as e:
            raise KeyError(f"flax variables hold no {e} for module "
                           f"'{name}'") from None
        for leaf, flax_leaf, value in leaves:
            key = f"{name}.{leaf}" if name else leaf
            value = np.asarray(value, np.float32)
            if tuple(own[key].shape) != value.shape:
                raise ValueError(f"{key}: flax value {value.shape} does not "
                                 f"fit {tuple(own[key].shape)}")
            own[key] = torch.from_numpy(value.copy())
            used.add(key)
            used.add(base + flax_leaf)
    missing = set(own) - used
    if missing:
        raise KeyError(f"no flax value for {sorted(missing)[:5]}")
    module.load_state_dict(own)
    leftover = [k for k in _flat_keys(params) + _flat_keys(stats)
                if not k.startswith(ignore) and k not in used
                and not _beyond_depth(module, k)]
    if leftover:
        raise KeyError(f"flax leaves not used by the module: {leftover[:5]}")
    return module


def random_init(module: nn.Module, seed: int = 0) -> nn.Module:
    """Random weights from ``seed`` with the flax initialisers' scales:
    LeCun-normal kernels, zero biases, unit norm scales, identity running
    statistics, NRMLP ``B`` ~ N(0, scale²) and zero attention gates."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for mod in module.modules():
            if isinstance(mod, (nn.Conv1d, nn.Conv2d, nn.ConvTranspose2d,
                                nn.Conv3d, nn.Linear)):
                w = mod.weight
                w.copy_(torch.randn(w.shape, generator=gen)
                        / np.sqrt(w[0].numel()))
                if mod.bias is not None:
                    mod.bias.zero_()
            elif isinstance(mod, (BatchNorm, TokenLayerNorm, LayerNormHWC)):
                mod.weight.fill_(1.0)
                mod.bias.zero_()
            if isinstance(mod, BatchNorm):
                mod.running_mean.zero_()
                mod.running_var.fill_(1.0)
            if isinstance(mod, NRMLP):
                mod.B.copy_(torch.randn(mod.B.shape, generator=gen)
                            * mod.scale)
            if isinstance(mod, (NonLocalAttention1D, NonLocalAttention2D)):
                mod.gamma.zero_()
    return module


def load_trained(module: nn.Module, src, half: str) -> nn.Module:
    """Load trained weights into ``module`` in place: a weights archive
    (``.npz``, its ``half`` "ae" or "pred") through the flax bridge, else a
    port checkpoint directory (its latest step) or file."""
    if str(src).endswith(".npz"):
        ae_vars, pred_vars, _ = load_weights(src)
        return load_flax(module, ae_vars if half == "ae" else pred_vars)
    module.load_state_dict(load_model_state(src))
    return module


def _linear_kernel(parent: Optional[nn.Module], child: str,
                   layer: nn.Linear) -> np.ndarray:
    """An ``nn.Linear`` weight as the flax kernel it came from: DenseGeneral
    (C, H, D) for the attention's q/k/v and (H, D, C) for its output, a
    1×1 conv (1, 1, I, O) in MlpDWBN, Dense (I, O) elsewhere."""
    w = layer.weight.detach().cpu().numpy().T
    if isinstance(parent, MultiHeadAttention):
        H = parent.num_heads
        return (w.reshape(H, -1, w.shape[1]) if child == "wo"
                else w.reshape(w.shape[0], H, -1))
    if isinstance(parent, MlpDWBN):
        return w.reshape((1, 1) + w.shape)
    return w


def _linear_bias(parent, child, layer) -> np.ndarray:
    b = layer.bias.detach().cpu().numpy()
    if isinstance(parent, MultiHeadAttention) and child != "wo":
        return b.reshape(parent.num_heads, -1)
    return b


def to_flax(module: nn.Module) -> dict:
    """The inverse of :func:`load_flax`: the module's parameters and
    running statistics as a flax variable tree ``{"params": ...,
    "batch_stats": ...}`` of float32 numpy arrays, in flax's names and
    layouts."""
    out = {"params": {}, "batch_stats": {}}
    np_ = lambda t: t.detach().cpu().numpy().astype(np.float32)  # noqa

    def put(collection, path, leaf, value):
        node = out[collection]
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = np.asarray(value, np.float32)

    for name, mod in module.named_modules():
        if not list(mod.parameters(recurse=False)):
            continue
        path = name.split(".") if name else []
        parent = (module.get_submodule(".".join(path[:-1])) if path
                  else None)
        child = path[-1] if path else ""
        if isinstance(mod, (nn.Conv1d, nn.Conv2d, nn.ConvTranspose2d,
                            nn.Conv3d)):
            w = np_(mod.weight)
            put("params", path, "kernel",
                w.transpose(tuple(range(2, w.ndim)) + (1, 0)))
            if mod.bias is not None:
                put("params", path, "bias", np_(mod.bias))
        elif isinstance(mod, nn.Linear):
            put("params", path, "kernel", _linear_kernel(parent, child, mod))
            put("params", path, "bias", _linear_bias(parent, child, mod))
        elif isinstance(mod, (BatchNorm, TokenLayerNorm, LayerNormHWC)):
            put("params", path, "scale", np_(mod.weight))
            put("params", path, "bias", np_(mod.bias))
            if isinstance(mod, BatchNorm):
                put("batch_stats", path, "mean", np_(mod.running_mean))
                put("batch_stats", path, "var", np_(mod.running_var))
        else:
            for leaf, value in mod.named_parameters(recurse=False):
                put("params", path, leaf, np_(value))
    return out


def _flatten(tree, prefix: str, out: Dict[str, np.ndarray]):
    if isinstance(tree, dict):
        for k, v in tree.items():
            _flatten(v, f"{prefix}{SEP}{k}", out)
    else:
        out[prefix] = np.asarray(tree)


def save_weights(path, ae: Optional[nn.Module],
                 predictor: Optional[nn.Module],
                 meta: Optional[dict] = None) -> None:
    """Write the AE and the predictor (either may be None: an AE-only
    archive) to one compressed ``.npz`` in the JAX package's format: keys
    ``vars/{ae,pred}/{params,batch_stats}/<flax path>``, float16 where
    every value's magnitude is below 60000 (else float32), and ``meta`` as
    JSON bytes under ``__meta__``."""
    halves = {h: (to_flax(m) if m is not None else {})
              for h, m in (("ae", ae), ("pred", predictor))}
    flat: Dict[str, np.ndarray] = {}
    _flatten(halves, "vars", flat)
    stored = {}
    for k, v in flat.items():
        if v.dtype in (np.float32, np.float64):
            v = v.astype(np.float32)
            if np.abs(v).max(initial=0.0) < _F16_MAX:
                v = v.astype(np.float16)
        stored[k] = v
    stored[META_KEY] = np.frombuffer(json.dumps(meta or {}).encode(),
                                     dtype=np.uint8)
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(path, **stored)


def warm_start_state(state, npz_path, which: str):
    """Adopt a weights archive's ``which`` half ("ae" or "pred") into a
    train state in place: its parameters and statistics, and its saved
    step (``<which>_step`` of the meta, so the epoch count derives from
    it); the optimizer's moments stay fresh, since the archive holds none.
    Raises ``ValueError`` naming the leaf when a shape differs."""
    ae_vars, pred_vars, meta = load_weights(npz_path)
    try:
        load_flax(state.model, ae_vars if which == "ae" else pred_vars)
    except (KeyError, ValueError) as e:
        raise ValueError(f"weights artifact {npz_path}: '{which}': {e} — "
                         "config mismatch?") from None
    state.step = int(meta.get(f"{which}_step", 0))
    return state
