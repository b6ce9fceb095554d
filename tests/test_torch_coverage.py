"""Every public name of the JAX package has its counterpart in the port.

For each module of ``npvp_tpu/`` (read with ``ast``, never imported, so the
test needs no JAX) its public module-level functions, classes and
constants and the public methods of its public classes are listed; each
must be bound by the module of the same path in ``npvp_tpu_torch/`` (defined
or imported there; a method defined in the class of the same name), or
have an entry below: the name of its counterpart, or one line on why it is
not ported. Functions nested in other functions are not listed; the table
still records the exceptions among them. A second case fails on a stale
entry: one that names something that no longer exists in either package,
or a name that now has its counterpart of the same name.
"""

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
JAX, PORT = ROOT / "npvp_tpu", ROOT / "npvp_tpu_torch"

# JAX modules with no module of the same path in the port
MODULES = {
    "core/chip_lock.py": "not ported: the TPU chip-yield protocol between "
                         "bench.py and tools/supervise.sh; a card has "
                         "nothing to yield",
    "core/mesh.py": ("core/distributed.py", "core/tensor_parallel.py",
                     "core/sequence_parallel.py"),
}

# (JAX module, name) → "port module:name" of its counterpart
RENAMED = {
    ("core/mesh.py", "DATA_AXIS"): "core/distributed.py:DATA_AXIS",
    ("core/mesh.py", "MODEL_AXIS"): "core/distributed.py:MODEL_AXIS",
    ("core/mesh.py", "make_mesh"): "core/distributed.py:make_mesh",
    ("core/mesh.py", "batch_sharding"): "core/distributed.py:shard_batch",
    ("core/mesh.py", "shard_batch"): "core/distributed.py:shard_batch",
    ("core/mesh.py", "param_spec"): "core/tensor_parallel.py:param_split",
    ("core/mesh.py", "tree_shardings"):
        "core/tensor_parallel.py:tensor_parallel_plan",
    ("core/mesh.py", "param_shardings"):
        "core/tensor_parallel.py:tensor_parallel_plan",
    ("core/mesh.py", "shard_params"):
        "core/tensor_parallel.py:shard_tensor_parallel",
    ("core/mesh.py", "shard_state"): "train/common.py:parallelize_state",
    ("core/mesh.py", "sequence_parallel"):
        "core/sequence_parallel.py:sequence_parallel",
    ("core/mesh.py", "enable_sequence_parallel"):
        "core/sequence_parallel.py:enable_sequence_parallel",
    ("core/mesh.py", "sp_shard"): "core/sequence_parallel.py:split_h",
    ("core/metrics.py", "is_main_process"):
        "core/distributed.py:is_main_process",
    ("core/train_state.py", "TrainState.variables"):
        "core/train_state.py:TrainState.state_dict",
    ("models/predictor.py", "NPPredictor.setup"):
        "models/predictor.py:NPPredictor.__init__",
    ("nn/resnet_ae.py", "FrameAutoEncoder.setup"):
        "nn/resnet_ae.py:FrameAutoEncoder.__init__",
    ("nn/quant.py", "QuantDense"): "nn/layers.py:linear",
    ("tools/export_weights.py", "warm_start_state"):
        "tools/weights.py:warm_start_state",
    ("tools/export_weights.py", "SEP"): "tools/weights.py:SEP",
    ("tools/export_weights.py", "META_KEY"): "tools/weights.py:META_KEY",
    ("train/common.py", "maybe_init_distributed"):
        "core/distributed.py:maybe_init_distributed",
    ("train/common.py", "maybe_start_profiler"):
        "train/common.py:StepProfiler.maybe_start_profiler",
    ("train/common.py", "stop_profiler"):
        "train/common.py:StepProfiler.stop_profiler",
}

_STACKED = ("JAX-only stacked dispatch (lax.scan over K placed batches); "
            "the port's train_chunks and run_train_chunk replace it")

# (JAX module, name) → why it is not ported
NOT_PORTED = {
    ("core/mesh.py", "FSDP_MIN_SIZE"): "XLA's layout rule: leaves below it "
                                       "stay whole; FSDP2 shards every leaf",
    ("core/mesh.py", "replicated"): "a NamedSharding; the port's tensors "
                                    "are whole on every rank unless split",
    ("core/metrics.py", "StepTimer"): "unused: referenced nowhere",
    ("core/metrics.py", "StepTimer.start"): "unused: referenced nowhere",
    ("core/metrics.py", "StepTimer.stop"): "unused: referenced nowhere",
    ("core/metrics.py", "StepTimer.summary"): "unused: referenced nowhere",
    ("core/metrics.py", "AverageMeters.reset"): "unused: the trainers make "
                                                "new meters each epoch",
    ("core/optim.py", "global_norm"): "unused (optax.global_norm); the "
                                      "port's clip computes its own norm",
    ("core/train_state.py", "TrainState.create"): "flax's constructor; the "
                                                  "port's is a dataclass",
    ("nn/layers.py", "LEGACY_NORMS"): "A/B instrumentation of a TPU probe, "
                                      "read only by the root tools/ab_train.py",
    ("kernels/temporal_attention.py", "BLOCK_SITES"):
        "Mosaic's site tile; the CUDA kernel tiles 64 rows in its source",
    ("kernels/temporal_attention.py", "PACK_LANES"):
        "the TPU's 128 lanes that sites are packed into; not a GPU layout",
    ("kernels/temporal_attention.py", "FUSE_OPROJ"):
        "not ported as a switch: the call sites always fuse; the "
        "attention-only kernel stays reachable with `wo=None`",
    ("train/stage1_ae.py", "make_steps.train_multi"): _STACKED,
    ("train/stage1_ae.py", "make_steps.eval_multi"): _STACKED,
    ("train/stage1_ae.py", "make_steps.place_stack"): _STACKED,
    ("train/stage1_ae.py", "make_steps.train_multi_placed"): _STACKED,
    ("train/stage1_ae.py", "make_steps.eval_multi_placed"): _STACKED,
    ("train/stage2_predictor.py", "make_steps.train_multi"): _STACKED,
    ("train/stage2_predictor.py", "make_steps.eval_multi"): _STACKED,
    ("train/stage2_predictor.py", "make_steps.place_stack"): _STACKED,
}


def _tree(path: Path) -> ast.Module:
    return ast.parse(path.read_text(), str(path))


def _bound(body):
    """Name → node of what ``body`` binds: defs, classes, assignments and
    imports."""
    out = {}
    for node in body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            out[node.name] = node
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = (node.targets if isinstance(node, ast.Assign)
                       else [node.target])
            out.update((t.id, node) for t in targets
                       if isinstance(t, ast.Name))
        elif isinstance(node, (ast.Import, ast.ImportFrom)):
            out.update(((a.asname or a.name).split(".")[0], node)
                       for a in node.names)
    return out


def public_names(path: Path) -> set:
    """The names this test holds for a JAX module: public module-level
    functions, classes and constants, and the public methods of public
    classes, as ``name`` or ``Class.method``."""
    names = set()
    for node in _tree(path).body:
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            continue
        for name in _bound([node]):
            if name.startswith("_"):
                continue
            names.add(name)
            if isinstance(node, ast.ClassDef):
                names.update(f"{name}.{m}" for m, sub in _bound(
                    node.body).items() if not m.startswith("_")
                    and isinstance(sub, (ast.FunctionDef,
                                         ast.AsyncFunctionDef)))
    return names


def resolves(path: Path, dotted: str) -> bool:
    """Whether module ``path`` binds ``dotted``: a module-level name, then
    each further part bound somewhere inside the node before it."""
    if not path.exists():
        return False
    first, *rest = dotted.split(".")
    node = _bound(_tree(path).body).get(first)
    for part in rest:
        if node is None:
            return False
        node = next((n for inner in ast.walk(node) if inner is not node
                     for name, n in _bound([inner]).items() if name == part),
                    None)
    return node is not None


def _rel(path: Path) -> str:
    return path.relative_to(JAX).as_posix()


JAX_MODULES = sorted(_rel(p) for p in JAX.rglob("*.py"))


def _counterpart(target: str) -> bool:
    module, name = target.split(":")
    return resolves(PORT / module, name)


@pytest.mark.parametrize("module", JAX_MODULES)
def test_every_public_name_has_a_counterpart(module):
    names = public_names(JAX / module)
    if module in MODULES:
        successors = MODULES[module]
        assert not (PORT / module).exists(), f"{module} is in the port now"
        if isinstance(successors, str):  # not ported, with the reason
            return
        assert all((PORT / s).exists() for s in successors), successors
    missing = []
    for name in sorted(names):
        key = (module, name)
        if key in RENAMED:
            if not _counterpart(RENAMED[key]):
                missing.append(f"{name} → {RENAMED[key]} (absent)")
        elif key not in NOT_PORTED and not resolves(PORT / module, name):
            missing.append(name)
    assert not missing, (
        f"npvp_tpu/{module}: no counterpart in npvp_tpu_torch/{module} and "
        f"no entry in this test's tables for {missing}")


def test_no_stale_entry():
    stale = [m for m in MODULES if not (JAX / m).exists()]
    for (module, name), why in [*RENAMED.items(), *NOT_PORTED.items()]:
        if not resolves(JAX / module, name):
            stale.append(f"{module}:{name} is not in npvp_tpu")
        elif module not in MODULES and resolves(PORT / module, name):
            stale.append(f"{module}:{name} has its counterpart of the same "
                         "name; the entry is not needed")
        elif (module, name) in RENAMED and not _counterpart(why):
            stale.append(f"{module}:{name} → {why} is not in the port")
    assert not stale, stale
