"""The port's asynchronous checkpoint writer (``npvp_tpu_torch/core/
checkpoint.py``) against the JAX package's Orbax manager and on its own:

- the steps that ``save`` starts, keeps and ranks best, against JAX's
  ``CheckpointManager`` on one sequence of steps and metrics, at
  ``save_interval_steps`` 1 and 3, with ``monitor`` 'min', 'max' and none;
- the file holds the state as it was at ``save``, however the state
  changes while the write is in flight;
- a write that raises is raised again at the next ``wait``, ``save`` or
  ``close``; reads wait for the write in flight;
- two gloo ranks over a fully sharded state: only the writer writes, every
  rank sees the same steps, and the file restores in one process;
- both trainers leave whole files behind when a step raises partway.
"""

import threading

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402
from _torch_parallel import checkpoint_scenario, spawn  # noqa: E402
from test_torch_stage1 import _trainer_cfg as stage1_cfg  # noqa: E402
from test_torch_train import _trainer_cfg as stage2_cfg  # noqa: E402

from npvp_tpu_torch.core import checkpoint as ck  # noqa: E402
from npvp_tpu_torch.core.train_state import TrainState  # noqa: E402
from npvp_tpu_torch.train import stage1_ae as s1  # noqa: E402
from npvp_tpu_torch.train import stage2_predictor as s2  # noqa: E402

# (step, metric) offered in this order: skipped steps, a repeated step, a
# step below the latest, a step the retention drops at once
OFFERS = [(0, 5.0), (1, 3.0), (2, 1.0), (3, 2.0), (4, 0.5), (5, 9.0),
          (6, 0.7), (7, 8.0), (9, 0.1), (9, 0.2), (8, 0.0), (12, 4.0)]
CASES = [(interval, monitor, mode) for interval in (1, 3)
         for monitor, mode in ((None, "min"), ("loss", "min"),
                               ("loss", "max"))]


class Holder:
    """A state: ``state_dict`` returns ``tree`` as it stands."""

    def __init__(self, tree):
        self.tree = tree

    def state_dict(self):
        return self.tree


def _offer(mngr, state, kept):
    started = [mngr.save(step, state(step), {"loss": loss})
               for step, loss in OFFERS]
    mngr.wait()
    return started, kept(), mngr.latest_step(), mngr.best_step()


@pytest.fixture(scope="module")
def orbax_decisions(tmp_path_factory):
    """JAX's Orbax manager on ``OFFERS`` for every case of ``CASES``."""
    from npvp_tpu.core.checkpoint import CheckpointManager

    out = {}
    for case in CASES:
        interval, monitor, mode = case
        mngr = CheckpointManager(tmp_path_factory.mktemp("orbax"),
                                 max_to_keep=2, save_interval_steps=interval,
                                 monitor=monitor, mode=mode)
        out[case] = _offer(mngr, lambda step: {"w": np.full(2, step)},
                           lambda: sorted(mngr._mngr.all_steps()))
        mngr.close()
    return out


@pytest.mark.parametrize("case", CASES, ids=lambda c: f"every{c[0]}-{c[1]}"
                         f"-{c[2]}")
def test_saved_kept_and_best_steps_match_orbax(case, orbax_decisions,
                                               tmp_path):
    interval, monitor, mode = case
    mngr = ck.CheckpointManager(tmp_path, max_to_keep=2,
                                save_interval_steps=interval,
                                monitor=monitor, mode=mode)
    got = _offer(mngr, lambda step: Holder({"w": torch.full((2,), step)}),
                 lambda: sorted(
        int(p.stem[5:]) for p in tmp_path.glob("step_*.pt")))
    assert got == orbax_decisions[case]
    again = ck.CheckpointManager(tmp_path, monitor=monitor, mode=mode)
    assert (again.latest_step(), again.best_step()) == got[2:]
    assert not list(tmp_path.glob("*.tmp"))


def _gate(monkeypatch):
    """Hold every background write until the returned event is set."""
    gate = threading.Event()
    write = ck.CheckpointManager._background

    def held(self, *args):
        assert gate.wait(30), "the test never opened the gate"
        write(self, *args)

    monkeypatch.setattr(ck.CheckpointManager, "_background", held)
    return gate


def test_file_holds_the_state_as_it_was_at_save(tmp_path, monkeypatch):
    """The state is updated in place while its write is held back; the
    file has the values, the step and the optimizer's groups of ``save``."""
    gate = _gate(monkeypatch)
    model = torch.nn.Linear(3, 2)
    opt = torch.optim.Adam(model.parameters(), lr=0.1)
    state = TrainState(model, opt, lambda step: 0.1)
    model(torch.ones(1, 3)).sum().backward()
    state.apply_gradients()
    want = {k: v.clone() for k, v in model.state_dict().items()}
    moments = {k: v.clone() for k, v in opt.state[model.weight].items()}
    mngr = ck.CheckpointManager(tmp_path)
    assert mngr.save(state.step, state)
    model(torch.ones(1, 3)).sum().backward()
    state.apply_gradients()  # parameters and moments move in place
    opt.param_groups[0]["lr"] = 0.5
    gate.set()
    saved = mngr.load()
    assert saved["step"] == 1
    for k, v in want.items():
        assert torch.equal(saved["model"][k], v), k
    for k, v in moments.items():
        assert torch.equal(saved["optimizer"]["state"][0][k], v), k
    assert saved["optimizer"]["param_groups"][0]["lr"] == 0.1
    assert not torch.equal(saved["model"]["weight"], model.weight)


@pytest.mark.parametrize("where", ["wait", "save", "close"])
def test_a_failed_write_is_raised_again(where, tmp_path):
    mngr = ck.CheckpointManager(tmp_path)
    # a local function cannot be pickled: torch.save raises in the writer
    assert mngr.save(1, Holder({"w": torch.ones(2), "f": lambda: 0}))
    call = {"wait": mngr.wait, "close": mngr.close,
            "save": lambda: mngr.save(2, Holder({"w": torch.ones(2)}))}
    with pytest.raises(AttributeError, match="local object"):
        call[where]()
    mngr.wait()  # raised once
    assert not mngr.path(1).exists()


def test_reads_wait_for_the_write_in_flight(tmp_path, monkeypatch):
    gate = _gate(monkeypatch)
    mngr = ck.CheckpointManager(tmp_path, monitor="loss")
    assert mngr.save(3, Holder({"w": torch.arange(4.0)}), {"loss": 1.0})
    assert not mngr.path(3).exists()
    threading.Timer(0.2, gate.set).start()
    state = Holder(None)
    state.load_state_dict = lambda tree: setattr(state, "tree", tree)
    mngr.restore(state)  # waits for the gate, then reads the whole file
    assert torch.equal(state.tree["w"], torch.arange(4.0))
    record = mngr.history[-1]
    assert record["step"] == 3 and record["bytes"] > 0
    assert record["save_ms"] >= 0 and record["write_ms"] >= 0
    assert (mngr.latest_step(), mngr.best_step()) == (3, 3)


def test_two_ranks_only_the_writer_writes(tmp_path):
    """Saves of a state sharded by FSDP on two gloo ranks: every rank
    gathers (a collective) and sees the same latest and best steps, only
    rank 0 writes; its file restores into a one-process state equal to the
    gathered one."""
    got = spawn(tmp_path, 2, [(checkpoint_scenario, dict(
        ckpt_dir=str(tmp_path), mesh_shape=(2, 1)))])[0]
    assert got["steps"].tolist() == [[2, 1], [2, 1]]  # (latest, best) a rank
    assert not (tmp_path / "rank1").exists()
    model = torch.nn.Sequential(torch.nn.Linear(8, 16),
                                torch.nn.Linear(16, 4))
    state = TrainState(model, torch.optim.Adam(model.parameters()),
                       lambda step: 1e-2)
    ck.CheckpointManager(tmp_path / "rank0").restore(state)
    assert state.step == 2
    restored = state.state_dict()
    for k, v in got["state"]["model"].items():
        assert torch.equal(restored["model"][k], v), k
    for i, st in got["state"]["optimizer"]["state"].items():
        for k, v in st.items():
            assert torch.equal(restored["optimizer"]["state"][i][k], v), k


class Planted(RuntimeError):
    pass


@pytest.mark.parametrize("stage", [1, 2])
def test_trainer_leaves_whole_files_when_a_step_raises(stage, tmp_path,
                                                       monkeypatch):
    """A train step of the second epoch raises while the first epoch's
    checkpoint is still being written (each write held back 0.3 s): the
    trainer's ``finally`` waits for it, so its file is whole and listed."""
    write = ck.CheckpointManager._background

    def slow(self, *args):
        threading.Event().wait(0.3)
        write(self, *args)

    monkeypatch.setattr(ck.CheckpointManager, "_background", slow)
    cfg = stage1_cfg(tmp_path) if stage == 1 else stage2_cfg(tmp_path)
    trainer = s1 if stage == 1 else s2
    directory = (cfg.AE if stage == 1 else cfg.Predictor).ckpt_save_dir
    seen = []

    def on_step(kind, index, metrics):
        seen.append(kind)
        if seen.count("train") == 3:  # the second epoch's first step
            raise Planted("a step raises")

    with pytest.raises(Planted):
        trainer.train(cfg, on_step=on_step)
    mngr = ck.CheckpointManager(directory)
    assert mngr.latest_step() == 2
    assert sorted(p.name for p in mngr.directory.glob("step_*")) == [
        "step_00000002.pt"]
    saved = mngr.load()
    assert saved["step"] == 2
    assert all(np.isfinite(v.numpy()).all() for v in saved["model"].values()
               if v.is_floating_point())
