"""The trainer's two paths on the CPU (``train/trainer.py``): the rule that
picks the graph path, the NaN/huge-loss guard decided on the device
(``train_step_guarded``) against the one decided on the host
(``train_step``), and the graph path's bookkeeping with a stand-in graph.

SiamMask-base at width 8, batch 2, the full 127/255 geometry, the bench's
training batch (``bench.train_batch``). The port alone: no JAX. The card's
own checks of a captured step are ``tests/test_torch_train_graph_card.py``.

The stand-in (``StandInGraph``) keeps ``TrainGraph``'s static inputs, LR
tensors, warm-up and version stamp, and replaces the CUDA graph by the
step body, which each replay runs into the same output tensors. A real
replay runs no Python and leaves every version as it is; the stand-in's
Python moves them, so it stamps them again after each replay."""
import copy

import numpy as np
import pytest
import torch

from siammask_tpu_torch.bench import train_batch
from siammask_tpu_torch.models.siammask import SiamMaskBase
from siammask_tpu_torch.train import trainer as trainer_module
from siammask_tpu_torch.train.checkpoint import save_checkpoint
from siammask_tpu_torch.train.trainer import (OptimizerConfig, Trainer, TrainSettings,
                                              train_step_guarded, uses_graph)
from siammask_tpu_torch.utils import trace
from _torch_weights import eager_step

WIDTH = 8
B = 2
SETTINGS = TrainSettings(task="base", loss_weight=(1.0, 1.2, 36.0), mask_pad=32)
# epochs 0 and 1 frozen, 2 and 3 unfrozen, a new LR at each
LRS = np.array([0.01, 0.008, 0.006, 0.004])


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def make_trainer(seed=0) -> Trainer:
    model = SiamMaskBase(width=WIDTH).init_weights(torch.Generator().manual_seed(seed))
    return Trainer(model, SETTINGS, OptimizerConfig(), LRS, epochs=len(LRS))


def lr_tensors(trainer: Trainer) -> list[torch.Tensor]:
    return [torch.tensor(g["lr"], dtype=torch.float32) for g in trainer.optimizer.param_groups]


def state_of(trainer: Trainer) -> dict:
    """Every parameter and buffer, and every momentum buffer by name."""
    out = {k: v.detach().clone() for k, v in trainer.model.state_dict().items()}
    state = trainer.optimizer.state
    for name, p in trainer.model.named_parameters():
        buf = state.get(p, {}).get("momentum_buffer")
        if buf is not None:
            out[f"momentum.{name}"] = buf.clone()
    return out


@pytest.mark.parametrize("device,distributed,remat,graph", [
    ("cpu", False, False, False),
    ("cpu", True, False, False),
    ("cpu", False, True, False),
    ("cuda", False, False, True),
    ("cuda", True, False, False),
    ("cuda", False, True, False),
    ("cuda", True, True, False),
])
def test_graph_path_only_for_one_cuda_card(device, distributed, remat, graph):
    assert uses_graph(torch.device(device), distributed, remat) is graph


def test_cpu_trainer_steps_eagerly():
    trainer = make_trainer()
    before = trace.counters()
    trainer.step(train_batch(B, 255, 25, "cpu"), 0)
    after = trace.counters()
    delta = {k: after.get(k, 0) - before.get(k, 0)
             for k in ("train.eager_steps", "train.graph_captures", "train.graph_replays")}
    assert delta == {"train.eager_steps": 1, "train.graph_captures": 0,
                     "train.graph_replays": 0}
    assert trainer.graphs == {}


def bad_batch(kind: str) -> dict:
    batch = train_batch(B, 255, 25, "cpu")
    if kind == "nan":
        batch["template"][0, 0, 0, 0] = float("nan")
    else:       # finite, far above 1e4: the box targets a million times too large
        batch["label_loc"] = batch["label_loc"] * 1e6
    return batch


@pytest.mark.parametrize("kind", ["nan", "huge"])
def test_device_guard_leaves_what_the_host_guard_leaves(kind):
    """One ordinary step on both (the eager path), then a step whose loss is
    NaN or above 1e4: the device-decided guard leaves the parameters,
    momentum buffers and train-mode BN buffers exactly as the host-decided
    step does, which is as they were before it."""
    eager = make_trainer()
    eager.step(train_batch(B, 255, 25, "cpu"), 0)
    guarded = copy.deepcopy(eager)
    before = state_of(eager)
    assert any(k.startswith("momentum.") for k in before)
    assert any(m.training for m in guarded._bns)

    batch = bad_batch(kind)
    m_host = eager.step(batch, 0)
    m_device = train_step_guarded(guarded.model, guarded.optimizer, batch, lr_tensors(guarded),
                                  SETTINGS, guarded.opt_cfg)
    total = m_device["total_loss"].item()
    assert (np.isnan(total) if kind == "nan" else np.isfinite(total) and total > 1e4)
    assert m_host["skipped"].item() == m_device["skipped"].item() == 1.0
    host, device = state_of(eager), state_of(guarded)
    assert host.keys() == device.keys() == before.keys()
    for k in before:
        assert torch.equal(device[k], host[k]), k
        assert torch.equal(device[k], before[k]), k


def test_device_guard_steps_a_finite_loss_as_the_eager_step():
    """A finite loss: the guarded step (fused SGD, first momentum from zero
    buffers) moves the state as the eager step (foreach SGD) does, within
    float32 rounding, and reports no skip."""
    eager = make_trainer()
    guarded = copy.deepcopy(eager)
    batch = train_batch(B, 255, 25, "cpu")
    for epoch in (0, 0):
        m_host = eager.step(batch, epoch)
        for g in guarded.optimizer.param_groups:
            g["lr"] = LRS[epoch] * g["mult"]
        m_device = train_step_guarded(guarded.model, guarded.optimizer, batch,
                                      lr_tensors(guarded), SETTINGS, guarded.opt_cfg)
        assert m_device["skipped"].item() == 0.0
        assert m_device.keys() == m_host.keys()
        for k in m_host:
            torch.testing.assert_close(m_device[k], m_host[k], rtol=1e-5, atol=1e-6)
    host, device = state_of(eager), state_of(guarded)
    assert host.keys() == device.keys()
    for k in host:
        torch.testing.assert_close(device[k], host[k], rtol=1e-5, atol=1e-7, msg=k)


class StandInGraph(trainer_module.TrainGraph):
    """``TrainGraph`` with the step body in place of the CUDA graph (the
    module docstring). Its Python moves the versions of the trainer's other
    graphs too, which a replay would not: it stamps theirs again as well."""

    def __init__(self, trainer, batch, side):
        self.trainer = trainer
        super().__init__(trainer, batch, side)

    def _warm_up(self, run, side):
        run()

    def _capture(self, run, side):
        owner = self

        class Replayer:
            def replay(self):
                out = run()
                if owner.out is None:
                    owner.out = {k: v.clone() for k, v in out.items()}
                else:
                    for k, v in out.items():
                        owner.out[k].copy_(v)
                for graph in {owner, *owner.trainer.graphs.values()}:
                    graph.stamp_versions()

        self.graph = Replayer()
        return None


@pytest.fixture
def stand_in(monkeypatch):
    monkeypatch.setattr(trainer_module, "uses_graph",
                        lambda device, distributed, remat: not distributed and not remat)
    monkeypatch.setattr(trainer_module, "TrainGraph", StandInGraph)
    monkeypatch.setattr(torch.cuda, "Stream", lambda device: None)


def test_graph_path_bookkeeping_with_a_stand_in_graph(stand_in, tmp_path):
    """Captures and replays by key: a new LR writes the LR tensors and
    recaptures nothing; another batch shape captures a second graph; a
    ``load_state_dict`` and a ``restore`` each make the graph stale, so the
    next step captures again; the unfreeze boundary's new optimizer
    captures and drops the older optimizer's graphs. Each step's metrics
    are fresh tensors that keep their values. Every step is held to the
    eager step's (foreach SGD) within float32 rounding."""
    graphed, eager = make_trainer(), make_trainer()
    big, small = train_batch(B, 255, 25, "cpu"), train_batch(1, 255, 25, "cpu")
    path = str(tmp_path / "ck.pth")
    plan = [(big, 0, "capture"), (big, 0, "replay"), (big, 1, "replay"),
            (small, 1, "capture"), (big, 1, "replay"), ("load", 1, None),
            (big, 1, "capture"), ("save", 1, None), (big, 1, "replay"), ("restore", 1, None),
            (big, 1, "capture"), (big, 2, "capture"), (big, 3, "replay")]
    kept = []
    for what, epoch, expect in plan:
        if what == "load":
            graphed.model.load_state_dict(graphed.model.state_dict())
            continue
        if what == "save":
            save_checkpoint(path, graphed.model.state_dict(), graphed.optimizer.state_dict(),
                            epoch=epoch)
            snapshot = (state_of(graphed), state_of(eager))
            continue
        if what == "restore":
            graphed.step(big, epoch)         # moves on, then goes back
            eager_step(eager, big, epoch)
            graphed.restore(path)
            eager.restore(path)
            assert all(torch.equal(v, snapshot[0][k]) for k, v in state_of(graphed).items())
            continue
        before = trace.counters()
        metrics = graphed.step(what, epoch)
        ref = eager_step(eager, what, epoch)
        after = trace.counters()
        delta = {k: after.get(k, 0) - before.get(k, 0)
                 for k in ("train.graph_captures", "train.graph_replays", "train.eager_steps")}
        assert delta == {"train.graph_captures": int(expect == "capture"),
                         "train.graph_replays": 1, "train.eager_steps": 0}, (what, epoch)
        for k in ref:
            torch.testing.assert_close(metrics[k], ref[k], rtol=1e-4, atol=1e-6)
        graph = next(reversed(graphed.graphs.values()))
        assert graph.optimizer is graphed.optimizer
        assert [t.item() for t in graph.lrs] == pytest.approx(
            [LRS[epoch] * g["mult"] for g in graphed.optimizer.param_groups])
        kept.append({k: (v, v.item()) for k, v in metrics.items()})
    # the frozen phase kept two graphs (the batch of 2 and of 1); the
    # unfreeze dropped both
    assert len(graphed.graphs) == 1
    for step in kept:
        for k, (tensor, value) in step.items():
            assert tensor.item() == value or (np.isnan(value) and np.isnan(tensor.item()))
    ptrs = [m["total_loss"][0].data_ptr() for m in kept]
    assert len(set(ptrs)) == len(ptrs)
    graphed_state, eager_state = state_of(graphed), state_of(eager)
    for k in eager_state:
        torch.testing.assert_close(graphed_state[k], eager_state[k], rtol=1e-4, atol=1e-6,
                                   msg=k)
