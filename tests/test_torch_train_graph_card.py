"""The trainer's graph path on the card (``train/trainer.py`` ``TrainGraph``)
against its eager step, SiamMask-base stage 1 at width 64, batch 8, float32
with TF32 off, from the same BN-calibrated weights.

- Four batches, the third with a NaN pixel: the graph path (captured at the
  first step, replayed for every step) and the eager step
  (``_torch_weights.eager_step``: foreach SGD, the guard read on the host)
  make the same skip decisions, and their parameters, momentum buffers and
  BN running statistics agree within ``TOL`` of each tensor's change
  (fused against foreach SGD, and the backward's atomics, round
  differently). Counters: 1 capture and 4 replays; the LR moves between
  the second and third step with no recapture; the capture counted the
  step's xcorr launches once, 3 of each kernel.
- A ``Trainer.restore`` then one step: one recapture, the restored state
  stepped as the eager step steps it; the unfreeze boundary then one
  recapture, and the frozen phase's graph dropped.

Marked ``cuda``; they skip without a card. The file imports only the port:
``python -m pytest tests/test_torch_train_graph_card.py -m cuda -q``."""
import numpy as np
import pytest
import torch

from siammask_tpu_torch.bench import train_batch
from siammask_tpu_torch.models.siammask import SiamMaskBase
from siammask_tpu_torch.ops.xcorr import (depthwise_xcorr, depthwise_xcorr_grad_input,
                                          depthwise_xcorr_grad_kernel)
from siammask_tpu_torch.train.checkpoint import save_checkpoint
from siammask_tpu_torch.train.trainer import OptimizerConfig, Trainer, TrainSettings
from siammask_tpu_torch.utils import trace
from _torch_weights import calibrate_bn, eager_step

WIDTH = 64
B = 8
SETTINGS = TrainSettings(task="base", loss_weight=(1.0, 1.2, 36.0), mask_pad=32)
# epochs 0 and 1 frozen, 2 and 3 unfrozen, a new LR at each
LRS = np.array([0.01, 0.008, 0.006, 0.004])
KERNELS = (depthwise_xcorr, depthwise_xcorr_grad_input, depthwise_xcorr_grad_kernel)
COUNTERS = ("train.graph_captures", "train.graph_replays", "train.eager_steps")
# graph vs eager, each tensor's gap against the largest entry of its change
# (momentum buffers: of the buffer), plus 1e-7 of the largest parameter
TOL = 1e-3


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def batches(device) -> list[dict]:
    """Four batches of the bench's distributions, the images shifted from
    one to the next; the third has a NaN pixel."""
    base = train_batch(B, 255, 25, device)
    out = []
    for i in range(4):
        b = {k: v.clone() for k, v in base.items()}
        b["template"] = torch.roll(b["template"], 7 * i, dims=-1)
        b["search"] = torch.roll(b["search"], 11 * i, dims=-2)
        out.append(b)
    out[2]["template"][0, 0, 0, 0] = float("nan")
    return out


def trainers(device) -> tuple[Trainer, Trainer]:
    model = SiamMaskBase(width=WIDTH).init_weights(torch.Generator().manual_seed(0))
    model = model.to(device)
    b = train_batch(1, 255, 25, device)
    calibrate_bn(model, b["template"], b["search"])
    twin = SiamMaskBase(width=WIDTH).to(device)
    twin.load_state_dict(model.state_dict())
    return tuple(Trainer(m, SETTINGS, OptimizerConfig(), LRS, epochs=len(LRS))
                 for m in (model, twin))


def state_of(trainer: Trainer) -> dict:
    out = {k: v.detach().clone() for k, v in trainer.model.state_dict().items()}
    for name, p in trainer.model.named_parameters():
        buf = trainer.optimizer.state.get(p, {}).get("momentum_buffer")
        if buf is not None:
            out[f"momentum.{name}"] = buf.clone()
    return out


def assert_states_close(graph: dict, eager: dict, start: dict) -> float:
    """Every entry of ``graph`` within ``TOL`` of ``eager``'s, measured
    against the entry's change from ``start`` (a momentum buffer: the
    buffer); returns the largest gap over its limit."""
    assert graph.keys() == eager.keys()
    floor = 1e-7 * max(v.abs().max().item() for k, v in start.items()
                       if v.is_floating_point())
    worst = 0.0
    for k, ref in eager.items():
        if not ref.is_floating_point():
            assert torch.equal(graph[k], ref), k
            continue
        scale = ref if k.startswith("momentum.") else ref - start[k]
        gap = (graph[k] - ref).abs().max().item()
        limit = TOL * scale.abs().max().item() + floor
        assert gap <= limit, (k, gap, limit)
        worst = max(worst, gap / limit)
    return worst


def counted(fn):
    before = trace.counters()
    out = fn()
    after = trace.counters()
    return out, {k: after.get(k, 0) - before.get(k, 0) for k in COUNTERS}


@pytest.mark.cuda
def test_graph_steps_as_the_eager_step_on_card(cuda_device):
    graphed, eager = trainers(cuda_device)
    start = state_of(graphed)
    skips, counts, launches = [], {k: 0 for k in COUNTERS}, []
    for batch, epoch in zip(batches(cuda_device), (0, 0, 1, 1)):
        before = [fn.launches for fn in KERNELS]
        m_graph, c = counted(lambda: graphed.step(batch, epoch))
        launches.append([fn.launches - n for fn, n in zip(KERNELS, before)])
        m_eager = eager_step(eager, batch, epoch)
        counts = {k: counts[k] + c[k] for k in COUNTERS}
        skips.append((m_graph["skipped"].item(), m_eager["skipped"].item()))
        if m_eager["skipped"].item() == 0.0:
            for k in m_eager:
                torch.testing.assert_close(m_graph[k], m_eager[k], rtol=1e-4, atol=1e-6)
    assert skips == [(0.0, 0.0), (0.0, 0.0), (1.0, 1.0), (0.0, 0.0)], skips
    assert counts == {"train.graph_captures": 1, "train.graph_replays": 4,
                      "train.eager_steps": 0}, counts
    # through the wrappers once, at the capture; the replays launch the captured ones
    assert launches == [[3, 3, 3], [0, 0, 0], [0, 0, 0], [0, 0, 0]], launches
    graph, = graphed.graphs.values()
    assert graph.xcorr_launches == [3, 3, 3]
    assert [t.item() for t in graph.lrs] == pytest.approx(
        [LRS[1] * g["mult"] for g in graphed.optimizer.param_groups])
    worst = assert_states_close(state_of(graphed), state_of(eager), start)
    print(f"[train-graph] 4 steps, one skipped: the largest gap {worst:.3f} of its limit")


@pytest.mark.cuda
def test_graph_recaptures_after_restore_and_unfreeze_on_card(cuda_device, tmp_path):
    graphed, eager = trainers(cuda_device)
    batch = batches(cuda_device)[0]
    for t in (graphed, eager):
        eager_step(t, batch, 0)     # both at the same state, with momentum
    path = str(tmp_path / "ck.pth")
    save_checkpoint(path, graphed.model.state_dict(), graphed.optimizer.state_dict(), epoch=1)
    start = state_of(graphed)
    _, c = counted(lambda: graphed.step(batch, 1))
    assert c["train.graph_captures"] == 1 and c["train.graph_replays"] == 1
    assert graphed.restore(path) == 1
    assert all(torch.equal(v, start[k]) for k, v in state_of(graphed).items())
    m_graph, c = counted(lambda: graphed.step(batch, 1))
    m_eager = eager_step(eager, batch, 1)
    assert c["train.graph_captures"] == 1 and c["train.graph_replays"] == 1, c
    assert m_graph["skipped"].item() == m_eager["skipped"].item() == 0.0
    assert_states_close(state_of(graphed), state_of(eager), start)

    frozen_opt = graphed.optimizer
    _, c = counted(lambda: graphed.step(batch, 2))      # the unfreeze boundary
    assert graphed.optimizer is not frozen_opt
    assert c["train.graph_captures"] == 1 and c["train.graph_replays"] == 1, c
    graph, = graphed.graphs.values()
    assert graph.optimizer is graphed.optimizer
    _, c = counted(lambda: graphed.step(batch, 3))
    assert c["train.graph_captures"] == 0 and c["train.graph_replays"] == 1, c
