"""Train-mode BatchNorm's kernels on the card (``ops/bn_train.py``,
``csrc/bn_train.cu``), against the plain version (``bn_train_reference``,
float32 arithmetic on the same bf16 inputs, rounded once):

- at the main path's shapes (C 128 / 256 / 512 / 1024 over R 14,400 and
  61,504 rows, layer2's 254,016-row map and a ragged 231-row one), with and
  without the ReLU and the residual: the output and dx (and dz) within one
  bf16 step (``one_bf16_step``), dgamma and dbeta, the running mean and
  biased running variance (``TOL_SUM``, ``TOL_STATS``);
- a channel whose mean is 100 times its spread: its variance to 1e-5;
- elements whose value before the ReLU float32 rounding can put on either
  side of 0 are left out of dx and dz (``relu_ties``);
- a ``torch.cuda.graph`` capture of forward and backward replays the eager
  call's bits, the running statistics too;
- an unfrozen width-64 bf16 SiamMask-base ``Trainer`` step (its CUDA graph)
  counts 75 ``bn.train_fused`` and 75 launches of each kernel at capture,
  and a replay runs the four kernels and none of ATen's ``batch_norm``
  kernels or ``threshold_backward``.

Marked ``cuda``; they skip without a card. The file imports only the port:
``python -m pytest tests/test_torch_bn_train_card.py -m cuda -q``."""
import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from siammask_tpu_torch.bench import train_batch
from siammask_tpu_torch.models.resnet import BatchNorm2d
from siammask_tpu_torch.models.siammask import SiamMaskBase
from siammask_tpu_torch.ops import bn_train
from siammask_tpu_torch.train.trainer import OptimizerConfig, Trainer, TrainSettings
from siammask_tpu_torch.utils import trace

from _torch_weights import bf16_steps_over, relu_ties
from test_torch_graph import cuda_device  # noqa: F401  (fixture)

# (N, H, W) a map: R = 14,400 and 61,504 (the template's and the search's
# layer2/3 maps at batch 64), layer2's first 63x63 map, a ragged 231 rows
ROWS = {"R14400": (64, 15, 15), "R61504": (64, 31, 31), "R254016": (64, 63, 63),
        "R231": (3, 7, 11)}
SHAPES = [(c, r) for c in (128, 256, 512, 1024) for r in ("R14400", "R61504")] + [
    (128, "R254016"), (256, "R231"), (1024, "R231")]
CHAINS = [(relu, residual) for relu in (True, False) for residual in (True, False)]
MOMENTUM, EPS = 0.1, 1e-5
# dgamma and dbeta: two float32 sums of the same terms in other orders are
# within ~(rows a thread sums + tree depth) 2^-24 of the sum of the terms'
# magnitudes each (about 1e-5 at 254,016 rows); three times that
TOL_SUM = 3e-5
# the running statistics: float32 means and variances summed in other
# orders, 1e-5 of the batch's scale (|mean| + std) over the channels
TOL_STATS = 1e-5


def one_bf16_step(what: str, out: torch.Tensor, ref: torch.Tensor, skip=None) -> None:
    over = bf16_steps_over(out, ref, skip)
    assert not over, f"{what}: {over} of {out.numel()} elements more than one bf16 step off"


def make(c: int, rows: str, device, seed: int = 0, big_mean: bool = False):
    """x, z, dy (bf16 channels_last) and a BN's float32 vectors."""
    gen = torch.Generator(device=device).manual_seed(seed)
    n, h, w = ROWS[rows]

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=device)

    x = randn(n, c, h, w) * (0.5 + randn(c).abs())[:, None, None] + randn(c)[:, None, None]
    if big_mean:
        x[:, 0] = 100.0 + randn(n, h, w)
    maps = [t.to(torch.bfloat16).contiguous(memory_format=torch.channels_last)
            for t in (x, randn(n, c, h, w), randn(n, c, h, w))]
    vecs = [1 + 0.3 * randn(c), 0.2 * randn(c), randn(c), randn(c).abs() + 0.5]
    return maps, vecs


def run(fn, x, z, dy, vecs, relu):
    """fn's output, its gradients (x, gamma, beta, z) and the running
    statistics after the call, from fresh leaves."""
    x = x.detach().requires_grad_()
    z = None if z is None else z.detach().requires_grad_()
    w, b = (v.clone().requires_grad_() for v in vecs[:2])
    mean, var = (v.clone() for v in vecs[2:])
    y = fn(x, w, b, mean, var, MOMENTUM, EPS, z, relu)
    grads = torch.autograd.grad(y, [t for t in (x, w, b, z) if t is not None], dy)
    return y.detach(), grads, mean, var


@pytest.mark.cuda
@pytest.mark.parametrize("relu,residual", CHAINS)
@pytest.mark.parametrize("c,rows", SHAPES)
def test_kernels_match_the_plain_version_on_card(cuda_device, c, rows, relu, residual):
    (x, z, dy), vecs = make(c, rows, cuda_device)
    z = z if residual else None
    before = [fn.launches for fn in bn_train.WRAPPERS]
    y, grads, mean, var = run(bn_train.bn_train, x, z, dy, vecs, relu)
    torch.cuda.synchronize()
    assert [fn.launches - n for fn, n in zip(bn_train.WRAPPERS, before)] == [1, 1, 1, 1]
    ry, rgrads, rmean, rvar = run(bn_train.bn_train_reference, x, z, dy, vecs, relu)
    assert y.dtype == torch.bfloat16 and y.is_contiguous(memory_format=torch.channels_last)
    one_bf16_step("y", y, ry)
    ties = relu_ties(x, z, *vecs[:2], EPS) if relu else None
    one_bf16_step("dx", grads[0], rgrads[0], ties)
    if residual:
        one_bf16_step("dz", grads[3], rgrads[3], ties)
    # each sum's terms, from the plain version: g (d beta) and g * xhat (d gamma)
    xf = x.float()
    xhat = (xf - xf.mean(dim=(0, 2, 3), keepdim=True)) * torch.rsqrt(
        xf.var(dim=(0, 2, 3), correction=0, keepdim=True) + EPS)
    g = dy.float()
    kept = ry.float() > 0 if relu else torch.ones_like(g, dtype=torch.bool)
    for got, want, term in ((grads[1], rgrads[1], (g * xhat).abs()),
                            (grads[2], rgrads[2], g.abs())):
        # plus each tie's whole term, which either side may take
        bound = TOL_SUM * (term * kept).sum(dim=(0, 2, 3))
        if relu:
            bound = bound + (term * ties).sum(dim=(0, 2, 3))
        assert ((got - want).abs() <= bound).all(), (got - want).abs().max()
    scale = (xf.mean(dim=(0, 2, 3)).abs() + xf.std(dim=(0, 2, 3))).max()
    torch.testing.assert_close(mean, rmean, rtol=TOL_STATS, atol=TOL_STATS * scale)
    torch.testing.assert_close(var, rvar, rtol=TOL_STATS, atol=TOL_STATS * scale ** 2)


@pytest.mark.cuda
def test_large_mean_channel_keeps_its_variance_on_card(cuda_device):
    (x, _, _), vecs = make(256, "R61504", cuda_device, big_mean=True)
    mean, var = torch.zeros(256, device=cuda_device), torch.zeros(256, device=cuda_device)
    bn_train.batch_stats(x, mean, var, 1.0, EPS)     # momentum 1: the batch's statistics
    x64 = x.double()
    want_var, want_mean = torch.var_mean(x64, dim=(0, 2, 3), correction=0)
    assert abs(want_mean[0].item() / want_var[0].item() ** 0.5) > 90
    torch.testing.assert_close(var.double(), want_var, rtol=1e-5, atol=0)
    torch.testing.assert_close(mean.double(), want_mean, rtol=1e-6, atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("residual", [True, False])
def test_graph_replay_gives_the_eager_bits_on_card(cuda_device, residual):
    (x, z, dy), vecs = make(256, "R61504", cuda_device, seed=1)
    z = z if residual else None
    stats0 = [v.clone() for v in vecs[2:]]
    mean, var = (v.clone() for v in stats0)

    def step():
        # leaves made in the call, so that autograd's nodes run on the
        # capturing stream
        ins = [t.detach().requires_grad_() for t in (x, *vecs[:2], z) if t is not None]
        y = bn_train.bn_train(*ins[:3], mean, var, MOMENTUM, EPS, ins[3] if residual else None,
                              True)
        return (y, *torch.autograd.grad(y, ins, dy))

    eager = [t.clone() for t in step()] + [mean.clone(), var.clone()]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        step()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = step()
    for replay in range(2):
        for kept, v in zip((mean, var), stats0):
            kept.copy_(v)
        graph.replay()
        torch.cuda.synchronize()
        for i, (got, want) in enumerate(zip(list(out) + [mean, var], eager)):
            assert torch.equal(got, want), (replay, i)


@pytest.mark.cuda
def test_unfrozen_base_step_runs_the_kernels_on_card(cuda_device):
    model = SiamMaskBase(width=64, dtype=torch.bfloat16)
    model = model.init_weights(torch.Generator().manual_seed(0)).to(cuda_device)
    trainer = Trainer(model, TrainSettings(task="base", loss_weight=(1.0, 1.2, 36.0)),
                      OptimizerConfig(), np.array([0.01, 0.005]), epochs=2)
    batch = train_batch(8, 255, 25, cuda_device)
    before = trace.counters()
    launches = [fn.launches for fn in bn_train.WRAPPERS]
    metrics = trainer.step(batch, 1)       # unfrozen: layer2, layer3, neck and heads train
    after = trace.counters()
    assert after["train.graph_captures"] - before.get("train.graph_captures", 0) == 1
    assert after["bn.train_fused"] - before.get("bn.train_fused", 0) == 75
    assert [fn.launches - n for fn, n in zip(bn_train.WRAPPERS, launches)] == [75] * 4
    assert sum(isinstance(m, BatchNorm2d) and m.training for m in model.modules()) == 42
    assert torch.isfinite(metrics["total_loss"])
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        metrics = trainer.step(batch, 1)    # a replay
        torch.cuda.synchronize()
    kernels = {e.key: e.count for e in prof.key_averages() if e.device_type.name == "CUDA"}
    assert torch.isfinite(metrics["total_loss"])
    assert not [k for k in kernels if "batch_norm" in k or "threshold" in k], kernels
    for name in ("bn_stats_kernel", "bn_apply_kernel", "bn_backward_reduce_kernel",
                 "bn_backward_elemt_kernel"):
        assert sum(n for k, n in kernels.items() if name in k) == 75, (name, kernels)
