"""Train-mode BatchNorm with its add and ReLU (``ops/bn_train.py``,
``models/resnet.py`` ``trains_fused`` / ``bn_add_relu``), on the CPU.

The kernels run on a card only (``tests/test_torch_bn_train_card.py``). Here:

- the plain version (``bn_train_reference``) against today's module chain,
  ``BatchNorm2d`` -> add -> ReLU, in float64, at the BN shapes of a base
  training step at width 8, with and without the ReLU and the residual:
  the output, the gradients of x, gamma, beta and z, and the running mean
  and biased running variance after two calls;
- ``BatchNormTrain``, the autograd Function, with its four kernel wrappers
  replaced by float64 stand-ins of the kernels' arithmetic
  (``emulated_kernels``): the same numbers, so the Function saves, masks
  and returns its gradients in the right places;
- the rule: the CPU, a hook on the BN, float32 or NCHW maps, eval mode and
  a ``SyncBatchNorm2d`` over a group of two leave the modules to run; with
  the rule let onto CPU tensors (``bn_train.DEVICES``), a width-8 bf16
  SiamMask-base in its unfrozen phase counts 75 ``bn.train_fused`` a
  forward and its wrappers' launch counts stand after ``trace.uncounted``.
"""
import pytest
import torch
import torch.distributed as dist

from siammask_tpu_torch.models.resnet import BatchNorm2d, bn_add_relu, trains_fused
from siammask_tpu_torch.models.siammask import SiamMaskBase
from siammask_tpu_torch.ops import bn_train
from siammask_tpu_torch.parallel.sync_bn import SyncBatchNorm2d
from siammask_tpu_torch.utils import trace

from test_torch_tracker import one_torch_thread  # noqa: F401  (autouse)

# (N, C, H, W): a base training step's train-mode BN maps at width 8 and
# batch 2 (layer2's 31 and 15, layer3's 15 and 31, the heads' 5, 29 and 25)
SHAPES = [(2, 16, 31, 31), (2, 32, 15, 15), (2, 64, 15, 15), (2, 128, 31, 31), (2, 32, 5, 5),
          (2, 32, 29, 29), (2, 32, 25, 25)]
CHAINS = [(relu, residual) for relu in (True, False) for residual in (True, False)]
MOMENTUM = 0.1
EPS = 1e-5


def _bn(c: int, dtype=torch.float64, seed: int = 0) -> BatchNorm2d:
    gen = torch.Generator().manual_seed(seed)
    bn = BatchNorm2d(c).to(dtype)
    with torch.no_grad():
        bn.weight.copy_(1 + 0.3 * torch.randn(c, generator=gen, dtype=dtype))
        bn.bias.copy_(0.2 * torch.randn(c, generator=gen, dtype=dtype))
        bn.running_mean.copy_(torch.randn(c, generator=gen, dtype=dtype))
        bn.running_var.copy_(torch.rand(c, generator=gen, dtype=dtype) + 0.5)
    return bn.train()


def _maps(shape, dtype=torch.float64, seed: int = 1, layout=torch.contiguous_format):
    """x with a channel mean and spread of its own in each channel, z, dy."""
    gen = torch.Generator().manual_seed(seed)
    c = shape[1]
    x = torch.randn(shape, generator=gen, dtype=dtype) * (0.5 + torch.rand(
        c, generator=gen, dtype=dtype))[:, None, None] + torch.randn(c, generator=gen,
                                                                      dtype=dtype)[:, None, None]
    z = torch.randn(shape, generator=gen, dtype=dtype)
    dy = torch.randn(shape, generator=gen, dtype=dtype)
    return tuple(t.contiguous(memory_format=layout) for t in (x, z, dy))


def _grads(out, dy, *ts):
    return torch.autograd.grad(out, ts, dy)


@pytest.mark.parametrize("relu,residual", CHAINS)
@pytest.mark.parametrize("shape", SHAPES)
def test_plain_version_is_the_module_chain_float64(shape, relu, residual):
    c = shape[1]
    bns = [_bn(c), _bn(c)]
    results = []
    for i, call in enumerate((
            lambda bn, x, z: bn_add_relu(bn, x, relu, z),
            lambda bn, x, z: bn_train.bn_train_reference(x, bn.weight, bn.bias, bn.running_mean,
                                                         bn.running_var, MOMENTUM, EPS, z,
                                                         relu))):
        bn = bns[i]
        for seed in (1, 2):     # two calls: the running statistics move twice
            x, z, dy = (t.requires_grad_() for t in _maps(shape, seed=seed))
            z = z if residual else None
            out = call(bn, x, z)
        ins = (x, bn.weight, bn.bias) + ((z,) if residual else ())
        results.append((out.detach(), _grads(out, dy, *ins), bn.running_mean.clone(),
                        bn.running_var.clone()))
    (out, grads, mean, var), (ref, ref_grads, ref_mean, ref_var) = results
    torch.testing.assert_close(ref, out, rtol=1e-10, atol=1e-12)
    for g, rg in zip(grads, ref_grads):
        torch.testing.assert_close(rg, g, rtol=1e-9, atol=1e-11)
    torch.testing.assert_close(ref_mean, mean, rtol=1e-12, atol=1e-14)
    torch.testing.assert_close(ref_var, var, rtol=1e-12, atol=1e-14)
    assert not torch.equal(var, _bn(c).running_var)


def emulated_kernels(monkeypatch):
    """The four wrappers replaced by float64 stand-ins of the kernels'
    arithmetic, counting their calls as the wrappers do."""
    def batch_stats(x, running_mean, running_var, momentum, eps):
        var, mean = torch.var_mean(x, dim=(0, 2, 3), correction=0)
        running_mean.mul_(1 - momentum).add_(momentum * mean)
        running_var.mul_(1 - momentum).add_(momentum * var)
        batch_stats.launches += 1
        return mean, torch.rsqrt(var + eps)

    def normalize(x, mean, invstd, weight, bias, z=None, relu=True):
        out = (x - mean[:, None, None]) * (weight * invstd)[:, None, None] + bias[:, None, None]
        out = out if z is None else out + z
        normalize.launches += 1
        return out.clamp(min=0) if relu else out

    def masked(dy, x, y, mean, invstd, weight, bias, mask):
        if mask == bn_train._MASK_RECOMPUTE:
            a = (weight * invstd)[:, None, None]
            return dy * ((x - mean[:, None, None]) * a + bias[:, None, None] > 0)
        return dy * (y > 0) if mask == bn_train._MASK_FROM_Y else dy

    def backward_reduce(dy, x, y, mean, invstd, weight, bias, mask):
        g = masked(dy, x, y, mean, invstd, weight, bias, mask)
        xhat = (x - mean[:, None, None]) * invstd[:, None, None]
        backward_reduce.launches += 1
        sums = torch.stack([g.sum(dim=(0, 2, 3)), (g * xhat).sum(dim=(0, 2, 3))])
        return sums, g if mask == bn_train._MASK_FROM_Y else dy

    def backward_elemt(g, x, mean, invstd, weight, bias, sums, recompute):
        if recompute:
            g = masked(g, x, None, mean, invstd, weight, bias, bn_train._MASK_RECOMPUTE)
        rows = x.numel() // x.shape[1]
        xhat = (x - mean[:, None, None]) * invstd[:, None, None]
        k1, k2 = (s[:, None, None] / rows for s in sums)
        backward_elemt.launches += 1
        return (weight * invstd)[:, None, None] * (g - k1 - xhat * k2)

    for fn in (batch_stats, normalize, backward_reduce, backward_elemt):
        fn.launches = 0
        monkeypatch.setattr(bn_train, fn.__name__, fn)
    return batch_stats, normalize, backward_reduce, backward_elemt


@pytest.mark.parametrize("relu,residual", CHAINS)
@pytest.mark.parametrize("shape", SHAPES[:3])
def test_function_places_the_kernels_results(monkeypatch, shape, relu, residual):
    fns = emulated_kernels(monkeypatch)
    c = shape[1]
    x, z, dy = (t.requires_grad_() for t in _maps(shape, layout=torch.channels_last))
    z = z if residual else None
    ins = (x, ) + ((z,) if residual else ())
    outs = []
    for fused in (True, False):
        bn = _bn(c)
        if fused:
            out = bn_train.BatchNormTrain.apply(x, bn.weight, bn.bias, z, bn.running_mean,
                                                bn.running_var, MOMENTUM, EPS, relu)
        else:
            out = bn_train.bn_train_reference(x, bn.weight, bn.bias, bn.running_mean,
                                              bn.running_var, MOMENTUM, EPS, z, relu)
        outs.append((out.detach(), _grads(out, dy, *ins, bn.weight, bn.bias),
                     bn.running_mean, bn.running_var))
    for got, want in zip(outs[0], outs[1]):
        torch.testing.assert_close(got, want, rtol=1e-10, atol=1e-12)
    assert [fn.launches for fn in fns] == [1, 1, 1, 1]


@pytest.fixture
def fused_on_cpu(monkeypatch):
    """The rule takes CPU tensors, where ``bn_train`` runs the plain version."""
    monkeypatch.setattr(bn_train, "DEVICES", ("cuda", "cpu"))


def _fused_calls(call) -> int:
    before = trace.counters().get("bn.train_fused", 0)
    call()
    return trace.counters().get("bn.train_fused", 0) - before


def _bf16_maps(c: int = 32, layout=torch.channels_last):
    x, z, _ = _maps((2, c, 9, 9), dtype=torch.float32, layout=layout)
    return x.to(torch.bfloat16), z.to(torch.bfloat16)


def test_rule_leaves_the_modules_on_the_cpu():
    bn = _bn(32, torch.float32)
    x, z = _bf16_maps()
    assert not trains_fused(bn, x, z)
    assert _fused_calls(lambda: bn_add_relu(bn, x, True, z)) == 0


def test_rule_fuses_a_train_mode_bf16_channels_last_map(fused_on_cpu):
    bn, twin = _bn(32, torch.float32), _bn(32, torch.float32)
    x, z = _bf16_maps()
    assert trains_fused(bn, x, z)
    outs = []
    assert _fused_calls(lambda: outs.append(bn_add_relu(bn, x, True, z))) == 1
    assert _fused_calls(lambda: outs.append(bn(x))) == 1     # the module's own forward
    assert int(bn.num_batches_tracked) == 2
    refs = [bn_train.bn_train_reference(x, twin.weight, twin.bias, twin.running_mean,
                                        twin.running_var, MOMENTUM, EPS, *args)
            for args in ((z, True), (None, False))]
    for got, want in zip(outs + [bn.running_mean, bn.running_var],
                         refs + [twin.running_mean, twin.running_var]):
        torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize("case", ["forward hook", "pre-hook", "float32", "NCHW", "eval",
                                  "channels not a multiple of 8"])
def test_rule_falls_back_to_the_modules(fused_on_cpu, case):
    c = 36 if case == "channels not a multiple of 8" else 32
    bn = _bn(c, torch.float32)
    x, z = _bf16_maps(c, torch.contiguous_format if case == "NCHW" else torch.channels_last)
    if case == "forward hook":
        bn.register_forward_hook(lambda *a: None)
    elif case == "pre-hook":
        bn.register_forward_pre_hook(lambda *a: None)
    elif case == "float32":
        x, z = x.float(), z.float()
    elif case == "eval":
        bn.eval()
    assert not trains_fused(bn, x, z)
    assert _fused_calls(lambda: bn_add_relu(bn, x, True, z)) == 0


def test_rule_leaves_a_synced_bn_to_its_collective(fused_on_cpu, monkeypatch):
    sync = SyncBatchNorm2d(32).train()
    x, z = _bf16_maps()
    assert not dist.is_initialized() and trains_fused(sync, x, z)   # no group: its own rows
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_world_size", lambda *a: 2)
    assert sync.synced() and not trains_fused(sync, x, z)


def test_unfrozen_base_step_fuses_every_train_mode_bn(fused_on_cpu):
    torch.manual_seed(0)
    model = SiamMaskBase(width=8, dtype=torch.bfloat16)
    model.features.features.unfix(True)
    model.train()
    z = (255 * torch.rand(2, 3, 127, 127)).contiguous(memory_format=torch.channels_last)
    x = (255 * torch.rand(2, 3, 255, 255)).contiguous(memory_format=torch.channels_last)
    training = [m for m in model.modules() if isinstance(m, BatchNorm2d) and m.training]
    assert len(training) == 42
    outs = []
    assert _fused_calls(lambda: outs.extend(model.forward_train(z, x))) == 75
    sum(o.float().sum() for o in outs).backward()
    assert all(m.weight.grad is not None for m in training)
    assert {int(m.num_batches_tracked) for m in training} <= {1, 2}


def test_uncounted_takes_back_the_bn_launches():
    before = [fn.launches for fn in bn_train.WRAPPERS]
    with trace.uncounted():
        for fn in bn_train.WRAPPERS:
            fn.launches += 3
    assert [fn.launches for fn in bn_train.WRAPPERS] == before
