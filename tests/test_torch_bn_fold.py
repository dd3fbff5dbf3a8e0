"""Eval-mode BatchNorm folded into its conv (``ops/bn_fold.py``,
``models/resnet.py`` ``folds`` / ``conv_bn``), on the CPU.

On the CPU every pair runs unfolded (the JAX package's tests hold that
path), so the folded path is run here by letting the fold take CPU tensors
(``bn_fold.DEVICES``), where its fused call is the plain version
(``conv_bias_relu_reference``: ``F.conv2d`` + bias + add + ReLU):

- the fold's (W', b') through the plain call against conv -> BN (-> add)
  (-> ReLU), at every pair shape the tracker has, in float64 and float32;
- a block's downsample run bias-free with its folded bias merged into
  conv3's gives the block's output (an unfolded block runs its BNs in the
  order it always has), and each family's entry points give
  the unfolded model's maps, counting ``conv.bn_folded`` once a pair;
- the gate (``folds``): train mode, a gradient through the pair, a hook,
  or a CPU tensor leave the pair unfolded and its output bit for bit;
- the cache: made again in the same storage after an in-place change to
  each of its five sources (and after a train-mode step), by a forward or
  by ``bn_fold.refresh`` (which ``Tracker.step_graph`` calls), usable
  outside inference mode after being made inside it, empty in a copy of
  the module; a fold changes no parameter, buffer or ``state_dict`` entry.
"""
import copy
import pickle
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from siammask_tpu_torch.config import Config
from siammask_tpu_torch.models import resnet
from siammask_tpu_torch.models.resnet import BatchNorm2d, Conv2d, conv_bn, folds
from siammask_tpu_torch.models.siammask import SiamMaskBase, SiamMaskSharp, SiamRPN
from siammask_tpu_torch.ops import bn_fold
from siammask_tpu_torch.tracker import tracker as tracker_module
from siammask_tpu_torch.tracker.tracker import Tracker
from siammask_tpu_torch.utils import trace

from test_torch_tracker import one_torch_thread  # noqa: F401  (autouse)

EXPERIMENTS = Path(__file__).resolve().parents[1] / "experiments"
WIDTH = 8
# name -> (in, out, kernel, stride, padding, dilation, input side): each
# conv -> BN pair shape of the tracker (published widths cut to a few)
PAIRS = {"stem 7x7/2 pad 0": (3, 8, 7, 2, 0, 1, 31),
         "1x1": (16, 32, 1, 1, 0, 1, 9),
         "3x3/2 pad 0 (layer2, its downsample)": (8, 8, 3, 2, 0, 1, 15),
         "3x3 dilation 2 (layer3)": (8, 8, 3, 1, 2, 2, 11),
         "3x3 pad 1 (layer3's downsample)": (16, 32, 3, 1, 1, 1, 11),
         "3x3 pad 0 (the heads' adjust convs)": (8, 8, 3, 1, 0, 1, 9)}
SOURCES = ("conv.weight", "bn.weight", "bn.bias", "bn.running_mean", "bn.running_var")
FAMILIES = {"sharp": SiamMaskSharp, "base": SiamMaskBase, "siamrpn": SiamRPN}


@pytest.fixture
def fold_on_cpu(monkeypatch):
    """The fold takes CPU tensors, its fused call the plain version."""
    monkeypatch.setattr(bn_fold, "DEVICES", ("cuda", "cpu"))


def _randomize_bn(module: torch.nn.Module, seed: int = 0) -> None:
    """Statistics and affine terms far from the identity, so a wrong fold shows."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                c = m.num_features
                m.weight.copy_(torch.rand(c, generator=g) + 0.5)
                m.bias.copy_(torch.rand(c, generator=g) - 0.5)
                m.running_mean.copy_(torch.rand(c, generator=g) - 0.5)
                m.running_var.copy_(torch.rand(c, generator=g) * 2 + 0.25)


def _pair(name: str, dtype=torch.float64, seed: int = 0):
    cin, cout, k, s, p, d, hw = PAIRS[name]
    conv = Conv2d(cin, cout, k, stride=s, padding=p, dilation=d, bias=False).to(dtype)
    bn = BatchNorm2d(cout).to(dtype)
    torch.nn.init.normal_(conv.weight, 0.0, (cin * k * k) ** -0.5,
                          generator=torch.Generator().manual_seed(seed + 1))
    _randomize_bn(bn, seed)
    x = torch.randn(2, cin, hw, hw, dtype=dtype, generator=torch.Generator().manual_seed(seed + 2))
    return conv.eval(), bn.eval(), x


def _folded_count(fn):
    before = trace.counters().get("conv.bn_folded", 0)
    out = fn()
    return out, trace.counters().get("conv.bn_folded", 0) - before


@pytest.mark.parametrize("epilogue", ["relu", "add relu", "none"])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["float64", "float32"])
@pytest.mark.parametrize("name", sorted(PAIRS))
def test_fold_through_the_plain_call_is_conv_bn(name, dtype, epilogue):
    conv, bn, x = _pair(name, dtype)
    with torch.no_grad():
        ref = bn(conv(x))
        z = torch.randn(ref.shape, dtype=dtype, generator=torch.Generator().manual_seed(9))
        if epilogue == "add relu":
            ref = ref + z
        if epilogue != "none":
            ref = F.relu(ref)
        w, b = bn_fold.fold(conv.weight, bn.weight, bn.bias, bn.running_mean, bn.running_var,
                            bn.eps)
        assert w.dtype == b.dtype == dtype
        out = bn_fold.conv_bias_relu(x, w, b, conv.stride, conv.padding, conv.dilation,
                                     z if epilogue == "add relu" else None, epilogue != "none")
    scale = ref.abs().max().item()
    tol = 1e-12 if dtype == torch.float64 else 1e-5
    torch.testing.assert_close(out, ref, rtol=tol, atol=tol * scale)


# (inplanes, planes, stride, dilation): layer1's (a 1x1 downsample), layer2's
# (3x3/2 pad 0) and layer3's (3x3 pad 1) first blocks
BLOCKS = {"layer1": (8, 2, 1, 1), "layer2": (8, 4, 2, 1), "layer3": (16, 8, 1, 2)}


@pytest.mark.parametrize("stage", sorted(BLOCKS))
def test_downsample_bias_merged_into_conv3_gives_the_block(stage, fold_on_cpu, monkeypatch):
    inplanes, planes, stride, dilation = BLOCKS[stage]
    block = resnet._make_layer(inplanes, planes, 1, stride, dilation)[0].double().eval()
    _randomize_bn(block, 3)
    x = torch.randn(2, inplanes, 17, 17, dtype=torch.float64,
                    generator=torch.Generator().manual_seed(4))
    with torch.enable_grad():
        ref = block(x).detach()     # the parameters ask for gradients: unfolded
    calls = []
    real = bn_fold.conv_bias_relu

    def recording(x, weight, bias, *args):
        calls.append((bias, args[3], args[4]))
        return real(x, weight, bias, *args)

    monkeypatch.setattr(bn_fold, "conv_bias_relu", recording)
    with torch.no_grad():
        out, n = _folded_count(lambda: block(x))
    assert n == 4
    # conv1, conv2 (ReLU), the downsample (no bias, no ReLU), conv3 (+ residual, ReLU)
    assert [(b is None, z is None, relu) for b, z, relu in calls] == \
        [(False, True, True), (False, True, True), (True, True, False), (False, False, True)]
    ds_bias = bn_fold.fold(block.downsample[0].weight, *(getattr(block.downsample[1], k) for k in (
        "weight", "bias", "running_mean", "running_var")), block.downsample[1].eps)[1]
    conv3_bias = bn_fold.fold(block.conv3.weight, block.bn3.weight, block.bn3.bias,
                              block.bn3.running_mean, block.bn3.running_var, block.bn3.eps)[1]
    torch.testing.assert_close(calls[3][0], ds_bias + conv3_bias, rtol=1e-14, atol=1e-14)
    torch.testing.assert_close(out, ref, rtol=1e-12, atol=1e-12 * ref.abs().max().item())


@pytest.mark.parametrize("stage", sorted(BLOCKS))
def test_unfolded_block_runs_its_batchnorms_in_order(stage):
    """The downsample first, then bn1-bn3: hooks that draw from one generator
    in the order the BNs run (the training tests' calibration) see the
    order they always saw."""
    inplanes, planes, stride, dilation = BLOCKS[stage]
    block = resnet._make_layer(inplanes, planes, 1, stride, dilation)[0].eval()
    seen = []
    for name, m in block.named_modules():
        if isinstance(m, torch.nn.BatchNorm2d):
            m.register_forward_pre_hook(lambda mod, inputs, name=name: seen.append(name))
    with torch.no_grad():
        block(torch.randn(1, inplanes, 17, 17))
    assert seen == ["downsample.1", "bn1", "bn2", "bn3"]


def _pairs_run(model, search_pass: str) -> int:
    """conv -> BN pairs of a template pass and a search pass: every BN of
    the model but sharp's unused 1x1 mask head's (``track_mask`` computes no
    head map)."""
    bns = sum(isinstance(m, torch.nn.BatchNorm2d) for m in model.modules())
    template = sum(isinstance(m, torch.nn.BatchNorm2d) for m in model.features.modules())
    unused = 1 if search_pass == "track_mask" and isinstance(model, SiamMaskSharp) else 0
    return template + bns - unused


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_folded_model_gives_the_unfolded_maps(family, fold_on_cpu):
    model = FAMILIES[family](width=WIDTH).init_weights(torch.Generator().manual_seed(0))
    model = model.double().eval()
    _randomize_bn(model, 5)
    g = torch.Generator().manual_seed(6)
    z = torch.rand(2, 3, 127, 127, dtype=torch.float64, generator=g) * 255
    x = torch.rand(2, 3, 255, 255, dtype=torch.float64, generator=g) * 255
    search = "track_mask" if hasattr(model, "track_mask") else "track"

    def run():
        out = getattr(model, search)(model.template(z), x)
        if isinstance(model, SiamMaskSharp):
            out = (*out[:2], model.track_refine(out.skips, out.corr,
                                                torch.tensor([[3, 4], [12, 12]])))
        return out

    with torch.enable_grad():
        ref = run()             # the parameters ask for gradients: unfolded
    with torch.no_grad():
        out, n = _folded_count(run)
    assert n == _pairs_run(model, search)
    for a, b in zip(out, ref):
        torch.testing.assert_close(a, b.detach(), rtol=1e-11,
                                   atol=1e-11 * b.abs().max().item())


def _unfolded(conv, bn, x):
    return F.relu(bn(conv(x)))


GATES = ["train mode", "conv weight asks for a gradient", "BN weight asks for a gradient",
         "input asks for a gradient", "hook on the conv", "pre-hook on the BN"]


@pytest.mark.parametrize("gate", GATES)
def test_gate_leaves_the_pair_unfolded(gate, fold_on_cpu):
    conv, bn, x = _pair("1x1")
    conv.requires_grad_(False)
    bn.requires_grad_(False)
    with torch.no_grad():
        assert folds(conv, bn, x)
    if gate == "train mode":
        bn.train()
    elif gate == "conv weight asks for a gradient":
        conv.weight.requires_grad_(True)
    elif gate == "BN weight asks for a gradient":
        bn.weight.requires_grad_(True)
    elif gate == "input asks for a gradient":
        x.requires_grad_(True)
    elif gate == "hook on the conv":
        conv.register_forward_hook(lambda *a: None)
    else:
        bn.register_forward_pre_hook(lambda *a: None)
    before = (bn.running_mean.clone(), bn.running_var.clone())
    assert not folds(conv, bn, x)
    out, n = _folded_count(lambda: conv_bn(conv, bn, x))
    assert n == 0
    bn.running_mean.copy_(before[0])          # undo train mode's update
    bn.running_var.copy_(before[1])
    assert torch.equal(out, _unfolded(conv, bn, x))


def test_gate_folds_a_frozen_pair_with_autograd_on(fold_on_cpu):
    """A frozen stage in training: autograd on, nothing asks for a gradient."""
    conv, bn, x = _pair("1x1")
    conv.requires_grad_(False)
    bn.requires_grad_(False)
    assert torch.is_grad_enabled() and folds(conv, bn, x)
    out, n = _folded_count(lambda: conv_bn(conv, bn, x))
    assert n == 1 and not out.requires_grad
    torch.testing.assert_close(out, _unfolded(conv, bn, x), rtol=1e-12, atol=1e-12)


def test_gate_leaves_a_cpu_tensor_unfolded():
    """Without the test's patch the CPU runs every pair as the two modules."""
    conv, bn, x = _pair("3x3/2 pad 0 (layer2, its downsample)")
    with torch.no_grad():
        assert not folds(conv, bn, x)
        out, n = _folded_count(lambda: conv_bn(conv, bn, x))
    assert n == 0 and not conv.bn_folds._entries
    assert torch.equal(out, _unfolded(conv, bn, x))
    model = SiamMaskSharp(width=WIDTH).eval()
    with torch.no_grad():
        _, n = _folded_count(lambda: model.template(torch.rand(1, 3, 127, 127) * 255))
    assert n == 0


def _source(conv, bn, name: str) -> torch.Tensor:
    owner, attr = name.split(".")
    return getattr(conv if owner == "conv" else bn, attr)


@pytest.mark.parametrize("by", ["forward", "refresh"])
@pytest.mark.parametrize("name", SOURCES)
def test_cache_remade_in_place_after_a_source_changes(name, by, fold_on_cpu):
    conv, bn, x = _pair("3x3 dilation 2 (layer3)")
    with torch.no_grad():
        conv_bn(conv, bn, x)
        (entry,) = conv.bn_folds._entries.values()
        kept = [v.data_ptr() for v in entry[1]]
        _source(conv, bn, name).mul_(1.5).add_(0.25)
        if by == "refresh":
            bn_fold.refresh(torch.nn.Sequential(conv, bn))
            w, b = bn_fold.fold(conv.weight, bn.weight, bn.bias, bn.running_mean,
                                bn.running_var, bn.eps)
            assert torch.equal(entry[1][0], w) and torch.equal(entry[1][1], b)
        out, n = _folded_count(lambda: conv_bn(conv, bn, x))
    assert n == 1 and len(conv.bn_folds._entries) == 1
    assert [v.data_ptr() for v in entry[1]] == kept
    ref = _unfolded(conv, bn, x)
    torch.testing.assert_close(out, ref, rtol=1e-12, atol=1e-12 * ref.abs().max().item())


def test_cache_follows_a_train_mode_step(fold_on_cpu):
    """A train-mode forward moves the running statistics (the native kernel
    leaves ``running_mean``'s version as it was); the next eval forward
    folds the new ones."""
    conv, bn, x = _pair("1x1")
    with torch.no_grad():
        conv_bn(conv, bn, x)
        bn.train()
        conv_bn(conv, bn, x * 3 + 1)
        bn.eval()
        out, n = _folded_count(lambda: conv_bn(conv, bn, x))
    assert n == 1
    ref = _unfolded(conv, bn, x)
    torch.testing.assert_close(out, ref, rtol=1e-12, atol=1e-12 * ref.abs().max().item())


def test_cache_made_in_inference_mode_serves_outside_it(fold_on_cpu):
    conv, bn, x = _pair("1x1")
    with torch.inference_mode():
        conv_bn(conv, bn, x)
    (entry,) = conv.bn_folds._entries.values()
    assert not any(v.is_inference() for v in entry[1])
    with torch.no_grad():
        bn.running_var.mul_(2)
        out = conv_bn(conv, bn, x)
    torch.testing.assert_close(out, _unfolded(conv, bn, x), rtol=1e-12, atol=1e-12)


def test_pair_made_in_inference_mode_folds_its_current_values(fold_on_cpu):
    """Tensors made under inference mode track no version: their fold is made
    anew at each call, so an in-place change there is taken at once."""
    with torch.inference_mode():
        conv, bn, x = _pair("1x1")
        conv_bn(conv, bn, x)
        bn.running_var.mul_(2)
        out, n = _folded_count(lambda: conv_bn(conv, bn, x))
        ref = _unfolded(conv, bn, x)
    assert n == 1 and not conv.bn_folds._entries
    bn_fold.refresh(torch.nn.Sequential(conv, bn))
    torch.testing.assert_close(out, ref, rtol=1e-12, atol=1e-12)


def test_fold_changes_no_module_state_and_copies_start_empty(fold_on_cpu):
    model = SiamMaskSharp(width=WIDTH).init_weights(torch.Generator().manual_seed(0)).eval()
    _randomize_bn(model, 7)
    before = {k: (v.clone(), v.data_ptr()) for k, v in model.state_dict().items()}
    with torch.no_grad():
        model.template(torch.rand(1, 3, 127, 127) * 255)
    after = model.state_dict()
    assert list(after) == list(before)
    for k, v in after.items():
        assert torch.equal(v, before[k][0]) and v.data_ptr() == before[k][1], k
    assert not [k for k in after if "fold" in k]
    conv = model.features.features.conv1
    assert conv.bn_folds._entries
    assert not copy.deepcopy(model).features.features.conv1.bn_folds._entries
    assert not pickle.loads(pickle.dumps(conv)).bn_folds._entries


def test_tracker_refreshes_the_folds_where_it_fetches_a_graph(fold_on_cpu, monkeypatch):
    """``Tracker.step_graph`` brings the folded weights up to the model's
    before it captures or runs a graph (a replay runs no Python)."""
    p = Config.load(str(EXPERIMENTS / "siammask_sharp" / "config_davis.json")).tracker_config()
    model = SiamMaskSharp(width=WIDTH).init_weights(torch.Generator().manual_seed(0)).eval()
    tracker = Tracker(model, p, "cpu")
    frames = torch.from_numpy(np.random.RandomState(1).randint(0, 256, (2, 120, 160, 3))
                              .astype(np.uint8))
    states = tracker.init_batched(frames[0], torch.tensor([[80.0, 60.0]]),
                                  torch.tensor([[40.0, 30.0]]))
    conv, bn = model.features.features.conv1, model.features.features.bn1
    (entry,) = conv.bn_folds._entries.values()
    with torch.no_grad():
        bn.running_var.mul_(4)
    seen = []
    monkeypatch.setattr(tracker_module, "StepGraph",
                        lambda tr, st, frame, side: seen.append(entry[1][1].clone()))
    monkeypatch.setattr(torch.cuda, "Stream", lambda device: None)
    monkeypatch.setattr(tracker, "_before_capture", lambda h, w: None)   # no nvcc here
    tracker.step_graph(states, frames[1:])
    w, b = bn_fold.fold(conv.weight, bn.weight, bn.bias, bn.running_mean, bn.running_var,
                        bn.eps)
    assert torch.equal(seen[0], b) and torch.equal(entry[1][0], w)
