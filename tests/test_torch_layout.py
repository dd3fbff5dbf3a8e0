"""The model's memory layout (``ops/layout.py``), on the CPU at width 8.

The port's maps keep their input's memory layout: channels_last (NHWC
memory) where the tracker's crops and the trainer's batches come from a
card, NCHW on the CPU. Both layouts run the same ops on the same values, so
each family's outputs, losses, gradients and updates must agree between
them to float64 rounding, and a channels_last run must stay channels_last
through every conv, with no copy before the xcorr. On the CPU the tracker
and the trainer hand the model NCHW, so a channels_last run is made here by
handing the model channels_last tensors directly, or by patching the entry
points' ``model_input``.

- ``memory_format`` reads the layout from the strides; ``model_input``
  gives NCHW on the CPU;
- ``Conv2d`` keeps a channels_last input's layout and leaves its
  parameters and ``state_dict`` as stored;
- ``template``, ``track`` / ``track_mask`` and ``track_refine`` of the
  three families, the window gathers and unfolds, in both layouts;
- one ``Trainer.step`` per task (siamrpn, base, sharp), unfrozen, in both
  layouts: metrics, every gradient, parameters and BN statistics;
- the tracker's step for every path (sharp with and without Refine, base,
  box only) in both layouts;
- the xcorr takes the adjust convs' outputs with no copy;
- the counters ``conv.channels_last`` and ``conv.contiguous``;
- a model after a channels_last step saves and loads through
  ``train/checkpoint.py`` and the JAX package's loader with its values.
"""
from pathlib import Path

import numpy as np
import pytest
import torch

from siammask_tpu.utils.torch_convert import load_torch_checkpoint
from siammask_tpu_torch.config import Config
from siammask_tpu_torch.models import heads
from siammask_tpu_torch.models.heads import slice_skip_windows, unfold_skip_windows
from siammask_tpu_torch.models.resnet import Conv2d
from siammask_tpu_torch.models.siammask import SiamMaskBase, SiamMaskSharp, SiamRPN
from siammask_tpu_torch.ops.layout import memory_format, model_input
from siammask_tpu_torch.ops.unfold import unfold, unfold_windows
from siammask_tpu_torch.tracker import tracker as tracker_module
from siammask_tpu_torch.tracker.tracker import Tracker
from siammask_tpu_torch.train import trainer as trainer_module
from siammask_tpu_torch.train.checkpoint import load_checkpoint, save_checkpoint
from siammask_tpu_torch.train.lr import build_lr_spaces
from siammask_tpu_torch.train.trainer import OptimizerConfig, Trainer, TrainSettings
from siammask_tpu_torch.utils import trace
from siammask_tpu_torch.utils.convert import state_dict_from_jax

from test_torch_tracker import one_torch_thread  # noqa: F401  (autouse)
from test_torch_train_tasks import make_batch

EXPERIMENTS = Path(__file__).resolve().parents[1] / "experiments"
WIDTH = 8
CL = torch.channels_last
NCHW = torch.contiguous_format
FAMILIES = {"siamrpn": SiamRPN, "base": SiamMaskBase, "sharp": SiamMaskSharp}
# task -> (model class, config, loss weights or None for the config's)
TASKS = {"siamrpn": (SiamRPN, EXPERIMENTS / "siamrpn_resnet" / "config.json", None),
         "base": (SiamMaskBase, EXPERIMENTS / "siammask_base" / "config.json", None),
         "sharp": (SiamMaskSharp, EXPERIMENTS / "siammask_sharp" / "config.json",
                   (1.0, 1.0, 36.0))}
# tracker path -> (model class, config, Tracker's mask and refine)
PATHS = {"sharp": (SiamMaskSharp, EXPERIMENTS / "siammask_sharp" / "config_davis.json", True,
                   True),
         "sharp-raw": (SiamMaskSharp, EXPERIMENTS / "siammask_base" / "config.json", True,
                       False),
         "base": (SiamMaskBase, EXPERIMENTS / "siammask_base" / "config.json", True, False),
         "rpn": (SiamRPN, EXPERIMENTS / "siamrpn_resnet" / "config.json", False, False)}
EPOCHS = 2
RTOL = 1e-9     # float64: the layouts sum each conv in another order


def _close(ours, ref, name, scale=None):
    """float64 agreement, relative to the tensor's largest value or to
    ``scale``, that of its kind over the model (a BN bias that feeds a
    train-mode BN takes a gradient of rounding noise alone)."""
    ours, ref = ours.detach(), ref.detach()
    assert ours.shape == ref.shape, name
    scale = scale or ref.abs().max().item() or 1.0
    torch.testing.assert_close(ours, ref, rtol=RTOL, atol=RTOL * scale, msg=name)


def _largest(tensors):
    return max(t.detach().abs().max().item() for t in tensors)


def _model(cls, seed=0):
    return cls(width=WIDTH).init_weights(torch.Generator().manual_seed(seed)).double().eval()


def _images(seed=0, b=2, search=255):
    g = torch.Generator().manual_seed(seed)
    z = torch.rand((b, 3, 127, 127), generator=g, dtype=torch.float64) * 255
    x = torch.rand((b, 3, search, search), generator=g, dtype=torch.float64) * 255
    return z, x


def _maps(out):
    """The 4-D tensors among a model call's outputs."""
    flat = []
    for v in (out if isinstance(out, tuple) else (out,)):
        flat += _maps(v) if isinstance(v, tuple) else [v]
    return [v for v in flat if v.dim() == 4]


def _convs(fn):
    """fn's result and the conv calls it made, by input layout."""
    before = trace.counters()
    out = fn()
    after = trace.counters()
    return out, {k: after.get(k, 0) - before.get(k, 0)
                 for k in ("conv.channels_last", "conv.contiguous")}


def test_memory_format_reads_the_strides():
    x = torch.zeros(2, 8, 15, 15)
    assert memory_format(x) is NCHW
    assert memory_format(x.contiguous(memory_format=CL)) is CL
    assert memory_format(x.permute(0, 2, 3, 1).contiguous().permute(0, 3, 1, 2)) is CL
    # a slice of NHWC memory (the neck's 7x7 crop of the template map)
    assert memory_format(x.contiguous(memory_format=CL)[:, :, 4:-4, 4:-4]) is CL
    # one pixel or one channel: both layouts are the same memory
    assert memory_format(torch.zeros(2, 8, 1, 1)) is NCHW
    assert memory_format(torch.zeros(2, 1, 15, 15)) is NCHW
    # the CPU hands the model NCHW, whatever it is given
    assert model_input(x.contiguous(memory_format=CL)).is_contiguous()
    assert model_input(x) is x


@pytest.mark.parametrize("dtype", [None, torch.bfloat16, torch.float64])
def test_conv_keeps_the_input_layout_and_its_parameters(dtype):
    conv = Conv2d(8, 6, 3, padding=1, dtype=dtype)
    if dtype is torch.float64:
        conv = conv.double()
    strides = {k: v.stride() for k, v in conv.state_dict().items()}
    x = torch.randn(2, 8, 9, 9, dtype=conv.weight.dtype, requires_grad=True)
    x_cl = x.detach().contiguous(memory_format=CL).requires_grad_(True)
    (y, counts), (y_cl, counts_cl) = _convs(lambda: conv(x)), _convs(lambda: conv(x_cl))
    assert counts == {"conv.channels_last": 0, "conv.contiguous": 1}
    assert counts_cl == {"conv.channels_last": 1, "conv.contiguous": 0}
    assert y.is_contiguous() and y_cl.is_contiguous(memory_format=CL)
    assert y_cl.dtype == y.dtype == (dtype or conv.weight.dtype)
    torch.testing.assert_close(y_cl, y)
    y_cl.float().square().sum().backward()
    assert conv.weight.grad.is_contiguous() and conv.weight.grad.dtype == conv.weight.dtype
    assert {k: v.stride() for k, v in conv.state_dict().items()} == strides
    assert conv.weight.is_contiguous()
    assert set(conv.state_dict()) == {"weight", "bias"}


@pytest.mark.parametrize("family", FAMILIES)
@torch.no_grad()
def test_inference_matches_across_layouts(family):
    """``template``, ``track`` / ``track_mask`` and sharp's ``track_refine``
    (at cells on the map's edges, whose windows reach past the maps) give the
    same maps from NCHW and channels_last inputs; the channels_last run's
    maps are channels_last and every conv in it takes channels_last, the
    NCHW run's none."""
    model = _model(FAMILIES[family])
    z, x = _images()
    pos = torch.tensor([[0, 24], [13, 2]])

    def run(z, x):
        zf = model.template(z)
        if family == "siamrpn":
            return zf, model.track(zf, x)
        out = model.track_mask(zf, x)
        if family == "sharp":
            return zf, out, model.track_refine(out.skips, out.corr, pos)
        return zf, out

    ref, counts = _convs(lambda: run(z, x))
    ours, counts_cl = _convs(lambda: run(z.contiguous(memory_format=CL),
                                         x.contiguous(memory_format=CL)))
    assert counts["conv.channels_last"] == counts_cl["conv.contiguous"] == 0
    assert counts["conv.contiguous"] == counts_cl["conv.channels_last"] > 0
    flat, flat_ref = _maps(ours), _maps(ref)
    for i, (a, b) in enumerate(zip(flat, flat_ref)):
        assert memory_format(a) is CL and memory_format(b) is NCHW, i
        _close(a, b, f"{family} map {i}")
    if family == "sharp":
        _close(ours[-1], ref[-1], "refined logits")


@pytest.mark.parametrize("kernel,padding,stride", [((15, 15), 0, 1), ((5, 5), 0, 3),
                                                   ((3, 3), 1, 1)])
def test_unfold_gives_the_same_windows_in_either_layout(kernel, padding, stride):
    """Both lowerings (few windows as slices; ``Tensor.unfold``, padded
    too): the same windows, and from channels_last maps windows whose
    channels are innermost."""
    x = torch.randn(2, 6, 17, 17, dtype=torch.float64)
    ref = unfold_windows(x, kernel, padding, stride)
    ours = unfold_windows(x.contiguous(memory_format=CL), kernel, padding, stride)
    assert torch.equal(ours, ref)
    assert ref.is_contiguous() and ours.permute(0, 1, 3, 4, 2).is_contiguous()
    assert torch.equal(unfold(x.contiguous(memory_format=CL), kernel, padding, stride),
                       unfold(x, kernel, padding, stride))


def test_skip_windows_keep_the_maps_layout():
    """Refine's windows at chosen cells and at every cell: the same values
    from both layouts, channels_last from channels_last maps, and one merged
    axis of windows a channels_last view with no copy of its own."""
    g = torch.Generator().manual_seed(3)
    maps = [torch.randn(2, c, n, n, generator=g, dtype=torch.float64)
            for c, n in ((8, 125), (32, 63), (64, 31))]
    maps_cl = [m.contiguous(memory_format=CL) for m in maps]
    pos = torch.tensor([[0, 24], [12, 7]])
    for a, b in zip(slice_skip_windows(*maps_cl, pos), slice_skip_windows(*maps, pos)):
        assert torch.equal(a, b)
        assert memory_format(a) is CL and b.is_contiguous()
    # the stage-2 shapes: 143 -> 71 / 35 / 17, a 3x3 grid of cells
    maps = [m[:, :, :s, :s] for m, s in zip(maps, (71, 35, 17))]
    maps_cl = [m.contiguous(memory_format=CL) for m in maps]
    for a, b in zip(unfold_skip_windows(*maps_cl), unfold_skip_windows(*maps)):
        assert torch.equal(a, b)
        assert a.is_contiguous(memory_format=CL) and b.is_contiguous()


def test_xcorr_takes_the_adjust_convs_outputs_without_a_copy(monkeypatch):
    """In a channels_last forward the xcorr's two inputs are the adjust
    convs' outputs themselves (same storage), for each of the three heads."""
    model = _model(SiamMaskSharp)
    adjusted, taken = [], []

    def record(module, inputs, out):
        adjusted.append(out.data_ptr())

    def xcorr(x, k):
        taken.extend((k.data_ptr(), x.data_ptr()))
        return depthwise_xcorr(x, k)

    depthwise_xcorr = heads.depthwise_xcorr
    monkeypatch.setattr(heads, "depthwise_xcorr", xcorr)
    for m in model.modules():
        if isinstance(m, heads.DepthCorr):
            m.conv_kernel.register_forward_hook(record)
            m.conv_search.register_forward_hook(record)
    z, x = _images()
    with torch.no_grad():
        model.track_mask(model.template(z.contiguous(memory_format=CL)),
                         x.contiguous(memory_format=CL))
    assert len(taken) == 6 and taken == adjusted


@pytest.mark.parametrize("task", TASKS)
def test_train_step_matches_across_layouts(task, monkeypatch):
    """One unfrozen ``Trainer.step`` from the same weights and batch with the
    model handed NCHW (the CPU's path) and channels_last (a card's): the
    same losses and metrics, every parameter's gradient, the parameters
    after the step and the BN statistics, to float64 rounding. Gradients
    and parameters stay NCHW-contiguous and float64; every conv of the
    channels_last step takes channels_last."""
    cls, config, weights = TASKS[task]
    cfg = Config.load(str(config), clip=10.0)
    _, batch = make_batch(cfg)
    batch = {k: v.double() if v.is_floating_point() else v for k, v in batch.items()}
    settings = TrainSettings.for_search(task, weights or cfg.loss_weight,
                                        cfg.train_datasets["search_size"])

    def step(layout):
        monkeypatch.setattr(trainer_module, "model_input",
                            lambda t: t.contiguous(memory_format=layout))
        model = _model(cls)
        trainer = Trainer(model, settings,
                          OptimizerConfig.from_lr_cfg(cfg.lr, clip=10.0, clip_cfg=cfg.clip),
                          build_lr_spaces(cfg.lr, EPOCHS), epochs=EPOCHS)
        metrics, counts = _convs(lambda: trainer.step(batch, EPOCHS - 1))
        return model, metrics, counts

    ref_model, ref, counts = step(NCHW)
    model, ours, counts_cl = step(CL)
    assert counts["conv.channels_last"] == counts_cl["conv.contiguous"] == 0
    assert counts["conv.contiguous"] == counts_cl["conv.channels_last"] > 0
    assert ours.keys() == ref.keys() and ours["skipped"] == 0
    for k in ref:
        _close(ours[k], ref[k], f"{task} {k}")
    params = dict(ref_model.named_parameters())
    p_scale = _largest(params.values())
    g_scale = _largest(p.grad for p in params.values() if p.grad is not None)
    trained = 0
    for name, p in model.named_parameters():
        assert p.dtype == torch.float64 and p.is_contiguous(), name
        _close(p, params[name], f"{task} {name}", p_scale)
        if params[name].grad is None:
            assert p.grad is None, name
            continue
        assert p.grad.is_contiguous(), name
        _close(p.grad, params[name].grad, f"{task} grad {name}", g_scale)
        trained += 1
    assert trained > 0
    buffers = dict(ref_model.named_buffers())
    for name, b in model.named_buffers():
        _close(b, buffers[name], f"{task} {name}")


@pytest.mark.parametrize("path", PATHS)
def test_tracker_step_matches_across_layouts(path, monkeypatch):
    """The tracker's init and two open-loop steps of three streams with the
    crops handed over NCHW (the CPU's path) and channels_last (a card's):
    the same states and outputs to float64 rounding. The NCHW run's convs
    all take NCHW, the channels_last run's channels_last, but the 1x1 head
    that sharp without Refine runs on one cell's vector, a map of one pixel
    (the same memory in either layout)."""
    cls, config, mask, refine = PATHS[path]
    p = Config.load(str(config)).tracker_config()
    model = cls(width=WIDTH, dtype=torch.float64)
    model = model.init_weights(torch.Generator().manual_seed(0)).double().eval()
    rng = np.random.RandomState(11)
    frames = torch.from_numpy(rng.randint(0, 256, size=(3, 120, 160, 3)).astype(np.uint8))
    pos = torch.tensor([(84.0, 58.0), (12.0, 96.0), (130.0, 34.0)])
    sz = torch.tensor([(44.0, 30.0), (36.0, 40.0), (50.0, 24.0)])

    def run(layout):
        monkeypatch.setattr(tracker_module, "model_input",
                            lambda t: t.contiguous(memory_format=layout))
        tracker = Tracker(model, p, "cpu", mask=mask, refine=refine)
        state = tracker.init_batched(frames[0], pos, sz)
        outs = [state]
        for frame in frames[1:]:
            new_state, out = tracker.step_batched(state, frame)
            outs += [new_state, out]
        return outs

    ref, counts = _convs(lambda: run(NCHW))
    ours, counts_cl = _convs(lambda: run(CL))
    cell_head = 2 * 2 if path == "sharp-raw" else 0       # two convs a step, two steps
    assert counts["conv.channels_last"] == 0
    assert counts_cl["conv.contiguous"] == cell_head
    assert counts["conv.contiguous"] == counts_cl["conv.channels_last"] + cell_head
    assert memory_format(ours[0].zf) is CL and memory_format(ref[0].zf) is NCHW
    for i, (a, b) in enumerate(zip(ours, ref)):
        assert a._fields == b._fields
        for name, u, v in zip(a._fields, a, b):
            if not u.is_floating_point():
                assert torch.equal(u, v), (path, i, name)
            else:
                _close(u.double(), v.double(), f"{path} {i} {name}")


def test_channels_last_step_saves_and_loads(tmp_path, monkeypatch):
    """A model after a channels_last training step keeps NCHW-contiguous
    parameters under its names; its checkpoint loads back into a model, and
    through the JAX package's loader, with the same values."""
    monkeypatch.setattr(trainer_module, "model_input",
                        lambda t: t.contiguous(memory_format=CL))
    cls, config, _ = TASKS["base"]
    cfg = Config.load(str(config), clip=10.0)
    _, batch = make_batch(cfg)
    model = cls(width=WIDTH).init_weights(torch.Generator().manual_seed(0))
    names = list(model.state_dict())
    trainer = Trainer(model, TrainSettings.for_search("base", cfg.loss_weight, 255),
                      OptimizerConfig.from_lr_cfg(cfg.lr, clip=10.0, clip_cfg=cfg.clip),
                      build_lr_spaces(cfg.lr, EPOCHS), epochs=EPOCHS)
    assert trainer.step(batch, EPOCHS - 1)["skipped"] == 0
    state = model.state_dict()
    assert list(state) == names
    assert all(v.is_contiguous() for v in state.values())
    path = str(tmp_path / "ck.pth")
    save_checkpoint(path, state, trainer.optimizer.state_dict(), epoch=1)
    loaded = cls(width=WIDTH)
    loaded.load_state_dict(load_checkpoint(path)["state_dict"], strict=True)
    for k, v in loaded.state_dict().items():
        assert torch.equal(v, state[k]), k
    # the JAX tree holds no BN step counts
    from_jax = state_dict_from_jax(load_torch_checkpoint(path))
    assert from_jax.keys() == state.keys()
    for k, v in from_jax.items():
        if not k.endswith("num_batches_tracked"):
            np.testing.assert_array_equal(np.asarray(v), state[k].numpy(), err_msg=k)
