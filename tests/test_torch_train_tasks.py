"""The port's other training tasks against the JAX package's
``make_train_step``: SiamRPN (``experiments/siamrpn_resnet/config.json``,
255x255 search), stage-2 refine training (``sharp_refine``,
``experiments/siammask_sharp/config.json``, 143x143 search, the 3x3 grid)
and SiamMask-sharp end to end (``sharp``, the same geometry with loss
weights (1, 1, 36) so that every head takes a gradient), at width 8, B=2.

Each task takes one step in the frozen phase on both sides, from the same
weights (the JAX tree carried over by ``state_dict_from_jax``) and the same
batch, in float32 and in float64 (``jax.enable_x64``, the flax ``dtype``;
``model.double()``). The JAX models run their xcorr through the Pallas
kernel in interpret mode, the port its plain version. The tolerances are
``test_torch_train.py``'s (its module docstring says why): float32 values
1e-4, gradients 1e-3 per tensor and 1e-4 over the step; float64 values
1e-6, gradients 1e-5 per tensor and 1e-6 over the step. BN running
variances are compared after removing the port's unbiased-update excess.

The two sharp tasks' gradients (seen as momentum and parameter updates) are
held to the JAX package in float64 only. Through Refine's 18 windows the
JAX package's own float32 step is already off its float64 one by more than
the float32 whole-step tolerance (``test_float32_refine_gradients_carry_
rounding_noise``), so no float32 comparison could be held to it; their
values and metrics are compared in both dtypes.

Sharp's ``forward_train`` never calls the mask corr's 1x1 head, yet optax
decays its leaves and carries them in momentum; the port gives them a zero
gradient so that SGD does the same. Every parameter is compared, the head
included.
"""
import contextlib
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from siammask_tpu.config import Config as JaxConfig
from siammask_tpu.models.siammask import SiamMaskSharp as JaxSiamMaskSharp
from siammask_tpu.models.siammask import SiamRPN as JaxSiamRPN
from siammask_tpu.models.siammask import log_softmax_cls as jax_log_softmax_cls
from siammask_tpu.train.lr import build_lr_spaces as jax_build_lr_spaces
from siammask_tpu.train.trainer import OptimizerConfig as JaxOptimizerConfig
from siammask_tpu.train.trainer import Trainer as JaxTrainer
from siammask_tpu.train.trainer import TrainSettings as JaxTrainSettings
from siammask_tpu.train.trainer import label_params as jax_label_params
from siammask_tpu.utils.torch_convert import convert_state_dict
from siammask_tpu_torch.config import Config
from siammask_tpu_torch.data.anchor_target import AnchorTarget
from siammask_tpu_torch.models.siammask import SiamMaskSharp, SiamRPN, log_softmax_cls
from siammask_tpu_torch.tracker.anchors import Anchors
from siammask_tpu_torch.train.lr import build_lr_spaces
from siammask_tpu_torch.train.trainer import (OptimizerConfig, Trainer, TrainSettings,
                                              label_params)
from siammask_tpu_torch.utils.convert import _torch_name, state_dict_from_jax

from test_torch_train import (TOL, BNRecorder, _bn_stats_close, _momentum_error, jax_momentum,
                              snapshot)
from test_torch_tracker import one_torch_thread  # noqa: F401  (autouse)

EXPERIMENTS = Path(__file__).resolve().parents[1] / "experiments"
WIDTH = 8
B = 2
EPOCHS = 2
DTYPES = ("float32", "float64")
# task -> (JAX model, port model, config, loss weights or None for the config's)
TASKS = {"siamrpn": (JaxSiamRPN, SiamRPN, EXPERIMENTS / "siamrpn_resnet" / "config.json",
                     None),
         "sharp_refine": (JaxSiamMaskSharp, SiamMaskSharp,
                          EXPERIMENTS / "siammask_sharp" / "config.json", None),
         "sharp": (JaxSiamMaskSharp, SiamMaskSharp,
                   EXPERIMENTS / "siammask_sharp" / "config.json", (1.0, 1.0, 36.0))}
# the dtypes whose gradients are compared, per task (see above)
GRAD_DTYPES = {"siamrpn": DTYPES, "sharp_refine": ("float64",), "sharp": ("float64",)}
HEAD = "mask_model.mask.head."
FROZEN_IN_REFINE = ("features.", "rpn_model.")


def make_batch(cfg: Config, seed=0):
    """Noise images and the port's anchor targets for a box near the centre
    of each search crop, at the config's search size and score map: (JAX
    batch, NHWC numpy; port batch, NCHW torch)."""
    search, size = cfg.train_datasets["search_size"], cfg.train_datasets["size"]
    rng = np.random.RandomState(seed)
    anchors = Anchors(cfg.anchors)
    anchors.generate_all_anchors(im_c=search // 2, size=size)
    target = AnchorTarget(np.random.RandomState(seed))
    cls, loc, loc_w, mask, mask_w = [], [], [], [], []
    for _ in range(B):
        cx, cy = search // 2 + rng.uniform(-8, 8, 2)
        w, h = rng.uniform(52, 78, 2)
        box = (cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2)
        c, d, dw = target(anchors, box, size)
        m = -np.ones((search, search), np.float32)
        m[int(box[1]):int(box[3]), int(box[0]):int(box[2])] = 1.0
        cls.append(c), loc.append(d), loc_w.append(dw), mask.append(m)
        mask_w.append(c.max(axis=0).astype(np.float32))
    jbatch = {"template": rng.uniform(0, 255, (B, 127, 127, 3)).astype(np.float32),
              "search": rng.uniform(0, 255, (B, search, search, 3)).astype(np.float32),
              "label_cls": np.stack(cls).astype(np.int32), "label_loc": np.stack(loc),
              "label_loc_weight": np.stack(loc_w), "label_mask": np.stack(mask),
              "label_mask_weight": np.stack(mask_w)}
    tbatch = {k: torch.from_numpy(np.ascontiguousarray(
        v.transpose(0, 3, 1, 2) if k in ("template", "search") else v))
        for k, v in jbatch.items()}
    tbatch["label_cls"] = tbatch["label_cls"].long()
    return jbatch, tbatch


@torch.no_grad()
def calibrated_variables(cls, batch, seed=0):
    """Seeded port weights whose BN statistics are those of their own inputs
    on ``batch`` and whose BN affine terms are perturbed, carried into the
    JAX package's tree by its own checkpoint importer."""
    model = cls(width=WIDTH).init_weights(torch.Generator().manual_seed(seed)).eval()
    g = torch.Generator().manual_seed(seed + 1)

    def hook(bn, inputs):
        x = inputs[0]
        bn.running_mean.copy_(x.mean(dim=(0, 2, 3)))
        bn.running_var.copy_(x.var(dim=(0, 2, 3)))
        bn.weight.uniform_(0.8, 1.2, generator=g)
        bn.bias.normal_(0.0, 0.05, generator=g)

    handles = [m.register_forward_pre_hook(hook) for m in model.modules()
               if isinstance(m, torch.nn.BatchNorm2d)]
    try:
        model.forward_train(batch["template"], batch["search"])
        if isinstance(model, SiamMaskSharp):  # the head forward_train skips
            zf = model.template(batch["template"])
            model.mask_model(zf, model.features(batch["search"])[1])
    finally:
        for h in handles:
            h.remove()
    return convert_state_dict({k: v.numpy() for k, v in model.state_dict().items()})


def _run(task, variables, dtype):
    jcls, cls, config, weights = TASKS[task]
    jcfg, cfg = JaxConfig.load(str(config), clip=10.0), Config.load(str(config), clip=10.0)
    weights = weights or cfg.loss_weight
    search = cfg.train_datasets["search_size"]
    jset = JaxTrainSettings(task=task, loss_weight=weights,
                            mask_pad=0 if search < 255 else 32)
    tset = TrainSettings.for_search(task, weights, search)
    jlr, tlr = jax_build_lr_spaces(jcfg.lr, EPOCHS), build_lr_spaces(cfg.lr, EPOCHS)
    np.testing.assert_array_equal(tlr, jlr)
    jdtype, tdtype = {"float32": (jnp.float32, torch.float32),
                      "float64": (jnp.float64, torch.float64)}[dtype]
    jbatch, tbatch = make_batch(cfg)
    variables = jax.tree.map(lambda v: jnp.asarray(v, jdtype), variables)
    jbatch = {k: v.astype(jdtype) if v.dtype == np.float32 else v for k, v in jbatch.items()}
    tbatch = {k: v.to(tdtype) if v.is_floating_point() else v for k, v in tbatch.items()}

    jmodel = jcls(width=WIDTH, xcorr_impl="pallas", dtype=jdtype)
    jtrainer = JaxTrainer(jmodel, variables, jset,
                          JaxOptimizerConfig.from_lr_cfg(jcfg.lr, clip=10.0, clip_cfg=jcfg.clip),
                          jlr, epochs=EPOCHS)
    model = cls(width=WIDTH).to(tdtype)
    model.load_state_dict(state_dict_from_jax(variables), strict=True)
    trainer = Trainer(model, tset, OptimizerConfig.from_lr_cfg(cfg.lr, clip=10.0,
                                                               clip_cfg=cfg.clip),
                      tlr, epochs=EPOCHS)
    recorder = BNRecorder(model)
    before = {k: v.numpy() for k, v in state_dict_from_jax(variables).items()}
    try:
        jm = jtrainer.step(jbatch, 0)
        tm = trainer.step(tbatch, 0)
    finally:
        recorder.remove()
    jvars = jax.tree.map(np.asarray, jtrainer.variables)
    return {"before": before, "lr": float(tlr[0]),
            "jax_state": {k: v.numpy() for k, v in state_dict_from_jax(jvars).items()},
            "jax_momentum": jax_momentum(jtrainer.opt_state),
            "jax_metrics": {k: float(v) for k, v in jm.items()},
            "port": snapshot(trainer, tm, recorder),
            "mults": {g["name"]: g["mult"] for g in trainer.optimizer.param_groups},
            "weight_decay": trainer.opt_cfg.weight_decay}


@pytest.fixture(scope="module")
def runs():
    """{(task, dtype): one frozen-phase step on both sides}."""
    out = {}
    variables = {}
    for task, (_, cls, config, _) in TASKS.items():
        if cls not in variables:
            variables[cls] = calibrated_variables(cls, make_batch(Config.load(str(config)))[1])
        for dtype in DTYPES:
            ctx = jax.enable_x64(True) if dtype == "float64" else contextlib.nullcontext()
            with ctx:
                out[(task, dtype)] = _run(task, variables[cls], dtype)
    return out


@pytest.mark.parametrize("task", TASKS)
def test_metrics_match_jax(runs, task):
    """The same metric keys per task (SiamRPN: no mask terms; the mask
    families: every term, zero-weighted ones too) and values."""
    for dtype in DTYPES:
        run = runs[(task, dtype)]
        ours, ref = run["port"]["metrics"], run["jax_metrics"]
        assert set(ours) == set(ref)
        assert ("mask_loss" in ours) == (task != "siamrpn")
        assert ours["skipped"] == ref["skipped"] == 0.0
        rel = TOL[dtype]["value"]
        for k in ref:
            np.testing.assert_allclose(ours[k], ref[k], rtol=rel, atol=1e-2 * rel,
                                       err_msg=f"{task} {dtype} {k}")


@pytest.mark.parametrize("task", TASKS)
def test_params_match_jax(runs, task):
    """Every parameter after the step, the unused mask head included; the
    frozen ones bit-identical on both sides."""
    for dtype in GRAD_DTYPES[task]:
        run, tol = runs[(task, dtype)], TOL[dtype]
        prev, ours, ref = run["before"], run["port"]["state"], run["jax_state"]
        moved = 0
        for name, label in run["port"]["labels"].items():
            d_ours, d_ref = ours[name] - prev[name], ref[name] - prev[name]
            if label == "frozen":
                np.testing.assert_array_equal(d_ours, 0.0, err_msg=f"{dtype} {name}")
                np.testing.assert_array_equal(d_ref, 0.0, err_msg=f"{dtype} {name}")
                continue
            # (a zero-initialised bias of the unused head decays by nothing)
            assert np.abs(d_ref).max() > 0 or not prev[name].any(), name
            np.testing.assert_allclose(ours[name], ref[name], rtol=tol["param"],
                                       atol=tol["grad"] * np.abs(d_ref).max(),
                                       err_msg=f"{task} {dtype} {name}")
            moved += 1
        assert moved > 0


@pytest.mark.parametrize("task", ["sharp", "sharp_refine"])
def test_unused_mask_head_decays_as_jax(runs, task):
    """The 1x1 head moves by weight decay alone, w - lr * mult * wd * w on
    the first step, on both sides, to the parameter tolerance (an update of
    1e-7 of the weight is a few float32 ulps)."""
    for dtype in DTYPES:
        run = runs[(task, dtype)]
        scale = run["lr"] * run["mults"]["mask"] * run["weight_decay"]
        names = [n for n in run["port"]["labels"] if n.startswith(HEAD)]
        assert len(names) == 5  # conv, BN weight and bias, conv weight and bias
        for name in names:
            before = run["before"][name]
            expected = before - scale * before
            for side in ("port", "jax"):
                after = run["port"]["state"][name] if side == "port" else run["jax_state"][name]
                np.testing.assert_allclose(after, expected, rtol=TOL[dtype]["param"],
                                           atol=1e-3 * scale * np.abs(before).max(),
                                           err_msg=f"{task} {dtype} {side} {name}")
                if before.any():
                    assert not np.array_equal(after, before), (task, dtype, side, name)


@pytest.mark.parametrize("task", TASKS)
def test_bn_stats_match_jax(runs, task):
    for dtype in DTYPES:
        run = runs[(task, dtype)]
        assert _bn_stats_close(run["port"]["state"], run["jax_state"], run["port"]["excess"],
                               TOL[dtype]["value"]) > 0


@pytest.mark.parametrize("task", TASKS)
def test_momentum_matches_jax(runs, task):
    for dtype in GRAD_DTYPES[task]:
        run = runs[(task, dtype)]
        ours, ref = run["port"]["momentum"], run["jax_momentum"]
        per_tensor = TOL[dtype]["grad"]
        assert set(ours) == set(ref)
        floor = 1e-2 * per_tensor * max(np.abs(v).max() for v in ref.values())
        for name in ref:
            np.testing.assert_allclose(ours[name], ref[name], rtol=per_tensor,
                                       atol=per_tensor * np.abs(ref[name]).max() + floor,
                                       err_msg=f"{task} {dtype} {name}")
        assert _momentum_error(ours, ref) < TOL[dtype]["step"], (task, dtype)


@pytest.mark.parametrize("task", ["sharp", "sharp_refine"])
def test_float32_refine_gradients_carry_rounding_noise(runs, task):
    """The reading behind comparing the sharp tasks' gradients in float64
    only: the JAX package's float32 momentum, against its own float64 one
    from the same weights and batch, is off by more than the float32
    whole-step tolerance, while in float64 the two frameworks agree within
    theirs."""
    jax32 = runs[(task, "float32")]["jax_momentum"]
    jax64 = runs[(task, "float64")]["jax_momentum"]
    assert _momentum_error(jax32, jax64) > TOL["float32"]["step"]
    run = runs[(task, "float64")]
    assert _momentum_error(run["port"]["momentum"], run["jax_momentum"]) < TOL["float64"]["step"]


def test_refine_only_freezes_backbone_neck_rpn(runs):
    """Stage 2: the backbone, neck and RPN heads, parameters and BN
    buffers alike, are bit-identical after the step on both sides; the mask
    corr's BN statistics move."""
    for dtype in DTYPES:
        run = runs[("sharp_refine", dtype)]
        ours, ref, prev = run["port"]["state"], run["jax_state"], run["before"]
        frozen = [k for k in ours if k.startswith(FROZEN_IN_REFINE)
                  and not k.endswith("num_batches_tracked")]
        assert len(frozen) > 100
        for name in frozen:
            np.testing.assert_array_equal(ours[name], prev[name], err_msg=name)
            np.testing.assert_array_equal(ref[name], prev[name], err_msg=name)
        name = "mask_model.mask.conv_search.1.running_mean"
        assert np.abs(ours[name] - prev[name]).max() > 0


def test_refine_only_modes_survive_train():
    model = SiamMaskSharp(width=WIDTH).fix_for_refine(True)
    model.train()
    assert not any(m.training for m in model.features.modules())
    assert not any(m.training for m in model.rpn_model.modules())
    assert model.mask_model.training and model.refine_model.training
    assert not any(p.requires_grad for p in model.features.parameters())
    assert not any(p.requires_grad for p in model.rpn_model.parameters())
    model.fix_for_refine(False)
    model.train()
    assert model.rpn_model.training and model.features.downsample.training
    assert not model.features.features.layer1.training
    assert not any(p.requires_grad for p in model.features.features.layer1.parameters())


@pytest.mark.parametrize("refine_only", [False, True])
def test_sharp_group_labels_match_jax(refine_only):
    jmodel = JaxSiamMaskSharp(width=WIDTH)
    params = jax.eval_shape(lambda: jmodel.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 127, 127, 3)), jnp.zeros((1, 255, 255, 3))))
    jlabels = jax_label_params(params["params"], False, refine_only)
    flat = jax.tree_util.tree_flatten_with_path(jlabels)[0]
    ref = {_torch_name(".".join(p.key for p in path))[0]: label for path, label in flat}
    assert label_params(SiamMaskSharp(width=WIDTH), False, refine_only) == ref


def test_train_settings_for_search():
    assert TrainSettings.for_search("sharp_refine", (0, 0, 36), 143).mask_pad == 0
    assert TrainSettings.for_search("base", (1, 1, 36), 255).mask_pad == 32
    with pytest.raises(ValueError):
        TrainSettings(task="refine")


def test_log_softmax_cls_matches_jax():
    """The reference's training-time cls activation: (B, 2k, S, S) ->
    (B, k, S, S, 2), the JAX package's layout (its NHWC input permuted)."""
    score = np.random.RandomState(4).randn(2, 25, 25, 10).astype(np.float32)
    ref = np.asarray(jax_log_softmax_cls(jnp.asarray(score), 5))
    ours = log_softmax_cls(torch.from_numpy(score.transpose(0, 3, 1, 2).copy()), 5)
    assert ours.shape == ref.shape == (2, 5, 25, 25, 2)
    np.testing.assert_allclose(ours.numpy(), ref, rtol=1e-6, atol=1e-6)
