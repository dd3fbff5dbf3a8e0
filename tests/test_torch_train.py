"""The port's SiamMask-base stage-1 training step against the JAX package's,
at width 8, batch 2, the full 127/255 geometry.

Both start from the same weights (the JAX tree carried over with
``state_dict_from_jax``, strictly) and take the same batch: one step in the
frozen phase (epoch 0 of 2) and one after the unfreeze boundary (epoch 1,
optimizer rebuilt). The JAX model runs its xcorr through the Pallas kernel in
interpret mode; the port's takes the plain version on the CPU. The two steps
run twice: in float32, and in float64 on both sides (``jax.enable_x64``, the
flax modules' ``dtype``; ``model.double()``).

Tolerances (``TOL``), relative to the largest magnitude of the JAX tensor.
In float32 both sides sum in another order (XLA's convs and reductions
against PyTorch's): forward values, losses, metrics and BN statistics are
held to 1e-4, gradients (seen as momentum buffers and parameter updates) to
1e-3 per tensor and 1e-4 over the whole step. In float64 the JAX side still
rounds to float32 in its Pallas xcorr (fp32 accumulation) and in its resize
matrices, which bounds the agreement near 1e-7: values are held to 1e-6,
gradients to 1e-5 per tensor and 1e-6 over the step.

The unfrozen phase's gradients are held to the JAX package in float64 only.
There the gradient through the train-mode BN of layer2/3 at batch 2 is
ill-conditioned in float32 whichever framework computes it: the port's own
float32 momentum differs from its float64 one by about 1% over the step
(``test_float32_unfrozen_gradients_carry_rounding_noise``), so no float32
comparison could be held to the frozen phase's tolerance.

BN running variance: the port keeps ``nn.BatchNorm2d``, which updates it with
the unbiased batch variance; flax uses the biased one. The tests record each
train-mode BN call's biased variance b and element count n on the port's
side and remove the difference, ``e <- 0.9 e + 0.1 b / (n - 1)`` per call,
before comparing.
"""
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from siammask_tpu.config import Config as JaxConfig
from siammask_tpu.models.siammask import SiamMaskBase as JaxSiamMaskBase
from siammask_tpu.train.lr import build_lr_spaces as jax_build_lr_spaces
from siammask_tpu.train.trainer import OptimizerConfig as JaxOptimizerConfig
from siammask_tpu.train.trainer import Trainer as JaxTrainer
from siammask_tpu.train.trainer import TrainSettings as JaxTrainSettings
from siammask_tpu.train.trainer import label_params as jax_label_params
from siammask_tpu.utils.torch_convert import convert_state_dict, invert_variables
from siammask_tpu_torch.config import Config
from siammask_tpu_torch.data.anchor_target import AnchorTarget
from siammask_tpu_torch.models.siammask import SiamMaskBase
from siammask_tpu_torch.tracker.anchors import Anchors
from siammask_tpu_torch.train.lr import build_lr_spaces
from siammask_tpu_torch.train.trainer import (OptimizerConfig, Trainer, TrainSettings,
                                              build_optimizer, label_params)
from siammask_tpu_torch.utils.convert import _torch_name, state_dict_from_jax

from test_torch_tracker import one_torch_thread  # noqa: F401  (autouse)

CONFIG = Path(__file__).resolve().parents[1] / "experiments" / "siammask_base" / "config.json"
WIDTH = 8
B = 2
EPOCHS = 2
PHASES = ("frozen", "unfrozen")
DTYPES = ("float32", "float64")
# relative tolerances, see above: forward values, metrics and BN statistics;
# gradients per tensor and over the step; parameters beyond their update
# (two ulps of the parameter)
TOL = {"float32": {"value": 1e-4, "grad": 1e-3, "step": 1e-4, "param": 2.0 ** -22},
       "float64": {"value": 1e-6, "grad": 1e-5, "step": 1e-6, "param": 2.0 ** -51}}
# the dtypes whose gradients are compared, per phase
GRAD_DTYPES = {"frozen": DTYPES, "unfrozen": ("float64",)}


@torch.no_grad()
def calibrated_variables(batch, seed=0):
    """Seeded port weights whose BN statistics are those of their own inputs
    on ``batch`` (per channel, as a trained backbone's are; activations stay
    O(1)) and whose BN affine terms are perturbed, carried into the JAX
    package's tree by its own checkpoint importer."""
    model = SiamMaskBase(width=WIDTH).init_weights(torch.Generator().manual_seed(seed)).eval()
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
    finally:
        for h in handles:
            h.remove()
    return convert_state_dict({k: v.numpy() for k, v in model.state_dict().items()})


def make_batch(seed=0):
    """Noise images and the port's anchor targets for a box near the centre
    of each search crop: (JAX batch, NHWC numpy; port batch, NCHW torch)."""
    rng = np.random.RandomState(seed)
    cfg = Config.load(str(CONFIG))
    anchors = Anchors(cfg.anchors)
    anchors.generate_all_anchors(im_c=255 // 2, size=25)
    target = AnchorTarget(np.random.RandomState(seed))
    cls, loc, loc_w, mask, mask_w = [], [], [], [], []
    for _ in range(B):
        cx, cy = 127 + rng.uniform(-8, 8, 2)
        w, h = rng.uniform(52, 78, 2)  # the search crop scales targets to ~64 px
        box = (cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2)
        c, d, dw = target(anchors, box, 25)
        m = -np.ones((255, 255), np.float32)
        m[int(box[1]):int(box[3]), int(box[0]):int(box[2])] = 1.0
        cls.append(c), loc.append(d), loc_w.append(dw), mask.append(m)
        mask_w.append(c.max(axis=0).astype(np.float32))
    jbatch = {"template": rng.uniform(0, 255, (B, 127, 127, 3)).astype(np.float32),
              "search": rng.uniform(0, 255, (B, 255, 255, 3)).astype(np.float32),
              "label_cls": np.stack(cls).astype(np.int32), "label_loc": np.stack(loc),
              "label_loc_weight": np.stack(loc_w), "label_mask": np.stack(mask),
              "label_mask_weight": np.stack(mask_w)}
    tbatch = {k: torch.from_numpy(np.ascontiguousarray(
        v.transpose(0, 3, 1, 2) if k in ("template", "search") else v))
        for k, v in jbatch.items()}
    tbatch["label_cls"] = tbatch["label_cls"].long()
    return jbatch, tbatch


def port_model(variables, dtype=torch.float32):
    model = SiamMaskBase(width=WIDTH).to(dtype)
    model.load_state_dict(state_dict_from_jax(variables), strict=True)
    return model


def settings_pair():
    jcfg = JaxConfig.load(str(CONFIG), clip=10.0)
    cfg = Config.load(str(CONFIG), clip=10.0)
    jset = JaxTrainSettings(task="base", loss_weight=jcfg.loss_weight, mask_pad=32)
    tset = TrainSettings(task="base", loss_weight=cfg.loss_weight, mask_pad=32)
    return (jset, JaxOptimizerConfig.from_lr_cfg(jcfg.lr, clip=10.0, clip_cfg=jcfg.clip),
            jax_build_lr_spaces(jcfg.lr, EPOCHS), tset,
            OptimizerConfig.from_lr_cfg(cfg.lr, clip=10.0, clip_cfg=cfg.clip),
            build_lr_spaces(cfg.lr, EPOCHS))


class BNRecorder:
    """Forward hooks that accumulate, per BN, the running-variance difference
    between the unbiased (port) and biased (flax) update rules."""

    def __init__(self, model):
        self.excess = {}
        self.handles = [m.register_forward_hook(self._hook(name))
                        for name, m in model.named_modules()
                        if isinstance(m, torch.nn.BatchNorm2d)]

    def _hook(self, name):
        def hook(mod, inputs, _):
            if not mod.training:
                return
            x = inputs[0].detach()
            n = x.numel() // x.shape[1]
            b = x.var(dim=(0, 2, 3), unbiased=False)
            self.excess[name] = 0.9 * self.excess.get(name, 0.0) + 0.1 * b / (n - 1)
        return hook

    def remove(self):
        for h in self.handles:
            h.remove()


def jax_momentum(opt_state) -> dict[str, np.ndarray]:
    """optax ``trace`` state of every non-frozen group -> torch names."""
    tree = {}
    for label, state in opt_state[1].inner_states.items():
        if label == "frozen":
            continue
        trace = state.inner_state[1].trace
        for path, leaf in jax.tree_util.tree_flatten_with_path(trace)[0]:
            node = tree
            keys = [p.key for p in path]
            for key in keys[:-1]:
                node = node.setdefault(key, {})
            node[keys[-1]] = np.asarray(leaf)
    return {k: v.numpy() for k, v in state_dict_from_jax({"params": tree}).items()}


def snapshot(trainer, metrics, recorder):
    model = trainer.model
    state = {k: v.detach().clone().numpy() for k, v in model.state_dict().items()}
    names = {p: n for n, p in model.named_parameters()}
    momentum = {names[p]: s["momentum_buffer"].numpy().copy()
                for p, s in trainer.optimizer.state.items()}
    return {"state": state, "momentum": momentum,
            "metrics": {k: float(v) for k, v in metrics.items()},
            "excess": {k: v.numpy().copy() for k, v in recorder.excess.items()},
            "labels": dict(trainer.labels)}


@pytest.fixture(scope="module")
def jax_vars():
    return (JaxSiamMaskBase(width=WIDTH, xcorr_impl="pallas"),
            calibrated_variables(make_batch()[1]))


def _run_both(variables, jbatch, tbatch, dtype):
    """One frozen and one unfrozen step on each side, in ``dtype``."""
    jset, jopt, jlr, tset, topt, tlr = settings_pair()
    np.testing.assert_array_equal(tlr, jlr)
    jdtype, tdtype = {"float32": (jnp.float32, torch.float32),
                      "float64": (jnp.float64, torch.float64)}[dtype]
    variables = jax.tree.map(lambda v: jnp.asarray(v, jdtype), variables)
    jbatch = {k: v.astype(jdtype) if v.dtype == np.float32 else v for k, v in jbatch.items()}
    tbatch = {k: v.to(tdtype) if v.is_floating_point() else v for k, v in tbatch.items()}

    jmodel = JaxSiamMaskBase(width=WIDTH, xcorr_impl="pallas", dtype=jdtype)
    jtrainer = JaxTrainer(jmodel, variables, jset, jopt, jlr, epochs=EPOCHS, unfreeze_at=0.5)
    model = port_model(variables, tdtype)
    trainer = Trainer(model, tset, topt, tlr, epochs=EPOCHS, unfreeze_at=0.5)
    recorder = BNRecorder(model)
    before = state_dict_from_jax(variables)
    out = {"before": {k: v.numpy() for k, v in before.items()}}
    try:
        for phase, epoch in zip(PHASES, (0, 1)):
            jm = jtrainer.step(jbatch, epoch)
            tm = trainer.step(tbatch, epoch)
            jvars = jax.tree.map(np.asarray, jtrainer.variables)
            out[phase] = {
                "jax_state": {k: v.numpy() for k, v in state_dict_from_jax(jvars).items()},
                "jax_momentum": jax_momentum(jtrainer.opt_state),
                "jax_metrics": {k: float(v) for k, v in jm.items()},
                "port": snapshot(trainer, tm, recorder),
            }
    finally:
        recorder.remove()
    return out


@pytest.fixture(scope="module")
def runs(jax_vars):
    """{dtype: {"before": state, phase: the step's results on both sides}}."""
    _, variables = jax_vars
    jbatch, tbatch = make_batch()
    out = {"float32": _run_both(variables, jbatch, tbatch, "float32")}
    with jax.enable_x64(True):
        out["float64"] = _run_both(variables, jbatch, tbatch, "float64")
    return out


def _close(ours, ref, rel, name):
    ref = np.asarray(ref, np.float64)
    np.testing.assert_allclose(ours, ref, rtol=rel, atol=rel * np.abs(ref).max(),
                               err_msg=name)


def _bn_stats_close(ours, ref, excess, rel=TOL["float32"]["value"]):
    """Running means directly; running variances after removing the
    unbiased-update excess recorded on the port's side."""
    updated = 0
    for name in ours:
        if name.endswith("running_mean"):
            _close(ours[name], ref[name], rel, name)
        elif name.endswith("running_var"):
            bn = name.removesuffix(".running_var")
            updated += bn in excess
            _close(ours[name] - excess.get(bn, 0.0), ref[name], rel, name)
    return updated


@pytest.mark.parametrize("unfrozen", [False, True])
def test_forward_train_matches_jax(jax_vars, unfrozen):
    """SiamMaskBase.forward_train with train-mode BN (neck and heads; layer2/3
    once unfrozen): the three head outputs and the updated BN statistics."""
    jmodel, variables = jax_vars
    jbatch, tbatch = make_batch()
    (ref, new_state) = jax.jit(lambda v, z, x: jmodel.apply(
        v, z, x, train_layers=(unfrozen, unfrozen), method="forward_train",
        mutable=["batch_stats"]))(variables, jbatch["template"], jbatch["search"])
    model = port_model(variables)
    model.features.features.unfix(unfrozen)
    model.train()
    recorder = BNRecorder(model)
    with torch.no_grad():
        outs = model.forward_train(tbatch["template"], tbatch["search"])
    recorder.remove()
    for name, o, r in zip(("score", "loc", "mask"), outs, (ref.score, ref.loc, ref.mask)):
        assert tuple(o.shape) == (B, r.shape[3], 25, 25), name
        _close(o.permute(0, 2, 3, 1).numpy(), r, 1e-4, name)
    ref_state = state_dict_from_jax({"params": variables["params"],
                                     "batch_stats": jax.tree.map(np.asarray, new_state)[
                                         "batch_stats"]})
    ours = {k: v.numpy() for k, v in model.state_dict().items()}
    excess = {k: v.numpy() for k, v in recorder.excess.items()}
    assert _bn_stats_close(ours, {k: v.numpy() for k, v in ref_state.items()}, excess) == (
        42 if unfrozen else 10)  # layer2/3: 32 BNs; neck 1; heads 3 x 3


@pytest.mark.parametrize("phase", PHASES)
def test_train_step_metrics_match_jax(runs, phase):
    for dtype in DTYPES:
        run = runs[dtype][phase]
        ours, ref = run["port"]["metrics"], run["jax_metrics"]
        assert set(ours) == set(ref)
        assert ours["skipped"] == ref["skipped"] == 0.0
        rel = TOL[dtype]["value"]
        for k in ref:
            np.testing.assert_allclose(ours[k], ref[k], rtol=rel, atol=1e-2 * rel,
                                       err_msg=f"{dtype} {k}")


@pytest.mark.parametrize("phase", PHASES)
def test_train_step_params_match_jax(runs, phase):
    """Every parameter after the step, and the frozen ones exactly unchanged.
    An update (lr ~1e-3 times the momentum buffer) is a few float32 ulps of
    its parameter, so the parameters agree to the gradient tolerance of the
    largest update plus two ulps; the updates themselves are compared through
    the momentum buffers below. Float32 in the frozen phase only (see the
    module docstring)."""
    for dtype in GRAD_DTYPES[phase]:
        run, tol = runs[dtype], TOL[dtype]
        prev = run["before"] if phase == "frozen" else run["frozen"]["port"]["state"]
        prev_jax = run["before"] if phase == "frozen" else run["frozen"]["jax_state"]
        ours, ref = run[phase]["port"]["state"], run[phase]["jax_state"]
        labels = run[phase]["port"]["labels"]
        moved = 0
        for name, label in labels.items():
            d_ours, d_ref = ours[name] - prev[name], ref[name] - prev_jax[name]
            if label == "frozen":
                np.testing.assert_array_equal(d_ours, 0.0, err_msg=f"{dtype} {name}")
                np.testing.assert_array_equal(d_ref, 0.0, err_msg=f"{dtype} {name}")
                continue
            assert np.abs(d_ref).max() > 0, name
            np.testing.assert_allclose(ours[name], ref[name], rtol=tol["param"],
                                       atol=tol["grad"] * np.abs(d_ref).max(),
                                       err_msg=f"{dtype} {name}")
            moved += 1
        assert moved > 0


@pytest.mark.parametrize("phase", PHASES)
def test_train_step_bn_stats_match_jax(runs, phase):
    for dtype in DTYPES:
        run = runs[dtype][phase]
        port = run["port"]
        assert _bn_stats_close(port["state"], run["jax_state"], port["excess"],
                               TOL[dtype]["value"]) > 0


def _momentum_error(ours, ref):
    """The whole step's relative error, sqrt(sum |ours - ref|^2 / sum |ref|^2)."""
    err = sum(np.sum((ours[n] - ref[n]).astype(np.float64) ** 2) for n in ref)
    norm = sum(np.sum(ref[n].astype(np.float64) ** 2) for n in ref)
    return np.sqrt(err / norm)


@pytest.mark.parametrize("phase", PHASES)
def test_train_step_momentum_matches_jax(runs, phase):
    """The momentum buffers against optax's trace state; float32 in the
    frozen phase only (see the module docstring)."""
    for dtype in GRAD_DTYPES[phase]:
        run = runs[dtype][phase]
        ours, ref = run["port"]["momentum"], run["jax_momentum"]
        per_tensor = TOL[dtype]["grad"]
        assert set(ours) == set(ref)
        # tensors whose exact gradient is 0 (the neck's BN bias: every head's
        # train-mode BN removes a per-channel shift of the neck output) hold
        # rounding noise only, so the floor is 1e-2 of the per-tensor
        # tolerance of the step's largest entry
        floor = 1e-2 * per_tensor * max(np.abs(v).max() for v in ref.values())
        for name in ref:
            np.testing.assert_allclose(ours[name], ref[name], rtol=per_tensor,
                                       atol=per_tensor * np.abs(ref[name]).max() + floor,
                                       err_msg=f"{dtype} {name}")
        assert _momentum_error(ours, ref) < TOL[dtype]["step"], dtype


def test_float32_unfrozen_gradients_carry_rounding_noise(runs):
    """The reading behind comparing the unfrozen phase's gradients in
    float64 only: the port's own float32 momentum, against its float64 one
    from the same weights and batch, is off by ten times the float32
    whole-step tolerance once layer2/3 train (train-mode BN at batch 2),
    while in float64 the two frameworks agree within theirs."""
    noise = _momentum_error(runs["float32"]["unfrozen"]["port"]["momentum"],
                            runs["float64"]["unfrozen"]["port"]["momentum"])
    assert noise > 10 * TOL["float32"]["step"], noise
    run = runs["float64"]["unfrozen"]
    assert _momentum_error(run["port"]["momentum"], run["jax_momentum"]) < TOL["float64"]["step"]


@pytest.mark.parametrize("unfreeze", [False, True])
@pytest.mark.parametrize("refine_only", [False, True])
def test_group_labels_match_jax(unfreeze, refine_only):
    jmodel = JaxSiamMaskBase(width=WIDTH)
    params = jax.eval_shape(lambda: jmodel.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 127, 127, 3)), jnp.zeros((1, 255, 255, 3))))
    jlabels = jax_label_params(params["params"], unfreeze, refine_only)
    flat = jax.tree_util.tree_flatten_with_path(jlabels)[0]
    ref = {_torch_name(".".join(p.key for p in path))[0]: label for path, label in flat}
    assert label_params(SiamMaskBase(width=WIDTH), unfreeze, refine_only) == ref


def test_state_dict_from_jax_maps_base_strictly(jax_vars):
    _, variables = jax_vars
    ours = state_dict_from_jax(variables)
    ref = invert_variables(variables)
    model = SiamMaskBase(width=WIDTH)
    assert set(ours) == set(ref) == set(model.state_dict())
    for name, value in ref.items():
        np.testing.assert_array_equal(ours[name].numpy(), value, err_msg=name)
    model.load_state_dict(ours, strict=True)


def test_frozen_stages_stay_frozen_under_train():
    model = SiamMaskBase(width=WIDTH)
    backbone = model.features.features
    for unfrozen in (False, True):
        backbone.unfix(unfrozen)
        model.train()
        for stage in ("conv1", "bn1", "layer1", "layer2", "layer3"):
            frozen = stage in ("conv1", "bn1", "layer1") or not unfrozen
            mod = getattr(backbone, stage)
            assert all(not m.training for m in mod.modules()) == frozen, stage
            assert all(p.requires_grad != frozen for p in mod.parameters()), stage
        assert model.rpn_model.training and model.features.downsample.training
    model.eval()
    assert not any(m.training for m in model.modules())


def _trainer_and_batch(opt_cfg=None, seed=0):
    model = SiamMaskBase(width=WIDTH).init_weights(torch.Generator().manual_seed(seed))
    _, tbatch = make_batch(seed)
    *_, tset, topt, tlr = settings_pair()
    return Trainer(model, tset, opt_cfg or topt, tlr, epochs=EPOCHS), tbatch


def test_nan_guard_moves_nothing():
    """A step whose loss is not finite changes no parameter, no momentum
    buffer and no BN statistic."""
    trainer, batch = _trainer_and_batch()
    trainer.step(batch, 0)
    model, opt = trainer.model, trainer.optimizer
    state = {k: v.clone() for k, v in model.state_dict().items()}
    momentum = {p: s["momentum_buffer"].clone() for p, s in opt.state.items()}
    bad = dict(batch, template=batch["template"].clone())
    bad["template"][0, 0, 0, 0] = float("nan")
    metrics = trainer.step(bad, 0)
    assert metrics["skipped"].item() == 1.0
    assert not np.isfinite(metrics["total_loss"].item())
    for k, v in model.state_dict().items():
        torch.testing.assert_close(v, state[k], rtol=0, atol=0, msg=k)
    for p, s in opt.state.items():
        torch.testing.assert_close(s["momentum_buffer"], momentum[p], rtol=0, atol=0)
    assert trainer.step(batch, 0)["skipped"].item() == 0.0


def test_split_clip_clips_each_group():
    """clip_split: backbone+neck, rpn and mask are each scaled to their own
    norm limit, from the same unclipped gradients."""
    limits = {"feature": 1e-3, "rpn": 2e-3, "mask": 3e-3}
    norms = {}
    for split in (False, True):
        cfg = OptimizerConfig(clip=limits["feature"] if split else 1e9, clip_split=split,
                              clip_rpn=limits["rpn"], clip_mask=limits["mask"])
        trainer, batch = _trainer_and_batch(cfg)
        trainer.step(batch, 1)
        groups = {"feature": [], "rpn": [], "mask": []}
        for g in trainer.optimizer.param_groups:
            key = {"resnet": "feature", "neck": "feature"}.get(g["name"], g["name"])
            groups[key] += [p.grad for p in g["params"]]
        norms[split] = {k: torch.linalg.vector_norm(torch.stack(
            [torch.linalg.vector_norm(x) for x in v])).item() for k, v in groups.items()}
    for k, limit in limits.items():
        assert norms[False][k] > 10 * limit  # the unclipped norms are far above
        np.testing.assert_allclose(norms[True][k], limit, rtol=1e-4)


def test_loss_falls_on_a_repeated_batch():
    trainer, batch = _trainer_and_batch()
    losses = [trainer.step(batch, 1)["total_loss"].item() for _ in range(4)]
    assert losses[-1] < losses[0], losses


def test_build_optimizer_groups():
    model = SiamMaskBase(width=WIDTH)
    model.features.features.unfix(True)
    opt, labels = build_optimizer(model, OptimizerConfig(feature_lr_mult=2.0), True)
    groups = {g["name"]: g for g in opt.param_groups}
    assert set(groups) == {"resnet", "neck", "rpn", "mask"}
    assert groups["resnet"]["mult"] == pytest.approx(0.2)
    assert groups["neck"]["mult"] == 2.0
    for g in opt.param_groups:
        assert (g["momentum"], g["weight_decay"], g["dampening"], g["nesterov"]) == \
            (0.9, 1e-4, 0.0, False)
    in_groups = {p for g in opt.param_groups for p in g["params"]}
    for name, p in model.named_parameters():
        assert (p in in_groups) == (labels[name] != "frozen") == p.requires_grad, name
