"""The port's bf16 compute mode against the JAX package's, at width 8: bf16
activations over float32 parameters (``dtype=torch.bfloat16`` on the port's
families, ``dtype=jnp.bfloat16`` on the JAX package's).

Both sides hold the same float32 weights: seeded, BN-calibrated port models
(``test_torch_families.calibrated``) whose cls head is sharpened
(``chip_smoke.sharpen_cls_head``), carried into the JAX models by the JAX
package's importer. The JAX models run their Pallas xcorr in interpret mode,
jitted, under ``Tracker(..., latency_lowerings=False)`` (the gather sampler
and the plain convs); the port's xcorr takes its plain versions on the CPU.

bf16 keeps 8 bits of mantissa, and two implementations that sum in another
order round differently at every layer, so no tolerance here is a float32
one. Stated where they are used:

- model outputs: within 3e-2 of JAX's bf16 outputs in relative L2 norm (the
  two sides' bf16-vs-float32 distances are 0.7e-2 to 2.1e-2 at this width),
  and the port's own bf16-vs-float32 distance between half and twice JAX's
  own (the two round at the same points);
- track steps, open loop: the same best cell; positions and sizes within
  1 px; the carried score within 2^-7 (two bf16 steps near 1); the cell mask
  and the mask in the frame within 3e-2;
- the video path on the CPU: bit-identical to its eager step loop;
- the stage-1 train step at batch 2: in the frozen phase the losses within
  2e-2 relative and the momentum (the clipped, decayed gradient) with a
  cosine above 0.85 to JAX's; in the unfrozen phase, whose gradient is
  bf16 rounding on both sides at this batch, the losses only
  (``test_train_step_matches_jax``).

A model built with ``dtype=torch.float32`` is the model built without it,
bit for bit.
"""
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from siammask_tpu.config import Config as JaxConfig
from siammask_tpu.models import heads as jheads
from siammask_tpu.models import losses as jlosses
from siammask_tpu.models import siammask as jsiammask
from siammask_tpu.models.siammask import SiamMaskBase as JaxSiamMaskBase
from siammask_tpu.ops.xcorr_pallas import depthwise_xcorr_ad
from siammask_tpu.config import TrackerConfig as JaxTrackerConfig
from siammask_tpu.tracker import vos as jvos
from siammask_tpu.tracker.runtime import TrackerRuntime as JaxTrackerRuntime
from siammask_tpu.tracker.tracker import Tracker as JaxTracker
from siammask_tpu.train.trainer import Trainer as JaxTrainer
from siammask_tpu.utils.torch_convert import convert_state_dict
from siammask_tpu_torch.config import Config, TrackerConfig
from siammask_tpu_torch.eval.datasets import load_dataset
from siammask_tpu_torch.models import losses
from siammask_tpu_torch.models.heads import DeconvExpand, slice_skip_windows
from siammask_tpu_torch.models.siammask import (SiamMaskBase, SiamMaskSharp, SiamRPN,
                                                build_model)
from siammask_tpu_torch.ops.sample import subwindow_crop
from siammask_tpu_torch.ops.xcorr import depthwise_xcorr
from siammask_tpu_torch.tools import test as cli
from siammask_tpu_torch.tracker.runtime import TrackerRuntime
from siammask_tpu_torch.tracker.tracker import Tracker, TrackState
from siammask_tpu_torch.tracker.vos import track_vos_batched
from siammask_tpu_torch.train.trainer import Trainer
from siammask_tpu_torch.utils import bbox
from siammask_tpu_torch.utils.convert import state_dict_from_jax

from chip_smoke import bf16_twin, bn_calibration, damp_box_head, sharpen_cls_head
from test_torch_families import POS, SZ, calibrated
from test_torch_tracker import WIDTH, _frames, one_torch_thread  # noqa: F401  (autouse)
from test_torch_train import EPOCHS, PHASES, jax_momentum, make_batch, settings_pair
from test_torch_vos import _fused
from test_torch_vot import FORCED, FRAMES, JUMP, _make_jump_dataset, _result_lines
from test_vos_e2e import HP, _make_davis

BF16 = torch.bfloat16
EXPERIMENTS = Path(__file__).resolve().parents[1] / "experiments"
# family -> (port class, JAX class, config, Tracker switches mask, refine)
FAMILIES = {
    "rpn": (SiamRPN, jsiammask.SiamRPN, "siamrpn_resnet/config.json", False, True),
    "base": (SiamMaskBase, jsiammask.SiamMaskBase, "siammask_base/config.json", True, False),
    "sharp": (SiamMaskSharp, jsiammask.SiamMaskSharp, "siammask_sharp/config_davis.json", True,
              True),
}
MODEL_TOL = 3e-2        # relative L2 norm, port bf16 against JAX bf16
DIST_RATIO = (0.5, 2.0)  # port's bf16-vs-fp32 distance over JAX's
POS_TOL = 1.0           # px, positions and sizes
SCORE_TOL = 2.0 ** -7
MASK_TOL = 3e-2


def _crops(frame: np.ndarray, pos=POS[0]):
    """The template and search crops (NCHW) that ``calibrated`` uses."""
    f = torch.from_numpy(frame)
    avg = f.mean(dim=(0, 1), dtype=torch.float32)
    return [subwindow_crop(f, torch.tensor(np.asarray([pos], np.float32)),
                           torch.tensor([float(s)]), m, avg[None]).permute(0, 3, 1, 2).contiguous()
            for s, m in ((64, 127), (128, 255))]


def _t(a) -> torch.Tensor:
    """A JAX array as a tensor of its dtype (bf16 through float32, exactly)."""
    a = np.asarray(a)
    if a.dtype == jnp.bfloat16:
        return torch.from_numpy(a.astype(np.float32)).to(BF16)
    return torch.from_numpy(np.array(a))


def _to_port(state, batched: bool = False) -> TrackState:
    zf = np.asarray(state.zf)
    zf = (zf[:, 0] if batched else zf).transpose(0, 3, 1, 2)
    return TrackState(_t(state.target_pos), _t(state.target_sz), _t(zf), _t(state.avg_chans),
                      _t(state.score))


def _np(t: torch.Tensor) -> np.ndarray:
    return t.float().numpy()


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.fixture(scope="module", params=sorted(FAMILIES))
def family(request):
    """(name, port float32 model, port bf16 model, variables, JAX float32
    model, JAX bf16 model, port bf16 Tracker, JAX bf16 Tracker), the cosine
    window off so that two streams land on distinct cells."""
    cls, jcls, config, mask, refine = FAMILIES[request.param]
    frame = _frames()[0]
    model = calibrated(cls, frame)
    sharpen_cls_head(model, *_crops(frame))
    variables = convert_state_dict({k: v.numpy() for k, v in model.state_dict().items()})
    twin = bf16_twin(model)
    jmodels = [jcls(width=WIDTH, xcorr_impl="pallas", dtype=d) for d in (jnp.float32, jnp.bfloat16)]
    path = str(EXPERIMENTS / config)
    p, p_jax = Config.load(path).tracker_config(), JaxConfig.load(path).tracker_config()
    p.window_influence = p_jax.window_influence = 0.0
    return (request.param, model, twin, variables, *jmodels,
            Tracker(twin, p, "cpu", mask=mask, refine=refine),
            JaxTracker(jmodels[1], p_jax, mask=mask, refine=refine, latency_lowerings=False))


def _port_outputs(model, z, x) -> dict:
    with torch.inference_mode():
        zf = model.template(torch.from_numpy(z).permute(0, 3, 1, 2).contiguous())
        xt = torch.from_numpy(x).permute(0, 3, 1, 2).contiguous()
        if isinstance(model, SiamMaskSharp):
            out = model.track_mask(zf, xt)
            cells = torch.tensor([[12, 10], [3, 20]])
            outs = {"score": out.score, "loc": out.loc, "corr": out.corr,
                    "refine": model.track_refine(out.skips, out.corr, cells)}
        elif isinstance(model, SiamMaskBase):
            outs = dict(zip(("score", "loc", "mask"), model.track_mask(zf, xt)))
            # base's track is the (score, loc) of its track_mask
            for name, v in zip(("score", "loc"), model.track(zf, xt)):
                assert torch.equal(v, outs[name]), name
        else:
            outs = dict(zip(("score", "loc"), model.track(zf, xt)))
    outs["template"] = zf
    return {k: v.permute(0, 2, 3, 1) if v.dim() == 4 else v for k, v in outs.items()}


def _jax_outputs(jmodel, variables, z, x) -> dict:
    apply = jax.jit(jmodel.apply, static_argnames="method")
    zf = apply(variables, jnp.asarray(z), method="template")
    outs = {"template": zf}
    if isinstance(jmodel, jsiammask.SiamRPN):
        outs.update(zip(("score", "loc"), apply(variables, zf, jnp.asarray(x), method="track")))
        return outs
    out = apply(variables, zf, jnp.asarray(x), method="track_mask")
    outs.update(score=out.score, loc=out.loc)
    if isinstance(jmodel, jsiammask.SiamMaskSharp):
        refine = jax.jit(jax.vmap(lambda s, c, pos: jmodel.apply(
            variables, s, c, pos, method="track_refine"), in_axes=((0, 0, 0), 0, 0)))
        skips = tuple(s[:, None] for s in out.skips)
        outs.update(corr=out.corr, refine=refine(skips, out.corr[:, None],
                                                 jnp.array([[12, 10], [3, 20]]))[:, 0])
    else:
        outs["mask"] = out.mask
    return outs


def test_models_match_jax(family):
    """template, track / track_mask, and sharp's track_refine at two cells:
    bf16 outputs (the carried template too) against JAX's bf16 model, and
    the bf16-vs-float32 distance against JAX's own."""
    name, model, twin, variables, jmodel32, jmodel16, _, _ = family
    rng = np.random.RandomState(3)
    z = rng.uniform(0, 255, (2, 127, 127, 3)).astype(np.float32)
    x = rng.uniform(0, 255, (2, 255, 255, 3)).astype(np.float32)
    ours16, ours32 = _port_outputs(twin, z, x), _port_outputs(model, z, x)
    ref16, ref32 = (_jax_outputs(m, variables, z, x) for m in (jmodel16, jmodel32))
    assert set(ours16) == set(ref16) == {"template", "score", "loc", *{
        "rpn": (), "base": ("mask",), "sharp": ("corr", "refine")}[name]}
    for what, ours in ours16.items():
        assert ours.dtype == BF16 and ref16[what].dtype == jnp.bfloat16, what
        assert ours32[what].dtype == torch.float32, what
        err = _rel(_np(ours), ref16[what])
        assert err < MODEL_TOL, (what, err)
        ratio = _rel(_np(ours), _np(ours32[what])) / _rel(ref16[what], ref32[what])
        assert DIST_RATIO[0] < ratio < DIST_RATIO[1], (what, ratio)


def _check_step(ours, ref, mask: bool):
    np.testing.assert_array_equal(ours.best_id.numpy(), np.asarray(ref.best_id))
    np.testing.assert_allclose(ours.target_pos.numpy(), np.asarray(ref.target_pos), atol=POS_TOL)
    np.testing.assert_allclose(ours.target_sz.numpy(), np.asarray(ref.target_sz), atol=POS_TOL)
    assert ours.score.dtype == torch.float32 and ref.score.dtype == jnp.float32
    np.testing.assert_allclose(ours.score.numpy(), np.asarray(ref.score), atol=SCORE_TOL)
    if not mask:
        return
    assert ours.mask_logits.dtype == BF16 and ref.mask_logits.dtype == jnp.bfloat16
    assert ours.mask_in_frame.dtype == torch.float32 and ref.mask_in_frame.dtype == jnp.float32
    np.testing.assert_allclose(_np(ours.mask_logits), np.asarray(ref.mask_logits, np.float32),
                               atol=MASK_TOL)
    np.testing.assert_allclose(ours.mask_in_frame.numpy(), np.asarray(ref.mask_in_frame),
                               atol=MASK_TOL)


def test_open_loop_step_matches_jax(family):
    """One step from JAX's bf16 init state: its bf16 template features carry
    over as they are, and the step keeps the state's score float32."""
    _, _, _, variables, _, _, tracker, jtracker = family
    frames = _frames()
    state = jtracker.init(variables, jnp.asarray(frames[0]), POS[0], SZ[0])
    assert state.zf.dtype == jnp.bfloat16
    ours_init = tracker.init(frames[0], POS[0], SZ[0])
    assert ours_init.zf.dtype == BF16 and ours_init.score.dtype == torch.float32
    assert _rel(_np(ours_init.zf.permute(0, 2, 3, 1)), state.zf) < MODEL_TOL
    new_state, ours = tracker.step(_to_port(state), torch.from_numpy(frames[1]))
    _, ref = jtracker.step(variables, state, jnp.asarray(frames[1]))
    _check_step(ours, ref, tracker.mask)
    assert new_state.zf.dtype == BF16 and new_state.score.dtype == torch.float32


def test_step_batched_matches_jax(family):
    """Two streams at distinct best cells against JAX's vmapped bf16 step."""
    _, _, _, variables, _, _, tracker, jtracker = family
    frames = _frames()
    states = jtracker.init_batched(variables, jnp.asarray(frames[0]), POS, SZ)
    _, ours = tracker.step_batched(_to_port(states, batched=True), torch.from_numpy(frames[1]))
    _, ref = jtracker.step_batched(variables, states, jnp.asarray(frames[1]))
    _check_step(ours, ref, tracker.mask)
    cells = ours.best_id.numpy() % 625
    assert cells[0] != cells[1]


def test_track_video_matches_step_loop(family):
    """The bf16 video path on the CPU: the step loop's outputs, bit for bit."""
    tracker = family[6]
    frames = _frames()
    state = tracker.init(frames[0], POS[0], SZ[0])
    final, outs = tracker.track_video(state, frames[1:])
    st, loop = state, []
    for frame in frames[1:]:
        st, out = tracker.step(st, frame)
        loop.append(out)
    for name, a, *b in zip(outs._fields, outs, *loop):
        torch.testing.assert_close(a, torch.stack(b), rtol=0, atol=0, msg=name)
    for a, b in zip(final, st):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("cls", [SiamRPN, SiamMaskBase, SiamMaskSharp])
def test_float32_dtype_changes_nothing(cls):
    """``dtype=torch.float32`` against no dtype: the same parameter names,
    dtypes and values, and the same step outputs bit for bit; a bf16 model's
    parameters and buffers stay float32 under the same names."""
    models = [cls(width=WIDTH, **kw).init_weights(torch.Generator().manual_seed(0)).eval()
              for kw in ({}, {"dtype": torch.float32}, {"dtype": BF16})]
    assert models[0].dtype is None and models[1].dtype is torch.float32
    states = [m.state_dict() for m in models]
    assert list(states[0]) == list(states[1]) == list(states[2])
    for k, v in states[0].items():
        assert states[1][k].dtype == states[2][k].dtype == v.dtype, k
        assert torch.equal(states[1][k], v) and torch.equal(states[2][k], v), k
    p = Config.load(str(EXPERIMENTS / FAMILIES[{SiamRPN: "rpn", SiamMaskBase: "base",
                                                 SiamMaskSharp: "sharp"}[cls]][2])).tracker_config()
    mask = cls is not SiamRPN
    refine = cls is SiamMaskSharp
    frames = _frames(3)
    runs = []
    for m in models[:2]:
        tracker = Tracker(m, p, "cpu", mask=mask, refine=refine)
        st = tracker.init(frames[0], POS[0], SZ[0])
        outs = []
        for frame in frames[1:]:
            st, out = tracker.step(st, frame)
            outs.append(out)
        runs.append((st, outs))
    for a, b in zip(runs[0][0], runs[1][0]):
        assert torch.equal(a, b)
    for a, b in zip(runs[0][1], runs[1][1]):
        for name, u, v in zip(a._fields, a, b):
            assert u.dtype == v.dtype and torch.equal(u, v), name


def test_float32_is_the_default_on_every_entry_point():
    """``build_model`` and the families default to no cast (the parameters'
    float32); the test CLI defaults to ``--dtype float32`` and hands
    ``bfloat16`` on as ``torch.bfloat16``."""
    assert build_model("Custom", width=WIDTH).dtype is None
    assert build_model("SiamRPN", width=WIDTH, dtype=BF16).dtype is BF16
    assert cli.parse_args(["--config", "c.json"]).dtype == "float32"
    assert cli.parse_args(["--config", "c.json", "--dtype", "bfloat16"]).dtype == "bfloat16"
    with pytest.raises(SystemExit):
        cli.parse_args(["--config", "c.json", "--dtype", "float16"])
    model = cli.load_model("SiamRPN", 5, None, torch.device("cpu"))
    assert model.dtype is torch.float32
    assert all(p.dtype == torch.float32 for p in model.parameters())


@pytest.mark.parametrize("dtype", [None, torch.float32, BF16], ids=["none", "float32", "bf16"])
def test_float32_model_switches_tf32_off(monkeypatch, dtype):
    """Building a float32 model switches TF32 off for the process (cuDNN's
    convs and the matmuls: the float32 reference mode); building a bf16
    model leaves both flags as they are."""
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    build_model("SiamRPN", width=WIDTH, dtype=dtype)
    tf32 = dtype is BF16
    assert torch.backends.cudnn.allow_tf32 is tf32
    assert torch.backends.cuda.matmul.allow_tf32 is tf32


def test_xcorr_bf16_route_matches_jax():
    """``depthwise_xcorr`` on bf16 CPU tensors (the plain versions) against
    the JAX package's ``depthwise_xcorr_ad`` on the same bf16 inputs (the
    Pallas kernel in interpret mode, the mm backward): bf16 out and bf16
    gradients, within 2e-2 of the largest entry (one bf16 rounding each side
    over 25 taps)."""
    rng = np.random.RandomState(0)
    x = rng.standard_normal((2, 9, 9, 16)).astype(np.float32)
    k = rng.standard_normal((2, 5, 5, 16)).astype(np.float32)
    g = rng.standard_normal((2, 5, 5, 16)).astype(np.float32)
    xj, kj, gj = (jnp.asarray(a, jnp.bfloat16) for a in (x, k, g))
    ref, vjp = jax.vjp(depthwise_xcorr_ad, xj, kj)
    ref_dx, ref_dk = vjp(gj)
    xt, kt = (torch.from_numpy(a).to(BF16).requires_grad_() for a in (x, k))
    out = depthwise_xcorr(xt, kt)
    out.backward(torch.from_numpy(g).to(BF16))
    for what, ours, theirs in (("out", out, ref), ("dx", xt.grad, ref_dx), ("dk", kt.grad, ref_dk)):
        assert ours.dtype == BF16 and theirs.dtype == jnp.bfloat16, what
        theirs = np.asarray(theirs, np.float32)
        np.testing.assert_allclose(_np(ours.detach()), theirs, rtol=0,
                                   atol=2e-2 * np.abs(theirs).max(), err_msg=what)


def test_deconv_and_skip_windows_keep_the_jax_dtypes():
    """``DeconvExpand`` on a bf16 corr vector with float32 weights is a
    float32 product, as the JAX ``DeconvExpand`` with float32 arrays in its
    bf16-declared parameters; ``slice_skip_windows`` keeps the maps' bf16,
    zero fill included."""
    deconv = DeconvExpand(16, 4, 15)
    torch.nn.init.normal_(deconv.bias)
    corr = torch.randn(2, 16, generator=torch.Generator().manual_seed(0)).to(BF16)
    ours = deconv(corr)
    params = {"params": {"kernel": deconv.weight.detach().numpy(),
                         "bias": deconv.bias.detach().numpy()}}
    ref = jheads.DeconvExpand(16, 4, 15, jnp.bfloat16).apply(
        params, jnp.asarray(corr.float().numpy(), jnp.bfloat16))
    assert ours.dtype == torch.float32 and ref.dtype == jnp.float32
    np.testing.assert_allclose(ours.detach().permute(0, 2, 3, 1).numpy(), np.asarray(ref),
                               rtol=1e-5, atol=1e-5)
    maps = [torch.randn(1, c, n, n).to(BF16) for c, n in ((4, 61), (8, 31), (16, 15))]
    for w in slice_skip_windows(*maps, torch.tensor([[0, 24]])):
        assert w.dtype == BF16 and (w == 0).any()


def test_losses_match_jax_on_bf16_maps():
    """The three losses on the same bf16 head maps: float32 losses, within
    1e-2 relative of JAX's (the log-softmax and the 63 -> 127 upsample in
    bf16 on both sides, their internal rounding not the same)."""
    _, tbatch = make_batch()
    rng = np.random.RandomState(1)
    maps = {"score": (2, 10, 25, 25), "loc": (2, 20, 25, 25), "mask": (2, 63 * 63, 25, 25)}
    ours = {k: torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(BF16)
            for k, s in maps.items()}
    theirs = {k: jnp.asarray(v.float().permute(0, 2, 3, 1).numpy(), jnp.bfloat16)
              for k, v in ours.items()}
    jb = {k: jnp.asarray(v.numpy()) for k, v in tbatch.items()}
    pairs = [
        (losses.select_cross_entropy_loss(ours["score"], tbatch["label_cls"]),
         jlosses.select_cross_entropy_loss(theirs["score"], jb["label_cls"])),
        (losses.weight_l1_loss(ours["loc"], tbatch["label_loc"], tbatch["label_loc_weight"]),
         jlosses.weight_l1_loss(theirs["loc"], jb["label_loc"], jb["label_loc_weight"])),
        (losses.select_mask_logistic_loss(ours["mask"], tbatch["label_mask"],
                                          tbatch["label_mask_weight"]).loss,
         jlosses.select_mask_logistic_loss(theirs["mask"], jb["label_mask"],
                                           jb["label_mask_weight"]).loss),
    ]
    for ours_loss, ref in pairs:
        assert ours_loss.dtype == torch.float32 and ref.dtype == jnp.float32
        np.testing.assert_allclose(ours_loss.item(), float(ref), rtol=1e-2)


@pytest.fixture(scope="module")
def train_runs():
    """A frozen (epoch 0) and an unfrozen (epoch 1) stage-1 step on each
    side from the same float32 weights and batch: the JAX Trainer on its
    bf16 SiamMaskBase, the port's Trainer on a bf16 and on a float32
    SiamMaskBase. The weights are seeded and BN-calibrated per layer on the
    batch's first pair (``chip_smoke.bn_calibration``, as its train phases
    calibrate). {phase: {"jax" / "bf16" / "fp32": (metrics, momentum)},
    "labels": the port's group labels}."""
    jbatch, tbatch = make_batch()
    model = SiamMaskBase(width=WIDTH).init_weights(torch.Generator().manual_seed(0)).eval()
    with torch.no_grad(), bn_calibration(model):
        model.forward_train(tbatch["template"][:1], tbatch["search"][:1])
    variables = convert_state_dict({k: v.numpy() for k, v in model.state_dict().items()})
    jset, jopt, jlr, tset, topt, tlr = settings_pair()
    jtrainer = JaxTrainer(JaxSiamMaskBase(width=WIDTH, xcorr_impl="pallas", dtype=jnp.bfloat16),
                          variables, jset, jopt, jlr, epochs=EPOCHS, unfreeze_at=0.5)
    trainers = {}
    for name, dtype in (("bf16", BF16), ("fp32", torch.float32)):
        port = SiamMaskBase(width=WIDTH, dtype=dtype)
        port.load_state_dict(state_dict_from_jax(variables), strict=True)
        trainers[name] = Trainer(port, tset, topt, tlr, epochs=EPOCHS, unfreeze_at=0.5)
    out = {}
    for phase, epoch in zip(PHASES, (0, 1)):
        jm = jtrainer.step(jbatch, epoch)
        out[phase] = {"jax": ({k: float(v) for k, v in jm.items()},
                              jax_momentum(jtrainer.opt_state))}
        for name, trainer in trainers.items():
            metrics = trainer.step(tbatch, epoch)
            names = {p: n for n, p in trainer.model.named_parameters()}
            momentum = {names[p]: s["momentum_buffer"]
                        for p, s in trainer.optimizer.state.items()}
            assert all(v.dtype == torch.float32 for v in momentum.values())
            out[phase][name] = ({k: float(v) for k, v in metrics.items()},
                                {n: v.numpy().copy() for n, v in momentum.items()})
        out[phase]["labels"] = dict(trainers["bf16"].labels)
    assert all(p.dtype == torch.float32 for p in trainers["bf16"].model.parameters())
    return out


def _cos(a: dict, b: dict, names) -> float:
    """The cosine between two momentum dicts over ``names``."""
    u = np.concatenate([a[n].ravel() for n in names]).astype(np.float64)
    v = np.concatenate([b[n].ravel() for n in names]).astype(np.float64)
    return float(u @ v / (np.linalg.norm(u) * np.linalg.norm(v)))


@pytest.mark.parametrize("phase", PHASES)
def test_train_step_matches_jax(train_runs, phase):
    """Trainer.step on a bf16 SiamMaskBase against the JAX Trainer on its
    bf16 model: float32 momentum (the clipped, decayed gradient), no skip,
    finite losses, every trained group moved.

    Frozen phase: every loss within 2e-2 relative of JAX's (measured within
    0.3%); the momentum's cosine to JAX's above 0.85 over the step (0.90
    measured) and above 0.9 for the mask head (0.96), and no further from
    JAX's than from the port's own float32 step (0.82 to that: at batch 2
    the gradient through the heads' train-mode BN carries ~17% of bf16
    rounding on either side).

    Unfrozen phase: the gradient through layer2/3's train-mode BN at batch
    2 is bf16 rounding on both sides (the cosine of JAX's own bf16 step to
    its float32 step is 0.17 here; cuDNN's at batch 64 is ``chip_smoke.py``
    ``[bf16-train]``'s), so only the losses are held: the total within 2e-2
    (0.05% measured), cls and loc within 1e-1 (4-6% measured, as far as
    JAX's bf16 is from its float32)."""
    run = train_runs[phase]
    (ours, mom), (ref, jmom), (_, mom32) = run["bf16"], run["jax"], run["fp32"]
    labels = run["labels"]
    assert ours["skipped"] == ref["skipped"] == 0.0
    assert all(np.isfinite(v) for v in ours.values())
    assert set(mom) == set(jmom) == {n for n, g in labels.items() if g != "frozen"}
    groups = sorted({labels[n] for n in mom})
    assert groups == (["mask", "neck", "resnet", "rpn"] if phase == "unfrozen"
                      else ["mask", "neck", "rpn"])
    assert all(np.abs(mom[n]).max() > 0 for n in mom)
    names = sorted(mom)
    if phase == "unfrozen":
        np.testing.assert_allclose(ours["total_loss"], ref["total_loss"], rtol=2e-2)
        for k in ("cls_loss", "loc_loss", "mask_loss"):
            np.testing.assert_allclose(ours[k], ref[k], rtol=1e-1, err_msg=k)
        return
    for k in ("cls_loss", "loc_loss", "mask_loss", "total_loss"):
        np.testing.assert_allclose(ours[k], ref[k], rtol=2e-2, err_msg=k)
    cos = _cos(mom, jmom, names)
    assert cos > 0.85 and cos >= _cos(mom, mom32, names), cos
    assert _cos(mom, jmom, [n for n in names if labels[n] == "mask"]) > 0.9


def test_vos_batched_base_matches_jax(tmp_path):
    """``track_vos_batched`` with a bf16 SiamMask-base (63x63 masks) on the
    synthetic two-object DAVIS video, a full window through
    ``track_video_multi`` and a ragged tail, against the JAX driver on its
    bf16 model: per-object mean IoU within 5e-2 at every threshold (1.4e-2
    measured) and the fused PNGs equal on 98% of the pixels (99.0%). It is
    a closed loop over 4 frames: a bf16 rounding moves a box by a fraction
    of a pixel and the masks' edges with it, so runs that round otherwise
    part a little (the port's bf16 run agrees with its float32 run on 98.8%
    of the pixels, JAX's on 99.8%); open loop, the port's bf16 cell masks
    are no further from float32 than JAX's (``test_open_loop_step_matches_jax``
    holds them to JAX's)."""
    frames = _frames()
    model = calibrated(SiamMaskBase, frames[0])
    sharpen_cls_head(model, *_crops(frames[0]))
    variables = convert_state_dict({k: v.numpy() for k, v in model.state_dict().items()})
    _make_davis(tmp_path / "DAVIS")
    video = load_dataset("DAVIS2017", str(tmp_path))["synth"]
    hp = {**HP, "out_size": 63}
    runtime = TrackerRuntime(bf16_twin(model), TrackerConfig().update(hp), "cpu", refine=False)
    jruntime = JaxTrackerRuntime(jsiammask.SiamMaskBase(width=WIDTH, xcorr_impl="pallas",
                                                        dtype=jnp.bfloat16),
                                 variables, JaxTrackerConfig().update(hp), refine=False,
                                 latency_lowerings=False)
    runs = {}
    for name, driver, rt in (("ours", track_vos_batched, runtime),
                             ("jax", jvos.track_vos_batched, jruntime)):
        iou, _ = driver(rt, video, result_dir=str(tmp_path / name), dataset="DAVIS2017",
                        save_mask=True, log=lambda *_: None, scan_chunk=2)
        runs[name] = (np.asarray(iou), _fused(tmp_path / name, "DAVIS2017", "synth"))
    (iou, fused), (ref, ref_fused) = runs["ours"], runs["jax"]
    assert iou.shape == ref.shape == (2, 4)
    np.testing.assert_allclose(iou, ref, rtol=0, atol=5e-2)
    assert len(fused) == len(ref_fused) == len(video["image_files"])
    same = np.mean([np.mean(a == b) for a, b in zip(fused, ref_fused)])
    assert same > 0.98, same


def test_trainer_refuses_bf16_under_distributed():
    """A bf16 model under ``distributed`` is refused only as a float32 one
    is, for want of a process group: the dtype itself is accepted
    (``tests/test_torch_parallel.py`` trains it on two ranks)."""
    *_, tset, topt, tlr = settings_pair()
    for dtype in (BF16, None):
        with pytest.raises(RuntimeError, match="needs an initialised process group"):
            Trainer(SiamMaskBase(width=WIDTH, dtype=dtype), tset, topt, tlr, epochs=EPOCHS,
                    distributed=True)


def test_cli_dtype_runs_a_vot_video_in_bf16(tmp_path, monkeypatch):
    """``main --dtype bfloat16`` builds the model in bf16 and tracks one VOT
    video on the CPU (SiamRPN, the published width, a reference-style
    ``.pth``): the forced loss at the jump, and the same markers as the
    float32 run of the same weights."""
    import cv2

    _make_jump_dataset(tmp_path / "data" / "VOT2018")
    video = tmp_path / "data" / "VOT2018" / "vid1"
    gt = np.loadtxt(video / "groundtruth.txt", delimiter=",")
    cx, cy, _, _ = bbox.get_axis_aligned_bbox(gt[0])
    frame = cv2.imread(str(video / "00000001.jpg"))
    model = calibrated(SiamRPN, frame, np.array([cx, cy], np.float32), width=64)
    damp_box_head(model)
    ckpt = tmp_path / "rpn.pth"
    torch.save({"state_dict": {f"module.{k}": v for k, v in model.state_dict().items()}}, ckpt)
    built = []
    real = cli.build_model
    monkeypatch.setattr(cli, "build_model", lambda *a, **kw: built.append(kw["dtype"])
                        or real(*a, **kw))
    markers = {}
    for dtype in ("float32", "bfloat16"):
        totals = cli.main(["--config", str(EXPERIMENTS / "siamrpn_resnet" / "config.json"),
                           "--resume", str(ckpt), "--dataset", "VOT2018", "--data-dir",
                           str(tmp_path / "data"), "--video", "vid1", "--result-dir",
                           str(tmp_path / dtype), "--device", "cpu", "--dtype", dtype])
        assert totals["videos"] == 1 and totals["lost"] == 1
        lines = _result_lines(tmp_path / dtype, "SiamRPN_rpn", "vid1")
        assert len(lines) == FRAMES and lines[JUMP:JUMP + 6] == FORCED
        markers[dtype] = [line if line in ("0", "1", "2") else "region" for line in lines]
    assert built == [torch.float32, BF16]
    assert markers["bfloat16"] == markers["float32"]
