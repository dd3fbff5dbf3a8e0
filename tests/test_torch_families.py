"""The port's SiamRPN and SiamMask-base against the JAX package's, at width 8
on seeded 120x160 uint8 frames: the models (``template``, ``track``,
``track_mask``), the box-only tracker (``Tracker(mask=False)``) and the 63²
mask tracker (``Tracker(refine=False)``), one stream and two, and the video
path on the CPU.

The JAX models run their Pallas xcorr (``xcorr_impl="pallas"``, interpret
mode on the CPU), jitted, under ``Tracker(..., latency_lowerings=False)``; the
weights are the port's, seeded and BN-calibrated, carried over by the JAX
package's own importer. Steps are compared open loop, as in
``test_torch_tracker.py``.
"""
from functools import cache
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from siammask_tpu.config import Config as JaxConfig
from siammask_tpu.models import siammask as jsiammask
from siammask_tpu.tracker.tracker import Tracker as JaxTracker
from siammask_tpu.utils.torch_convert import convert_state_dict
from siammask_tpu_torch.config import Config
from siammask_tpu_torch.models.siammask import (SiamMaskBase, SiamMaskSharp, SiamRPN,
                                                build_model)
from siammask_tpu_torch.ops.sample import subwindow_crop
from siammask_tpu_torch.tracker.runtime import TrackerRuntime
from siammask_tpu_torch.tracker.tracker import BoxStepOutput, StepOutput, Tracker, TrackState
from siammask_tpu_torch.utils.convert import load_reference_state_dict, state_dict_from_jax

from chip_smoke import calibrate_bn
from test_torch_tracker import WIDTH, _frames, one_torch_thread  # noqa: F401  (autouse)
from test_torch_video import _to_port as _to_port_batched

EXPERIMENTS = Path(__file__).resolve().parents[1] / "experiments"
# family -> (port class, JAX class, config, Tracker switches mask, refine)
FAMILIES = {
    "rpn": (SiamRPN, jsiammask.SiamRPN, "siamrpn_resnet/config.json", False, True),
    "base": (SiamMaskBase, jsiammask.SiamMaskBase, "siammask_base/config.json", True, False),
}
# two streams whose best cells differ, so a transposed 63² gather shows
POS = np.array([(84.0, 58.0), (40.0, 80.0)], np.float32)
SZ = np.array([(44.0, 30.0), (30.0, 36.0)], np.float32)


def calibrated(cls, frame: np.ndarray, pos=POS[0], width: int = WIDTH):
    """A seeded port model with its BN calibrated on crops of ``frame``
    around ``pos`` (activations O(1), scores unsaturated)."""
    model = cls(width=width).init_weights(torch.Generator().manual_seed(0)).eval()
    f = torch.from_numpy(frame)
    avg = f.mean(dim=(0, 1), dtype=torch.float32)
    crops = [subwindow_crop(f, torch.tensor(np.asarray([pos], np.float32)),
                            torch.tensor([float(s)]), m, avg[None])
             for s, m in ((64, 127), (128, 255))]
    calibrate_bn(model, *(c.permute(0, 3, 1, 2).contiguous() for c in crops))
    return model


@pytest.fixture(scope="module", params=sorted(FAMILIES))
def family(request):
    """(name, port model, its Tracker, the JAX model, its variables, its
    Tracker) for one family."""
    cls, jcls, config, mask, refine = FAMILIES[request.param]
    model = calibrated(cls, _frames()[0])
    variables = convert_state_dict({k: v.numpy() for k, v in model.state_dict().items()})
    jmodel = jcls(width=WIDTH, xcorr_impl="pallas")
    path = str(EXPERIMENTS / config)
    p, p_jax = Config.load(path).tracker_config(), JaxConfig.load(path).tracker_config()
    # the cosine window off: on random weights its centre wins every argmax,
    # and the streams must land on distinct cells
    p.window_influence = p_jax.window_influence = 0.0
    return (request.param, model, Tracker(model, p, "cpu", mask=mask, refine=refine),
            jmodel, variables,
            JaxTracker(jmodel, p_jax, mask=mask, refine=refine, latency_lowerings=False))


def _to_port(state) -> TrackState:
    zf = np.asarray(state.zf).transpose(0, 3, 1, 2)
    return TrackState(*(torch.from_numpy(np.array(a)) for a in
                        (state.target_pos, state.target_sz, zf, state.avg_chans, state.score)))


@cache
def _jax_tree_shapes(jcls):
    ref = jax.eval_shape(jcls(width=WIDTH).init, jax.random.PRNGKey(0),
                         jnp.zeros((1, 127, 127, 3)), jnp.zeros((1, 255, 255, 3)))
    return jax.tree.map(lambda v: tuple(v.shape), ref)


def _close(ours: torch.Tensor, ref, what: str):
    """1e-4 of the largest magnitude; ours NCHW, ref NHWC."""
    ref = np.asarray(ref)
    np.testing.assert_allclose(ours.permute(0, 2, 3, 1).numpy(), ref, rtol=0,
                               atol=1e-4 * np.abs(ref).max(), err_msg=what)


@pytest.mark.parametrize("arch,cls,modules", [
    ("SiamRPN", SiamRPN, {"features", "rpn_model"}),
    ("SiamMaskBase", SiamMaskBase, {"features", "rpn_model", "mask_model"}),
    ("Custom", SiamMaskSharp, {"features", "rpn_model", "mask_model", "refine_model"}),
    ("SiamMaskSharp", SiamMaskSharp, {"features", "rpn_model", "mask_model", "refine_model"}),
])
def test_build_model_keeps_each_family_tree(arch, cls, modules):
    """``build_model`` maps the reference's arch names; each family's
    state_dict holds its own modules only, the JAX importer reads it into the
    JAX model's own variable tree, ``state_dict_from_jax`` carries that back
    and ``load_reference_state_dict`` loads it (with the ``module.`` prefix)
    into a fresh model of the family."""
    model = build_model(arch, width=WIDTH)
    assert type(model) is cls and model.anchor_num == 5
    state = model.state_dict()
    assert {k.split(".")[0] for k in state} == modules
    variables = convert_state_dict({k: v.numpy() for k, v in state.items()})
    jcls = {"SiamRPN": jsiammask.SiamRPN, "SiamMaskBase": jsiammask.SiamMaskBase}.get(
        arch, jsiammask.SiamMaskSharp)
    assert jax.tree.map(lambda v: tuple(v.shape), variables) == _jax_tree_shapes(jcls)
    back = state_dict_from_jax(variables)
    assert back.keys() == state.keys()
    for k, v in state.items():
        torch.testing.assert_close(back[k], v if "num_batches" not in k else torch.tensor(0))
    fresh = build_model(arch, width=WIDTH)
    load_reference_state_dict(fresh, {f"module.{k}": v for k, v in back.items()})
    for k, v in fresh.state_dict().items():
        if "num_batches" not in k:
            torch.testing.assert_close(v, state[k], rtol=0, atol=0)


def test_build_model_rejects_unknown_arch():
    with pytest.raises(ValueError, match="unknown arch"):
        build_model("SiamFC")


def test_models_match_jax(family):
    """template, track and (base) track_mask on the same crops. JAX's base
    ``track`` is the (score, loc) of its ``track_mask`` (the same layers), so
    for base one JAX ``track_mask`` holds both of the port's methods."""
    name, model, _, jmodel, variables, _ = family
    rng = np.random.RandomState(3)
    z = rng.uniform(0, 255, (2, 127, 127, 3)).astype(np.float32)
    x = rng.uniform(0, 255, (2, 255, 255, 3)).astype(np.float32)
    apply = jax.jit(jmodel.apply, static_argnames="method")
    zf_ref = apply(variables, jnp.asarray(z), method="template")
    refs = apply(variables, zf_ref, jnp.asarray(x),
                 method="track_mask" if name == "base" else "track")
    with torch.inference_mode():
        zf = model.template(torch.from_numpy(z).permute(0, 3, 1, 2).contiguous())
        xt = torch.from_numpy(x).permute(0, 3, 1, 2).contiguous()
        ours = {"track": model.track(zf, xt)}
        if name == "base":
            ours["track_mask"] = model.track_mask(zf, xt)
    _close(zf, zf_ref, "template")
    for method, outs in ours.items():
        assert len(outs) == (3 if method == "track_mask" else 2)
        for what, a, b in zip(("score", "loc", "mask"), outs, refs):
            assert a.shape[1] == {"score": 10, "loc": 20, "mask": 63 * 63}[what]
            _close(a, b, f"{method} {what}")


def _check_step(ours, ref, mask: bool):
    np.testing.assert_array_equal(ours.best_id.numpy(), np.asarray(ref.best_id))
    np.testing.assert_allclose(ours.target_pos.numpy(), np.asarray(ref.target_pos), atol=1e-3)
    np.testing.assert_allclose(ours.target_sz.numpy(), np.asarray(ref.target_sz), atol=1e-3)
    np.testing.assert_allclose(ours.score.numpy(), np.asarray(ref.score), atol=1e-5)
    if not mask:
        assert type(ours) is BoxStepOutput
        assert ref.mask_in_frame is None and ref.mask_logits is None
        return
    assert type(ours) is StepOutput and ours.mask_logits.shape[-2:] == (63, 63)
    np.testing.assert_allclose(ours.mask_logits.numpy(), np.asarray(ref.mask_logits), atol=1e-5)
    np.testing.assert_allclose(ours.mask_in_frame.numpy(), np.asarray(ref.mask_in_frame),
                               atol=1e-4)


def test_open_loop_steps_match_jax(family):
    _, _, tracker, _, variables, jtracker = family
    frames = _frames()
    state = jtracker.init(variables, jnp.asarray(frames[0]), POS[0], SZ[0])
    for frame in frames[1:]:
        ours_state, ours = tracker.step(_to_port(state), torch.from_numpy(frame))
        state, ref = jtracker.step(variables, state, jnp.asarray(frame))
        _check_step(ours, ref, tracker.mask)
        np.testing.assert_array_equal(ours_state.target_pos.numpy(), ours.target_pos.numpy())


def test_step_batched_matches_jax(family):
    """Two streams at distinct best cells against JAX's vmapped step."""
    _, _, tracker, _, variables, jtracker = family
    frames = _frames()
    states = jtracker.init_batched(variables, jnp.asarray(frames[0]), POS, SZ)
    cells = set()
    for frame in frames[1:]:
        _, ours = tracker.step_batched(_to_port_batched(states), torch.from_numpy(frame))
        states, ref = jtracker.step_batched(variables, states, jnp.asarray(frame))
        _check_step(ours, ref, tracker.mask)
        best = ours.best_id.numpy() % 625
        assert best[0] != best[1]
        cells.update(best.tolist())
    assert len(cells) == 2 * (len(frames) - 1)


def test_sharp_without_refine_matches_jax():
    """SiamMask-sharp with ``refine=False``: the raw 63² head at each
    stream's best cell (the port runs the head on the corr vector gathered
    there), two streams at distinct cells, against JAX's vmapped step."""
    frames = _frames()
    model = calibrated(SiamMaskSharp, frames[0])
    variables = convert_state_dict({k: v.numpy() for k, v in model.state_dict().items()})
    path = str(EXPERIMENTS / "siammask_base/config.json")     # out_size 63
    p, p_jax = Config.load(path).tracker_config(), JaxConfig.load(path).tracker_config()
    p.window_influence = p_jax.window_influence = 0.0
    tracker = Tracker(model, p, "cpu", refine=False)
    jtracker = JaxTracker(jsiammask.SiamMaskSharp(width=WIDTH, xcorr_impl="pallas"), p_jax,
                          refine=False, latency_lowerings=False)
    states = jtracker.init_batched(variables, jnp.asarray(frames[0]), POS, SZ)
    for frame in frames[1:]:
        _, ours = tracker.step_batched(_to_port_batched(states), torch.from_numpy(frame))
        states, ref = jtracker.step_batched(variables, states, jnp.asarray(frame))
        _check_step(ours, ref, True)
        best = ours.best_id.numpy() % 625
        assert best[0] != best[1]


def _stacked(outs):
    return type(outs[0])(*(torch.stack(v) for v in zip(*outs)))


def test_track_video_matches_step_loop(family):
    """The CPU video path: the same outputs as the step loop, bit for bit,
    in the family's output type."""
    _, _, tracker, _, _, _ = family
    frames = _frames()
    state = tracker.init(frames[0], POS[0], SZ[0])
    final, outs = tracker.track_video(state, frames[1:])
    st, loop = state, []
    for frame in frames[1:]:
        st, out = tracker.step(st, frame)
        loop.append(out)
    assert type(outs) is type(loop[0])
    for name, a, b in zip(outs._fields, outs, _stacked(loop)):
        torch.testing.assert_close(a, b, rtol=0, atol=0, msg=name)
    for a, b in zip(final, st):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_runtime_keys_follow_the_mask_switch(family):
    """Without the mask: no mask key and no polygon, as the JAX runtime."""
    _, model, tracker, _, _, _ = family
    frames = _frames(2)
    runtime = TrackerRuntime(model, tracker.p, "cpu", mask=tracker.mask, refine=tracker.refine)
    runtime.init(frames[0], POS[0], SZ[0])
    for soft_mask, key in ((True, "mask"), (False, "mask_bin")):
        result = runtime.track(frames[1], soft_mask=soft_mask)
        keys = {"target_pos", "target_sz", "score"}
        assert set(result) == (keys | {key, "polygon"} if tracker.mask else keys)


@pytest.mark.parametrize("cls,mask,refine,out_size,match", [
    (SiamRPN, True, True, 127, "needs a SiamMaskSharp"),
    (SiamRPN, True, False, 63, "needs a SiamMaskBase or SiamMaskSharp"),
    (SiamMaskBase, True, True, 127, "needs a SiamMaskSharp"),
    (SiamMaskSharp, True, False, 127, "reads the 63x63 mask head"),
])
def test_tracker_rejects_a_model_without_the_path(cls, mask, refine, out_size, match):
    """A path the model lacks, or the 63² head read at a sharp config's
    out_size (127)."""
    p = Config().tracker_config()
    p.out_size = out_size
    with pytest.raises(ValueError, match=match):
        Tracker(cls(width=WIDTH), p, "cpu", mask=mask, refine=refine)
