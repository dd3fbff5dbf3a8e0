"""The port's batched and whole-video tracking against the JAX package's
``Tracker(..., latency_lowerings=False)`` (the gather sampler and plain
convs) at width 8, on seeded 120x160 uint8 frames: the crop and warp-back
over O windows, the per-sample skip windows and Refine, ``init_batched``,
``step_batched`` and the shapes of ``track_video`` / ``track_video_multi``.

The JAX side's stream axis is ``jax.vmap``; the port's is a leading
dimension. Steps are compared open loop, as in ``test_torch_tracker.py``.
"""
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from siammask_tpu.config import Config as JaxConfig
from siammask_tpu.models import heads as jheads
from siammask_tpu.models.siammask import SiamMaskSharp as JaxSiamMaskSharp
from siammask_tpu.ops import sample as jsample
from siammask_tpu.tracker.tracker import Tracker as JaxTracker
from siammask_tpu.utils.torch_convert import convert_state_dict
from siammask_tpu_torch.config import Config
from siammask_tpu_torch.models.heads import slice_skip_windows
from siammask_tpu_torch.models.siammask import SiamMaskSharp
from siammask_tpu_torch.ops.sample import subwindow_crop, warp_back_mask
from siammask_tpu_torch.tracker.tracker import StepOutput, Tracker, TrackState

from chip_smoke import calibrate_bn
from test_torch_tracker import CONFIG, WIDTH, _frames, one_torch_thread  # noqa: F401  (autouse)

# three streams; the second starts across the left border of the frame
POS = np.array([(84.0, 58.0), (12.0, 96.0), (130.0, 34.0)], np.float32)
SZ = np.array([(44.0, 30.0), (36.0, 40.0), (50.0, 24.0)], np.float32)
RNG = np.random.RandomState(17)


@pytest.fixture(scope="module")
def trackers():
    """Seeded port weights with BN statistics calibrated on crops of the first
    frame, carried into the JAX model through its checkpoint importer."""
    p_jax = JaxConfig.load(str(CONFIG)).tracker_config()
    p = Config.load(str(CONFIG)).tracker_config()
    model = SiamMaskSharp(width=WIDTH).init_weights(torch.Generator().manual_seed(0)).eval()
    frame = torch.from_numpy(_frames()[0])
    avg = frame.mean(dim=(0, 1), dtype=torch.float32)
    crops = [subwindow_crop(frame, torch.from_numpy(POS[:1]), torch.tensor([float(s)]), m,
                            avg[None]) for s, m in ((64, 127), (128, 255))]
    calibrate_bn(model, *(c.permute(0, 3, 1, 2).contiguous() for c in crops))
    variables = convert_state_dict({k: v.numpy() for k, v in model.state_dict().items()})
    jmodel = JaxSiamMaskSharp(width=WIDTH)
    return JaxTracker(jmodel, p_jax, latency_lowerings=False), jmodel, variables, \
        Tracker(model, p, "cpu")


def _to_port(states) -> TrackState:
    """A JAX batched state (zf (O, 1, 7, 7, C)) as the port's (zf (O, C, 7, 7))."""
    zf = np.asarray(states.zf)[:, 0].transpose(0, 3, 1, 2)
    return TrackState(*(torch.from_numpy(np.array(a)) for a in
                        (states.target_pos, states.target_sz, zf, states.avg_chans,
                         states.score)))


def _stream(states: TrackState, i: int) -> TrackState:
    return TrackState(states.target_pos[i], states.target_sz[i], states.zf[i:i + 1],
                      states.avg_chans[i], states.score[i])


@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
def test_batched_crop_matches_vmapped_jax(dtype):
    frame = RNG.uniform(0, 255, size=(120, 160, 3)).astype(dtype)
    avg = frame.astype(np.float32).mean(axis=(0, 1))
    avgs = np.stack([avg, avg + 3.0, avg - 5.0]).astype(np.float32)
    crop_sz = np.array([64.0, 90.0, 127.0], np.float32)
    crop = partial(jsample.subwindow_crop, jnp.asarray(frame), model_sz=127)
    ref = np.asarray(jax.vmap(lambda p, c, a: crop(pos_xy=p, crop_sz=c, avg_chans=a))(
        POS, crop_sz, avgs))
    ours = subwindow_crop(torch.from_numpy(frame), torch.from_numpy(POS),
                          torch.from_numpy(crop_sz), 127, torch.from_numpy(avgs))
    assert ours.dtype == torch.float32 and ours.shape == (3, 127, 127, 3)
    # 0-255 values; fp32 rounding of the blend only
    np.testing.assert_allclose(ours.numpy(), ref, atol=1e-3)
    for i in range(3):   # each window is the call on that window alone
        single = subwindow_crop(torch.from_numpy(frame), torch.from_numpy(POS[i:i + 1]),
                                torch.from_numpy(crop_sz[i:i + 1]), 127,
                                torch.from_numpy(avgs[i:i + 1]))
        torch.testing.assert_close(ours[i], single[0], rtol=0, atol=0)


def test_batched_warp_back_matches_vmapped_jax():
    masks = RNG.uniform(-6, 6, size=(3, 127, 127)).astype(np.float32)
    boxes = np.array([(-50.3, -20.7, 288.0, 216.0), (10.0, 30.0, 90.0, 60.0),
                      (-400.0, -300.0, 1200.0, 900.0)], np.float32)
    ref = np.asarray(jax.vmap(lambda m, b: jsample.warp_back_mask(m, b, (120, 160)))(
        masks, boxes))
    ours = warp_back_mask(torch.from_numpy(masks), torch.from_numpy(boxes), (120, 160))
    assert ours.shape == (3, 120, 160)
    np.testing.assert_allclose(ours.numpy(), ref, atol=1e-5)
    for i in range(3):
        single = warp_back_mask(torch.from_numpy(masks[i:i + 1]),
                                torch.from_numpy(boxes[i:i + 1]), (120, 160))
        torch.testing.assert_close(ours[i], single[0], rtol=0, atol=0)


def _skip_maps(b=3):
    """NHWC skip maps of the width-8 search pass."""
    return [RNG.randn(b, n, n, c).astype(np.float32)
            for n, c in ((125, WIDTH), (63, 4 * WIDTH), (31, 8 * WIDTH))]


def test_batched_skip_windows_match_vmapped_jax():
    maps = _skip_maps()
    cells = np.array([(0, 0), (24, 24), (12, 3)], np.int32)
    ref = jax.vmap(lambda a, b, c, pos: jheads.slice_skip_windows(
        a[None], b[None], c[None], pos))(*maps, cells)
    ours = slice_skip_windows(*(torch.from_numpy(m).permute(0, 3, 1, 2) for m in maps),
                              torch.from_numpy(cells).long())
    for o, r, win in zip(ours, ref, (61, 31, 15)):
        assert o.shape[2:] == (win, win)
        np.testing.assert_array_equal(o.permute(0, 2, 3, 1).numpy(), np.asarray(r)[:, 0])


def test_batched_track_refine_matches_jax(trackers):
    """Refine at a different cell per sample against the JAX Refine under
    ``vmap``, on the same skip maps and corr features."""
    _, jmodel, variables, tracker = trackers
    maps = _skip_maps()
    corr = RNG.randn(3, 25, 25, 4 * WIDTH).astype(np.float32)
    cells = np.array([(0, 0), (24, 24), (7, 19)], np.int32)
    ref = jax.jit(jax.vmap(lambda s0, s1, s2, c, pos: jmodel.apply(
        variables, (s0[None], s1[None], s2[None]), c[None], pos,
        method="track_refine")[0]))(*maps, corr, cells)
    nchw = [torch.from_numpy(m).permute(0, 3, 1, 2) for m in (*maps, corr)]
    with torch.inference_mode():
        ours = tracker.model.track_refine(nchw[:3], nchw[3], torch.from_numpy(cells).long())
        first = tracker.model.track_refine([m[:1] for m in nchw[:3]], nchw[3][:1],
                                           torch.from_numpy(cells[:1]).long())
    ref = np.asarray(ref)
    assert ours.shape == (3, 127 * 127)
    np.testing.assert_allclose(ours.numpy(), ref, rtol=1e-4, atol=1e-4 * np.abs(ref).max())
    torch.testing.assert_close(ours[:1], first)


def test_init_batched_matches_jax(trackers):
    jtracker, _, variables, tracker = trackers
    frame = _frames()[0]
    ref = jtracker.init_batched(variables, jnp.asarray(frame), POS, SZ)
    ours = tracker.init_batched(frame, POS, SZ)
    assert ours.zf.shape == (3, 4 * WIDTH, 7, 7) and ours.avg_chans.shape == (3, 3)
    assert ours.score.shape == (3,)
    np.testing.assert_array_equal(ours.target_pos.numpy(), np.asarray(ref.target_pos))
    np.testing.assert_allclose(ours.avg_chans.numpy(), np.asarray(ref.avg_chans), rtol=1e-6)
    zf = np.asarray(ref.zf)[:, 0]
    np.testing.assert_allclose(ours.zf.permute(0, 2, 3, 1).numpy(), zf, rtol=1e-4,
                               atol=1e-4 * np.abs(zf).max())


def test_step_batched_matches_jax_open_loop(trackers):
    jtracker, _, variables, tracker = trackers
    frames = _frames()
    states = jtracker.init_batched(variables, jnp.asarray(frames[0]), POS, SZ)
    for frame in frames[1:]:
        ours_states, ours = tracker.step_batched(_to_port(states), torch.from_numpy(frame))
        states, ref = jtracker.step_batched(variables, states, jnp.asarray(frame))
        np.testing.assert_array_equal(ours.best_id.numpy(), np.asarray(ref.best_id))
        np.testing.assert_allclose(ours.target_pos.numpy(), np.asarray(ref.target_pos), atol=1e-3)
        np.testing.assert_allclose(ours.target_sz.numpy(), np.asarray(ref.target_sz), atol=1e-3)
        np.testing.assert_allclose(ours.score.numpy(), np.asarray(ref.score), atol=1e-5)
        np.testing.assert_allclose(ours.mask_logits.numpy(), np.asarray(ref.mask_logits),
                                   atol=1e-5)
        assert ours.mask_in_frame.shape == (3, *frame.shape[:2])
        np.testing.assert_allclose(ours.mask_in_frame.numpy(), np.asarray(ref.mask_in_frame),
                                   atol=1e-4)
        np.testing.assert_array_equal(ours_states.target_sz.numpy(), ours.target_sz.numpy())


def test_step_batched_rows_match_single_step(trackers):
    """Row i of the batched step is the single-object step of stream i
    (batch-3 and batch-1 convs on the CPU: fp32 summation order only)."""
    *_, tracker = trackers
    frames = _frames()
    states = tracker.init_batched(frames[0], POS, SZ)
    _, batched = tracker.step_batched(states, frames[1])
    for i in range(3):
        _, single = tracker.step(_stream(states, i), frames[1])
        assert int(single.best_id) == int(batched.best_id[i])
        for name in ("target_pos", "target_sz", "score", "mask_logits", "mask_in_frame"):
            torch.testing.assert_close(getattr(batched, name)[i], getattr(single, name),
                                       rtol=1e-5, atol=1e-5, msg=name)


def _stacked(outs):
    return StepOutput(*(torch.stack(v) for v in zip(*outs)))


def _shapes(tree):
    return [tuple(a.shape) for a in tree]


def test_track_video_matches_step_loop_and_jax_shapes(trackers):
    jtracker, _, variables, tracker = trackers
    frames = _frames()
    state = tracker.init(frames[0], POS[0], SZ[0])
    final, outs = tracker.track_video(state, frames[1:])
    st, loop = state, []
    for frame in frames[1:]:
        st, out = tracker.step(st, frame)
        loop.append(out)
    for name, a, b in zip(StepOutput._fields, outs, _stacked(loop)):
        torch.testing.assert_close(a, b, rtol=0, atol=0, msg=name)
    for a, b in zip(final, st):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    jstate = jtracker.init(variables, jnp.asarray(frames[0]), POS[0], SZ[0])
    jfinal, jouts = jax.eval_shape(jtracker.track_video, variables, jstate,
                                   jnp.asarray(frames[1:]))
    assert _shapes(outs) == _shapes(jouts) == [(3, 2), (3, 2), (3,), (3,), (3, 120, 160),
                                                (3, 127, 127)]
    assert _shapes(final)[:2] == _shapes(jfinal)[:2]


def test_track_video_multi_matches_step_batched_loop_and_jax_shapes(trackers):
    jtracker, _, variables, tracker = trackers
    frames = _frames()
    states = tracker.init_batched(frames[0], POS, SZ)
    final, outs = tracker.track_video_multi(states, frames[1:])
    st, loop = states, []
    for frame in frames[1:]:
        st, out = tracker.step_batched(st, frame)
        loop.append(out)
    for name, a, b in zip(StepOutput._fields, outs, _stacked(loop)):
        torch.testing.assert_close(a, b, rtol=0, atol=0, msg=name)
    for a, b in zip(final, st):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    jstates = jtracker.init_batched(variables, jnp.asarray(frames[0]), POS, SZ)
    _, jouts = jax.eval_shape(jtracker.track_video_multi, variables, jstates,
                              jnp.asarray(frames[1:]))
    assert _shapes(outs) == _shapes(jouts) == [(3, 3, 2), (3, 3, 2), (3, 3), (3, 3),
                                                (3, 3, 120, 160), (3, 3, 127, 127)]
