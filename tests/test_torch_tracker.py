"""The slice: the port's SiamMask-sharp tracker against the JAX package's
``Tracker(..., latency_lowerings=False)`` (the gather sampler and plain convs)
at width 8, on seeded 120x160 uint8 frames.

Steps are compared open-loop: at each step the JAX state, converted, is fed
to the port, because closed loops over random weights diverge from 1-ULP
differences.
"""
import dataclasses
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from siammask_tpu.config import Config as JaxConfig
from siammask_tpu.models.siammask import SiamMaskSharp as JaxSiamMaskSharp
from siammask_tpu.tracker import anchors as janchors
from siammask_tpu.tracker.tracker import Tracker as JaxTracker
from siammask_tpu.tracker.tracker import make_window as jax_make_window
from siammask_tpu.utils.torch_convert import convert_state_dict
from siammask_tpu_torch.config import Config
from siammask_tpu_torch.models.siammask import SiamMaskSharp
from siammask_tpu_torch.tracker import anchors
from siammask_tpu_torch.tracker.runtime import TrackerRuntime
from siammask_tpu_torch.ops.sample import subwindow_crop
from siammask_tpu_torch.tracker.tracker import Tracker, TrackState, make_window

from chip_smoke import calibrate_bn

CONFIG = Path(__file__).resolve().parents[1] / "experiments" / "siammask_sharp" / "config_davis.json"
WIDTH = 8
POS, SZ = (84.0, 58.0), (44.0, 30.0)


# Tier-1 runs the suite in six worker processes at once, and torch's default
# of one intra-op thread per core then oversubscribes the cores: the port's
# parity files, many small steps each, ran several times slower so, and the
# load reached the other files' tests that time two processes against each
# other. Every port parity module takes this fixture (the others import it).

@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One torch thread for the module, the count restored after."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _frames(n=4, h=120, w=160):
    """Noise with a textured rectangle that drifts a few pixels a frame."""
    rng = np.random.RandomState(11)
    frames = rng.randint(0, 256, size=(n, h, w, 3)).astype(np.uint8)
    patch = rng.randint(0, 256, size=(30, 44, 3)).astype(np.uint8)
    for i in range(n):
        y, x = 43 + 2 * i, 62 + 3 * i
        frames[i, y:y + 30, x:x + 44] = patch
    return frames


@pytest.fixture(scope="module")
def trackers():
    """Seeded port weights with BN statistics calibrated on crops of the first
    frame (activations O(1), scores unsaturated), carried into the JAX model
    through the JAX package's own checkpoint importer."""
    p_jax = JaxConfig.load(str(CONFIG)).tracker_config()
    p = Config.load(str(CONFIG)).tracker_config()
    model = SiamMaskSharp(width=WIDTH).init_weights(torch.Generator().manual_seed(0)).eval()
    frame = torch.from_numpy(_frames()[0])
    avg = frame.mean(dim=(0, 1), dtype=torch.float32)
    crops = [subwindow_crop(frame, torch.tensor([POS]), torch.tensor([float(s)]), m, avg[None])
             for s, m in ((64, 127), (128, 255))]
    calibrate_bn(model, *(c.permute(0, 3, 1, 2).contiguous() for c in crops))
    variables = convert_state_dict({k: v.numpy() for k, v in model.state_dict().items()})
    jmodel = JaxSiamMaskSharp(width=WIDTH)
    return (JaxTracker(jmodel, p_jax, latency_lowerings=False), variables,
            Tracker(model, p, "cpu"), model, p)


def test_tracker_config_matches_jax():
    ours = Config.load(str(CONFIG))
    ref = JaxConfig.load(str(CONFIG))
    assert dataclasses.asdict(ours.tracker_config()) == dataclasses.asdict(ref.tracker_config())
    assert ours.tracker_config().score_size == ref.tracker_config().score_size == 25
    assert dataclasses.asdict(ours.anchors) == dataclasses.asdict(ref.anchors)
    assert (ours.arch, ours.hp, ours.lr, ours.loss_weight, ours.loss, ours.clip) == \
        (ref.arch, ref.hp, ref.lr, ref.loss_weight, ref.loss, ref.clip)


@pytest.mark.parametrize("ratios,scales,round_digit", [
    ((0.33, 0.5, 1, 2, 3), (8,), 0),
    ((0.5, 1, 2), (8, 16), 0),
    ((0.33, 0.5, 1, 2, 3), (8,), 2),
])
def test_anchors_and_window_match_jax(ratios, scales, round_digit):
    cfg = anchors.AnchorConfig(ratios=ratios, scales=scales, round_digit=round_digit)
    jcfg = janchors.AnchorConfig(ratios=ratios, scales=scales, round_digit=round_digit)
    np.testing.assert_array_equal(anchors.generate_anchors(cfg), janchors.generate_anchors(jcfg))
    np.testing.assert_array_equal(anchors.generate_score_map_anchors(cfg, 25),
                                  janchors.generate_score_map_anchors(jcfg, 25))
    p = Config.load(str(CONFIG)).tracker_config()
    p_jax = JaxConfig.load(str(CONFIG)).tracker_config()
    np.testing.assert_array_equal(make_window(p), jax_make_window(p_jax))


def _to_port(state) -> TrackState:
    zf = np.asarray(state.zf).transpose(0, 3, 1, 2)
    return TrackState(*(torch.from_numpy(np.array(a)) for a in
                        (state.target_pos, state.target_sz, zf, state.avg_chans, state.score)))


def test_init_matches_jax(trackers):
    jtracker, variables, tracker, _, _ = trackers
    frame = _frames()[0]
    ref = jtracker.init(variables, jnp.asarray(frame), np.asarray(POS, np.float32),
                        np.asarray(SZ, np.float32))
    ours = tracker.init(frame, POS, SZ)
    np.testing.assert_allclose(ours.avg_chans.numpy(), np.asarray(ref.avg_chans), rtol=1e-6)
    zf = np.asarray(ref.zf)
    np.testing.assert_allclose(ours.zf.permute(0, 2, 3, 1).numpy(), zf, rtol=1e-4,
                               atol=1e-4 * np.abs(zf).max())


def test_open_loop_steps_match_jax(trackers):
    jtracker, variables, tracker, _, _ = trackers
    frames = _frames()
    state = jtracker.init(variables, jnp.asarray(frames[0]), np.asarray(POS, np.float32),
                          np.asarray(SZ, np.float32))
    for frame in frames[1:]:
        ours_state, ours = tracker.step(_to_port(state), torch.from_numpy(frame))
        state, ref = jtracker.step(variables, state, jnp.asarray(frame))
        assert int(ours.best_id) == int(ref.best_id)
        np.testing.assert_allclose(ours.target_pos.numpy(), np.asarray(ref.target_pos), atol=1e-3)
        np.testing.assert_allclose(ours.target_sz.numpy(), np.asarray(ref.target_sz), atol=1e-3)
        np.testing.assert_allclose(ours.score.numpy(), np.asarray(ref.score), atol=1e-5)
        np.testing.assert_allclose(ours.mask_logits.numpy(), np.asarray(ref.mask_logits),
                                   atol=1e-5)
        assert ours.mask_in_frame.shape == frame.shape[:2]
        np.testing.assert_allclose(ours.mask_in_frame.numpy(), np.asarray(ref.mask_in_frame),
                                   atol=1e-4)
        np.testing.assert_array_equal(ours_state.target_pos.numpy(), ours.target_pos.numpy())


@pytest.mark.parametrize("soft_mask", [True, False])
def test_runtime_track_result_keys(trackers, soft_mask):
    _, _, _, model, p = trackers
    frames = _frames(2)
    runtime = TrackerRuntime(model, p, "cpu")
    runtime.init(frames[0], POS, SZ)
    result = runtime.track(frames[1], soft_mask=soft_mask)
    mask_key = "mask" if soft_mask else "mask_bin"
    assert set(result) == {"target_pos", "target_sz", "score", mask_key, "polygon"}
    assert result["target_pos"].shape == result["target_sz"].shape == (2,)
    assert isinstance(result["score"], float)
    assert result[mask_key].shape == frames.shape[1:3]
    assert result["polygon"].shape == (4, 2)
    assert np.all(result["target_sz"] >= 10)
