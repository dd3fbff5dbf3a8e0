"""The CUDA-graph video paths on the card: ``track_video`` and
``track_video_multi`` replay a captured step and must give the bits of the
eager step loop, for each model family (the box-only step's graph holds
no mask outputs), and the tracker keeps only its most recently used graphs.
Marked ``cuda``; they skip without a card. The file imports
only the port, not the JAX package, so it runs where PyTorch alone is
installed: ``python -m pytest tests/test_torch_graph.py -m cuda -q``."""
from pathlib import Path

import numpy as np
import pytest
import torch

from siammask_tpu_torch.config import Config
from siammask_tpu_torch.models.siammask import SiamMaskBase, SiamMaskSharp, SiamRPN
from siammask_tpu_torch.tracker.tracker import MAX_GRAPHS, Tracker

EXPERIMENTS = Path(__file__).resolve().parents[1] / "experiments"
CONFIG = EXPERIMENTS / "siammask_sharp" / "config_davis.json"
# family -> (model class, config, Tracker's mask and refine, xcorr launches a step)
FAMILIES = {"sharp": (SiamMaskSharp, CONFIG, True, True, 3),
            "base": (SiamMaskBase, EXPERIMENTS / "siammask_base" / "config.json", True, False, 3),
            # sharp without its Refine: the 63x63 head on the gathered corr vector
            "sharp-raw": (SiamMaskSharp, EXPERIMENTS / "siammask_base" / "config.json", True,
                          False, 3),
            "rpn": (SiamRPN, EXPERIMENTS / "siamrpn_resnet" / "config.json", False, False, 2)}
WIDTH = 8
# three streams; the second starts across the left border of the frame
POS = np.array([(84.0, 58.0), (12.0, 96.0), (130.0, 34.0)], np.float32)
SZ = np.array([(44.0, 30.0), (36.0, 40.0), (50.0, 24.0)], np.float32)


def _frames(n, h=120, w=160):
    rng = np.random.RandomState(11)
    return rng.randint(0, 256, size=(n, h, w, 3)).astype(np.uint8)


def _stacked(outs):
    return type(outs[0])(*(torch.stack(v) for v in zip(*outs)))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is false)")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _tracker(device, family: str = "sharp") -> Tracker:
    cls, config, mask, refine, _ = FAMILIES[family]
    p = Config.load(str(config)).tracker_config()
    model = cls(width=WIDTH).init_weights(torch.Generator().manual_seed(0))
    return Tracker(model.to(device).eval(), p, device, mask=mask, refine=refine)


@pytest.mark.cuda
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_graph_track_video_matches_eager_on_card(cuda_device, family):
    """The CUDA-graph replay of ``track_video`` / ``track_video_multi`` gives
    the bits of the eager step loop from the same state: the same kernels in
    the same order."""
    tracker = _tracker(cuda_device, family)
    frames = torch.from_numpy(_frames(6)).to(cuda_device)
    for states, run, step in (
            (tracker.init(frames[0], POS[0], SZ[0]), tracker.track_video, tracker.step),
            (tracker.init_batched(frames[0], POS, SZ), tracker.track_video_multi,
             tracker.step_batched)):
        final, outs = run(states, frames[1:])
        again_final, again = run(states, frames[1:])     # the cached graph
        st, loop = states, []
        for frame in frames[1:]:
            st, out = step(st, frame)
            loop.append(out)
        assert type(outs) is type(loop[0])
        for name, a, b, c in zip(outs._fields, outs, again, _stacked(loop)):
            assert torch.equal(a, c) and torch.equal(b, c), name
        assert all(torch.equal(a, b) for a, b in zip(final, st))
        assert all(torch.equal(a, b) for a, b in zip(again_final, st))
    assert sorted(k[0] for k in tracker.graphs) == [1, 3]
    per_step = FAMILIES[family][4]
    assert all(g.xcorr_launches == per_step for g in tracker.graphs.values())


@pytest.mark.cuda
def test_graph_cache_drops_the_least_recently_used(cuda_device):
    """Videos of four frame sizes (one pixel count) through one tracker: only
    the ``MAX_GRAPHS`` most recently used graphs are kept, and a dropped
    graph's private pool goes back to the device, so the memory reserved
    after four keys is what it was after two."""
    tracker = _tracker(cuda_device)
    sizes = ((120, 160), (160, 120), (96, 200), (200, 96))
    videos = [torch.from_numpy(_frames(3, h, w)).to(cuda_device) for h, w in sizes]
    states = [tracker.init_batched(v[0], POS, SZ) for v in videos]
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_reserved()
    reserved = []
    for frames, state in zip(videos, states):
        tracker.track_video_multi(state, frames[1:])
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        reserved.append(torch.cuda.memory_reserved())
    assert MAX_GRAPHS == 2
    assert list(tracker.graphs) == [(3, 96, 200, torch.uint8), (3, 200, 96, torch.uint8)]
    # a graph's pool: half of what two of them added to the base
    pool = (reserved[1] - base) / 2
    assert pool > 0
    assert reserved[3] - reserved[1] < pool / 2, (base, reserved)
    # a kept graph is replayed, not captured again, and becomes the most recent
    kept = tracker.graphs[(3, 96, 200, torch.uint8)]
    tracker.track_video_multi(states[2], videos[2][1:])
    assert tracker.graphs[(3, 96, 200, torch.uint8)] is kept
    assert list(tracker.graphs)[-1] == (3, 96, 200, torch.uint8)


@pytest.mark.cuda
def test_graph_path_spans_and_counts_on_card(cuda_device):
    """Under a profiler, each ``track_video_multi`` call's span holds a
    ``step_graph.capture`` at a key's first call (its own work unrecorded)
    and a ``step_graph.run`` with a ``step_graph.replay`` a frame; three
    keys through ``MAX_GRAPHS`` = 2 count three captures and one eviction."""
    from torch.profiler import ProfilerActivity, profile

    from siammask_tpu_torch.utils import trace

    tracker = _tracker(cuda_device)
    videos = [torch.from_numpy(_frames(3, h, w)).to(cuda_device)
              for h, w in ((120, 160), (160, 120), (96, 200))]
    states = [tracker.init_batched(v[0], POS, SZ) for v in videos]
    before = trace.counters()
    trace.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        for frames, state in zip(videos + videos[-1:], states + states[-1:]):
            tracker.track_video_multi(state, frames[1:])
        torch.cuda.synchronize()
    log = trace.records()
    trace.clear()
    roots = [r for r in log if r["parent"] is None]
    # the request: the video frame a chunk starts at, counted since the
    # tracker's last init (here of the third video)
    assert [(r["name"], r["request"]) for r in roots] == \
        [("tracker.track_video_multi", f) for f in (1, 3, 5, 7)]
    captures = []
    for i, r in enumerate(roots):
        kids = [c for c in log if c["parent"] == r["id"]]
        assert [c["name"] for c in kids] == \
            ["step_graph.capture"] * (i < 3) + ["step_graph.run"]
        captures += kids[:-1]
        assert [c["name"] for c in log if c["parent"] == kids[-1]["id"]] == \
            ["step_graph.replay"] * 2
    assert not [c for c in log if c["parent"] in {k["id"] for k in captures}]
    assert [c["counts"] for c in captures] == [
        {"step_graph.captures": 1}, {"step_graph.captures": 1},
        {"step_graph.captures": 1, "step_graph.evictions": 1}]
    after = trace.counters()
    for name, n in (("step_graph.captures", 3), ("step_graph.evictions", 1)):
        assert after[name] - before.get(name, 0) == n
