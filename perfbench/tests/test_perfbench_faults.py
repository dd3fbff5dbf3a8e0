"""The check fails what it should: a whole run of each cell at a size a test
run holds (``cells.TINY``: width 8, the program in float32, on the CPU,
the card's look skipped), sound, then with the timed path broken
underneath (a step that returns its state unchanged; half of the batch left
out; an answer altered where it is produced), then with the control, the
plain reference at fp8, in the program's place. The limits are the cells'
own, set from the card's readings (PERF.md)."""
import pytest
import torch

from perfbench import harness
from perfbench.tests.cells import TINY

SEED = 2 ** 31 + 3


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def run(name, **kwargs):
    return harness.run_cell(name, SEED, 0.3, False, device="cpu", require_card=False,
                            overrides=TINY[name], **kwargs)


ONE_CARD = sorted(n for n in TINY if n != "base_train_dp4")


@pytest.mark.parametrize("name", ONE_CARD)
def test_sound_run_is_correct(name):
    out = run(name)
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0


@pytest.mark.parametrize("name", ONE_CARD)
def test_control_is_not_correct(name):
    out = run(name, system="control")
    assert not out["correct"], out["checks"]


def _tracker():
    from siammask_tpu_torch.tracker.tracker import Tracker
    return Tracker


def _stale_step(monkeypatch):
    """``Tracker.step`` returns the state it was given."""
    tracker = _tracker()
    step = tracker.step

    def stale(self, state, frame):
        return state, step(self, state, frame)[1]

    monkeypatch.setattr(tracker, "step", stale)


def _shifted_box(monkeypatch):
    """The runtime reports each box 3 px to the right."""
    from siammask_tpu_torch.tracker.runtime import TrackerRuntime
    track = TrackerRuntime.track

    def shifted(self, im, soft_mask=True):
        out = track(self, im, soft_mask)
        out["target_pos"] = out["target_pos"] + [3.0, 0.0]
        return out

    monkeypatch.setattr(TrackerRuntime, "track", shifted)


def _cut_mask(monkeypatch):
    """The runtime's binary mask loses every other row."""
    from siammask_tpu_torch.tracker.runtime import TrackerRuntime
    track = TrackerRuntime.track

    def cut(self, im, soft_mask=True):
        out = track(self, im, soft_mask)
        out["mask_bin"] = out["mask_bin"].copy()
        out["mask_bin"][::2] = 0
        return out

    monkeypatch.setattr(TrackerRuntime, "track", cut)


@pytest.mark.parametrize("fault", [_stale_step, _shifted_box, _cut_mask])
def test_vot_faults_are_not_correct(monkeypatch, fault):
    fault(monkeypatch)
    out = run("sharp_vot_1obj")
    assert not out["correct"], out["checks"]


def _stale_video(monkeypatch):
    """``track_video_multi`` returns the states it was given."""
    tracker = _tracker()
    video = tracker.track_video_multi

    def stale(self, states, frames):
        return states, video(self, states, frames)[1]

    monkeypatch.setattr(tracker, "track_video_multi", stale)


def _half_objects(monkeypatch):
    """Half of the objects' masks are left out (the border value)."""
    tracker = _tracker()
    video = tracker.track_video_multi

    def half(self, states, frames):
        states, outs = video(self, states, frames)
        mask = outs.mask_in_frame.clone()
        mask[:, mask.shape[1] // 2:] = -1.0
        return states, outs._replace(mask_in_frame=mask)

    monkeypatch.setattr(tracker, "track_video_multi", half)


def _brighter_mask(monkeypatch):
    """Every soft mask is altered where it is produced."""
    tracker = _tracker()
    video = tracker.track_video_multi

    def altered(self, states, frames):
        states, outs = video(self, states, frames)
        return states, outs._replace(mask_in_frame=outs.mask_in_frame + 0.25)

    monkeypatch.setattr(tracker, "track_video_multi", altered)


@pytest.mark.parametrize("fault", [_stale_video, _half_objects, _brighter_mask])
def test_vos_faults_are_not_correct(monkeypatch, fault):
    fault(monkeypatch)
    out = run("sharp_vos_16obj")
    assert not out["correct"], out["checks"]


def _no_update(monkeypatch):
    """The optimizer's step leaves the parameters as they were."""
    monkeypatch.setattr(torch.optim.SGD, "step", lambda self, closure=None: None)


def _half_batch(monkeypatch):
    """Each step takes the first half of its batch, the mean over it."""
    from siammask_tpu_torch.train.trainer import Trainer
    step = Trainer.step

    def half(self, batch, epoch):
        rows = batch["template"].shape[0] // 2
        return step(self, {k: v[:rows] for k, v in batch.items()}, epoch)

    monkeypatch.setattr(Trainer, "step", half)


def _loss_altered(monkeypatch):
    """The reported losses are altered where they are produced."""
    from siammask_tpu_torch.train import trainer
    train_step = trainer.train_step

    def altered(*args, **kwargs):
        m = train_step(*args, **kwargs)
        return {**m, "mask_loss": m["mask_loss"] * 1.5}

    monkeypatch.setattr(trainer, "train_step", altered)


@pytest.mark.parametrize("fault", [_no_update, _half_batch, _loss_altered])
def test_train_faults_are_not_correct(monkeypatch, fault):
    fault(monkeypatch)
    out = run("base_train_b64")
    assert not out["correct"], out["checks"]


def test_four_ranks_without_the_exchange_are_not_correct():
    """Four gloo ranks: sound, then with the trainer's exchanges left out."""
    assert run("base_train_dp4")["correct"]
    out = run("base_train_dp4", system="no_exchange")
    assert not out["correct"], out["checks"]
    assert out["checks"]["cross_rank"]["value"] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(TINY))
def test_cell_on_the_card(name):
    """One short run of each cell at its own size on its cards."""
    chips = 4 if name == "base_train_dp4" else 1
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        pytest.skip(f"needs {chips} NVIDIA card(s)")
    out = harness.run_cell(name, SEED, 2.0, False)
    assert out["correct"], out["checks"]
