"""SAM 2.1 in the port against the plain reference (``perfbench/reference/
sam2.py``), in float64 on the CPU at a small size (Hiera at width 16,
stages (1, 2, 2, 1), windows (4, 2, 4, 2) with a global block, a 128x128
image, memory attention at d 32): the encoder's maps, the conditioning
frame's decoder, memory attention and the memory encoder one by one, then a
24-frame, 3-object track frame by frame (past the 6-slot ring and the 16
pointer slots). Also: the published widths' parameter count, the memory-key
counter, and the VOS driver and test CLI running the model through the
tracker that ``TrackerRuntime`` builds for its family. On a card (``cuda``):
the small model in bf16 through its attention kernels against the float32
reference."""
import dataclasses
import json

import numpy as np
import pytest
import torch

from perfbench.reference import sam2 as R
from siammask_tpu_torch.config import TrackerConfig
from siammask_tpu_torch.models.sam2 import Sam2, Sam2Config
from siammask_tpu_torch.tracker.runtime import TrackerRuntime
from siammask_tpu_torch.tracker.sam2 import Sam2Tracker
from siammask_tpu_torch.utils import trace


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One torch thread for the module (tier-1 runs six workers), restored
    after. This file imports no JAX, so that its card test runs on the card's
    machine."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)

SMALL = Sam2Config(embed_dim=16, num_heads=1, stages=(1, 2, 2, 1), window_spec=(4, 2, 4, 2),
                   global_att_blocks=(4,), pos_embed_size=(7, 7), d_model=32, mem_dim=8,
                   image_size=128, memattn_ffn=64, decoder_mlp=64)
CFG = dataclasses.asdict(SMALL)
HW = (60, 100)
TOL = 1e-9


def _weights(seed=3):
    p = R.init_weights(CFG, torch.Generator().manual_seed(seed), "cpu", torch.float64)
    # blob-like masks: mask 0 positive inside the frame, masks 1-3 mixed
    md = "sam_mask_decoder.output_hypernetworks_mlps"
    p[f"{md}.0.layers.2.bias"] += 0.5
    p["sam_mask_decoder.pred_obj_score_head.layers.2.bias"] += 0.3
    return p


def _model(p):
    model = Sam2(SMALL).double()
    model.load_state_dict(p)
    return model.eval()


def _video(n, seed=0):
    """(n, H, W, 3) uint8 frames: noise with three moving squares."""
    r = np.random.RandomState(seed)
    frames = r.randint(0, 60, (n, *HW, 3)).astype(np.uint8)
    for i in range(n):
        for k, (y, x) in enumerate(((10, 10), (30, 50), (15, 70))):
            y0, x0 = y + (i % 5), x + (2 * i) % 9
            frames[i, y0:y0 + 15, x0:x0 + 18] = (80 * k + 60, 200 - 50 * k, 120)
    return frames


BOXES = np.array([[19.0, 17.5], [59.0, 37.5], [79.0, 22.5]], np.float32), \
    np.array([[18.0, 15.0], [18.0, 15.0], [18.0, 15.0]], np.float32)


@pytest.fixture(scope="module")
def setup():
    p = _weights()
    return p, _model(p), R.Sam2Ref(p, CFG)


def _close(a, b, what, tol=TOL):
    a, b = torch.as_tensor(a).double(), torch.as_tensor(b).double()
    err = (a - b).abs().max().item()
    assert err <= tol * max(1.0, b.abs().max().item()), f"{what}: {err}"


def test_spec_is_the_programs_state_dict():
    with torch.device("meta"):
        theirs = {k: tuple(v.shape) for k, v in Sam2(SMALL).state_dict().items()}
        published = {k: tuple(v.shape) for k, v in Sam2().state_dict().items()}
    assert R.shapes(CFG) == theirs
    assert R.shapes({}) == published


def test_published_parameter_count():
    """80,850,178 parameters: the published table's 80.8 M (SAM 2) and the
    two tensors SAM 2.1 adds (``obj_ptr_tpos_proj``, ``no_obj_embed_spatial``)."""
    with torch.device("meta"):
        model = Sam2()
    total = sum(p.numel() for p in model.parameters())
    added = sum(p.numel() for p in model.obj_ptr_tpos_proj.parameters()) \
        + model.no_obj_embed_spatial.numel()
    assert total == 80_850_178
    assert round((total - added) / 1e6, 1) == 80.8 and round(total / 1e6, 1) == 80.9


def test_encoder_matches(setup):
    p, model, ref = setup
    frame = torch.from_numpy(_video(1)[0])
    with torch.no_grad():
        ours = model.encode_image(model.preprocess(frame))
        theirs = ref.image(frame)
    for k in ("feat", "s0", "s1"):
        _close(ours[k], theirs[k], k)


@pytest.mark.parametrize("sharp", [False, True])
def test_first_frame_matches(setup, sharp):
    """The conditioning frame's decoder, mask choice, memory and pointer;
    ``sharp``: mask 0's logits x100, far from 0, so the stability rule keeps
    it (unscaled, it takes the best of masks 1-3)."""
    p, model, ref = setup
    if sharp:
        md = "sam_mask_decoder.output_hypernetworks_mlps.0.layers.2"
        p = {**p, f"{md}.weight": 100 * p[f"{md}.weight"], f"{md}.bias": 100 * p[f"{md}.bias"]}
        model, ref = _model(p), R.Sam2Ref(p, CFG)
    frame = _video(1)[0]
    tracker = Sam2Tracker(model, TrackerConfig(), "cpu")
    before = trace.counters().get("sam2.multimask_switch", 0)
    state = tracker.init_batched(frame, *BOXES)
    maps = ref.image(torch.from_numpy(frame))
    outs = [ref.frame(maps, HW, box=(cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2))
            for (cx, cy), (w, h) in zip(*BOXES)]
    got = tracker.init_output
    for i, o in enumerate(outs):
        assert int(got.best[i]) == o["choice"]
        _close(got.iou[i], o["iou"], "iou")
        _close(got.object_score[i], o["score"], "score")
        _close(got.mask_in_frame[i], o["mask"], "mask")
        _close(state.cond_mem[i], o["mem"], "memory")
        _close(state.ptrs[i, 0], o["ptr"], "pointer")
        assert o["switched"] is not sharp
    assert trace.counters()["sam2.multimask_switch"] - before == (0 if sharp else 3)


def test_memory_attention_and_encoder_match(setup):
    p, model, ref = setup
    g = torch.Generator().manual_seed(5)
    s, d, m = SMALL.feat_side, SMALL.d_model, SMALL.mem_dim
    feat = torch.randn(1, d, s, s, generator=g, dtype=torch.float64)
    memory = torch.randn(2, 7 * s * s + 16 * d // m, m, generator=g, dtype=torch.float64)
    pos = torch.randn(memory.shape, generator=g, dtype=torch.float64)
    with torch.no_grad():
        ours = model.condition(feat, memory, pos, 16 * d // m)
        for i in range(2):
            theirs = ref.memory_attention(feat[0].flatten(1).t(), memory[i], pos[i], 16 * d // m)
            _close(ours[i].flatten(1).t(), theirs, "memory attention")
        mask = 20 * torch.rand(2, 1, 128, 128, generator=g, dtype=torch.float64) - 10
        ours = model.encode_memory(feat, mask, torch.tensor([True, False]))
        for i in range(2):
            theirs = ref.memory_encoder(feat, mask[i, 0])
            if i == 1:
                theirs = theirs + p["no_obj_embed_spatial"][0]
            _close(ours[i], theirs, "memory encoder")


def _bank(state, t, i):
    """Object i's bank in the program's state, as the reference holds one."""
    frames = {0: (state.cond_mem[i], state.ptrs[i, 0])}
    mems = {int(f): state.ring_mem[i, s] for s, f in enumerate(state.mem_frame[i]) if f >= 1}
    ptrs = {int(f): state.ptrs[i, s] for s, f in enumerate(state.ptr_frame[i]) if f >= 1}
    for f in set(mems) | set(ptrs):
        frames[f] = (mems.get(f), ptrs.get(f))
    return frames


def test_track_matches_frame_by_frame(setup):
    """24 frames, 3 objects: the ring wraps past 6 slots and the pointers
    past 16; masks, IoUs, the choice, scores, the bank and the pointers."""
    p, model, ref = setup
    video = _video(24)
    tracker = Sam2Tracker(model, TrackerConfig(), "cpu")
    state = tracker.init_batched(video[0], *BOXES)
    theirs = R.Tracker(ref)
    theirs.init(torch.from_numpy(video[0]), *BOXES)
    for t in range(1, 24):
        state, out = tracker.step_batched(state, video[t])
        outs = theirs.step(torch.from_numpy(video[t]))
        for i, o in enumerate(outs):
            assert int(out.best[i]) == o["choice"], t
            _close(out.iou[i], o["iou"], f"iou {t}")
            _close(out.object_score[i], o["score"], f"score {t}")
            _close(out.mask_in_frame[i], o["mask"], f"mask {t}")
            ours = _bank(state, t + 1, i)
            want = theirs.banks[i]
            assert set(ours) == {f for f in want if f == 0 or t + 1 - f <= 15}, t
            for f, (mem, ptr) in ours.items():
                if mem is not None:
                    assert t + 1 - f <= 6 or f == 0
                    _close(mem, want[f][0], f"memory of frame {f} at {t}")
                _close(ptr, want[f][1], f"pointer of frame {f} at {t}")
        assert state.t.tolist() == [t + 1.0] * 3


def test_memory_keys_counter(setup):
    """Once the bank is full each object-frame attends 7 frames of memory
    and 16 pointers of d / mem_dim tokens: 28,736 keys at the published
    widths."""
    p, model, ref = setup
    video = _video(18)
    tracker = Sam2Tracker(model, TrackerConfig(), "cpu")
    state = tracker.init_batched(video[0], *BOXES)
    state, _ = tracker.track_video_multi(state, video[1:17])
    before = trace.counters().get("sam2.memory_keys", 0)
    tracker.step_batched(state, video[17])
    per = (trace.counters()["sam2.memory_keys"] - before) / 3
    s, k = SMALL.feat_side, SMALL.d_model // SMALL.mem_dim
    assert per == 7 * s * s + 16 * k
    pub = Sam2Config()
    assert 7 * pub.feat_side ** 2 + 16 * pub.d_model // pub.mem_dim == 28_736


def _write_davis(root, n=6, late=False):
    """A DAVIS-layout video of three objects (or, ``late``, a YouTube-VOS
    one whose third object starts on frame 2)."""
    from PIL import Image

    video = _video(n)
    jpg, ann = root / "JPEGImages" / "480p" / "synth", root / "Annotations" / "480p" / "synth"
    jpg.mkdir(parents=True)
    ann.mkdir(parents=True)
    for i, im in enumerate(video):
        Image.fromarray(im[..., ::-1]).save(jpg / f"{i:05d}.jpg", quality=95)
        label = np.zeros(HW, np.uint8)
        for k, ((cx, cy), (w, h)) in enumerate(zip(*BOXES)):
            label[int(cy - h / 2):int(cy + h / 2), int(cx - w / 2):int(cx + w / 2)] = k + 1
        Image.fromarray(label).save(ann / f"{i:05d}.png")
    (root / "ImageSets" / "2017").mkdir(parents=True)
    (root / "ImageSets" / "2017" / "val.txt").write_text("synth\n")


def test_vos_driver_and_test_cli_run_sam2(tmp_path, setup):
    """``track_vos_batched`` through ``TrackerRuntime`` (the tracker of the
    model's family), then the test CLI on an experiment config of the small
    model; a video with a late-starting object is refused."""
    from siammask_tpu_torch.eval.datasets import load_dataset
    from siammask_tpu_torch.tools import test as test_cli
    from siammask_tpu_torch.tracker.vos import track_vos_batched

    p, model, ref = setup
    _write_davis(tmp_path / "DAVIS")
    runtime = TrackerRuntime(model, TrackerConfig(seg_thr=0.5), "cpu")
    assert isinstance(runtime.tracker, Sam2Tracker)
    video = load_dataset("DAVIS2017", str(tmp_path))["synth"]
    iou, fps = track_vos_batched(runtime, video, log=lambda *_: None, scan_chunk=2)
    assert np.asarray(iou).shape == (3, 4) and fps > 0
    late = dict(video, start_frame={"1": 0, "2": 0, "3": 2}, end_frame={"1": 5, "2": 5, "3": 5})
    with pytest.raises(NotImplementedError, match="frame 0 only"):
        track_vos_batched(runtime, late, log=lambda *_: None, scan_chunk=2)

    config = tmp_path / "config.json"
    sizes = {k: list(v) if isinstance(v, tuple) else v for k, v in CFG.items()}
    config.write_text(json.dumps({"network": {"arch": "SAM2", "sam2": sizes},
                                  "hp": {"seg_thr": 0.5}}))
    totals = test_cli.main(["--config", str(config), "--dataset", "DAVIS2017", "--data-dir",
                            str(tmp_path), "--device", "cpu", "--result-dir",
                            str(tmp_path / "out"), "--scan-chunk", "2"])
    assert totals["videos"] == 1 and 0.0 <= totals["iou"] <= 1.0


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is false)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_bf16_track_on_card_near_the_reference(cuda_device):
    """The small model in bf16 autocast on the card (FlashAttention-2 at
    head widths 16-32, cuDNN where the width is 256: none at this size)
    over 20 frames, against the float32 reference on the card's program
    state each frame, at the mask the program took: masks within 0.02 mean
    absolute difference, and that mask the reference's best where its IoUs
    are 0.01 apart."""
    from perfbench.reference.model import fp32_exact

    p = {k: v.float().to(cuda_device) for k, v in _weights().items()}
    model = Sam2(SMALL, torch.bfloat16).to(cuda_device)
    model.load_state_dict(p)
    tracker = Sam2Tracker(model.eval(), TrackerConfig(), cuda_device)
    video = torch.from_numpy(_video(20)).to(cuda_device)
    state = tracker.init_batched(video[0], *BOXES)
    ref = R.Sam2Ref(p, CFG)
    with fp32_exact():
        for t in range(1, 20):
            bank = [_bank(state, t, i) for i in range(3)]
            bank = [{f: tuple(None if x is None else x.float().clone() for x in v)
                     for f, v in b.items()} for b in bank]
            state, out = tracker.step_batched(state, video[t])
            maps = ref.image(video[t])
            for i in range(3):
                o = ref.frame(maps, HW, bank=R.select(t, bank[i], CFG), choice=int(out.best[i]))
                assert (out.mask_in_frame[i] - o["mask"]).abs().mean() < 0.02, t
                iou = o["iou"][1:].sort(descending=True).values
                if iou[0] - iou[1] > 0.01:
                    assert o["iou"][int(out.best[i])] == iou[0], t


@pytest.mark.cuda
def test_graph_replay_is_the_eager_loop_on_card(cuda_device):
    """From frame 16 on (a full bank) ``track_video_multi`` replays one CUDA
    graph a frame: the same bits as the eager ``step_batched`` loop from the
    same state, the bank and the counters included."""
    p = {k: v.float().to(cuda_device) for k, v in _weights().items()}
    model = Sam2(SMALL, torch.bfloat16).to(cuda_device)
    model.load_state_dict(p)
    video = torch.from_numpy(_video(26)).to(cuda_device)
    runs = []
    for graphed in (True, False):
        tracker = Sam2Tracker(model.eval(), TrackerConfig(), cuda_device)
        state = tracker.init_batched(video[0], *BOXES)
        before = trace.counters().get("sam2.memory_keys", 0)
        if graphed:
            state, outs = tracker.track_video_multi(state, video[1:])
            assert len(tracker.graphs) == 1
        else:
            loop = []
            for frame in video[1:]:
                state, out = tracker.step_batched(state, frame)
                loop.append(out)
            outs = type(loop[0])(*(torch.stack(v) for v in zip(*loop)))
        runs.append((state, outs, trace.counters()["sam2.memory_keys"] - before))
    (s1, o1, k1), (s2, o2, k2) = runs
    for name, a, b in zip(o1._fields, o1, o2):
        assert torch.equal(a, b), name
    assert all(torch.equal(a, b) for a, b in zip(s1, s2))
    assert k1 == k2
