"""TransT in the port against the plain reference (``perfbench/reference/
transt.py``), in float64 on the CPU at a small size (the backbone at width
8, d 32 with 2 heads, FFN 64, four fusion layers, 64 / 128 crops): the
torchvision-padded backbone, one fusion layer, the decoder and heads, a
batched step of 3 objects, and a 5-frame closed loop taken a step at a time
against the reference's step at the program's state. Also: the
``state_dict`` names, the published parameter count, the
``transt.attn_calls`` counter, and the family's dispatch in
``TrackerRuntime``, ``build_model`` and the test CLI. On a card (``cuda``):
the small model in bf16 near the float32 reference, and the graph replay
bit for bit the eager loop. The file imports no JAX, so that its card tests
run on the card's machine."""
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from perfbench.reference import transt as R
from siammask_tpu_torch.config import TrackerConfig
from siammask_tpu_torch.models.resnet import ResNet50Stride8
from siammask_tpu_torch.models.siammask import build_model
from siammask_tpu_torch.models.transt import TransT, TransTConfig
from siammask_tpu_torch.tracker.runtime import TrackerRuntime
from siammask_tpu_torch.tracker.transt import TransTTracker
from siammask_tpu_torch.utils import trace


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One torch thread for the module (tier-1 runs six workers), restored
    after."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


SMALL = TransTConfig(width=8, d_model=32, heads=2, ffn=64, template_size=64, search_size=128)
CFG = {k: getattr(SMALL, k) for k in R.DEFAULTS}
HP = TrackerConfig().update(R.TRACKER)
HW = (120, 200)
POS = np.array([[60.0, 50.0], [130.0, 70.0], [30.0, 100.0]], np.float32)
SZ = np.array([[30.0, 24.0], [22.0, 36.0], [26.0, 26.0]], np.float32)
TOL = 1e-9
EXPERIMENT = Path(__file__).resolve().parents[1] / "experiments" / "transt_n4" / "config.json"


def _weights(seed=3, dtype=torch.float64):
    """Seeded weights with BatchNorm statistics away from the identity, the
    classifier sharpened and the box head damped (as the benchmark's)."""
    g = torch.Generator().manual_seed(seed)
    p = R.init_weights(CFG, g, "cpu", dtype)
    for k, v in p.items():
        if k.endswith("running_var"):
            v.uniform_(0.5, 2.0, generator=g)
        elif k.endswith("running_mean"):
            v.uniform_(-0.2, 0.2, generator=g)
    p["class_embed.layers.2.weight"].mul_(8.0)
    p["bbox_embed.layers.2.weight"].mul_(0.5)
    p["bbox_embed.layers.2.bias"].copy_(torch.tensor([0.0, 0.0, np.log(1 / 3), np.log(1 / 3)]))
    return p


def _model(p, dtype=None):
    model = TransT(SMALL, dtype)
    if dtype is None:
        model = model.double()
    model.load_state_dict(p)
    return model.eval()


def _video(n, seed=0):
    """(n, H, W, 3) uint8 frames: noise with three moving blocks."""
    r = np.random.RandomState(seed)
    frames = r.randint(0, 80, (n, *HW, 3)).astype(np.uint8)
    for i in range(n):
        for k, ((x, y), (w, h)) in enumerate(zip(POS, SZ)):
            x0, y0 = int(x - w / 2) + (i % 4), int(y - h / 2) + (2 * i) % 5
            frames[i, y0:y0 + int(h), x0:x0 + int(w)] = (70 * k + 60, 200 - 50 * k, 150)
    return frames


@pytest.fixture(scope="module")
def setup():
    p = _weights()
    return p, _model(p), R.TransTRef(p, CFG)


def _close(a, b, what, tol=TOL):
    a, b = torch.as_tensor(a).double(), torch.as_tensor(b).double()
    err = (a - b).abs().max().item()
    assert err <= tol * max(1.0, b.abs().max().item()), f"{what}: {err}"


def test_spec_is_the_programs_state_dict():
    with torch.device("meta"):
        theirs = {k: tuple(v.shape) for k, v in TransT(SMALL).state_dict().items()}
        published = {k: tuple(v.shape) for k, v in TransT().state_dict().items()}
    assert list(R.spec(CFG).items()) == list(theirs.items())
    assert R.spec({}) == published
    assert "backbone.0.body.layer3.5.conv2.weight" in published
    assert published["featurefusion_network.encoder.layers.3.self_attn1.in_proj_weight"] == \
        (768, 256)
    assert published["class_embed.layers.2.weight"] == (2, 256)


def test_published_parameter_count():
    """23,016,006 parameters from the shapes (the 23.0 M that comparisons
    of trackers cite for TransT-N4): the backbone through layer3 8,543,296,
    the projection 262,400, four fusion layers of 3,157,504, the decoder
    1,315,584 with its norm, the two heads 264,710."""
    with torch.device("meta"):
        model = TransT()
    count = {name: sum(p.numel() for p in getattr(model, name).parameters())
             for name in ("backbone", "input_proj", "featurefusion_network", "class_embed",
                          "bbox_embed")}
    fusion = model.featurefusion_network
    assert count["backbone"] == 8_543_296 and count["input_proj"] == 262_400
    assert sum(p.numel() for p in fusion.encoder.layers[0].parameters()) == 3_157_504
    assert sum(p.numel() for p in fusion.decoder.parameters()) == 1_315_584
    assert count["class_embed"] + count["bbox_embed"] == 264_710
    from_spec = sum(int(np.prod(s)) for k, s in R.spec({}).items()
                    if not k.endswith(("running_mean", "running_var", "num_batches_tracked")))
    assert sum(count.values()) == 23_016_006 == from_spec
    assert round(from_spec / 1e6, 1) == 23.0


def test_backbone_matches(setup):
    """The torchvision-padded backbone: 128 -> 16 and 256 -> 32 at stride 8
    (the SiamMask backbone's pad-0 stem gives 31 at 255), and its layer3
    map against the reference's."""
    p, model, ref = setup
    with torch.device("meta"):
        body = ResNet50Stride8()
        assert body(torch.empty(1, 3, 256, 256)).shape == (1, 1024, 32, 32)
        assert body(torch.empty(1, 3, 128, 128)).shape == (1, 1024, 16, 16)
    x = torch.randn(2, 3, 128, 128, dtype=torch.float64, generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        ours = model.backbone[0].body(x)
    _close(ours, ref.backbone(x), "layer3")
    assert ours.shape == (2, 128, 16, 16)


def test_fusion_layer_matches(setup):
    p, model, ref = setup
    g = torch.Generator().manual_seed(4)
    t = torch.randn(2, 64, 32, dtype=torch.float64, generator=g)
    s = torch.randn(2, 256, 32, dtype=torch.float64, generator=g)
    c = model.consts("cpu")
    _close(c["pos_t"], ref.positions(8), "template positions", 1e-12)
    _close(c["pos_s"], ref.positions(16), "search positions", 1e-12)
    with torch.no_grad():
        ours = model.featurefusion_network.encoder.layers[1](t, s, c["pos_t"], c["pos_s"])
    theirs = ref.fusion_layer(1, t, s, ref.positions(8), ref.positions(16))
    _close(ours[0], theirs[0], "template stream")
    _close(ours[1], theirs[1], "search stream")


def test_decoder_and_heads_match(setup):
    p, model, ref = setup
    g = torch.Generator().manual_seed(5)
    t = torch.randn(3, 64, 32, dtype=torch.float64, generator=g)
    s = torch.randn(3, 256, 32, dtype=torch.float64, generator=g)
    c = model.consts("cpu")
    fusion = model.featurefusion_network
    with torch.no_grad():
        hs = fusion.decoder.norm(fusion.decoder.layers[0](s, t, c["pos_s"], c["pos_t"]))
        logits, boxes = model.class_embed(hs), torch.sigmoid(model.bbox_embed(hs))
    theirs = ref.decoder(s, t, ref.positions(16), ref.positions(8))
    _close(hs, theirs, "decoded tokens")
    for ours, want, what in zip((logits, boxes), ref.heads(theirs), ("logits", "boxes")):
        _close(ours, want, what)
    assert logits.shape == (3, 256, 2) and boxes.shape == (3, 256, 4)


def _reference_step(ref, frame0, state, frame, best=None):
    tmpl = R.Template(ref, torch.from_numpy(frame0), torch.from_numpy(POS),
                      torch.from_numpy(SZ), R.TRACKER)
    return R.step(ref, R.TRACKER, tmpl, torch.from_numpy(frame), state.target_pos,
                  state.target_sz, best=best)


def test_batched_step_matches(setup):
    """Three objects on one frame: the template, the foreground map, the
    argmax and the new boxes, against the reference's step."""
    p, model, ref = setup
    video = _video(2)
    tracker = TransTTracker(model, HP, "cpu")
    state = tracker.init_batched(video[0], POS, SZ)
    tmpl = R.Template(ref, torch.from_numpy(video[0]), torch.from_numpy(POS),
                      torch.from_numpy(SZ), R.TRACKER)
    _close(state.zf, tmpl.tokens, "template tokens")
    fg = tracker.search(state, torch.from_numpy(video[1]))[0]
    new, out = tracker.step_batched(state, video[1])
    theirs = _reference_step(ref, video[0], state, video[1])
    _close(fg, theirs["fg"], "foreground")
    assert out.best_id.tolist() == theirs["best"].tolist()
    _close(out.target_pos, theirs["pos"], "position", 1e-7)
    _close(out.target_sz, theirs["sz"], "size", 1e-7)
    _close(out.score, theirs["score"], "score")
    assert torch.equal(new.target_pos, out.target_pos) and new.zf is state.zf
    assert out.target_pos.dtype == torch.float32 and out.best_id.shape == (3,)


def test_closed_loop_matches_step_by_step(setup):
    """Five frames, each object's box fed back: every step against the
    reference's step from the program's state at the program's cell, and
    the cell the reference would take itself."""
    p, model, ref = setup
    video = _video(6)
    tracker = TransTTracker(model, HP, "cpu")
    state = tracker.init_batched(video[0], POS, SZ)
    moved = 0.0
    for t in range(1, 6):
        before = state
        state, out = tracker.step_batched(state, video[t])
        theirs = _reference_step(ref, video[0], before, video[t])
        assert out.best_id.tolist() == theirs["best"].tolist(), t
        _close(out.target_pos, theirs["pos"], f"position {t}", 1e-7)
        _close(out.target_sz, theirs["sz"], f"size {t}", 1e-7)
        moved = max(moved, float((out.target_pos - before.target_pos).abs().max()))
    assert moved > 1.0           # the loop is closed: the boxes move
    assert tracker.frame_index == 6


def test_attn_calls_counter(setup):
    """Seventeen attentions a step at the published depth (four a fusion
    layer, one in the decoder), each counted once; the template pass runs
    none."""
    p, model, ref = setup
    video = _video(2)
    tracker = TransTTracker(model, HP, "cpu")
    before = trace.counters().get("transt.attn_calls", 0)
    state = tracker.init_batched(video[0], POS, SZ)
    assert trace.counters().get("transt.attn_calls", 0) == before
    tracker.step_batched(state, video[1])
    assert trace.counters()["transt.attn_calls"] - before == 17


def _write_vot(root, n=5):
    """A VOT2018-layout video of one textured block."""
    import cv2

    video = _video(n)
    vdir = root / "VOT2018" / "synth"
    vdir.mkdir(parents=True)
    gts = []
    for i, im in enumerate(video):
        cv2.imwrite(str(vdir / f"{i + 1:08d}.jpg"), im)
        (x, y), (w, h) = POS[0] + (i % 4, (2 * i) % 5), SZ[0]
        x0, y0 = int(x - w / 2), int(y - h / 2)
        gts.append([x0, y0, x0 + w, y0, x0 + w, y0 + h, x0, y0 + h])
    np.savetxt(vdir / "groundtruth.txt", np.array(gts), delimiter=",", fmt="%.4f")
    (root / "VOT2018" / "list.txt").write_text("synth\n")


def test_family_dispatch_and_test_cli(tmp_path):
    """``build_model("TransT")`` at an experiment config's sizes,
    ``TrackerRuntime`` building ``TransTTracker`` for the family (box only,
    whatever ``mask`` asks), and the test CLI's VOT run on such a config."""
    from siammask_tpu_torch.tools import test as test_cli

    model = build_model("TransT", network={"transt": CFG})
    assert isinstance(model, TransT) and model.cfg == SMALL and model.dtype is None
    assert build_model("TransT", dtype=torch.bfloat16).dtype is torch.bfloat16
    runtime = TrackerRuntime(model.init_weights(torch.Generator().manual_seed(0)).eval(),
                             HP, "cpu", mask=True, refine=True)
    assert isinstance(runtime.tracker, TransTTracker) and not runtime.tracker.mask
    video = _video(2)
    runtime.init(video[0], POS[0], SZ[0])
    result = runtime.track(video[1])
    assert set(result) == {"target_pos", "target_sz", "score"}

    published = json.loads(EXPERIMENT.read_text())
    assert published["network"]["arch"] == "TransT"
    assert {k: published["hp"][k] for k in R.TRACKER} == R.TRACKER
    _write_vot(tmp_path)
    config = tmp_path / "config.json"
    config.write_text(json.dumps({"network": {"arch": "TransT", "transt": CFG},
                                  "hp": published["hp"]}))
    totals = test_cli.main(["--config", str(config), "--dataset", "VOT2018", "--data-dir",
                            str(tmp_path), "--device", "cpu", "--result-dir",
                            str(tmp_path / "out")])
    assert totals["videos"] == 1 and totals["lost"] >= 0
    lines = (tmp_path / "out" / "VOT2018" / "TransT_random" / "baseline" / "synth" /
             "synth_001.txt").read_text().split()
    assert lines[0] == "1" and len(lines) == 5 and len(lines[1].split(",")) in (1, 4)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is false)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_bf16_step_on_card_near_the_reference(cuda_device):
    """The small model in bf16 on the card (folded BN convs, FlashAttention-2
    at head width 16) over 8 frames, each step against the float32
    reference on the card from the program's state at the program's cell:
    foreground probabilities within 0.02 on average, boxes within 2% of the
    target's size, and that cell the reference's best where its windowed
    scores are 0.01 apart."""
    from perfbench.reference.model import fp32_exact

    p = {k: v.float().to(cuda_device) for k, v in _weights().items()}
    model = _model(p, torch.bfloat16).to(cuda_device)
    tracker = TransTTracker(model, HP, cuda_device)
    video = torch.from_numpy(_video(9)).to(cuda_device)
    state = tracker.init_batched(video[0], POS, SZ)
    before = trace.counters().get("conv.bn_folded", 0)
    with fp32_exact():
        ref = R.TransTRef(p, CFG)
        tmpl = R.Template(ref, video[0], torch.from_numpy(POS).to(cuda_device),
                          torch.from_numpy(SZ).to(cuda_device), R.TRACKER)
        for t in range(1, 9):
            with torch.inference_mode():
                fg = tracker.search(state, video[t])[0]
            prev = state
            state, out = tracker.step_batched(state, video[t])
            r = R.step(ref, R.TRACKER, tmpl, video[t], prev.target_pos, prev.target_sz,
                       best=out.best_id)
            assert (fg - r["fg"]).abs().mean() < 0.02, t
            units = prev.target_sz.prod(1).sqrt()[:, None]
            assert ((out.target_pos - r["pos"]).abs() / units).max() < 0.02, t
            assert ((out.target_sz - r["sz"]).abs() / units).max() < 0.02, t
            top = r["pscore"].topk(2, dim=1).values
            clear = (top[:, 0] - top[:, 1]) > 0.01
            taken = r["pscore"].gather(1, out.best_id[:, None])[:, 0]
            assert torch.equal(taken[clear], top[clear, 0]), t
    assert trace.counters()["conv.bn_folded"] > before      # the backbone ran folded


@pytest.mark.cuda
def test_graph_replay_is_the_eager_loop_on_card(cuda_device):
    """``track_video_multi`` replays one CUDA graph a frame: the same bits
    as the eager ``step_batched`` loop from the same state."""
    p = {k: v.float().to(cuda_device) for k, v in _weights().items()}
    model = _model(p, torch.bfloat16).to(cuda_device)
    video = torch.from_numpy(_video(12)).to(cuda_device)
    runs = []
    for graphed in (True, False):
        tracker = TransTTracker(model, HP, cuda_device)
        state = tracker.init_batched(video[0], POS, SZ)
        if graphed:
            state, outs = tracker.track_video_multi(state, video[1:])
            assert len(tracker.graphs) == 1
        else:
            loop = []
            for frame in video[1:]:
                state, out = tracker.step_batched(state, frame)
                loop.append(out)
            outs = type(loop[0])(*(torch.stack(v) for v in zip(*loop)))
        runs.append((state, outs))
    (s1, o1), (s2, o2) = runs
    for a, b in zip(list(o1) + list(s1), list(o2) + list(s2)):
        assert torch.equal(a, b)
    assert o1.target_pos.shape == (11, 3, 2)
