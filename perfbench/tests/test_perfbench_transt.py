"""The TransT cell on the CPU at a small size (the backbone at width 8, d 32
with 2 heads, FFN 64, four fusion layers, 64 / 128 crops; three objects in
a 120x200 video; the program in float32): a sound run is correct; the
control (the plain reference at fp8 in the program's place) and each
planted fault are not, under the cell's own limits, set from the card's
readings (PERF.md): the cross-attention directions swapped, the positions
left off the keys, the last fusion layer skipped, the template's tokens
frozen after their self-attention. Also the FLOP counts against ``torch``'s
counter on the reference, the traffic drawn from the seed, and the
weights' calibration."""
import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from perfbench import flops_transt, harness
from perfbench.reference import transt as R

SEED = 2 ** 31 + 5
SMALL = {"width": 8, "d_model": 32, "heads": 2, "ffn": 64, "template_size": 64,
         "search_size": 128, "dtype": "float32"}
TINY = {"config": SMALL,
        "traffic": {"objects": 3, "chunk": 2, "pool_frames": 4, "frame_size": [120, 200],
                    "centre": [40, 80], "size": [20, 40], "amplitude": 5}}


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def run(seed=SEED, **kwargs):
    readings = {}
    out = harness.run_cell("transt_box_16obj", seed, 0.3, False, device="cpu",
                           require_card=False, overrides=TINY, readings=readings, **kwargs)
    return out, readings


def test_sound_run_is_correct():
    out, readings = run()
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    assert set(out["checks"]) == {"score_gap.mean", "box_err", "box_err.mean", "cls_mae"}
    assert readings["box_err"] < 1e-4 and readings["cls_mae"] < 1e-4


def test_control_is_not_correct():
    out, _ = run(system="control")
    assert not out["correct"], out["checks"]


def _layer():
    from siammask_tpu_torch.models.transt import FeatureFusionLayer
    return FeatureFusionLayer


def _cross_swapped(monkeypatch):
    """Each stream's cross-attention runs with the other stream's weights."""
    from siammask_tpu_torch.models.transt import _ffn

    def swapped(self, t, s, pt, ps):
        t = self.norm11(t + self.self_attn1(t, pt, t, pt))
        s = self.norm21(s + self.self_attn2(s, ps, s, ps))
        t2 = self.multihead_attn2(t, pt, s, ps)
        s2 = self.multihead_attn1(s, ps, t, pt)
        t = _ffn(self.norm12(t + t2), self.linear11, self.linear12, self.norm13)
        s = _ffn(self.norm22(s + s2), self.linear21, self.linear22, self.norm23)
        return t, s

    monkeypatch.setattr(_layer(), "forward", swapped)


def _keys_without_positions(monkeypatch):
    """Every attention's keys are the tokens alone, the queries keep theirs."""
    from siammask_tpu_torch.models.transt import MultiheadAttention
    forward = MultiheadAttention.forward

    def unplaced(self, x, px, m, pm):
        return forward(self, x, px, m, torch.zeros_like(pm))

    monkeypatch.setattr(MultiheadAttention, "forward", unplaced)


def _last_layer_skipped(monkeypatch):
    """The fusion network runs all but its last layer."""
    from siammask_tpu_torch.models.transt import FeatureFusionNetwork

    def short(self, t, s, pt, ps):
        for layer in self.encoder.layers[:-1]:
            t, s = layer(t, s, pt, ps)
        for layer in self.decoder.layers:
            s = layer(s, t, ps, pt)
        return self.decoder.norm(s)

    monkeypatch.setattr(FeatureFusionNetwork, "forward", short)


def _template_frozen(monkeypatch):
    """The template's tokens leave each layer as its self-attention left
    them: no cross-attention and no FFN on that stream."""
    from siammask_tpu_torch.models.transt import _ffn

    def frozen(self, t, s, pt, ps):
        t = self.norm11(t + self.self_attn1(t, pt, t, pt))
        s = self.norm21(s + self.self_attn2(s, ps, s, ps))
        s2 = self.multihead_attn2(s, ps, t, pt)
        return t, _ffn(self.norm22(s + s2), self.linear21, self.linear22, self.norm23)

    monkeypatch.setattr(_layer(), "forward", frozen)


FAULTS = [_cross_swapped, _keys_without_positions, _last_layer_skipped, _template_frozen]


@pytest.mark.parametrize("fault", FAULTS)
def test_faults_are_not_correct(monkeypatch, fault):
    fault(monkeypatch)
    out, _ = run()
    assert not out["correct"], out["checks"]


def test_traffic_is_drawn_from_the_seed():
    """One seed gives one video, one set of weights and one set of checked
    frames; another seed deals the same objects' sides to other centres."""
    from perfbench.drivers.transt_box import TransTBoxCell

    def cell(seed):
        found = harness.find_cell("transt_box_16obj")
        ctx = harness.Context("transt_box_16obj", found, seed, torch.device("cpu"), 1, TINY)
        return TransTBoxCell(ctx)

    a, b, c = cell(SEED), cell(SEED), cell(SEED + 1)
    assert np.array_equal(a.pool, b.pool) and not np.array_equal(a.pool, c.pool)
    assert all(torch.equal(a.p[k], b.p[k]) for k in a.p)
    assert np.array_equal(a.boxes, b.boxes)
    assert sorted(map(tuple, a.sz0)) == sorted(map(tuple, c.sz0))
    assert not np.array_equal(a.sz0, c.sz0)
    centres = np.random.RandomState(0).uniform(40, 80, (3, 2))
    assert np.allclose(np.sort(a.boxes[:, :, :2].mean(0), axis=0), np.sort(centres, axis=0),
                       atol=1e-9)


def test_flops_match_the_counter():
    """One object-frame's FLOPs counted from shapes against
    ``FlopCounterMode`` on the reference's step network, at the small size;
    the published size's attention count and QK/PV share."""
    p = R.init_weights(SMALL, torch.Generator().manual_seed(0), "cpu")
    net = R.TransTRef(p, SMALL)
    zt = net.template(255 * torch.rand(1, 3, 64, 64))
    with FlopCounterMode(display=False) as counter:
        net.track(zt, 255 * torch.rand(1, 3, 128, 128))
    assert counter.get_total_flops() == flops_transt.step_flops(SMALL)
    with FlopCounterMode(display=False) as counter:
        net.fuse(zt, net.features(255 * torch.rand(1, 3, 128, 128)))
    fusion = flops_transt.fusion_flops(SMALL)
    features = flops_transt.step_flops(SMALL) - fusion["total"]
    heads = 2 * 256 * (2 * 32 * 32 + 2 * 32) + 2 * 256 * (2 * 32 * 32 + 4 * 32)
    assert counter.get_total_flops() == fusion["total"] + features - heads
    assert flops_transt.attn_calls({}) == 17 and flops_transt.head_width({}) == 32
    assert flops_transt.fusion_flops({})["attn"] == 6_979_321_856
    assert round(flops_transt.step_flops({}) / 1e9, 2) == 45.88


def test_weights_are_calibrated():
    """Frame 0's fg - bg logits over the objects' cells have mean 0 and the
    traffic's spread; the box head's outputs the given spread about the
    crop's centre and a quarter of its side."""
    from perfbench.drivers.transt_box import _penultimate, make_weights
    from perfbench.reference.tracker import crop

    frame = torch.randint(0, 255, (120, 200, 3), dtype=torch.uint8,
                          generator=torch.Generator().manual_seed(1))
    pos, sz = np.array([[60.0, 50.0], [130.0, 70.0]]), np.array([[30.0, 24.0], [22.0, 36.0]])
    p = make_weights(SMALL, 5, frame, pos, sz, 2.0, 0.02)
    net = R.TransTRef(p, SMALL)
    pos, sz = torch.as_tensor(pos, dtype=torch.float32), torch.as_tensor(sz, dtype=torch.float32)
    avg = frame.float().mean(dim=(0, 1)).expand(2, -1)
    xs = net.features(crop(frame, pos, R.crop_side(sz, 4.0), 128, avg))
    zt = net.template(crop(frame, pos, R.crop_side(sz, 2.0), 64, avg))
    logits, boxes = net.heads(net.fuse(zt, xs))
    diff = logits[..., 0] - logits[..., 1]
    assert float(diff.mean()) == pytest.approx(0.0, abs=1e-4)
    assert float(diff.std()) == pytest.approx(2.0, rel=1e-4)
    raw = torch.logit(boxes).flatten(0, 1)
    assert raw.std(dim=0).tolist() == pytest.approx([0.02] * 4, rel=1e-3)
    assert raw.mean(dim=0).tolist() == pytest.approx([0.0, 0.0, np.log(1 / 3), np.log(1 / 3)],
                                                     abs=1e-4)
    assert _penultimate(net, net.fuse(zt, xs), "bbox_embed").shape == (2, 256, 32)


def test_attention_kernels_by_name():
    """The roofline reader's kernels: FlashAttention-2's forward kernels of
    head width 32, split-KV included, and no others."""
    ops = {"void pytorch_flash::flash_fwd_kernel<Flash_fwd_kernel_traits<32, 128, 128, 4, false, "
           "false, cutlass::bfloat16_t, Flash_kernel_traits<32, 128, 128, 4, cutlass::bfloat16_t> "
           ">, false>(pytorch_flash::Flash_fwd_params)": 2.0,
           "void pytorch_flash::flash_fwd_splitkv_kernel<Flash_fwd_kernel_traits<32, 64, 256, 4, "
           "false, false, cutlass::bfloat16_t, Flash_kernel_traits<32, 64, 256, 4, "
           "cutlass::bfloat16_t> >, false>(pytorch_flash::Flash_fwd_params)": 4.0,
           "void pytorch_flash::flash_fwd_kernel<Flash_fwd_kernel_traits<64, 128, 128, 4, false, "
           "false, cutlass::bfloat16_t, Flash_kernel_traits<64, 128, 128, 4, cutlass::bfloat16_t> "
           ">, false>(pytorch_flash::Flash_fwd_params)": 8.0}
    assert flops_transt.attention_seconds(ops, 32) == 6.0


@pytest.mark.cuda
def test_cell_on_the_card():
    """One short run of the cell at its own size on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    out = harness.run_cell("transt_box_16obj", SEED, 2.0, False)
    assert out["correct"], out["checks"]
