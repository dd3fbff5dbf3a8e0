"""The SAM 2 cell on the CPU at a small size (Hiera at width 16, a 128x128
input, memory attention at d 32; three objects in a 60x100 video; the
program in float32): a sound run is correct; the control (the plain
reference at fp8 in the program's place) and each planted fault are not,
under the cell's own limits, set from the card's readings (PERF.md): the
ring not rotated, the pointers dropped from memory attention, RoPE left off
the memory keys. Also the FLOP counts against ``torch``'s counter on the
reference, and the weights' calibration."""
import dataclasses

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from perfbench import flops_sam2, harness
from perfbench.reference import sam2 as R

SEED = 2 ** 31 + 3
SMALL = {"embed_dim": 16, "num_heads": 1, "stages": [1, 2, 2, 1], "window_spec": [4, 2, 4, 2],
         "global_att_blocks": [4], "pos_embed_size": [7, 7], "d_model": 32, "mem_dim": 8,
         "image_size": 128, "memattn_ffn": 64, "decoder_mlp": 64, "dtype": "float32"}
TINY = {"config": SMALL,
        "traffic": {"objects": 3, "chunk": 2, "pool_frames": 6, "frame_size": [60, 100],
                    "centre": [30, 50], "size": [14, 24], "amplitude": 3}}


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def run(**kwargs):
    readings = {}
    out = harness.run_cell("sam2_vos_16obj", SEED, 0.3, False, device="cpu",
                           require_card=False, overrides=TINY, readings=readings, **kwargs)
    return out, readings


def test_sound_run_is_correct():
    out, readings = run()
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    assert set(readings) >= {"mask_mae", "iou_gap", "memory_err", "ptr_err"}


def test_control_is_not_correct():
    out, _ = run(system="control")
    assert not out["correct"], out["checks"]


def _tracker():
    from siammask_tpu_torch.tracker.sam2 import Sam2Tracker
    return Sam2Tracker


def _ring_not_rotated(monkeypatch):
    """Every frame writes ring slot 0."""
    tracker = _tracker()
    slots = tracker._slots

    def first(self, states):
        ring, ptr = slots(self, states)
        return torch.zeros_like(ring), ptr

    monkeypatch.setattr(tracker, "_slots", first)


def _pointers_dropped(monkeypatch):
    """Memory attention attends the memory frames and no pointer."""
    tracker = _tracker()
    memory = tracker._memory

    def dropped(self, states, t, dtype):
        mem, pos, n = memory(self, states, t, dtype)
        return mem[:, :mem.shape[1] - n], pos[:, :pos.shape[1] - n], 0

    monkeypatch.setattr(tracker, "_memory", dropped)


def _rope_off_memory(monkeypatch):
    """RoPE rotates the queries and the frame's own keys, not the memory's."""
    from siammask_tpu_torch.models.sam2 import Sam2
    phases = Sam2.key_phases

    def unrotated(self, device, dtype, frames, ptr_tokens):
        return torch.ones_like(phases(self, device, dtype, frames, ptr_tokens))

    monkeypatch.setattr(Sam2, "key_phases", unrotated)


def _least_iou_mask(monkeypatch):
    """Tracking frames take the least of masks 1-3 by predicted IoU."""
    monkeypatch.setattr(_tracker(), "_choose",
                        staticmethod(lambda iou: 1 + torch.argmin(iou[:, 1:], dim=1)))


def _mask_zero(monkeypatch):
    """Tracking frames take mask 0, as the conditioning frame does."""
    monkeypatch.setattr(_tracker(), "_choose",
                        staticmethod(lambda iou: torch.zeros_like(iou[:, 0], dtype=torch.long)))


@pytest.mark.parametrize("fault", [_ring_not_rotated, _pointers_dropped, _rope_off_memory,
                                   _least_iou_mask, _mask_zero])
def test_faults_are_not_correct(monkeypatch, fault):
    fault(monkeypatch)
    out, _ = run()
    assert not out["correct"], out["checks"]


def test_flops_match_the_counter():
    """The encoder's and one tracking frame's FLOPs counted from shapes
    against ``FlopCounterMode`` on the reference, at the small size."""
    cfg = SMALL
    p = R.init_weights(cfg, torch.Generator().manual_seed(0), "cpu")
    ref = R.Sam2Ref(p, cfg)
    frame = torch.randint(0, 255, (60, 100, 3), dtype=torch.uint8)
    with FlopCounterMode(display=False) as counter:
        maps = ref.image(frame)
    enc = flops_sam2.encoder_flops(cfg)
    s = cfg["image_size"] // 16
    shared = 2 * s * s * cfg["d_model"] ** 2          # counted once a frame
    assert counter.get_total_flops() == enc["total"] - shared
    out0 = ref.frame(maps, (60, 100), box=(10, 10, 30, 30))
    frames = {f: (out0["mem"], out0["ptr"]) for f in range(16)}
    bank = R.select(16, frames, cfg)
    assert len(bank[0]) == 7 and len(bank[1]) == 16
    with FlopCounterMode(display=False) as counter:
        ref.frame(maps, (60, 100), bank=bank)
    per = flops_sam2.memattn_flops(cfg)["total"] + flops_sam2.object_flops(cfg) + shared
    # the reference's own extras: the decoder's and prompt's Fourier
    # encodings, the pointers' sine positions
    assert per <= counter.get_total_flops() <= per * 1.01


def test_weights_are_calibrated():
    """Frame 0's mask logits inside the boxes have the traffic's mean and
    spread, for each mask token; every object scores at least the margin;
    memory attention's first layer has logits of the given spread."""
    from perfbench.drivers.sam2_vos import frame0_bank, make_weights

    cfg = SMALL
    frame = torch.randint(0, 255, (60, 100, 3), dtype=torch.uint8,
                          generator=torch.Generator().manual_seed(1))
    pos, sz = [[30.0, 25.0], [60.0, 35.0]], [[20.0, 16.0], [18.0, 22.0]]
    p = make_weights(cfg, 5, frame, pos, sz, {"mean": 1.5, "std": 2.0}, 10.0, 2.0)
    ref = R.Sam2Ref(p, cfg)
    maps = ref.image(frame)
    outs = [ref.frame(maps, (60, 100), box=(x - w / 2, y - h / 2, x + w / 2, y + h / 2))
            for (x, y), (w, h) in zip(pos, sz)]
    assert min(float(o["score"]) for o in outs) == pytest.approx(10.0, abs=1e-4)
    s = 4 * cfg["image_size"] // 16
    for k in range(4):
        inside = torch.cat([o["masks"][k][int(y0 * s / 60):int(-(-y1 * s // 60)),
                                          int(x0 * s / 100):int(-(-x1 * s // 100))].flatten()
                            for o, ((x, y), (w, h)) in zip(outs, zip(pos, sz))
                            for x0, y0, x1, y1 in [(x - w / 2, y - h / 2, x + w / 2, y + h / 2)]])
        assert float(inside.mean()) == pytest.approx(1.5, abs=1e-3)
        assert float(inside.std(unbiased=False)) == pytest.approx(2.0, abs=1e-3)
    probe = []
    ref.memory_attention(*frame0_bank(ref, maps, outs[0]), probe=probe)
    assert probe[0][0] == pytest.approx(2.0, rel=1e-4)
    assert all(v == pytest.approx(2.0, rel=0.25) for layer in probe for v in layer), probe


def test_reference_defaults_are_the_programs():
    """The reference's published sizes are the program's ``Sam2Config``
    defaults, and the cell's configuration file states every one of them."""
    import json
    from pathlib import Path

    from siammask_tpu_torch.models.sam2 import Sam2Config

    ours = {k: list(v) if isinstance(v, tuple) else v
            for k, v in dataclasses.asdict(Sam2Config()).items()}
    assert ours == R.DEFAULTS
    config = json.loads((Path(__file__).parents[1] / "configs" /
                         "sam2.1_hiera_bplus_bf16.json").read_text())
    assert {k: config[k] for k in R.DEFAULTS} == R.DEFAULTS


def test_attention_kernels_by_name():
    """The roofline readers' kernels: cuDNN's fused attention (memory
    attention) and FlashAttention-2's by head width, split-KV included."""
    ops = {"cudnn_generated_fort_native_sdpa_sm90_flash_fprop_wgmma_f16_knob_7_64x128x256_4x1x1"
           "_cga1x1x1_kernel0_0": 1.0,
           "void pytorch_flash::flash_fwd_kernel<Flash_fwd_kernel_traits<64, 128, 128, 4, false, "
           "false, cutlass::bfloat16_t, Flash_kernel_traits<64, 128, 128, 4, cutlass::bfloat16_t> "
           ">, false>(pytorch_flash::Flash_fwd_params)": 2.0,
           "void pytorch_flash::flash_fwd_splitkv_kernel<Flash_fwd_kernel_traits<32, 64, 256, 4, "
           "false, false, cutlass::bfloat16_t, Flash_kernel_traits<32, 64, 256, 4, "
           "cutlass::bfloat16_t> >, false>(pytorch_flash::Flash_fwd_params)": 4.0,
           "nvjet_tst_128x256_64x4_2x1_v_bz_coopA_bias_TNN": 8.0}
    assert flops_sam2.attention_seconds(ops) == 1.0
    assert flops_sam2.attention_seconds(ops, 64) == 2.0
    assert flops_sam2.attention_seconds(ops, 32) == 4.0
    assert flops_sam2.attention_seconds(ops, 256) == 0.0


@pytest.mark.cuda
def test_cell_on_the_card():
    """One short run of the cell at its own size on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    out = harness.run_cell("sam2_vos_16obj", SEED, 2.0, False)
    assert out["correct"], out["checks"]
