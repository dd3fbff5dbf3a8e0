"""``siammask_tpu_torch.bench`` on the CPU at width 8.

- FLOPs: the port's count (``bench.count_flops``) of the sharp track step
  per frame and of the frozen, unfrozen and stage-2 training steps at batch
  2 equals the JAX bench's jaxpr walk (the root ``bench.py``'s
  ``_flops_per_frame``, loaded by path as ``test_bench_outage.py`` does) on
  the JAX package's counterparts (``Tracker(..., latency_lowerings=False)``,
  ``make_train_step``, both with ``xcorr_impl="shift"``), once the terms
  below, each computed here from shapes, are added to the port's count.
  Each is a matmul or a conv extent the JAX program holds and the port's
  does not:

  - ``refine_upsample``: Refine's three nearest upsamples, which JAX runs as
    two interpolation matmuls each (``ops/resize.py``) and the port as
    gathers; per refined window, forward (and backward when training);
  - ``raw_mask_head``: the 1x1 mask head over the 25x25 corr, which JAX's
    sharp ``track_mask`` traces and its step never reads (XLA drops it);
  - ``mask_loss_upsample``: the base loss's 63 -> 127 bilinear upsample of
    the K selected rows, two matmuls forward and two backward;
  - ``gt_window_onehot``: the mask loss's one-hot matmul that gathers the K
    ground-truth windows from the padded mask;
  - ``dgrad_extent``: for each conv input gradient, the walk counts the
    transposed conv over the input's extent (its output), the port's counter
    over the forward output's: 2 N Cin Cout kh kw (Hin Win - Hout Wout),
    from the shapes of the port's own ``convolution_backward`` calls.

  K, the rows the mask loss selects, is min(16 B, B S^2), as JAX's
  ``select_mask_logistic_loss`` sizes its static top-k.
- Payloads: each row function emits its metric name and every key the JAX
  bench emits for that row, names its device ``cpu`` and gives no MFU.
- Summary: ``run_summary``'s final line carries the five rows; a failing
  row is an error and a non-zero exit, with no cached stand-in; a row's
  process that fails, prints nothing or overruns is an error too.
"""
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from siammask_tpu.config import TrackerConfig as JaxTrackerConfig
from siammask_tpu.models import siammask as jsiammask
from siammask_tpu.tracker.tracker import Tracker as JaxTracker
from siammask_tpu.train import trainer as jtrainer
from siammask_tpu.utils.torch_convert import convert_state_dict
from siammask_tpu_torch import bench
from siammask_tpu_torch.config import TrackerConfig
from siammask_tpu_torch.models.siammask import SiamMaskBase, SiamMaskSharp
from siammask_tpu_torch.tracker.tracker import Tracker
from siammask_tpu_torch.train.trainer import OptimizerConfig, Trainer, TrainSettings

from test_torch_tracker import WIDTH, one_torch_thread  # noqa: F401  (autouse)

B = 2
S_TRACK = 25
# (in size, out size, channels) of Refine's three upsamples
REFINE_UPSAMPLES = ((15, 31, 32), (31, 61, 16), (61, 127, 4))
JAX_KEYS = {
    "track": {"metric", "value", "unit", "vs_baseline", "device_step_us",
              "model_gflops_per_frame", "mfu_pct"},
    "per_step": {"metric", "value", "unit", "vs_baseline", "device_step_us"},
    "train": {"metric", "value", "unit", "vs_baseline", "device_step_ms", "batch", "phase",
              "train_gflops_per_step", "train_mfu_pct"},
}


@pytest.fixture(scope="module")
def root_bench():
    spec = importlib.util.spec_from_file_location(
        "bench_root", str(Path(__file__).resolve().parents[1] / "bench.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def refine_upsample(windows: int) -> int:
    """Refine's nearest upsamples as JAX's two matmuls each, for ``windows``
    refined windows: (O, H) over the rows, then (O, W) over the columns."""
    return sum(2 * windows * o * i * i * c + 2 * windows * o * o * i * c
               for i, o, c in REFINE_UPSAMPLES)


def raw_mask_head(width: int) -> int:
    hidden = 4 * width
    return 2 * S_TRACK ** 2 * hidden * (hidden + 63 ** 2)


def mask_loss_upsample(k: int) -> int:
    """63 -> 127 bilinear over rows then columns, forward and backward."""
    return 2 * (2 * k * 127 * 63 * 63 + 2 * k * 127 * 127 * 63)


def gt_window_onehot(k: int, padded_width: int) -> int:
    return 2 * k * 127 * 127 * padded_width


class ConvBackwards(TorchDispatchMode):
    """Records (grad_out, input, weight) shapes of each conv backward that
    computes an input gradient."""

    def __init__(self):
        super().__init__()
        self.dgrads = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func is torch.ops.aten.convolution_backward.default and args[-1][0]:
            self.dgrads.append(tuple(tuple(a.shape) for a in args[:3]))
        return func(*args, **(kwargs or {}))


def dgrad_extent(dgrads) -> int:
    return sum(2 * n * cin * cout * kh * kw * (hin * win - hout * wout)
               for (n, cout, hout, wout), (_, cin, hin, win), (_, _, kh, kw) in dgrads)


def _variables(model):
    return convert_state_dict({k: v.detach().float().numpy()
                               for k, v in model.state_dict().items()})


def test_track_flops_match_the_jax_walk(root_bench):
    model = bench.fast_init(SiamMaskSharp(width=WIDTH)).eval()
    frame = np.random.RandomState(0).uniform(0, 255, (*bench.FRAME_HW, 3)).astype(np.uint8)
    jtracker = JaxTracker(jsiammask.SiamMaskSharp(width=WIDTH, xcorr_impl="shift"),
                          JaxTrackerConfig().update(bench.HP), latency_lowerings=False)
    variables = _variables(model)
    jstate = jtracker.init(variables, jnp.asarray(frame, jnp.float32),
                           np.array(bench.INIT_POS), np.array(bench.INIT_SZ))
    theirs = root_bench._flops_per_frame(jtracker.step,
                                         (variables, jstate, jnp.asarray(frame)), 1)
    tracker = Tracker(model, TrackerConfig().update(bench.HP), "cpu")
    state = tracker.init(frame, np.array(bench.INIT_POS), np.array(bench.INIT_SZ))
    ours, _ = bench.count_flops(lambda: tracker.step(state, frame))
    assert ours + refine_upsample(1) + raw_mask_head(WIDTH) == theirs


TRAIN_CASES = {"frozen": (False, False), "unfrozen": (False, True), "refine": (True, False)}


@pytest.mark.parametrize("case", sorted(TRAIN_CASES))
def test_train_flops_match_the_jax_walk(root_bench, case):
    refine, unfrozen = TRAIN_CASES[case]
    if refine:
        model, jmodel = SiamMaskSharp(width=WIDTH), jsiammask.SiamMaskSharp
        search, size, task, weights, pad = 143, 3, "sharp_refine", (0.0, 0.0, 36.0), 0
    else:
        model, jmodel = SiamMaskBase(width=WIDTH), jsiammask.SiamMaskBase
        search, size, task, weights, pad = 255, 25, "base", (1.0, 1.2, 36.0), 32
    bench.fast_init(model)
    variables = jax.tree_util.tree_map(jnp.asarray, _variables(model))
    tx, _ = jtrainer.build_optimizer(variables["params"], jtrainer.OptimizerConfig(),
                                     unfreeze_backbone=unfrozen, train_refine_only=refine)
    step = jtrainer.make_train_step(
        jmodel(width=WIDTH, xcorr_impl="shift"),
        jtrainer.TrainSettings(task=task, loss_weight=weights, mask_pad=pad), tx,
        unfreeze_backbone=unfrozen)
    batch = bench.train_batch(B, search, size, "cpu")
    jbatch = {k: jnp.asarray(v.permute(0, 2, 3, 1).numpy() if v.dim() == 4 and k in
                             ("template", "search") else v.numpy()) for k, v in batch.items()}
    jbatch["label_cls"] = jbatch["label_cls"].astype(jnp.int32)
    theirs = root_bench._flops_per_frame(
        step, (variables, tx.init(variables["params"]), jbatch, jnp.float32(0.005)), 1)

    trainer = Trainer(model, TrainSettings(task=task, loss_weight=weights, mask_pad=pad),
                      OptimizerConfig(), np.full(2, 0.005), epochs=2)
    log = ConvBackwards()

    def step_logged():
        with log:
            return trainer.step(batch, 1 if unfrozen else 0)

    ours, _ = bench.count_flops(step_logged)
    k = min(16 * B, B * size ** 2)
    terms = dgrad_extent(log.dgrads) + gt_window_onehot(k, search + 2 * pad)
    terms += refine_upsample(2 * B * size ** 2) if refine else mask_loss_upsample(k)
    assert log.dgrads
    assert ours + terms == theirs


def _check_payload(payload: dict, keys: set, metric: str) -> None:
    assert keys <= set(payload), keys - set(payload)
    assert payload["metric"] == metric
    assert payload["device"] == "cpu" and payload["name"] is None
    assert payload["value"] > 0 and payload["windows"] >= bench.MIN_WINDOWS
    assert not {"from_cache", "stale", "cached_at"} & set(payload)
    assert payload.get("mfu_pct") is None and payload.get("train_mfu_pct") is None
    json.dumps(payload)


@pytest.mark.parametrize("fp32", [False, True], ids=["bf16", "fp32"])
def test_track_rows_emit_the_jax_keys(fp32):
    one = bench.bench_track(width=WIDTH, device="cpu", fp32=fp32, scan=1, iters=5)
    _check_payload(one, JAX_KEYS["track"], "siammask_sharp_scan_fps_T1")
    assert one["model_gflops_per_frame"] > 0
    assert one["tf32"] is False or not fp32
    multi = bench.bench_track(width=WIDTH, device="cpu", fp32=fp32, scan=1, streams=2, iters=5)
    _check_payload(multi, JAX_KEYS["track"], "siammask_sharp_scan_aggregate_fps_2streams")
    assert multi["model_gflops_per_frame"] == one["model_gflops_per_frame"]


def test_per_step_rows_emit_the_jax_keys():
    one = bench.bench_track(width=WIDTH, device="cpu", scan=1, iters=5, per_step=True)
    _check_payload(one, JAX_KEYS["per_step"], "siammask_sharp_track_step_fps_per_chip")
    multi = bench.bench_track(width=WIDTH, device="cpu", scan=1, streams=2, iters=5,
                              per_step=True)
    _check_payload(multi, JAX_KEYS["per_step"], "siammask_sharp_track_aggregate_fps_2streams")


@pytest.mark.parametrize("case", sorted(TRAIN_CASES))
def test_train_rows_emit_the_jax_keys(case):
    refine, unfrozen = TRAIN_CASES[case]
    payload = bench.bench_train(width=WIDTH, batch=B, device="cpu", refine=refine,
                                unfrozen=unfrozen, iters=5)
    stage = "refine" if refine else "base"
    _check_payload(payload, JAX_KEYS["train"], f"siammask_{stage}_train_samples_per_s_b{B}")
    assert payload["phase"] == ("unfrozen" if unfrozen else "frozen") and payload["batch"] == B
    assert np.isfinite(payload["loss"]) and payload["train_gflops_per_step"] > 0


def test_fast_init_follows_the_jax_rule_and_keeps_dtypes():
    model = bench.fast_init(SiamMaskSharp(width=WIDTH, dtype=torch.bfloat16))
    deconv = model.refine_model.deconv
    assert deconv.weight.dtype == deconv.bias.dtype == torch.bfloat16
    bn = model.features.features.bn1
    assert (bn.weight == 1).all() and (bn.running_var == 1).all()
    assert (bn.bias == 0).all() and (bn.running_mean == 0).all()
    assert (deconv.bias == 0).all() and (model.rpn_model.cls.head[3].bias == 0).all()
    w = model.features.features.conv1.weight
    assert 0.015 < float(w.detach().std()) < 0.025
    again = bench.fast_init(SiamMaskSharp(width=WIDTH, dtype=torch.bfloat16))
    assert all(torch.equal(a, b) for a, b in zip(model.state_dict().values(),
                                                 again.state_dict().values()))


def _summary(capsys) -> dict:
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_summary_carries_the_five_rows(monkeypatch, capsys):
    seen = []

    def fake_row(name, argv, timeout):
        seen.append(argv)
        return {"metric": f"m_{name}", "value": 1.0, "unit": "fps", "vs_baseline": 0.1}

    monkeypatch.setattr(bench, "_run_row", fake_row)
    assert bench.main([]) == 0
    line = _summary(capsys)
    assert set(line["summary"]) == {name for name, _ in bench._SUMMARY_ROWS}
    assert line["metric"] == "m_scan" and line["value"] == 1.0
    assert all(argv[-2:] == ["--iters", "1024"] for argv in seen)
    assert bench.main(["--summary", "--iters", "320", "--fp32"]) == 0
    _summary(capsys)
    assert seen[-1][-3:] == ["--iters", "320", "--fp32"]


def test_a_failing_row_fails_the_summary(monkeypatch, capsys):
    def fake_row(name, argv, timeout):
        if name == "train_unfrozen":
            raise RuntimeError("rc=1: boom")
        return {"metric": f"m_{name}", "value": 1.0, "unit": "fps", "vs_baseline": 0.1}

    monkeypatch.setattr(bench, "_run_row", fake_row)
    assert bench.run_summary() == 1
    line = _summary(capsys)
    assert line["summary"]["train_unfrozen"] == {"error": "rc=1: boom"}
    assert not any("from_cache" in row or "stale" in row for row in line["summary"].values())


@pytest.mark.parametrize("code,why", [
    ("print('not json')", "rc=0"),
    ("import sys; print('{\"metric\": 1}'); sys.exit(3)", "rc=3"),
    ("import time; time.sleep(30)", "exceeded"),
])
def test_row_process_failures_are_errors(monkeypatch, code, why):
    monkeypatch.setattr(bench, "_row_command", lambda argv: [sys.executable, "-c", code])
    with pytest.raises(RuntimeError, match=why):
        bench._run_row("scan", [], timeout=3.0)


def test_row_process_result_line(monkeypatch):
    code = "import sys; print('noise'); print('{\"metric\": \"m\", \"value\": 2.0}')"
    monkeypatch.setattr(bench, "_row_command", lambda argv: [sys.executable, "-c", code])
    assert bench._run_row("scan", [], timeout=30.0) == {"metric": "m", "value": 2.0}


def test_the_cli_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA card"):
        bench.main(["--scan", "8"])
    proc = subprocess.run([sys.executable, "-m", "siammask_tpu_torch.bench", "--train"],
                          capture_output=True, text=True, timeout=120,
                          env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin",
                               "PYTHONPATH": str(Path(__file__).resolve().parents[1])})
    assert proc.returncode != 0 and not proc.stdout.strip()
