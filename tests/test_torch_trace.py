"""The port's spans and counters (``siammask_tpu_torch/utils/trace.py``) on
the CPU: nothing recorded without a profiler; nesting, requests and counts
under one; the records on the exported trace's clock; the span trees of a
width-8 float32 VOS run, a training step (one process, and a world-1 gloo
group for the gradient exchange) and ``TrackerRuntime.track``; the counted
bytes and host syncs; the counters read from their attributes; and the
benchmark's three readers of the log (``perfbench/metrics/``)."""
import importlib.util
import json
import socket
import types
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.profiler import ProfilerActivity, profile

from siammask_tpu_torch.config import TrackerConfig
from siammask_tpu_torch.eval.datasets import load_dataset
from siammask_tpu_torch.models.siammask import SiamMaskBase, SiamMaskSharp
from siammask_tpu_torch.ops import xcorr
from siammask_tpu_torch.parallel import dist as pdist
from siammask_tpu_torch.tracker import vos
from siammask_tpu_torch.tracker.runtime import TrackerRuntime
from siammask_tpu_torch.tracker.tracker import Tracker
from siammask_tpu_torch.train.trainer import OptimizerConfig, Trainer, TrainSettings
from siammask_tpu_torch.utils import trace

from test_torch_tracker import one_torch_thread  # noqa: F401  (autouse)
from test_vos_e2e import HP, _make_ytb_vos_valid

WIDTH = 8
METRICS = Path(__file__).resolve().parents[1] / "perfbench" / "metrics"
H, W = 120, 160
BACKBONE = (["model.backbone.stem"]
            + [f"model.backbone.layer{i}.{j}" for i, n in ((1, 3), (2, 4), (3, 6))
               for j in range(n)] + ["model.neck"])


@pytest.fixture(autouse=True)
def empty_log():
    trace.clear()
    yield
    trace.clear()


def _profiled(fn, path=None):
    """``fn()`` under a CPU profiler session (the trace exported to
    ``path`` when given); returns what ``fn`` returned."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    if path is not None:
        prof.export_chrome_trace(str(path))
    return out


def _children(log, rec):
    return [r for r in log if r["parent"] == rec["id"]]


def _frames(n, seed=0):
    return np.random.RandomState(seed).randint(0, 256, (n, H, W, 3)).astype(np.uint8)


def _sharp():
    return SiamMaskSharp(width=WIDTH).init_weights(torch.Generator().manual_seed(0)).eval()


def test_off_without_a_profiler(monkeypatch):
    """No session: ``span`` enters no ``record_function`` and records
    nothing, as a context or a decorator; ``count`` still counts."""
    def refuse(*_):
        raise AssertionError("record_function entered with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    before = trace.counters().get("test.things", 0)

    @trace.span("train.decorated")
    def work(x):
        trace.count("test.things", 2)
        return x + 1

    with trace.span("train.outer", request=3, frames=2):
        assert work(1) == 2
    assert trace.records() == []
    assert trace.span("train.a") is trace.span("train.a")      # nothing made per call
    assert trace.counters()["test.things"] == before + 2
    assert work.__name__ == "work"


def test_nesting_requests_and_counts_under_a_profiler():
    """Parents, requests (given, else the parent's), counts at the open and
    from ``count`` into the innermost span; a paused block records nothing;
    the decorator records at call time."""
    @trace.span("train.decorated")
    def work():
        trace.count("h2d_bytes", 5)

    def run():
        with trace.span("vos.outer", request=7, frames=3):
            trace.count("d2h_bytes", 10)
            with trace.span("vos.inner"):
                trace.count("d2h_bytes", 1)
                trace.count("d2h_bytes", 2)
            with trace.paused(), trace.span("vos.hidden"):
                trace.count("h2d_bytes", 4)
            work()
        with trace.span("vos.other", request=8):
            pass

    _profiled(run)
    log = trace.records()
    assert [r["name"] for r in log] == ["vos.outer", "vos.inner", "train.decorated",
                                        "vos.other"]
    outer, inner, decorated, other = log
    assert outer["parent"] is None and other["parent"] is None
    assert inner["parent"] == decorated["parent"] == outer["id"]
    assert [r["request"] for r in log] == [7, 7, 7, 8]
    assert outer["counts"] == {"frames": 3, "d2h_bytes": 10, "h2d_bytes": 4}
    assert inner["counts"] == {"d2h_bytes": 3}
    assert decorated["counts"] == {"h2d_bytes": 5}
    assert all(r["start_ns"] <= c["start_ns"] <= c["end_ns"] <= r["end_ns"]
               for r in (outer,) for c in (inner, decorated))
    assert outer["end_ns"] <= other["start_ns"]


def test_records_lie_on_the_trace_clock(tmp_path):
    """Each span is a ``user_annotation`` event of the exported trace, its
    record's start within 50 us of the event's ``ts`` (on the trace's base).
    A process's first ``record_function`` sets itself up for ~1 ms inside
    the call, after the event's stamp: a session before makes that."""
    def warm():
        with trace.span("train.warm"):
            pass

    _profiled(warm)
    trace.clear()

    def run():
        for i in range(5):
            with trace.span("train.step", request=i), trace.span("train.sync"):
                torch.ones(64, 64).sum()

    _profiled(run, tmp_path / "t.json")
    data = json.loads((tmp_path / "t.json").read_text())
    base_us = data.get("baseTimeNanoseconds", 0) / 1e3
    events = [e for e in data["traceEvents"] if e.get("cat") == "user_annotation"]
    for name in ("train.step", "train.sync"):
        ts = sorted(float(e["ts"]) for e in events if e["name"] == name)
        starts = [r["start_ns"] / 1e3 - base_us for r in trace.records() if r["name"] == name]
        assert len(ts) == len(starts) == 5
        assert max(abs(a - b) for a, b in zip(ts, starts)) < 50


def test_vos_span_tree(tmp_path):
    """The batched VOS driver on a ranged ytb_vos video (object 2 starts at
    frame 2) in 2-frame windows: frame reads, uploads, the video steps (on
    the CPU a span a frame, the model's stages inside), the copies, the
    re-init between windows and the merges, with the video frame each
    window starts at as its request and the bytes of what crosses."""
    _make_ytb_vos_valid(tmp_path)
    video = load_dataset("ytb_vos", str(tmp_path))["vid"]
    runtime = TrackerRuntime(_sharp(), TrackerConfig().update(HP), "cpu")
    before = trace.counters()
    _profiled(lambda: vos.track_vos_batched(runtime, video, log=lambda *_: None,
                                            scan_chunk=2))
    log = trace.records()
    roots = [r for r in log if r["parent"] is None]
    assert [(r["name"], r["request"]) for r in roots] == [
        ("tracker.init_batched", 0), ("vos.read_frames", 1), ("vos.upload", None),
        ("tracker.track_video_multi", 1),
        ("vos.copy_to_host", None), ("vos.reinit", None),
        ("vos.read_frames", 3), ("vos.upload", None), ("tracker.track_video_multi", 3),
        ("vos.materialize", None), ("vos.copy_to_host", None), ("vos.materialize", None)]
    h, w = H, W
    for r in roots:
        kids = [c["name"] for c in _children(log, r)]
        if r["name"] == "tracker.track_video_multi":
            assert r["counts"] == {"frames": 2, "objects": 2}
            steps = _children(log, r)
            assert [(c["name"], c["request"]) for c in steps] == [
                ("tracker.step_batched", r["request"]),
                ("tracker.step_batched", r["request"] + 1)]
            for step in steps:
                assert [c["name"] for c in _children(log, step)] == \
                    BACKBONE + ["model.rpn", "model.mask", "model.refine"]
        elif r["name"] == "vos.upload":
            assert kids == [] and r["counts"] == {"h2d_bytes": 2 * h * w * 3}
        elif r["name"] == "vos.copy_to_host":
            assert r["counts"] == {"d2h_bytes": 2 * 2 * h * w * 4}     # (T, O, H, W) float32
        elif r["name"] == "vos.reinit":             # the late object's template pass
            assert kids == ["tracker.init_batched"]
            assert [c["name"] for c in _children(log, _children(log, r)[0])] == BACKBONE
    after = trace.counters()
    assert after["h2d_bytes"] - before.get("h2d_bytes", 0) == 4 * h * w * 3 + h * w * 3
    assert after["d2h_bytes"] - before.get("d2h_bytes", 0) == 2 * 2 * 2 * h * w * 4


def test_runtime_span_tree_syncs_and_bytes():
    """``TrackerRuntime.track``: the step, the fetches and the polygon
    under one span a frame, the runtime's frame number as its request; four
    host syncs a frame; the bytes are the frame's and the fetched
    tensors'."""
    frames = _frames(4)
    runtime = TrackerRuntime(_sharp(), TrackerConfig().update(HP), "cpu")
    runtime.init(frames[0], (80.0, 60.0), (40.0, 30.0))
    before = trace.counters()
    _profiled(lambda: [runtime.track(im, soft_mask=i % 2 == 0)
                       for i, im in enumerate(frames[1:])])
    log = trace.records()
    roots = [r for r in log if r["parent"] is None]
    assert [(r["name"], r["request"]) for r in roots] == [("runtime.track", i)
                                                          for i in (1, 2, 3)]
    for i, r in enumerate(roots):
        kids = _children(log, r)
        assert [c["name"] for c in kids] == ["tracker.step", "runtime.fetch", "runtime.polygon"]
        assert all(c["request"] == r["request"] for c in kids)
        mask_bytes = H * W * (4 if i % 2 == 0 else 1)
        assert kids[0]["counts"] == {"h2d_bytes": H * W * 3}
        assert kids[1]["counts"] == {"host_syncs": 4, "d2h_bytes": 8 + 8 + 4 + mask_bytes}
    after = trace.counters()
    assert after["host_syncs"] - before.get("host_syncs", 0) == 4 * 3


def _batch(b=2, seed=0):
    g = torch.Generator().manual_seed(seed)
    k, s = 5, 25

    def rand(*shape):
        return torch.rand(shape, generator=g)

    u = rand(b, k, s, s)
    return {"template": 255 * rand(b, 3, 127, 127), "search": 255 * rand(b, 3, 255, 255),
            "label_cls": torch.where(u < 0.8, -1, torch.where(u < 0.95, 0, 1)).long(),
            "label_loc": 0.1 * torch.randn((b, 4, k, s, s), generator=g),
            "label_loc_weight": (rand(b, k, s, s) < 0.1).float(),
            "label_mask": torch.sign(torch.randn((b, 255, 255), generator=g)),
            "label_mask_weight": (rand(b, s, s) < 0.2).float()}


def _trainer(distributed=False):
    model = SiamMaskBase(width=WIDTH).init_weights(torch.Generator().manual_seed(0))
    return Trainer(model, TrainSettings(task="base", loss_weight=(1.0, 1.2, 36.0)),
                   OptimizerConfig(), np.full(4, 1e-3), 4, unfreeze_at=0.5,
                   distributed=distributed)


TRAIN_STEP = ["train.prepare", "train.forward", "train.loss", "train.backward", "train.clip",
              "train.sync", "train.optimizer"]


def test_train_span_tree():
    """Two ``Trainer.step`` calls: a ``train.step`` each with its step number,
    its phases in order with one ``train.sync``, and the forward split at
    the model's stages (template, then search, then the heads)."""
    trainer, batch = _trainer(), _batch()
    trainer.step(batch, 3)
    _profiled(lambda: [trainer.step(batch, 3) for _ in range(2)])
    log = trace.records()
    roots = [r for r in log if r["parent"] is None]
    assert [(r["name"], r["request"]) for r in roots] == [("train.step", 1), ("train.step", 2)]
    for r in roots:
        kids = _children(log, r)
        assert [c["name"] for c in kids] == TRAIN_STEP
        forward = kids[1]
        assert [c["name"] for c in _children(log, forward)] == \
            BACKBONE + BACKBONE + ["model.rpn", "model.mask"]


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_train_exchange_bytes_and_calls():
    """Under a world-1 gloo group the step exchanges its gradients in a
    ``train.exchange`` span: ``dist.all_reduce_tensors`` spans (the
    gradients, then the metrics) with a call and their bytes each; the
    counters read ``_all_reduce.calls`` as it stands, and
    ``all_reduce_bytes`` holds every collective's payload."""
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{_free_port()}", rank=0,
                            world_size=1)
    try:
        trainer, batch = _trainer(distributed=True), _batch()
        calls0, bytes0 = pdist._all_reduce.calls, trace.counters().get("all_reduce_bytes", 0)
        _profiled(lambda: trainer.step(batch, 3))
        log = trace.records()
        step = next(r for r in log if r["name"] == "train.step")
        names = [c["name"] for c in _children(log, step)]
        assert names == TRAIN_STEP[:4] + ["train.exchange"] + TRAIN_STEP[4:]
        exchange = next(c for c in _children(log, step) if c["name"] == "train.exchange")
        reduces = _children(log, exchange)
        grads = sum(p.numel() * 4 for g in trainer.optimizer.param_groups for p in g["params"])
        n_metrics = 8           # cls, loc, mask, three IoUs, overflow, total; float64
        assert [c["counts"] for c in reduces] == [
            {"calls": 1, "all_reduce_bytes": grads},
            {"calls": 1, "all_reduce_bytes": 8 * n_metrics}]
        counted = trace.counters()
        assert counted["_all_reduce.calls"] == pdist._all_reduce.calls > calls0 + 2
        # sync-BN's statistics and the loss normalizers go over too
        assert counted["all_reduce_bytes"] - bytes0 > grads + 8 * n_metrics
    finally:
        dist.destroy_process_group()


def test_counts_from_many_threads_add_up():
    """``count`` from more threads than cores, switching often: no update
    is lost."""
    import sys
    import threading

    threads, each = 16, 2000
    before = trace.counters().get("test.threads", 0)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        workers = [threading.Thread(target=lambda: [trace.count("test.threads")
                                                    for _ in range(each)])
                   for _ in range(threads)]
        for w in workers:
            w.start()
        for w in workers:
            w.join(timeout=60)
        assert not any(w.is_alive() for w in workers)
    finally:
        sys.setswitchinterval(interval)
    assert trace.counters()["test.threads"] - before == threads * each


def test_counters_read_the_existing_attributes(monkeypatch):
    for fn, n in ((xcorr.depthwise_xcorr, 5), (xcorr.depthwise_xcorr_grad_input, 6),
                  (xcorr.depthwise_xcorr_grad_kernel, 7)):
        monkeypatch.setattr(fn, "launches", n)
        monkeypatch.setattr(fn, "packed_launches", n - 1)
    monkeypatch.setattr(pdist._all_reduce, "calls", 11)
    counted = trace.counters()
    assert {k: v for k, v in counted.items() if "launches" in k or k.endswith(".calls")} == {
        "depthwise_xcorr.launches": 5, "depthwise_xcorr.packed_launches": 4,
        "depthwise_xcorr_grad_input.launches": 6,
        "depthwise_xcorr_grad_input.packed_launches": 5,
        "depthwise_xcorr_grad_kernel.launches": 7,
        "depthwise_xcorr_grad_kernel.packed_launches": 6, "_all_reduce.calls": 11}


def _reader(name):
    spec = importlib.util.spec_from_file_location(f"reader_{name}", METRICS / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def _run(units, objects=None, copy_s=None):
    traffic = {"objects": objects} if objects else {}
    return types.SimpleNamespace(
        units=units, cell=types.SimpleNamespace(ctx=types.SimpleNamespace(traffic=traffic)),
        trace=None if copy_s is None else {"categories": {"host<->device copy": copy_s}})


def test_vos_readers():
    """``host_issue_ms.vos`` and ``copy_gbps.vos`` on the log of two chunks
    through the calls the benchmark's VOS cell makes, and a fake trace;
    None from an empty log."""
    host_issue, copy_gbps = _reader("host_issue_ms.vos"), _reader("copy_gbps.vos")
    tracker = Tracker(_sharp(), TrackerConfig().update(HP), "cpu")
    frames = _frames(5)
    states = tracker.init_batched(frames[0], np.array([[80.0, 60.0], [40.0, 50.0]], np.float32),
                                  np.array([[40.0, 30.0], [30.0, 30.0]], np.float32))

    def chunks():
        nonlocal states
        for c in range(2):
            states, outs = tracker.track_video_multi(
                states, vos._upload(frames[1 + 2 * c:3 + 2 * c], tracker.device))
            vos._start_copy_to_host(outs.mask_in_frame)

    _profiled(chunks)
    log = trace.records()
    roots = [r for r in log if r["parent"] is None]
    assert [r["name"] for r in roots] == ["vos.upload", "tracker.track_video_multi",
                                          "vos.copy_to_host"] * 2
    run = _run(units=2 * 2 * 2, objects=2, copy_s=0.002)
    host_ms = sum(r["end_ns"] - r["start_ns"] for r in roots) / 1e6
    assert host_issue(run) == pytest.approx(host_ms / 4)
    moved = 4 * H * W * 3 + 4 * 2 * H * W * 4
    assert copy_gbps(run) == pytest.approx(moved / 1e9 / 0.002)
    assert copy_gbps(_run(8, 2, copy_s=None)) is None
    trace.clear()
    assert host_issue(run) is None and copy_gbps(run) is None


def test_train_reader():
    """``host_issue_ms.train``: each ``train.step``'s time less its
    ``train.sync``, a step on average; None from an empty log."""
    read = _reader("host_issue_ms.train")
    trainer, batch = _trainer(), _batch()
    _profiled(lambda: [trainer.step(batch, 3) for _ in range(2)])
    log = trace.records()
    steps = [r for r in log if r["name"] == "train.step"]
    syncs = [r for r in log if r["name"] == "train.sync"]
    assert len(steps) == len(syncs) == 2

    def dur(r):
        return r["end_ns"] - r["start_ns"]

    want = (sum(map(dur, steps)) - sum(map(dur, syncs))) / 1e6 / 2
    assert read(_run(2)) == pytest.approx(want)
    assert 0 < want < sum(map(dur, steps)) / 1e6 / 2
    trace.clear()
    assert read(_run(2)) is None
