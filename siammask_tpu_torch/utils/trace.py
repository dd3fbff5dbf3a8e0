"""Spans and counters of the program, on the profiler's clock.

The port's layer boundaries (the VOS driver's copies, the tracker's video
and per-frame steps, the captured graph's replays, the trainer's step and
the model's stages) open named spans, and count what crosses them:

- ``span(name, request=None, **counts)``: a context manager, or, without
  ``request`` and counts, a decorator. Spans record only while a
  ``torch.profiler`` session runs (any session: the benchmark's traced
  stretch, ``bench.py --profile-dir``, an operator's own), and never inside
  a CUDA-graph capture (``paused``). Off, a span is one check of the
  profiler's flag: no ``record_function``, no record, no sync.
- While recording, a span enters ``torch.profiler.record_function(name)``,
  so it lies in the Chrome trace's host lane as a ``user_annotation`` event
  beside the kernels and copies, and appends a record to a bounded log
  (``LOG_LIMIT`` records, the oldest dropped): its name, its id, its
  parent's id on this thread, its request (the video frame a VOS chunk
  starts at, the runtime's frame number, the trainer's step number; a child
  takes its parent's), its start and end in Unix ns, and its counts.
  ``time.time_ns`` is the profiler's clock, read just inside the
  annotation: an event's ``ts`` in an exported trace is a record's start in
  us less the trace's ``baseTimeNanoseconds``, to a few us (a process's
  first ``record_function`` sets itself up for ~1 ms in between).
- ``count(name, n)``: adds to the cumulative counters, whether or not a
  session runs, and, while recording, to the innermost open span's counts.
- ``count_device(name, n)``: adds a device tensor's value to a counter on
  its device, with no wait; ``counters()`` reads the sum.
- ``counters()``: a snapshot of the cumulative counters, with the counts
  the program keeps elsewhere read from where their readers read them: the
  xcorr wrappers' ``launches`` and ``packed_launches``
  (``ops/xcorr.py``) and ``_all_reduce.calls`` (``parallel/dist.py``).
- ``uncounted()``: while open, nothing it counts stands (a CUDA graph's
  warm-up, which runs the work its capture counts).
- ``records()`` / ``clear()``: the log as dicts, and emptying it.

Counts: ``h2d_bytes`` (host data handed to the device: frames, VOS chunks)
and ``d2h_bytes`` (device data fetched to the host: the runtime's box,
score and mask, a VOS chunk's masks), counted where the program issues the
transfer, on the CPU too, where nothing is copied; ``host_syncs`` (the
runtime's waits on the device a frame); ``step_graph.captures`` and
``step_graph.evictions`` (``Tracker.step_graph`` under ``MAX_GRAPHS``);
``all_reduce_bytes`` (every collective's payload); ``conv.channels_last``
and ``conv.contiguous`` (the model's conv calls by the memory layout of
their input, ``models/resnet.py`` ``Conv2d``; a captured graph counts its
convs at capture); ``conv.bn_folded`` (the conv -> BN pairs that ran as one
call of the folded conv, ``models/resnet.py`` ``conv_bn``; the same at
capture); ``bn.train_fused`` (the train-mode BNs, each with its add and
ReLU, that ran as ``ops/bn_train.py``'s kernels, ``models/resnet.py``
``trains_fused``; the same at capture); ``train.graph_captures``,
``train.graph_replays`` and ``train.eager_steps`` (``train/trainer.py`` ``Trainer.step``'s two paths,
under its spans ``train.capture`` and ``train.replay``; a training graph's
warm-up is ``uncounted``, so its capture counts the step's convs and xcorr
launches once); ``sam2.memory_keys`` (the keys SAM 2's memory attention
attends, summed over object-frames), and on the device ``sam2.no_object``
and ``sam2.multimask_switch`` (``tracker/sam2.py``). SAM 2's spans are
``sam2.image_encoder``, ``sam2.memory_attention``, ``sam2.mask_decoder``,
``sam2.memory_encoder`` and ``sam2.bank_update`` (eager frames); its
full-bank frames replay a ``StepGraph`` under the ``step_graph`` spans.
TransT's (``models/transt.py``) are ``transt.backbone``, ``transt.fusion.<i>``,
``transt.decoder`` and ``transt.heads`` (eager steps and the template), and
``transt.attn_calls`` counts its attention calls (17 a step; a captured
graph counts at capture, as ``conv.bn_folded``).

A span's name is ``<layer>.<what>``, its layer one of ``LAYERS``: that is
how ``tools/trace_report.py`` tells the program's spans from others.
"""
from __future__ import annotations

import collections
import contextlib
import functools
import itertools
import threading
import time

import torch
from torch.autograd import profiler as _profiler

LAYERS = ("vos", "tracker", "step_graph", "runtime", "train", "dist", "model", "sam2", "transt")
LOG_LIMIT = 200_000

_counters: collections.Counter = collections.Counter()
_device_counts: dict = {}             # name -> a device tensor, summed there
_counters_lock = threading.Lock()     # sync-BN's backward counts on autograd's thread
_log: collections.deque = collections.deque(maxlen=LOG_LIMIT)
_ids = itertools.count()
_local = threading.local()      # .stack: this thread's open records
_paused = 0                     # open ``paused`` blocks (graph captures)


def is_program_span(name: str) -> bool:
    return name.split(".", 1)[0] in LAYERS


class _Record:
    __slots__ = ("name", "id", "parent", "request", "start_ns", "end_ns", "counts")

    def as_dict(self) -> dict:
        out = {k: getattr(self, k) for k in self.__slots__}
        out["counts"] = dict(self.counts)
        return out


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


class _Off:
    """What ``span`` gives while nothing records: a context that does
    nothing, and a decorator whose wrapper checks again at each call."""

    __slots__ = ("name",)

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False

    def __call__(self, fn):
        name = self.name

        @functools.wraps(fn)
        def spanned(*args, **kwargs):
            if not _profiler._is_profiler_enabled:
                return fn(*args, **kwargs)
            with span(name):
                return fn(*args, **kwargs)

        return spanned


_OFF: dict[str, _Off] = {}


class _On:
    __slots__ = ("record", "annotation")

    def __init__(self, name: str, request, counts: dict):
        rec = self.record = _Record()
        rec.name, rec.request, rec.counts = name, request, counts

    def __enter__(self):
        rec, stack = self.record, _stack()
        parent = stack[-1] if stack else None
        rec.id = next(_ids)
        rec.parent = parent.id if parent is not None else None
        if rec.request is None and parent is not None:
            rec.request = parent.request
        rec.end_ns = None
        self.annotation = torch.profiler.record_function(rec.name)
        self.annotation.__enter__()
        rec.start_ns = time.time_ns()
        stack.append(rec)
        _log.append(rec)
        return None

    def __exit__(self, *exc):
        self.record.end_ns = time.time_ns()
        stack = _stack()
        if stack and stack[-1] is self.record:
            stack.pop()
        self.annotation.__exit__(*exc)
        return False

    def __call__(self, fn):
        return _Off(self.record.name)(fn)


def span(name: str, request=None, **counts):
    """A span named ``name`` (the module docstring). As a decorator it takes
    the name alone and decides at each call whether to record."""
    if not _profiler._is_profiler_enabled or _paused:
        off = _OFF.get(name)
        if off is None:
            off = _OFF[name] = _Off(name)
        return off
    return _On(name, request, counts)


class paused:
    """While open, no span records (a CUDA-graph capture: its work runs at
    each replay, not here)."""

    def __enter__(self):
        global _paused
        _paused += 1

    def __exit__(self, *exc):
        global _paused
        _paused -= 1
        return False


@contextlib.contextmanager
def uncounted():
    """While open, counts are taken back when it closes: the cumulative
    counters and the kernel wrappers' launch counts (the xcorr's and the
    train-mode BN's, ``ops/bn_train.py``) stand as they were (a CUDA graph's
    warm-up, whose work the capture counts once)."""
    from siammask_tpu_torch.ops import bn_train

    fns = (*_xcorr_wrappers(), *bn_train.WRAPPERS)
    with _counters_lock:
        saved = _counters.copy()
    launches = [{k: getattr(fn, k) for k in ("launches", "packed_launches") if hasattr(fn, k)}
                for fn in fns]
    try:
        yield
    finally:
        with _counters_lock:
            _counters.clear()
            _counters.update(saved)
        for fn, counts in zip(fns, launches):
            for k, n in counts.items():
                setattr(fn, k, n)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` and, while recording, to the
    innermost open span's counts on this thread."""
    with _counters_lock:
        _counters[name] += n
    if _profiler._is_profiler_enabled:
        stack = getattr(_local, "stack", None)
        if stack:
            counts = stack[-1].counts
            counts[name] = counts.get(name, 0) + n


def count_device(name: str, n: torch.Tensor) -> None:
    """Add the device value ``n`` to the counter ``name`` on its device, in
    place and with no wait: ``counters()`` reads the sum (one wait there).
    A CUDA-graph capture records the addition, so each replay counts; while
    ``paused`` outside a capture (a graph's warm-up) nothing is counted."""
    if _paused and not (n.is_cuda and torch.cuda.is_current_stream_capturing()):
        return
    with _counters_lock:
        total = _device_counts.get(name)
        if total is None:
            _device_counts[name] = n.detach().long().clone()
        else:
            total.add_(n.detach())


def _xcorr_wrappers() -> tuple:
    from siammask_tpu_torch.ops import xcorr

    return (xcorr.depthwise_xcorr, xcorr.depthwise_xcorr_grad_input,
            xcorr.depthwise_xcorr_grad_kernel)


def counters() -> dict:
    """The cumulative counters, and the xcorr wrappers' launch counts and
    ``_all_reduce.calls`` as their attributes hold them."""
    from siammask_tpu_torch.parallel.dist import _all_reduce

    with _counters_lock:
        out = dict(_counters)
        device = dict(_device_counts)
    for name, n in device.items():
        out[name] = out.get(name, 0) + int(n)
    for fn in _xcorr_wrappers():
        out[f"{fn.__name__}.launches"] = fn.launches
        out[f"{fn.__name__}.packed_launches"] = fn.packed_launches
    out["_all_reduce.calls"] = _all_reduce.calls
    return out


def records() -> list[dict]:
    """The log, oldest first: ``name``, ``id``, ``parent`` (an id or None),
    ``request``, ``start_ns``, ``end_ns`` (None while open) and ``counts``."""
    return [r.as_dict() for r in list(_log)]


def clear() -> None:
    """Empty the log (the counters run on)."""
    _log.clear()
