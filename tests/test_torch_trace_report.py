"""``siammask_tpu_torch.tools.trace_report`` on a synthetic Chrome trace in
``torch.profiler``'s format (a kernel lane with nested events and gaps, a
copy lane, a user annotation over the kernels, a host lane) and on a real
``torch.profiler`` trace of a width-8 train step on the CPU."""
import gzip
import json
import os

import pytest

from siammask_tpu_torch.models.siammask import SiamMaskBase
from siammask_tpu_torch.tools import trace_report
from siammask_tpu_torch.train.trainer import Trainer

from test_torch_tracker import one_torch_thread  # noqa: F401  (autouse)
from test_torch_train import WIDTH, make_batch, settings_pair

KERNEL_LANE, COPY_LANE, HOST = (0, 7), (0, 13), (4321, 4321)
# (lane, cat, name, ts us, dur us)
EVENTS = [
    (KERNEL_LANE, "kernel", "void depthwise_xcorr_strip_kernel<float, false>(int)", 0, 10),
    (KERNEL_LANE, "kernel", "sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc",
     10, 20),
    # nested in the fprop kernel, whose self time is then 15 us
    (KERNEL_LANE, "kernel",
     "void at::native::vectorized_elementwise_kernel<4, at::native::CUDAFunctor_add<float> >",
     15, 5),
    (KERNEL_LANE, "kernel", "void cudnn::engines_precompiled::nchwToNhwcKernel<__nv_bfloat16>",
     50, 5),
    (KERNEL_LANE, "kernel", "void depthwise_xcorr_strip_bf16x2_kernel<4, true>(int)", 60, 10),
    (KERNEL_LANE, "kernel", "void depthwise_xcorr_grad_kernel_bf16x2_kernel<4>(int)", 100, 8),
    (KERNEL_LANE, "gpu_user_annotation", "my_span", 0, 110),
    (COPY_LANE, "gpu_memcpy", "Memcpy HtoD (Pageable -> Device)", 52, 6),
    (COPY_LANE, "gpu_memset", "Memset (Device)", 120, 2),
    (HOST, "cpu_op", "aten::conv2d", 0, 40),
    (HOST, "cpu_op", "aten::convolution", 1, 38),
]


def synthetic_trace() -> list:
    meta = [{"ph": "M", "name": "process_name", "pid": 0, "tid": 0, "args": {"name": "GPU 0"}},
            {"ph": "M", "name": "process_name", "pid": 4321, "tid": 0,
             "args": {"name": "python3"}},
            {"ph": "M", "name": "thread_name", "pid": 0, "tid": 7, "args": {"name": "stream 7"}},
            {"ph": "M", "name": "thread_name", "pid": 0, "tid": 13,
             "args": {"name": "stream 13"}}]
    flows = [{"ph": "s", "id": 1, "pid": 4321, "tid": 4321, "ts": 0, "cat": "ac2g",
              "name": "ac2g"}]
    return meta + flows + [{"ph": "X", "cat": cat, "name": name, "pid": lane[0],
                            "tid": lane[1], "ts": ts, "dur": dur,
                            "args": {"stream": lane[1]}}
                           for lane, cat, name, ts, dur in EVENTS]


def test_synthetic_trace_self_time_categories_and_idle():
    """Device events only: the annotation and the host lane left out; the
    nested kernel's time taken from its parent; the window 0-122 us, busy
    58 us (the copy overlaps a kernel by 3 us), the three longest gaps."""
    events = synthetic_trace()
    assert trace_report.device_pids(events) == {0: "GPU 0"}
    assert trace_report.op_lane_tids(events, {0: "GPU 0"}) == {KERNEL_LANE, COPY_LANE}
    table = trace_report.report(events)
    assert table["lanes"] == {0: "GPU 0"}
    assert table["total_ms"] == pytest.approx(0.061)
    assert table["window_ms"] == pytest.approx(0.122)
    assert table["busy_ms"] == pytest.approx(0.058)
    assert table["idle_ms"] == pytest.approx(0.064)
    assert table["idle_share"] == pytest.approx(64 / 122)
    assert table["gaps"] == [pytest.approx((0.070, 0.030)), pytest.approx((0.030, 0.020)),
                             pytest.approx((0.108, 0.012))]
    assert [(edge, n) for edge, n, _ in table["gap_bins"]] == [
        (2.0, 0), (10.0, 1), (100.0, 3), (1000.0, 0), (float("inf"), 0)]
    assert [ms for *_, ms in table["gap_bins"]] == pytest.approx([0, 0.002, 0.062, 0, 0])
    expected = {"xcorr strip fwd (fp32, bf16 scalar)": (0.010, 1), "conv fprop": (0.015, 1),
                "elementwise": (0.005, 1), "NCHW<->NHWC transpose": (0.005, 1),
                "xcorr packed bf16 grad-input": (0.010, 1),
                "xcorr packed bf16 grad-kernel": (0.008, 1),
                "device copy / memset": (0.008, 2)}
    got = {cat: (pytest.approx(row["ms"]), row["calls"])
           for cat, row in table["categories"].items()}
    assert got == expected
    assert list(table["categories"])[0] == "conv fprop"
    assert sum(r["share"] for r in table["categories"].values()) == pytest.approx(1.0)
    assert table["ops"]["Memset (Device)"]["args"] == {"stream": 13}


def test_synthetic_trace_every_lane():
    """``all_pids``: every complete event, the annotation and the host's
    nested ops too, each by its self time."""
    table = trace_report.report(synthetic_trace(), all_pids=True)
    ops = {name: row["ms"] for name, row in table["ops"].items()}
    assert ops["my_span"] == pytest.approx(0.110 - 0.053)   # less its direct children
    assert ops["aten::conv2d"] == pytest.approx(0.002)
    assert ops["aten::convolution"] == pytest.approx(0.038)
    assert table["lanes"] == {}


# the program's spans (``utils/trace.py``) and host ops on the host lane,
# over the device events above: gaps 30-50, 58-60, 70-100 and 108-120 us
SPAN_EVENTS = [
    (HOST, "user_annotation", "train.step", 0, 100),
    (HOST, "user_annotation", "train.forward", 0, 45),
    (HOST, "user_annotation", "model.backbone.stem", 35, 10),
    (HOST, "cpu_op", "aten::cudnn_convolution", 36, 8),
    (HOST, "user_annotation", "bench.chunk", 50, 20),       # not the program's
    (HOST, "user_annotation", "train.sync", 80, 10),
    (HOST, "cuda_runtime", "cudaStreamSynchronize", 81, 8),
]


def test_program_spans_self_time_and_idle_by_span(capsys, tmp_path):
    """The program's spans by self time (less the program spans nested in
    them), and each device gap given to the innermost program span open at
    its middle, however long before it opened, with the host op inside it;
    a gap outside every program span is outside the program."""
    events = synthetic_trace() + [
        {"ph": "X", "cat": cat, "name": name, "pid": lane[0], "tid": lane[1], "ts": ts,
         "dur": dur} for lane, cat, name, ts, dur in SPAN_EVENTS]
    table = trace_report.report(events)
    assert {k: (v["calls"], v["ms"], v["self_ms"]) for k, v in table["spans"].items()} == {
        "train.step": (1, pytest.approx(0.100), pytest.approx(0.045)),
        "train.forward": (1, pytest.approx(0.045), pytest.approx(0.035)),
        "model.backbone.stem": (1, pytest.approx(0.010), pytest.approx(0.010)),
        "train.sync": (1, pytest.approx(0.010), pytest.approx(0.010))}
    got = {k: (pytest.approx(v["ms"]), v["gaps"], v["op"])
           for k, v in table["idle_by_span"].items()}
    assert got == {"train.sync": (0.030, 1, "cudaStreamSynchronize"),
                   "model.backbone.stem": (0.020, 1, "aten::cudnn_convolution"),
                   trace_report.OUTSIDE: (0.012, 1, None), "train.step": (0.002, 1, None)}
    assert list(table["idle_by_span"])[0] == "train.sync"
    assert sum(v["ms"] for v in table["idle_by_span"].values()) == \
        pytest.approx(table["idle_ms"])
    path = tmp_path / "spans.json"
    path.write_text(json.dumps({"traceEvents": events}))
    trace_report.main([str(path)])
    out = capsys.readouterr().out
    assert "program span" in out and "device idle by program span" in out
    assert "outside the program" in out and "cudaStreamSynchronize" in out
    # a trace with no program span has neither table
    assert trace_report.report(synthetic_trace())["idle_by_span"] == {}


def test_overlapping_kernels_keep_their_durations():
    """Two kernels on one lane whose stamps overlap by 1 us, then one nested
    in the second: the first keeps its 10 us, the second its 11 us less the
    nested 2 us; the busy time is their union, 20 us."""
    events = [{"ph": "X", "cat": "kernel", "name": name, "pid": 0, "tid": 7, "ts": ts,
               "dur": dur} for name, ts, dur in (("gemm_a", 0, 10), ("gemm_b", 9, 11),
                                                  ("gemm_c", 12, 2))]
    table = trace_report.report(events)
    assert {n: row["ms"] for n, row in table["ops"].items()} == pytest.approx(
        {"gemm_a": 0.010, "gemm_b": 0.009, "gemm_c": 0.002})
    assert table["total_ms"] == pytest.approx(0.021)
    assert table["busy_ms"] == pytest.approx(0.020)


@pytest.mark.parametrize("name, category", [
    ("void depthwise_xcorr_strip_kernel<__nv_bfloat16, false>(int)",
     "xcorr strip fwd (fp32, bf16 scalar)"),
    ("void depthwise_xcorr_strip_kernel<float, true>(int)",
     "xcorr strip grad-input (fp32, bf16 scalar)"),
    ("void depthwise_xcorr_grad_kernel_kernel<float>(int)",
     "xcorr grad-kernel (fp32, bf16 scalar)"),
    ("void depthwise_xcorr_strip_bf16x2_kernel<4, false>(int)", "xcorr packed bf16 fwd"),
    ("ncclDevKernel_AllReduce_Sum_f32_RING_LL(ncclDevComm*)", "collective (nccl)"),
    ("void cudnn::bn_fw_tr_1C11_kernel_NCHW<float, float, int, 512>(int)", "BN"),
    ("void at::native::batch_norm_collect_statistics_kernel<float>(int)", "BN"),
    ("sm80_xmma_wgrad_implicit_gemm_indexed_tf32f32_tf32f32_f32", "conv wgrad"),
    ("void cudnn::detail::dgrad_engine<float, 128, 6, 7, 3, 3, 5, false>(int)", "conv dgrad"),
    ("void implicit_convolve_sgemm<float, float, 128, 5, 5, 3, 3, 3, 1, false>(int)",
     "conv fprop"),
    ("void fft2d_r2c_32x32<float, false, 1u, false>(int)", "conv FFT (any pass)"),
    ("void pointwise_mult_and_sum_complex<float2, 8, 4>(float2*, int)", "conv FFT (any pass)"),
    ("sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n_tilesize64x64x64", "GEMM"),
    ("void at::native::bfloat16_copy_kernel_cuda(at::TensorIteratorBase&)", "dtype cast"),
    ("void at::native::vectorized_elementwise_kernel<4, at::native::direct_copy_kernel_cuda"
     "(at::TensorIteratorBase&)::{lambda()#3}>", "device copy / memset"),
    ("void at::native::reduce_kernel<512, 1, at::native::ReduceOp<float> >(int)",
     "reduce / pool"),
    ("void at::native::max_pool_forward_nchw<float>(int)", "reduce / pool"),
    ("nvjet_tst_128x152_64x6_2x1_v_bz_TNT", "GEMM"),
    ("void at::native::_scatter_gather_elementwise_kernel<128, 8>(int)",
     "gather / scatter / upsample"),
    ("void at::native::upsample_nearest2d_out_frame<c10::BFloat16>(int)",
     "gather / scatter / upsample"),
    ("void at::native::elementwise_kernel<128, 2, at::native::gpu_kernel_impl>(int)",
     "elementwise"),
    ("some_unknown_kernel", "other"),
])
def test_categories(name, category):
    assert trace_report.categorize(name) == category


def test_main_reads_the_newest_trace_under_a_directory(tmp_path, capsys):
    """``main`` on a directory reads its newest trace, gzipped or not, and
    prints the table."""
    older = synthetic_trace()[:4] + [{"ph": "X", "cat": "kernel", "name": "old_kernel",
                                      "pid": 0, "tid": 7, "ts": 0, "dur": 1}]
    (tmp_path / "a").mkdir()
    (tmp_path / "a" / "old.json").write_text(json.dumps({"traceEvents": older}))
    with gzip.open(tmp_path / "new.json.gz", "wt") as f:
        json.dump({"traceEvents": synthetic_trace()}, f)
    os.utime(tmp_path / "a" / "old.json", (1, 1))
    table = trace_report.main([str(tmp_path), "--top", "3", "--long"])
    assert "old_kernel" not in table["ops"]
    out = capsys.readouterr().out
    assert "device lanes: ['GPU 0']" in out and "conv fprop" in out and '"stream": 7' in out
    with pytest.raises(FileNotFoundError):
        trace_report.load_trace_events(str(tmp_path / "a" / "missing"))


def test_real_cpu_trace_of_a_train_step(tmp_path, capsys):
    """A ``torch.profiler`` trace of one width-8 SiamMask-base train step
    on the CPU, exported by ``export_chrome_trace``: no device lane (the
    table of device events raises), so ``main`` falls back to every lane;
    the host ops' self times sum to at most the window, and the convs are
    in their category."""
    from torch.profiler import ProfilerActivity, profile

    _, tbatch = make_batch()
    *_, tset, topt, tlr = settings_pair()
    trainer = Trainer(SiamMaskBase(width=WIDTH), tset, topt, tlr, epochs=2)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        trainer.step(tbatch, 0)
    prof.export_chrome_trace(str(tmp_path / "step.json"))
    events = trace_report.load_trace_events(str(tmp_path))
    assert trace_report.device_pids(events) == {}
    with pytest.raises(ValueError, match="no device events"):
        trace_report.report(events)
    table = trace_report.main([str(tmp_path / "step.json")])
    assert "no device lanes recognized" in capsys.readouterr().out
    assert 0 < table["total_ms"]
    assert table["categories"]["conv fprop"]["calls"] > 0
    assert "aten::conv2d" in table["ops"]
    assert table["busy_ms"] <= table["window_ms"] + 1e-9
