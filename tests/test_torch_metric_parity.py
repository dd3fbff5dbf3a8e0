"""The metric-level parity harness: the port against the JAX package through
the VOT reset protocol and VOS fusion, on the CPU.

- The width-8 link (``scripts/metric_parity_jax.py``'s functions in
  process, a shortened benchmark of FRAMES clip frames, two videos of
  3 * FRAMES - 3): the JAX tracker (Pallas xcorr in interpret mode, the plain
  lowerings) makes the benchmark from its no-reset runs; then the JAX
  drivers and the port's run the VOT protocol in box mode and VOS on it.
  The two result trees hold the same marker lines, so the same lost and
  reset frames, and regions within 1e-2 px; the forced failures land in
  both windows of both videos; each tree scored by the JAX eval and by the
  port's gives the same numbers to the last bit; the tracker deltas are
  those of ``tests/test_metric_parity_slow.py`` (lost and robustness 0,
  accuracy under 0.02), J and F within 1e-3.
- The tool's parts: ``orders``, ``displace_gt`` and ``rect_poly`` against
  ``tools/metric_parity.py``'s, read from its source (importing it reaches
  for the PyTorch 0.4 checkout); the benchmark's layout as both packages'
  ``load_dataset`` read it; ``temper``; the tool's CLI on the CPU against
  the port's tree; its card default and its refusal without a card.
- The full-width link (``slow``, outside tier-1): box mode at width 64 with
  the slow JAX test's assertions.
"""
import ast
import json
import os
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from siammask_tpu.eval.datasets import load_dataset as jax_load_dataset
from siammask_tpu_torch.eval.datasets import VOTDataset, load_dataset
from siammask_tpu_torch.tools import metric_parity as mp
from siammask_tpu_torch.tracker.runtime import TrackerRuntime

from test_torch_tracker import one_torch_thread  # noqa: F401  (autouse)

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO / "scripts"))
import metric_parity_jax as mpj  # noqa: E402

WIDTH = 8
FRAMES = 36                 # videos of 105 frames: the EAO interval keeps support
SLOW_FRAMES = 70            # the full-width link's: the whole clip
MARKERS = ("0", "1", "2")


def _quiet(*_):
    pass


def _run_link(work: Path, frames: int, width: int, vos: bool) -> dict:
    """The JAX link in process: benchmark, both trees (box-mode VOT, and
    VOS with ``vos``), both scored by both toolkits."""
    bench, weights = mpj.prepare(str(work), frames, width, log=_quiet)
    results = str(work / "results")
    mpj.run_jax(bench, weights, width, results, vot_mask=False, vos=vos, log=_quiet)
    mp.run_drivers(weights, width, "cpu", bench, results, "port", vot_mask=False, vos=vos,
                   log=_quiet)
    out = mpj.report(bench, results, mpj.score_both(bench, results, vos))
    return {"bench": bench, "weights": weights, "results": results, "out": out}


@pytest.fixture(scope="module")
def link(tmp_path_factory) -> dict:
    return _run_link(tmp_path_factory.mktemp("link"), FRAMES, WIDTH, vos=True)


def _lines(results: str, tree: str, video: str) -> list[str]:
    return (Path(results) / "VOT2018" / tree / "baseline" / video /
            f"{video}_001.txt").read_text().splitlines()


def _same_lines(link: dict, frames: int) -> None:
    """The same marker lines, so the same lost and reset frames, and the
    regions within 1e-2 px."""
    out = link["out"]
    assert out["trees"]["same_decisions"]
    assert out["decisions"]["jax"] == out["decisions"]["port"]
    for video in ("v0", "v1"):
        ours, ref = _lines(link["results"], "port", video), _lines(link["results"], "jax", video)
        assert len(ours) == len(ref) == 3 * frames - 3
        for a, b in zip(ours, ref):
            if b in MARKERS or a in MARKERS:
                assert a == b
            else:
                np.testing.assert_allclose(np.array(a.split(","), float),
                                           np.array(b.split(","), float), rtol=0, atol=1e-2)


def _forced_failures(link: dict, frames: int) -> None:
    """A lost frame in each failure window of each video, in both trees."""
    for tree, videos in link["out"]["decisions"].items():
        for video, d in videos.items():
            for k in mp.fail_windows(3 * frames - 3):
                assert any(k <= f < k + mp.FAIL_LEN for f in d["lost_frames"]), (tree, video, k)


def _eval_deltas_zero(link: dict) -> None:
    """Each tree scored by the JAX eval and by the port's: the same numbers."""
    for tree, ev in link["out"]["eval_deltas"].items():
        for metric, delta in ev.items():
            assert delta == 0.0, (tree, metric, delta)
    for s in link["out"]["scores"].values():
        assert all(np.isfinite(v) for v in s["port_eval"].values())


def _tracker_deltas(link: dict) -> None:
    d = link["out"]["tracker_deltas"]
    assert d["lost"] == 0.0 and d["robustness"] == 0.0 and d["accuracy"] < 0.02


def test_jax_link_same_marker_lines_and_regions(link):
    _same_lines(link, FRAMES)


def test_jax_link_forced_failures_in_both_windows(link):
    _forced_failures(link, FRAMES)
    assert link["out"]["scores"]["jax"]["port_eval"]["lost"] == 4.0


def test_jax_link_eval_deltas_are_zero(link):
    _eval_deltas_zero(link)


def test_jax_link_tracker_deltas(link):
    _tracker_deltas(link)
    d = link["out"]["tracker_deltas"]
    assert d["J"] < 1e-3 and d["F"] < 1e-3


# ---------------- the tool's parts ----------------

def _jax_tool_functions() -> dict:
    """``_orders``, ``_rect_poly``, ``_displace_gt`` and their constants from
    ``tools/metric_parity.py``'s source."""
    tree = ast.parse((REPO / "tools" / "metric_parity.py").read_text())
    keep = [node for node in tree.body
            if (isinstance(node, ast.FunctionDef)
                and node.name in ("_orders", "_rect_poly", "_displace_gt"))
            or (isinstance(node, ast.Assign)
                and {t.id for t in node.targets} & {"FAIL_WINDOWS", "DISPLACE"})]
    namespace: dict = {}
    exec(compile(ast.Module(body=keep, type_ignores=[]), "tools/metric_parity.py", "exec"),
         namespace)
    return namespace


def test_benchmark_functions_match_the_jax_tool():
    ref = _jax_tool_functions()
    assert mp.FAIL_WINDOWS == ref["FAIL_WINDOWS"] and mp.DISPLACE == ref["DISPLACE"]
    for n in (70, 36, 12):
        assert mp.orders(n) == ref["_orders"](n)
    assert [len(o) for o in mp.orders(70).values()] == [207, 207]
    rng = np.random.RandomState(0)
    for _ in range(5):
        pos, sz = rng.uniform(50, 400, 2), rng.uniform(10, 200, 2)
        assert mp.rect_poly(pos, sz) == ref["_rect_poly"](pos, sz)
    gt = [mp.rect_poly(rng.uniform(50, 400, 2), rng.uniform(10, 200, 2)) for _ in range(207)]
    assert mp.displace_gt(gt) == ref["_displace_gt"](gt)
    assert mp.fail_windows(207) == (60, 140) and mp.fail_windows(105) == (30, 71)


def test_benchmark_layout_reads_in_both_packages(link):
    """Both packages' ``load_dataset`` read the same VOT and DAVIS videos;
    the JSON's gt is the text files'; the frames are the clip's files in the
    videos' orders, byte for byte; the VOS video's first annotation is the
    init box, the others the JAX run's masks over seg_thr."""
    bench = Path(link["bench"])
    clip = bench.parent / "clip"
    settings = json.loads((bench / mp.SETTINGS).read_text())
    assert settings["frames"] == FRAMES and (bench / mp.WEIGHTS).exists()
    ours, ref = load_dataset("VOT2018", str(bench)), jax_load_dataset("VOT2018", str(bench))
    ds = VOTDataset("VOT2018", str(bench / "VOT2018"))
    orders = mp.orders(FRAMES)
    assert list(ours) == list(ref) == list(orders)
    for name, order in orders.items():
        assert ours[name]["image_files"] == ref[name]["image_files"]
        np.testing.assert_array_equal(ours[name]["gt"], ref[name]["gt"])
        np.testing.assert_array_equal(np.array(ds[name].gt_traj), ours[name]["gt"])
        for i in (0, len(order) // 2, len(order) - 1):
            assert (Path(ours[name]["image_files"][i]).read_bytes()
                    == (clip / f"{order[i]:05d}.jpg").read_bytes())
        k = mp.fail_windows(len(order))[0]
        np.testing.assert_allclose(ours[name]["gt"][k] - ours[name]["gt"][k - 1],
                                   mp.DISPLACE, atol=50)
    vos, jvos = load_dataset("DAVIS2016", str(bench)), jax_load_dataset("DAVIS2016", str(bench))
    assert list(vos) == list(jvos) == [mp.VOS_VIDEO]
    video = vos[mp.VOS_VIDEO]
    assert video == jvos[mp.VOS_VIDEO] and len(video["anno_files"]) == FRAMES
    from PIL import Image
    annos = [np.array(Image.open(f)) for f in video["anno_files"]]
    pos, sz = mp.init_box(0)
    assert annos[0].sum() == int(sz[0]) * int(sz[1])
    assert annos[0][int(pos[1]), int(pos[0])] == 1
    assert all(a.max() <= 1 and a.sum() > 0 for a in annos[1:])


def test_temper_gives_finite_weights_and_masks(link):
    """The tempered weights: finite, mask logits of std in (0.05, 20) (the
    tool's own check), and a mask over seg_thr at the clip's first box."""
    model = mp.load_model(link["weights"], WIDTH, "cpu")
    assert all(bool(torch.isfinite(v).all()) for v in model.state_dict().values()
               if v.is_floating_point())
    frames = mp.read_clip(str(Path(link["bench"]).parent / "clip"), 2)
    mp.temper(model, frames[0])         # raises unless the logits are in range
    runtime = TrackerRuntime(model, mp.tracker_config(), "cpu")
    runtime.init(frames[0], *mp.init_box(0))
    out = runtime.track(frames[1])
    assert (out["mask"] > mp.HP["seg_thr"]).sum() > 100
    assert np.all(np.isfinite(out["target_pos"])) and out["polygon"].shape == (4, 2)


def test_tool_cli_on_the_cpu_against_the_port_tree(link, tmp_path):
    """``main`` on the link's benchmark in box mode on the CPU, compared
    with the link's port tree: the same run, so the same decisions, overlap
    1 and every delta 0."""
    out_json = tmp_path / "out.json"
    out = mp.main(["--device", "cpu", "--width", str(WIDTH), "--box-only", "--benchmark",
                   link["bench"], "--work-dir", str(tmp_path), "--json-out", str(out_json),
                   "--compare", str(Path(link["results"]) / "VOT2018" / "port")], log=_quiet)
    assert json.loads(out_json.read_text())["scores"]["lost"] == out["scores"]["lost"] == 4.0
    cmp = out["compare"]
    assert cmp["same_decisions"] and cmp["iou_mean"] == 1.0
    assert cmp["frames_compared"] > 150
    assert all(v == 0.0 for v in cmp["deltas"].values())
    assert out["scores"]["eao"] == link["out"]["scores"]["port"]["port_eval"]["eao"]


def test_tool_runs_on_the_card_by_default(monkeypatch, tmp_path):
    assert mp.parse_args(["--make-benchmark"]).device == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="--device cpu"):
        mp.run(mp.parse_args(["--make-benchmark", "--work-dir", str(tmp_path / "w")]))
    assert not (tmp_path / "w").exists()


# ---------------- full width ----------------

@pytest.mark.slow
def test_jax_link_full_width_box_mode(tmp_path):
    """Box mode at width 64 on SLOW_FRAMES clip frames: the slow JAX
    test's bounds (lost and robustness deltas 0, accuracy under 0.02, eval
    deltas 0) and the same decisions."""
    threads = torch.get_num_threads()
    torch.set_num_threads(os.cpu_count() or 1)      # the module runs one thread
    try:
        link = _run_link(tmp_path, SLOW_FRAMES, 64, vos=False)
    finally:
        torch.set_num_threads(threads)
    _same_lines(link, SLOW_FRAMES)
    _forced_failures(link, SLOW_FRAMES)
    _eval_deltas_zero(link)
    _tracker_deltas(link)
    print(json.dumps({k: link["out"][k] for k in ("tracker_deltas", "eval_deltas", "trees",
                                                  "decisions", "scores")}))
