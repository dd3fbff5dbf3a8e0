"""The port's YouTube-VOS scorer (``eval/ytb_vos.py``) against the JAX
package's, on ``test_ytb_vos_eval.py``'s five cases: the seen-category
sources, the end-to-end seen/unseen summary, an object scored only on its
own sparse frames, frames without annotation skipped with a warning, and the
split fallback. Every result and summary is compared with JAX's.
"""
import json
import logging
import shutil

import numpy as np
from PIL import Image

from siammask_tpu.eval import ytb_vos as jytb_vos
from siammask_tpu_torch.eval import ytb_vos
from siammask_tpu_torch.eval.datasets import load_dataset

from test_torch_tracker import one_torch_thread  # noqa: F401  (autouse)
from test_ytb_vos_eval import _make_sparse_ytb_vos, _make_ytb_vos, _square


def _copy_annotations(root, video, tracker, frames, keep=lambda a: a):
    """Result PNGs of ``tracker``: the annotations, through ``keep``."""
    out = root / "test" / "ytb_vos" / tracker / video
    out.mkdir(parents=True)
    for f in frames:
        anno = np.array(Image.open(root / "ytb_vos" / "valid" / "Annotations" / video
                                   / f"{f}.png"))
        Image.fromarray(keep(anno)).save(out / f"{f}.png")


def _both(dataset, root, trackers, **kw):
    """(results, summary, printed lines) from the port's and JAX's scorer."""
    out = []
    for mod in (ytb_vos, jytb_vos):
        bench = mod.YTBVOSBenchmark(dataset, str(root / "test"), data_dir=str(root), **kw)
        results = {}
        for t in trackers:
            results.update(bench.eval(t))
        summary = bench.summarize(results)
        lines = []
        mod.YTBVOSBenchmark.show_result(summary, log=lines.append)
        out.append((results, summary, lines))
    return out


def test_seen_categories_match_jax(tmp_path):
    _make_ytb_vos(tmp_path)
    assert ytb_vos.seen_categories_for(str(tmp_path)) == \
        jytb_vos.seen_categories_for(str(tmp_path)) == {"person", "dog"}
    shutil.rmtree(tmp_path / "ytb_vos" / "train")
    assert ytb_vos.seen_categories_for(str(tmp_path)) is None
    (tmp_path / "ytb_vos" / "valid" / "seen_categories.json").write_text(json.dumps(["cat"]))
    assert ytb_vos.seen_categories_for(str(tmp_path)) == \
        jytb_vos.seen_categories_for(str(tmp_path)) == {"cat"}


def test_ytb_vos_benchmark_matches_jax(tmp_path):
    frames = _make_ytb_vos(tmp_path)
    dataset = load_dataset("ytb_vos", str(tmp_path))
    _copy_annotations(tmp_path, "vidA", "perfect", frames)
    _copy_annotations(tmp_path, "vidA", "object2off", frames, lambda a: a * (a != 2))
    ours, ref = _both(dataset, tmp_path, ("perfect", "object2off"))
    assert ours == ref
    results, summary, _ = ours
    assert summary["perfect"]["overall"] == 1.0
    assert summary["object2off"]["J_unseen"] == 0.0 and summary["object2off"]["overall"] == 0.5
    assert results["perfect"]["vidA"][2]["category"] == "lizard"
    assert not results["perfect"]["vidA"][2]["seen"]


def test_sparse_object_scored_on_its_own_frames_as_jax(tmp_path):
    frames, _ = _make_sparse_ytb_vos(tmp_path)
    dataset = load_dataset("ytb_vos", str(tmp_path))
    out = tmp_path / "test" / "ytb_vos" / "trk" / "vidB"
    out.mkdir(parents=True)
    for i, f in enumerate(frames):
        Image.fromarray(_square(50, 60, 18, 2, _square(10, 10 + 2 * i, 20, 1))).save(
            out / f"{f}.png")
    ours, ref = _both(dataset, tmp_path, ("trk",), seen_categories={"person"})
    assert ours == ref
    assert ours[0]["trk"]["vidB"][2]["J"] == ours[0]["trk"]["vidB"][2]["F"] == 1.0


def test_missing_annotation_frames_skipped_with_warning_as_jax(tmp_path, caplog):
    frames = _make_ytb_vos(tmp_path)
    dataset = load_dataset("ytb_vos", str(tmp_path))
    _copy_annotations(tmp_path, "vidA", "trk", frames)
    (tmp_path / "ytb_vos" / "valid" / "Annotations" / "vidA" / f"{frames[2]}.png").unlink()
    with caplog.at_level(logging.WARNING, logger="siammask_tpu_torch"):
        ours, ref = _both(dataset, tmp_path, ("trk",), seen_categories={"person"})
    warned = [r for r in caplog.records if "no ground-truth annotation" in r.getMessage()]
    assert sorted(r.name for r in warned) == ["siammask_tpu", "siammask_tpu_torch"]
    assert ours == ref
    assert ours[0]["trk"]["vidA"][1]["J"] == ours[0]["trk"]["vidA"][2]["J"] == 1.0


def test_split_fallback_marks_missing_as_jax(tmp_path):
    frames = _make_ytb_vos(tmp_path)
    shutil.rmtree(tmp_path / "ytb_vos" / "train")
    dataset = load_dataset("ytb_vos", str(tmp_path))
    _copy_annotations(tmp_path, "vidA", "trk", frames)
    ours, ref = _both(dataset, tmp_path, ("trk",))
    assert ours == ref
    summary = ours[1]["trk"]
    assert summary["split_source_missing"] is True
    assert summary["J_seen"] == 1.0 and summary["J_unseen"] == 0.0
