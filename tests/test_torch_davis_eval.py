"""The port's DAVIS J&F evaluator (``eval/davis.py``) against the JAX
package's: J, ``seg2bmap``, the L2 disk and F exact on the seeded blobs of
``test_davis_eval.py`` and on hand-checkable squares, the toolkit statistics,
and ``DAVISBenchmark`` summaries on a synthetic DAVIS2016 and DAVIS2017
layout with saved result masks.
"""
import numpy as np
import pytest
from PIL import Image

from siammask_tpu.eval import davis as jdavis
from siammask_tpu_torch.eval import davis
from siammask_tpu_torch.eval.datasets import load_dataset

from test_davis_eval import _square
from test_torch_tracker import one_torch_thread  # noqa: F401  (autouse)
from test_vos_e2e import _make_davis


def _blobs(seed, h=120, w=214):
    """test_davis_eval.py's blobby masks: thresholded blurred noise."""
    import cv2

    rng = np.random.RandomState(seed)
    return [cv2.GaussianBlur(rng.rand(h, w).astype(np.float32), (31, 31), 8) > 0.5
            for _ in range(2)]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_j_seg2bmap_and_f_are_exact_against_jax(seed):
    fg, gt = _blobs(seed)
    assert fg.any() and gt.any()
    for m in (fg, gt):
        np.testing.assert_array_equal(davis.seg2bmap(m), jdavis.seg2bmap(m))
    assert davis.db_eval_iou(fg, gt) == jdavis.db_eval_iou(fg, gt)
    for bound_th in (0.008, 0.02):
        assert davis.db_eval_boundary(fg, gt, bound_th) == jdavis.db_eval_boundary(fg, gt,
                                                                                   bound_th)
    assert 0 < davis.db_eval_boundary(fg, gt) < 1


def test_squares_disk_and_statistics_match_jax():
    a, b, c = (_square(200, 200, *args) for args in ((50, 50, 60), (50, 51, 60), (120, 120, 60)))
    empty = np.zeros((200, 200))
    for x, y in ((a, a), (a, b), (a, c), (empty, empty), (empty, a)):
        assert davis.db_eval_iou(x, y) == jdavis.db_eval_iou(x, y)
        assert davis.db_eval_boundary(x, y) == jdavis.db_eval_boundary(x, y)
    assert davis.db_eval_boundary(a, b) == 1.0 and davis.db_eval_boundary(a, c) == 0.0
    for r in (0, 1, 3, 7):
        np.testing.assert_array_equal(davis._l2_disk(r), jdavis._l2_disk(r))
    rng = np.random.RandomState(5)
    for n in (0, 1, 3, 17):
        scores = rng.rand(n)
        np.testing.assert_equal(davis.statistics(scores), jdavis.statistics(scores))


@pytest.mark.parametrize("name", ["DAVIS2016", "DAVIS2017"])
def test_davis_benchmark_matches_jax(tmp_path, name):
    """A perfect tracker, one rolled 8 px and an incomplete result dir
    (skipped), scored by both packages' ``DAVISBenchmark``."""
    _make_davis(tmp_path / "data" / "DAVIS", n_frames=6)
    dataset = load_dataset(name, str(tmp_path / "data"))
    res_root = tmp_path / "test"
    for tracker, shift, frames in (("perfect", 0, 6), ("shifted", 8, 6), ("partial", 0, 4)):
        out = res_root / name / tracker / "synth"
        out.mkdir(parents=True)
        for i, anno_file in enumerate(dataset["synth"]["anno_files"][:frames]):
            a = np.array(Image.open(anno_file))
            if name == "DAVIS2016":                 # single object: a binary mask
                a = (a > 0).astype(np.uint8)
            Image.fromarray(np.roll(a, shift, axis=1)).save(out / f"{i:05d}.png")
    results = []
    for mod in (davis, jdavis):
        bench = mod.DAVISBenchmark(dataset, name, str(res_root))
        merged = {}
        for t in ("perfect", "shifted", "partial"):
            merged.update(bench.eval(t))
        results.append((merged, mod.DAVISBenchmark.summarize(merged)))
    assert results[0] == results[1]
    merged, summary = results[0]
    assert merged["partial"] == {}
    assert summary["perfect"]["J_mean"] == summary["perfect"]["F_mean"] == 1.0
    assert 0.2 < summary["shifted"]["J_mean"] < 0.9 and summary["shifted"]["F_mean"] < 1.0
    assert len(merged["perfect"]["synth"]) == (1 if name == "DAVIS2016" else 2)
