"""The port's data pipeline against the JAX package's, bit for bit:
``PairDataset`` items and ``collate`` batches for the same seed (through
``DataLoader`` with no workers, threads and forked processes), the RLE
codec, and the crop and JSON preparation of COCO, VID, DET and YouTube-VOS
on ``test_checkpoint_prep.py``'s synthetic layouts. Then ``to_device`` on
the CPU: the order, the NCHW images and an error of the source raised at
the consumer."""
import json
import os

import cv2
import numpy as np
import pytest
import torch

from siammask_tpu.data import gen_json as jax_gen_json
from siammask_tpu.data import prep as jax_prep
from siammask_tpu.data import rle as jax_rle
from siammask_tpu.data.dataset import PairDataset as JaxPairDataset
from siammask_tpu.data.dataset import collate as jax_collate
from siammask_tpu_torch.data import gen_json, prep, rle
from siammask_tpu_torch.data.dataset import DataLoader, PairDataset, collate, to_device

from test_checkpoint_prep import _make_crop_dataset, _write_xml_frame
from test_torch_tracker import one_torch_thread  # noqa: F401  (autouse)

KEYS = ("template", "search", "label_cls", "label_loc", "label_loc_weight", "bbox",
        "label_mask", "label_mask_weight")
ANCHORS = {"stride": 8, "ratios": [0.33, 0.5, 1, 2, 3], "scales": [8]}
SEED = 7


def train_cfg(root, anno):
    return {"datasets": {"coco": {"root": root, "anno": anno, "frame_range": 2}},
            "template_size": 127, "search_size": 143, "base_size": 0, "size": 3,
            "num": 8,
            "augmentation": {"template": {"shift": 4, "scale": 0.05},
                             "search": {"shift": 8, "scale": 0.18, "blur": 0.18},
                             "neg": 0.2, "gray": 0.25}}


@pytest.fixture(scope="module")
def crop_cfg(tmp_path_factory):
    return train_cfg(*_make_crop_dataset(tmp_path_factory.mktemp("crops")))


def assert_batches_equal(ours, ref):
    assert set(ours) == set(ref) == set(KEYS)
    for k in KEYS:
        assert ours[k].dtype == ref[k].dtype, k
        np.testing.assert_array_equal(ours[k], ref[k], err_msg=k)


@pytest.fixture(scope="module")
def jax_batches(crop_cfg):
    """The JAX package's 8 items as two batches of 4, for two shuffle
    generations."""
    ds = JaxPairDataset(crop_cfg, ANCHORS, seed=SEED)
    out = []
    for _ in range(2):
        out.append([jax_collate([ds[i] for i in range(b, b + 4)]) for b in (0, 4)])
        ds.shuffle()
    return out


def test_pair_dataset_matches_jax(crop_cfg, jax_batches):
    """All 8 collate keys, bit for bit, for two shuffle generations; the
    batches hold negatives, gray pairs and positives alike."""
    ds = PairDataset(crop_cfg, ANCHORS, seed=SEED)
    for generation in jax_batches:
        for b, ref in zip((0, 4), generation):
            assert_batches_equal(collate([ds[i] for i in range(b, b + 4)]), ref)
        ds.shuffle()
    weights = np.concatenate([g[i]["label_mask_weight"] for g in jax_batches for i in (0, 1)])
    assert (weights.reshape(16, -1).max(axis=1) == 0).any()     # a negative pair
    assert (weights.reshape(16, -1).max(axis=1) == 1).any()     # a positive one


@pytest.mark.parametrize("workers,mode", [(0, "thread"), (2, "thread"), (2, "process")])
def test_loader_matches_jax(crop_cfg, jax_batches, workers, mode):
    ds = PairDataset(crop_cfg, ANCHORS, seed=SEED)
    batches = list(DataLoader(ds, 4, num_workers=workers, workers_mode=mode))
    assert len(batches) == 2
    for ours, ref in zip(batches, jax_batches[0]):
        assert_batches_equal(ours, ref)


def test_unseeded_dataset_draws_its_own_seed(crop_cfg):
    a, b = PairDataset(crop_cfg, ANCHORS), PairDataset(crop_cfg, ANCHORS)
    assert a.seed != b.seed
    c = PairDataset(crop_cfg, ANCHORS, seed=a.seed)
    np.testing.assert_array_equal(a[3].search, c[3].search)


def test_rle_matches_jax():
    rng = np.random.RandomState(0)
    masks = [(rng.rand(37, 23) > p).astype(np.uint8) for p in (0.1, 0.5, 0.9)]
    masks.append(np.zeros((5, 7), np.uint8))
    for mask in masks:
        enc, ref = rle.encode(mask), jax_rle.encode(mask)
        assert enc == ref
        np.testing.assert_array_equal(rle.decode(enc), jax_rle.decode(ref))
        counts = rle.string_to_counts(enc["counts"])
        np.testing.assert_array_equal(counts, jax_rle.string_to_counts(ref["counts"]))
        assert rle.area(counts) == jax_rle.area(counts) == int(mask.sum())
        np.testing.assert_array_equal(rle.to_bbox(counts, mask.shape[0]),
                                      jax_rle.to_bbox(counts, mask.shape[0]))
    polys = [[10.5, 3.0, 30.2, 8.0, 25.0, 33.7, 4.0, 20.0], [0, 0, 12, 0, 12, 12]]
    runs = [rle.fr_poly(p, 40, 35) for p in polys]
    for ours, p in zip(runs, polys):
        np.testing.assert_array_equal(ours, jax_rle.fr_poly(p, 40, 35))
    for intersect in (False, True):
        np.testing.assert_array_equal(rle.merge(runs, 40, 35, intersect),
                                      jax_rle.merge(runs, 40, 35, intersect))
    ann = {"segmentation": [polys[0]]}
    np.testing.assert_array_equal(rle.ann_to_mask(ann, 40, 35),
                                  jax_rle.ann_to_mask(ann, 40, 35))
    ann = {"segmentation": rle.encode(masks[1])}
    np.testing.assert_array_equal(rle.ann_to_mask(ann, 37, 23), masks[1])


def assert_trees_equal(a, b):
    """Every file under two directories, byte for byte."""
    files = lambda root: sorted(os.path.relpath(os.path.join(d, f), root)
                                for d, _, fs in os.walk(root) for f in fs)
    assert files(a) == files(b) and files(a)
    for rel in files(a):
        with open(os.path.join(a, rel), "rb") as fa, open(os.path.join(b, rel), "rb") as fb:
            assert fa.read() == fb.read(), rel


def test_prep_coco_matches_jax(tmp_path):
    coco = tmp_path / "coco"
    (coco / "annotations").mkdir(parents=True)
    (coco / "val2017").mkdir()
    img = np.random.RandomState(1).randint(0, 255, (100, 120, 3), np.uint8)
    cv2.imwrite(str(coco / "val2017" / "000000000001.jpg"), img)
    mask = (np.random.RandomState(2).rand(100, 120) > 0.5).astype(np.uint8)
    data = {"images": [{"id": 1, "file_name": "000000000001.jpg", "height": 100,
                        "width": 120}],
            "annotations": [
                {"id": 10, "image_id": 1, "bbox": [10, 20, 30, 40],
                 "segmentation": [[10, 20, 40, 20, 40, 60, 10, 60]]},
                {"id": 11, "image_id": 1, "bbox": [50, 10, 40, 50],
                 "segmentation": jax_rle.encode(mask)},
                {"id": 12, "image_id": 1, "bbox": [5, 5, 0, 10]}]}
    anno = coco / "annotations" / "instances_val2017.json"
    anno.write_text(json.dumps(data))
    for mod, out in ((prep, "ours"), (jax_prep, "ref")):
        annotations = mod.CocoAnnotations(str(anno))
        mod.crop_coco_image(annotations, 1, str(coco / "val2017"),
                            str(tmp_path / out), search_size=255)
    assert_trees_equal(tmp_path / "ours", tmp_path / "ref")
    assert prep.gen_json_coco(str(coco), subsets=("val2017",)) == \
        jax_prep.gen_json_coco(str(coco), subsets=("val2017",))


def _vid_layout(root):
    sub = "ILSVRC2015_VID_train_0000"
    for f in range(3):
        _write_xml_frame(root / "Annotations" / "VID" / "train" / sub / "vidA",
                         root / "Data" / "VID" / "train" / sub / "vidA",
                         f, [(0, [20, 15, 50, 45]), (1, [5, 5, 25, 30])])
    _write_xml_frame(root / "Annotations" / "VID" / "val" / "vidB",
                     root / "Data" / "VID" / "val" / "vidB", 0, [(0, [10, 10, 40, 40])])


def _det_layout(root):
    _write_xml_frame(root / "Annotations" / "DET" / "train" / "ILSVRC2014_train_0000",
                     root / "Data" / "DET" / "train" / "ILSVRC2014_train_0000",
                     0, [(0, [20, 15, 50, 45])])
    _write_xml_frame(root / "Annotations" / "DET" / "train" / "ILSVRC2013_train" / "n0001",
                     root / "Data" / "DET" / "train" / "ILSVRC2013_train" / "n0001",
                     0, [(0, [10, 10, 30, 30]), (1, [40, 20, 70, 50])])


def _ytb_layout(root):
    (root / "train" / "JPEGImages" / "vidX").mkdir(parents=True)
    (root / "train" / "Annotations" / "vidX").mkdir(parents=True)
    rng = np.random.RandomState(3)
    for frame in ("00000", "00005"):
        cv2.imwrite(str(root / "train" / "JPEGImages" / "vidX" / f"{frame}.jpg"),
                    rng.randint(0, 255, (60, 80, 3), np.uint8))
        label = np.zeros((60, 80), np.uint8)
        label[10:50, 20:60] = 1
        cv2.imwrite(str(root / "train" / "Annotations" / "vidX" / f"{frame}.png"), label)
    (root / "train" / "meta.json").write_text(json.dumps(
        {"videos": {"vidX": {"objects": {"1": {"frames": ["00000", "00005"]}}}}}))


def test_prep_vid_det_ytb_vos_match_jax(tmp_path):
    """The crops of each crop pass byte for byte, and the train JSONs."""
    for name, layout in (("vid", _vid_layout), ("det", _det_layout), ("ytb", _ytb_layout)):
        layout(tmp_path / name)
    root = lambda name: str(tmp_path / name)
    crops = {}
    for mod, tag in ((prep, "ours"), (jax_prep, "ref")):
        crops[tag] = (
            mod.prep_vid(root("vid"), crop_path=root(f"vid_{tag}"), search_size=127,
                         num_workers=0),
            mod.prep_det(root("det"), crop_path=root(f"det_{tag}"), search_size=127,
                         num_workers=0),
            mod.prep_ytb_vos(root("ytb"), crop_path=root(f"ytb_{tag}"), search_size=127,
                             num_workers=0))
    for ours, ref in zip(crops["ours"], crops["ref"]):
        assert_trees_equal(ours, ref)

    assert gen_json.gen_json_vid(gen_json.parse_vid(root("vid"))) == \
        jax_gen_json.gen_json_vid(jax_gen_json.parse_vid(root("vid")))
    assert gen_json.gen_json_det(root("det")) == jax_gen_json.gen_json_det(root("det"))
    instances = gen_json.parse_ytb_vos(root("ytb"))
    assert instances == jax_gen_json.parse_ytb_vos(root("ytb"))
    assert gen_json.gen_json_ytb_vos(instances) == jax_gen_json.gen_json_ytb_vos(instances)
    out = tmp_path / "train.json"
    gen_json.gen_json_ytb_vos(instances, str(out))
    assert json.loads(out.read_text()) == jax_gen_json.gen_json_ytb_vos(instances)


def test_to_device_keeps_order_and_layout(crop_cfg):
    batches = list(DataLoader(PairDataset(crop_cfg, ANCHORS, seed=SEED), 2, num_workers=0))
    staged = list(to_device(iter(batches), "cpu", size=2))
    assert len(staged) == len(batches) == 4
    for ours, ref in zip(staged, batches):
        assert set(ours) == set(ref)
        for k, v in ref.items():
            t = ours[k]
            assert t.device.type == "cpu" and t.is_contiguous()
            if k in ("template", "search"):
                assert t.shape == (2, 3, *v.shape[1:3])
                v = v.transpose(0, 3, 1, 2)
            np.testing.assert_array_equal(t.numpy(), v, err_msg=k)
    assert staged[0]["label_cls"].dtype == torch.int64


def test_to_device_raises_source_error_at_consumer():
    def source():
        for i in range(2):
            yield {"template": np.full((1, 4, 4, 3), i, np.float32)}
        raise RuntimeError("source failed")

    got = []
    with pytest.raises(RuntimeError, match="source failed"):
        for b in to_device(source(), "cpu"):
            got.append(int(b["template"][0, 0, 0, 0]))
    assert got == [0, 1]


def test_to_device_stops_when_the_consumer_does():
    def endless():
        i = 0
        while True:
            yield {"template": np.full((1, 2, 2, 3), i, np.float32)}
            i += 1

    it = to_device(endless(), "cpu", size=1)
    assert [int(next(it)["template"].flatten()[0]) for _ in range(3)] == [0, 1, 2]
    it.close()
