"""The port's checkpoints, resume and train CLI, on the CPU at width 8.

- ``save_checkpoint``/``load_checkpoint``: a round trip, a crash mid-write
  that leaves the old file as it was, and ``torch.load(weights_only=True)``;
- a port checkpoint read by the JAX package's ``load_torch_checkpoint``
  gives the variables the weights came from, also for a bf16 SiamMask-sharp,
  whose deconv is bf16; a bf16 resume keeps that deconv bf16;
- ``merge_state_dict`` of SiamMask-base into sharp (and back) reports the
  names the JAX package's ``merge_variables`` reports;
- ``Trainer.restore``: the step after a resume is bit-identical, weights,
  BN statistics and momentum, to the uninterrupted run's; across the
  unfreeze boundary it warns, restarts momentum, and is still bit-identical
  to the run that crossed the boundary;
- ``tools.train.main``: SiamMask-base for 2 steps, then ``sharp_refine``
  warm-started from its checkpoint, then resumed for another epoch.
"""
import json
import logging
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from siammask_tpu.models.siammask import SiamMaskBase as JaxSiamMaskBase
from siammask_tpu.models.siammask import SiamMaskSharp as JaxSiamMaskSharp
from siammask_tpu.train.checkpoint import merge_variables
from siammask_tpu.utils.torch_convert import load_torch_checkpoint
from siammask_tpu_torch.models.siammask import SiamMaskBase, SiamMaskSharp
from siammask_tpu_torch.tools import train as train_cli
from siammask_tpu_torch.train import checkpoint
from siammask_tpu_torch.train.checkpoint import (load_checkpoint, merge_state_dict,
                                                 read_state_dict, save_checkpoint)
from siammask_tpu_torch.train.trainer import Trainer
from siammask_tpu_torch.tracker.anchors import AnchorConfig
from siammask_tpu_torch.utils.convert import _torch_name, state_dict_from_jax

from test_checkpoint_prep import _make_crop_dataset
from test_torch_models import jax_variables
from test_torch_tracker import one_torch_thread  # noqa: F401  (autouse)
from test_torch_train import make_batch, settings_pair

REPO = Path(__file__).resolve().parents[1]
WIDTH = 8


def _model(cls=SiamMaskBase, seed=0):
    return cls(width=WIDTH).init_weights(torch.Generator().manual_seed(seed))


def _trainer(seed=0):
    *_, tset, topt, tlr = settings_pair()
    return Trainer(_model(seed=seed), tset, topt, tlr, epochs=2)


def test_round_trip_loads_weights_only(tmp_path):
    trainer = _trainer()
    _, batch = make_batch()
    trainer.step(batch, 0)
    path = str(tmp_path / "sub" / "ck.pth")
    anchors = AnchorConfig().to_dict()
    save_checkpoint(path, trainer.model.state_dict(), trainer.optimizer.state_dict(), epoch=3,
                    arch="SiamMaskBase", anchor_cfg=anchors)
    raw = torch.load(path, map_location="cpu", weights_only=True)
    assert set(raw) == {"epoch", "arch", "state_dict", "optimizer", "anchor_cfg"}
    ck = load_checkpoint(path)
    assert (ck["epoch"], ck["arch"], ck["anchor_cfg"]) == (3, "SiamMaskBase", anchors)
    assert AnchorConfig.from_dict(ck["anchor_cfg"]) == AnchorConfig()
    state = trainer.model.state_dict()
    assert set(ck["state_dict"]) == set(state)
    for k, v in state.items():
        assert torch.equal(ck["state_dict"][k], v), k
    saved = trainer.optimizer.state_dict()
    assert ck["optimizer"]["param_groups"] == saved["param_groups"]
    for i, s in saved["state"].items():
        assert torch.equal(ck["optimizer"]["state"][i]["momentum_buffer"], s["momentum_buffer"])
    prefixed = {f"module.{k}": v for k, v in state.items()}
    torch.save({"state_dict": prefixed}, tmp_path / "ref.pth")
    assert read_state_dict(str(tmp_path / "ref.pth")).keys() == state.keys()
    torch.save(state, tmp_path / "bare.pth")
    assert read_state_dict(str(tmp_path / "bare.pth")).keys() == state.keys()


def test_save_is_atomic(tmp_path, monkeypatch):
    """A crash mid-write leaves the published checkpoint as it was and no
    temp file; the next save replaces it."""
    path = str(tmp_path / "ck.pth")
    state = _model().state_dict()
    save_checkpoint(path, state, epoch=1)
    good = Path(path).read_bytes()

    def crash(obj, f):
        f.write(b"half a checkpoint")
        raise RuntimeError("crash mid-write")

    monkeypatch.setattr(checkpoint.torch, "save", crash)
    with pytest.raises(RuntimeError):
        save_checkpoint(path, state, epoch=2)
    monkeypatch.undo()
    assert Path(path).read_bytes() == good
    assert load_checkpoint(path)["epoch"] == 1
    save_checkpoint(path, state, epoch=3)
    assert load_checkpoint(path)["epoch"] == 3
    assert [p.name for p in tmp_path.iterdir()] == ["ck.pth"]


def _flat(tree) -> dict:
    return {"/".join(p.key for p in path): np.asarray(v) for path, v in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


def _bf16_sharp():
    """A bf16 SiamMask-sharp of the port holding the JAX bf16 model's
    ``init`` variables, deconv kernel and bias in bf16 as JAX creates them;
    and those variables."""
    variables = jax.jit(JaxSiamMaskSharp(width=WIDTH, dtype=jnp.bfloat16).init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 127, 127, 3)), jnp.zeros((1, 255, 255, 3)))
    wide = jax.tree.map(lambda v: np.asarray(v, np.float32), variables)
    state = state_dict_from_jax(wide)
    model = SiamMaskSharp(width=WIDTH, dtype=torch.bfloat16)
    for k, v in model.state_dict().items():
        if v.dtype == torch.bfloat16:
            state[k] = state[k].to(torch.bfloat16)
    model.load_state_dict(state, strict=True)
    return model, variables


def test_jax_loader_reads_a_port_checkpoint(tmp_path):
    """float32, and a bf16 sharp whose deconv is bf16: the JAX package's
    loader reads the checkpoint into the JAX model's variables (the bf16
    ones widened to float32, which is exact)."""
    variables = jax_variables(JaxSiamMaskSharp(width=WIDTH))
    model = SiamMaskSharp(width=WIDTH)
    model.load_state_dict(state_dict_from_jax(variables), strict=True)
    bf16_model, bf16_variables = _bf16_sharp()
    deconv = bf16_model.refine_model.deconv
    assert deconv.weight.dtype == deconv.bias.dtype == torch.bfloat16
    for name, m, v in (("sharp", model, variables), ("bf16_sharp", bf16_model, bf16_variables)):
        path = str(tmp_path / f"{name}.pth")
        save_checkpoint(path, m.state_dict(), epoch=1)
        ours, ref = _flat(load_torch_checkpoint(path)), _flat(v)
        assert ours.keys() == ref.keys()
        for k in ref:
            assert ours[k].dtype == np.float32, k
            np.testing.assert_array_equal(ours[k], ref[k].astype(np.float32), err_msg=k)


def test_bf16_resume_keeps_the_deconv_bf16(tmp_path):
    """A bf16 sharp's checkpoint holds no bf16 tensor and names its bf16
    entries; ``load_checkpoint`` and ``read_state_dict`` give them back in
    bf16, bit for bit, and ``Trainer.restore`` into a bf16 model keeps its
    deconv bf16."""
    model, _ = _bf16_sharp()
    path = str(tmp_path / "bf16.pth")
    save_checkpoint(path, model.state_dict(), epoch=1)
    raw = torch.load(path, map_location="cpu", weights_only=True)
    assert all(v.dtype != torch.bfloat16 for v in raw["state_dict"].values())
    assert raw["dtypes"] == {"refine_model.deconv.weight": "bfloat16",
                             "refine_model.deconv.bias": "bfloat16"}
    for state in (load_checkpoint(path)["state_dict"], read_state_dict(path)):
        for k, v in model.state_dict().items():
            assert state[k].dtype == v.dtype and torch.equal(state[k], v), k
    *_, tset, topt, tlr = settings_pair()
    fresh = SiamMaskSharp(width=WIDTH, dtype=torch.bfloat16).init_weights(
        torch.Generator().manual_seed(1))
    trainer = Trainer(fresh, tset, topt, tlr, epochs=2)
    assert trainer.restore(path) == 1
    deconv = trainer.model.refine_model.deconv
    assert deconv.weight.dtype == deconv.bias.dtype == torch.bfloat16
    assert torch.equal(deconv.weight, model.refine_model.deconv.weight)


def _jax_init(cls):
    shapes = jax.eval_shape(lambda: cls(width=WIDTH).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 127, 127, 3)), jnp.zeros((1, 255, 255, 3))))
    return jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes)


def _torch_names(paths, tree):
    """JAX merge paths ('params/refine', a subtree or a leaf of ``tree``)
    -> the port's state_dict names of every leaf under them."""
    leaves = ["/".join(k.key for k in path)
              for path, _ in jax.tree_util.tree_flatten_with_path(tree)[0]]
    return {_torch_name(".".join(leaf.split("/")[1:]))[0] for p in paths for leaf in leaves
            if leaf == p or leaf.startswith(p + "/")}


@pytest.mark.parametrize("src,dst", [("base", "sharp"), ("sharp", "base")])
def test_merge_matches_jax(src, dst):
    """Base into sharp: Refine is missing, nothing unused; sharp into base:
    the reverse. The names are JAX's ``merge_variables``'."""
    port = {"base": SiamMaskBase, "sharp": SiamMaskSharp}
    jax_cls = {"base": JaxSiamMaskBase, "sharp": JaxSiamMaskSharp}
    source, target = _model(port[src], seed=1), _model(port[dst], seed=2)
    jdst, jsrc = _jax_init(jax_cls[dst]), _jax_init(jax_cls[src])
    _, jmissing, junused = merge_variables(jdst, jsrc)
    missing, unused = merge_state_dict(target, source.state_dict())
    assert set(missing) == _torch_names(jmissing, jdst)
    assert set(unused) == _torch_names(junused, jsrc)
    refine = {k for k in _model(SiamMaskSharp).state_dict() if k.startswith("refine_model.")}
    assert set(missing if dst == "sharp" else unused) == refine
    assert not (unused if dst == "sharp" else missing)
    kept = target.state_dict()
    for k, v in source.state_dict().items():
        if k in kept:
            assert torch.equal(kept[k], v), k


def test_merge_reports_shape_mismatch():
    target = _model()
    state = dict(_model(seed=3).state_dict())
    name = "rpn_model.cls.head.3.weight"
    state[name] = state[name][:2]
    before = target.state_dict()[name].clone()
    missing, unused = merge_state_dict(target, state)
    assert len(missing) == 1 and missing[0].startswith(name) and "shape" in missing[0]
    assert unused == [] and torch.equal(target.state_dict()[name], before)


def _snapshot(trainer):
    names = {p: n for n, p in trainer.model.named_parameters()}
    return ({k: v.clone() for k, v in trainer.model.state_dict().items()},
            {names[p]: s["momentum_buffer"].clone() for p, s in trainer.optimizer.state.items()})


def _assert_same(a, b):
    for x, y in zip(a, b):
        assert x.keys() == y.keys()
        for k in x:
            assert torch.equal(x[k], y[k]), k


@pytest.mark.parametrize("boundary", [False, True])
def test_resume_is_bit_identical(tmp_path, caplog, boundary):
    """k=2 steps, save, restore into a fresh trainer, step 3 -- against the
    uninterrupted run. Across the boundary (saved after epoch 0, resumed at
    epoch 1) both runs rebuild the optimizer with fresh momentum."""
    _, batch = make_batch()
    _, batch2 = make_batch(seed=1)
    epochs = (0, 0, 1) if boundary else (0, 0, 0)
    straight = _trainer()
    for epoch in epochs[:2]:
        straight.step(batch, epoch)
    path = str(tmp_path / "ck.pth")
    save_checkpoint(path, straight.model.state_dict(), straight.optimizer.state_dict(),
                    epoch=epochs[2])
    straight.step(batch2, epochs[2])

    resumed = _trainer(seed=5)
    with caplog.at_level(logging.WARNING):
        assert resumed.restore(path) == epochs[2]
    warned = any("optimizer state not restored" in r.message for r in caplog.records)
    assert warned == boundary
    assert len(resumed.optimizer.state) == (0 if boundary else len(straight.optimizer.state))
    resumed.step(batch2, epochs[2])
    _assert_same(_snapshot(resumed), _snapshot(straight))


def _cli_config(tmp_path, config, search):
    """The experiment config with its train data the synthetic crop
    dataset (COCO layout, masks), 4 pairs an epoch."""
    root, anno = _make_crop_dataset(tmp_path / f"data{search}")
    cfg = json.loads((REPO / "experiments" / config).read_text())
    cfg["train_datasets"]["datasets"] = {"coco": {"root": root, "anno": anno,
                                                  "frame_range": 2}}
    cfg["train_datasets"]["num"] = 4
    path = tmp_path / f"config{search}.json"
    path.write_text(json.dumps(cfg))
    return str(path)


def test_train_cli_base_then_refine_then_resume(tmp_path, caplog):
    common = ["--batch", "2", "--workers", "0", "--width", str(WIDTH), "--log-interval", "1",
              "--seed", "3", "--device", "cpu"]
    base_dir, sharp_dir = tmp_path / "base", tmp_path / "sharp"
    base = train_cli.main(["--config", _cli_config(tmp_path, "siammask_base/config.json", 255),
                           "--task", "base", "--epochs", "1", "--save-dir", str(base_dir),
                           *common])
    assert {"cls_loss", "loc_loss", "mask_loss", "total_loss"} <= set(base)
    assert all(np.isfinite(v) for v in base.values()) and base["skipped"] == 0.0
    ck = load_checkpoint(str(base_dir / "checkpoint_e1.pth"))
    assert ck["epoch"] == 1 and ck["arch"] == "SiamMaskBase"

    sharp_cfg = _cli_config(tmp_path, "siammask_sharp/config.json", 143)
    refine_args = ["--config", sharp_cfg, "--task", "sharp_refine", "--epochs", "2",
                   "--save-dir", str(sharp_dir), *common]
    with caplog.at_level(logging.INFO, logger="train"):
        first = train_cli.main([*refine_args[:5], "1", *refine_args[6:], "--pretrained",
                                str(base_dir / "checkpoint_e1.pth")])
    assert any("pretrained:" in r.message and "refine_model." in r.message
               for r in caplog.records)
    assert all(np.isfinite(v) for v in first.values()) and first["skipped"] == 0.0
    refined = load_checkpoint(str(sharp_dir / "checkpoint_e1.pth"))
    for k, v in ck["state_dict"].items():
        if k.startswith(("features.", "rpn_model.")):
            assert torch.equal(refined["state_dict"][k], v), k

    resumed = train_cli.main([*refine_args, "--resume", str(sharp_dir / "checkpoint_e1.pth")])
    assert all(np.isfinite(v) for v in resumed.values())
    assert load_checkpoint(str(sharp_dir / "checkpoint_e2.pth"))["epoch"] == 2
