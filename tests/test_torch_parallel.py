"""The port's data-parallel training on two gloo ranks on the CPU, against
the JAX package's mesh step on a 2-device CPU mesh and against the port's
own single-process step, at width 8, SiamMask-base stage 1, a global batch
of 4 (2 rows a rank).

One spawn for the module (``dp_runs``, ``parallel.dist.spawn`` of
``_torch_dp.run_cases``, which imports the port only) runs every case on
both ranks from the same weights, carried into the JAX package's tree by
its own checkpoint importer (``calibrated_variables``):

- the default mode (the exact global-batch step), one frozen and one
  unfrozen step, against ``make_train_step(mesh=data_parallel_mesh(2))``
  through the JAX ``Trainer``: loss rtol 1e-5, parameters rtol 1e-4 /
  atol 1e-6 (``tests/test_training.py``'s mesh tolerances), metrics and BN
  statistics 1e-4 of their largest entry; and against the port's
  single-process step at batch 4;
- ``fused_allreduce`` and ``fused_allreduce`` + ``sync_bn``, one unfrozen
  step each, against JAX's ``fused_allreduce=True`` (with ``sync_bn=True``):
  both compute each rank's loss with local normalizers and average the
  gradients, so losses, metrics and BN statistics are held to 1e-4 of their
  largest entry (float32 summation order), parameters to rtol 1e-4 / atol
  1e-6;
- ``remat`` against the default mode; a NaN in one rank's batch, in the
  default and the fused mode; the collectives each step issues;
- ``AllReduceSum``'s values and gradients.

The JAX models run the default xcorr (``"mm"``), as the JAX package's own
mesh tests do. BN running means and variances are compared directly: the
port's, like flax's, take the biased batch variance
(``_torch_dp.BNRecorder`` notes which BNs ran in training mode).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from siammask_tpu.models.siammask import SiamMaskBase as JaxSiamMaskBase
from siammask_tpu.parallel.mesh import data_parallel_mesh, shard_batch
from siammask_tpu.train.trainer import Trainer as JaxTrainer
from siammask_tpu.utils.torch_convert import convert_state_dict
from siammask_tpu_torch.data.dataset import DataLoader, PairDataset
from siammask_tpu_torch.models.siammask import SiamMaskBase
from siammask_tpu_torch.parallel.dist import local_rows, spawn
from siammask_tpu_torch.parallel.sync_bn import SyncBatchNorm2d, convert_sync_bn
from siammask_tpu_torch.train.trainer import Trainer, label_params
from siammask_tpu_torch.utils.convert import state_dict_from_jax

import _torch_dp
from chip_smoke import bn_calibration
from test_checkpoint_prep import _make_crop_dataset
from test_torch_data import ANCHORS, train_cfg
from test_torch_tracker import one_torch_thread  # noqa: F401  (autouse)
from test_torch_train import (WIDTH, calibrated_variables, make_batch, port_model,
                              settings_pair)

B = 4
WORLD = 2
# (name, Trainer keyword arguments, epochs stepped, the rank given a NaN)
BF16 = {"dtype": torch.bfloat16, "weights": "layer"}
CASES = [("default", {}, (0, 1), None),
         ("default64", {"dtype": torch.float64}, (0, 1), None),
         ("remat", {"remat": True}, (0, 1), None),
         ("fused", {"fused_allreduce": True}, (1,), None),
         ("fused_sync", {"fused_allreduce": True, "sync_bn": True}, (1,), None),
         ("nan", {}, (0,), 1),
         ("nan_fused", {"fused_allreduce": True}, (0,), 0),
         ("bf16", BF16, (0, 1), None),
         ("bf16_remat", {**BF16, "remat": True}, (0, 1), None),
         ("bf16_fused_sync", {**BF16, "fused_allreduce": True, "sync_bn": True}, (0,), None)]
# the JAX Trainer's keyword arguments for each compared case
JAX_MODES = {"default": {}, "fused": {"fused_allreduce": True},
             "fused_sync": {"fused_allreduce": True, "sync_bn": True}}
JAX_BF16_MODES = {"bf16": {}, "bf16_fused_sync": {"fused_allreduce": True, "sync_bn": True}}
VALUE = 1e-4          # metrics and BN statistics, of the largest entry
PARAM = {"rtol": 1e-4, "atol": 1e-6}


@pytest.fixture(scope="module")
def setup():
    jbatch, tbatch = make_batch(seed=3, b=B)
    variables = calibrated_variables(tbatch)
    state = state_dict_from_jax(variables)
    return jbatch, tbatch, variables, state


@pytest.fixture(scope="module")
def layer_weights(setup):
    """The bf16 cases' weights: seeded, BN-calibrated per layer on the
    batch's first pair (``chip_smoke.bn_calibration``, as
    ``tests/test_torch_bf16.py``'s train step and ``chip_smoke.py``'s train
    phases calibrate: per-channel statistics leave bf16 ~45% off float32 in
    train mode). (JAX variables, port state)."""
    _, tbatch, _, _ = setup
    model = SiamMaskBase(width=WIDTH).init_weights(torch.Generator().manual_seed(0)).eval()
    with torch.no_grad(), bn_calibration(model):
        model.forward_train(tbatch["template"][:1], tbatch["search"][:1])
    state = {k: v.detach().clone() for k, v in model.state_dict().items()}
    # copies: ``spawn`` moves the state's storage to shared memory and frees
    # the old one, which numpy views would still point to
    return convert_state_dict({k: v.numpy().copy() for k, v in state.items()}), state


def bn_input():
    """bf16 maps (4, 16, 5, 5) whose channels' means (50 to 150) are large
    against their spread (std 1), seeded by numpy."""
    rng = np.random.RandomState(11)
    x = rng.uniform(50, 150, (1, 16, 1, 1)) + rng.standard_normal((4, 16, 5, 5))
    return torch.from_numpy(x).to(torch.bfloat16)


@pytest.fixture(scope="module")
def dp_runs(setup, layer_weights):
    """{case: (rank 0's results, rank 1's)} from one spawn of two ranks."""
    _, tbatch, _, state = setup
    *_, tset, topt, tlr = settings_pair()
    ranks = spawn(_torch_dp.run_cases, WORLD, "cpu", {"channel": state, "layer": layer_weights[1]},
                  tbatch, (tset, topt, tlr), CASES, bn_input(), timeout=600)
    return {name: tuple(r[name] for r in ranks) for name in ranks[0]}


def _jax_steps(variables, jbatch, epochs, dtype=None, **kwargs):
    jset, jopt, jlr, *_ = settings_pair()
    mesh = data_parallel_mesh(WORLD)
    model = JaxSiamMaskBase(width=WIDTH) if dtype is None else JaxSiamMaskBase(width=WIDTH,
                                                                               dtype=dtype)
    trainer = JaxTrainer(model, variables, jset, jopt, jlr, epochs=2,
                         mesh=mesh, unfreeze_at=0.5, **kwargs)
    steps = []
    for epoch in epochs:
        metrics = trainer.step(shard_batch(mesh, jbatch), epoch)
        state = state_dict_from_jax(jax.tree.map(np.asarray, trainer.variables))
        steps.append({"metrics": {k: float(v) for k, v in metrics.items()},
                      "state": {k: v.numpy() for k, v in state.items()}})
    return steps


@pytest.fixture(scope="module")
def jax_runs(setup):
    jbatch, _, variables, _ = setup
    epochs = {name: ep for name, _, ep, _ in CASES}
    return {name: _jax_steps(variables, jbatch, epochs[name], **kw)
            for name, kw in JAX_MODES.items()}


@pytest.fixture(scope="module")
def jax_bf16_runs(setup, layer_weights):
    """The JAX mesh step's frozen step over its bf16 ``SiamMaskBase``, in
    the default mode and fused + sync-BN, from the per-layer weights."""
    jbatch = setup[0]
    return {name: _jax_steps(layer_weights[0], jbatch, (0,), jnp.bfloat16, **kw)
            for name, kw in JAX_BF16_MODES.items()}


@pytest.fixture(scope="module")
def single_bf16_run(setup, layer_weights):
    """The port's single-process trainer on the whole batch from the
    per-layer weights, on a bf16 and on a float32 model: a frozen and an
    unfrozen step, each state and metrics."""
    tbatch = setup[1]
    *_, tset, topt, tlr = settings_pair()
    runs = {}
    for dtype in (torch.bfloat16, None):
        model = SiamMaskBase(width=WIDTH, dtype=dtype)
        model.load_state_dict(layer_weights[1])
        trainer = Trainer(model, tset, topt, tlr, epochs=2)
        steps = []
        for epoch in (0, 1):
            metrics = trainer.step(tbatch, epoch)
            steps.append({"metrics": {k: float(v) for k, v in metrics.items()},
                          "state": {k: v.detach().numpy().copy()
                                    for k, v in model.state_dict().items()}})
        runs[dtype] = steps
    return runs


@pytest.fixture(scope="module")
def single_run(setup):
    """The port's single-process trainer on the whole batch, in float32 and
    in float64: a frozen and an unfrozen step, each state and metrics."""
    _, tbatch, variables, _ = setup
    *_, tset, topt, tlr = settings_pair()
    runs = {}
    for dtype in (torch.float32, torch.float64):
        model = port_model(variables, dtype)
        trainer = Trainer(model, tset, topt, tlr, epochs=2)
        data = {k: v.to(dtype) if v.is_floating_point() else v for k, v in tbatch.items()}
        steps = []
        for epoch in (0, 1):
            metrics = trainer.step(data, epoch)
            steps.append({"metrics": {k: float(v) for k, v in metrics.items()},
                          "state": {k: v.detach().numpy().copy()
                                    for k, v in model.state_dict().items()}})
        runs[dtype] = steps
    return runs


def _close(ours, ref, rel, name):
    np.testing.assert_allclose(ours, ref, rtol=rel, atol=rel * np.abs(ref).max(), err_msg=name)


def _check_step(ours, ref, bn_updated, labels, name):
    """Metrics, parameters and BN statistics of a step against a JAX step;
    ``bn_updated`` names the port's BNs that ran in training mode."""
    np.testing.assert_allclose(ours["metrics"]["total_loss"], ref["metrics"]["total_loss"],
                               rtol=1e-5, err_msg=name)
    assert set(ours["metrics"]) == set(ref["metrics"])
    for k, v in ref["metrics"].items():
        np.testing.assert_allclose(ours["metrics"][k], v, rtol=VALUE, atol=1e-2 * VALUE,
                                   err_msg=f"{name} {k}")
    for k, label in labels.items():
        np.testing.assert_allclose(ours["state"][k], ref["state"][k], **PARAM,
                                   err_msg=f"{name} {k}")
    updated = 0
    for k, v in ref["state"].items():
        if k.endswith(("running_mean", "running_var")):
            _close(ours["state"][k], v, VALUE, f"{name} {k}")
            updated += k.endswith("running_var") and k.removesuffix(".running_var") in bn_updated
    assert updated > 0


def test_all_reduce_sum_values_and_gradients(dp_runs):
    """y = x_0 + x_1 on both ranks; rank r's loss is (r + 2) * sum(y), so
    each x's gradient is the sum of both ranks' weights, 2 + 3."""
    runs = dp_runs["all_reduce_sum"]
    total = runs[0]["x"] + runs[1]["x"]
    for r in runs:
        np.testing.assert_array_equal(r["y"], total)
        np.testing.assert_array_equal(r["grad"], np.full((2, 3), 5.0))


@pytest.mark.parametrize("world", [1, 2, 4])
def test_local_rows_tile_the_global_batch(world):
    batch = np.arange(8 * 3).reshape(8, 3)
    parts = [batch[local_rows(8, r, world)] for r in range(world)]
    assert all(len(p) == 8 // world for p in parts)
    np.testing.assert_array_equal(np.concatenate(parts), batch)
    with pytest.raises(ValueError, match="does not split"):
        local_rows(6, 0, 4)


def test_loader_ranks_give_the_single_process_batches(tmp_path):
    """For one seed, rank r's batches are rows [2r, 2r + 2) of each
    single-process batch of 4, bit for bit, for two shuffle generations."""
    cfg = train_cfg(*_make_crop_dataset(tmp_path))
    datasets = [PairDataset(cfg, ANCHORS, seed=7) for _ in range(WORLD + 1)]
    loaders = [DataLoader(datasets[0], 4, num_workers=0)] + [
        DataLoader(datasets[1 + r], 4, num_workers=0, rank=r, world=WORLD)
        for r in range(WORLD)]
    for _ in range(2):
        batches = [list(loader) for loader in loaders]
        assert len(batches[0]) == 2
        for whole, *parts in zip(*batches):
            for key, value in whole.items():
                np.testing.assert_array_equal(np.concatenate([p[key] for p in parts]), value,
                                              err_msg=key)
        for ds in datasets:
            ds.shuffle()
    with pytest.raises(ValueError, match="ragged"):
        DataLoader(datasets[0], 4, drop_last=False, rank=0, world=WORLD)


@pytest.mark.parametrize("step", [0, 1], ids=["frozen", "unfrozen"])
def test_default_mode_matches_jax_mesh_step(dp_runs, jax_runs, step):
    ours = dp_runs["default"][0]["steps"][step]
    _check_step(ours, jax_runs["default"][step], ours["bn_updated"],
                dp_runs["default"][0]["labels"], f"default step {step}")


def _step_error(ours, ref, before, labels):
    """The whole step's relative error of the parameter updates,
    sqrt(sum |ours - ref|^2 / sum |ref - before|^2), in float64."""
    err = sum(np.sum((ours[k].astype(np.float64) - ref[k]) ** 2)
              for k, label in labels.items() if label != "frozen")
    norm = sum(np.sum((ref[k].astype(np.float64) - before[k]) ** 2)
               for k, label in labels.items() if label != "frozen")
    return np.sqrt(err / norm)


@pytest.mark.parametrize("step", [0, 1], ids=["frozen", "unfrozen"])
def test_default_mode_matches_single_process_step(dp_runs, single_run, setup, step):
    """Sync-BN over the ranks is the single process's BN over the whole
    batch, running variances too (both biased over 4 rows' counts). In
    float64 the step's updates agree to 1e-9 of their norm, in float32 the
    parameters within rtol 1e-4 / atol 1e-6 and the frozen step's updates
    within 1e-4 (the unfrozen one carries ~1e-3 of float32 rounding through
    layer2/3's BN at 4 rows, as ``test_torch_train.py`` measures)."""
    initial = {k: v.numpy() for k, v in setup[3].items()}
    labels = dp_runs["default"][0]["labels"]
    for name, dtype in (("default", torch.float32), ("default64", torch.float64)):
        ours, ref = dp_runs[name][0]["steps"][step], single_run[dtype][step]
        before = initial if step == 0 else single_run[dtype][0]["state"]
        for k, v in ref["metrics"].items():
            np.testing.assert_allclose(ours["metrics"][k], v, rtol=1e-5, atol=1e-7,
                                       err_msg=f"{name} {k}")
        for k, v in ref["state"].items():
            if np.issubdtype(v.dtype, np.floating):
                np.testing.assert_allclose(ours["state"][k], v, **PARAM, err_msg=f"{name} {k}")
            else:
                np.testing.assert_array_equal(ours["state"][k], v, err_msg=f"{name} {k}")
        error = _step_error(ours["state"], ref["state"], before, labels)
        limit = 1e-9 if dtype == torch.float64 else (1e-4 if step == 0 else 1e-2)
        assert error < limit, (name, error)


@pytest.mark.parametrize("case", ["fused", "fused_sync"])
def test_fused_modes_match_jax_fused_step(dp_runs, jax_runs, case):
    ours = dp_runs[case]
    _check_step(ours[0]["steps"][0], jax_runs[case][0], ours[0]["steps"][0]["bn_updated"],
                ours[0]["labels"], case)


def test_ranks_hold_the_same_weights(dp_runs):
    """After every step of every case both ranks' states are bit-identical."""
    for name, _, _, _ in CASES:
        r0, r1 = dp_runs[name]
        for s0, s1 in zip(r0["steps"], r1["steps"]):
            np.testing.assert_array_equal(list(s0["metrics"].values()),
                                          list(s1["metrics"].values()), err_msg=name)
            for k, v in s0["state"].items():
                np.testing.assert_array_equal(v, s1["state"][k], err_msg=f"{name} {k}")


@pytest.mark.parametrize("case", ["nan", "nan_fused"])
def test_nan_in_one_ranks_batch_skips_both(dp_runs, setup, case):
    _, _, _, state = setup
    for r in dp_runs[case]:
        step = r["steps"][0]
        assert step["metrics"]["skipped"] == 1.0
        assert not np.isfinite(step["metrics"]["total_loss"])
        for k, v in state.items():
            np.testing.assert_array_equal(step["state"][k], v.numpy(), err_msg=f"{case} {k}")


def test_remat_matches_plain_step_on_the_ranks(dp_runs):
    """Remat with sync-BN: the same parameters and BN statistics as the
    default mode (float32 summation order: rtol 1e-6), the recompute's
    second BN update undone."""
    for plain, remat in zip(dp_runs["default"][0]["steps"], dp_runs["remat"][0]["steps"]):
        for k, v in plain["state"].items():
            np.testing.assert_allclose(remat["state"][k], v, rtol=1e-6, atol=1e-9, err_msg=k)


def test_collectives_per_step(dp_runs):
    """Default: the counts, the gradient bucket, the metrics, and two for
    each train-mode BN call (its statistics and their gradient); remat one
    more for each BN call, in the recompute. Fused: the bucket, the BN
    buffers and the metrics; with sync-BN two more for each BN call."""
    # frozen: the neck (template and search) and 3 heads x 3 BNs;
    # unfrozen: layer2/3's 32 BNs twice more
    bn_calls = {0: 11, 1: 75}
    for step, epoch in enumerate((0, 1)):
        default = dp_runs["default"][0]["steps"][step]["collectives"]
        assert default == 3 + 2 * bn_calls[epoch]
        assert dp_runs["remat"][0]["steps"][step]["collectives"] == default + bn_calls[epoch]
    assert dp_runs["fused"][0]["steps"][0]["collectives"] == 3
    assert dp_runs["fused_sync"][0]["steps"][0]["collectives"] == 3 + 2 * bn_calls[1]


def test_remat_step_matches_plain_step():
    """One process: remat's parameters, momentum and BN buffers are the
    plain step's, in the frozen and the unfrozen phase."""
    _, tbatch = make_batch(seed=5)
    *_, tset, topt, tlr = settings_pair()
    states = []
    for remat in (False, True):
        model = port_model(calibrated_variables(tbatch))
        trainer = Trainer(model, tset, topt, tlr, epochs=2, remat=remat)
        for epoch in (0, 1):
            trainer.step(tbatch, epoch)
        states.append({k: v.detach().clone() for k, v in model.state_dict().items()})
    for k, v in states[0].items():
        torch.testing.assert_close(states[1][k], v, rtol=1e-6, atol=1e-9, msg=k)


def test_sync_bn_alone_is_batchnorm_and_keeps_the_state_dict():
    """Without a group SyncBatchNorm2d is nn.BatchNorm2d bit for bit, in
    train and eval mode; the conversion keeps the tensors, the keys and
    each module's mode."""
    _, tbatch = make_batch(seed=5)
    variables = calibrated_variables(tbatch)
    models = [port_model(variables) for _ in range(2)]
    for m in models:
        m.features.features.unfix(True)
        m.train()
    model, synced = models
    params = list(synced.parameters())
    modes = [m.training for m in synced.modules()]
    assert convert_sync_bn(synced) is synced
    assert sum(isinstance(m, SyncBatchNorm2d) for m in synced.modules()) == 53
    assert list(synced.parameters()) == params
    assert [m.training for m in synced.modules()] == modes
    assert list(synced.state_dict()) == list(model.state_dict())
    with torch.no_grad():
        outs = [m.forward_train(tbatch["template"], tbatch["search"]) for m in models]
    for a, b in zip(*outs):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    for k, v in model.state_dict().items():
        torch.testing.assert_close(synced.state_dict()[k], v, rtol=0, atol=0, msg=k)


RANK_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "SLURM_NTASKS", "SLURM_PROCID",
            "SLURM_LOCALID", "MASTER_ADDR", "MASTER_PORT")


def test_init_distributed_reads_torchrun_env(monkeypatch):
    """No rank environment, or torchrun's for one process: no group, as
    ``init_multihost`` makes none. An explicit world of one over torchrun's
    MASTER_ADDR / MASTER_PORT: a gloo group on the CPU."""
    import torch.distributed as dist

    from siammask_tpu_torch.parallel.dist import _free_port, init_distributed

    for name in RANK_ENV:
        monkeypatch.delenv(name, raising=False)
    assert init_distributed("cpu") == (0, 1, torch.device("cpu"))
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("WORLD_SIZE", "1")
    monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
    monkeypatch.setenv("MASTER_PORT", str(_free_port()))
    assert init_distributed("cpu") == (0, 1, torch.device("cpu"))
    assert not dist.is_initialized()
    try:
        assert init_distributed("cpu", rank=0, world=1, timeout=120) == (
            0, 1, torch.device("cpu"))
        assert dist.get_backend() == "gloo" and dist.get_world_size() == 1
    finally:
        dist.destroy_process_group()


def test_init_distributed_under_slurm(monkeypatch):
    """One SLURM task with no MASTER_*: no group, the process alone (every
    sbatch/srun job sets SLURM_NTASKS). Two tasks with no MASTER_*: an error
    that names them, before any rendezvous."""
    import torch.distributed as dist

    from siammask_tpu_torch.parallel.dist import init_distributed

    for name in RANK_ENV:
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setenv("SLURM_NTASKS", "1")
    monkeypatch.setenv("SLURM_PROCID", "0")
    monkeypatch.setenv("SLURM_LOCALID", "0")
    assert init_distributed("cpu") == (0, 1, torch.device("cpu"))
    assert not dist.is_initialized()
    monkeypatch.setenv("SLURM_NTASKS", "2")
    with pytest.raises(RuntimeError, match="MASTER_ADDR and MASTER_PORT unset"):
        init_distributed("cpu")
    assert not dist.is_initialized()


def test_losses_with_global_counts_sum_over_shards_to_the_batch_loss():
    """Each shard's loss divided by the whole batch's counts: the shards'
    losses and mask metrics sum to the whole batch's (float64, to 1e-12),
    and with its own counts a loss is the one without counts, bit for bit."""
    from siammask_tpu_torch.models.losses import (select_cross_entropy_loss,
                                                  select_mask_logistic_loss, weight_l1_loss)

    _, batch = make_batch(seed=9, b=B)
    g = torch.Generator().manual_seed(0)
    k = batch["label_cls"].shape[1]
    score = torch.randn(B, 2 * k, 25, 25, generator=g, dtype=torch.float64)
    loc = torch.randn(B, 4 * k, 25, 25, generator=g, dtype=torch.float64)
    mask = torch.randn(B, 63 * 63, 25, 25, generator=g, dtype=torch.float64)
    data = {n: v.double() if v.is_floating_point() else v for n, v in batch.items()}

    def losses(rows, counts):
        cls = select_cross_entropy_loss(score[rows], data["label_cls"][rows],
                                        counts.get("npos"), counts.get("nneg"))
        l1 = weight_l1_loss(loc[rows], data["label_loc"][rows],
                            data["label_loc_weight"][rows], counts.get("batch"))
        m = select_mask_logistic_loss(mask[rows], data["label_mask"][rows],
                                      data["label_mask_weight"][rows], nval=counts.get("nval"))
        return torch.stack([cls, l1, m.loss, m.iou_mean, m.iou_at_5, m.iou_at_7])

    everything = slice(0, B)
    cls, w = data["label_cls"], data["label_mask_weight"]
    counts = {"npos": (cls == 1).sum().double(), "nneg": (cls == 0).sum().double(),
              "batch": B, "nval": (w == 1).sum().double()}
    whole = losses(everything, {})
    torch.testing.assert_close(losses(everything, counts), whole, rtol=0, atol=0)
    shards = sum(losses(local_rows(B, r, WORLD), counts) for r in range(WORLD))
    torch.testing.assert_close(shards, whole, rtol=1e-12, atol=1e-12)



def _rel_l2(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.mark.parametrize("case", list(JAX_BF16_MODES))
def test_bf16_modes_match_jax_mesh_step(dp_runs, jax_bf16_runs, case):
    """The frozen step of a bf16 model on two ranks, in the default mode
    and fused + sync-BN, against the JAX mesh step over its bf16
    ``SiamMaskBase`` from the same weights: no skip; the total loss within
    5e-3 relative (9.3e-4 / 1.0e-3 measured), each loss within 5e-2 (loc
    1.6e-2 measured, the largest; JAX's own bf16 step is 2.5e-2 off its
    float32 step there); the running mean of each BN that ran in training
    mode within 3e-2 of JAX's in relative L2 norm (1.0e-2 measured: a batch
    mean of bf16 maps) and its running variance within 3e-3 (4.5e-4)."""
    ours, ref = dp_runs[case][0]["steps"][0], jax_bf16_runs[case][0]
    assert ours["metrics"]["skipped"] == ref["metrics"]["skipped"] == 0.0
    np.testing.assert_allclose(ours["metrics"]["total_loss"], ref["metrics"]["total_loss"],
                               rtol=5e-3)
    for k in ("cls_loss", "loc_loss", "mask_loss"):
        np.testing.assert_allclose(ours["metrics"][k], ref["metrics"][k], rtol=5e-2, err_msg=k)
    updated = 0
    for k, v in ref["state"].items():
        name, _, stat = k.rpartition(".")
        if stat in ("running_mean", "running_var") and name in ours["bn_updated"]:
            err = _rel_l2(ours["state"][k], v)
            assert err < (3e-2 if stat == "running_mean" else 3e-3), (case, k, err)
            updated += 1
    assert updated == 2 * 10    # the neck's BN and 3 heads x 3 BNs


@pytest.mark.parametrize("step", [0, 1], ids=["frozen", "unfrozen"])
def test_bf16_default_mode_matches_single_process_step(dp_runs, single_bf16_run, layer_weights,
                                                       step):
    """A bf16 model on two ranks in the default mode against the port's
    single-process bf16 step on the whole batch, with bf16 noise measured in
    the same run as the yardstick: the two-rank step's updates no further
    from the single process's than half the single-process bf16 step is
    from its float32 step (the two-rank step 1.4e-2 / 0.50 off, the float32
    step 0.29 / 1.67, frozen / unfrozen, over the step), and so its BN
    running statistics, all of them in relative L2 norm (1.2e-8 / 6.4e-7
    against 3.2e-6 / 9.4e-6); the total loss within 1e-4 / 5e-3 relative
    (2.4e-6 / 1.1e-3 measured; the unfrozen step is the second, after
    updates already apart)."""
    initial = {k: v.numpy() for k, v in layer_weights[1].items()}
    labels = dp_runs["bf16"][0]["labels"]
    ours = dp_runs["bf16"][0]["steps"][step]
    ref, fp32 = single_bf16_run[torch.bfloat16][step], single_bf16_run[None][step]
    before = initial if step == 0 else single_bf16_run[torch.bfloat16][0]["state"]
    assert ours["metrics"]["skipped"] == ref["metrics"]["skipped"] == 0.0
    np.testing.assert_allclose(ours["metrics"]["total_loss"], ref["metrics"]["total_loss"],
                               rtol=1e-4 if step == 0 else 5e-3)
    error = _step_error(ours["state"], ref["state"], before, labels)
    noise = _step_error(fp32["state"], ref["state"], before, labels)
    assert error <= noise / 2, (error, noise)
    bn = [k for k in ref["state"] if k.endswith(("running_mean", "running_var"))]

    def flat(state):
        return np.concatenate([state[k].ravel() for k in bn])
    bn_error, bn_noise = (_rel_l2(flat(s["state"]), flat(ref["state"])) for s in (ours, fp32))
    assert bn_error <= bn_noise / 2, (bn_error, bn_noise)


def test_bf16_remat_matches_plain_step_on_the_ranks(dp_runs):
    """Remat on a bf16 model: the same parameters and BN statistics as its
    plain step (``test_remat_matches_plain_step_on_the_ranks``'s
    tolerances: the recompute rounds as the forward did)."""
    for plain, remat in zip(dp_runs["bf16"][0]["steps"], dp_runs["bf16_remat"][0]["steps"]):
        for k, v in plain["state"].items():
            np.testing.assert_allclose(remat["state"][k], v, rtol=1e-6, atol=1e-9, err_msg=k)


def test_collectives_carry_no_bf16(dp_runs):
    """Every collective of every case is float32 or float64; a bf16 model's
    steps issue as many as the float32 model's in the same mode: sync-BN's
    statistics and their gradients, the gradient bucket and the BN running
    statistics are float32, the loss normalizers and the metrics float64."""
    for name, _, _, _ in CASES:
        for step in dp_runs[name][0]["steps"]:
            assert set(step["collective_dtypes"]) <= {"float32", "float64"}, (name, step)
    for bf16, fp32 in (("bf16", "default"), ("bf16_remat", "remat")):
        assert [s["collectives"] for s in dp_runs[bf16][0]["steps"]] == \
            [s["collectives"] for s in dp_runs[fp32][0]["steps"]]
        assert all(s["collective_dtypes"] == ["float32", "float64"]
                   for s in dp_runs[bf16][0]["steps"])
    assert dp_runs["bf16_fused_sync"][0]["steps"][0]["collectives"] == 3 + 2 * 11


def test_sync_bn_reduces_bf16_statistics_in_float32(dp_runs):
    """``SyncBatchNorm2d`` on two ranks' rows of bf16 maps whose channels'
    means (50 to 150) are large against their spread (std 1), against the
    port's ``BatchNorm2d`` on all the rows (``F.batch_norm``, which
    reduces in float32): the output and the input's gradient within one
    bf16 step (rtol 2^-7; 5% of the outputs differ, by one step), the
    running mean within 1e-5 and the running variance within 1e-3 relative
    of its and of the float64 batch variance's (1e-4 measured), the ranks'
    weight and bias gradients summing to its within 1e-3 (6.5e-4). Summed
    in bf16, whose steps are 0.5 at 100, ``E[x^2] - E[x]^2`` would keep
    nothing of a variance of 1."""
    x = bn_input()
    ref = _torch_dp.sync_bn_rows(x, slice(0, 4))
    runs = dp_runs["sync_bn"]
    var = x.double().var(dim=(0, 2, 3), unbiased=False)
    torch.testing.assert_close(ref["running_var"].double(), 0.9 + 0.1 * var, rtol=1e-3, atol=0)
    for r, run in enumerate(runs):
        rows = local_rows(x.shape[0], r, WORLD)
        assert run["out"].dtype == run["grad_x"].dtype == torch.bfloat16
        for k in ("out", "grad_x"):
            torch.testing.assert_close(run[k].float(), ref[k][rows].float(), rtol=2**-7,
                                       atol=1e-3, msg=lambda m, k=k: f"rank {r} {k}: {m}")
        torch.testing.assert_close(run["running_mean"], ref["running_mean"], rtol=1e-5, atol=0)
        torch.testing.assert_close(run["running_var"], ref["running_var"], rtol=1e-3, atol=0)
    for k in ("grad_weight", "grad_bias"):
        torch.testing.assert_close(sum(run[k] for run in runs), ref[k], rtol=1e-3, atol=0,
                                   msg=k)
