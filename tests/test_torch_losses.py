"""The port's training losses against the JAX package's, on the same arrays.

The JAX losses take NHWC predictions, the port's NCHW; both take the same
labels. Values and gradients are fp32 sums in another order: 1e-5 relative,
with a floor of 1e-5 of the largest entry for gradients.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from siammask_tpu.models import losses as jlosses
from siammask_tpu_torch.models import losses

RNG_SEED = 21
K, S = 5, 25


def nhwc(a):
    return np.ascontiguousarray(np.moveaxis(a, 1, -1))


def _grad_close(ours, ref):
    np.testing.assert_allclose(ours, ref, rtol=1e-5, atol=1e-5 * np.abs(ref).max())


@pytest.mark.parametrize("positives", [True, False])
def test_cross_entropy_matches_jax(positives):
    rng = np.random.RandomState(RNG_SEED)
    pred = rng.randn(3, 2 * K, S, S).astype(np.float32) * 2
    p = [0.7, 0.2, 0.1] if positives else [0.7, 0.3, 0.0]
    label = rng.choice([-1, 0, 1], size=(3, K, S, S), p=p)
    ref, jgrad = jax.value_and_grad(jlosses.select_cross_entropy_loss)(
        jnp.asarray(nhwc(pred)), jnp.asarray(label, jnp.int32))
    tpred = torch.from_numpy(pred).requires_grad_()
    ours = losses.select_cross_entropy_loss(tpred, torch.from_numpy(label))
    ours.backward()
    np.testing.assert_allclose(ours.item(), float(ref), rtol=1e-5)
    _grad_close(nhwc(tpred.grad.numpy()), np.asarray(jgrad))


def test_weight_l1_matches_jax():
    rng = np.random.RandomState(RNG_SEED + 1)
    pred = rng.randn(3, 4 * K, S, S).astype(np.float32)
    label = rng.randn(3, 4, K, S, S).astype(np.float32)
    weight = (rng.rand(3, K, S, S) < 0.05).astype(np.float32) / 16
    ref, jgrad = jax.value_and_grad(jlosses.weight_l1_loss)(
        jnp.asarray(nhwc(pred)), jnp.asarray(label), jnp.asarray(weight))
    tpred = torch.from_numpy(pred).requires_grad_()
    ours = losses.weight_l1_loss(tpred, torch.from_numpy(label), torch.from_numpy(weight))
    ours.backward()
    np.testing.assert_allclose(ours.item(), float(ref), rtol=1e-5)
    _grad_close(nhwc(tpred.grad.numpy()), np.asarray(jgrad))


def _mask_case(branch, b, n_pos, seed):
    """(p_m for the port, p_m for JAX, mask, weight) for the base branch
    (4-D head output, 255 search, padding 32) or the sharp one (2-D refined
    rows, 143 search, padding 0)."""
    rng = np.random.RandomState(seed)
    s, hw = (S, 255) if branch == "base" else (3, 143)
    weight = np.zeros((b, s, s), np.float32)
    weight.reshape(-1)[rng.choice(b * s * s, size=n_pos, replace=False)] = 1.0
    flat = weight.reshape(-1)
    flat[rng.choice(np.flatnonzero(flat == 0), size=3, replace=False)] = -1.0  # ignored
    mask = np.sign(rng.randn(b, hw, hw)).astype(np.float32)
    if branch == "base":
        p_m = (rng.randn(b, 63 * 63, s, s) * 2).astype(np.float32)
        return p_m, nhwc(p_m), mask, weight
    p_m = (rng.randn(b * s * s, 127 * 127) * 2).astype(np.float32)
    return p_m, p_m, mask, weight


def _mask_losses(p_m, jp_m, mask, weight, padding, max_pos=None):
    def jfn(p):
        out = jlosses.select_mask_logistic_loss(p, jnp.asarray(mask), jnp.asarray(weight),
                                                padding=padding, max_pos=max_pos)
        return out.loss, out
    (_, ref), jgrad = jax.value_and_grad(jfn, has_aux=True)(jnp.asarray(jp_m))
    tp = torch.from_numpy(p_m).requires_grad_()
    ours = losses.select_mask_logistic_loss(tp, torch.from_numpy(mask),
                                            torch.from_numpy(weight), padding=padding,
                                            max_pos=max_pos)
    ours.loss.backward()
    return ours, ref, tp.grad.numpy(), np.asarray(jgrad)


@pytest.mark.parametrize("branch,b,n_pos", [
    ("base", 2, 20),     # the stage-1 shapes: (B, 3969, 25, 25) head output
    ("sharp", 9, 70),    # refined rows, more positives than 64
    ("base", 2, 0),      # no positives
    ("sharp", 2, 0),
])
def test_mask_loss_matches_jax(branch, b, n_pos):
    p_m, jp_m, mask, weight = _mask_case(branch, b, n_pos, seed=RNG_SEED + n_pos)
    padding = 32 if branch == "base" else 0
    ours, ref, grad, jgrad = _mask_losses(p_m, jp_m, mask, weight, padding)
    for field in ref._fields:
        np.testing.assert_allclose(float(getattr(ours, field)), float(getattr(ref, field)),
                                   rtol=1e-5, atol=1e-7, err_msg=field)
    if branch == "base":
        grad = nhwc(grad)
    if n_pos == 0:
        assert ours.loss.item() == 0.0 and ours.iou_mean.item() == 0.0
        assert not grad.any()
    else:
        _grad_close(grad, jgrad)


@pytest.mark.parametrize("branch", ["base", "sharp"])
def test_mask_loss_reports_overflow_beyond_max_pos(branch):
    """An explicit cap below the positives keeps max_pos rows and reports the
    rest. Which tied rows are kept is the top-k's choice on either side, so
    only the count is compared."""
    p_m, jp_m, mask, weight = _mask_case(branch, 2, 12, seed=RNG_SEED + 100)
    ours, ref, _, _ = _mask_losses(p_m, jp_m, mask, weight, 32 if branch == "base" else 0,
                                   max_pos=5)
    assert ours.pos_overflow.item() == float(ref.pos_overflow) == 7.0
    assert np.isfinite(ours.loss.item()) and ours.loss.item() > 0


def test_mask_loss_rejects_a_grid_mismatch():
    p_m, _, mask, weight = _mask_case("base", 1, 3, seed=RNG_SEED)
    with pytest.raises(ValueError):
        losses.select_mask_logistic_loss(torch.from_numpy(p_m), torch.from_numpy(mask),
                                         torch.from_numpy(weight), padding=0)
