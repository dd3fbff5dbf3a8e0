"""The port's sliding windows against the JAX package's: ``unfold_windows``
(both lowerings, with and without padding), ``unfold`` against
``F.unfold``, and the training path's ``unfold_skip_windows`` and
``SiamMaskSharp.refine_all`` at width 8, B=2, on the 3x3 grid of the 143x143
stage-2 search.

Windows are copies of the input, so they are held exactly. Refine's logits
are held row by row to 1e-4 of the largest reference value: each row is one
(sample, cell) and every row's inputs differ, so a row in the wrong place
fails."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from siammask_tpu.models.heads import unfold_skip_windows as jax_unfold_skip_windows
from siammask_tpu.models.siammask import SiamMaskSharp as JaxSiamMaskSharp
from siammask_tpu.ops.unfold import unfold_windows as jax_unfold_windows
from siammask_tpu_torch.models.heads import unfold_skip_windows
from siammask_tpu_torch.models.siammask import SiamMaskSharp
from siammask_tpu_torch.ops.unfold import FEW_WINDOWS, unfold, unfold_windows
from siammask_tpu_torch.utils.convert import state_dict_from_jax

from test_torch_models import jax_variables
from test_torch_tracker import one_torch_thread  # noqa: F401  (autouse)

WIDTH = 8
B = 2
# the stage-2 skip maps of a 143x143 search: p0, p1, p2 and the 3x3 corr
SKIP_SHAPES = ((B, 69, 69, WIDTH), (B, 35, 35, 4 * WIDTH), (B, 17, 17, 8 * WIDTH))
CORR_SHAPE = (B, 3, 3, 4 * WIDTH)


def nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a).transpose(0, 3, 1, 2)))


# (H, W, kernel, padding, stride): few windows without padding (static
# slices), then the Tensor.unfold path, with and without padding
CASES = [(17, 17, (15, 15), 0, 1), (69, 69, (61, 61), 0, 4), (13, 11, (3, 4), 0, 2),
         (9, 9, (3, 3), 1, 1), (12, 10, (5, 3), 2, 3), (5, 5, (3, 3), 1, 2)]


@pytest.mark.parametrize("h,w,kernel,padding,stride", CASES)
def test_unfold_windows_match_jax(h, w, kernel, padding, stride):
    x = np.random.RandomState(h * w + stride).randn(2, h, w, 3).astype(np.float32)
    ref = np.asarray(jax_unfold_windows(jnp.asarray(x), kernel, padding, stride))
    ours = unfold_windows(nchw(x), kernel, padding, stride)
    oh = (h + 2 * padding - kernel[0]) // stride + 1
    ow = (w + 2 * padding - kernel[1]) // stride + 1
    assert ours.shape == (2, oh * ow, 3, *kernel)
    np.testing.assert_array_equal(ours.permute(0, 1, 3, 4, 2).numpy(), ref)


def test_cases_cover_both_lowerings():
    few = [padding == 0 and ((h - k[0]) // s + 1) * ((w - k[1]) // s + 1) <= FEW_WINDOWS
           for h, w, k, padding, s in CASES]
    assert any(few) and not all(few)


@pytest.mark.parametrize("h,w,kernel,padding,stride", CASES)
def test_unfold_matches_torch(h, w, kernel, padding, stride):
    x = torch.from_numpy(np.random.RandomState(h + w).randn(2, 3, h, w).astype(np.float32))
    ref = F.unfold(x, kernel, padding=padding, stride=stride)
    assert torch.equal(unfold(x, kernel, padding, stride), ref)


@pytest.fixture(scope="module")
def skips():
    rng = np.random.RandomState(5)
    return [rng.randn(*s).astype(np.float32) for s in SKIP_SHAPES]


def test_unfold_skip_windows_match_jax(skips):
    """(B*9, C, win, win) each, batch-major, cells row-major, exactly JAX's."""
    refs = jax.jit(jax_unfold_skip_windows)(*skips)
    ours = unfold_skip_windows(*(nchw(s) for s in skips))
    for o, r, (c, win) in zip(ours, refs, ((WIDTH, 61), (4 * WIDTH, 31), (8 * WIDTH, 15))):
        assert o.shape == (B * 9, c, win, win)
        np.testing.assert_array_equal(o.permute(0, 2, 3, 1).numpy(), np.asarray(r))


def test_unfold_skip_windows_order(skips):
    """Row b*9 + i*3 + j is sample b's window at cell (i, j)."""
    w2 = unfold_skip_windows(*(nchw(s) for s in skips))[2]
    p2 = nchw(skips[2])
    for b in range(B):
        for i in range(3):
            for j in range(3):
                assert torch.equal(w2[b * 9 + i * 3 + j], p2[b, :, i:i + 15, j:j + 15])


def test_refine_all_matches_jax_row_by_row(skips):
    jmodel = JaxSiamMaskSharp(width=WIDTH)
    variables = jax_variables(jmodel)
    corr = np.random.RandomState(6).randn(*CORR_SHAPE).astype(np.float32)
    ref = np.asarray(jax.jit(lambda v, s, c: jmodel.apply(v, s, c, method="refine_all"))(
        variables, tuple(skips), corr))
    model = SiamMaskSharp(width=WIDTH).eval()
    model.load_state_dict(state_dict_from_jax(variables), strict=True)
    with torch.no_grad():
        ours = model.refine_all(tuple(nchw(s) for s in skips), nchw(corr)).numpy()
    assert ours.shape == ref.shape == (B * 9, 127 * 127)
    atol = 1e-4 * np.abs(ref).max()
    for row in range(B * 9):
        np.testing.assert_allclose(ours[row], ref[row], rtol=1e-4, atol=atol,
                                   err_msg=f"row {row}")
        others = np.delete(np.arange(B * 9), row)
        # each row is its own: no other reference row is as close
        assert all(np.abs(ours[row] - ref[o]).max() > 10 * atol for o in others), row
