"""The port's crop, warp-back and nearest resize against the JAX package's
gather-path ops, on the same numpy inputs."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from siammask_tpu.ops import resize as jresize
from siammask_tpu.ops import sample as jsample
from siammask_tpu_torch.ops.resize import upsample_bilinear_align_corners, upsample_nearest
from siammask_tpu_torch.ops.sample import subwindow_crop, warp_back_mask

RNG = np.random.RandomState(7)


@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
@pytest.mark.parametrize("pos,crop_sz,model_sz", [
    ((100.0, 120.0), 80, 127),      # fully inside
    ((10.0, 10.0), 90, 127),        # off the top and left edges
    ((310.0, 230.0), 200, 255),     # off the bottom and right edges
    ((160.0, 120.0), 127, 127),     # crop_sz == model_sz: integer crop
    ((55.5, 77.25), 93, 127),       # fractional center
    ((160.0, 120.0), 400, 255),     # off every edge at once
    ((5.0, 235.0), 150, 127),       # bottom-left corner
    ((100.5, 100.5), 64, 127),      # half-pixel center: round half to even
])
def test_subwindow_crop_matches_jax(pos, crop_sz, model_sz, dtype):
    frame = RNG.uniform(0, 255, size=(240, 320, 3)).astype(dtype)
    avg = frame.astype(np.float32).mean(axis=(0, 1))
    ref = np.asarray(jsample.subwindow_crop(
        jnp.asarray(frame), jnp.asarray(pos, jnp.float32), jnp.asarray(float(crop_sz)),
        model_sz, jnp.asarray(avg)))
    ours = subwindow_crop(torch.from_numpy(frame), torch.tensor(pos, dtype=torch.float32),
                          torch.tensor(float(crop_sz)), model_sz, torch.from_numpy(avg))
    assert ours.dtype == torch.float32 and ours.shape == (model_sz, model_sz, 3)
    # 0-255 values; fp32 rounding of the blend only
    np.testing.assert_allclose(ours.numpy(), ref, atol=1e-3)


@pytest.mark.parametrize("back_box,out_hw", [
    ((-50.3, -20.7, 288.0, 216.0), (240, 320)),
    ((10.0, 30.0, 90.0, 60.0), (120, 160)),       # mask larger than the frame view
    ((-400.0, -300.0, 1200.0, 900.0), (96, 128)),  # mask lies well inside the frame
])
def test_warp_back_matches_jax(back_box, out_hw):
    mask = RNG.uniform(-6, 6, size=(127, 127)).astype(np.float32)
    ref = np.asarray(jsample.warp_back_mask(jnp.asarray(mask),
                                            jnp.asarray(back_box, jnp.float32), out_hw))
    ours = warp_back_mask(torch.from_numpy(mask), torch.tensor(back_box), out_hw)
    assert ours.shape == out_hw
    np.testing.assert_allclose(ours.numpy(), ref, atol=1e-5)


@pytest.mark.parametrize("in_sz,out_sz", [(15, 31), (31, 61), (61, 127), (16, 8)])
def test_upsample_nearest_matches_jax_exactly(in_sz, out_sz):
    x = RNG.randn(2, in_sz, in_sz, 4).astype(np.float32)
    ref = np.asarray(jresize.upsample_nearest(jnp.asarray(x), (out_sz, out_sz)))
    ours = upsample_nearest(torch.from_numpy(x), (out_sz, out_sz)).numpy()
    np.testing.assert_array_equal(ours, ref)


@pytest.mark.parametrize("in_hw,out_hw", [((63, 63), (127, 127)), ((5, 7), (9, 4)),
                                           ((1, 3), (2, 5))])
def test_upsample_bilinear_align_corners_matches_jax(in_hw, out_hw):
    x = RNG.randn(3, *in_hw, 2).astype(np.float32)
    ref = np.asarray(jresize.upsample_bilinear_align_corners(jnp.asarray(x), out_hw))
    ours = upsample_bilinear_align_corners(torch.from_numpy(x), out_hw).numpy()
    assert ours.shape == ref.shape
    # float32 interpolation weights computed two ways (a few ulps apart)
    np.testing.assert_allclose(ours, ref, rtol=1e-5, atol=1e-5 * np.abs(ref).max())


def test_bbox_helpers_match_jax():
    from siammask_tpu.utils import bbox as jbbox
    from siammask_tpu_torch.utils import bbox

    corners = RNG.uniform(0, 100, size=(4, 7)).astype(np.float32)
    for ours, ref in zip(bbox.corner2center(corners), jbbox.corner2center(corners)):
        np.testing.assert_array_equal(ours, ref)
    for ours, ref in zip(bbox.center2corner(corners), jbbox.center2corner(corners)):
        np.testing.assert_array_equal(ours, ref)
    np.testing.assert_array_equal(bbox.cxy_wh_2_rect((50.5, 20.0), (31.0, 12.5)),
                                  jbbox.cxy_wh_2_rect((50.5, 20.0), (31.0, 12.5)))
