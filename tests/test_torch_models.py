"""The port's SiamMask-sharp against the JAX package's at width 8 (the real
module tree and geometry, narrow channels), on the same weights and inputs.

The JAX model runs its DepthCorr heads through the Pallas kernel in interpret
mode; the port's run its xcorr's plain version on the CPU. Random weights
make activations large, so every comparison has a relative floor:
rtol=1e-4, atol=1e-4 * max|ref|.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from siammask_tpu.models.siammask import SiamMaskSharp as JaxSiamMaskSharp
from siammask_tpu.utils.torch_convert import invert_variables
from siammask_tpu_torch.models.heads import slice_skip_windows
from siammask_tpu_torch.models.siammask import SiamMaskSharp
from siammask_tpu_torch.utils.convert import load_reference_state_dict, state_dict_from_jax

from test_torch_tracker import one_torch_thread  # noqa: F401  (autouse)

WIDTH = 8


def jax_variables(model, seed=0):
    """model.init, then seeded non-trivial BN statistics and biases so that
    every leaf of the weight mapping is exercised."""
    z = jnp.zeros((1, 127, 127, 3), jnp.float32)
    x = jnp.zeros((1, 255, 255, 3), jnp.float32)
    variables = jax.jit(model.init)(jax.random.PRNGKey(seed), z, x)
    rng = np.random.RandomState(seed)

    def perturb(tree):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out[k] = perturb(v)
                continue
            v = np.asarray(v)
            if k in ("scale", "var"):
                v = rng.uniform(0.8, 1.2, v.shape).astype(np.float32)
            elif k in ("bias", "mean"):
                v = rng.normal(0.0, 0.05, v.shape).astype(np.float32)
            out[k] = v
        return out

    return {"params": perturb(variables["params"]),
            "batch_stats": perturb(variables["batch_stats"])}


def assert_close(ours, ref):
    ref = np.asarray(ref)
    ours = ours.detach().numpy() if isinstance(ours, torch.Tensor) else ours
    assert ours.shape == ref.shape
    np.testing.assert_allclose(ours, ref, rtol=1e-4, atol=1e-4 * np.abs(ref).max())


def nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a).transpose(0, 3, 1, 2)))


def to_nhwc(t):
    return t.permute(0, 2, 3, 1).numpy()


@pytest.fixture(scope="module")
def pair():
    jmodel = JaxSiamMaskSharp(width=WIDTH, xcorr_impl="pallas")
    variables = jax_variables(jmodel)
    model = SiamMaskSharp(width=WIDTH).eval()
    model.load_state_dict(state_dict_from_jax(variables), strict=True)
    rng = np.random.RandomState(3)
    z = rng.uniform(0, 255, (1, 127, 127, 3)).astype(np.float32)
    x = rng.uniform(0, 255, (1, 255, 255, 3)).astype(np.float32)
    return jmodel, variables, model, z, x


@pytest.fixture(scope="module")
def tracked(pair):
    jmodel, variables, model, z, x = pair
    zf = jax.jit(lambda v, z: jmodel.apply(v, z, method="template"))(variables, z)
    out = jax.jit(lambda v, zf, x: jmodel.apply(v, zf, x, method="track_mask"))(
        variables, zf, x)
    with torch.inference_mode():
        tzf = model.template(nchw(z))
        tout = model.track_mask(tzf, nchw(x))
    return zf, out, tzf, tout


def test_state_dict_matches_invert_variables(pair):
    _, variables, model, _, _ = pair
    ours = state_dict_from_jax(variables)
    ref = invert_variables(variables)
    assert set(ours) == set(ref) == set(model.state_dict())
    for name, value in ref.items():
        np.testing.assert_array_equal(ours[name].numpy(), value, err_msg=name)


def test_reference_checkpoint_loader_skips_bookkeeping_keys(pair):
    _, variables, _, _, _ = pair
    state = {f"module.{k}": v for k, v in invert_variables(variables).items()
             if not k.endswith("num_batches_tracked")}
    state["module.anchors"] = np.zeros((5, 4), np.float32)
    model = SiamMaskSharp(width=WIDTH)
    load_reference_state_dict(model, state)
    np.testing.assert_array_equal(model.refine_model.deconv.weight.detach().numpy(),
                                  variables["params"]["refine"]["deconv"]["kernel"])
    del state["module.refine_model.post2.bias"]
    with pytest.raises(KeyError):
        load_reference_state_dict(model, state)


@pytest.mark.parametrize("size", [127, 255])
def test_backbone_matches_jax(pair, size):
    jmodel, variables, model, z, x = pair
    img = z if size == 127 else x
    ref = jax.jit(lambda v, img: jmodel.apply(
        v, img, method=lambda m, i: m.backbone(i)))(variables, img)
    with torch.inference_mode():
        ours = model.features.features(nchw(img))
    for o, r in zip(ours, ref):
        assert_close(to_nhwc(o), r)


def test_template_matches_jax(tracked):
    zf, _, tzf, _ = tracked
    assert tzf.shape == (1, 4 * WIDTH, 7, 7)
    assert_close(to_nhwc(tzf), zf)


@pytest.mark.parametrize("field", ["score", "loc", "corr", "skips"])
def test_track_mask_matches_jax(tracked, field):
    _, out, _, tout = tracked
    if field == "skips":
        for o, r in zip(tout.skips, out.skips):
            assert_close(to_nhwc(o), r)
    else:
        assert_close(to_nhwc(getattr(tout, field)), getattr(out, field))


@pytest.mark.parametrize("cell", [(0, 0), (12, 12), (24, 24), (3, 20)])
def test_track_refine_matches_jax(pair, tracked, cell):
    jmodel, variables, model, _, _ = pair
    _, out, _, tout = tracked
    pos = jnp.asarray(cell, jnp.int32)
    ref = jax.jit(lambda v, s, c, p: jmodel.apply(v, s, c, p, method="track_refine"))(
        variables, out.skips, out.corr, pos)
    with torch.inference_mode():
        ours = model.track_refine(tout.skips, tout.corr, torch.tensor([cell]))
    assert ours.shape == (1, 127 * 127)
    assert_close(ours, ref)


@pytest.mark.parametrize("cell", [(0, 0), (24, 24)])
def test_skip_windows_zero_outside_the_map(tracked, cell):
    """The clamped gathers reproduce the reference's zero-padded slices."""
    _, _, _, tout = tracked
    windows = slice_skip_windows(*tout.skips, torch.tensor([cell]))
    for f, w, pad, scale, win in zip(tout.skips, windows, (16, 8, 4), (4, 2, 1),
                                     (61, 31, 15)):
        padded = torch.nn.functional.pad(f, (pad, pad, pad, pad))
        y, x = scale * cell[0], scale * cell[1]
        torch.testing.assert_close(w, padded[:, :, y:y + win, x:x + win], rtol=0, atol=0)
