"""The port's depthwise xcorr against the JAX package's, the wrapper's input
checks, the kernel on the card, and the port's import hygiene.

On the CPU the wrapper takes its plain version (a grouped conv); the JAX side
runs the Pallas kernel in interpret mode, as tests/test_ops.py does.
"""
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from siammask_tpu.ops.xcorr import depthwise_xcorr_mm
from siammask_tpu.ops.xcorr_pallas import depthwise_xcorr_pallas
from siammask_tpu_torch.ops.xcorr import depthwise_xcorr, depthwise_xcorr_reference

REPO = Path(__file__).resolve().parents[1]


def _pair(xs, ks, seed=0):
    rng = np.random.RandomState(seed)
    return rng.randn(*xs).astype(np.float32), rng.randn(*ks).astype(np.float32)


def test_xcorr_matches_pallas_interpret():
    x, k = _pair((2, 29, 29, 256), (2, 5, 5, 256))
    ref = np.asarray(depthwise_xcorr_pallas(jnp.asarray(x), jnp.asarray(k), interpret=True))
    ours = depthwise_xcorr(torch.from_numpy(x), torch.from_numpy(k)).numpy()
    assert ours.shape == (2, 25, 25, 256)
    # fp32 accumulation order differs (grouped conv vs unrolled taps)
    np.testing.assert_allclose(ours, ref, atol=1e-4)


@pytest.mark.parametrize("xs,ks", [
    ((1, 9, 9, 8), (1, 3, 3, 8)),
    ((3, 17, 23, 13), (3, 4, 3, 13)),   # ragged C and a non-square template
    ((2, 5, 5, 7), (2, 5, 5, 7)),       # 1x1 output
])
def test_xcorr_matches_mm(xs, ks):
    x, k = _pair(xs, ks, seed=1)
    ref = np.asarray(depthwise_xcorr_mm(jnp.asarray(x), jnp.asarray(k)))
    ours = depthwise_xcorr(torch.from_numpy(x), torch.from_numpy(k)).numpy()
    assert ours.shape == ref.shape
    np.testing.assert_allclose(ours, ref, atol=1e-4)


def test_xcorr_cpu_takes_plain_version_and_counts_no_launch():
    x, k = (torch.from_numpy(a) for a in _pair((1, 9, 9, 8), (1, 3, 3, 8)))
    before = depthwise_xcorr.launches
    out = depthwise_xcorr(x, k)
    assert depthwise_xcorr.launches == before
    torch.testing.assert_close(out, depthwise_xcorr_reference(x, k), rtol=0, atol=0)


@pytest.mark.parametrize("case", ["rank", "dtype", "mixed_dtype", "batch", "channels",
                                  "too_big", "noncontiguous"])
def test_xcorr_rejects_bad_input(case):
    x = torch.zeros(1, 9, 9, 8)
    k = torch.zeros(1, 3, 3, 8)
    bad = {
        "rank": (x[0], k),
        "dtype": (x.double(), k.double()),
        "mixed_dtype": (x, k.bfloat16()),
        "batch": (x, torch.zeros(2, 3, 3, 8)),
        "channels": (x, torch.zeros(1, 3, 3, 4)),
        "too_big": (x, torch.zeros(1, 10, 3, 8)),
        "noncontiguous": (x.permute(0, 2, 1, 3), k),
    }[case]
    with pytest.raises((ValueError, TypeError)):
        depthwise_xcorr(*bad)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("xs,ks,dtype", [
    ((1, 29, 29, 256), (1, 5, 5, 256), torch.float32),
    ((16, 29, 29, 256), (16, 5, 5, 256), torch.float32),
    ((3, 17, 23, 200), (3, 4, 3, 200), torch.float32),
    ((1, 29, 29, 256), (1, 5, 5, 256), torch.bfloat16),
])
def test_xcorr_kernel_matches_plain_on_card(cuda_device, xs, ks, dtype):
    x, k = (torch.from_numpy(a).to(cuda_device, dtype) for a in _pair(xs, ks, seed=2))
    before = depthwise_xcorr.launches
    out = depthwise_xcorr(x, k)
    torch.cuda.synchronize()
    assert depthwise_xcorr.launches == before + 1
    ref = depthwise_xcorr_reference(x, k)
    scale = ref.float().abs().max().item()
    # fp32: summation order only; bf16: one rounding of the output each side
    atol = (1e-4 if dtype == torch.float32 else 2e-2) * scale
    torch.testing.assert_close(out.float(), ref.float(), rtol=1e-5, atol=atol)


def test_port_imports_no_jax_and_cv2_only_for_the_polygon():
    """Every module of the port imports without jax, flax, siammask_tpu or
    cv2; cv2 loads only when mask_to_rotated_box runs."""
    code = textwrap.dedent("""
        import importlib, pkgutil, sys
        banned = ("jax", "flax", "siammask_tpu", "cv2")
        preloaded = {m for m in banned if m in sys.modules}
        import numpy as np
        import siammask_tpu_torch
        names = [m.name for m in pkgutil.walk_packages(siammask_tpu_torch.__path__,
                                                       "siammask_tpu_torch.")]
        for name in names:
            importlib.import_module(name)
        assert len(names) >= 15, names
        leaked = {m for m in banned if m in sys.modules} - preloaded
        assert not leaked, leaked
        from siammask_tpu_torch.tracker.runtime import mask_to_rotated_box
        mask = np.zeros((40, 40), np.uint8)
        mask[5:30, 8:35] = 1
        poly = mask_to_rotated_box(mask, (20.0, 20.0), (10.0, 10.0))
        assert poly.shape == (4, 2)
        assert "cv2" in sys.modules
        print("OK", len(names))
    """)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.startswith("OK")
