"""The port's depthwise xcorr and its gradients against the JAX package's,
the wrappers' input checks, the kernels on the card, and the port's import
hygiene.

On the CPU the wrappers take their plain versions (grouped convs); the JAX
side runs the Pallas kernel in interpret mode and its custom_vjp backward,
as tests/test_ops.py does.
"""
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from siammask_tpu.ops.xcorr import depthwise_xcorr_mm
from siammask_tpu.ops.xcorr_pallas import depthwise_xcorr_ad, depthwise_xcorr_pallas
from siammask_tpu_torch.ops import xcorr as xcorr_mod
from siammask_tpu_torch.ops.xcorr import (depthwise_xcorr, depthwise_xcorr_grad_input,
                                          depthwise_xcorr_grad_input_reference,
                                          depthwise_xcorr_grad_kernel,
                                          depthwise_xcorr_grad_kernel_reference,
                                          depthwise_xcorr_reference)

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
        "dtype": (x.half(), k.half()),
        "mixed_dtype": (x, k.bfloat16()),
        "batch": (x, torch.zeros(2, 3, 3, 8)),
        "channels": (x, torch.zeros(1, 3, 3, 4)),
        "too_big": (x, torch.zeros(1, 10, 3, 8)),
        "noncontiguous": (x.permute(0, 2, 1, 3), k),
    }[case]
    with pytest.raises((ValueError, TypeError)):
        depthwise_xcorr(*bad)


def test_xcorr_float64_on_cpu_matches_autograd_of_plain():
    """float64, which the train-step parity tests use, runs the plain
    versions on the CPU, forward and both gradients."""
    x, k = (torch.from_numpy(a).double().requires_grad_()
            for a in _pair((2, 9, 9, 8), (2, 3, 3, 8), seed=11))
    out = depthwise_xcorr(x, k)
    g = torch.randn(out.shape, dtype=torch.float64, generator=torch.Generator().manual_seed(12))
    grads = torch.autograd.grad(out, (x, k), g)
    ref = depthwise_xcorr_reference(x, k)
    assert out.dtype == torch.float64
    torch.testing.assert_close(out, ref, rtol=0, atol=0)
    # the same sums in another order, in float64
    for ours, r in zip(grads, torch.autograd.grad(ref, (x, k), g)):
        torch.testing.assert_close(ours, r, rtol=1e-12, atol=1e-12)


GRAD_SHAPES = [
    ((2, 29, 29, 256), (2, 5, 5, 256)),  # the training shape at batch 2
    ((3, 17, 23, 13), (3, 4, 3, 13)),    # ragged C and a non-square template
    ((2, 5, 5, 7), (2, 5, 5, 7)),        # 1x1 output
    ((2, 9, 9, 8), (2, 1, 1, 8)),        # 1x1 template: g is dx's size
    ((2, 12, 4, 8), (2, 5, 1, 8)),       # 5x1 template, search narrower than one strip
]


@pytest.mark.parametrize("xs,ks", GRAD_SHAPES)
def test_xcorr_grads_match_jax_vjp(xs, ks):
    """Gradients through the port's op against jax.vjp of the JAX package's
    trainable op, for the same upstream gradient."""
    x, k = _pair(xs, ks, seed=3)
    out, vjp = jax.vjp(depthwise_xcorr_ad, jnp.asarray(x), jnp.asarray(k))
    g = np.random.RandomState(4).randn(*out.shape).astype(np.float32)
    dx_ref, dk_ref = (np.asarray(a) for a in vjp(jnp.asarray(g)))
    tx, tk = (torch.from_numpy(a).requires_grad_() for a in (x, k))
    depthwise_xcorr(tx, tk).backward(torch.from_numpy(g))
    # fp32 sums in another order; dk sums Ho*Wo (625) products per entry
    np.testing.assert_allclose(tx.grad.numpy(), dx_ref, rtol=1e-4,
                               atol=1e-5 * np.abs(dx_ref).max())
    np.testing.assert_allclose(tk.grad.numpy(), dk_ref, rtol=1e-4,
                               atol=1e-5 * np.abs(dk_ref).max())


@pytest.mark.parametrize("xs,ks", GRAD_SHAPES)
def test_plain_grads_match_autograd_of_plain_forward(xs, ks):
    x, k = (torch.from_numpy(a).requires_grad_() for a in _pair(xs, ks, seed=5))
    out = depthwise_xcorr_reference(x, k)
    g = torch.randn(out.shape, generator=torch.Generator().manual_seed(6))
    dx, dk = torch.autograd.grad(out, (x, k), g)
    # the same sums in another order: 1e-5 of the largest entry
    for ours, ref in ((depthwise_xcorr_grad_input_reference(g, k, xs[1], xs[2]), dx),
                      (depthwise_xcorr_grad_kernel_reference(x, g), dk)):
        torch.testing.assert_close(ours, ref, rtol=1e-5, atol=1e-5 * ref.abs().max().item())


def test_backward_takes_a_strided_upstream_grad():
    """The heads permute the output to NCHW, so the grad arrives strided."""
    x, k = (torch.from_numpy(a).requires_grad_() for a in _pair((2, 9, 9, 8), (2, 3, 3, 8)))
    out = depthwise_xcorr(x, k).permute(0, 3, 1, 2)
    g = torch.randn(out.shape, generator=torch.Generator().manual_seed(7))
    out.backward(g)
    dx, dk = torch.autograd.grad(depthwise_xcorr_reference(x, k).permute(0, 3, 1, 2),
                                 (x, k), g)
    torch.testing.assert_close(x.grad, dx, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(k.grad, dk, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("needs", ["x", "k"])
def test_backward_computes_only_the_needed_grad(monkeypatch, needs):
    calls = []

    def spy(fn):
        def wrapped(*args):
            calls.append(fn.__name__)
            return fn(*args)
        return wrapped

    for name in ("depthwise_xcorr_grad_input", "depthwise_xcorr_grad_kernel"):
        monkeypatch.setattr(xcorr_mod, name, spy(getattr(xcorr_mod, name)))
    x, k = (torch.from_numpy(a) for a in _pair((1, 9, 9, 8), (1, 3, 3, 8)))
    (x if needs == "x" else k).requires_grad_()
    depthwise_xcorr(x, k).sum().backward()
    assert calls == [{"x": "depthwise_xcorr_grad_input",
                      "k": "depthwise_xcorr_grad_kernel"}[needs]]
    assert (x.grad is None) == (needs == "k") and (k.grad is None) == (needs == "x")


def test_grad_wrappers_on_cpu_count_no_launch():
    x, k = (torch.from_numpy(a) for a in _pair((1, 9, 9, 8), (1, 3, 3, 8)))
    g = torch.ones(1, 7, 7, 8)
    before = (depthwise_xcorr_grad_input.launches, depthwise_xcorr_grad_kernel.launches)
    depthwise_xcorr_grad_input(g, k, 9, 9)
    depthwise_xcorr_grad_kernel(x, g)
    assert (depthwise_xcorr_grad_input.launches,
            depthwise_xcorr_grad_kernel.launches) == before


@pytest.mark.parametrize("case", ["dtype", "shape", "noncontiguous", "batch"])
def test_grad_wrappers_reject_bad_input(case):
    x, k, g = torch.zeros(1, 9, 9, 8), torch.zeros(1, 3, 3, 8), torch.zeros(1, 7, 7, 8)
    bad_in, bad_k = {
        "dtype": ((g.half(), k.half(), 9, 9), (x, g.bfloat16())),
        "shape": ((g, k, 10, 9), (x, torch.zeros(1, 10, 7, 8))),
        "noncontiguous": ((g.permute(0, 2, 1, 3), k, 9, 9), (x.permute(0, 2, 1, 3), g)),
        "batch": ((g, torch.zeros(2, 3, 3, 8), 9, 9), (x, torch.zeros(2, 7, 7, 8))),
    }[case]
    with pytest.raises((ValueError, TypeError)):
        depthwise_xcorr_grad_input(*bad_in)
    with pytest.raises((ValueError, TypeError)):
        depthwise_xcorr_grad_kernel(*bad_k)


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
    ((64, 29, 29, 256), (64, 5, 5, 256), torch.float32),    # the training batch
    ((64, 7, 7, 256), (64, 5, 5, 256), torch.float32),      # stage 2: a 3x3 output
    ((3, 17, 23, 200), (3, 4, 3, 200), torch.float32),
    ((1, 29, 29, 256), (1, 5, 5, 256), torch.bfloat16),
    ((2, 5, 5, 7), (2, 5, 5, 7), torch.float32),            # 1x1 output
    ((3, 17, 23, 13), (3, 4, 3, 13), torch.float32),        # C below one channel tile
    ((64, 20, 20, 64), (64, 7, 7, 64), torch.float32),      # larger than the 5x5 window
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


@pytest.mark.cuda
@pytest.mark.parametrize("xs,ks,dtype", [
    ((1, 29, 29, 256), (1, 5, 5, 256), torch.float32),      # 8 blocks, fewer than the SMs
    ((16, 29, 29, 256), (16, 5, 5, 256), torch.float32),
    ((64, 29, 29, 256), (64, 5, 5, 256), torch.float32),    # the training batch
    ((64, 7, 7, 256), (64, 5, 5, 256), torch.float32),      # stage 2: a 3x3 output
    ((3, 17, 23, 200), (3, 4, 3, 200), torch.float32),
    ((1, 29, 29, 256), (1, 5, 5, 256), torch.bfloat16),
    ((2, 5, 5, 7), (2, 5, 5, 7), torch.float32),            # 1x1 output
    ((3, 17, 23, 13), (3, 4, 3, 13), torch.float32),        # C below one channel tile
    ((64, 20, 20, 64), (64, 7, 7, 64), torch.float32),      # more taps than one 5x5 group
    ((2, 9, 9, 8), (2, 1, 1, 8), torch.float32),            # 1x1 template
    ((2, 12, 4, 8), (2, 5, 1, 8), torch.float32),           # 5x1 template, one ragged strip
])
def test_xcorr_grad_kernels_match_plain_on_card(cuda_device, xs, ks, dtype):
    x, k = (torch.from_numpy(a).to(cuda_device, dtype) for a in _pair(xs, ks, seed=8))
    ho, wo = xs[1] - ks[1] + 1, xs[2] - ks[2] + 1
    g = torch.randn((xs[0], ho, wo, xs[3]), generator=torch.Generator().manual_seed(9))
    g = g.to(cuda_device, dtype)
    before = (depthwise_xcorr_grad_input.launches, depthwise_xcorr_grad_kernel.launches)
    dx = depthwise_xcorr_grad_input(g, k, xs[1], xs[2])
    dk = depthwise_xcorr_grad_kernel(x, g)
    torch.cuda.synchronize()
    assert (depthwise_xcorr_grad_input.launches,
            depthwise_xcorr_grad_kernel.launches) == (before[0] + 1, before[1] + 1)
    for ours, ref in ((dx, depthwise_xcorr_grad_input_reference(g, k, xs[1], xs[2])),
                      (dk, depthwise_xcorr_grad_kernel_reference(x, g))):
        scale = ref.float().abs().max().item()
        # fp32: summation order only; bf16: one rounding of the output each side
        atol = (1e-4 if dtype == torch.float32 else 2e-2) * scale
        torch.testing.assert_close(ours.float(), ref.float(), rtol=1e-5, atol=atol)


@pytest.mark.cuda
@pytest.mark.parametrize("which", ["input", "kernel"])
def test_xcorr_grad_kernel_is_deterministic_on_card(cuda_device, which):
    """No atomics: two calls at the training batch give the same bits."""
    x, k = (torch.from_numpy(a).to(cuda_device)
            for a in _pair((64, 29, 29, 256), (64, 5, 5, 256), seed=13))
    g = torch.randn((64, 25, 25, 256), generator=torch.Generator().manual_seed(14))
    g = g.to(cuda_device)
    call = {"input": lambda: depthwise_xcorr_grad_input(g, k, 29, 29),
            "kernel": lambda: depthwise_xcorr_grad_kernel(x, g)}[which]
    first = call()
    second = call()
    torch.cuda.synchronize()
    assert torch.equal(first, second)


@pytest.mark.cuda
def test_xcorr_autograd_on_card_launches_the_kernels(cuda_device):
    x, k = (torch.from_numpy(a).to(cuda_device).requires_grad_()
            for a in _pair((2, 29, 29, 256), (2, 5, 5, 256), seed=10))
    before = (depthwise_xcorr.launches, depthwise_xcorr_grad_input.launches,
              depthwise_xcorr_grad_kernel.launches)
    depthwise_xcorr(x, k).permute(0, 3, 1, 2).square().sum().backward()
    torch.cuda.synchronize()
    assert (depthwise_xcorr.launches, depthwise_xcorr_grad_input.launches,
            depthwise_xcorr_grad_kernel.launches) == tuple(b + 1 for b in before)
    dx, dk = torch.autograd.grad(
        depthwise_xcorr_reference(x, k).permute(0, 3, 1, 2).square().sum(), (x, k))
    for ours, ref in ((x.grad, dx), (k.grad, dk)):
        torch.testing.assert_close(ours, ref, rtol=1e-5, atol=1e-4 * ref.abs().max().item())


def _offset_copy(t: torch.Tensor) -> torch.Tensor:
    """A contiguous copy of ``t`` whose data starts one element past an
    aligned allocation: for bf16 a pointer 2 bytes off 4-byte alignment."""
    out = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)[1:].view(t.shape)
    return out.copy_(t)


@pytest.mark.parametrize("case,packed", [
    ("model", True), ("stage2", True), ("float32", False), ("odd_c", False),
    ("offset_search", False), ("offset_template", False), ("offset_grad", False),
    ("template_6x6", False)])
def test_packed_kernel_choice(case, packed):
    """The packed bf16 kernels take bf16 with even C, a template of at most
    5x5 and 4-byte aligned pointers (the model's shapes, stage 2's too);
    anything else takes the kernel of its dtype. For grad-kernel (x, g, dk)
    the template's size is dk's: the model's 25x25 g takes the packed
    kernel."""
    shapes = {"odd_c": ((2, 29, 29, 201), (2, 5, 5, 201)),
              "template_6x6": ((2, 29, 29, 256), (2, 6, 6, 256)),
              "stage2": ((2, 7, 7, 256), (2, 5, 5, 256))}
    xs, ks = shapes.get(case, ((2, 29, 29, 256), (2, 5, 5, 256)))
    dtype = torch.float32 if case == "float32" else torch.bfloat16
    x, k = (torch.from_numpy(a).to(dtype) for a in _pair(xs, ks))
    if case == "offset_search":
        x = _offset_copy(x)
    if case == "offset_template":
        k = _offset_copy(k)
    out = torch.empty((xs[0], xs[1] - ks[1] + 1, xs[2] - ks[2] + 1, xs[3]), dtype=dtype)
    if case == "offset_grad":
        out = _offset_copy(out)
    assert xcorr_mod.uses_packed_kernel(x, k, out) is packed
    assert xcorr_mod.uses_packed_kernel(out, k, x) is packed   # grad-input: (g, k, dx)
    # grad-kernel: (x, g, dk), the template dk
    assert xcorr_mod.uses_packed_kernel(x, out, k, template=2) is packed
    if case == "model":
        # read from g, the template would be 25x25: too big for the packed kernel
        assert not xcorr_mod.uses_packed_kernel(x, out, k)


def test_launch_passes_the_kernel_choice_and_counts_it(monkeypatch):
    """``_launch`` hands the C entry the kernel ``uses_packed_kernel`` picks
    (for grad-kernel from dk's size, not g's) and counts the packed launches
    beside the wrapper's count; a non-zero code raises."""
    calls = []

    class FakeLibrary:
        def __getattr__(self, entry):
            def launch(*args):
                calls.append((entry, args[10]))   # (..., dtype, kernel, device, stream)
                return 0
            return launch

    monkeypatch.setattr(xcorr_mod._build, "load_library", lambda: FakeLibrary())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: type("Stream", (), {"cuda_stream": 0})())
    for wrapper in (depthwise_xcorr, depthwise_xcorr_grad_input, depthwise_xcorr_grad_kernel):
        monkeypatch.setattr(wrapper, "launches", 0)
        monkeypatch.setattr(wrapper, "packed_launches", 0)
    x, k = (torch.from_numpy(a).bfloat16() for a in _pair((2, 29, 29, 256), (2, 5, 5, 256)))
    g = torch.zeros((2, 25, 25, 256), dtype=torch.bfloat16)
    dims = (2, 29, 29, 256, 5, 5)
    launch = xcorr_mod._launch
    launch(depthwise_xcorr, "siammask_depthwise_xcorr", x, k, tuple(g.shape), dims)
    launch(depthwise_xcorr, "siammask_depthwise_xcorr", _offset_copy(x), k, tuple(g.shape),
           dims)
    launch(depthwise_xcorr_grad_input, "siammask_depthwise_xcorr_grad_input", g, k,
           tuple(x.shape), dims)
    launch(depthwise_xcorr_grad_kernel, "siammask_depthwise_xcorr_grad_kernel", x, g,
           tuple(k.shape), dims)
    launch(depthwise_xcorr_grad_kernel, "siammask_depthwise_xcorr_grad_kernel", x,
           _offset_copy(g), tuple(k.shape), dims)
    launch(depthwise_xcorr, "siammask_depthwise_xcorr", x.float(), k.float(), tuple(g.shape),
           dims)
    assert calls == [("siammask_depthwise_xcorr", 1), ("siammask_depthwise_xcorr", 0),
                     ("siammask_depthwise_xcorr_grad_input", 1),
                     ("siammask_depthwise_xcorr_grad_kernel", 1),
                     ("siammask_depthwise_xcorr_grad_kernel", 0),
                     ("siammask_depthwise_xcorr", 0)]
    assert (depthwise_xcorr.launches, depthwise_xcorr.packed_launches) == (3, 1)
    assert (depthwise_xcorr_grad_input.launches,
            depthwise_xcorr_grad_input.packed_launches) == (1, 1)
    assert (depthwise_xcorr_grad_kernel.launches,
            depthwise_xcorr_grad_kernel.packed_launches) == (2, 1)

    class FailingLibrary(FakeLibrary):
        def __getattr__(self, entry):
            if entry == "siammask_cuda_error_string":
                return lambda code: b"invalid argument"
            return lambda *args: 1

    monkeypatch.setattr(xcorr_mod._build, "load_library", lambda: FailingLibrary())
    with pytest.raises(RuntimeError, match="packed bf16 kernel"):
        launch(depthwise_xcorr, "siammask_depthwise_xcorr", x, k, tuple(g.shape), dims)
    assert depthwise_xcorr.packed_launches == 1


# the bf16 shapes of the model's paths: tracking (B=1), 16 streams, the
# training batch and stage 2's 3x3 output
BF16_SHAPES = [((1, 29, 29, 256), (1, 5, 5, 256)), ((16, 29, 29, 256), (16, 5, 5, 256)),
               ((64, 29, 29, 256), (64, 5, 5, 256)), ((64, 7, 7, 256), (64, 5, 5, 256))]


def _bf16_call(which, xs, ks, seed, offset=False):
    """(output, plain version's output, packed launches it made) of one
    bf16 forward, grad-input or grad-kernel call on the card, its inputs
    copied to a 2-byte offset with ``offset``."""
    x, k = (torch.from_numpy(a).to("cuda", torch.bfloat16) for a in _pair(xs, ks, seed))
    g = torch.randn((xs[0], xs[1] - ks[1] + 1, xs[2] - ks[2] + 1, xs[3]),
                    generator=torch.Generator().manual_seed(seed + 1))
    g = g.to("cuda", torch.bfloat16)
    if offset:
        x, k, g = _offset_copy(x), _offset_copy(k), _offset_copy(g)
    wrapper, args, plain = {
        "forward": (depthwise_xcorr, (x, k), depthwise_xcorr_reference),
        "input": (depthwise_xcorr_grad_input, (g, k, xs[1], xs[2]),
                  depthwise_xcorr_grad_input_reference),
        "kernel": (depthwise_xcorr_grad_kernel, (x, g),
                   depthwise_xcorr_grad_kernel_reference)}[which]
    before = (wrapper.launches, wrapper.packed_launches)
    out = wrapper(*args)
    torch.cuda.synchronize()
    assert wrapper.launches == before[0] + 1
    return out, plain(*args), wrapper.packed_launches - before[1]


def _close_to_plain(out, ref):
    # one bf16 rounding of the output on each side
    scale = ref.float().abs().max().item()
    torch.testing.assert_close(out.float(), ref.float(), rtol=1e-5, atol=2e-2 * scale)


def _within_one_bf16_step(out, ref):
    """Each element of ``out`` at most one bf16 step (2^-7 of the binade of
    the larger of the two) from ``ref``'s, plus 2^-16 of ``ref``'s largest
    entry for float32 sums of the same terms in another order, which can
    differ by more than that step where they cancel to near zero."""
    a, b = out.float(), ref.float()
    step = torch.exp2(torch.floor(torch.log2(torch.maximum(a.abs(), b.abs()))) - 7)
    assert ((a - b).abs() <= step + 2.0 ** -16 * b.abs().max()).all()


@pytest.mark.cuda
@pytest.mark.parametrize("which", ["forward", "input"])
@pytest.mark.parametrize("xs,ks", BF16_SHAPES)
def test_packed_bf16_kernel_is_the_scalar_kernel_bit_for_bit_on_card(cuda_device, which, xs,
                                                                      ks):
    """At the model's bf16 shapes the wrapper takes the packed kernel; the
    same inputs at a 2-byte offset take the scalar bf16 kernel, and the two
    outputs are the same bits, within the plain version's tolerance."""
    packed, ref, n_packed = _bf16_call(which, xs, ks, seed=21)
    scalar, _, n_scalar = _bf16_call(which, xs, ks, seed=21, offset=True)
    assert (n_packed, n_scalar) == (1, 0)
    assert torch.equal(packed, scalar)
    _close_to_plain(packed, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("xs,ks", [
    *BF16_SHAPES,
    ((3, 17, 23, 200), (3, 4, 3, 200)),   # a partial channel tile, a 4x3 template
    ((2, 12, 12, 64), (2, 5, 5, 64)),     # two chunks, tap groups of 2, 2 and 1 rows
    ((2, 5, 5, 64), (2, 5, 5, 64)),       # a 1x1 g: one x row a tap row
    ((1, 7, 7, 64), (1, 5, 5, 64)),       # stage 2's 3x3 g at B=1: a cluster of tap rows
])
def test_packed_bf16_grad_kernel_on_card(cuda_device, xs, ks):
    """At the model's bf16 shapes, and at four that take the split's other
    paths, the grad-kernel wrapper takes the packed kernel: within the plain
    version's tolerance, within one bf16 step of the scalar kernel (which
    the same inputs at a 2-byte offset take; the two sum in other orders)
    and the same bits on a second call."""
    packed, ref, n_packed = _bf16_call("kernel", xs, ks, seed=25)
    scalar, _, n_scalar = _bf16_call("kernel", xs, ks, seed=25, offset=True)
    again, _, _ = _bf16_call("kernel", xs, ks, seed=25)
    assert (n_packed, n_scalar) == (1, 0)
    _close_to_plain(packed, ref)
    _within_one_bf16_step(packed, scalar)
    assert torch.equal(packed, again)


@pytest.mark.cuda
@pytest.mark.parametrize("which", ["forward", "input", "kernel"])
@pytest.mark.parametrize("case", ["odd_c", "offset"])
def test_scalar_bf16_kernel_takes_odd_c_and_offsets_on_card(cuda_device, which, case):
    xs, ks = {"odd_c": ((3, 29, 29, 201), (3, 5, 5, 201)),
              "offset": ((2, 29, 29, 256), (2, 5, 5, 256))}[case]
    out, ref, n_packed = _bf16_call(which, xs, ks, seed=23, offset=case == "offset")
    assert n_packed == 0
    _close_to_plain(out, ref)


def test_port_imports_no_jax_and_cv2_only_for_the_polygon():
    """No file of the port names jax, flax or siammask_tpu in an import, at
    any depth; every module imports without them or cv2, and cv2 loads only
    when mask_to_rotated_box runs; the eval toolkit and the eval CLI import
    with torch blocked."""
    import ast

    banned = {"jax", "flax", "siammask_tpu"}
    for path in sorted((REPO / "siammask_tpu_torch").rglob("*.py")):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                roots = [a.name.split(".")[0] for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                roots = [(node.module or "").split(".")[0]]
            else:
                continue
            assert not banned & set(roots), f"{path.relative_to(REPO)}:{node.lineno}"
    no_torch = textwrap.dedent("""
        import importlib, pkgutil, sys
        sys.modules["torch"] = None             # any import of torch now raises
        import siammask_tpu_torch.eval
        names = [m.name for m in pkgutil.walk_packages(siammask_tpu_torch.eval.__path__,
                                                       "siammask_tpu_torch.eval.")]
        for name in [*names, "siammask_tpu_torch.tools.eval"]:
            importlib.import_module(name)
        assert len(names) >= 6, names
        print("OK", len(names))
    """)
    proc = subprocess.run([sys.executable, "-c", no_torch], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0 and proc.stdout.startswith("OK"), proc.stdout + proc.stderr
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
