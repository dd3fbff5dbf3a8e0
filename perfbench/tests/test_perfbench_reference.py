"""The plain reference against the program, the FLOP counts against the
counter, and the traffic against its seed; on the CPU at width 8."""
import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode, conv_backward_flop, conv_flop_count

from perfbench import flops, frames
from perfbench.drivers import train as train_driver
from perfbench.reference import model as M
from perfbench.reference import tracker as R
from perfbench.reference import train as T

WIDTH = 8


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def weights(family, width=WIDTH, seed=3):
    p = M.init_weights(M.spec(family, width), torch.Generator().manual_seed(seed), "cpu")
    for k, v in p.items():       # non-trivial BatchNorm statistics and biases
        if k.endswith(("running_mean", "bias")):
            v.normal_(0, 0.1, generator=torch.Generator().manual_seed(len(k)))
        elif k.endswith("running_var"):
            v.uniform_(0.5, 2.0, generator=torch.Generator().manual_seed(len(k)))
    return p


def port_model(family, p):
    from siammask_tpu_torch.models.siammask import SiamMaskBase, SiamMaskSharp
    model = (SiamMaskSharp if family == "sharp" else SiamMaskBase)(5, WIDTH)
    model.load_state_dict(p)
    return model


@pytest.mark.parametrize("family", ["sharp", "base"])
@pytest.mark.parametrize("width", [8, 64])
def test_spec_is_the_programs_state_dict(family, width):
    from siammask_tpu_torch.models.siammask import SiamMaskBase, SiamMaskSharp
    with torch.device("meta"):
        model = (SiamMaskSharp if family == "sharp" else SiamMaskBase)(5, width)
    theirs = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    assert M.spec(family, width) == theirs


def test_forward_matches_the_program():
    p = weights("sharp")
    model = port_model("sharp", {k: v.clone() for k, v in p.items()}).eval()
    net = M.Net(p, WIDTH)
    g = torch.Generator().manual_seed(0)
    z = 255 * torch.rand(2, 3, 127, 127, generator=g)
    x = 255 * torch.rand(2, 3, 255, 255, generator=g)
    with torch.no_grad():
        zf = model.template(z)
        out = model.track_mask(zf, x)
        cells = torch.tensor([[3, 20], [12, 12]])
        logits = model.track_refine(out.skips, out.corr, cells)
        rzf = net.template(z)
        p0, p1, p2, p3 = net.backbone(x)
        xf = net.neck(p3)
        cls, loc = net.rpn(rzf, xf)
        corr = net.corr("mask_model.mask", rzf, xf)
        w = M.skip_windows(p0, p1, p2, [3, 12], [20, 12])
        cvec = torch.stack([corr[0, :, 3, 20], corr[1, :, 12, 12]])
        rlogits = net.refine(*w, cvec)
    for a, b in ((zf, rzf), (out.score, cls), (out.loc, loc), (out.corr, corr),
                 (logits, rlogits)):
        assert torch.allclose(a, b, rtol=1e-4, atol=1e-4 * b.abs().max())


def test_fp8_control_differs():
    p = weights("base")
    x = 255 * torch.rand(1, 3, 127, 127, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        a = M.Net(p, WIDTH).template(x)
        b = M.Net(p, WIDTH, "fp8").template(x)
    rel = float((a - b).abs().max() / a.abs().max())
    assert 1e-3 < rel < 1.0


def test_tracker_step_matches_the_program():
    from siammask_tpu_torch.config import TrackerConfig
    from siammask_tpu_torch.tracker.tracker import Tracker
    p = weights("sharp")
    hp = {"seg_thr": 0.15, "penalty_k": 0.10, "window_influence": 0.41, "lr": 0.32}
    tracker = Tracker(port_model("sharp", {k: v.clone() for k, v in p.items()}).eval(),
                      TrackerConfig().update({**hp, "out_size": 127}), "cpu")
    g = torch.Generator().manual_seed(2)
    boxes = np.array([[[60, 50, 30, 40], [100, 70, 50, 24]], [[63, 52, 30, 40],
                                                               [97, 71, 50, 24]]], np.float32)
    pool = frames.render(g, boxes, (120, 200), "cpu")
    net = M.Net(p, WIDTH)
    pos, sz = torch.as_tensor(boxes[0, :, :2]), torch.as_tensor(boxes[0, :, 2:])
    with torch.no_grad():
        state = tracker.init_batched(pool[0], pos, sz)
        _, out = tracker.step_batched(state, pool[1])
        tmpl = R.Template(net, pool[0], pos, sz)
        ref = R.step(net, hp, tmpl, pool[1], pos, sz)
        at = R.step(net, hp, tmpl, pool[1], pos, sz, best=out.best_id)
    assert torch.equal(ref["best"], out.best_id)
    assert torch.allclose(out.target_pos, at["pos"], atol=1e-3)
    assert torch.allclose(out.target_sz, at["sz"], atol=1e-3)
    assert torch.allclose(out.mask_in_frame, at["mask"], atol=1e-4)


@pytest.mark.parametrize("kind", ["blobs", "speckle", "empty"])
def test_rotated_box_matches_the_programs_polygon(kind):
    """The reference's contour tracing, largest contour and least-area box
    against cv2's (the program's polygon), on ellipses and on speckled
    masks of many small components, some near the 100 px limit."""
    import cv2
    from siammask_tpu_torch.tracker.runtime import mask_to_rotated_box
    r = np.random.default_rng(4)
    for _ in range(40):
        mask = np.zeros((90, 140), np.uint8)
        if kind == "blobs":
            for _ in range(r.integers(1, 4)):
                cy, cx, a, b = r.integers(10, 80), r.integers(10, 130), *r.integers(3, 25, 2)
                yy, xx = np.mgrid[:90, :140]
                mask[((yy - cy) / a) ** 2 + ((xx - cx) / b) ** 2 <= 1] = 1
        elif kind == "speckle":
            k = r.integers(1, 6)
            cells = r.random((90 // k + 1, 140 // k + 1)) < r.uniform(0.2, 0.6)
            mask = np.kron(cells, np.ones((k, k))).astype(np.uint8)[:90, :140]
            contours = cv2.findContours(mask, cv2.RETR_EXTERNAL, cv2.CHAIN_APPROX_NONE)[-2]
            largest = R.largest_contour(mask)
            assert largest[0] == max(cv2.contourArea(c) for c in contours)
        pos, sz = np.array([70.0, 45.0]), np.array([20.0, 30.0])
        theirs = mask_to_rotated_box(mask, pos, sz)
        ours = R.rotated_box(mask, pos, sz)
        assert R.polygon_gap(np.asarray(theirs, float), ours) < 1e-4


def test_training_step_matches_the_program():
    from siammask_tpu_torch.train.trainer import OptimizerConfig, TrainSettings, train_step, \
        build_optimizer
    p = weights("base")
    model = port_model("base", {k: v.clone() for k, v in p.items()})
    model.features.features.unfix(True)
    model.train()
    opt, _ = build_optimizer(model, OptimizerConfig(), True)
    cfg = {"template_size": 127, "search_size": 255, "score_size": 25, "anchor_num": 5}
    batch = train_driver.make_batch(torch.Generator().manual_seed(5), 2, cfg, "cpu")
    settings = TrainSettings(task="base", loss_weight=(1.0, 1.2, 36.0), mask_pad=32)
    m = train_step(model, opt, batch, 0.004, settings, OptimizerConfig())
    net = M.Net({k: v.clone() for k, v in p.items()}, WIDTH, train_bn=T.trains)
    terms, grads = T.SGDStep(net, 0.004)(batch)
    for name, value in zip(("cls_loss", "loc_loss", "mask_loss"), terms):
        assert abs(float(m[name]) - value) <= 1e-5 * abs(value)
    # the unfrozen step's float32 gradients carry ~1% of rounding noise
    # through the train-mode BatchNorms: each leaf's change within 2% of the
    # larger of its own and the median leaf's
    theirs = dict(model.named_parameters())
    ours = {k: net.p[k] - p[k] for k in grads}
    med = float(np.median([float(v.norm()) for v in ours.values()]))
    for k, d in ours.items():
        gap = float((theirs[k].detach() - p[k] - d).norm())
        assert gap <= 2e-2 * max(float(d.norm()), med), k
    buffers = dict(model.named_buffers())
    for k in p:
        if k.endswith("running_var"):
            assert torch.allclose(buffers[k], net.p[k], rtol=1e-4), k


def test_lr_at_matches_the_programs_schedule():
    from siammask_tpu_torch.train.lr import build_lr_spaces
    lr = {"type": "log", "start_lr": 0.005, "end_lr": 0.0025,
          "warmup": {"start_lr": 0.001, "end_lr": 0.005, "type": "step", "step": 1, "epoch": 5}}
    spaces = build_lr_spaces(lr, 20)
    for epoch in range(20):
        assert abs(train_driver.lr_at(lr, 20, epoch) - spaces[epoch]) < 1e-12


def _dense(x_shape, w_shape, _b, _s, _p, _d, transposed, _op, groups, *a, out_shape=None,
           **k):
    return 0 if groups > 1 else conv_flop_count(x_shape, w_shape, out_shape,
                                                transposed=transposed)


def _dense_backward(grad_out_shape, x_shape, w_shape, _bias, _stride, _padding, _dilation,
                    transposed, _output_padding, groups, output_mask, out_shape):
    if groups > 1:       # the reference's xcorr: no dense conv
        return 0
    return conv_backward_flop.__wrapped__(grad_out_shape, x_shape, w_shape, _bias, _stride,
                                          _padding, _dilation, transposed, _output_padding,
                                          groups, output_mask, out_shape)


def counted(fn):
    aten = torch.ops.aten
    mapping = {aten.convolution: _dense, aten._convolution: _dense,
               aten.convolution_backward: _dense_backward}
    with FlopCounterMode(display=False, custom_mapping=mapping) as c:
        fn()
    return c.get_total_flops()


@pytest.mark.parametrize("width", [8, 64])
def test_track_flops_from_shapes(width):
    p = {k: v.to("meta") for k, v in M.init_weights(M.spec("sharp", width),
                                                    torch.Generator(), "cpu").items()}
    net = M.Net(p, width)
    zf = net.template(torch.zeros(1, 3, 127, 127, device="meta"))

    def frame():
        p0, p1, p2, p3 = net.backbone(torch.zeros(1, 3, 255, 255, device="meta"))
        xf = net.neck(p3)
        net.rpn(zf, xf)
        net.corr("mask_model.mask", zf, xf)
        w = [torch.zeros(1, t.shape[1], s, s, device="meta") for t, s in
             ((p0, 61), (p1, 31), (p2, 15))]
        net.refine(*w, torch.zeros(1, 4 * width, device="meta"))

    assert flops.track_flops(width) == counted(frame)
    if width == 64:      # the program bench's count (PERF.md, the scan row)
        assert round(flops.track_flops(64) / 1e9, 3) == 32.628


@pytest.mark.parametrize("width", [8, 64])
def test_train_flops_from_shapes(width):
    p = {k: v.to("meta") for k, v in M.init_weights(M.spec("base", width),
                                                    torch.Generator(), "cpu").items()}
    b = 2
    batch = {"template": torch.zeros(b, 3, 127, 127, device="meta"),
             "search": torch.zeros(b, 3, 255, 255, device="meta"),
             "label_cls": torch.zeros(b, 5, 25, 25, dtype=torch.long, device="meta"),
             "label_loc": torch.zeros(b, 4, 5, 25, 25, device="meta"),
             "label_loc_weight": torch.zeros(b, 5, 25, 25, device="meta"),
             "label_mask": torch.zeros(b, 255, 255, device="meta"),
             "label_mask_weight": torch.zeros(b, 25, 25, device="meta")}
    for k in p:
        if T.trains(k) and p[k].is_floating_point() and not k.endswith(("_mean", "_var")):
            p[k] = p[k].requires_grad_(True)
    net = M.Net(p, width, train_bn=T.trains)

    def step():
        cls, loc, mask = T.losses(net, batch)
        (cls + loc + mask).backward()

    assert flops.train_walk(width, b).training() == counted(step)
    if width == 64:      # the program bench's unfrozen step at batch 64
        assert round(flops.train_flops(64) * 64 / 1e9, 1) == 7169.1


def test_xcorr_bytes_bound():
    """The fp32 kernels' bound at B=64, 29.17 us (PERF.md's kernel table),
    is the bf16 one doubled."""
    least = sum(flops.xcorr_bytes(64, 256, elem=4).values()) / 3 / flops.PEAK_HBM_BYTES
    assert abs(least * 1e6 - 29.17) < 0.01


@pytest.mark.parametrize("seed", [0, 2 ** 31 + 5, 3 * 2 ** 32 + 1])
def test_traffic_follows_its_seed(seed):
    r1, r2 = frames.rng(seed, 2), frames.rng(seed, 2)
    b1 = frames.paths(r1, 4, [[50, 40]], [[20, 30]], 5.0)
    b2 = frames.paths(r2, 4, [[50, 40]], [[20, 30]], 5.0)
    assert np.array_equal(b1, b2)
    f1 = frames.render(frames.device_generator(seed, 2, "cpu"), b1, (80, 120), "cpu")
    f2 = frames.render(frames.device_generator(seed, 2, "cpu"), b2, (80, 120), "cpu")
    f3 = frames.render(frames.device_generator(seed + 1, 2, "cpu"), b1, (80, 120), "cpu")
    assert torch.equal(f1, f2) and not torch.equal(f1, f3)
    cfg = {"template_size": 127, "search_size": 255, "score_size": 25, "anchor_num": 5}
    a = train_driver.make_batch(frames.device_generator(seed, 4, "cpu"), 2, cfg, "cpu")
    b = train_driver.make_batch(frames.device_generator(seed, 4, "cpu"), 2, cfg, "cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert set(a["label_cls"].unique().tolist()) <= {-1, 0, 1}
