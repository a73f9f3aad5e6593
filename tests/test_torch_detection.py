"""SSD detection in the port (`paddle_tpu_torch/ops/detection.py`,
`nn/detection_layers.py`, `models/ssd.py`, the `detection_map` evaluator)
against the JAX package's, on the CPU.

Case for case the JAX package's tests/test_detection.py (prior counts and
ranges, IoU, the coding round trip, bipartite matching, the loss falling,
NMS, the detection output's content, the layers end to end, the v1 packed
layers, mAP), and on numpy inputs from a seed, both packages side by side:
  * priors equal; IoU, coding, the loss and its gradients within 1e-5
    (gradients 1e-4 x max(1, max|g|)); match indices, NMS keep masks and
    index orders, detection labels equal;
  * `detection_output` whole, the padding rows too (every suppressed
    candidate scores exactly 0 and is ordered as `lax.top_k` orders ties),
    with fewer candidates than keep_top_k (zero rows appended) and more;
  * the 16x16 SSD graph of tests/test_detection.py trained 12 SGD steps
    in both packages from the JAX parameters: every cost, and the
    gradients of the first and the last step;
  * the evaluator on the same detections, 11-point and integral.
On a card (`cuda`, skipped here): the loss, its gradients and the
detections card against CPU, and SSD's training step captured as one
graph. jax is imported inside the CPU tests only."""

import numpy as np
import pytest
import torch

from paddle_tpu_torch.nn import graph as tgraph
from paddle_tpu_torch.nn.convert import params_from_jax
from paddle_tpu_torch.ops import detection as tdet

RTOL = 1e-5
GRAD_TOL = 1e-4


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _close(got, want, rtol=RTOL):
    want = np.asarray(want, np.float64)
    got = np.asarray(got, np.float64)
    scale = max(1.0, float(np.abs(want).max()) if want.size else 1.0)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * scale)


def _priors(fh=4, fw=4, image=64, mins=(24,), maxs=(40,), ars=(2.0,)):
    return tdet.prior_boxes((fh, fw), (image, image), list(mins), list(maxs), list(ars))


def _gt(rs, b, g, n_classes):
    """Ground truth as tests/test_detection.py draws SSD's: 1..g boxes an
    image, normalised corners, labels 1..n_classes-1, padding zero."""
    boxes = np.zeros((b, g, 4), np.float32)
    labels = np.zeros((b, g), np.int32)
    lengths = rs.randint(1, g + 1, b).astype(np.int32)
    for i in range(b):
        for j in range(lengths[i]):
            x0, y0 = rs.uniform(0, 0.6, 2)
            w, h = rs.uniform(0.15, 0.4, 2)
            boxes[i, j] = [x0, y0, min(x0 + w, 1.0), min(y0 + h, 1.0)]
            labels[i, j] = rs.randint(1, n_classes)
    return boxes, labels, lengths


# -- ops -----------------------------------------------------------------------


def test_prior_boxes_equal_jax():
    from paddle_tpu.ops import detection as jdet

    for args in [((2, 2), (32, 32), [8], [16], [2.0]), ((3, 5), (48, 80), [10, 20], [30], [2.0, 3.0]),
                 ((2, 2), (32, 32), [12], [], [])]:
        for clip in (True, False):
            got = tdet.prior_boxes(*args, clip=clip)
            want = jdet.prior_boxes(*args, clip=clip)
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g, w)
    boxes, var = tdet.prior_boxes((2, 2), (32, 32), [8], [16], [2.0])
    assert boxes.shape == (16, 4) and var.shape == boxes.shape
    assert (boxes >= 0).all() and (boxes <= 1).all()
    np.testing.assert_allclose(boxes[0], [0.125, 0.125, 0.375, 0.375])


def test_iou_and_coding_match_jax():
    from paddle_tpu.ops import detection as jdet

    a = np.array([[0.0, 0.0, 1.0, 1.0], [0.0, 0.0, 0.5, 0.5]], np.float32)
    b = np.array([[0.5, 0.5, 1.0, 1.0]], np.float32)
    np.testing.assert_allclose(tdet.iou_matrix(_t(a), _t(b)).numpy()[:, 0], [0.25, 0.0],
                               atol=1e-6)
    rs = np.random.RandomState(0)
    priors = np.stack([rs.uniform(0, 0.4, 12), rs.uniform(0, 0.4, 12),
                       rs.uniform(0.5, 1.0, 12), rs.uniform(0.5, 1.0, 12)], 1).astype(np.float32)
    var = np.full((12, 4), 0.1, np.float32)
    gt = priors + 0.05
    _close(tdet.iou_matrix(_t(priors), _t(gt)), jdet.iou_matrix(priors, gt))
    enc = tdet.encode_boxes(_t(priors), _t(var), _t(gt))
    _close(enc, jdet.encode_boxes(priors, var, gt))
    dec = tdet.decode_boxes(_t(priors), _t(var), enc)
    _close(dec, jdet.decode_boxes(priors, var, np.asarray(enc)))
    np.testing.assert_allclose(dec.numpy(), gt, atol=1e-5)


def test_match_priors_equals_jax_per_image():
    import jax
    import jax.numpy as jnp

    from paddle_tpu.ops import detection as jdet

    rs = np.random.RandomState(1)
    priors, _ = _priors(6, 6, 96, (20,), (36,), (2.0,))
    boxes, _, lengths = _gt(rs, 6, 5, 4)
    boxes[0, 1] = boxes[0, 0]  # two gts that want the same prior
    lengths[0] = max(lengths[0], 2)
    valid = np.arange(5)[None, :] < lengths[:, None]
    match, miou = tdet.match_priors(_t(priors), _t(boxes), _t(valid), 0.5)
    jmatch = jax.jit(lambda b, v: jdet.match_priors(jnp.asarray(priors), b, v, 0.5))
    for i in range(6):
        jm, ji = jmatch(jnp.asarray(boxes[i]), jnp.asarray(valid[i]))
        np.testing.assert_array_equal(match[i].numpy(), np.asarray(jm))
        _close(miou[i], ji)
    # bipartite: every valid gt holds a prior of its own
    for i in range(6):
        got = set(match[i].numpy().tolist()) - {-1}
        assert got == set(range(lengths[i]))
    # the JAX package's own case: a weak overlap still matches its best prior
    p3 = np.array([[0.0, 0.0, 0.3, 0.3], [0.35, 0.35, 0.65, 0.65], [0.7, 0.7, 1.0, 1.0]],
                  np.float32)
    m3, _ = tdet.match_priors(_t(p3), _t(np.array([[[0.4, 0.4, 0.9, 0.9]]], np.float32)),
                              torch.tensor([[True]]), 0.5)
    assert m3[0, 1] == 0


def _loss_case(seed=2, b=4, g=6, c=5):
    rs = np.random.RandomState(seed)
    priors, var = _priors(4, 4, 64, (24,), (40,), (2.0,))
    p = priors.shape[0]
    boxes, labels, lengths = _gt(rs, b, g, c)
    valid = np.arange(g)[None, :] < lengths[:, None]
    loc = rs.randn(b, p, 4).astype(np.float32)
    conf = rs.randn(b, p, c).astype(np.float32)
    return priors, var, boxes, labels, valid, loc, conf


def _jax_loss_and_grads(priors, var, boxes, labels, valid, loc, conf, **kw):
    import jax
    import jax.numpy as jnp

    from paddle_tpu.ops import detection as jdet

    def f(l, cf):
        return jnp.sum(jdet.multibox_loss(l, cf, jnp.asarray(priors), jnp.asarray(var),
                                          jnp.asarray(boxes), jnp.asarray(labels),
                                          jnp.asarray(valid), **kw))

    per = jax.jit(lambda l, cf: jdet.multibox_loss(
        l, cf, jnp.asarray(priors), jnp.asarray(var), jnp.asarray(boxes),
        jnp.asarray(labels), jnp.asarray(valid), **kw))(jnp.asarray(loc), jnp.asarray(conf))
    gl, gc = jax.jit(jax.grad(f, argnums=(0, 1)))(jnp.asarray(loc), jnp.asarray(conf))
    return np.asarray(per), np.asarray(gl), np.asarray(gc)


def _port_loss_and_grads(priors, var, boxes, labels, valid, loc, conf, device="cpu", **kw):
    dev = torch.device(device)
    lt = _t(loc).to(dev).requires_grad_(True)
    ct = _t(conf).to(dev).requires_grad_(True)
    per = tdet.multibox_loss(lt, ct, _t(priors).to(dev), _t(var).to(dev), _t(boxes).to(dev),
                             _t(labels).to(dev), _t(valid).to(dev), **kw)
    gl, gc = torch.autograd.grad(per.sum(), [lt, ct])
    return per.detach().cpu().numpy(), gl.cpu().numpy(), gc.cpu().numpy()


def _grad_close(got, want):
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=GRAD_TOL, atol=GRAD_TOL * scale)


@pytest.mark.parametrize("kw", [{}, dict(overlap_threshold=0.3, neg_pos_ratio=2.0),
                                dict(background_id=2)])
def test_multibox_loss_and_grads_match_jax(kw):
    case = _loss_case()
    want = _jax_loss_and_grads(*case, **kw)
    got = _port_loss_and_grads(*case, **kw)
    _close(got[0], want[0])
    _grad_close(got[1], want[1])
    _grad_close(got[2], want[2])


def test_multibox_loss_learns():
    """The JAX package's case: the loss falls when loc and conf step down
    their gradients."""
    priors, var = _priors(4, 4, 64, (24,), (40,), (2.0,))
    rs = np.random.RandomState(3)
    p = priors.shape[0]
    loc = _t(rs.randn(1, p, 4).astype(np.float32)).requires_grad_(True)
    conf = _t(rs.randn(1, p, 5).astype(np.float32)).requires_grad_(True)
    args = (_t(priors), _t(var), torch.tensor([[[0.1, 0.1, 0.45, 0.5]]]), torch.tensor([[3]]),
            torch.tensor([[True]]))
    l0 = tdet.multibox_loss(loc, conf, *args).sum()
    gl, gc = torch.autograd.grad(l0, [loc, conf])
    l1 = tdet.multibox_loss(loc - 0.1 * gl, conf - 0.1 * gc, *args).sum()
    assert torch.isfinite(l0) and l1 < l0


def test_nms_equals_jax():
    import jax
    import jax.numpy as jnp

    from paddle_tpu.ops import detection as jdet

    boxes = np.array([[0.0, 0.0, 0.5, 0.5], [0.02, 0.02, 0.52, 0.52], [0.6, 0.6, 0.9, 0.9]],
                     np.float32)
    keep, idx = tdet.nms(_t(boxes), torch.tensor([0.9, 0.8, 0.7]), iou_threshold=0.5, top_k=3)
    assert set(idx[keep].tolist()) == {0, 2}
    rs = np.random.RandomState(4)
    n = 60
    xy = rs.uniform(0, 0.7, (3, n, 2)).astype(np.float32)
    wh = rs.uniform(0.05, 0.3, (3, n, 2)).astype(np.float32)
    bx = np.concatenate([xy, xy + wh], -1)
    sc = rs.rand(3, n).astype(np.float32)
    sc[:, 10:20] = 0.5  # ties: the lower index first, as lax.top_k
    sc[:, 30:40] = 0.005  # under the score threshold
    keep, idx = tdet.nms(_t(bx), _t(sc), 0.45, 40, 0.01)
    jnms = jax.jit(lambda b, s: jdet.nms(b, s, 0.45, 40, 0.01))
    for i in range(3):
        jk, ji = jnms(jnp.asarray(bx[i]), jnp.asarray(sc[i]))
        np.testing.assert_array_equal(idx[i].numpy(), np.asarray(ji))
        np.testing.assert_array_equal(keep[i].numpy(), np.asarray(jk))


def _det_case(seed, b=3, c=5, fh=4):
    rs = np.random.RandomState(seed)
    priors, var = _priors(fh, fh, 64, (16,), (28,), (2.0,))
    p = priors.shape[0]
    loc = (rs.randn(b, p, 4) * 0.5).astype(np.float32)
    conf = (rs.randn(b, p, c) * 4.0).astype(np.float32)
    conf[0, :5, 2] = 8.0  # confident, overlapping boxes of one class
    return loc, conf, priors, var


@pytest.mark.parametrize("keep_top_k,nms_top_k,bg", [(110, 30, 0), (200, 30, 0), (250, 400, 0),
                                                     (70, 20, 3)])
def test_detection_output_whole_equals_jax(keep_top_k, nms_top_k, bg):
    """Every row, the zero-score padding rows too (labels and boxes of
    suppressed candidates, chosen by lax.top_k's tie order)."""
    import jax
    import jax.numpy as jnp

    from paddle_tpu.ops import detection as jdet

    loc, conf, priors, var = _det_case(5)
    kw = dict(num_classes=conf.shape[-1], background_id=bg, keep_top_k=keep_top_k,
              nms_top_k=nms_top_k)
    got = tdet.detection_output(_t(loc), _t(conf), _t(priors), _t(var), **kw).numpy()
    want = np.asarray(jax.jit(lambda *a: jdet.detection_output(*a, **kw))(
        jnp.asarray(loc), jnp.asarray(conf), jnp.asarray(priors), jnp.asarray(var)))
    assert got.shape == want.shape == (3, keep_top_k, 6)
    np.testing.assert_array_equal(got[..., 0], want[..., 0])
    _close(got[..., 1:], want[..., 1:])
    assert (got[..., 1] == 0).any()  # padding rows were compared


def test_detection_output_content():
    priors, var = tdet.prior_boxes((2, 2), (32, 32), [12], [], [])
    p = priors.shape[0]
    conf = np.full((1, p, 3), -4.0, np.float32)
    conf[0, 0, 2] = 6.0
    out = tdet.detection_output(torch.zeros(1, p, 4), _t(conf), _t(priors), _t(var),
                                num_classes=3, keep_top_k=10).numpy()
    assert out.shape == (1, 10, 6)
    assert out[0, 0, 0] == 2.0 and out[0, 0, 1] > 0.9
    np.testing.assert_allclose(out[0, 0, 2:], priors[0], atol=1e-5)


# -- layers and SSD ------------------------------------------------------------


def _ssd16(L, D):
    """tests/test_detection.py's 16x16 SSD net in either package."""
    img = L.Data("image", shape=(16, 16, 3))
    feat = L.Conv2D(img, 8, 3, padding=1, act="relu", name="feat")
    down = L.Pool2D(feat, 2, "max", name="down")
    n_cls = 4
    loc1 = L.Conv2D(feat, 16, 3, padding=1, act=None, name="loc1")
    conf1 = L.Conv2D(feat, n_cls * 4, 3, padding=1, act=None, name="conf1")
    loc2 = L.Conv2D(down, 16, 3, padding=1, act=None, name="loc2")
    conf2 = L.Conv2D(down, n_cls * 4, 3, padding=1, act=None, name="conf2")
    pb1 = D.PriorBox(feat, (16, 16), [4], [8], [2.0], name="pb1")
    pb2 = D.PriorBox(down, (16, 16), [8], [12], [2.0], name="pb2")
    gtb = L.Data("gt_boxes", shape=(None, 4))
    gtl = L.Data("gt_labels", shape=(None,))
    cost = D.MultiBoxLoss([loc1, loc2], [conf1, conf2], [pb1, pb2], gtb, gtl,
                          num_classes=n_cls, name="mbloss")
    out = D.DetectionOutput([loc1, loc2], [conf1, conf2], [pb1, pb2], num_classes=n_cls,
                            keep_top_k=20, name="detout")
    return cost, out


SSD16_BATCH = {
    "gt_boxes": np.array([[[0.1, 0.1, 0.4, 0.4], [0.5, 0.5, 0.8, 0.9]],
                          [[0.2, 0.3, 0.7, 0.8], [0.0, 0.0, 0.0, 0.0]]], np.float32),
    "gt_boxes.lengths": np.array([2, 1], np.int32),
    "gt_labels": np.array([[1, 2], [3, 0]], np.int32),
    "gt_labels.lengths": np.array([2, 1], np.int32),
}


def test_ssd16_trains_as_jax_over_12_steps():
    import jax

    from paddle_tpu.nn import detection_layers as JD
    from paddle_tpu.nn import layers as JL
    from paddle_tpu.nn.graph import Network as JNetwork, reset_name_scope
    from paddle_tpu_torch.nn import detection_layers as TD
    from paddle_tpu_torch.nn import layers as TL

    batch = dict(SSD16_BATCH, image=np.random.RandomState(0).randn(2, 16, 16, 3)
                 .astype(np.float32))
    reset_name_scope()
    jcost, jout = _ssd16(JL, JD)
    jnet = JNetwork([jcost, jout])
    params, states = jax.jit(lambda key: jnet.init(key, batch))(jax.random.PRNGKey(0))
    tgraph.reset_name_scope()
    tcost, tout = _ssd16(TL, TD)
    tnet = tgraph.Network([tcost])
    tdetect = tgraph.Network([tout])

    @jax.jit
    def jstep(p):
        def f(p):
            outs, _ = jnet.apply(p, states, batch, train=True)
            return outs["mbloss"].value

        l, g = jax.value_and_grad(f)(p)
        return jax.tree.map(lambda a, b: a - 0.05 * b, p, g), l, g

    tparams = params_from_jax(params, device="cpu")
    jp = params
    for step in range(12):
        tp = {k: v.requires_grad_(True) for k, v in tparams.items()}
        cost = tnet.apply(tp, batch, train=True)["mbloss"].value
        grads = dict(zip(tp, torch.autograd.grad(cost, list(tp.values()))))
        jp, jl, jg = jstep(jp)
        _close(float(cost), float(jl))
        if step in (0, 11):
            for k, g in grads.items():
                _grad_close(g.numpy(), np.asarray(jg[k]))
        tparams = {k: (v - 0.05 * grads[k]).detach() for k, v in tp.items()}
        if step == 0:
            l0 = float(cost)
    assert float(cost) < l0
    outs = jax.jit(lambda p: jnet.apply(p, states, batch)[0])(jp)
    want = np.asarray(outs["detout"].value)
    got = tdetect.apply(tparams, batch)["detout"].value.numpy()
    assert got.shape == want.shape == (2, 20, 6)
    np.testing.assert_array_equal(got[..., 0], want[..., 0])
    _close(got[..., 1:], want[..., 1:], rtol=1e-4)


def test_ssd_model_builds_the_jax_parameters():
    """models/ssd.py at a 32x32 image: the port's init makes the JAX
    package's parameter names and shapes; one forward of both from the
    same parameters gives the same cost."""
    import jax

    from paddle_tpu.models.ssd import ssd as jssd
    from paddle_tpu.nn.graph import Network as JNetwork, reset_name_scope
    from paddle_tpu_torch.models import ssd as tssd

    rs = np.random.RandomState(1)
    boxes, labels, lengths = _gt(rs, 2, 3, 21)
    batch = {"image": rs.randn(2, 32, 32, 3).astype(np.float32), "gt_boxes": boxes,
             "gt_boxes.lengths": lengths, "gt_labels": labels, "gt_labels.lengths": lengths}
    reset_name_scope()
    jnet = JNetwork([jssd(image_size=32, widths=(8, 8, 16))[3]])

    @jax.jit
    def init_and_cost(key):  # one compiled program for both
        params, states = jnet.init(key, batch)
        return params, jnet.apply(params, states, batch, train=True)[0]["mbox_loss"].value

    params, jcost = init_and_cost(jax.random.PRNGKey(0))
    tgraph.reset_name_scope()
    tnet = tgraph.Network([tssd(image_size=32, widths=(8, 8, 16))[3]])
    tparams = tnet.init(batch, device="cpu")
    assert {k: tuple(v.shape) for k, v in tparams.items()} == \
        {k: tuple(np.shape(v)) for k, v in params.items()}
    got = tnet.apply(params_from_jax(params, device="cpu"), batch, train=True)
    _close(float(got["mbox_loss"].value), float(jcost))


def test_v1_packed_detection_layers_match_jax():
    import jax

    from paddle_tpu.nn import detection_layers as JD
    from paddle_tpu.nn import layers as JL
    from paddle_tpu.nn.graph import Network as JNetwork, reset_name_scope
    from paddle_tpu_torch.nn import detection_layers as TD
    from paddle_tpu_torch.nn import layers as TL

    b, p = 2, 4
    rs = np.random.RandomState(0)
    priors = np.zeros((p, 8), np.float32)
    priors[:, 0] = np.linspace(0.0, 0.6, p)
    priors[:, 1] = 0.1
    priors[:, 2] = priors[:, 0] + 0.3
    priors[:, 3] = 0.5
    priors[:, 4:] = 0.1
    gt = np.zeros((b, 2, 6), np.float32)
    gt[:, 0] = [3, 0.05, 0.1, 0.35, 0.5, 0]
    batch = {"loc": rs.randn(b, p * 4).astype(np.float32) * 0.05,
             "conf": rs.randn(b, p * 21).astype(np.float32),
             "prior": np.tile(priors.reshape(1, -1), (b, 1)), "label": gt.reshape(b, -1)}

    def build(L, D):
        loc, conf = L.Data("loc", shape=(p * 4,)), L.Data("conf", shape=(p * 21,))
        prior, label = L.Data("prior", shape=(p * 8,)), L.Data("label", shape=(12,))
        return (D.MultiBoxLossV1([loc], [conf], prior, label, num_classes=21, name="mb"),
                D.DetectionOutputV1([loc], [conf], prior, num_classes=21, keep_top_k=5,
                                    name="det"))

    reset_name_scope()
    jnet = JNetwork(list(build(JL, JD)))  # no parameters, no states
    def japply(x):
        outs = jnet.apply({}, {}, {**batch, "loc": x})[0]
        return outs["mb"].value, outs

    jg, jouts = jax.jit(jax.grad(japply, has_aux=True))(jax.numpy.asarray(batch["loc"]))
    tgraph.reset_name_scope()
    tnet = tgraph.Network(list(build(TL, TD)))
    loc = _t(batch["loc"]).requires_grad_(True)
    touts = tnet.apply({"device": torch.zeros(())}, {**batch, "loc": loc})
    (tg,) = torch.autograd.grad(touts["mb"].value, [loc])
    _close(float(touts["mb"].value), float(jouts["mb"].value))
    _grad_close(tg.numpy(), np.asarray(jg))
    rows = touts["det"].value.detach().numpy()
    want = np.asarray(jouts["det"].value)
    assert rows.shape == (b, 5, 7)
    np.testing.assert_array_equal(rows[..., :2], want[..., :2])
    _close(rows[..., 2:], want[..., 2:])


# -- the evaluator -------------------------------------------------------------


def test_detection_map_case_of_the_jax_package():
    from paddle_tpu_torch.metrics.evaluators import EVALUATORS

    ev = EVALUATORS.get("detection_map")(ap_type="integral")
    ev.start()
    dets = np.zeros((1, 3, 6), np.float32)
    dets[0, 0] = [1, 0.9, 0.1, 0.1, 0.4, 0.4]
    dets[0, 1] = [1, 0.8, 0.6, 0.6, 0.9, 0.9]
    dets[0, 2] = [2, 0.7, 0.5, 0.5, 0.8, 0.8]
    ev.update(detections=torch.from_numpy(dets),
              gt_boxes=np.array([[[0.1, 0.1, 0.4, 0.4], [0.5, 0.5, 0.8, 0.8]]], np.float32),
              gt_labels=np.array([[1, 2]]), gt_lengths=np.array([2]))
    np.testing.assert_allclose(ev.finish(), 1.0)


@pytest.mark.parametrize("ap_type", ["11point", "integral"])
def test_detection_map_equals_jax(ap_type):
    from paddle_tpu.metrics.evaluators import DetectionMAPEvaluator as JMAP
    from paddle_tpu_torch.metrics.evaluators import DetectionMAPEvaluator as TMAP

    rs = np.random.RandomState(6)
    evs = [TMAP(ap_type=ap_type), JMAP(ap_type=ap_type)]
    for ev in evs:
        ev.start()
    for _ in range(3):
        boxes, labels, lengths = _gt(rs, 4, 5, 6)
        dets = np.zeros((4, 12, 6), np.float32)
        for i in range(4):
            for r in range(12):
                j = rs.randint(0, lengths[i])
                jitter = rs.uniform(-0.08, 0.08, 4)
                dets[i, r] = [labels[i, j] if rs.rand() < 0.8 else rs.randint(1, 6),
                              rs.rand(), *(boxes[i, j] + jitter)]
            dets[i, 10:, 1] = 0.0  # padding rows
        for ev in evs:
            ev.update(detections=dets, gt_boxes=boxes, gt_labels=labels, gt_lengths=lengths)
    got, want = evs[0].finish(), evs[1].finish()
    assert 0.0 < want < 1.0
    np.testing.assert_allclose(got, want, rtol=1e-12)


# -- on the card ---------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")


@pytest.mark.cuda
def test_cuda_loss_and_detections_match_cpu(cuda):
    case = _loss_case(seed=7, b=8, g=8, c=21)
    cpu = _port_loss_and_grads(*case)
    card = _port_loss_and_grads(*case, device="cuda")
    _close(card[0], cpu[0])
    _grad_close(card[1], cpu[1])
    _grad_close(card[2], cpu[2])
    loc, conf, priors, var = _det_case(8, b=4, c=21, fh=6)
    args = [_t(x) for x in (loc, conf, priors, var)]
    want = tdet.detection_output(*args, num_classes=21).numpy()
    got = tdet.detection_output(*[a.cuda() for a in args], num_classes=21).cpu().numpy()
    np.testing.assert_array_equal(got[..., 0], want[..., 0])
    np.testing.assert_allclose(got[..., 1:], want[..., 1:], rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
def test_cuda_ssd_step_is_one_graph(cuda):
    from paddle_tpu_torch.models import ssd
    from paddle_tpu_torch.optim import Adam
    from paddle_tpu_torch.trainer import SGDTrainer

    rs = np.random.RandomState(0)
    boxes, labels, _ = _gt(rs, 4, 8, 21)
    lengths = np.full(4, 8, np.int32)
    batch = {"image": rs.randn(4, 32, 32, 3).astype(np.float32), "gt_boxes": boxes,
             "gt_boxes.lengths": (boxes != 0).any(-1).sum(1).astype(np.int32),
             "gt_labels": labels, "gt_labels.lengths": lengths}
    tgraph.reset_name_scope()
    tr = SGDTrainer(ssd(image_size=32, widths=(8, 8, 16))[3], Adam(1e-3), device="cuda")
    tr.init_state(batch)
    costs = [float(tr.step(batch)) for _ in range(5)]
    graphs = list(tr.graphs.values())
    assert len(graphs) == 1 and graphs[0].replays == 4
    assert np.isfinite(costs).all() and costs[-1] < costs[0]
