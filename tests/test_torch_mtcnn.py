"""Port parity of MTCNN (models/mtcnn.py) on the CPU against the JAX
package's models/mtcnn.py, with the JAX parameters carried across through
utils/convert.mtcnn_state_dicts_from_jax, or facenet-keyed state dicts
(tests/test_mtcnn_parity.make_torch_state_dicts) loaded by the port directly
and converted for JAX by convert_facenet_state_dict.

Tolerances: net outputs 1e-5; the resampling weights and patches 1e-6;
NMS masks, top-k order on ties and pyramid scales exactly. The JAX side runs
jitted, as the JAX package runs it: XLA multiplies by the float32 reciprocal
of a constant divisor, and the port does the same. The full cascade
on JAX's calibrated recipe (make_test_image, calibrate_thresholds) box 1e-3
px, score 1e-4, face 1e-3, JAX's own parity bounds; mtcnn_align_batch row
by row the same, with weights whose scores do not saturate (±3 class-head
biases: at ±5 most of P-Net's top probabilities are exact float32 ties,
where a 1-ulp convolution difference could reorder them)."""

import argparse
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from real_time_video_deepfake_detection_tpu.models import mtcnn as JM
from real_time_video_deepfake_detection_tpu_torch.models import mtcnn as TM
from real_time_video_deepfake_detection_tpu_torch.utils.convert import (
    mtcnn_state_dicts_from_jax,
)

from tests.test_mtcnn_parity import (
    calibrate_thresholds, make_test_image, make_torch_state_dicts,
)


def _jax_tree(seed, bias=None):
    """JAX init_random_mtcnn(seed) as numpy, with ±bias class heads."""
    p = jax.tree.map(np.asarray, JM.init_random_mtcnn(seed))
    if bias is not None:
        b = np.asarray([-bias, bias], np.float32)
        p["pnet"]["conv4_1"]["b"] = b
        p["rnet"]["dense5_1"]["b"] = b
        p["onet"]["dense6_1"]["b"] = b
    return p


def _jax_from_facenet(sds):
    return {net: JM.convert_facenet_state_dict({k: v.numpy() for k, v in sd.items()}, net)
            for net, sd in sds.items()}


_FORWARD = {"pnet": (JM.pnet_forward, (2, 23, 31, 3)), "rnet": (JM.rnet_forward, (5, 24, 24, 3)),
            "onet": (JM.onet_forward, (5, 48, 48, 3))}


def _forward_pair(net, jparams, nets, seed):
    fn, shape = _FORWARD[net]
    x = np.random.default_rng(seed).uniform(-1, 1, shape).astype(np.float32)
    want = [np.asarray(o) for o in fn(jparams[net], jnp.asarray(x))]
    with torch.no_grad():
        got = nets[net](torch.from_numpy(x).permute(0, 3, 1, 2))
    # P-Net's maps come back NCHW
    got = [g.permute(0, 2, 3, 1) if g.ndim == 4 else g for g in got]
    assert len(got) == len(want)
    for w, g in zip(want, got):
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-5)


@pytest.mark.parametrize("net", TM.NETS)
def test_net_forward_matches_jax(net):
    tree = _jax_tree(1, bias=1.0)
    nets = TM.build_nets(mtcnn_state_dicts_from_jax(tree), "cpu")
    _forward_pair(net, tree, nets, 2)


@pytest.mark.parametrize("net", TM.NETS)
def test_facenet_state_dict_loads_directly(net):
    """facenet's keys load into the port's modules unchanged and give JAX's
    outputs on the same state dict through convert_facenet_state_dict."""
    sds = make_torch_state_dicts(0)
    nets = TM.build_nets(sds, "cpu")
    for k, v in sds[net].items():
        assert torch.equal(nets[net].state_dict()[k], v)
    _forward_pair(net, _jax_from_facenet(sds), nets, 3)


def test_init_random_mtcnn_draws_jax_values():
    tree = jax.tree.map(np.asarray, JM.init_random_mtcnn(5))
    got = TM.init_random_mtcnn(5)
    assert got["pnet"]["conv1.weight"].shape == (10, 3, 3, 3)
    np.testing.assert_array_equal(got["pnet"]["conv1.weight"].numpy(),
                                  tree["pnet"]["conv1"]["w"].transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(got["onet"]["dense6_3.weight"].numpy(),
                                  tree["onet"]["dense6_3"]["w"].T)
    np.testing.assert_array_equal(got["rnet"]["prelu4.weight"].numpy(), np.full(128, 0.25))
    assert set(got) == set(TM.NETS)


def test_state_dict_conversion_checks_keys_and_shapes():
    tree = _jax_tree(0)
    tree["rnet"]["dense9"] = tree["rnet"].pop("dense4")
    with pytest.raises(ValueError, match="unused leaves"):
        mtcnn_state_dicts_from_jax(tree)
    tree = _jax_tree(0)
    tree["onet"]["conv2"]["w"] = tree["onet"]["conv2"]["w"][:, :, :, :60]
    with pytest.raises(ValueError, match="shape"):
        mtcnn_state_dicts_from_jax(tree)


def _tie_boxes(seed):
    """Integer boxes with repeated scores and repeated boxes: exact IoU ties
    on both sides of both thresholds."""
    rng = np.random.default_rng(seed)
    xy = rng.integers(0, 40, (24, 2)).astype(np.float32)
    wh = rng.choice([8.0, 10.0, 16.0], (24, 2)).astype(np.float32)
    boxes = np.concatenate([xy, xy + wh], axis=1)
    boxes[12:16] = boxes[:4]
    boxes[16] = boxes[0] + [5, 0, 5, 0]            # IoU exactly 1/3 with box 0 at w 10
    scores = rng.choice([0.3, 0.55, 0.7, 0.9], 24).astype(np.float32)
    valid = scores >= 0.5
    valid[5] = False
    return boxes, scores, valid


@pytest.mark.parametrize("method_min", [False, True], ids=["union", "min"])
@pytest.mark.parametrize("thresh", [0.5, 0.7])
def test_nms_mask_equals_jax_on_ties(method_min, thresh):
    for seed in range(6):
        boxes, scores, valid = _tie_boxes(seed)
        want = np.asarray(JM._nms_mask(jnp.asarray(boxes), jnp.asarray(scores),
                                       jnp.asarray(valid), thresh, method_min))
        got = TM._nms_mask(*map(torch.from_numpy, (boxes, scores, valid)), thresh, method_min)
        np.testing.assert_array_equal(got.numpy(), want, err_msg=str(seed))
        # batched over a leading axis: the same masks row by row
        stack = [np.stack([a, a[::-1].copy()]) for a in (boxes, scores, valid)]
        got2 = TM._nms_mask(*map(torch.from_numpy, stack), thresh, method_min)
        want2 = np.asarray(JM._nms_mask(*map(jnp.asarray, (stack[0][1], stack[1][1],
                                                           stack[2][1])), thresh, method_min))
        np.testing.assert_array_equal(got2[0].numpy(), want)
        np.testing.assert_array_equal(got2[1].numpy(), want2)


def test_top_k_order_on_ties_equals_jax():
    rng = np.random.default_rng(4)
    x = rng.choice(np.float32([0.0, 0.25, 0.5, 1.0 - 4e-5, 1.0]), (3, 200)).astype(np.float32)
    for k in (1, 17, 64, 200):
        wv, wi = jax.lax.top_k(jnp.asarray(x), k)
        gv, gi = TM._top_k(torch.from_numpy(x), k)
        np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
        np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))


@pytest.mark.parametrize("hw", [(160, 160), (64, 64), (121, 97), (20, 300), (19, 40)])
def test_pyramid_scales_equal_jax(hw):
    assert TM.pyramid_scales(*hw) == JM.pyramid_scales(*hw)
    for scale in JM.pyramid_scales(*hw):
        assert int(hw[0] * scale + 1) > 0


def test_resampling_weights_match_jax():
    for n_in, n_out in ((160, 97), (97, 69), (13, 24), (24, 48)):
        np.testing.assert_array_equal(TM._adaptive_weights_np(n_in, n_out),
                                      JM._adaptive_weights_np(n_in, n_out))
    start = np.array([0, 3, -2, 50, 7], np.int32)
    length = np.array([10, 1, 0, 30, 90], np.int32)
    for fn_t, fn_j in ((TM._adaptive_weights_dyn, JM._adaptive_weights_dyn),
                       (TM._pil_weights_dyn, JM._pil_weights_dyn)):
        for out in (24, 48, 160):
            got = fn_t(torch.from_numpy(start), torch.from_numpy(length), out, 97).numpy()
            want = jax.jit(jax.vmap(lambda s, n: fn_j(s, n, out, 97)))(
                jnp.asarray(start), jnp.asarray(length))
            np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=1e-6)


def test_patch_and_face_extraction_match_jax():
    rng = np.random.default_rng(9)
    img = rng.uniform(0, 255, (2, 53, 71, 3)).astype(np.float32)
    boxes = np.array([[[3.7, -4.2, 40.9, 30.1], [10.0, 10.0, 80.5, 60.5], [0.2, 0.9, 1.5, 2.1]],
                      [[-10.0, 5.5, 20.0, 70.0], [30.3, 20.6, 55.2, 45.8],
                       [60.0, 40.0, 90.0, 70.0]]], np.float32)
    for out in (24, 48):
        got = TM._extract_patch_area(torch.from_numpy(img), torch.from_numpy(boxes), out)
        want = jax.jit(jax.vmap(jax.vmap(lambda b, i: JM._extract_patch_area(i, b, out),
                                         (0, None))))(jnp.asarray(boxes), jnp.asarray(img))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6 * 255)
    got = TM._extract_face_pil(torch.from_numpy(img), torch.from_numpy(boxes[:, 1]), 160)
    want = jax.jit(jax.vmap(lambda i, b: JM._extract_face_pil(i, b, 160)))(
        jnp.asarray(img), jnp.asarray(boxes[:, 1]))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6 * 255)


@pytest.mark.parametrize("seed", [0, 3])
def test_cascade_matches_jax_on_the_calibrated_recipe(seed):
    """JAX's parity recipe (tests/test_mtcnn_parity.py): calibrated
    thresholds keep every stage well inside its caps and away from
    saturated scores."""
    sds = make_torch_state_dicts(seed)
    img = make_test_image(seed=seed + 10)
    th = calibrate_thresholds(img, sds)
    bgr = img[..., ::-1].copy()
    jf, js, jb = JM.MTCNNAligner(_jax_from_facenet(sds), thresholds=th).detect(bgr)
    tf, ts, tb = TM.MTCNNAligner(sds, thresholds=th, device="cpu").detect(bgr)
    assert jf is not None, "the recipe found no face: the test would be inert"
    assert tf is not None
    assert ts == pytest.approx(js, abs=1e-4)
    np.testing.assert_allclose(tb, jb, rtol=0, atol=1e-3)
    np.testing.assert_allclose(tf, np.asarray(jf), rtol=0, atol=1e-3)
    assert tf.shape == (160, 160, 3) and tf.dtype == np.float32


def test_align_batch_matches_jax_row_by_row():
    tree = _jax_tree(5, bias=3.0)
    nets = TM.build_nets(mtcnn_state_dicts_from_jax(tree), "cpu")
    rng = np.random.default_rng(12)
    yy, xx = np.mgrid[:64, :64]
    base = 120 + 50 * np.sin(xx / 9.0) * np.cos(yy / 7.0)
    crops = np.clip(base[None, ..., None] + rng.normal(0, 30, (4, 64, 64, 3)), 0, 255)
    crops = crops.astype(np.float32)
    caps = dict(max_p=16, max_r=4, max_o=2)
    jf, js, jb = jax.jit(functools.partial(JM.mtcnn_align_batch, **caps))(
        jax.tree.map(jnp.asarray, tree), jnp.asarray(crops))
    tf, ts, tb = TM.mtcnn_align_batch(nets, torch.from_numpy(crops), **caps)
    js, jb, jf = map(np.asarray, (js, jb, jf))
    assert tf.shape == (4, 160, 160, 3) and ts.shape == (4,) and tb.shape == (4, 4)
    np.testing.assert_array_equal(ts.numpy() > 0, js > 0)
    assert (js > 0).any(), "no crop passed the cascade: the test would be inert"
    for i in np.flatnonzero(js > 0):
        assert float(ts[i]) == pytest.approx(float(js[i]), abs=1e-5), i
        np.testing.assert_allclose(tb[i].numpy(), jb[i], rtol=0, atol=1e-3, err_msg=str(i))
        np.testing.assert_allclose(tf[i].numpy(), jf[i], rtol=0, atol=1e-3, err_msg=str(i))


@pytest.fixture(scope="module")
def aligner():
    return TM.MTCNNAligner(_jax_tree_sds(5, 3.0), device="cpu")


def _jax_tree_sds(seed, bias):
    return mtcnn_state_dicts_from_jax(_jax_tree(seed, bias))


def test_aligner_tiny_input_and_no_face(aligner):
    assert aligner(np.zeros((8, 8, 3), np.uint8)) is None
    assert aligner.detect(np.zeros((19, 300, 3), np.uint8)) == (None, 0.0, None)
    # O-Net's head reversed: every crop is rejected
    sds = _jax_tree_sds(5, 3.0)
    sds["onet"]["dense6_1.bias"] = torch.tensor([3.0, -3.0])
    reject = TM.MTCNNAligner(sds, device="cpu")
    img = make_test_image(seed=10)[..., ::-1].copy()
    assert reject.detect(img) == (None, 0.0, None)
    assert reject(img) is None


def test_aligner_takes_bgr_and_equals_jax(aligner):
    img = make_test_image(seed=11)
    jal = JM.MTCNNAligner(jax.tree.map(jnp.asarray, _jax_tree(5, 3.0)))
    for bgr in (img, img[..., ::-1].copy()):
        tf, ts, tb = aligner.detect(bgr)
        jf, js, jb = jal.detect(bgr)
        assert (tf is None) == (jf is None)
        if tf is not None:
            assert ts == pytest.approx(js, abs=1e-4)
            np.testing.assert_allclose(tb, jb, rtol=0, atol=1e-3)
            np.testing.assert_allclose(tf, np.asarray(jf), rtol=0, atol=1e-3)
    # the channel order matters: BGR in, RGB out
    face, _, box = aligner.detect(img)
    assert face is not None
    rgb_face, _, _ = aligner.detect(img[..., ::-1].copy())
    assert rgb_face is None or not np.allclose(face, rgb_face)
    np.testing.assert_array_equal(aligner(img), face)


def test_pyramid_cache_is_bounded_lru(aligner):
    """The host aligner sees a new crop size for almost every face: the
    per-size pyramid matrices stay within PYRAMID_CACHE sizes (the JAX
    aligner's max_compiled), the oldest evicted first, and a size built
    again after its eviction detects as it did."""
    TM._pyramids.clear()
    rng = np.random.default_rng(7)
    crops = [rng.integers(0, 256, (20 + i, 24, 3), dtype=np.uint8)
             for i in range(TM.PYRAMID_CACHE + 6)]
    first = aligner.detect(crops[0])
    for c in crops[1:]:
        aligner.detect(c)
        assert len(TM._pyramids) <= TM.PYRAMID_CACHE
    assert [k[:2] for k in TM._pyramids] == [c.shape[:2] for c in crops[6:]]
    again = aligner.detect(crops[0])
    assert len(TM._pyramids) == TM.PYRAMID_CACHE
    assert list(TM._pyramids)[-1][:2] == crops[0].shape[:2]
    assert (again[0] is None) == (first[0] is None) and again[1] == first[1]
    if first[0] is not None:
        np.testing.assert_array_equal(again[0], first[0])
        np.testing.assert_array_equal(again[2], first[2])


def test_from_weights_directory_and_file_never_unpickle(tmp_path):
    sds = make_torch_state_dicts(0)
    d = tmp_path / "mtcnn"
    d.mkdir()
    for net, sd in sds.items():
        torch.save(sd, d / f"{net}.pt")
    a1 = TM.MTCNNAligner.from_weights(str(d), device="cpu")
    bundle = {f"{net}.{k}": v for net, sd in sds.items() for k, v in sd.items()}
    torch.save(bundle, tmp_path / "bundle.pt")
    a2 = TM.MTCNNAligner.from_weights(str(tmp_path / "bundle.pt"), device="cpu")
    for a in (a1, a2):
        assert set(a.nets) == set(TM.NETS)
        for net, sd in sds.items():
            for k, v in sd.items():
                assert torch.equal(a.nets[net].state_dict()[k], v), (net, k)
    evil = tmp_path / "evil.pt"
    torch.save({"pnet.conv1.weight": argparse.Namespace(boom=1)}, evil)
    with pytest.raises(Exception, match="[Ww]eights only load failed|Unsupported"):
        TM.MTCNNAligner.from_weights(str(evil), device="cpu")
    if not torch.cuda.is_available():   # the default device is the card
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            TM.MTCNNAligner.from_weights(str(d))
