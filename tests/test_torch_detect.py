"""Port parity of the SSD detection path on the CPU, against the JAX
package: the prototxt parser and caffemodel reader, the Caffe graph
executor (models/caffe_net.py) on a small synthetic res10-class SSD
(utils/ssd_synth.py, channels (8, 8, 16, 16)), NMS on built ties, the box
selection (models/ssd_res10.detect_postprocess_batch) and the per-stream
crop and align (ops/resize.crop_resize_u8_cv2). Integer outputs and row
orders exactly, float blobs within 1e-4."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from real_time_video_deepfake_detection_tpu.models import caffe_net as JN
from real_time_video_deepfake_detection_tpu.models import ssd_res10 as JS
from real_time_video_deepfake_detection_tpu.ops import resize as JR
from real_time_video_deepfake_detection_tpu.utils import caffe_convert as JCC
from real_time_video_deepfake_detection_tpu.utils import prototxt as JP
from real_time_video_deepfake_detection_tpu.utils import ssd_synth as JSy
from real_time_video_deepfake_detection_tpu_torch.models import caffe_net as TN
from real_time_video_deepfake_detection_tpu_torch.models import ssd_res10 as TS
from real_time_video_deepfake_detection_tpu_torch.ops import resize as TR
from real_time_video_deepfake_detection_tpu_torch.utils import caffe_convert as TCC
from real_time_video_deepfake_detection_tpu_torch.utils import prototxt as TP
from real_time_video_deepfake_detection_tpu_torch.utils import ssd_synth as TSy

CHANNELS = (8, 8, 16, 16)


@pytest.fixture(scope="module", params=[True, False], ids=["decisive", "near_ties"])
def ssd(request, tmp_path_factory):
    """(decisive, prototxt, caffemodel, JAX SSDRes10, port SSDRes10) of one
    synthetic SSD, written by the port's ssd_synth."""
    d = tmp_path_factory.mktemp("ssd")
    proto, cm = TSy.res10_class_ssd(str(d), seed=0, channels=CHANNELS,
                                    decisive=request.param)
    return (request.param, proto, cm, JS.SSDRes10.from_caffemodel(cm, proto),
            TS.SSDRes10.from_caffemodel(cm, proto, device="cpu"))


def test_synth_files_prototxt_and_weights_equal_jax(ssd, tmp_path):
    decisive, proto, cm, jssd, tssd = ssd
    # the JAX package's ssd_synth writes the same files from the same seed
    jproto, jcm = JSy.res10_class_ssd(str(tmp_path), seed=0, channels=CHANNELS,
                                      decisive=decisive)
    for a, b in ((proto, jproto), (cm, jcm)):
        with open(a, "rb") as fa, open(b, "rb") as fb:
            assert fa.read() == fb.read()
    assert TP.load_prototxt(proto) == JP.load_prototxt(proto)
    tw, jw = TCC.load_caffemodel(cm), JCC.load_caffemodel(cm)
    assert list(tw) == list(jw)
    for name in jw:
        for a, b in zip(jw[name], tw[name]):
            np.testing.assert_array_equal(a, b)
    # the port's net holds every blob of the caffemodel, equal to the JAX
    # net's weights layer by layer
    net = tssd.net
    held = {}
    for i, lay in enumerate(net.layers):
        for j in range(net._n_blobs.get(i, 0)):
            held.setdefault(lay["name"], []).append(net._blob(i, j).numpy())
    assert set(held) == set(jssd.net.weights)
    for name, blobs in jssd.net.weights.items():
        assert len(held[name]) == len(blobs)
        for a, b in zip(blobs, held[name]):
            np.testing.assert_array_equal(a, b)


def test_pool_out_and_pooling_match_jax():
    for size in range(1, 40):
        for k, s, p in ((3, 2, 0), (2, 2, 0), (3, 2, 1), (3, 1, 1), (5, 3, 2)):
            if size + 2 * p >= k:
                assert TN._pool_out(size, k, s, p) == JN._pool_out(size, k, s, p)
    rng = np.random.default_rng(3)
    jnet = JN.CaffeNet.__new__(JN.CaffeNet)
    for mode in ("MAX", "AVE"):
        for (h, w), (k, s, p) in (((75, 75), (3, 2, 0)), ((38, 37), (3, 2, 1)),
                                  ((10, 11), (2, 2, 0)), ((19, 19), (5, 3, 2))):
            lay = {"pooling_param": {"pool": mode, "kernel_size": k, "stride": s, "pad": p}}
            x = rng.normal(0, 1, (2, h, w, 4)).astype(np.float32)
            want = np.asarray(jnet._pool(lay, jnp.asarray(x)))
            got = TN.CaffeNet._pool(lay, torch.from_numpy(x).permute(0, 3, 1, 2))
            assert got.shape[2:] == (TN._pool_out(h, k, s, p), TN._pool_out(w, k, s, p))
            np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want,
                                       rtol=0, atol=1e-6)


def test_caffe_net_blobs_and_detection_rows_match_jax(ssd):
    _, _, _, jssd, tssd = ssd
    rng = np.random.default_rng(4)
    x = (rng.integers(0, 256, (3, 3, 300, 300)) - 128).astype(np.float32)
    jb = jssd.net.forward(x)
    tb = tssd.net(torch.from_numpy(x))
    assert set(tb) == set(jb)
    for k, v in jb.items():
        a, b = np.asarray(v), tb[k].numpy()
        if a.ndim == 4 and b.shape != a.shape:   # JAX keeps conv blobs NHWC
            a = a.transpose(0, 3, 1, 2)
        np.testing.assert_allclose(b, a, rtol=0, atol=1e-4, err_msg=k)
    det_j = np.asarray(jb["detection_out"])
    det_t = tb["detection_out"].numpy()
    assert det_t.shape == det_j.shape == (3, 1, 200, 7)
    # identical row order: every row's score and box at the same position
    np.testing.assert_allclose(det_t, det_j, rtol=0, atol=1e-6)
    assert (det_j[..., 2] > 0.5).any()


def test_nms_identical_on_built_ties():
    """Equal scores, exact duplicates, nested and disjoint boxes: the kept
    scores, boxes and their order equal the JAX fori_loop NMS."""
    rng = np.random.default_rng(5)
    n = 64
    scores = np.round(rng.uniform(0, 1, (3, n)), 1).astype(np.float32)   # many ties
    scores[:, ::7] = 0.0
    scores[1] = 0.6                                                       # all equal
    base = rng.uniform(0, 0.8, (3, n, 2))
    size = rng.uniform(0.02, 0.3, (3, n, 2))
    boxes = np.concatenate([base, base + size], -1).astype(np.float32)
    boxes[:, 10] = boxes[:, 11]                                           # duplicates
    boxes[2, :8] = [0.1, 0.1, 0.5, 0.5]
    for top_k, out_k in ((40, 20), (64, 80)):
        got_s, got_b = TN._nms_padded(torch.from_numpy(scores), torch.from_numpy(boxes),
                                      0.3, top_k, out_k)
        for i in range(3):
            want_s, want_b = JN._nms_padded(jnp.asarray(scores[i]), jnp.asarray(boxes[i]),
                                            0.3, top_k, out_k)
            np.testing.assert_array_equal(got_s[i].numpy(), np.asarray(want_s))
            np.testing.assert_array_equal(got_b[i].numpy(), np.asarray(want_b))


def test_detect_postprocess_batch_exact():
    rng = np.random.default_rng(6)
    rows = np.zeros((5, 1, 30, 7), np.float32)
    rows[..., 2] = np.sort(rng.uniform(0, 1, (5, 1, 30)), -1)[..., ::-1]
    rows[..., 3:5] = rng.uniform(-0.2, 0.9, (5, 1, 30, 2))
    rows[..., 5:7] = rows[..., 3:5] + rng.uniform(0, 0.5, (5, 1, 30, 2))
    rows[0, 0, 0, 3] = np.nan                   # non-finite rows never count
    rows[1, 0, 0, 5] = np.inf
    rows[2, 0, :, 2] = 0.5                      # conf must be strictly > 0.5
    rows[3, 0, 0, 3:7] = [0.1, 0.1, 0.1 + 21 / 320, 0.1 + 21 / 240]   # 20/21 px edges
    for thr, mpx in ((0.5, 20), (0.3, 5)):
        want = jax.jit(lambda d: JS.detect_postprocess_batch(d, 240, 320, thr, mpx))(rows)
        got = TS.detect_postprocess_batch(torch.from_numpy(rows), 240, 320, thr, mpx)
        for k in ("box_xywh", "has_face", "n_faces"):
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)
        assert got["box_xywh"].dtype == torch.int32


def test_batched_and_host_detect_match_jax(ssd):
    _, _, _, jssd, tssd = ssd
    frames = np.random.default_rng(7).integers(0, 256, (3, 240, 320, 3), dtype=np.uint8)
    want = JS.make_detect_batch(jssd.net, 0.5, 20)(jnp.asarray(frames))
    got = TS.make_detect_batch(tssd.net, 0.5, 20)(torch.from_numpy(frames))
    for k in ("box_xywh", "has_face", "n_faces"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)
    assert bool(got["has_face"].any())
    for f in frames:
        assert tssd.detect(f, 0.5, 20) == jssd.detect(f, 0.5, 20)


@pytest.mark.parametrize("dst", [(160, 160), (48, 40)])
def test_crop_resize_bit_exact(dst):
    """Random, frame-edge, identity and exact-2x boxes."""
    rng = np.random.default_rng(8)
    imgs = rng.integers(0, 256, (4, 240, 320, 3), dtype=np.uint8)
    dh, dw = dst
    boxes = [(5, 7, 33, 47), (0, 0, 320, 240), (319, 239, 1, 1), (300, 200, 20, 40),
             (10, 20, dw, dh), (40, 30, 2 * dw, 2 * dh), (0, 0, 0, 0)]
    for _ in range(9):
        w, h = int(rng.integers(1, 320)), int(rng.integers(1, 240))
        boxes.append((int(rng.integers(0, 321 - w)), int(rng.integers(0, 241 - h)), w, h))
    boxes = np.asarray(boxes[:16], np.int32).reshape(4, 4, 4)
    f = jax.jit(jax.vmap(lambda im, b: JR.crop_resize_u8_cv2(im, b, dh, dw)))
    for j in range(4):
        want = np.asarray(f(jnp.asarray(imgs), jnp.asarray(boxes[:, j])))
        got = TR.crop_resize_u8_cv2(torch.from_numpy(imgs), torch.from_numpy(boxes[:, j]),
                                    dh, dw).numpy()
        np.testing.assert_array_equal(got, want, err_msg=str(boxes[:, j]))
    # the static path agrees on an in-frame exact-2x and identity box
    big = rng.integers(0, 256, (1, 2 * dh + 8, 2 * dw + 8, 3), dtype=np.uint8)
    for x, y, w, h in ((4, 6, 2 * dw, 2 * dh), (3, 5, dw, dh)):
        got = TR.crop_resize_u8_cv2(torch.from_numpy(big),
                                    torch.tensor([[x, y, w, h]], dtype=torch.int32),
                                    dh, dw)[0].numpy()
        want = np.asarray(JR.resize_bilinear_u8_cv2(big[0, y:y + h, x:x + w], dh, dw))
        np.testing.assert_array_equal(got, want)


def test_caffe_net_bn_scale_eltwise_layers_match_jax(tmp_path):
    """The layers of the real res10 graph that the synthetic SSD lacks:
    BatchNorm (with its scale factor), Scale with a bias, AVE and global
    pooling, Eltwise PROD and MAX."""
    rng = np.random.default_rng(9)
    txt = ('name: "bn_net"\ninput: "data"\ninput_dim: 1\ninput_dim: 3\n'
           'input_dim: 40\ninput_dim: 40\n'
           'layer { name: "c1" type: "Convolution" bottom: "data" top: "c1" '
           'convolution_param { num_output: 6 kernel_size: 3 pad: 1 stride: 2 } }\n'
           'layer { name: "bn1" type: "BatchNorm" bottom: "c1" top: "bn1" }\n'
           'layer { name: "sc1" type: "Scale" bottom: "bn1" top: "sc1" '
           'scale_param { bias_term: true } }\n'
           'layer { name: "p1" type: "Pooling" bottom: "sc1" top: "p1" '
           'pooling_param { pool: AVE kernel_size: 3 stride: 2 pad: 1 } }\n'
           'layer { name: "p2" type: "Pooling" bottom: "sc1" top: "p2" '
           'pooling_param { pool: MAX kernel_size: 3 stride: 2 pad: 1 } }\n'
           'layer { name: "e1" type: "Eltwise" bottom: "p1" bottom: "p2" top: "e1" '
           'eltwise_param { operation: PROD } }\n'
           'layer { name: "e2" type: "Eltwise" bottom: "p1" bottom: "e1" top: "e2" '
           'eltwise_param { operation: MAX } }\n'
           'layer { name: "g" type: "Pooling" bottom: "e2" top: "g" '
           'pooling_param { pool: AVE global_pooling: true } }\n')
    weights = [("c1", [rng.normal(0, 0.3, (6, 3, 3, 3)), rng.normal(0, 0.1, 6)]),
               ("bn1", [rng.normal(0, 1, 6), rng.uniform(0.5, 2, 6), np.array([2.5])]),
               ("sc1", [rng.uniform(0.5, 1.5, 6), rng.normal(0, 0.2, 6)])]
    proto, cm = tmp_path / "deploy.prototxt", tmp_path / "m.caffemodel"
    proto.write_text(txt)
    cm.write_bytes(b"".join(TSy._layer_weights(n, [np.asarray(b, np.float32) for b in bl])
                            for n, bl in weights))
    jnet = JN.CaffeNet(str(proto), str(cm))
    tnet = TN.CaffeNet(str(proto), str(cm))
    x = rng.normal(0, 2, (2, 3, 40, 40)).astype(np.float32)
    jb, tb = jnet.forward(x), tnet(torch.from_numpy(x))
    for k in ("c1", "bn1", "sc1", "p1", "p2", "e1", "e2", "g"):
        a = np.asarray(jb[k]).transpose(0, 3, 1, 2)
        np.testing.assert_allclose(tb[k].numpy(), a, rtol=1e-5, atol=1e-4, err_msg=k)
