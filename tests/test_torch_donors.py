"""The donor converters of config 5 against their libraries and the JAX
package: utils/xception_convert.from_keras and from_h5 on a random
keras.applications.Xception (96x96, so the max pools pad asymmetrically)
against keras' model.predict and the JAX package's converter and Xception,
within atol and rtol 1e-4 (the JAX package's own keras test); and
utils/vit_convert.from_pretrained on a seeded transformers ViT written with
save_pretrained, against ViTModel's last_hidden_state and the JAX
package's from_pretrained, within 2e-5 (its own test of the transformers
donor)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from real_time_video_deepfake_detection_tpu.models import vit as JV
from real_time_video_deepfake_detection_tpu.models import xception as JX
from real_time_video_deepfake_detection_tpu.utils import vit_convert as JVC
from real_time_video_deepfake_detection_tpu.utils import xception_convert as JXC
from real_time_video_deepfake_detection_tpu_torch.models import vit as TV
from real_time_video_deepfake_detection_tpu_torch.models import xception as TX
from real_time_video_deepfake_detection_tpu_torch.utils import vit_convert as TVC
from real_time_video_deepfake_detection_tpu_torch.utils import xception_convert as TXC


@pytest.fixture(scope="module")
def keras_xception():
    keras = pytest.importorskip("keras")
    keras.utils.set_random_seed(0)
    model = keras.applications.Xception(weights=None, include_top=False, pooling="avg",
                                        input_shape=(96, 96, 3))
    # random batch-norm statistics, so that inference BN does real work
    rng = np.random.default_rng(1)
    for layer in model.layers:
        if type(layer).__name__ == "BatchNormalization":
            g, b, m, v = layer.get_weights()
            layer.set_weights([rng.uniform(0.5, 1.5, g.shape).astype(np.float32),
                               rng.normal(0, 0.2, b.shape).astype(np.float32),
                               rng.normal(0, 0.2, m.shape).astype(np.float32),
                               rng.uniform(0.5, 1.5, v.shape).astype(np.float32)])
    x = np.random.default_rng(2).standard_normal((2, 96, 96, 3)).astype(np.float32)
    return model, x, model.predict(x, verbose=0)


def _port_features(sd, spec, x):
    model = TX.Xception(spec)
    model.load_state_dict(sd)
    with torch.no_grad():
        return model.eval().extract_features(torch.from_numpy(x)).numpy()


def test_xception_from_keras_matches_keras_and_jax(keras_xception):
    model, x, ref = keras_xception
    sd, spec = TXC.from_keras(model)
    assert spec == TX.XceptionSpec()
    assert not sd["head.w"].any() and not sd["head.b"].any()
    got = _port_features(sd, spec, x)
    assert ref.shape == got.shape == (2, 2048)
    assert float(np.abs(ref).max()) > 0.1   # the features are not degenerate
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=1e-4)
    pj, spec_j = JXC.from_keras(model)
    want = np.asarray(JX.extract_features(pj, jnp.asarray(x), spec_j))
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


def test_xception_from_h5_reads_save_weights(keras_xception, tmp_path):
    model, x, ref = keras_xception
    path = str(tmp_path / "xception.weights.h5")
    model.save_weights(path)
    sd, spec = TXC.from_h5(path)
    direct, _ = TXC.from_keras(model)
    assert set(sd) == set(direct)
    for k in sd:
        assert torch.equal(sd[k], direct[k]), k
    np.testing.assert_allclose(_port_features(sd, spec, x), ref, atol=1e-4, rtol=1e-4)


def test_xception_from_keras_refuses_a_model_that_is_not_xception():
    class Layer:
        def __init__(self, name):
            self.name = name

    class NotXception:
        layers = [Layer("conv")]

        def get_layer(self, name):
            raise AssertionError("the residual layers are counted first")

    with pytest.raises(ValueError, match="not a stock keras Xception"):
        TXC.from_keras(NotXception())


def test_vit_from_pretrained_matches_transformers_and_jax(tmp_path):
    transformers = pytest.importorskip("transformers")
    cfg = transformers.ViTConfig(hidden_size=64, num_hidden_layers=2, num_attention_heads=2,
                                 intermediate_size=256, image_size=32, patch_size=16)
    torch.manual_seed(4)
    donor = transformers.ViTModel(cfg, add_pooling_layer=False).eval()
    donor.save_pretrained(str(tmp_path))
    sd, spec = TVC.from_pretrained(str(tmp_path))
    assert spec.use_cls and spec.ln_eps == cfg.layer_norm_eps
    assert not sd["head.w"].any()
    model = TV.ViT(spec)
    model.load_state_dict(sd)
    x = np.random.default_rng(3).normal(0, 1, (2, 32, 32, 3)).astype(np.float32)
    with torch.no_grad():
        ref = donor(torch.from_numpy(x.transpose(0, 3, 1, 2))).last_hidden_state.numpy()
        tok = model.eval().encode(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(tok, ref, rtol=0, atol=2e-5)
    pj, spec_j = JVC.from_pretrained(str(tmp_path))
    want = np.asarray(JV._encode(pj, jnp.asarray(x), spec_j))
    np.testing.assert_allclose(tok, want, rtol=0, atol=2e-5)
