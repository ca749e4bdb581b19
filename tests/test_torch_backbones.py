"""Port parity: the config-5 backbones (models/vit.py, models/xception.py)
against the JAX ones on the same parameters (utils/convert.params_from_jax),
the donor converter (utils/vit_convert.py) against transformers' ViTModel,
and the backbone registry (models/backbones.py).

Tolerances: the tiny ViT's features and logits within 1e-5 absolute; the
converted ViTModel's tokens within 2e-5 (as tests/test_backbone_swap.py
holds the JAX ViT); Xception's features within 1e-4 relative to their
largest magnitude."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from real_time_video_deepfake_detection_tpu.models import backbones as JB
from real_time_video_deepfake_detection_tpu.models import vit as JV
from real_time_video_deepfake_detection_tpu.models import xception as JX
from real_time_video_deepfake_detection_tpu_torch.models import backbones as TB
from real_time_video_deepfake_detection_tpu_torch.models import vit as TV
from real_time_video_deepfake_detection_tpu_torch.models import xception as TX
from real_time_video_deepfake_detection_tpu_torch.utils.convert import params_from_jax

from tests.torch_port_util import draw_params, randomize_bn, vit_models


@pytest.mark.parametrize("use_cls,ln_eps", [(False, 1e-6), (True, 1e-12)],
                         ids=["mean_pool", "cls_hf_eps"])
def test_vit_matches_jax(use_cls, ln_eps):
    spec_j, pj, model = vit_models(seed=1, use_cls=use_cls, ln_eps=ln_eps)
    x = np.random.default_rng(2).normal(0, 1, (3, 64, 64, 3)).astype(np.float32)
    want_f = np.asarray(JV.extract_features(pj, jnp.asarray(x), spec_j))
    want_l = np.asarray(JV.forward(pj, jnp.asarray(x), spec_j))
    with torch.no_grad():
        feats = model.extract_features(torch.from_numpy(x))
        logits = model.apply_head(feats)
    np.testing.assert_allclose(feats.numpy(), want_f, rtol=0, atol=1e-5)
    np.testing.assert_allclose(logits.numpy(), want_l, rtol=0, atol=1e-5)
    assert float(np.abs(want_f).max()) > 0.5   # the features are not degenerate


def test_vit_from_transformers_matches_last_hidden_state():
    """A random transformers ViTModel (hidden 64, 2 layers, image 32),
    converted: the port's encoder output equals last_hidden_state and its
    features the [CLS] row."""
    transformers = pytest.importorskip("transformers")
    from real_time_video_deepfake_detection_tpu_torch.utils.vit_convert import (
        from_transformers)
    cfg = transformers.ViTConfig(hidden_size=64, num_hidden_layers=2, num_attention_heads=2,
                                 intermediate_size=256, image_size=32, patch_size=16)
    torch.manual_seed(0)
    donor = transformers.ViTModel(cfg, add_pooling_layer=False).eval()
    sd, spec = from_transformers(donor)
    assert spec.use_cls and spec.ln_eps == cfg.layer_norm_eps
    model = TV.ViT(spec)
    model.load_state_dict(sd)
    x = np.random.default_rng(3).normal(0, 1, (2, 32, 32, 3)).astype(np.float32)
    with torch.no_grad():
        ref = donor(torch.from_numpy(x.transpose(0, 3, 1, 2))).last_hidden_state.numpy()
        tok = model.eval().encode(torch.from_numpy(x)).numpy()
        feats = model.extract_features(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(tok, ref, rtol=0, atol=2e-5)
    np.testing.assert_allclose(feats, ref[:, 0], rtol=0, atol=2e-5)


def test_vit_convert_refuses_a_nonstandard_mlp():
    from real_time_video_deepfake_detection_tpu_torch.utils.vit_convert import (
        convert_vit_state_dict)
    with pytest.raises(ValueError, match="4x MLP"):
        convert_vit_state_dict({}, hidden_size=64, num_layers=1, num_heads=2, patch=16,
                               image_size=32, mlp_dim=128)


def test_xception_matches_jax_at_even_pool_sizes():
    """middle_blocks=1 at 96x96: the four max pools see 45, 23, 12 and 6
    pixels, so two pad asymmetrically (XLA's SAME); random BN statistics."""
    spec_j = JX.XceptionSpec(middle_blocks=1)
    shapes = jax.eval_shape(lambda k: JX.init_params(k, spec_j), jax.random.PRNGKey(0))
    pj = randomize_bn(draw_params(shapes, 4), 5)
    model = TX.Xception(TX.XceptionSpec(middle_blocks=1))
    model.load_state_dict(params_from_jax(pj, model))
    x = np.random.default_rng(6).normal(0, 1, (2, 96, 96, 3)).astype(np.float32)
    want = np.asarray(JX.extract_features(pj, jnp.asarray(x), spec_j))
    want_l = np.asarray(JX.forward(pj, jnp.asarray(x), spec_j))
    with torch.no_grad():
        feats = model.eval().extract_features(torch.from_numpy(x))
        logits = model.apply_head(feats)
    scale = float(np.abs(want).max())
    assert scale > 0
    np.testing.assert_allclose(feats.numpy(), want, rtol=0, atol=1e-4 * scale)
    np.testing.assert_allclose(logits.numpy(), want_l, rtol=0,
                               atol=1e-4 * float(np.abs(want_l).max()))


def test_xception_maxpool_pads_like_xla():
    """The SAME max pool on even and odd sizes against reduce_window."""
    for n in (6, 7, 12, 45):
        x = np.random.default_rng(n).normal(0, 1, (1, n, n, 2)).astype(np.float32)
        want = np.asarray(JX._maxpool3s2(jnp.asarray(x)))
        got = TX.maxpool3s2_same(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        np.testing.assert_array_equal(got.numpy(), want)


def test_xception_full_spec_parameter_count():
    with torch.device("meta"):
        model = TB.build_model(TB.make("xception"))
    assert TX.n_trainable_params(model) == 20_806_952 + 2_049


def test_backbone_registry_and_feature_dims():
    names = TB.backbone_names()
    assert names == JB.backbone_names()   # b0..b7, the three ViTs, xception
    assert names[8:] == ["vit_s16", "vit_b16", "vit_l16", "xception"]
    for name, dim in (("b0", 1280), ("b4", 1792), ("vit_s16", 384), ("vit_b16", 768),
                      ("vit_l16", 1024), ("xception", 2048)):
        assert TB.feature_dim(TB.make(name)) == dim, name
    with pytest.raises(ValueError):
        TB.make("resnet50")


@pytest.mark.parametrize("name", ["vit_s16", "vit_b16", "vit_l16", "xception"])
def test_make_builds_the_config5_backbones(name):
    """Each name builds a module whose features have feature_dim(spec)
    columns (shapes only: the meta device allocates nothing)."""
    spec = TB.make(name)
    with torch.device("meta"):
        model = TB.build_model(spec)
        feats = model.extract_features(torch.empty((2, 224, 224, 3)))
        logits = model.apply_head(feats)
    assert tuple(feats.shape) == (2, TB.feature_dim(spec)) and tuple(logits.shape) == (2, 1)
    if name == "vit_b16":
        assert (spec.depth, spec.dim, spec.heads, spec.n_tokens) == (12, 768, 12, 196)


@pytest.mark.parametrize("name", ["vit_tiny", "xception_small"])
def test_detector_single_prediction_with_config5_backbones(name):
    """DeepfakeDetector(spec=...) classifies a face crop with the ViT or the
    Xception through build_model and classify_batch, as the JAX detector
    does with the same parameters; probabilities within 1e-5."""
    from real_time_video_deepfake_detection_tpu.core.config import DetectorConfig as JDC
    from real_time_video_deepfake_detection_tpu.pipeline.detector import (
        DeepfakeDetector as JDet)
    from real_time_video_deepfake_detection_tpu_torch.core.config import (
        DetectorConfig as TDC)
    from real_time_video_deepfake_detection_tpu_torch.pipeline.detector import (
        DeepfakeDetector as TDet)
    if name == "vit_tiny":
        spec_j, pj, model = vit_models(seed=8)
        size, spec_t = 64, TV.ViTSpec(**dataclasses.asdict(spec_j))
    else:
        spec_j = JX.XceptionSpec(middle_blocks=1)
        shapes = jax.eval_shape(lambda k: JX.init_params(k, spec_j), jax.random.PRNGKey(0))
        pj = randomize_bn(draw_params(shapes, 9), 10)
        size, spec_t = 96, TX.XceptionSpec(middle_blocks=1)
        model = TX.Xception(spec_t)
    jd = JDet(JDC(model_input_size=size), params=pj, spec=spec_j)
    td = TDet(TDC(model_input_size=size), params=params_from_jax(pj, model), spec=spec_t,
              device="cpu")
    assert type(td.model) is type(model)
    rng = np.random.default_rng(11)
    for shape in ((120, 100, 3), (200, 180, 3)):
        face = rng.integers(0, 256, shape, dtype=np.uint8)
        want, got = jd._single_prediction(face), td._single_prediction(face)
        assert want is not None and got is not None
        assert got == pytest.approx(want, abs=1e-5), (shape, got, want)
