"""Port parity: the EfficientNet nn.Module under parameters carried from
JAX by utils/convert.params_from_jax, against the JAX package's
extract_features / apply_head (f32, 1e-4), and the converter's accounting
at full B0."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from real_time_video_deepfake_detection_tpu.models import efficientnet as JE
from real_time_video_deepfake_detection_tpu_torch.models import backbones
from real_time_video_deepfake_detection_tpu_torch.models import efficientnet as TE
from real_time_video_deepfake_detection_tpu_torch.utils.convert import params_from_jax

from tests.torch_port_util import HEAD_DIMS, jax_params, small_models


@pytest.mark.parametrize("hw", [64, 57])
def test_small_spec_features_and_logits_match_jax(hw):
    spec_j, pj, model = small_models(seed=3, head_dims=HEAD_DIMS)
    x = np.random.default_rng(hw).standard_normal((3, hw, hw, 3)).astype(np.float32)
    fj = np.asarray(jax.jit(JE.extract_features, static_argnums=2)(
        pj, jnp.asarray(x), spec_j))
    lj = np.asarray(jax.jit(JE.apply_head)(pj, jnp.asarray(fj)))
    with torch.no_grad():
        ft = model.extract_features(torch.from_numpy(x))
        lt = model.apply_head(ft)
    assert fj.std() > 1e-2   # randomized BN keeps the features alive
    np.testing.assert_allclose(ft.numpy(), fj, rtol=0, atol=1e-4)
    np.testing.assert_allclose(lt.numpy(), lj, rtol=0, atol=1e-4)


def test_full_b0_converter_uses_every_leaf():
    spec = TE.EfficientNetSpec.make("b0")
    pj = jax_params(JE.EfficientNetSpec.make("b0"), seed=1)
    model = backbones.build_model(spec, torch.Generator().manual_seed(0))
    sd = params_from_jax(pj, model)
    assert set(sd) == set(model.state_dict())
    model.load_state_dict(sd)
    assert TE.param_count(model) == JE.param_count(pj)
    # HWIO -> (O, I, kh, kw); depthwise (k, k, 1, C) -> (C, 1, k, k)
    np.testing.assert_array_equal(model.stem.conv.detach().numpy(),
                                  pj["stem"]["conv"].transpose(3, 2, 0, 1))
    dw = pj["blocks"][1]["depthwise"]
    assert model.blocks[1].depthwise.shape == (dw.shape[3], 1, dw.shape[0], dw.shape[1])


def test_converter_rejects_leftover_and_missing_leaves():
    _, pj, model = small_models(seed=0, head_dims=HEAD_DIMS)
    extra = dict(pj, unused={"w": np.zeros(3, np.float32)})
    with pytest.raises(ValueError, match="unused"):
        params_from_jax(extra, model)
    missing = dict(pj)
    del missing["fc"]
    with pytest.raises(ValueError, match="missing"):
        params_from_jax(missing, model)


def test_seeded_init_is_deterministic_and_follows_init_laws():
    spec = TE.EfficientNetSpec.make("b0")
    a = backbones.build_model(spec, torch.Generator().manual_seed(7))
    b = backbones.build_model(spec, torch.Generator().manual_seed(7))
    for (k, va), vb in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(va, vb), k
    w = a.stem.conv.detach()
    assert abs(float(w.std()) - (2.0 / (3 * 3 * 32)) ** 0.5) < 0.02
    assert float(a.fc.fc1.w.detach().abs().max()) <= 1.0 / 1280 ** 0.5
