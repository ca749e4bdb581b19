"""Port parity: the tensor-parallel ViT (models/vit.vit_partition_specs,
shard_state_dict, parallel/tensor_parallel.make_tp_forward over a
parallel/mesh.GridMesh) against the JAX package's sharded forward, ViT-S/16
at 64 px with JAX's init_params carried across. On a 4x2 ("data", "model")
mesh of cpu entries the port equals JAX's jit over its 8 virtual CPU
devices (tests/conftest.py) and the port's unsharded forward within 2e-4,
JAX's own tolerance (tests/test_backbone_swap.py); a 1x1 mesh equals the
unsharded forward exactly. The spec table equals JAX's leaf for leaf;
indivisible heads raise; B0 and Xception have no table."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh, NamedSharding, PartitionSpec as P

from real_time_video_deepfake_detection_tpu.models import vit as JV
from real_time_video_deepfake_detection_tpu_torch.models import backbones as TBB, vit as TV
from real_time_video_deepfake_detection_tpu_torch.parallel import mesh as TM
from real_time_video_deepfake_detection_tpu_torch.parallel.tensor_parallel import (
    make_tp_forward,
)
from real_time_video_deepfake_detection_tpu_torch.utils.convert import params_from_jax

TOL = 2e-4


@pytest.fixture(scope="module")
def vit_s():
    spec_j = JV.ViTSpec.make("s16", image_size=64)
    pj = JV.init_params(jax.random.PRNGKey(0), spec_j)
    model = TV.ViT(TV.ViTSpec.make("s16", image_size=64))
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, pj), model))
    x = np.random.default_rng(71).standard_normal((8, 64, 64, 3)).astype(np.float32)
    return spec_j, pj, model.eval(), x


def test_tp_forward_matches_jax_sharded_on_4x2(vit_s):
    if len(jax.devices()) < 8:
        pytest.skip("needs JAX's 8 virtual CPU devices")
    spec_j, pj, model, x = vit_s
    jmesh = JMesh(np.array(jax.devices()[:8]).reshape(4, 2), ("data", "model"))
    sharded = jax.tree.map(lambda v, s: jax.device_put(v, NamedSharding(jmesh, s)),
                           pj, JV.vit_partition_specs(pj),
                           is_leaf=lambda v: isinstance(v, jnp.ndarray))
    f = jax.jit(lambda p, x: JV.forward(p, x, spec_j),
                out_shardings=NamedSharding(jmesh, P("data")))
    want = np.asarray(f(sharded, jax.device_put(jnp.asarray(x),
                                                NamedSharding(jmesh, P("data")))))
    mesh = TM.grid_mesh(["cpu"] * 8, (4, 2))
    shards = make_tp_forward(mesh, model)(torch.from_numpy(x))
    assert [tuple(s.shape) for s in shards] == [(2, 1)] * 4
    got = TM.gather(shards).numpy()
    with torch.no_grad():
        unsharded = model(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
    np.testing.assert_allclose(got, unsharded, rtol=0, atol=TOL)


def test_tp_on_a_1x1_mesh_is_the_unsharded_forward(vit_s):
    _, _, model, x = vit_s
    xt = torch.from_numpy(x[:2])
    mesh = TM.make_mesh(1, "cpu", axis_names=("data", "model"))
    assert mesh.shape == (1, 1)
    with torch.no_grad():
        want = model(xt)
    assert torch.equal(TM.gather(make_tp_forward(mesh, model)(xt)), want)


def test_partition_specs_equal_jax_and_shards_cut_by_heads(vit_s):
    _, pj, model, _ = vit_s
    spec = model.spec
    jflat = {}

    def walk(tree, prefix):
        if isinstance(tree, dict):
            for k, v in tree.items():
                walk(v, f"{prefix}{k}.")
        elif isinstance(tree, list):
            for i, v in enumerate(tree):
                walk(v, f"{prefix}{i}.")
        else:
            jflat[prefix[:-1]] = tuple(tree)

    walk(JV.vit_partition_specs(pj), "")
    assert TBB.partition_specs(model, spec) == jflat
    state = model.state_dict()
    hd, h = spec.dim // spec.heads, spec.heads
    s1 = TV.shard_state_dict(spec, state, 2, 1)
    qkv = state["blocks.0.qkv.w"].reshape(spec.dim, 3, h, hd)
    assert torch.equal(s1["blocks.0.qkv.w"],
                       qkv[:, :, h // 2:].reshape(spec.dim, -1))
    assert torch.equal(s1["blocks.0.mlp2.w"], state["blocks.0.mlp2.w"][spec.dim * 2:])
    assert torch.equal(s1["blocks.0.proj.w"], state["blocks.0.proj.w"])


def test_indivisible_heads_raise_and_other_backbones_have_no_table(vit_s):
    _, _, model, _ = vit_s
    with pytest.raises(ValueError, match="divide by 4"):    # 6 heads
        make_tp_forward(TM.grid_mesh(["cpu"] * 4, (1, 4)), model)
    for name in ("b0", "xception"):
        spec = TBB.make(name)
        assert TBB.partition_specs(None, spec) is None
