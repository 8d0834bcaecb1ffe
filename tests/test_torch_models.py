"""Port modules against their JAX counterparts, with the JAX variables
(drawn from a numpy seed) carried across by the port's utils/weight_port.py:
VisualLingAttn, RNNStateEncoder, both ResNet trunks, both visual encoders in
spatial, vector and precomputed-feature modes, and BERT.  Also pins the
normalisation epsilons, and checks that the JAX package's reference-checkpoint
converter maps the port's state_dicts back to the JAX variables exactly."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

from robo_vln_tpu.models.encoders import bert as jax_bert
from robo_vln_tpu.models.encoders import resnet as jax_resnet
from robo_vln_tpu.models.encoders import visual as jax_visual
from robo_vln_tpu.models import rnn_state_encoder as jax_rnn
from robo_vln_tpu.models import transformer as jax_tf
from robo_vln_tpu.training.checkpoint import convert_hierarchical_checkpoint
from robo_vln_tpu_torch.models import transformer
from robo_vln_tpu_torch.models.encoders import bert, resnet, visual
from robo_vln_tpu_torch.models.rnn_state_encoder import RNNStateEncoder
from robo_vln_tpu_torch.utils import weight_port as wp
from tests.test_torch_agent import _port_agent, jax_tiny_hcm, random_variables
from tests.test_torch_threads import one_torch_thread  # noqa: F401

BLOCKS = (1, 1, 1, 1)


def _init(module, seed, *args):
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0), *args)
    return random_variables(shapes, seed)


def _close(a, b, atol):
    if isinstance(a, torch.Tensor):
        a = a.detach()
    np.testing.assert_allclose(np.asarray(a, np.float32), np.asarray(b, np.float32), atol=atol)


def _t(x):
    return torch.from_numpy(np.array(x))


def test_sinusoid_table_matches_jax():
    _close(transformer.sinusoid_encoding_table(200, 256),
           jax_tf.sinusoid_encoding_table(200, 256), atol=1e-6)


@pytest.mark.parametrize("n_tokens", [16, 64])
def test_visual_ling_attn_matches_jax(rng, n_tokens):
    ins = rng.standard_normal((3, 12, 32)).astype(np.float32)
    vis = rng.standard_normal((3, n_tokens, 16)).astype(np.float32)
    ref_mod = jax_tf.VisualLingAttn(d_model=16, h=2, d_ff=32, n_layers=1,
                                    vis_in_features=16, ins_in_features=32)
    variables = _init(ref_mod, 1, jnp.asarray(ins), jnp.asarray(vis))
    ours = transformer.VisualLingAttn(16, 2, 32, 1, 16, 32)
    wp.load_state(ours, wp.visual_ling_attn_state(variables["params"]))
    _close(ours(_t(ins), _t(vis)), jax.jit(ref_mod.apply)(variables, ins, vis), atol=1e-5)


def test_rnn_state_encoder_matches_jax(rng):
    T, B, D, H = 4, 2, 6, 16
    x = rng.standard_normal((T, B, D)).astype(np.float32)
    hidden = rng.standard_normal((2, B, H)).astype(np.float32)
    masks = np.ones((T, B), np.float32)
    masks[2, 0] = 0.0
    ref_mod = jax_rnn.RNNStateEncoder(hidden_size=H)
    variables = _init(ref_mod, 2, jnp.asarray(x), jnp.asarray(hidden), jnp.asarray(masks))
    ours = RNNStateEncoder(D, H)
    wp.load_state(ours, wp.rnn_state(variables["params"], "rnn."))
    for args in ((x, hidden, masks), (x[0], hidden, masks[0])):  # sequence, one step
        out, new_hidden = ours(*map(_t, args))
        ref_out, ref_hidden = jax.jit(ref_mod.apply)(variables, *args)
        assert new_hidden.shape == (2, B, H)
        _close(out, ref_out, atol=1e-5)
        _close(new_hidden, ref_hidden, atol=1e-5)


def test_gn_resnet_encoder_matches_jax(rng):
    x = rng.random((2, 64, 64, 1)).astype(np.float32)
    ref_mod = jax_resnet.GNResNetEncoder(blocks=BLOCKS)
    variables = _init(ref_mod, 3, jnp.asarray(x))
    ours = resnet.GNResNetEncoder(blocks=BLOCKS)
    wp.load_state(ours, wp.gn_resnet_encoder_state(variables["params"]))
    got = ours(_t(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    _close(got, jax.jit(ref_mod.apply)(variables, x), atol=1e-4)


def test_tv_resnet50_matches_jax(rng):
    x = rng.random((2, 64, 64, 3)).astype(np.float32)
    ref_mod = jax_resnet.TVResNet50(blocks=BLOCKS)
    variables = _init(ref_mod, 4, jnp.asarray(x))
    ours = resnet.TVResNet50(blocks=BLOCKS)
    wp.load_state(ours, wp.tv_resnet50_state(variables["params"], variables["batch_stats"]))
    got = ours(_t(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    _close(got, jax.jit(ref_mod.apply)(variables, x), atol=1e-4)


def _depth_state(p, spatial):
    sd = wp.gn_resnet_encoder_state(p["visual_encoder"], "visual_encoder.")
    if spatial:
        sd["spatial_embeddings.weight"] = wp._spatial_embeddings(p["spatial_embeddings"])
    else:
        sd.update(wp._dense(p["visual_fc"], "visual_fc.1."))
    return sd


def _rgb_state(variables, spatial):
    p = variables["params"]
    sd = wp.tv_resnet50_state(p["cnn"], variables["batch_stats"]["cnn"], "cnn.")
    if spatial:
        sd["spatial_embeddings.weight"] = wp._spatial_embeddings(p["spatial_embeddings"])
    else:
        sd.update(wp._dense(p["fc"], "fc."))
    return sd


@pytest.mark.parametrize("spatial", [True, False])
@pytest.mark.parametrize("features", [False, True])
def test_depth_encoder_matches_jax(rng, spatial, features):
    depth = rng.random((2, 64, 64, 1)).astype(np.float32)
    ref_mod = jax_visual.DepthEncoder(output_size=8, spatial_output=spatial, blocks=BLOCKS)
    variables = _init(ref_mod, 5, {"depth": jnp.asarray(depth)})
    obs = {"depth": depth}
    if features:  # the trunk's output, as a shared trunk pass gives it
        trunk = jax.jit(jax_resnet.GNResNetEncoder(blocks=BLOCKS).apply)
        obs = {"depth_features": np.asarray(
            trunk({"params": variables["params"]["visual_encoder"]}, depth))}
    ours = visual.DepthEncoder(output_size=8, spatial_output=spatial, input_size=64,
                               blocks=BLOCKS)
    wp.load_state(ours, _depth_state(variables["params"], spatial))
    got = ours({k: _t(v) for k, v in obs.items()})
    _close(got, jax.jit(ref_mod.apply)(variables, obs), atol=1e-4)


@pytest.mark.parametrize("spatial", [True, False])
@pytest.mark.parametrize("features", [False, True])
def test_rgb_encoder_matches_jax(rng, spatial, features):
    rgb = rng.integers(0, 255, (2, 64, 64, 3)).astype(np.uint8)
    ref_mod = jax_visual.RGBEncoder(output_size=16, spatial_output=spatial, blocks=BLOCKS)
    variables = _init(ref_mod, 6, {"rgb": jnp.asarray(rgb)})
    obs = {"rgb": rgb}
    if features:
        trunk = jax.jit(jax_resnet.TVResNet50(blocks=BLOCKS).apply)
        obs = {"rgb_features": np.asarray(trunk(
            {"params": variables["params"]["cnn"],
             "batch_stats": variables["batch_stats"]["cnn"]}, rgb / 255.0))}
    ours = visual.RGBEncoder(output_size=16, spatial_output=spatial, blocks=BLOCKS)
    wp.load_state(ours, _rgb_state(variables, spatial))
    got = ours({k: _t(v) for k, v in obs.items()})
    _close(got, jax.jit(ref_mod.apply)(variables, obs), atol=1e-4)


def test_bert_matches_jax(rng):
    ids = rng.integers(0, 64, (2, 20)).astype(np.int32)
    ref_mod = jax_bert.BertEncoder(vocab_size=64, hidden_size=32, num_layers=2,
                                   num_heads=2, intermediate_size=64,
                                   max_position_embeddings=40)
    variables = _init(ref_mod, 7, jnp.asarray(ids))
    ours = bert.BertEncoder(vocab_size=64, hidden_size=32, num_layers=2, num_heads=2,
                            intermediate_size=64, max_position_embeddings=40)
    wp.load_state(ours, wp.bert_state(variables["params"]))
    _close(ours(_t(ids)), jax.jit(ref_mod.apply)(variables, ids), atol=1e-5)


def test_norm_epsilons_pinned(rng):
    """flax's LayerNorm and GroupNorm default to eps=1e-6 (torch: 1e-5), BERT
    uses 1e-12, FrozenBatchNorm 1e-5.  On inputs whose variance is near eps
    the port matches flax, and torch's defaults would not."""
    assert transformer.VisualLingAttn(16, 2, 32, 1, 16, 32).layer_norm.eps == 1e-6
    assert transformer.MultiHeadAttention(16, 2).layer_norm.eps == 1e-6
    gn_eps = {m.eps for m in resnet.GNResNetEncoder(blocks=BLOCKS).modules()
              if isinstance(m, torch.nn.GroupNorm)}
    assert gn_eps == {1e-6}
    bert_eps = {m.eps for m in bert.BertEncoder(64, 32, 1, 2, 64, 40).modules()
                if isinstance(m, torch.nn.LayerNorm)}
    assert bert_eps == {1e-12}
    assert resnet.FrozenBatchNorm(4).eps == 1e-5

    x = (1e-3 * rng.standard_normal((2, 5, 16))).astype(np.float32)
    ln_ref = fnn.LayerNorm().apply({"params": {"scale": np.ones(16, np.float32),
                                               "bias": np.zeros(16, np.float32)}}, x)
    ln = torch.nn.LayerNorm(16, eps=transformer.LN_EPS)
    _close(transformer.layer_norm(_t(x), ln), ln_ref, atol=1e-4)
    assert np.abs(torch.nn.LayerNorm(16)(_t(x)).detach().numpy() - np.asarray(ln_ref)).max() > 0.1

    y = (1e-3 * rng.standard_normal((2, 4, 4, 8))).astype(np.float32)  # NHWC
    gn_ref = fnn.GroupNorm(num_groups=2).apply(
        {"params": {"scale": np.ones(8, np.float32), "bias": np.zeros(8, np.float32)}}, y)
    gn = resnet.group_norm(_t(y).permute(0, 3, 1, 2), resnet._gn(2, 8)).permute(0, 2, 3, 1)
    _close(gn.detach(), gn_ref, atol=1e-4)

    z = (1e-6 * rng.standard_normal((2, 5, 16))).astype(np.float32)
    bln_ref = fnn.LayerNorm(epsilon=1e-12).apply(
        {"params": {"scale": np.ones(16, np.float32), "bias": np.zeros(16, np.float32)}}, z)
    bln = bert.BertEncoder(64, 16, 1, 2, 32, 40).embeddings.LayerNorm
    _close(transformer.layer_norm(_t(z), bln).detach(), bln_ref, atol=1e-4)


def test_checkpoint_converter_round_trip():
    """The port keeps the reference's state_dict names, so the JAX package's
    convert_hierarchical_checkpoint maps the port's weights back to the JAX
    variables they were carried from, leaf for leaf."""
    *_, high_vars, low_vars = jax_tiny_hcm()
    agent = _port_agent()
    ckpt = {
        "high_level_state_dict": {k: v.numpy() for k, v in agent.high.state_dict().items()},
        "low_level_state_dict": {k: v.numpy() for k, v in agent.low.state_dict().items()},
    }
    converted = convert_hierarchical_checkpoint(ckpt, blocks=BLOCKS)
    for want, got in zip((high_vars, low_vars), converted):
        flat_want = jax.tree_util.tree_flatten_with_path(want)[0]
        assert flat_want
        for path, leaf in flat_want:
            node = got
            for key in path:
                node = node[key.key]
            np.testing.assert_array_equal(np.asarray(node), leaf, err_msg=str(path))


def test_rgb_spatial_pooling_7x7_matches_jax(rng):
    """The serving path pools the 7×7 layer4 map to 4×4 tokens with
    overlapping bins, as torch's adaptive pooling and the JAX matrices do."""
    feats = rng.standard_normal((2, 7, 7, 2048)).astype(np.float32)
    ref_mod = jax_visual.RGBEncoder(spatial_output=True, blocks=BLOCKS)
    variables = _init(ref_mod, 8, {"rgb_features": jnp.asarray(feats)})
    ours = visual.RGBEncoder(spatial_output=True, blocks=BLOCKS)
    table = wp._spatial_embeddings(variables["params"]["spatial_embeddings"])
    ours.spatial_embeddings.weight.data = _t(table)
    got = ours({"rgb_features": _t(feats)})
    assert got.shape == (2, 16, 2048 + 64)
    _close(got, jax.jit(ref_mod.apply)(variables, {"rgb_features": feats}), atol=1e-5)
