"""The port's transformer blocks that no policy builds against the JAX
package's (robo_vln_tpu/models/transformer.py): each of the nine at tiny
widths, its flax variables drawn from a numpy seed and carried into the
port by its utils/weight_port function, with and without attention masks,
in float32 within 1e-4.  Unmasked attention calls go through
ops/cm_attention.attention_core to the kernel's wrapper (its plain version
on the CPU); masked calls take the plain path, and the wrapper counts them
not."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from robo_vln_tpu.models import transformer as jt
from robo_vln_tpu_torch.models import transformer as pt
from robo_vln_tpu_torch.ops import fused_attention
from robo_vln_tpu_torch.utils import weight_port as wp
from tests.test_torch_agent import random_variables
from tests.test_torch_threads import one_torch_thread  # noqa: F401

ATOL = 1e-4
B, L, S, D, H, FF, DIN = 2, 7, 5, 32, 2, 64, 24


def _inputs(rng):
    f = lambda *shape: rng.standard_normal(shape).astype(np.float32)  # noqa: E731
    pad = np.zeros((B, L), bool)
    pad[0, L - 2:] = True  # the first example's last two tokens are padding
    enc_pad = np.zeros((B, S), bool)
    enc_pad[1, S - 1] = True
    return {
        "x": f(B, L, D), "x_in": f(B, L, DIN), "enc": f(B, S, D), "enc_in": f(B, S, DIN),
        "pos": f(B, L, D), "pad_mask": pad[:, :, None],
        # True = masked, broadcast over heads and queries
        "self_mask": pad[:, None, None, :], "enc_mask": enc_pad[:, None, None, :],
    }


# name -> (JAX module, port module, weight_port function, call(inputs, masked)
# -> positional arguments, attention calls a forward makes)
BLOCKS = {
    "EncoderLayer": (
        jt.EncoderLayer(D, H, FF), pt.EncoderLayer(D, H, FF), wp.encoder_layer_state,
        lambda i, m: (i["x"], i["x"], i["x"], i["self_mask"] if m else None), 1),
    "BaseEncoder": (
        jt.BaseEncoder(D, H, FF, 2), pt.BaseEncoder(D, H, FF, 2), wp.base_encoder_state,
        lambda i, m: (i["x"], i["self_mask"] if m else None), 2),
    "TransformerLanguageEncoder": (
        jt.TransformerLanguageEncoder(D, H, FF, 2, DIN),
        pt.TransformerLanguageEncoder(D, H, FF, 2, DIN),
        wp.transformer_language_encoder_state,
        lambda i, m: (i["x_in"], i["pad_mask"] if m else None, i["self_mask"] if m else None),
        2),
    "DecoderLayer": (
        jt.DecoderLayer(D, H, FF), pt.DecoderLayer(D, H, FF), wp.decoder_layer_state,
        lambda i, m: (i["x"], i["enc"], i["self_mask"] if m else None,
                      i["enc_mask"] if m else None, i["pos"]), 2),
    "DecoderLayer_pooled": (
        jt.DecoderLayer(D, H, FF, pool_to=3), pt.DecoderLayer(D, H, FF, pool_to=3),
        wp.decoder_layer_state,
        lambda i, m: (i["x"], i["enc"], i["self_mask"] if m else None,
                      i["enc_mask"] if m else None), 2),
    "InterModuleAttnDecoder": (
        jt.InterModuleAttnDecoder(D, H, FF, 2, DIN), pt.InterModuleAttnDecoder(D, H, FF, 2, DIN),
        wp.inter_module_attn_decoder_state,
        lambda i, m: (i["x_in"], i["enc_in"], None, i["enc_mask"] if m else None), 2),
    "ImageCrossModalEncoder": (
        jt.ImageCrossModalEncoder(D, H, FF, 2, DIN), pt.ImageCrossModalEncoder(D, H, FF, 2, DIN),
        wp.image_cross_modal_encoder_state,
        lambda i, m: (i["x_in"], i["enc"], i["self_mask"] if m else None,
                      i["enc_mask"] if m else None), 4),
    "ImageEncoderWithPosEncodings": (
        jt.ImageEncoderWithPosEncodings(D, H, FF, 2, D),
        pt.ImageEncoderWithPosEncodings(D, H, FF, 2, D),
        wp.image_encoder_with_pos_encodings_state,
        lambda i, m: (i["x"], i["enc"], i["self_mask"] if m else None,
                      i["enc_mask"] if m else None, i["pos"]), 4),
    "ImagePlainEncoder": (
        jt.ImagePlainEncoder(D, H, FF, 2, DIN), pt.ImagePlainEncoder(D, H, FF, 2, DIN),
        wp.image_plain_encoder_state,
        lambda i, m: (i["x_in"], i["self_mask"] if m else None), 2),
}


def _counting_wrapper(monkeypatch):
    calls = []
    real = fused_attention.fused_cross_modal_attention

    def counting(q, k, v, heads):
        calls.append(tuple(q.shape))
        return real(q, k, v, heads)

    monkeypatch.setattr(fused_attention, "fused_cross_modal_attention", counting)
    return calls


def _port_module(module, to_state, params):
    module.eval()
    wp.load_state(module, to_state(jax.tree.map(np.asarray, params)))
    return module


@pytest.mark.parametrize("masked", [False, True], ids=["unmasked", "masked"])
@pytest.mark.parametrize("name", sorted(BLOCKS))
def test_block_matches_jax(name, masked, monkeypatch):
    jmod, pmod, to_state, call, attention_calls = BLOCKS[name]
    inputs = _inputs(np.random.default_rng(sorted(BLOCKS).index(name)))
    args = call(inputs, masked)
    jargs = [None if a is None else jnp.asarray(a) for a in args]
    shapes = jax.eval_shape(jmod.init, jax.random.PRNGKey(0), *jargs)
    variables = random_variables(shapes, 5)
    want = jmod.apply(variables, *jargs)
    module = _port_module(pmod, to_state, variables["params"])
    calls = _counting_wrapper(monkeypatch)
    with torch.no_grad():
        got = module(*[None if a is None else torch.from_numpy(a) for a in args])
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    assert len(calls) == (0 if masked else attention_calls), calls


def test_position_embedding_2d_matches_jax():
    jmod, pmod = jt.PositionEmbedding2DLearned(8, 6), pt.PositionEmbedding2DLearned(8, 6)
    shapes = jax.eval_shape(lambda key: jmod.init(key, (4, 5), B), jax.random.PRNGKey(0))
    variables = random_variables(shapes, 6)
    want = jmod.apply(variables, (4, 5), B)
    module = _port_module(pmod, wp.position_embedding_2d_state, variables["params"])
    got = module((4, 5), B)
    assert got.shape == want.shape == (B, 4, 5, 16)
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want))


def test_blocks_keep_the_reference_names():
    """The port's keys are the reference's torch names (``layers.{i}``,
    ``mhatt``, ``self_att``, ``enc_att``, ``encoder``, ``fc``...)."""
    keys = {name: set(m.state_dict()) for name, (_, m, _, _, _) in BLOCKS.items()}
    assert "layers.1.mhatt.attention.fc_q.weight" in keys["BaseEncoder"]
    assert "encoder.layers.0.pwff.fc2.bias" in keys["TransformerLanguageEncoder"]
    assert {"self_att.attention.fc_o.weight", "enc_att.layer_norm.weight",
            "pwff.fc1.weight"} <= keys["DecoderLayer"]
    assert "layers.1.enc_att.attention.fc_v.bias" in keys["InterModuleAttnDecoder"]
    assert {"fc.weight", "layer_norm.bias"} <= keys["ImageCrossModalEncoder"]
    assert not any(k.startswith("fc.") for k in keys["ImageEncoderWithPosEncodings"])
    assert set(pt.PositionEmbedding2DLearned().state_dict()) == {"row_embed.weight",
                                                                 "col_embed.weight"}
