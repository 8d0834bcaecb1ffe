"""The flat family's ops, encoders and policies in the port against the JAX
package, on the CPU, float32.

The same numpy inputs from a seed go through both; the JAX variables (drawn
by tests/test_torch_agent.random_variables) reach the port through
utils/weight_port.py.  Tolerances: the ops (the GRU, the length-masked
recurrences and the card's packed path for them, the single-query
attention, the RCM state encoder alone) 1e-5; the encoders and each
policy's forward (CMA with the RCM encoder among them), a window and its
single-step ticks, 1e-4 (the forward's tolerance of
tests/test_torch_agent.py).

Sizes: a state encoder of 16, an instruction RNN of 8 over a 6-wide table
of 30 tokens, instructions of at most 10 tokens (one row of length 0 where
the policy takes it), 36 px frames for SimpleCNN and 32 px for the
ResNets (one block a stage), BERT 1 layer of 16.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

from robo_vln_tpu.config.default import get_config as jax_get_config
from robo_vln_tpu.models import build_flat_policy as jax_build_flat
from robo_vln_tpu.models.encoders import instruction as jax_instruction
from robo_vln_tpu.models.encoders import language as jax_language
from robo_vln_tpu.models.encoders import visual as jax_visual
from robo_vln_tpu.models import rnn_state_encoder as jax_rnn_encoder
from robo_vln_tpu.ops import cm_attention as jax_cm
from robo_vln_tpu.ops import rnn as jax_rnn
from robo_vln_tpu_torch.config import get_config
from robo_vln_tpu_torch.models import build_flat_policy
from robo_vln_tpu_torch.models.encoders.instruction import (InstructionEncoder,
                                                            load_glove_embeddings)
from robo_vln_tpu_torch.models.encoders.language import LanguageEncoder
from robo_vln_tpu_torch.models.encoders.visual import SimpleCNN
from robo_vln_tpu_torch.models.rnn_state_encoder import RNNStateEncoder
from robo_vln_tpu_torch.models.seq2seq import embed_prev_action
from robo_vln_tpu_torch.ops import cm_attention, rnn
from robo_vln_tpu_torch.utils import weight_port as wp
from tests.test_torch_agent import _set, random_variables
from tests.test_torch_threads import one_torch_thread  # noqa: F401

OPS_TOL = 1e-5
TOL = 1e-4
B, T, L = 3, 4, 10
SIMPLE_PX, RESNET_PX = 36, 32

TINY_FLAT = {
    "STATE_ENCODER.hidden_size": 16, "INSTRUCTION_ENCODER.hidden_size": 8,
    "INSTRUCTION_ENCODER.embedding_size": 6, "INSTRUCTION_ENCODER.vocab_size": 30,
    "INSTRUCTION_ENCODER.use_pretrained_embeddings": False,
    "RGB_ENCODER.output_size": 8, "DEPTH_ENCODER.output_size": 4,
    "RGB_ENCODER.blocks": [1, 1, 1, 1], "DEPTH_ENCODER.blocks": [1, 1, 1, 1],
    "BERT.num_layers": 1, "BERT.hidden_size": 16, "BERT.num_heads": 2,
    "BERT.intermediate_size": 32, "BERT.vocab_size": 30,
}
SIMPLE = {"RGB_ENCODER.cnn_type": "SimpleRGBCNN", "DEPTH_ENCODER.cnn_type": "SimpleDepthCNN"}


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(got, want, atol, what=""):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               atol=atol, rtol=0, err_msg=what)


def _init(module, seed, *args):
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0), *args)
    return random_variables(shapes, seed)


def flat_configs(px, overrides):
    """(JAX MODEL config, port MODEL config) of the tiny flat policy."""
    over = {**TINY_FLAT, **dict(overrides)}
    jax_mc = _set(jax_get_config().clone().defrost().MODEL, over)
    port_mc = _set(get_config().clone().defrost().MODEL,
                   {**over, "DEPTH_ENCODER.input_size": px})
    return jax_mc, port_mc


def instruction_ids(rng, b=B, lengths=None):
    """(b, L) token ids, each row its valid tokens then 0 pads."""
    lengths = rng.integers(1, L + 1, b) if lengths is None else lengths
    ids = np.zeros((b, L), np.int32)
    for i, n in enumerate(lengths):
        ids[i, :n] = rng.integers(1, TINY_FLAT["INSTRUCTION_ENCODER.vocab_size"], n)
    return ids


def flat_inputs(rng, px, b=B, t=T, lengths=None, prev_scale=0.5):
    """A window's observations (uint8 rgb, float16 depth, the instruction),
    masks with an episode boundary inside the window, prev actions whose
    embedding index lands in the table, negative ones included."""
    obs = {
        "rgb": rng.integers(0, 255, (b, t, px, px, 3)).astype(np.uint8),
        "depth": rng.random((b, t, px, px, 1)).astype(np.float16),
        "instruction": instruction_ids(rng, b, lengths),
    }
    masks = np.ones((b, t), np.float32)
    masks[:, 0] = 0.0
    masks[-1, t // 2] = 0.0
    prev = (rng.standard_normal((b, t, 2)) * prev_scale).astype(np.float32)
    prev[0, 1, 0] = -2.5  # index int(-1.5) = -1: the table's last row
    return obs, masks, prev


@functools.lru_cache(maxsize=None)
def jax_flat(px, overrides=()):
    """(jax_mc, port_mc, JAX policy, its numpy variables, jitted apply)."""
    jax_mc, port_mc = flat_configs(px, overrides)
    jax_mc.freeze()
    policy = jax_build_flat(jax_mc)
    obs, masks, prev = flat_inputs(np.random.default_rng(0), px)
    variables = _init(policy, 5, jax.tree.map(jnp.asarray, obs), policy.initial_hidden(B),
                      jnp.asarray(prev), jnp.asarray(masks))
    return jax_mc, port_mc, policy, variables, jax.jit(policy.apply)


def port_flat(px, overrides=()):
    """The port's float32 policy with the JAX variables of :func:`jax_flat`."""
    _, port_mc, _, variables, _ = jax_flat(px, overrides)
    policy = build_flat_policy(port_mc, rgb_hw=(px, px))
    wp.load_flat_weights(policy, variables)
    return policy


# -- the ops ----------------------------------------------------------------------------

def test_gru_sequence_matches_jax(rng):
    Tn, Bn, D, H = 5, 3, 4, 6
    x = rng.standard_normal((Tn, Bn, D)).astype(np.float32)
    h0 = rng.standard_normal((Bn, H)).astype(np.float32)
    masks = np.ones((Tn, Bn), np.float32)
    masks[2, 1] = masks[0, 0] = 0.0
    w = [rng.standard_normal(s).astype(np.float32) * 0.5
         for s in ((D, 3 * H), (H, 3 * H), (3 * H,), (3 * H,))]
    outs, hT = rnn.gru_sequence(_t(x), _t(h0), _t(masks), *map(_t, w))
    ref_outs, ref_hT = jax_rnn.gru_sequence(x, h0, masks, *w)
    _close(outs, ref_outs, OPS_TOL)
    _close(hT, ref_hT, OPS_TOL)
    out, h1 = rnn.gru_step(_t(x[0]), _t(h0), _t(masks[0]), *map(_t, w))
    ref_out, ref_h1 = jax_rnn.gru_step(x[0], h0, masks[0], *w)
    _close(out, ref_out, OPS_TOL)
    _close(h1, ref_h1, OPS_TOL)


@pytest.mark.parametrize("cell", ["LSTM", "GRU"])
@pytest.mark.parametrize("reverse", [False, True])
def test_length_masked_rnns_match_jax(rng, cell, reverse):
    """Rows of length 0, 3 and L: the carry frozen on pads, outputs there
    exactly 0, the reverse direction from the last valid token, a row of
    length 0 all zeros."""
    D, H, g = 5, 7, 4 if cell == "LSTM" else 3
    lengths = np.asarray([0, 3, L], np.int32)
    x = rng.standard_normal((3, L, D)).astype(np.float32)
    w_ih = rng.standard_normal((D, g * H)).astype(np.float32) * 0.5
    w_hh = rng.standard_normal((H, g * H)).astype(np.float32) * 0.5
    b_ih, b_hh = (rng.standard_normal(g * H).astype(np.float32) * 0.1 for _ in range(2))
    if cell == "LSTM":
        outs, (hT, cT) = rnn.length_masked_lstm(_t(x), _t(lengths), _t(w_ih), _t(w_hh),
                                                _t(b_ih + b_hh), reverse=reverse)
        ref_outs, (ref_h, ref_c) = jax_rnn.length_masked_lstm(
            x, lengths, w_ih, w_hh, b_ih + b_hh, reverse=reverse)
        _close(cT, ref_c, OPS_TOL)
    else:
        outs, hT = rnn.length_masked_gru(_t(x), _t(lengths), _t(w_ih), _t(w_hh), _t(b_ih),
                                         _t(b_hh), reverse=reverse)
        ref_outs, ref_h = jax_rnn.length_masked_gru(x, lengths, w_ih, w_hh, b_ih, b_hh,
                                                    reverse=reverse)
    _close(outs, ref_outs, OPS_TOL)
    _close(hT, ref_h, OPS_TOL)
    assert torch.equal(outs[0], torch.zeros(L, H)) and torch.equal(hT[0], torch.zeros(H))
    assert torch.equal(outs[1, 3:], torch.zeros(L - 3, H))
    assert (outs[1, :3] != 0).all() and (outs[2] != 0).all()


@pytest.mark.parametrize("masked", [False, True])
def test_single_query_attention_matches_jax(rng, masked):
    N, C, Cv, S = 4, 6, 5, 7
    q = rng.standard_normal((N, C)).astype(np.float32)
    k = rng.standard_normal((N, C, S)).astype(np.float32)
    v = rng.standard_normal((N, Cv, S)).astype(np.float32)
    mask = None
    if masked:
        mask = rng.random((N, S)) > 0.5
        mask[0] = True  # every slot masked: a uniform softmax, as in JAX
        mask[1] = False
    got = cm_attention.single_query_attention(_t(q), _t(k), _t(v), 0.3,
                                              None if mask is None else _t(mask))
    _close(got, jax_cm.single_query_attention(q, k, v, 0.3, mask), OPS_TOL)


def test_embed_prev_action_matches_flax(rng):
    """JAX's index int(((prev + 1)·mask)[..., 0]): truncation toward zero, a
    negative index from the end of the table, past it NaN."""
    table = fnn.Embed(3, 4)
    variables = _init(table, 1, jnp.zeros((1,), jnp.int32))
    prev = np.asarray([[0.5, 0.0], [-2.5, 1.0], [1.7, 0.0], [-3.2, 0.0], [2.5, 0.0],
                       [-5.0, 0.0], [0.3, 0.0]], np.float32)
    masks = np.asarray([1, 1, 1, 1, 1, 1, 0], np.float32)
    want = table.apply(variables, ((prev + 1) * masks[:, None]).astype(np.int32)[:, 0])
    emb = torch.nn.Embedding(3, 4)
    wp.load_state(emb, {"weight": variables["params"]["embedding"]})
    got = embed_prev_action(emb, _t(prev), _t(masks))
    assert np.isnan(np.asarray(want)).any()
    np.testing.assert_array_equal(np.isnan(got.detach().numpy()), np.isnan(np.asarray(want)))
    _close(torch.nan_to_num(got.detach()), np.nan_to_num(np.asarray(want)), 0.0)


# -- encoders ---------------------------------------------------------------------------

def test_gru_state_encoder_matches_jax(rng):
    Tn, Bn, D, H = 4, 2, 6, 16
    x = rng.standard_normal((Tn, Bn, D)).astype(np.float32)
    hidden = rng.standard_normal((1, Bn, H)).astype(np.float32)
    masks = np.ones((Tn, Bn), np.float32)
    masks[2, 0] = 0.0
    ref_mod = jax_rnn_encoder.RNNStateEncoder(hidden_size=H, rnn_type="GRU")
    variables = _init(ref_mod, 2, jnp.asarray(x), jnp.asarray(hidden), jnp.asarray(masks))
    ours = RNNStateEncoder(D, H, "GRU")
    wp.load_state(ours, wp.rnn_state(variables["params"], "rnn."))
    assert ours.initial_hidden(Bn).shape == (1, Bn, H)
    for args in ((x, hidden, masks), (x[0], hidden, masks[0])):  # sequence, one tick
        xs = [_t(a).requires_grad_(a is hidden) for a in args]
        out, new_hidden = ours(*xs)
        ref_out, ref_hidden = jax.jit(ref_mod.apply)(variables, *args)
        assert new_hidden.shape == (1, Bn, H)
        assert new_hidden.requires_grad == (args[0].ndim == 2)  # a window's carry detached
        _close(out.detach(), ref_out, TOL)
        _close(new_hidden.detach(), ref_hidden, TOL)


@pytest.mark.parametrize("rnn_type,bidirectional", [("LSTM", True), ("GRU", False)])
def test_packed_rnn_matches_the_scan(rng, rnn_type, bidirectional):
    """The instruction RNNs' path (the module's own forward over a packed
    sequence: cuDNN on the card, torch's CPU RNN here) against the
    length-masked scans, rows of length 0, 3 and L: outputs (exact zeros at
    the pads), final states and gradients within 1e-5."""
    from robo_vln_tpu_torch.models.encoders import instruction

    torch.manual_seed(0)
    rnn = instruction.RNN_TYPES[rnn_type](5, 7, batch_first=True, bidirectional=bidirectional)
    lengths = torch.tensor([0, 3, L])
    x = torch.from_numpy(rng.standard_normal((3, L, 5)).astype(np.float32))
    got, want = [], []
    for fn, out in ((instruction.run_rnn, got), (instruction.run_scan, want)):
        xs = x.clone().requires_grad_()
        outs, final, c = fn(rnn, xs, lengths)
        grads = torch.autograd.grad((outs * 1.3).sum() + final.sum(), [xs, *rnn.parameters()])
        out.extend([outs, final, *([c] if c is not None else []), *grads])
    assert len(got) == len(want)
    for g, w in zip(got, want):
        _close(g.detach(), w.detach(), OPS_TOL)
    assert torch.equal(got[0][0], torch.zeros_like(got[0][0]))
    assert torch.equal(got[0][1, 3:], torch.zeros_like(got[0][1, 3:]))


@pytest.mark.parametrize("rnn_type,bidirectional,final", [
    ("LSTM", False, True), ("LSTM", True, False), ("GRU", True, True)])
def test_instruction_encoder_matches_jax(rng, rnn_type, bidirectional, final):
    ids = instruction_ids(rng, 4, lengths=[0, 2, 5, L])
    kw = dict(vocab_size=30, embedding_size=6, hidden_size=8, rnn_type=rnn_type,
              final_state_only=final, bidirectional=bidirectional)
    ref_mod = jax_instruction.InstructionEncoder(use_pretrained_embeddings=False, **kw)
    variables = _init(ref_mod, 3, jnp.asarray(ids))
    ours = InstructionEncoder(**kw)
    wp.load_state(ours, wp.instruction_encoder_state(variables["params"], ""))
    got = ours(_t(ids))
    want = jax.jit(ref_mod.apply)(variables, ids)
    _close(got.detach(), want, TOL)
    if not final:  # channel-major, exact zeros at the pads (CMA's text mask)
        assert got.shape == (4, 16, L)
        assert torch.equal(got[0], torch.zeros(16, L)) and (got[1, :, 2:] == 0).all()


def test_glove_table_read_only_when_present(tmp_path):
    """use_pretrained_embeddings reads embedding_file when it exists; a
    missing file leaves the table learned from its random start."""
    import gzip
    import json

    table = np.arange(30 * 6, dtype=np.float32).reshape(30, 6) / 100
    path = tmp_path / "embeddings.json.gz"
    with gzip.open(path, "wt") as f:
        json.dump(table.tolist(), f)
    np.testing.assert_array_equal(load_glove_embeddings(str(path)), table)
    assert load_glove_embeddings(str(tmp_path / "missing.json.gz")) is None
    for file, want in ((str(path), table), (str(tmp_path / "missing.json.gz"), None)):
        _, mc = flat_configs(SIMPLE_PX, {**SIMPLE, "INSTRUCTION_ENCODER.embedding_file": file,
                                         "INSTRUCTION_ENCODER.use_pretrained_embeddings": True})
        got = build_flat_policy(mc, rgb_hw=(SIMPLE_PX,) * 2).instruction_encoder
        got = got.embedding_layer.weight.detach().numpy()
        if want is None:
            assert got.std() > 0.5  # N(0, 1), as flax's normal(1.0)
        else:
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("final", [True, False])
def test_language_encoder_matches_jax(rng, final):
    jax_mc, port_mc = flat_configs(SIMPLE_PX, {})
    ids = instruction_ids(rng, 3, lengths=[1, 4, L])
    ref_mod = jax_language.LanguageEncoder(bert_config=jax_mc.BERT, hidden_size=8,
                                           final_state_only=final, bidirectional=True)
    variables = _init(ref_mod, 4, jnp.asarray(ids))
    ours = LanguageEncoder(port_mc.BERT, hidden_size=8, final_state_only=final,
                           bidirectional=True).eval()
    # under the policy's prefix: flax creates encoder2decoder only where it is read
    wp.load_state(torch.nn.ModuleDict({"instruction_encoder": ours}),
                  wp.instruction_encoder_state(variables["params"]))
    got = ours(_t(ids))
    want = jax.jit(ref_mod.apply)(variables, ids)
    if final:
        _close(got.detach(), want, TOL)
    else:
        _close(got[0].detach(), want[0], TOL)
        _close(got[1][0].detach(), want[1][0], TOL)
        _close(got[1][1].detach(), want[1][1], TOL)


@pytest.mark.parametrize("key", ["rgb", "depth"])
def test_simple_cnn_matches_jax(rng, key):
    px = (SIMPLE_PX + 12, SIMPLE_PX + 12)  # a 2 x 2 map before the Linear
    c = 3 if key == "rgb" else 1
    x = (rng.integers(0, 255, (2,) + px + (c,)).astype(np.uint8) if key == "rgb"
         else rng.random((2,) + px + (c,)).astype(np.float32))
    ref_mod = jax_visual.SimpleCNN(8, key)
    variables = _init(ref_mod, 6, {key: jnp.asarray(x)})
    ours = SimpleCNN(key, 8, px)
    wp.load_state(ours, wp.simple_cnn_state(variables["params"], ""))
    _close(ours({key: _t(x)}).detach(), jax.jit(ref_mod.apply)(variables, {key: x}), TOL)


# -- the policies ---------------------------------------------------------------------

RCM = (("CMA.use", True), ("CMA.rcm_state_encoder", True))
CMA_CASES = {"uni": (("CMA.use", True),),
             "bi": (("CMA.use", True), ("INSTRUCTION_ENCODER.bidirectional", True)),
             # the RCM first encoder, fed the raw velocities or their embedding
             "rcm": RCM, "rcm_prev": RCM + (("CMA.use_prev_action", True),)}
SEQ2SEQ_CASES = {
    "simple_cnn_pm_prev": tuple({**SIMPLE, "PROGRESS_MONITOR.use": True,
                                 "SEQ2SEQ.use_prev_action": True}.items()),
    "bert_gru": tuple({**SIMPLE, "INSTRUCTION_ENCODER.is_bert": True,
                       "STATE_ENCODER.rnn_type": "GRU"}.items()),
    "resnet": (),
    "ablations": tuple({**SIMPLE, "ablate_instruction": True, "ablate_rgb": True}.items()),
}


def _check_policy(px, overrides, lengths=None):
    """A window, then its ticks one at a time from the same hidden, then the
    window again with the instruction's encoding given: each within TOL of
    the JAX policy."""
    _, _, jpolicy, variables, japply = jax_flat(px, overrides)
    policy = port_flat(px, overrides)
    obs, masks, prev = flat_inputs(np.random.default_rng(1), px, lengths=lengths)
    jobs = jax.tree.map(jnp.asarray, obs)
    want = japply(variables, jobs, jpolicy.initial_hidden(B), jnp.asarray(prev),
                  jnp.asarray(masks))
    with torch.no_grad():
        tobs = {k: _t(v) for k, v in obs.items()}
        hidden = policy.initial_hidden(B)
        got = policy(tobs, hidden, _t(prev), _t(masks))
        for g, w, what in zip(got[:3], want[:3], ("actions", "stop", "hidden")):
            _close(g, w, TOL, what)
        assert got[3].keys() == want[3].keys()
        for k in want[3]:
            _close(got[3][k], want[3][k], TOL, k)
        emb = policy.encode_instruction(tobs["instruction"])
        again = policy({**tobs, "instruction_embedding": emb}, hidden, _t(prev), _t(masks))
        for g, a in zip(got[:3], again[:3]):
            torch.testing.assert_close(g, a, atol=0, rtol=0)
        jh, th = jpolicy.initial_hidden(B), hidden
        for t in range(T):
            tick = {k: (v if k == "instruction" else v[:, t]) for k, v in obs.items()}
            jw = japply(variables, jax.tree.map(jnp.asarray, tick), jh,
                        jnp.asarray(prev[:, t]), jnp.asarray(masks[:, t]))
            tg = policy({k: _t(v) for k, v in tick.items()}, th, _t(prev[:, t]),
                        _t(masks[:, t]))
            jh, th = jw[2], tg[2]
            for g, w, what in zip(tg[:3], jw[:3], ("actions", "stop", "hidden")):
                _close(g, w, TOL, f"tick {t} {what}")


@pytest.mark.parametrize("case", sorted(CMA_CASES))
def test_cma_forward_matches_jax(case):
    """CMA at 32 px with a row of length 0 (the text mask all True) and a
    full row."""
    _check_policy(RESNET_PX, CMA_CASES[case], lengths=[0, 4, L])


@pytest.mark.parametrize("case", sorted(SEQ2SEQ_CASES))
def test_seq2seq_forward_matches_jax(case):
    px = RESNET_PX if case == "resnet" else SIMPLE_PX
    _check_policy(px, SEQ2SEQ_CASES[case])


def test_rcm_state_encoder_matches_jax(rng):
    """models/rcm.RCMStateEncoder alone against the JAX package's, with a
    mask of 0 inside the window and a carried hidden: its outputs and the
    packed (GRU h, last output) within 1e-5."""
    from robo_vln_tpu.models.rcm import RCMStateEncoder as JaxRCM
    from robo_vln_tpu_torch.models.rcm import RCMStateEncoder

    t, b, H = 5, 2, 16
    rgb = rng.standard_normal((t, b, 5, 12)).astype(np.float32)
    depth = rng.standard_normal((t, b, 7, 8)).astype(np.float32)
    pa = rng.standard_normal((t, b, 4)).astype(np.float32)
    masks = np.ones((t, b), np.float32)
    masks[0, 0] = masks[3, 1] = 0.0
    hidden = rng.standard_normal((2, b, H)).astype(np.float32)
    ref = JaxRCM(hidden_size=H)
    variables = _init(ref, 3, rgb, depth, pa, hidden, masks)
    want_outs, want_hidden = jax.jit(ref.apply)(variables, rgb, depth, pa, hidden, masks)
    ours = RCMStateEncoder(12, 8, 4, H)
    wp.load_state(ours, wp.rcm_state(variables["params"], ""))
    got_outs, got_hidden = ours(_t(rgb), _t(depth), _t(pa), _t(hidden), _t(masks))
    _close(got_outs.detach(), want_outs, OPS_TOL, "outs")
    _close(got_hidden, want_hidden, OPS_TOL, "hidden")
    assert not got_hidden.requires_grad


def test_rcm_state_encoder_replaces_the_first_encoder():
    """MODEL.CMA.rcm_state_encoder, which the port once refused, is read:
    get_config takes it and CMA builds the RCM encoder where the first
    LSTM was, without rgb_linear and depth_linear, its hidden still
    (4, B, H); the JAX tree's params all land in the port's module."""
    assert get_config(opts=["MODEL.CMA.rcm_state_encoder", "True"]).MODEL.CMA.rcm_state_encoder
    policy = port_flat(RESNET_PX, CMA_CASES["rcm"])
    keys = policy.state_dict().keys()
    assert "state_encoder.q_net.weight" in keys and "state_encoder.rgb_kv.weight" in keys
    assert not any(k.startswith(("rgb_linear.", "depth_linear.")) for k in keys)
    assert policy.initial_hidden(2).shape == (4, 2, TINY_FLAT["STATE_ENCODER.hidden_size"])


def test_flat_policies_build_the_reference_heads():
    """The reference builds progress_monitor (both) and sub_goal_linear
    (Seq2Seq) whatever the config: their keys are in the port's state_dict,
    so a reference .pth loads; the JAX variables, which lack them, load
    too."""
    cma = port_flat(RESNET_PX, CMA_CASES["uni"]).state_dict()
    s2s = port_flat(SIMPLE_PX, SEQ2SEQ_CASES["bert_gru"]).state_dict()
    assert "progress_monitor.weight" in cma and "sub_goal_linear.weight" in s2s
    assert "instruction_encoder.encoder2decoder.weight" in s2s
    assert "instruction_encoder.encoder_rnn.weight_hh_l0" in cma
