"""The high level without the cross-modal transformer
(models/hierarchical_seq2seq.HighLevelSeq2SeqPolicy) against the JAX
package's, on the CPU, float32: the tiny sizes of
tests/test_torch_flat_models.py at 32 px, the GloVe instruction encoder and
BERT's, a window and its single-step ticks from the same hidden, each
within 1e-4 (the forward's tolerance of tests/test_torch_agent.py).  As in
the JAX package (tests/test_language_models.py) no build function reaches it."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from robo_vln_tpu.models.hierarchical_seq2seq import (
    HighLevelSeq2SeqPolicy as JaxHighLevelSeq2Seq,
)
from robo_vln_tpu_torch.models import init_weights
from robo_vln_tpu_torch.models.hierarchical_seq2seq import HighLevelSeq2SeqPolicy
from robo_vln_tpu_torch.ops import fused_lstm
from robo_vln_tpu_torch.utils import weight_port as wp
from tests.test_torch_flat_models import (B, RESNET_PX, T, TOL, _close, _init, _t,
                                          flat_configs, flat_inputs)
from tests.test_torch_threads import one_torch_thread  # noqa: F401


@pytest.mark.parametrize("is_bert", [False, True])
def test_high_level_seq2seq_matches_jax(is_bert, monkeypatch):
    overrides = {"INSTRUCTION_ENCODER.is_bert": is_bert}
    jax_mc, port_mc = flat_configs(RESNET_PX, overrides)
    jax_mc.freeze()
    ref = JaxHighLevelSeq2Seq(model_config=jax_mc)
    obs, masks, _ = flat_inputs(np.random.default_rng(2), RESNET_PX)
    jobs = jax.tree.map(jnp.asarray, obs)
    hidden = np.random.default_rng(3).standard_normal((2, B, 16)).astype(np.float32)
    variables = _init(ref, 9, jobs, jnp.asarray(hidden), None, jnp.asarray(masks))
    apply = jax.jit(ref.apply)
    policy = HighLevelSeq2SeqPolicy(port_mc)
    init_weights(policy, torch.Generator().manual_seed(0))
    wp.load_high_level_seq2seq_weights(policy, variables)
    policy.eval()

    calls = []
    lstm = fused_lstm.lstm_sequence_fused
    monkeypatch.setattr(fused_lstm, "lstm_sequence_fused",
                        lambda *a: calls.append(a[0].shape) or lstm(*a))
    want_logits, want_hidden = apply(variables, jobs, jnp.asarray(hidden), None,
                                     jnp.asarray(masks))
    with torch.no_grad():
        tobs = {k: _t(v) for k, v in obs.items()}
        logits, got_hidden = policy(tobs, _t(hidden), None, _t(masks))
        assert logits.shape == (B, T, 4) and [c[:2] for c in calls] == [(T, B)]  # one LSTM call
        _close(logits, want_logits, TOL, "logits")
        _close(got_hidden, want_hidden, TOL, "hidden")
        jh, th = jnp.asarray(hidden), _t(hidden)
        for t in range(T):
            tick = {k: (v if k == "instruction" else v[:, t]) for k, v in obs.items()}
            jl, jh = apply(variables, jax.tree.map(jnp.asarray, tick), jh, None,
                           jnp.asarray(masks[:, t]))
            tl, th = policy({k: _t(v) for k, v in tick.items()}, th, None, _t(masks[:, t]))
            _close(tl, jl, TOL, f"tick {t} logits")
            _close(th, jh, TOL, f"tick {t} hidden")
