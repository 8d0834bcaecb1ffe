"""The port's profiling module (robo_vln_tpu_torch/utils/profiling.py) against
the JAX package's: StepTimer's EMA and log lines on the same step durations,
the trace directory, the module ranges inside a profile of the tiny HCM train
step, and the live-capture server, which torch.profiler lacks."""

import logging
import os

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from robo_vln_tpu.utils import profiling as jax_profiling
from robo_vln_tpu_torch.utils import profiling
from tests.test_torch_threads import one_torch_thread  # noqa: F401
from tests.test_torch_train_step import LR, _torch, make_batch, port_setup

DURATIONS = [0.012, 0.0305, 0.0071, 0.25, 0.0119, 0.0402, 0.0199]


@pytest.mark.parametrize("scope", [False, True])
def test_step_timer_matches_jax(monkeypatch, caplog, scope):
    averages = {}
    for name, module, kwargs in (("jax", jax_profiling, {}),
                                 ("port", profiling, {"scope": scope})):
        ticks = iter(np.cumsum([x for d in DURATIONS for x in (0.0, d)]).tolist())
        monkeypatch.setattr(module.time, "perf_counter", lambda: next(ticks))
        timer = module.StepTimer("unit", log_every=3, ema=0.9, **kwargs)
        caplog.clear()
        with caplog.at_level(logging.INFO):
            seen = []
            for _ in DURATIONS:
                with timer:
                    pass
                seen.append(timer.average)
        averages[name] = (seen, [r.getMessage() for r in caplog.records
                                 if r.getMessage().startswith("unit:")])
    assert averages["port"] == averages["jax"]
    assert len(averages["port"][1]) == len(DURATIONS) // 3


def test_step_timer_scope_is_a_range():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiling.StepTimer("timed_region", scope=True):
            torch.ones(4).sum()
    assert "timed_region" in {e.name for e in prof.events()}


def test_trace_writes_a_tensorboard_trace(tmp_path):
    with profiling.trace(str(tmp_path)):
        torch.ones(8).sum().item()
    found = [f for _, _, files in os.walk(tmp_path) for f in files
             if f.endswith((".pt.trace.json", ".pt.trace.json.gz"))]
    assert found, "no trace written"


def test_module_ranges_in_a_train_step_profile():
    """The trunks', BERT's and both policies' ranges sit inside the step's
    forward range, each once a step (the trunks run once for both levels)."""
    high, low, state, step, _ = port_setup(weights=False)
    batch = _torch(make_batch(np.random.default_rng(0), 0))
    hh, lh = high.initial_hidden(3), low.initial_hidden(3)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        step(state, hh, lh, batch, LR, LR)
    events = prof.events()
    names = [e.name for e in events]
    for name in profiling.MODULE_RANGES:
        assert names.count(name) == 1, (name, names.count(name))
    forward = next(e for e in events if e.name == "hier_train_step.forward")
    for e in events:
        if e.name in profiling.MODULE_RANGES:
            assert forward.time_range.start <= e.time_range.start
            assert e.time_range.end <= forward.time_range.end


def test_trace_server_refuses_a_port(monkeypatch):
    monkeypatch.delenv("ROBO_VLN_PROFILE_PORT", raising=False)
    assert profiling.maybe_start_trace_server() is None
    with pytest.raises(NotImplementedError, match="9012.*live-capture"):
        profiling.maybe_start_trace_server(9012)
    monkeypatch.setenv("ROBO_VLN_PROFILE_PORT", "9013")
    with pytest.raises(NotImplementedError, match="9013"):
        profiling.maybe_start_trace_server()
