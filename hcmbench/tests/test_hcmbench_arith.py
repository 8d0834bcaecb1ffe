"""The yardstick's arithmetic: FLOPs counted over the reference, the
kernels' bounds, and the reductions of a trace to rooflines, the whole
step's share of the peak, the idle share and occupancy."""

import json

import pytest
import torch

from hcmbench import flops, harness, readers
from hcmbench.reference import ops, trunks
from hcmbench.trace import Trace, parse
from hcmbench.weights import make_weights


def _tv_resnet50_shapes():
    """torchvision ResNet50's trunk weights, by the port's key names."""
    shapes = {"conv1.weight": (64, 3, 7, 7)}
    inplanes = 64
    for stage, (n, planes) in enumerate(zip((3, 4, 6, 3), (64, 128, 256, 512)), 1):
        for i in range(n):
            b = f"layer{stage}.{i}."
            shapes.update({b + "conv1.weight": (planes, inplanes, 1, 1),
                           b + "conv2.weight": (planes, planes, 3, 3),
                           b + "conv3.weight": (planes * 4, planes, 1, 1)})
            if i == 0:
                shapes[b + "downsample.0.weight"] = (planes * 4, inplanes, 1, 1)
            inplanes = planes * 4
    return {k: torch.empty(v, device="meta") for k, v in shapes.items()}


def test_resnet50_flops():
    w = _tv_resnet50_shapes()
    norms = {}
    for k, v in w.items():  # each conv's BatchNorm: conv<i> -> bn<i>, downsample.0 -> .1
        if "downsample" in k:
            stem = k.replace("downsample.0.weight", "downsample.1")
        else:
            stem = k.replace("conv", "bn")[:-len(".weight")]
        for s in ("weight", "bias", "running_mean", "running_var"):
            norms[f"{stem}.{s}"] = torch.empty(v.shape[0], device="meta")
    rgb = torch.empty(1, 224, 224, 3, dtype=torch.uint8, device="meta")
    macs = flops.count_flops(trunks.tv_resnet50, ops.Arith(), {**w, **norms}, "", rgb) / 2
    assert macs == pytest.approx(4.1e9, rel=0.02)


def test_bert_base_flops_closed_form():
    L, d, n, inter, vocab = 12, 768, 200, 3072, 30522
    w = {"embeddings.word_embeddings.weight": (vocab, d),
         "embeddings.position_embeddings.weight": (512, d),
         "embeddings.token_type_embeddings.weight": (2, d),
         "embeddings.LayerNorm.weight": (d,), "embeddings.LayerNorm.bias": (d,)}
    for i in range(L):
        b = f"encoder.layer.{i}."
        for name in ("attention.self.query", "attention.self.key", "attention.self.value",
                     "attention.output.dense"):
            w.update({b + name + ".weight": (d, d), b + name + ".bias": (d,)})
        w.update({b + "intermediate.dense.weight": (inter, d), b + "intermediate.dense.bias": (inter,),
                  b + "output.dense.weight": (d, inter), b + "output.dense.bias": (d,)})
        for ln in ("attention.output.LayerNorm", "output.LayerNorm"):
            w.update({b + ln + ".weight": (d,), b + ln + ".bias": (d,)})
    w = {k: torch.empty(v, device="meta") for k, v in w.items()}
    ids = torch.zeros(1, n, dtype=torch.long, device="meta")
    counted = flops.count_flops(trunks.bert, ops.Arith(), w, "", ids, 12)
    assert counted == pytest.approx(2 * L * (12 * d * d + 2 * n * d) * n, rel=0.02)


def test_kernel_bounds_at_the_hcm_shapes():
    """Two LSTM calls at T=50, B=4, H=512 (forward; the backward's three
    products) and the bf16 attention at S=16 and 64, as PERF.md's kernel
    table gives them."""
    fwd = 2 * flops.least_ms(flops.lstm_bound_ms(50, 4, 512))
    bwd = 2 * flops.least_ms(flops.lstm_backward_bound_ms(50, 4, 512)[0])
    attn = sum(flops.least_ms(flops.attn_bound_ms(200, 200, s, 4, 64, 2,
                                                  flops.BF16_TC_FLOP_PER_S)) for s in (16, 64))
    assert round(fwd, 4) == 0.0125 and round(bwd, 4) == 0.0376 and round(attn, 4) == 0.0293


def _trace(ops_, window_s=1.0, launches=None, ranges=None, host=()):
    return Trace(window_s, list(ops_), launches or {}, ranges or {}, list(host))


def test_busy_idle_and_ranges():
    # kernels at 0-100 us and 50-150 us overlap: busy 150 us; one at 300-400
    tr = _trace([("k_a", 0.0, 100.0, 1), ("k_b", 50.0, 100.0, 2), ("lstm_seq_kernel", 300.0,
                                                                   100.0, 3)],
                window_s=1e-3, launches={1: (7, 5.0), 2: (7, 60.0), 3: (9, 250.0)},
                ranges={"R": [(7, 0.0, 55.0)]},
                host=[(7, 150.0, 290.0, "aten::mm")])
    assert tr.busy_s() == pytest.approx(250e-6)
    assert readers.device_idle({"trace": tr}) == pytest.approx(75.0)
    assert tr.range_device_s("R") == pytest.approx(100e-6)  # only k_a launched inside
    # the gap 150-300 us falls inside aten::mm; the window's tail is not a gap
    assert tr.idle_gaps() == [["aten::mm", pytest.approx(150e-6)]]


def test_rooflines_and_mfu():
    fwd = flops.least_ms(flops.lstm_bound_ms(50, 4, 512))
    bwd = flops.least_ms(flops.lstm_backward_bound_ms(50, 4, 512)[1])
    # two steps; the LSTM kernels took 10x their least time in all
    took_us = 10 * 2 * (2 * fwd + 2 * bwd) * 1e3
    tr = _trace([("lstm_seq_kernel", 0.0, took_us / 2, 1),
                 ("lstm_seq_backward_partials_kernel", took_us, took_us / 2, 2)])
    calls = {"lstm_forward": [(50, 4, 512)] * 2, "lstm_backward": [(50, 4, 512)] * 2,
             "attention": [(200, 200, 16, 4, 64, 2)]}
    rec = {"trace": tr, "trace_steps": 2, "kernel_calls": calls}
    assert readers.lstm_roofline(rec) == pytest.approx(10.0)
    assert readers.attn_roofline(rec) is None  # no attention kernel in the trace: nothing read
    rec.update(flops_per_step=989e12 * 0.05, untraced_window_s=1.0)
    assert readers.mfu(rec) == pytest.approx(10.0)


def test_occupancy_and_eval_rates():
    read = harness.metric_reader("batch_occupancy.eval")
    assert read({"graph_ticks": 4, "live_ticks": 600, "batch": 8, "ticks_stepped": 100}) == 75.0
    assert harness.metric_reader("eval_env_steps_per_s")(
        {"graph_ticks": 4, "live_ticks": 600, "window_s": 2.0}) == 300.0
    assert harness.metric_reader("train_frames_per_s")(
        {"window_len": 50, "steps": 10, "rows": 4, "ranks": 4, "window_s": 2.0}) == 4000.0
    assert harness.metric_reader("train_step_ms_p95")(
        {"window_len": 50, "step_ms": list(range(101))}) == 95.0
    mesh_p95 = harness.metric_reader("train_step_ms_p95.mesh")
    assert mesh_p95({"ranks": 4, "window_step_ms": list(range(101))}) == 95.0
    assert mesh_p95({"ranks": 1, "window_step_ms": list(range(101))}) is None
    # a train metric finds nothing in an eval record, and the other way round
    assert harness.metric_reader("mfu.train")({"graph_ticks": 4}) is None
    assert harness.metric_reader("mfu.eval")({"window_len": 50}) is None


def test_chrome_trace_parse(tmp_path):
    events = {"traceEvents": [
        {"ph": "X", "cat": "kernel", "name": "k", "ts": 10, "dur": 5, "args": {"correlation": 4}},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 2, "dur": 1,
         "tid": 3, "args": {"correlation": 4}},
        {"ph": "X", "cat": "user_annotation", "name": "R", "ts": 0, "dur": 8, "tid": 3},
        {"ph": "i", "cat": "kernel", "name": "ignored", "ts": 0}]}
    path = tmp_path / "t.json"
    path.write_text(json.dumps(events))
    tr = parse(str(path), 1.0)
    assert tr.range_device_s("R") == pytest.approx(5e-6) and tr.busy_s() == pytest.approx(5e-6)


def test_weights_from_the_seed():
    shapes = {"a.weight": (4, 3), "a.bias": (4,), "ln.weight": (3,), "t.embeddings.x.weight": (5, 2)}
    one = make_weights(shapes, 2**31 + 11, "cpu")
    two = make_weights(shapes, 2**31 + 11, "cpu")
    assert all(torch.equal(one[k], two[k]) for k in shapes)
    assert torch.equal(one["ln.weight"], torch.ones(3)) and not one["a.bias"].any()
    assert not torch.equal(one["a.weight"], make_weights(shapes, 2**31 + 12, "cpu")["a.weight"])
