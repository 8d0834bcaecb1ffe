"""The readings that the limits of ``correct`` are set from, at a cell's own
sizes, on the card:

    python3 hcmbench/calibrate.py --workload <name> --seeds 1,2,... \
        --control-seeds 7,8,9 --out <file.json>

For each of ``--seeds``: the program's check steps against the float32
reference (the lower readings).  For each of ``--control-seeds``, against
the same float32 reference: the control (the reference stored in float8
e4m3, hcmbench/reference/ops.py), the reference stored in bfloat16 (a
witness of what the configuration's precision alone gives), and the faults
that the cell can have, planted in the reference put in the program's
place: part of the batch left out (half of its episodes, or of a single
episode's window; on several cards, every rank's rows but rank 0's, as a
step without the exchange between cards sees them).  A state left
unchanged reads 1 on change_gap by construction and is not run.

For the on-device eval: a batch of the rollout on each seed, followed by the
float32 reference; on the control seeds the same batch followed again in
float8 (the control) and in bfloat16 (a witness).  ``--recorder-cost``:
the tick with and without the harness's recorder of each tick's outputs.
"""

import argparse
import json
import os
import statistics
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def _free():
    from hcmbench import harness

    harness.CARD.release()


def program_readings(cell, seeds, device, mesh=None, rank=0, ranks=1):
    """{seed: numbers} of the program against the float32 reference (rank 0)."""
    from hcmbench.drivers import train

    out = {}
    for seed in seeds:
        cell.seed = seed
        setup = train.Setup(cell, device, mesh, rank, ranks, keep_global=rank == 0)
        got = setup.check_steps()
        setup.program = setup.pool = None
        _free()
        if rank == 0:
            ref = train.reference_readings(cell, setup)
            out[seed] = {**train.numbers(got, ref), "where": train.worst(got, ref),
                         "raw": {"program": got, "reference": ref}}
            print(f"seed {seed}: " + str({k: v for k, v in out[seed].items() if k != "raw"}),
                  flush=True)
        del setup
        _free()
    return out


def control_readings(cell, seeds, device):
    """{seed: {"control": numbers, "fault_rows": numbers}}."""
    from hcmbench.drivers import train

    out = {}
    rows = cell.mix["batch"] if cell.mix.get("ranks", 1) > 1 else max(1, cell.mix["batch"] // 2)
    for seed in seeds:
        cell.seed = seed
        inputs = train.Setup(cell, device, build_program=False)
        inputs.pool = None
        ref = train.reference_readings(cell, inputs)
        ctrl = train.reference_readings(cell, inputs, "float8")
        witness = train.reference_readings(cell, inputs, "bfloat16")
        fault = train.reference_readings(cell, inputs, rows=rows)
        out[seed] = {"control": {**train.numbers(ctrl, ref), "where": train.worst(ctrl, ref)},
                     "bfloat16_reference": train.numbers(witness, ref),
                     "fault_rows": train.numbers(fault, ref),
                     "raw": {"reference": ref, "control": ctrl, "bfloat16_reference": witness,
                             "fault_rows": fault}}
        print(f"control seed {seed}: " + str({k: v for k, v in out[seed].items() if k != "raw"}),
              flush=True)
        del inputs
        _free()
    return out


def eval_readings(cell, seeds, control_seeds, device):
    """The on-device eval's readings: for each seed, a batch of the rollout
    followed by the float32 reference (the program's numbers); on the
    control seeds the same batch followed again by the reference stored in
    float8 (the control) and in bfloat16 (the witness), each held to the
    float32 reference's outputs."""
    from hcmbench.drivers import eval_ondevice as ev_drv
    from hcmbench.reference import rollout as ref_rollout

    out = {"program": {}, "control": {}}
    for seed in list(seeds) + [s for s in control_seeds if s not in seeds]:
        cell.seed = seed
        ev = ev_drv.Eval(cell, device)
        ev.batch(keep=False)  # the capture
        batch = ev.batch()
        cfg, mix = ev.cfg, cell.mix
        sim = cfg.TASK_CONFIG.SIMULATOR
        hw = ((sim.RGB_SENSOR.HEIGHT, sim.RGB_SENSOR.WIDTH),
              (sim.DEPTH_SENSOR.HEIGHT, sim.DEPTH_SENSOR.WIDTH))
        args = (ev.weights, ev.fam.reference_sizes(cell.config, cfg), batch["episode"],
                batch["record"], __import__("torch").as_tensor(batch["steps"]), hw,
                cfg.DAGGER.time_step, mix["max_steps"])
        ev.rollout = ev.recorder = ev.policy = ev.agent = None
        _free()
        ref = ref_rollout.follow(*args)
        if seed in seeds:
            out["program"][seed] = {**ev_drv.compare(batch, ref), "ticks": ref["ticks"]}
            print(f"seed {seed}: {out['program'][seed]}", flush=True)
        if seed in control_seeds:
            out["control"][seed] = {p: ev_drv.compare_references(
                batch, ref, ref_rollout.follow(*args, precision=p))
                for p in ("float8", "bfloat16")}
            print(f"control seed {seed}: {out['control'][seed]}", flush=True)
        del ev, batch, ref
        _free()
    return out


def recorder_cost(cell, batches, rounds):
    """What the harness's recorder adds to the eval's timed graph: the
    rollout built and captured anew ``rounds`` times with the recorder and
    as often without it (the agent's step alone, no hook), alternately;
    each build's median and 95th percentile tick ms over the replays of
    ``batches`` batches after the capture."""
    from hcmbench import harness
    from hcmbench.drivers import eval_ondevice as ev_drv
    from robo_vln_tpu_torch.eval.ondevice import GRAPH_TICKS

    out = {"with": [], "without": []}
    for _ in range(rounds):
        for variant in out:
            ev = ev_drv.Eval(cell, "cuda")
            if variant == "without":
                ev.policy = ev.agent.step
                ev.hook.remove()
            for _ in range(batches + 1):  # the first captures
                ev.batch(keep=False)
            ticks = ev_drv._replay_tick_ms(ev.batches[1:], GRAPH_TICKS)
            out[variant].append({"median_ms": statistics.median(ticks),
                                 "p95_ms": harness.percentile(ticks, 95), "replays": len(ticks)})
            print(f"recorder {variant}: {out[variant][-1]}", flush=True)
            del ev
            _free()
    return out


def _rank(rank, device, cell, seeds, fault_seeds, path):
    """A rank of the program's readings over several cards; then, on
    ``fault_seeds``, the same with the exchange between the cards left out
    (each rank's all-reduce returning its own gradients and losses)."""
    import torch
    from robo_vln_tpu_torch.parallel.mesh import DataMesh

    mesh = DataMesh(device)
    out = {"program": program_readings(cell, seeds, device, mesh, rank, mesh.size)}
    DataMesh.reduce_step = lambda self, grads, scalars: (list(grads), list(scalars))
    out["fault_exchange"] = program_readings(cell, fault_seeds, device, mesh, rank, mesh.size)
    if rank == 0:
        torch.save(out, path)


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", default="")
    parser.add_argument("--control-seeds", default="")
    parser.add_argument("--exchange-fault-seeds", default="",
                        help="several cards: seeds run with the all-reduce left out")
    parser.add_argument("--recorder-cost", type=int, default=0, metavar="BATCHES",
                        help="the eval: tick ms with and without the recorder, BATCHES each")
    parser.add_argument("--out", required=True)
    parser.add_argument("--option", action="append", default=[],
                        help="KEY=VALUE of the port's config, for a diagnosis (JSON value)")
    args = parser.parse_args(argv)
    import torch
    from hcmbench import harness

    cell = harness.load_cell(args.workload)
    harness.require_cards(cell.chips if args.seeds else 1)
    for opt in args.option:
        key, value = opt.split("=", 1)
        cell.config["options"][key] = json.loads(value)
    seeds = [int(s) for s in args.seeds.split(",") if s]
    control = [int(s) for s in args.control_seeds.split(",") if s]
    t0 = time.time()
    ranks = cell.mix.get("ranks", 1)
    result = {"workload": args.workload, "card": torch.cuda.get_device_name(0),
              "power_limit": harness.power_limits()}
    if args.recorder_cost:
        result["recorder_cost"] = recorder_cost(cell, args.recorder_cost, 2)
    if cell.mix["driver"] == "eval_ondevice":
        result.update(eval_readings(cell, seeds, control, "cuda"))
        seeds = control = []
    if seeds:
        if ranks == 1:
            result["program"] = program_readings(cell, seeds, "cuda")
        else:
            import tempfile

            from robo_vln_tpu_torch.parallel.mesh import spawn

            path = os.path.join(tempfile.mkdtemp(prefix="hcmbench-cal-"), "out.pt")
            faults = [int(s) for s in args.exchange_fault_seeds.split(",") if s]
            spawn(_rank, ranks, "cuda", cell, seeds, faults, path, timeout_s=3000)
            result.update(torch.load(path, weights_only=False))
    if control:
        result["control"] = control_readings(cell, control, "cuda")
    result["seconds"] = time.time() - t0
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(result, f, indent=1)
    print(json.dumps(result))


if __name__ == "__main__":
    main()
