"""The readings that a training cell's limits are set from, one process
for many seeds (no window is needed for them):

  python3 benchmark/readings.py --workload st_train_b128k \
      --seeds 11,12,13 [--control] [--fault half_batch]

For each seed of a training cell it sets the cell up as a run does,
takes the program's checked steps and prints, as one JSON line, the
numbers that `correct` compares for:

- program: the program against the float32 reference (the lower
  reading is the largest over a dozen seeds or more);
- control (--control): the reference computed with float8 matmul and
  convolution operands, put in the program's place (the upper reading);
- fault (--fault half_batch): the program with half of each batch's
  real rows left out and the mean taken over the rest.

A state left unchanged reads 1 on change_gap by construction and is not
run. For a serving cell each seed runs a short window (--seconds) at the
cell's load and judges its sampled answers (program), and the float8
reference's own answers to the same requests (--control). Not part of
a benchmark run; the tests run it at a small size.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def half_batch(program):
    """Plant the fault: every step sees only the first half of its real
    rows; the rest become length-0 rows, which carry no loss."""
    step = program.step

    def call(batch, _call=step.__call__):
        batch = dict(batch)
        n = len(batch["ids"])
        lens = batch["feat_lengths"].copy()
        lens[n // 2:] = 0
        targets = batch["targets"].copy()
        targets[n // 2:] = -1
        tlens = batch["target_lengths"].copy()
        tlens[n // 2:] = 0
        batch.update(feat_lengths=lens, targets=targets,
                     target_lengths=tlens)
        return _call(batch)

    program.step = call
    program.step.model = step.model
    program.step.optimizer = step.optimizer


FAULTS = {"half_batch": half_batch}


def serve_readings(cell, seeds, device, control=False, seconds=4.0,
                   log=print):
    """A serving cell's readings: a short window at the cell's load a
    seed, then the program's numbers on the sampled answers and, with
    control, the float8 reference's in its place."""
    from benchmark.drivers import serve as drv
    for seed in seeds:
        t0 = time.perf_counter()
        out = drv.run(cell, seed, seconds, False, device, t0)
        requests, picked = out["sample"]
        rows = drv.reference_answers(cell, picked, requests, seed, device,
                                     search=True)
        row = {"seed": seed, "answered": out["attempted"],
               "program": drv.compare(rows), "rows": rows}
        if control:
            low = drv.reference_answers(cell, picked, requests, seed,
                                        device, control=True, search=True)
            row["control"] = drv.compare(low)
            row["control_rows"] = low
        row["seconds"] = time.perf_counter() - t0
        log(json.dumps(row))


def readings(cell, seeds, device, control=False, fault=None, log=print):
    import torch

    from benchmark import traffic
    from benchmark.drivers import train as drv
    for seed in seeds:
        t0 = time.perf_counter()
        corpus = traffic.make_train_corpus(
            cell.traffic, cell.config["model"]["vocab_size"], seed, device)
        row = {"seed": seed}
        runs = [("program", None)] + ([("fault", fault)] if fault else [])
        ref = None
        for label, planted in runs:
            prog = drv.Program(cell, corpus, seed, device)
            if planted:
                FAULTS[planted](prog)
            got, batches = prog.check_steps(cell.traffic["check_steps"])
            prog.close()
            del prog
            drv.free(device)
            if ref is None:
                ref = drv.reference_readings(cell, corpus, batches, seed,
                                             device, "f32")
            row[label] = drv.compare(got, ref)
            row[label + "_batches"] = [[b["rows"], b["t_pad"]]
                                       for b in batches]
            row[label + "_losses"] = got["losses"]
        row["reference_losses"] = ref["losses"]
        if control:
            low = drv.reference_readings(cell, corpus, batches, seed, device,
                                         "fp8")
            row["control"] = drv.compare(low, ref)
        row["seconds"] = time.perf_counter() - t0
        log(json.dumps(row))
        drv.free(device)
        if torch.device(device).type == "cuda":
            torch.cuda.reset_peak_memory_stats()


def main():
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control", action="store_true")
    p.add_argument("--fault", choices=sorted(FAULTS))
    p.add_argument("--seconds", type=float, default=4.0,
                   help="serving cells: the short window a seed")
    args = p.parse_args()
    from benchmark import harness
    cell = harness.Cell(args.workload)
    seeds = [int(s) for s in args.seeds.split(",")]
    out = lambda s: print(s, flush=True)  # noqa: E731
    if cell.traffic["kind"] == "serve":
        serve_readings(cell, seeds, "cuda", args.control, args.seconds,
                       log=out)
    else:
        readings(cell, seeds, "cuda", args.control, args.fault, log=out)


if __name__ == "__main__":
    main()
