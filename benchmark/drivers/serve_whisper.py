"""Serving cells of Whisper: benchmark/drivers/serve.py's closed loop of
clients, window, traced stretch and check, run on a Recognizer whose
model is the configuration's WhisperConfig and whose frontend is built
from the configuration's `frontend` block (Whisper's log-mel of the
30 s window) instead of the default Kaldi fbank. Everything else is
serve.py's: the AsrServer with the mix's buckets, batch size and
batching window, its warm-up, the seeded waveforms, the sample of
answers and `score_gap` against the plain reference
(benchmark/reference/whisper.py).

The readings that the cell's limit is set from, one process for many
seeds (not part of a benchmark run):

  python3 benchmark/drivers/serve_whisper.py \\
      --workload whisper_lv3_serve_beam5_c64 --seeds 11,12 [--control]

prints a JSON line a seed: a short window at the cell's load (--seconds),
the program's `score_gap` and `best_gap` over the sampled answers, the
`score_gap` of the same answers with their first token altered (the
served scores kept, as a program that altered a token would report)
and, with --control, those of the reference computed in float8 in the
program's place.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import threading
import time

import torch

if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))))

from benchmark.drivers import serve  # noqa: E402


def program_config(model: dict):
    """The configuration's `model` block as the port's WhisperConfig."""
    from tpu_asr_torch.models.config import WhisperConfig
    kw = dict(model)
    kw["dtype"] = getattr(torch, kw["dtype"])
    kw["param_dtype"] = getattr(torch, kw["param_dtype"])
    kw["sot_sequence"] = tuple(kw["sot_sequence"])
    return WhisperConfig(**kw)


def frontend_config(block: dict):
    """The configuration's `frontend` block as the port's
    WhisperFrontendConfig."""
    from tpu_asr_torch.frontend import WhisperFrontendConfig
    return WhisperFrontendConfig(**block)


class Program(serve.Program):
    """serve.Program with Whisper's model and frontend."""

    def __init__(self, cell, seed: int, device):
        from tpu_asr_torch.decode.beam import BeamConfig
        from tpu_asr_torch.decode.recognizer import Recognizer
        from tpu_asr_torch.models import build_model
        from tpu_asr_torch.serve import AsrServer
        mix = cell.traffic
        dev = torch.device(device)
        with dev:
            model = build_model(program_config(cell.config["model"]))
        model.load_state_dict(serve.weights_for(cell, seed, dev),
                              strict=True)
        d = mix["decode"]
        beam = BeamConfig(beam=d["beam"], max_len=d["max_len"],
                          ctc_weight=d["ctc_weight"],
                          maxlenratio=d["maxlenratio"])
        self.rec = Recognizer(model.cfg, model, beam=beam, mode=d["mode"],
                              frontend=frontend_config(
                                  cell.config["frontend"]), device=dev)
        s = mix["server"]
        self.server = AsrServer(self.rec, bucket_frames=s["bucket_frames"],
                                batch_size=s["batch_size"],
                                window_ms=s["window_ms"], device=dev)
        self.spans = []
        self.stretch = None
        self.stretch_s = 0.0
        self.traced = threading.Event()
        self._wrap()


def run(cell, seed: int, seconds: float, trace: bool, device, t_start,
        program_cls=Program):
    return serve.run(cell, seed, seconds, trace, device, t_start,
                     program_cls=program_cls)


def altered_first(y: list) -> list:
    """y with its first token changed (2, or 3 where it was 2)."""
    return [3 if y and y[0] == 2 else 2] + list(y[1:])


def readings(cell, seeds, device, control=False, seconds=4.0, log=print):
    """serve.py's check over a short window a seed, with the reference's
    own search (best_gap) and, with control, the float8 reference's
    answers in the program's place."""
    for seed in seeds:
        t0 = time.perf_counter()
        out = run(cell, seed, seconds, False, device, t0)
        requests, picked = out["sample"]
        rows = serve.reference_answers(cell, picked, requests, seed, device,
                                       search=True)
        row = {"seed": seed, "answered": out["attempted"],
               "program": serve.compare(rows), "rows": rows}
        altered = [(i, a, b, [dict(nb[0],
                                   yseq=altered_first(nb[0]["yseq"]))])
                   for i, a, b, nb in picked]
        row["altered"] = serve.compare(serve.reference_answers(
            cell, altered, requests, seed, device))
        if control:
            low = serve.reference_answers(cell, picked, requests, seed,
                                          device, control=True, search=True)
            row["control"] = serve.compare(low)
            row["control_rows"] = low
        row["seconds"] = time.perf_counter() - t0
        log(json.dumps(row))


def main():
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control", action="store_true")
    p.add_argument("--seconds", type=float, default=4.0)
    p.add_argument("--device", default="cuda")
    args = p.parse_args()
    from benchmark import harness
    cell = harness.Cell(args.workload)
    readings(cell, [int(s) for s in args.seeds.split(",")], args.device,
             args.control, args.seconds,
             log=lambda s: print(s, flush=True))


if __name__ == "__main__":
    main()
