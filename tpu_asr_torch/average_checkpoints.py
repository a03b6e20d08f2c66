"""Average the weights of the last N (or the listed) checkpoints (port
of bin/average_checkpoints.py): the recipe's step before decoding.

  python -m tpu_asr_torch.average_checkpoints --ckpt exp/aishell \\
      --out exp/aishell_avg --last 5
  python -m tpu_asr_torch.recognize --ckpt exp/aishell_avg \\
      --manifest test.jsonl

Works on the port's own checkpoint folders (train/checkpoints.py). Each
floating-point weight of the model is summed in float32 over the steps,
divided by their number and cast back to its dtype; every other entry
(integer buffers, the optimizer state, the step, the generators) is the
newest step's. The output is a checkpoint folder that recognize, serve
and align read unchanged: model_config.json, one ckpt_<step>.pt (the
newest step's number, its meta with averaged_steps and is_best) and
best.json {"step", "averaged_steps"}. Unlike the reference, which copies
only model_config.json, frontend.json is copied too, so an averaged
--pitch or --cmvn global checkpoint decodes with its own frontend.
The sums run on the CUDA card unless given --device cpu (float32 adds
and an IEEE division, so either device gives the same bits); with no
card and no such flag it raises.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import torch


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        prog="python -m tpu_asr_torch.average_checkpoints",
        description=__doc__.split("\n\n")[0])
    p.add_argument("--ckpt", required=True, help="source checkpoint folder")
    p.add_argument("--out", required=True, help="output checkpoint folder")
    p.add_argument("--last", type=int, default=5,
                   help="average the newest N saved steps (default 5)")
    p.add_argument("--steps", default="",
                   help="comma-separated explicit steps (overrides --last)")
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    return p.parse_args(argv)


def average_state(states: list[dict]) -> dict:
    """The element-wise mean of model state_dicts: floating-point tensors
    summed in float32 in order, divided by their number, cast back; other
    entries from the last state. The divisor is a tensor: CUDA divides by
    a Python number as a product with its reciprocal, which can round
    one ulp away from the quotient."""
    out = {}
    for key, last in states[-1].items():
        if last.is_floating_point():
            acc = sum(s[key].float() for s in states)
            n = torch.full_like(acc, float(len(states)))
            out[key] = (acc / n).to(last.dtype)
        else:
            out[key] = last
    return out


def main(argv=None) -> list[int]:
    """-> the averaged steps."""
    args = parse_args(argv)
    from tpu_asr_torch.train.checkpoints import Checkpointer
    from tpu_asr_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    src = Checkpointer(args.ckpt)
    all_steps = src.all_steps()
    if not all_steps:
        sys.exit(f"no checkpoints in {args.ckpt}")
    if args.steps:
        steps = sorted(int(s) for s in args.steps.split(","))
        missing = [s for s in steps if s not in all_steps]
        if missing:
            sys.exit(f"steps {missing} not in {args.ckpt} "
                     f"(available: {all_steps})")
    else:
        steps = all_steps[-args.last:]
    print(f"averaging steps {steps} of {all_steps}", file=sys.stderr)

    newest = src.restore(steps[-1])      # optimizer, step, generators
    avg = average_state([src.restore(s, map_location=device)["model"]
                         for s in steps])
    newest["model"] = {k: v.cpu() for k, v in avg.items()}
    newest["meta"] = {**newest["meta"], "averaged_steps": steps,
                      "is_best": True}
    dst = Checkpointer(args.out)
    dst.save_config(src.load_config())
    frontend = src.load_frontend()
    if frontend is not None:
        dst.save_frontend(frontend)
    out_step = int(steps[-1])
    dst.write(out_step, newest)
    with open(os.path.join(dst.directory, "best.json"), "w") as f:
        json.dump({"step": out_step, "averaged_steps": steps}, f)
    print(f"wrote averaged checkpoint (step {out_step}, n={len(steps)}) "
          f"-> {args.out}", file=sys.stderr)
    return steps


if __name__ == "__main__":
    main()
