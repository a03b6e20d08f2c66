#!/usr/bin/env python
"""Render egs_torch/synth_eval/run.sh's cer_vs_mode.jsonl as a markdown
table.

Usage: python egs_torch/synth_eval/summarize.py \\
           [path/to/cer_vs_mode.jsonl] [--beside other.jsonl]

One row per decode run (stages 3 and 4), sorted by CER and then speed,
and a one-line recommendation of the best dev mode. --beside adds the CER
of the same decode from another table, such as the JAX package's
exp/synth_eval/cer_vs_mode.jsonl, as a column.
"""

from __future__ import annotations

import argparse
import json


def read_rows(path: str) -> list[dict]:
    with open(path) as f:
        return [json.loads(x) for x in f if x.strip()]


def tag(r: dict) -> str:
    t = f"{r['mode']} b{r.get('beam', 1)}"
    if r.get("lm_weight"):
        t += f" +lm{r['lm_weight']}"
    if r.get("length_penalty"):
        t += f" lp{r['length_penalty']}"
    return t


def render(rows: list[dict], beside: list[dict] | None = None) -> str:
    dev = [r for r in rows if r.get("split") != "train_overfit"]
    train = [r for r in rows if r.get("split") == "train_overfit"]
    # the other table's first row of each decode (stage 3 writes a
    # decode once; a table may hold later rows without its fields)
    other: dict = {}
    for r in beside or []:
        if r.get("split") != "train_overfit" and "lm_weight" in r:
            other.setdefault(tag(r), r.get("cer", "—"))
    lines = ["| decode | CER | inverse-RTF | n |"
             + (" beside: CER |" if beside else ""),
             "|---|---|---|---|" + ("---|" if beside else "")]
    for r in sorted(dev, key=lambda r: (r.get("cer", 9), -r["inverse_rtf"])):
        lines.append(f"| {tag(r)} | {r.get('cer', '—')} | "
                     f"{r['inverse_rtf']}x | {r['n_utts']} |"
                     + (f" {other.get(tag(r), '—')} |" if beside else ""))
    if train:
        lines += ["", "train-overfit search sanity (stage 4):",
                  "| decode | CER | inverse-RTF |", "|---|---|---|"]
        lines += [f"| {r['mode']} | {r.get('cer', '—')} | "
                  f"{r['inverse_rtf']}x |" for r in train]
    if dev:
        best = min(dev, key=lambda r: (r.get("cer", 9), -r["inverse_rtf"]))
        lines += ["", f"best dev mode: {tag(best)} (CER {best.get('cer')}, "
                      f"{best['inverse_rtf']}x)"]
    return "\n".join(lines)


def main(argv=None) -> str:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("path", nargs="?",
                   default="exp/synth_eval_torch/cer_vs_mode.jsonl")
    p.add_argument("--beside", default="",
                   help="another cer_vs_mode.jsonl whose CER to add")
    args = p.parse_args(argv)
    text = render(read_rows(args.path),
                  read_rows(args.beside) if args.beside else None)
    print(text)
    return text


if __name__ == "__main__":
    main()
