"""Run one cell of the benchmark once:

  python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> \
      --trace <0|1>

(or `python3 -m benchmark.run ...` from the repository's root). Set-up
(`setup_s`) runs from the start of this script to the opening of the
window. The last line of standard output is the result as one JSON
object; the numbers that `correct` compared are printed beside their
limits as the last lines of standard error and under the result's last
key. Without a CUDA card, with fewer cards than the cell asks for, or
with a JAX module loaded, the run exits non-zero and prints no result.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    from benchmark import harness
    cell = harness.Cell(args.workload)
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device: the benchmark measures the card only",
              file=sys.stderr)
        return 3
    if torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} cards, "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 3
    out = cell.driver.run(cell, seed=args.seed, seconds=args.seconds,
                          trace=bool(args.trace), device="cuda",
                          t_start=T_START)
    found = harness.forbidden_modules()
    if found:
        print(f"modules of JAX or of the JAX package were loaded: {found}",
              file=sys.stderr)
        return 4
    harness.print_checks(out["checks"])
    print(harness.result_line(out["correct"], out["attempted"],
                              out["failed"], out["metrics"],
                              out["device"], out["checks"],
                              out.get("breakdown")), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
