"""What every cell shares: finding the pieces of a cell by name, the
per-layer readers, the check that no JAX module was loaded, and the
result line.

A cell (an entry of BENCHMARK.json's `workloads`) pairs a configuration
with a traffic mix. Each piece is found by its name alone:

  benchmark/configs/<config>.json    sizes, training and decode settings,
                                     the source, `reduced` and `assumed`,
                                     and the name of its plain reference
  benchmark/reference/<name>.py      that reference
  benchmark/traffic/<traffic>.json   the mix's parameters; its "kind"
                                     names the driver
  benchmark/drivers/<kind>.py        set-up, window, trace and check of
                                     that kind of traffic
  benchmark/limits/<workload>.json   the cell's limits on what `correct`
                                     compares
  benchmark/metrics/<metric>.py      one per-layer metric: read(ctx) ->
                                     a number, or None when the run has
                                     nothing for it to read

so a later change adds a configuration, a mix or a metric by adding
files and entries, and edits none.
"""

from __future__ import annotations

import importlib.util
import json
import math
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = os.path.dirname(os.path.abspath(__file__))
FORBIDDEN = ("jax", "jaxlib", "flax", "tpu_asr")


def load_json(path: str):
    with open(path) as f:
        return json.load(f)


def load_module(path: str, name: str):
    """Import a file of the benchmark by path (metric files have dots in
    their names)."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Cell:
    """One workload of BENCHMARK.json with its pieces loaded by name."""

    def __init__(self, workload: str, root: str = ROOT, here: str = HERE):
        self.root, self.here = root, here
        self.bench = load_json(os.path.join(root, "BENCHMARK.json"))
        cells = {w["name"]: w for w in self.bench["workloads"]}
        if workload not in cells:
            raise KeyError(f"no workload {workload!r}; have {sorted(cells)}")
        self.workload = cells[workload]
        self.name = workload
        self.chips = int(self.workload["chips"])
        configs = {c["name"]: c for c in self.bench["configs"]}
        entry = configs[self.workload["config"]]
        self.config = load_json(os.path.join(root, entry["file"]))
        self.traffic = load_json(os.path.join(
            here, "traffic", self.workload["traffic"] + ".json"))
        self.limits = load_json(os.path.join(here, "limits",
                                             workload + ".json"))

    def module(self, folder: str, name: str):
        return load_module(os.path.join(self.here, folder, name + ".py"),
                           f"benchmark_{folder}_{name.replace('.', '_')}")

    @property
    def reference(self):
        return self.module("reference", self.config["reference"])

    @property
    def driver(self):
        return self.module("drivers", self.traffic["kind"])

    def _reports(self, metric: dict) -> bool:
        listed = metric.get("workloads")
        return self.name in listed if listed is not None else True

    def end_to_end(self) -> list[dict]:
        return [m for m in self.bench["end_to_end"] if self._reports(m)]

    def per_layer(self) -> list[dict]:
        """Per-layer metrics of this cell: those that list it, and those
        without a list whose end-to-end metric the cell reports."""
        mine = {m["name"] for m in self.end_to_end()}
        out = []
        for m in self.bench["per_layer"]:
            listed = m.get("workloads")
            if (self.name in listed if listed is not None
                    else m["moves"] in mine):
                out.append(m)
        return out

    def read_per_layer(self, ctx: dict) -> dict:
        """Each per-layer metric's reader on ctx; a metric whose reader
        finds nothing (None) is left out."""
        out = {}
        for m in self.per_layer():
            value = self.module("metrics", m["name"]).read(ctx)
            if value is not None:
                out[m["name"]] = {"value": float(value), "unit": m["unit"]}
        return out


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name (before the first dot) is one
    of FORBIDDEN, compared whole: tpu_asr_torch is not tpu_asr."""
    return sorted({n for n in list(sys.modules)
                   if n.split(".")[0] in FORBIDDEN})


def device_info(torch, chips: int) -> dict:
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": chips,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(0))}


def finite(x) -> bool:
    return isinstance(x, (int, float)) and math.isfinite(x)


def result_line(correct: bool, attempted: int, failed: int, metrics: dict,
                device: dict, checks: list, breakdown: dict | None = None
                ) -> str:
    """The run's last line: the contract's keys, then the numbers that
    `correct` compared, each beside its limit, under the last key."""
    out = {"correct": bool(correct), "attempted": int(attempted),
           "failed": int(failed), "metrics": metrics, "device": device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checked"] = {name: {"value": value, "limit": limit}
                      for name, value, limit in checks}
    return json.dumps(out)


def judge(checks: list) -> bool:
    """Every number compared is finite and within its limit."""
    return all(finite(v) and v <= limit for _, v, limit in checks)


def print_checks(checks: list, stream=sys.stderr) -> None:
    for name, value, limit in checks:
        ok = finite(value) and value <= limit
        print(f"check {name}: {value!r} (limit {limit!r}) "
              f"{'ok' if ok else 'FAILED'}", file=stream)
    stream.flush()
