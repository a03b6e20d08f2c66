"""Structured metrics: JSONL file + console pretty-printing (copy of
tpu_asr/train/metrics.py).

Replaces the reference's stdout prints / optional visdom curves (SURVEY.md
section 5): every record carries the BASELINE.json north-star fields
(loss_att, loss_ctc, loss_qty, acc, lr, steps/sec) when available.
"""

from __future__ import annotations

import json
import sys
import time


class MetricsWriter:
    def __init__(self, path: str | None = None, echo: bool = True):
        self.path = path
        self.echo = echo
        self._f = open(path, "a", encoding="utf-8") if path else None
        self._t0 = time.time()

    def write(self, record: dict) -> None:
        record = {"t": round(time.time() - self._t0, 3), **record}
        clean = {k: (round(v, 6) if isinstance(v, float) else v)
                 for k, v in record.items()}
        if self._f:
            self._f.write(json.dumps(clean) + "\n")
            self._f.flush()
        if self.echo:
            parts = [f"{k}={v}" for k, v in clean.items()]
            print("[metrics] " + " ".join(parts), file=sys.stderr)

    def close(self):
        if self._f:
            self._f.close()
