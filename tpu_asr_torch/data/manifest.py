"""Dataset manifests (copy of tpu_asr/data/manifest.py).

Native format: JSONL, one utterance per line:
    {"id": ..., "text": ..., "tokens": [ids...],
     "wav": path-or-null, "feat": path-or-null (npy [T,80] or kaldi ark
     offset spec "file.ark:123"), "num_frames": T, "num_samples": S}

Also reads the reference's espnet-style `data.json` (utts -> {input:
[{feat, shape}], output: [{tokenid, shape}]}), for python -m
tpu_asr_torch.prepare_data --espnet-json.
"""

from __future__ import annotations

import dataclasses
import json


@dataclasses.dataclass
class Utterance:
    id: str
    tokens: list[int]
    text: str = ""
    wav: str | None = None
    feat: str | None = None
    num_frames: int = 0      # feature frames (pre-subsampling)
    num_samples: int = 0     # raw waveform samples (wav mode)

    @property
    def num_tokens(self) -> int:
        return len(self.tokens)


def load_manifest(path: str) -> list[Utterance]:
    utts = []
    with open(path, encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            d = json.loads(line)
            utts.append(Utterance(
                id=d["id"], tokens=list(d["tokens"]), text=d.get("text", ""),
                wav=d.get("wav"), feat=d.get("feat"),
                num_frames=int(d.get("num_frames", 0)),
                num_samples=int(d.get("num_samples", 0))))
    return utts


def save_manifest(utts: list[Utterance], path: str) -> None:
    with open(path, "w", encoding="utf-8") as f:
        for u in utts:
            f.write(json.dumps(dataclasses.asdict(u)) + "\n")


def load_espnet_json(path: str) -> list[Utterance]:
    """Read an espnet-style data.json (the reference's manifest format)."""
    with open(path, encoding="utf-8") as f:
        data = json.load(f)
    utts = []
    for uid, d in data["utts"].items():
        inp = d["input"][0]
        out = d["output"][0]
        tokens = [int(x) for x in str(out["tokenid"]).split()]
        utts.append(Utterance(
            id=uid, tokens=tokens, text=out.get("text", ""),
            feat=inp.get("feat"), num_frames=int(inp["shape"][0])))
    return utts
