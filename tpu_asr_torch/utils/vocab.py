"""Character vocabulary with the reference's special-symbol conventions
(copy of tpu_asr/utils/vocab.py).

Reference: src/utils/utils.py `process_dict` — reads a Kaldi-style dict file
(`token id` per line) and surfaces <unk>/<sos>/<eos> ids; the CTC paths add a
<blank>. We pin the layout: id 0 = <blank>, 1 = <unk>, last two = <sos>,
<eos>, matching the espnet/kaituoxu convention the reference follows.
"""

from __future__ import annotations

import dataclasses
from collections.abc import Iterable, Sequence

BLANK = "<blank>"
UNK = "<unk>"
SOS = "<sos>"
EOS = "<eos>"


@dataclasses.dataclass
class Vocab:
    tokens: list[str]
    _index: dict[str, int] = dataclasses.field(default_factory=dict, repr=False)

    def __post_init__(self):
        if not self._index:
            self._index = {t: i for i, t in enumerate(self.tokens)}

    @classmethod
    def build(cls, symbols: Iterable[str]) -> "Vocab":
        """Build from raw (non-special) symbols, applying the standard layout."""
        uniq = sorted(set(symbols) - {BLANK, UNK, SOS, EOS})
        return cls([BLANK, UNK, *uniq, SOS, EOS])

    @classmethod
    def load(cls, path: str) -> "Vocab":
        """Load a `token id` dict file (Kaldi/espnet style)."""
        pairs = []
        with open(path, encoding="utf-8") as f:
            for line in f:
                parts = line.split()
                if not parts:
                    continue
                tok = parts[0]
                idx = int(parts[1]) if len(parts) > 1 else len(pairs)
                pairs.append((idx, tok))
        pairs.sort()
        return cls([t for _, t in pairs])

    def save(self, path: str) -> None:
        with open(path, "w", encoding="utf-8") as f:
            for i, t in enumerate(self.tokens):
                f.write(f"{t} {i}\n")

    def __len__(self) -> int:
        return len(self.tokens)

    @property
    def blank_id(self) -> int:
        return self._index[BLANK]

    @property
    def unk_id(self) -> int:
        return self._index[UNK]

    @property
    def sos_id(self) -> int:
        return self._index[SOS]

    @property
    def eos_id(self) -> int:
        return self._index[EOS]

    def encode(self, text: Sequence[str]) -> list[int]:
        unk = self.unk_id
        return [self._index.get(ch, unk) for ch in text]

    def decode(self, ids: Iterable[int], strip_special: bool = True) -> list[str]:
        special = {self.blank_id, self.unk_id, self.sos_id, self.eos_id}
        out = []
        for i in ids:
            i = int(i)
            if i < 0 or i >= len(self.tokens):
                continue
            if strip_special and i in special and i != self.unk_id:
                continue
            out.append(self.tokens[i])
        return out
