"""Score a hypothesis JSONL against a reference manifest (port of
bin/score.py): corpus CER with its substitution, insertion and deletion
counts, and the worst utterances, as one JSON line.

  python -m tpu_asr_torch.score --manifest test.jsonl --hyp hyp.jsonl
"""

from __future__ import annotations

import argparse
import json


def parse_args(argv=None):
    p = argparse.ArgumentParser(prog="python -m tpu_asr_torch.score",
                                description=__doc__.split("\n\n")[0])
    p.add_argument("--manifest", required=True)
    p.add_argument("--hyp", required=True)
    p.add_argument("--worst", type=int, default=5)
    return p.parse_args(argv)


def main(argv=None) -> dict:
    """-> the JSON object printed."""
    args = parse_args(argv)
    from tpu_asr_torch.data.manifest import load_manifest
    from tpu_asr_torch.utils.cer import batch_edit_distance

    refs = {u.id: u.tokens for u in load_manifest(args.manifest)}
    hyps = {}
    with open(args.hyp, encoding="utf-8") as f:
        for line in f:
            if line.strip():
                d = json.loads(line)
                hyps[d["id"]] = d["hyp_tokens"]
    ids = [i for i in hyps if i in refs]
    r = [refs[i] for i in ids]
    per = batch_edit_distance(r, [hyps[i] for i in ids])
    ref_tokens = sum(len(x) for x in r)
    worst = sorted(((per[j, 0] / max(len(r[j]), 1), ids[j])
                    for j in range(len(ids))), reverse=True)[: args.worst]
    out = {"n_utts": len(ids), "missing_refs": len(hyps) - len(ids),
           "cer": round(int(per[:, 0].sum()) / max(ref_tokens, 1), 4),
           "sub": int(per[:, 1].sum()), "ins": int(per[:, 2].sum()),
           "del": int(per[:, 3].sum()), "ref_tokens": ref_tokens,
           "worst": [{"id": uid, "cer": round(float(c), 3)}
                     for c, uid in worst]}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
