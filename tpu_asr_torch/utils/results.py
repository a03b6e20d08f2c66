"""Recognition-result formatting, espnet/reference-compatible (copy of
tpu_asr/utils/results.py).

Reference: src/utils/utils.py `parse_hypothesis` / `add_results_to_json` —
decode results merged back into the espnet-style data.json so the
reference's scoring scripts work unchanged on our output.
"""

from __future__ import annotations

from tpu_asr_torch.utils.vocab import Vocab


def parse_hypothesis(hyp: dict, char_list: list[str]):
    """hyp: {'yseq': [ids...], 'score': float} -> (text, token, tokenid,
    score), mirroring the reference helper (yseq excludes sos/eos)."""
    tokenid = [int(i) for i in hyp["yseq"]]
    token = [char_list[i] for i in tokenid]
    text = "".join(token)
    return text, " ".join(token), " ".join(map(str, tokenid)), hyp["score"]


def add_results_to_json(js_utt: dict, nbest_hyps: list[dict],
                        char_list: list[str]) -> dict:
    """Attach n-best hypotheses to one espnet-format utterance entry.

    js_utt: the utterance dict from data.json (must contain 'output');
    returns a NEW dict with output[0] kept as reference and rec_* fields
    added per hypothesis (reference behavior).
    """
    out = dict(js_utt)
    ref = dict(js_utt.get("output", [{}])[0]) if js_utt.get("output") else {}
    outputs = []
    for n, hyp in enumerate(nbest_hyps, 1):
        text, token, tokenid, score = parse_hypothesis(hyp, char_list)
        entry = dict(ref)
        entry.update({
            "name": f"target1[{n}]",
            "rec_text": text,
            "rec_token": token,
            "rec_tokenid": tokenid,
            "score": float(score),
        })
        outputs.append(entry)
    out["output"] = outputs
    return out


def ids_to_text(ids: list[int], vocab: Vocab) -> str:
    return "".join(vocab.decode(ids))
