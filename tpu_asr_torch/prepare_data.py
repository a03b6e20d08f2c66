"""Data preparation CLI of the PyTorch port (port of bin/prepare_data.py):
Kaldi/espnet-style inputs -> manifests (JSONL) and a char dict.

  python -m tpu_asr_torch.prepare_data --wav-scp wav.scp --text text \\
      --dict-out dict.txt --out train.jsonl
  python -m tpu_asr_torch.prepare_data --espnet-json data.json \\
      --out train.jsonl
  python -m tpu_asr_torch.prepare_data --synthetic 40 --vocab-size 64 \\
      --text-dist markov --out data/all.jsonl

Three input modes: an espnet data.json (the reference's manifest
format), a Kaldi wav.scp + text pair (wav mode: the features are made on
the device at training time), or a synthetic tone corpus (its .npy
waves next to the manifest, in wavs/). The char dict (<blank>, <unk>,
chars, <sos>, <eos>) is built from the text and written to --dict-out,
or an existing --dict encodes it. For the same inputs the manifest and
the dict are byte for byte those of bin/prepare_data.py. Needs no
device.
"""

from __future__ import annotations

import argparse


def parse_args(argv=None):
    p = argparse.ArgumentParser(prog="python -m tpu_asr_torch.prepare_data",
                                description=__doc__.split("\n\n")[0])
    p.add_argument("--espnet-json")
    p.add_argument("--wav-scp")
    p.add_argument("--text")
    p.add_argument("--synthetic", type=int, default=0)
    p.add_argument("--vocab-size", type=int, default=64,
                   help="synthetic mode vocab")
    p.add_argument("--seed", type=int, default=0,
                   help="synthetic mode RNG seed (distinct seeds give "
                        "disjoint train/dev corpora)")
    p.add_argument("--noise", type=float, default=0.01,
                   help="synthetic mode additive-noise sigma")
    p.add_argument("--text-dist", default="uniform",
                   choices=["uniform", "markov"],
                   help="synthetic transcript distribution; markov draws "
                        "from a fixed bigram language (seeded apart from "
                        "--seed) so an external LM has structure to learn")
    p.add_argument("--dict", dest="dict_path")
    p.add_argument("--dict-out")
    p.add_argument("--out", required=True, help="manifest path (.jsonl)")
    return p.parse_args(argv)


def read_kaldi_pair(wav_scp: str, text: str, vocab=None):
    """(utterances, vocab) from a Kaldi wav.scp and text: the ids in both,
    in wav.scp's order; the text's spaces dropped (chars); the vocab
    built from the text's chars unless given."""
    from tpu_asr_torch.data.audio import wav_num_samples
    from tpu_asr_torch.data.manifest import Utterance
    from tpu_asr_torch.utils.vocab import Vocab

    texts = {}
    with open(text, encoding="utf-8") as f:
        for line in f:
            parts = line.strip().split(maxsplit=1)
            if len(parts) == 2:
                texts[parts[0]] = parts[1].replace(" ", "")
    if vocab is None:
        chars = set()
        for t in texts.values():
            chars.update(t)
        vocab = Vocab.build(chars)
    utts = []
    with open(wav_scp, encoding="utf-8") as f:
        for line in f:
            parts = line.strip().split(maxsplit=1)
            if len(parts) != 2 or parts[0] not in texts:
                continue
            uid, path = parts
            utts.append(Utterance(
                id=uid, tokens=vocab.encode(texts[uid]), text=texts[uid],
                wav=path, num_samples=wav_num_samples(path)))
    return utts, vocab


def main(argv=None) -> list:
    """-> the utterances written to --out."""
    args = parse_args(argv)
    from tpu_asr_torch.data.manifest import load_espnet_json, save_manifest
    from tpu_asr_torch.utils.vocab import Vocab

    if args.synthetic:
        from tpu_asr_torch.data.synthetic import write_synthetic_manifest
        utts = write_synthetic_manifest(
            args.out, args.synthetic, args.vocab_size, seed=args.seed,
            noise=args.noise, text=args.text_dist)
        print(f"wrote {len(utts)} synthetic utts -> {args.out}")
        return utts
    if args.espnet_json:
        utts = load_espnet_json(args.espnet_json)
        save_manifest(utts, args.out)
        print(f"converted {len(utts)} utts from {args.espnet_json}")
        return utts
    if not (args.wav_scp and args.text):
        raise SystemExit("need --wav-scp and --text (or --espnet-json, or "
                         "--synthetic N)")
    vocab = Vocab.load(args.dict_path) if args.dict_path else None
    utts, built = read_kaldi_pair(args.wav_scp, args.text, vocab)
    if vocab is None and args.dict_out:
        built.save(args.dict_out)
        print(f"wrote dict ({len(built)} tokens) -> {args.dict_out}")
    save_manifest(utts, args.out)
    print(f"wrote {len(utts)} utts -> {args.out}")
    return utts


if __name__ == "__main__":
    main()
