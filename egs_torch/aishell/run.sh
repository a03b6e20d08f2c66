#!/usr/bin/env bash
# AISHELL-1 recipe on the PyTorch port (tpu_asr_torch): the stages of
# egs/aishell/run.sh (data prep -> dict -> manifests -> CMVN + train ->
# decode + score -> CER-vs-beam gate), each a `python -m
# tpu_asr_torch.<cli>`. Features are computed on the card inside the
# train and decode steps, as in the reference recipe.
#
# Usage: bash egs_torch/aishell/run.sh --data /path/to/aishell [--stage N]
# Expects the standard AISHELL-1 layout:
#   $data/wav/{train,dev,test}/...S0002/BAC009S0002W0122.wav
#   $data/transcript/aishell_transcript_v0.8.txt
#
# No AISHELL on disk? The whole staged pipeline runs on synthetic
# tone-burst data written in the same layout:
#   bash egs_torch/aishell/run.sh --data /tmp/synth_aishell --synthetic 40 \
#       --preset hybrid_dev --epochs 40 --device cpu
# Every CLI runs on the CUDA card unless given --device cpu. $PYTHON
# names the interpreter (default: python). Lists go to data/aishell/,
# checkpoints and decodes to --exp (default exp/aishell_torch_<preset>,
# apart from the JAX recipe's exp/aishell_<preset> orbax folders).
set -euo pipefail

stage=0
data=""
exp=""   # default exp/aishell_torch_<preset> (set after arg parsing)
preset=aishell
nj_decode_beam=10
synthetic=0
device=""
epochs=0
python="${PYTHON:-python}"
repo_root="$(cd "$(dirname "$0")/../.." && pwd)"

while [[ $# -gt 0 ]]; do
  case "$1" in
    --stage) stage="$2"; shift 2 ;;
    --data) data="$2"; shift 2 ;;
    --exp) exp="$2"; shift 2 ;;
    --preset) preset="$2"; shift 2 ;;
    --synthetic) synthetic="$2"; shift 2 ;;
    --device) device="$2"; shift 2 ;;
    --epochs) epochs="$2"; shift 2 ;;
    *) echo "unknown arg $1"; exit 1 ;;
  esac
done

[[ -n "$exp" ]] || exp="exp/aishell_torch_${preset}"
[[ -n "$data" ]] || { echo "--data /path/to/aishell required"; exit 1; }
cd "$repo_root"
mkdir -p "$exp" data/aishell

if [[ $synthetic -gt 0 && $stage -le 0 ]]; then
  echo "=== stage -1: write synthetic corpus in AISHELL layout -> $data ==="
  "$python" - "$data" "$synthetic" <<'PY'
import os, sys, wave as wavmod
import numpy as np
from tpu_asr_torch.data.synthetic import make_synthetic_dataset
data, n = sys.argv[1], int(sys.argv[2])
vocab = 16
utts, waves = make_synthetic_dataset(n, vocab, seed=0)
n_dev = max(n // 8, 1)
n_test = max(n // 8, 1)
splits = {"train": utts[n_dev + n_test:], "dev": utts[:n_dev],
          "test": utts[n_dev: n_dev + n_test]}
os.makedirs(os.path.join(data, "transcript"), exist_ok=True)
lines = []
for split, us in splits.items():
    d = os.path.join(data, "wav", split, "S0001")
    os.makedirs(d, exist_ok=True)
    for u in us:
        pcm = (np.clip(waves[u.id], -1, 1) * 32767).astype("<i2")
        with wavmod.open(os.path.join(d, u.id + ".wav"), "wb") as w:
            w.setnchannels(1); w.setsampwidth(2); w.setframerate(16000)
            w.writeframes(pcm.tobytes())
        # token id -> letter, one char per token (char-dict pipeline)
        lines.append(u.id + " " + "".join(chr(ord("a") + t) for t in u.tokens))
with open(os.path.join(data, "transcript",
                       "aishell_transcript_v0.8.txt"), "w") as f:
    f.write("\n".join(lines) + "\n")
print("synthetic corpus:", {k: len(v) for k, v in splits.items()})
PY
fi

train_extra=()
recog_extra=()
cmvn_extra=()
[[ -n "$device" ]] && train_extra+=(--device "$device") \
  && recog_extra+=(--device "$device") \
  && cmvn_extra+=(--device "$device")
[[ $epochs -gt 0 ]] && train_extra+=(--epochs "$epochs")

if [[ $stage -le 0 ]]; then
  echo "=== stage 0: build wav.scp/text per split ==="
  "$python" - "$data" <<'PY'
import os, sys
data = sys.argv[1]
trans = {}
with open(os.path.join(data, "transcript", "aishell_transcript_v0.8.txt"),
          encoding="utf-8") as f:
    for line in f:
        parts = line.strip().split(maxsplit=1)
        if len(parts) == 2:
            trans[parts[0]] = parts[1]
os.makedirs("data/aishell", exist_ok=True)
for split in ("train", "dev", "test"):
    wavs, texts = [], []
    root = os.path.join(data, "wav", split)
    for dirpath, _, files in os.walk(root):
        for fn in sorted(files):
            if not fn.endswith(".wav"):
                continue
            uid = fn[:-4]
            if uid not in trans:
                continue
            wavs.append(f"{uid} {os.path.join(dirpath, fn)}")
            texts.append(f"{uid} {trans[uid]}")
    with open(f"data/aishell/{split}.wav.scp", "w") as f:
        f.write("\n".join(wavs) + "\n")
    with open(f"data/aishell/{split}.text", "w") as f:
        f.write("\n".join(texts) + "\n")
    print(split, len(wavs), "utts")
PY
fi

if [[ $stage -le 1 ]]; then
  echo "=== stage 1: char dict + manifests ==="
  "$python" -m tpu_asr_torch.prepare_data \
    --wav-scp data/aishell/train.wav.scp \
    --text data/aishell/train.text --dict-out data/aishell/dict.txt \
    --out data/aishell/train.jsonl
  for split in dev test; do
    "$python" -m tpu_asr_torch.prepare_data \
      --wav-scp data/aishell/$split.wav.scp \
      --text data/aishell/$split.text --dict data/aishell/dict.txt \
      --out data/aishell/$split.jsonl
  done
fi

if [[ $stage -le 2 ]]; then
  echo "=== stage 2: global CMVN stats + train ($preset preset) ==="
  # the reference recipe's compute-cmvn-stats/apply-cmvn: every split is
  # normalized with TRAIN-set statistics (also the causal choice for the
  # streaming presets); decode reads the policy from the checkpoint's
  # frontend.json
  "$python" -m tpu_asr_torch.compute_cmvn \
    --manifest data/aishell/train.jsonl \
    --out "$exp/cmvn.npz" ${cmvn_extra[@]+"${cmvn_extra[@]}"}
  "$python" -m tpu_asr_torch.train --preset "$preset" \
    --train-manifest data/aishell/train.jsonl \
    --cv-manifest data/aishell/dev.jsonl \
    --dict data/aishell/dict.txt \
    --cmvn global --cmvn-stats "$exp/cmvn.npz" \
    --save-folder "$exp" ${train_extra[@]+"${train_extra[@]}"}
fi

# the primary decode mode of each model family, as egs/aishell/run.sh
# chooses it: hybrid presets default to attention rescoring (its choice
# rests on the JAX package's synth_eval table,
# exp/synth_eval/cer_vs_mode.jsonl: attn_rescore 0.0083 against joint's
# 0.0158); transducer presets two-pass rescoring; cif its own decode
case "$preset" in
  transducer*) decode_mode=transducer_rescore ;;
  cif*)        decode_mode=cif_greedy ;;
  ctc*|streaming) decode_mode=ctc_beam ;;
  attention*)  decode_mode=beam ;;
  *)           decode_mode=attn_rescore ;;
esac

if [[ $stage -le 3 ]]; then
  echo "=== stage 3: decode + score ($decode_mode) ==="
  "$python" -m tpu_asr_torch.recognize --ckpt "$exp" \
    --manifest data/aishell/test.jsonl \
    --mode "$decode_mode" --beam "$nj_decode_beam" \
    --output "$exp/test_hyp.jsonl" \
    ${recog_extra[@]+"${recog_extra[@]}"} | tee "$exp/decode_summary.json"
  if [[ "$decode_mode" == attn_rescore ]]; then
    # the reference's one-pass joint CTC/attention beam, kept as a
    # cross-check beside the rescoring default
    "$python" -m tpu_asr_torch.recognize --ckpt "$exp" \
      --manifest data/aishell/test.jsonl \
      --mode joint --beam "$nj_decode_beam" \
      --output "$exp/test_hyp_joint.jsonl" \
      ${recog_extra[@]+"${recog_extra[@]}"} \
      | tee "$exp/decode_summary_joint.json"
  fi
fi

if [[ $stage -le 4 ]]; then
  echo "=== stage 4: CER-vs-beam sanity sweep (decode-quality regression"
  echo "    gate: CER must not blow up as beam widens) ==="
  : > "$exp/cer_vs_beam.jsonl"
  for b in 1 5 10; do
    "$python" -m tpu_asr_torch.recognize --ckpt "$exp" \
      --manifest data/aishell/test.jsonl \
      --mode "$decode_mode" --beam "$b" --output "$exp/test_hyp_beam$b.jsonl" \
      ${recog_extra[@]+"${recog_extra[@]}"} \
      | "$python" -c "import sys,json; s=json.loads(sys.stdin.readlines()[-1]); \
s['beam']=$b; print(json.dumps(s))" >> "$exp/cer_vs_beam.jsonl"
  done
  cat "$exp/cer_vs_beam.jsonl"
  "$python" - "$exp/cer_vs_beam.jsonl" <<'PY'
import json, sys
rows = [json.loads(l) for l in open(sys.argv[1])]
by_beam = {r["beam"]: r["cer"] for r in rows}
assert set(by_beam) == {1, 5, 10}, by_beam
# wider beams must not be dramatically worse than greedy-ish beam=1
assert by_beam[10] <= by_beam[1] + 0.05, by_beam
assert by_beam[5] <= by_beam[1] + 0.05, by_beam
print("cer_vs_beam OK:", by_beam)
PY
fi
