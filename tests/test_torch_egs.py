"""The port's recipe scripts (egs_torch/aishell/run.sh,
egs_torch/synth_eval/run.sh and summarize.py), checked without running
them: the shell parses, every `python -m tpu_asr_torch.<cli>` names a
CLI of the port, and that CLI's parse_args takes every flag the script
passes it, by its exact name. chip_smoke.py phase 16 runs the aishell
recipe end to end on the card."""

import argparse
import importlib
import json
import os
import re
import shlex
import subprocess

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPTS = [os.path.join("egs_torch", "aishell", "run.sh"),
           os.path.join("egs_torch", "synth_eval", "run.sh")]

# what each array expansion may hold, and a value of each variable
ARRAYS = {"train_extra": "--device cpu --epochs 3",
          "recog_extra": "--device cpu", "cmvn_extra": "--device cpu",
          "DFLAG": "--device cpu",
          "lmargs": "--lm-ckpt lm --lm-weight 0.1 --length-penalty 0.5"}
VALUES = {"decode_mode": "attn_rescore", "mode": "joint", "m": "beam",
          "preset": "hybrid_dev"}
NUMBERS = {"EPOCHS", "NTRAIN", "NCV", "NDEV", "VOCAB", "NOISE", "LRK",
           "seed", "n", "b", "beam", "nj_decode_beam", "lmw", "lp"}


def invocations(path: str) -> list[tuple[str, list[str]]]:
    """(cli, argv) of every `-m tpu_asr_torch.<cli> ...` in the script,
    continuation lines joined, up to the end of the command; shell
    expansions replaced by what they may hold."""
    text = open(os.path.join(REPO, path)).read().replace("\\\n", " ")
    text = re.sub(r'\$\{(\w+)\[@\]\+"\$\{\1\[@\]\}"\}',
                  lambda m: ARRAYS[m.group(1)], text)
    text = text.replace('"$@"', "--minlenratio 0.05")

    def value(m):
        name = m.group(1) or m.group(2)
        return "1" if name in NUMBERS else VALUES.get(name, "x")
    out = []
    for m in re.finditer(r"-m tpu_asr_torch\.(\w+)([^|\n)]*)", text):
        args = re.sub(r"\$\{(\w+)\}|\$(\w+)", value, m.group(2))
        out.append((m.group(1), shlex.split(args)))
    return out


@pytest.mark.parametrize("script", SCRIPTS)
def test_scripts_parse(script):
    done = subprocess.run(["bash", "-n", os.path.join(REPO, script)],
                          capture_output=True, text=True, timeout=60)
    assert done.returncode == 0, done.stderr


@pytest.mark.parametrize("script", SCRIPTS)
def test_every_cli_takes_its_flags(script, monkeypatch):
    calls = invocations(script)
    clis = {cli for cli, _ in calls}
    want = ({"prepare_data", "compute_cmvn", "train", "recognize"}
            if "aishell" in script else
            {"prepare_data", "train", "train_lm", "recognize"})
    assert clis == want
    parsers = []
    real = argparse.ArgumentParser.parse_args

    def keep(self, args=None, namespace=None):
        parsers.append(self)
        return real(self, args, namespace)
    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", keep)
    for cli, argv in calls:
        module = importlib.import_module(
            f"tpu_asr_torch.{cli}" + (".__main__" if cli == "train" else ""))
        parsers.clear()
        module.parse_args(argv)              # SystemExit on a bad flag
        options = parsers[-1]._option_string_actions
        flags = [a for a in argv if a.startswith("--")]
        assert flags and all(f in options for f in flags), (cli, flags)


def test_defaults_write_apart_from_the_jax_package():
    aishell = open(os.path.join(REPO, SCRIPTS[0])).read()
    synth = open(os.path.join(REPO, SCRIPTS[1])).read()
    assert 'exp="exp/aishell_torch_${preset}"' in aishell
    assert "EXP=${EXP:-exp/synth_eval_torch}" in synth


def test_summarize_renders_a_table(tmp_path):
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "summarize", os.path.join(REPO, "egs_torch", "synth_eval",
                                  "summarize.py"))
    summarize = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(summarize)
    rows = [
        {"n_utts": 200, "inverse_rtf": 100.0, "wall_s": 1.0,
         "mode": "greedy_ctc", "cer": 0.02, "beam": 1, "lm_weight": 0.0,
         "length_penalty": 0.0},
        {"n_utts": 200, "inverse_rtf": 50.0, "wall_s": 2.0,
         "mode": "ctc_beam", "cer": 0.01, "beam": 10, "lm_weight": 0.1,
         "length_penalty": 0.0},
        {"n_utts": 100, "inverse_rtf": 80.0, "wall_s": 1.0, "mode": "joint",
         "cer": 0.0, "split": "train_overfit"}]
    ours, theirs = tmp_path / "ours.jsonl", tmp_path / "theirs.jsonl"
    ours.write_text("".join(json.dumps(r) + "\n" for r in rows))
    theirs.write_text(json.dumps(dict(rows[1], cer=0.006)) + "\n")
    text = summarize.main([str(ours), "--beside", str(theirs)])
    lines = text.splitlines()
    assert lines[0] == "| decode | CER | inverse-RTF | n | beside: CER |"
    assert lines[2] == "| ctc_beam b10 +lm0.1 | 0.01 | 50.0x | 200 | 0.006 |"
    assert lines[3] == "| greedy_ctc b1 | 0.02 | 100.0x | 200 | — |"
    assert "| joint | 0.0 | 80.0x |" in lines
    assert lines[-1] == "best dev mode: ctc_beam b10 +lm0.1 (CER 0.01, 50.0x)"
    assert summarize.main([str(ours)]).splitlines()[0] == \
        "| decode | CER | inverse-RTF | n |"
