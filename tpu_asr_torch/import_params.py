"""Flax params in an .npz -> a checkpoint folder of the port: the port's
side of the bridge from tpu_asr's orbax checkpoints.

  python tools/orbax_to_npz.py --ckpt exp/aishell --out exp/aishell_npz
  python -m tpu_asr_torch.import_params --src exp/aishell_npz \\
      --out exp/aishell_port
  python -m tpu_asr_torch.recognize --ckpt exp/aishell_port \\
      --manifest test.jsonl

--src holds params.npz (the '/'-joined flax paths) and the sidecars
tools/orbax_to_npz.py copies: model_config.json of an ASR model (any
family, the conformer too; dtypes by numpy name) or lm_config.json of a
train_lm folder, frontend.json when there is one, and meta.json (step,
epoch, cv_loss). The model is built from the config, filled by
`weights.load_jax_params` (strict on missing or extra keys and on
shapes) and moved to the device, then its weights are saved as
ckpt_<step>.pt with the sidecars and best.json, so recognize, serve,
align, stream_demo and --lm-ckpt read the folder as one the port's
trainer wrote. The optimizer state is not carried over: training does
not resume from such a folder. Runs on the CUDA card unless given
--device cpu; with no card and no such flag it raises.
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def parse_args(argv=None):
    p = argparse.ArgumentParser(prog="python -m tpu_asr_torch.import_params",
                                description=__doc__.split("\n\n")[0])
    p.add_argument("--src", required=True,
                   help="folder of params.npz and its sidecars "
                        "(tools/orbax_to_npz.py --out)")
    p.add_argument("--out", required=True, help="output checkpoint folder")
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    return p.parse_args(argv)


def _read_json(folder: str, name: str):
    path = os.path.join(folder, name)
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f)


def main(argv=None) -> int:
    """-> the step written."""
    args = parse_args(argv)
    from tpu_asr_torch.models import build_model
    from tpu_asr_torch.models.lm import (LM_CONFIG_FILE, TransformerLM,
                                         load_lm_config, save_lm_config)
    from tpu_asr_torch.train.checkpoints import (Checkpointer,
                                                 frontend_config_from_json,
                                                 model_config_from_json)
    from tpu_asr_torch.utils.device import resolve_device
    from tpu_asr_torch.weights import load_jax_params

    device = resolve_device(args.device)
    model_json = _read_json(args.src, "model_config.json")
    if model_json is not None:
        cfg = model_config_from_json(model_json)
        model = build_model(cfg)
    elif os.path.exists(os.path.join(args.src, LM_CONFIG_FILE)):
        cfg = load_lm_config(args.src)
        model = TransformerLM(cfg)
    else:
        sys.exit(f"{args.src} has neither model_config.json nor "
                 f"{LM_CONFIG_FILE}")
    load_jax_params(model, os.path.join(args.src, "params.npz"))
    model.to(device)
    meta = _read_json(args.src, "meta.json") or {}
    step = int(meta.get("step", 0))

    ck = Checkpointer(args.out)
    if model_json is not None:
        ck.save_config(cfg)
        frontend = _read_json(args.src, "frontend.json")
        if frontend is not None:
            ck.save_frontend(frontend_config_from_json(frontend))
    else:
        save_lm_config(args.out, cfg)
    state = {k: v.cpu() for k, v in model.state_dict().items()}
    ck.save({"model": state, "step": step}, step,
            epoch=int(meta.get("epoch", 0)),
            cv_loss=float(meta.get("cv_loss", 0.0)), is_best=True)
    print(f"imported {len(state)} tensors of step {step} -> {args.out}",
          file=sys.stderr)
    return step


if __name__ == "__main__":
    main()
