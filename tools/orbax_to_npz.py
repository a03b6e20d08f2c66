#!/usr/bin/env python
"""Convert a tpu_asr (JAX) checkpoint folder to flax params in an .npz,
the JAX side of the bridge into the PyTorch port.

  python tools/orbax_to_npz.py --ckpt exp/aishell --out exp/aishell_npz
  python -m tpu_asr_torch.import_params --src exp/aishell_npz \\
      --out exp/aishell_port

Restores the best (or the latest) step of a folder that bin/train.py or
bin/train_lm.py wrote, through tpu_asr.train.checkpoints.Checkpointer,
and writes to --out:

  params.npz         the params, keyed by their '/'-joined flax paths
                     (what tpu_asr_torch.weights.load_jax_params reads)
  model_config.json  copied, or lm_config.json for an LM folder
  frontend.json      copied when present
  meta.json          {"step", "epoch", "cv_loss", "source"}

The restore takes the tree as saved, with no model built: the params of
every model family, under any optimizer or PRNG setting of the run, come
out alike. This script needs JAX and tpu_asr, so it runs where they are
installed, on the CPU (JAX_PLATFORMS=cpu is forced); it is not part of
the port, which imports neither.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys

os.environ["JAX_PLATFORMS"] = "cpu"
sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))

SIDECARS = ("model_config.json", "lm_config.json", "frontend.json")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--ckpt", required=True,
                   help="tpu_asr checkpoint folder (bin/train.py or "
                        "bin/train_lm.py --save-folder)")
    p.add_argument("--out", required=True, help="output folder")
    p.add_argument("--restore", default="best", choices=["best", "latest"])
    return p.parse_args(argv)


def flatten(tree, prefix="") -> dict:
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, dict):
            out.update(flatten(v, key))
        else:
            out[key] = v
    return out


def main(argv=None) -> dict:
    """-> the meta written to meta.json."""
    args = parse_args(argv)
    import jax
    import numpy as np
    jax.config.update("jax_platforms", "cpu")
    from tpu_asr.train.checkpoints import Checkpointer

    if not any(os.path.exists(os.path.join(args.ckpt, f))
               for f in ("model_config.json", "lm_config.json")):
        sys.exit(f"{args.ckpt} has neither model_config.json nor "
                 f"lm_config.json")
    ck = Checkpointer(args.ckpt)
    step = ck.latest_step() if args.restore == "latest" else ck.best_step()
    if step is None:
        sys.exit(f"no checkpoint in {args.ckpt}")
    state, meta = ck.restore(None, step=step)
    params = flatten(jax.device_get(state["params"]))
    os.makedirs(args.out, exist_ok=True)
    np.savez(os.path.join(args.out, "params.npz"),
             **{k: np.asarray(v) for k, v in params.items()})
    for name in SIDECARS:
        src = os.path.join(args.ckpt, name)
        if os.path.exists(src):
            shutil.copy(src, os.path.join(args.out, name))
    out = {"step": int(step), "epoch": int(meta.get("epoch", 0)),
           "cv_loss": float(meta.get("cv_loss", 0.0)),
           "source": os.path.abspath(args.ckpt)}
    with open(os.path.join(args.out, "meta.json"), "w") as f:
        json.dump(out, f, indent=2)
    print(f"wrote {len(params)} params of step {step} -> {args.out}",
          file=sys.stderr)
    return out


if __name__ == "__main__":
    main()
