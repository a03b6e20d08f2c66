"""Export a checkpoint of the port to the original PyTorch repo's
`.pth.tar` (port of bin/export_torch.py).

The inverse of `python -m tpu_asr_torch.recognize --torch-ckpt`: writes
the reference's `Transformer.serialize` layout (hyperparameters and the
kaituoxu/eastonYi-lineage state_dict names), so weights trained here
load into a reference-style PyTorch stack. Transformer, ctc and hybrid
models with the transformer encoder:

  python -m tpu_asr_torch.export_torch --ckpt exp/aishell \\
      --out exp/aishell/final.pth.tar --restore best

Reads the port's checkpoint folder (train/checkpoints.py) on the host:
the weights are copied and renamed, nothing is computed, so no card is
needed.
"""

from __future__ import annotations

import argparse
import sys


def parse_args(argv=None):
    p = argparse.ArgumentParser(prog="python -m tpu_asr_torch.export_torch",
                                description=__doc__.split("\n\n")[0])
    p.add_argument("--ckpt", required=True,
                   help="checkpoint folder of python -m tpu_asr_torch.train")
    p.add_argument("--out", required=True, help="output .pth.tar path")
    p.add_argument("--restore", default="best", choices=["best", "latest"])
    return p.parse_args(argv)


def main(argv=None) -> int:
    """-> the exported step."""
    args = parse_args(argv)
    from tpu_asr_torch.models import build_model
    from tpu_asr_torch.parity.torch_export import export_model
    from tpu_asr_torch.recognize import restore_step
    from tpu_asr_torch.train.checkpoints import Checkpointer

    ck = Checkpointer(args.ckpt)
    cfg = ck.load_config()
    step = restore_step(ck, -1, args.restore)
    state = ck.restore(step)
    model = build_model(cfg)
    model.load_state_dict(state["model"])
    meta = state.get("meta", {})
    export_model(args.out, model, cfg, epoch=int(meta.get("epoch", 0)),
                 cv_loss=float(meta.get("cv_loss", 0.0)))
    print(f"wrote {args.out} (step {step}, model_type={cfg.model_type})",
          file=sys.stderr)
    return step


if __name__ == "__main__":
    main()
