"""Checkpoints: torch.save of the training state, with the reference's
JSON sidecars (port of tpu_asr/train/checkpoints.py).

A checkpoint directory holds, as the reference's does:
  model_config.json   the ModelConfig (same keys; dtypes by name)
  frontend.json       the FrontendConfig (same keys)
  best.json           {"step", "epoch", "cv_loss", "is_best"} of the best
  ckpt_<step>.pt      one per save: {"model", "optimizer", "step",
                      "generators", "meta"} (the port's own format)

`max_to_keep` newest saves are kept, and the best one is pinned against
cleanup. The reference's orbax folders come over through
tools/orbax_to_npz.py and `python -m tpu_asr_torch.import_params`, which
writes such a folder; its model_config.json names dtypes as numpy does
("float32", "bfloat16"), which model_config_from_json reads as well.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re

import torch

from tpu_asr_torch.frontend import FrontendConfig, WhisperFrontendConfig
from tpu_asr_torch.models.config import ModelConfig, WhisperConfig

_CKPT = re.compile(r"^ckpt_(\d+)\.pt$")


def _dtype_name(dt: torch.dtype) -> str:
    return str(dt).rsplit(".", 1)[-1]          # torch.bfloat16 -> bfloat16


def config_to_json(cfg) -> dict:
    d = dataclasses.asdict(cfg)
    for k, v in d.items():
        if isinstance(v, torch.dtype):
            d[k] = _dtype_name(v)
    return d


def model_config_from_json(d: dict) -> ModelConfig:
    """A ModelConfig, or a WhisperConfig where Whisper's own keys are."""
    d = dict(d)
    d["dtype"] = getattr(torch, d["dtype"])
    d["param_dtype"] = getattr(torch, d["param_dtype"])
    for key in ("conv_channels", "sot_sequence"):
        if isinstance(d.get(key), list):
            d[key] = tuple(d[key])
    return (WhisperConfig if "audio_ctx" in d else ModelConfig)(**d)


def frontend_config_from_json(d: dict
                              ) -> FrontendConfig | WhisperFrontendConfig:
    """A FrontendConfig, or a WhisperFrontendConfig (its key chunk_s)."""
    d = dict(d)
    d["dtype"] = getattr(torch, d["dtype"])
    return (WhisperFrontendConfig if "chunk_s" in d
            else FrontendConfig)(**d)


class Checkpointer:
    def __init__(self, directory: str, max_to_keep: int = 5):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.max_to_keep = max_to_keep

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"ckpt_{step}.pt")

    def _write_json(self, name: str, obj) -> None:
        with open(os.path.join(self.directory, name), "w") as f:
            json.dump(obj, f, indent=2)

    def _read_json(self, name: str):
        path = os.path.join(self.directory, name)
        if not os.path.exists(path):
            return None
        with open(path) as f:
            return json.load(f)

    def save_config(self, cfg: ModelConfig) -> None:
        self._write_json("model_config.json", config_to_json(cfg))

    def load_config(self) -> ModelConfig:
        d = self._read_json("model_config.json")
        if d is None:
            raise FileNotFoundError(f"{self.directory} has no "
                                    f"model_config.json")
        return model_config_from_json(d)

    def save_frontend(self, fcfg: FrontendConfig | WhisperFrontendConfig
                      ) -> None:
        self._write_json("frontend.json", config_to_json(fcfg))

    def load_frontend(self
                      ) -> FrontendConfig | WhisperFrontendConfig | None:
        """FrontendConfig from the sidecar; None if absent."""
        d = self._read_json("frontend.json")
        return None if d is None else frontend_config_from_json(d)

    def all_steps(self) -> list[int]:
        return sorted(int(m.group(1)) for m in map(
            _CKPT.match, os.listdir(self.directory)) if m)

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def _best_json_step(self) -> int | None:
        best = self._read_json("best.json")
        return None if best is None else best["step"]

    def best_step(self) -> int | None:
        """The best-by-cv step; the latest one if best.json names a step
        that is gone (or there is none)."""
        best = self._best_json_step()
        return best if best in self.all_steps() else self.latest_step()

    def save(self, state: dict, step: int, epoch: int = 0,
             cv_loss: float = 0.0, is_best: bool = False) -> None:
        """Write `state` (the trainer's state_dict) as step `step`, then
        drop all but the newest max_to_keep saves and the best."""
        meta = {"epoch": epoch, "cv_loss": float(cv_loss),
                "is_best": bool(is_best)}
        self.write(step, {**state, "meta": meta})
        if is_best:
            self._write_json("best.json", {"step": step, **meta})
        pinned = self._best_json_step()
        steps = self.all_steps()
        for old in steps[:-self.max_to_keep] if self.max_to_keep else []:
            if old != pinned:
                os.remove(self._path(old))

    def write(self, step: int, ckpt: dict) -> None:
        """Write ckpt_<step>.pt (a state with its "meta"), all or
        nothing."""
        tmp = self._path(step) + ".tmp"
        torch.save(ckpt, tmp)
        os.replace(tmp, self._path(step))

    def restore(self, step: int | None = None,
                map_location="cpu") -> dict:
        """The saved state of `step` (default: the latest), with "meta"."""
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.directory}")
        return torch.load(self._path(step), map_location=map_location,
                          weights_only=True)
