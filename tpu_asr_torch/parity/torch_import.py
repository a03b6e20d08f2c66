"""The original PyTorch repo's `.pth.tar` into the port (port of
tpu_asr/parity/torch_import.py).

The reference saves `Transformer.serialize`: a torch.save dict of
hyperparameters (d_model, n_head, n_layers_enc, epoch, optim_dict, ...)
beside a state_dict under the kaituoxu/eastonYi-lineage module names
(`encoder.layer_stack.N.slf_attn.w_qs`, post-norm `layer_norm` inside
each sublayer, `pos_ffn`, `decoder.tgt_word_emb`, `ctc.ctc_lo`).
KEY_ALIASES renames those keys to the twin names the shape map reads;
the shape map builds the flax-path tree of tpu_asr.models.Transformer,
which `weights.load_jax_params` loads into the port's model (strict on
missing or extra keys and on shapes):

  conv kernels   torch [out, in, kh, kw]  -> flax [kh, kw, in, out]
  linear weights torch [out, in]          -> flax [in, out]
  q/k/v proj     torch [d, d]             -> flax [d, H, dh]
  out proj       torch [d, H*dh]          -> flax [H, dh, d]
  layernorm      weight/bias              -> scale/bias

Model types as the reference infers them from the tensors: transformer
(no CTC head), ctc (no decoder), hybrid, and cif when an `assigner` key
is present.

The file is read with `torch.load(..., weights_only=True)`, where the
reference passes weights_only=False: a serialize blob holds only dicts,
lists, tensors, numbers and strings, which the restricted unpickler
reads, and a file that holds any other object is refused with its name
rather than unpickled (unpickling runs code the file names).
"""

from __future__ import annotations

import pickle
import re

import numpy as np
import torch

from tpu_asr_torch.models.config import ModelConfig

# Ordered (regex, replacement) renames: reference-style state_dict key ->
# twin-style key the shape map below reads. Applied top to bottom, every
# rule, by re.sub; idempotent on keys already in twin style. The
# kaituoxu/Speech-Transformer lineage names its modules
# layer_stack/w_qs/w_ks/w_vs/fc/pos_ffn with the post-norm LayerNorm
# INSIDE each sublayer module; the twin names flatten those norms to
# per-layer norm_attn/norm_slf/norm_crs/norm_ffn.
KEY_ALIASES: list[tuple[str, str]] = [
    (r"^module\.", ""),                                  # DataParallel wrap
    (r"^(?:model\.)?encoder\.layer_stack\.(\d+)\.", r"enc_layers.\1."),
    (r"^(?:model\.)?decoder\.layer_stack\.(\d+)\.", r"dec_layers.\1."),
    # post-norm layer norms (inside sublayers in the reference lineage)
    (r"^(enc_layers\.\d+)\.slf_attn\.layer_norm\.", r"\1.norm_attn."),
    (r"^(dec_layers\.\d+)\.slf_attn\.layer_norm\.", r"\1.norm_slf."),
    (r"^(dec_layers\.\d+)\.enc_attn\.layer_norm\.", r"\1.norm_crs."),
    (r"\.pos_ffn\.layer_norm\.", ".norm_ffn."),
    # sublayer + projection names
    (r"\.pos_ffn\.", ".ffn."),
    (r"\.enc_attn\.", ".crs_attn."),
    (r"\.w_qs\.", ".q_proj."),
    (r"\.w_ks\.", ".k_proj."),
    (r"\.w_vs\.", ".v_proj."),
    (r"(_attn\.)fc\.", r"\1out_proj."),
    # decoder embedding / untied projection / encoder input
    (r"^(?:model\.)?decoder\.tgt_word_emb\.", "embed."),
    (r"^(?:model\.)?decoder\.tgt_word_prj\.", "out_proj."),
    (r"^(?:model\.)?encoder\.linear_in\.", "linear_in."),
    (r"^(?:model\.)?encoder\.layer_norm_in\.", "norm_in."),
    # conv2d subsampling front end (eastonYi's addition)
    (r"^(?:model\.)?encoder\.(?:conv\.|subsample\.)?conv[_]?([12])\.",
     r"subsample.conv\1."),
    (r"^(?:model\.)?encoder\.(?:conv\.|subsample\.)(?:out|linear_out)\.",
     "subsample.out."),
    # CTC head (espnet-style ctc.ctc_lo, or a bare linear)
    (r"^ctc\.ctc_lo\.", "ctc_proj."),
    (r"^(?:model\.)?ctc_lo\.", "ctc_proj."),
]


def _np(t) -> np.ndarray:
    return np.asarray(t.detach().cpu().float().numpy()
                      if isinstance(t, torch.Tensor) else t,
                      dtype=np.float32)


def _apply_aliases(sd: dict) -> dict:
    out = {}
    for k, v in sd.items():
        for pat, repl in KEY_ALIASES:
            k = re.sub(pat, repl, k)
        out[k] = v
    return out


def infer_config_overrides(sd: dict) -> dict:
    """The ModelConfig fields an alias-normalized state_dict's tensors pin
    down. The serialize blob stores some hyperparameters but never
    model_type or the conv channels; an attention-only checkpoint read
    with the dataclass defaults would claim a CTC head it does not
    have."""
    out: dict = {}
    n_enc = n_dec = -1
    for k in sd:
        m = re.match(r"enc_layers\.(\d+)\.", k)
        if m:
            n_enc = max(n_enc, int(m.group(1)))
        m = re.match(r"dec_layers\.(\d+)\.", k)
        if m:
            n_dec = max(n_dec, int(m.group(1)))
    if n_enc >= 0:
        out["num_enc_layers"] = n_enc + 1
    out["num_dec_layers"] = n_dec + 1
    has_ctc = "ctc_proj.weight" in sd
    has_dec = n_dec >= 0 or "embed.weight" in sd
    if any("assigner" in k for k in sd):
        out["model_type"] = "cif"
    elif has_ctc:
        out["model_type"] = "hybrid" if has_dec else "ctc"
    else:
        out["model_type"] = "transformer"
    if "subsample.conv1.weight" in sd:
        out["input_layer"] = "conv2d"
        c1 = _np(sd["subsample.conv1.weight"]).shape[0]
        c2 = _np(sd["subsample.conv2.weight"]).shape[0]
        out["conv_channels"] = c1 if c1 == c2 else (c1, c2)
    elif "linear_in.weight" in sd:
        out["input_layer"] = "linear"
    if "embed.weight" in sd:
        v, d = _np(sd["embed.weight"]).shape
        out["vocab_size"], out["d_model"] = int(v), int(d)
    elif has_ctc:
        v, d = _np(sd["ctc_proj.weight"]).shape
        out["vocab_size"], out["d_model"] = int(v), int(d)
    if "enc_layers.0.ffn.w_1.weight" in sd:
        out["d_inner"] = int(_np(sd["enc_layers.0.ffn.w_1.weight"]).shape[0])
    if has_dec:
        out["tie_embedding"] = "out_proj.weight" not in sd
    return out


def torch_state_dict_to_flax(sd: dict, cfg: ModelConfig) -> dict:
    """A reference- or twin-named state_dict -> the flax params tree of
    tpu_asr.models.Transformer (without the {'params': ...} level), as
    numpy float32."""
    sd = _apply_aliases(sd)
    d, h = cfg.d_model, cfg.num_heads
    dh = d // h

    def conv(prefix):
        w = _np(sd[f"{prefix}.weight"])          # [out, in, kh, kw]
        return {"kernel": w.transpose(2, 3, 1, 0),
                "bias": _np(sd[f"{prefix}.bias"])}

    def linear(prefix):
        w = _np(sd[f"{prefix}.weight"])
        b = sd.get(f"{prefix}.bias")
        return {"kernel": w.T,
                "bias": (_np(b) if b is not None
                         else np.zeros(w.shape[0], np.float32))}

    def mha(prefix):
        out = {}
        for name in ("q_proj", "k_proj", "v_proj"):
            w = _np(sd[f"{prefix}.{name}.weight"])       # [d, d]
            out[name] = {"kernel": w.T.reshape(d, h, dh),
                         "bias": _np(sd[f"{prefix}.{name}.bias"])
                         .reshape(h, dh)}
        w = _np(sd[f"{prefix}.out_proj.weight"])          # [d, H*dh]
        out["out_proj"] = {"kernel": w.T.reshape(h, dh, d),
                           "bias": _np(sd[f"{prefix}.out_proj.bias"])}
        return out

    def ffn(prefix):
        return {"w_1": linear(f"{prefix}.w_1"), "w_2": linear(f"{prefix}.w_2")}

    def ln(prefix):
        return {"LayerNorm_0": {"scale": _np(sd[f"{prefix}.weight"]),
                                "bias": _np(sd[f"{prefix}.bias"])}}

    enc: dict = {}
    if cfg.input_layer == "conv2d":
        enc["subsample"] = {"conv1": conv("subsample.conv1"),
                            "conv2": conv("subsample.conv2"),
                            "out": linear("subsample.out")}
    else:
        enc["linear_in"] = linear("linear_in")
        enc["norm_in"] = {"scale": _np(sd["norm_in.weight"]),
                          "bias": _np(sd["norm_in.bias"])}
    for i in range(cfg.num_enc_layers):
        enc[f"layer_{i}"] = {
            "slf_attn": mha(f"enc_layers.{i}.slf_attn"),
            "ffn": ffn(f"enc_layers.{i}.ffn"),
            "post_attn": ln(f"enc_layers.{i}.norm_attn"),
            "post_ffn": ln(f"enc_layers.{i}.norm_ffn"),
        }

    params: dict = {"encoder": enc}
    if cfg.num_dec_layers > 0:
        dec: dict = {"embed": {"embedding": _np(sd["embed.weight"])}}
        for i in range(cfg.num_dec_layers):
            dec[f"layer_{i}"] = {
                "slf_attn": mha(f"dec_layers.{i}.slf_attn"),
                "crs_attn": mha(f"dec_layers.{i}.crs_attn"),
                "ffn": ffn(f"dec_layers.{i}.ffn"),
                "post_slf": ln(f"dec_layers.{i}.norm_slf"),
                "post_crs": ln(f"dec_layers.{i}.norm_crs"),
                "post_ffn": ln(f"dec_layers.{i}.norm_ffn"),
            }
        if not cfg.tie_embedding and "out_proj.weight" in sd:
            # the decoder's output projection has no bias, as the
            # reference's tgt_word_prj
            dec["out_proj"] = {"kernel": _np(sd["out_proj.weight"]).T}
        params["decoder"] = dec
    if cfg.model_type in ("ctc", "hybrid") and "ctc_proj.weight" in sd:
        params["ctc_head"] = {"ctc_proj": linear("ctc_proj")}
    return params


def _read(path: str):
    try:
        return torch.load(path, map_location="cpu", weights_only=True)
    except pickle.UnpicklingError as e:
        raise ValueError(
            f"{path}: holds objects other than dicts, lists, tensors, "
            f"numbers and strings; refused, not unpickled ({e})") from None


def load_torch_checkpoint(path: str, cfg: ModelConfig | None = None):
    """A reference-style `.pth.tar` (or a bare state_dict) -> ({'params':
    flax tree}, the port's ModelConfig). The state_dict is the blob
    itself or its 'state_dict', 'model' or 'model_state_dict' entry.
    Without `cfg` the config is rebuilt from the stored hyperparameters,
    with the fields the tensors pin down (model type, conv channels,
    vocab size, layer counts, tied embedding) inferred from them."""
    blob = _read(path)
    sd = blob
    if isinstance(blob, dict) and not any(
            isinstance(v, torch.Tensor) for v in blob.values()):
        for key in ("state_dict", "model", "model_state_dict"):
            if key in blob:
                sd = blob[key]
                break
    sd = _apply_aliases(dict(sd))
    if cfg is None:
        hyp = blob if isinstance(blob, dict) else {}
        inferred = infer_config_overrides(sd)
        d = ModelConfig()

        def pick(field, *names):
            if field in inferred:
                return inferred[field]
            for name in names:
                if name in hyp:
                    return hyp[name]
            return getattr(d, field)
        cfg = ModelConfig(
            vocab_size=int(pick("vocab_size", "vocab_size")),
            d_model=int(pick("d_model", "d_model")),
            d_inner=int(pick("d_inner", "d_inner")),
            num_heads=int(pick("num_heads", "n_head", "num_heads")),
            num_enc_layers=int(pick("num_enc_layers", "n_layers_enc")),
            num_dec_layers=int(pick("num_dec_layers", "n_layers_dec")),
            model_type=pick("model_type"),
            input_layer=pick("input_layer"),
            conv_channels=pick("conv_channels"),
            tie_embedding=pick("tie_embedding"))
    return {"params": torch_state_dict_to_flax(sd, cfg)}, cfg


def load_torch_model(path: str, cfg: ModelConfig | None = None):
    """The port's model (on the CPU) filled from a reference `.pth.tar`
    -> (model, cfg); see load_torch_checkpoint."""
    from tpu_asr_torch.models import build_model
    from tpu_asr_torch.weights import load_jax_params
    params, cfg = load_torch_checkpoint(path, cfg)
    model = build_model(cfg)
    load_jax_params(model, params)
    return model, cfg
