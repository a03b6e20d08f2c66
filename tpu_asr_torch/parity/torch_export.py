"""The port's weights out to the original PyTorch repo's `.pth.tar`
(port of tpu_asr/parity/torch_export.py).

`flax_to_reference_state_dict` takes the flax-path tree
(`weights.torch_to_flax` of the port's model, nested) and writes the
reference's state_dict names (encoder.layer_stack.N.slf_attn.w_qs,
pos_ffn, decoder.tgt_word_emb, ctc.ctc_lo, ...);
`export_torch_checkpoint` saves it with the hyperparameter fields of the
reference's `Transformer.serialize`. torch_import reads the file back to
the same tree bit for bit. Transformer, ctc and hybrid models with the
transformer encoder only: the families the reference format covers.
"""

from __future__ import annotations

import numpy as np
import torch

from tpu_asr_torch.models.config import ModelConfig


def _t(x) -> torch.Tensor:
    return torch.tensor(np.asarray(x, dtype=np.float32))


def nest(flat: dict) -> dict:
    """{"a/b/c": x} -> {"a": {"b": {"c": x}}}."""
    tree: dict = {}
    for path, value in flat.items():
        node = tree
        *heads, leaf = path.split("/")
        for head in heads:
            node = node.setdefault(head, {})
        node[leaf] = value
    return tree


def flax_to_reference_state_dict(params: dict, cfg: ModelConfig) -> dict:
    """flax param tree -> reference-named torch state_dict (CPU
    float32)."""
    if cfg.model_type not in ("transformer", "ctc", "hybrid"):
        raise ValueError(f"reference checkpoint format covers "
                         f"transformer/ctc/hybrid (got {cfg.model_type})")
    if cfg.encoder_type != "transformer":
        raise ValueError(f"reference checkpoint format covers the "
                         f"transformer encoder (got {cfg.encoder_type})")
    p = params["params"] if "params" in params else params
    d = cfg.d_model
    sd = {}

    def mha(dst, src):
        for ours, theirs in (("q_proj", "w_qs"), ("k_proj", "w_ks"),
                             ("v_proj", "w_vs"), ("out_proj", "fc")):
            sd[f"{dst}.{theirs}.weight"] = _t(
                src[ours]["kernel"]).reshape(d, d).T
            sd[f"{dst}.{theirs}.bias"] = _t(src[ours]["bias"]).reshape(-1)

    def ffn(dst, src):
        for w in ("w_1", "w_2"):
            sd[f"{dst}.{w}.weight"] = _t(src[w]["kernel"]).T
            sd[f"{dst}.{w}.bias"] = _t(src[w]["bias"])

    def ln(dst, src):
        sd[f"{dst}.weight"] = _t(src["LayerNorm_0"]["scale"])
        sd[f"{dst}.bias"] = _t(src["LayerNorm_0"]["bias"])

    enc = p["encoder"]
    if cfg.input_layer == "conv2d":
        sub = enc["subsample"]
        for i in ("1", "2"):
            sd[f"encoder.subsample.conv{i}.weight"] = _t(
                sub[f"conv{i}"]["kernel"]).permute(3, 2, 0, 1)
            sd[f"encoder.subsample.conv{i}.bias"] = _t(
                sub[f"conv{i}"]["bias"])
        sd["encoder.subsample.out.weight"] = _t(sub["out"]["kernel"]).T
        sd["encoder.subsample.out.bias"] = _t(sub["out"]["bias"])
    else:
        sd["encoder.linear_in.weight"] = _t(enc["linear_in"]["kernel"]).T
        sd["encoder.linear_in.bias"] = _t(enc["linear_in"]["bias"])
        sd["encoder.layer_norm_in.weight"] = _t(enc["norm_in"]["scale"])
        sd["encoder.layer_norm_in.bias"] = _t(enc["norm_in"]["bias"])

    for i in range(cfg.num_enc_layers):
        src = enc[f"layer_{i}"]
        dst = f"encoder.layer_stack.{i}"
        mha(f"{dst}.slf_attn", src["slf_attn"])
        ffn(f"{dst}.pos_ffn", src["ffn"])
        ln(f"{dst}.slf_attn.layer_norm", src["post_attn"])
        ln(f"{dst}.pos_ffn.layer_norm", src["post_ffn"])

    if cfg.model_type in ("transformer", "hybrid"):
        dec = p["decoder"]
        sd["decoder.tgt_word_emb.weight"] = _t(dec["embed"]["embedding"])
        if not cfg.tie_embedding:
            sd["decoder.tgt_word_prj.weight"] = _t(
                dec["out_proj"]["kernel"]).T
        for i in range(cfg.num_dec_layers):
            src = dec[f"layer_{i}"]
            dst = f"decoder.layer_stack.{i}"
            mha(f"{dst}.slf_attn", src["slf_attn"])
            mha(f"{dst}.enc_attn", src["crs_attn"])
            ffn(f"{dst}.pos_ffn", src["ffn"])
            ln(f"{dst}.slf_attn.layer_norm", src["post_slf"])
            ln(f"{dst}.enc_attn.layer_norm", src["post_crs"])
            ln(f"{dst}.pos_ffn.layer_norm", src["post_ffn"])

    if cfg.model_type in ("ctc", "hybrid"):
        ctc = p["ctc_head"]["ctc_proj"]
        sd["ctc.ctc_lo.weight"] = _t(ctc["kernel"]).T
        sd["ctc.ctc_lo.bias"] = _t(ctc["bias"])
    return {k: v.contiguous() for k, v in sd.items()}


def export_torch_checkpoint(path: str, params: dict, cfg: ModelConfig,
                            epoch: int = 0, tr_loss: float = 0.0,
                            cv_loss: float = 0.0) -> None:
    """Write the reference's `serialize` layout: hyperparameters, the
    state_dict and the epoch/loss fields."""
    blob = {
        "state_dict": flax_to_reference_state_dict(params, cfg),
        # the reference Transformer.serialize's hyperparameter fields
        "d_input": cfg.encoder_input_dim,
        "d_model": cfg.d_model,
        "d_inner": cfg.d_inner,
        "n_head": cfg.num_heads,
        "n_layers_enc": cfg.num_enc_layers,
        "n_layers_dec": cfg.num_dec_layers,
        "vocab_size": cfg.vocab_size,
        "tie_embedding": cfg.tie_embedding,
        "model_type": cfg.model_type,
        "epoch": epoch,
        "tr_loss": tr_loss,
        "cv_loss": cv_loss,
    }
    torch.save(blob, path)


def export_model(path: str, model: torch.nn.Module, cfg: ModelConfig,
                 **fields) -> None:
    """export_torch_checkpoint of the port's model itself."""
    from tpu_asr_torch.weights import torch_to_flax
    export_torch_checkpoint(path, nest(torch_to_flax(model)), cfg, **fields)
