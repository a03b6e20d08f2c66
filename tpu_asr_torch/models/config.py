"""Model hyperparameters (port of tpu_asr/models/config.py).

Same field names and defaults as the JAX ModelConfig, so a config
round-trips between the two packages. `dtype`/`param_dtype` are torch
dtypes.

`use_pallas` is the master switch and the per-op `pallas_*` flags
override it (None = follow the master), resolved as the reference
resolves them. `attention_pallas` and `layernorm_pallas` choose the
*formulation* of attention and of the post-norm LayerNorm: the fused
forms (flash attention, LN(residual + h) with a float32 add) differ from
the plain ones in bf16 and on rows whose keys are all masked. Which
implementation of a formulation runs is still chosen by the device of
the tensors: the CUDA kernel on a card, its plain PyTorch version on the
CPU. `ctc_pallas` and `cif_pallas` are resolved but not read: the CTC
loss and the CIF fire always go through their kernel dispatchers, since
the two forms of each agree (`train --pallas-ctc 0` sets the field and
changes no route).
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    vocab_size: int = 4233            # AISHELL-1 char vocab incl. specials
    d_input: int = 80                 # mel bins (before LFR stacking)
    d_model: int = 512
    d_inner: int = 2048
    num_heads: int = 8
    num_enc_layers: int = 6
    num_dec_layers: int = 6
    dropout: float = 0.1
    pe_maxlen: int = 5000
    input_layer: str = "conv2d"       # conv2d (4x subsample) | linear (LFR)
    encoder_type: str = "transformer"  # transformer | conformer
    conv_kernel: int = 15
    conv_channels: int | tuple = 256  # int, or (conv1, conv2) channels
    lfr_m: int = 4
    lfr_n: int = 3
    tie_embedding: bool = True        # share decoder embedding + output proj
    model_type: str = "hybrid"        # transformer | ctc | hybrid | cif
    ctc_weight: float = 0.3
    cif_quantity_weight: float = 1.0
    cif_tail_threshold: float = 0.5
    label_smoothing: float = 0.1
    enc_chunk_size: int = 0
    enc_left_chunks: int = -1
    num_pred_layers: int = 2
    d_joint: int = 512
    # numerics
    dtype: torch.dtype = torch.float32        # compute dtype
    param_dtype: torch.dtype = torch.float32
    # fused formulations (see module docstring)
    use_pallas: bool = False
    pallas_attention: bool | None = None
    pallas_ctc: bool | None = None
    pallas_cif: bool | None = None
    pallas_layernorm: bool | None = None

    def _resolve(self, flag):
        return self.use_pallas if flag is None else flag

    @property
    def attention_pallas(self) -> bool:
        return self._resolve(self.pallas_attention)

    @property
    def ctc_pallas(self) -> bool:
        return self._resolve(self.pallas_ctc)

    @property
    def cif_pallas(self) -> bool:
        return self._resolve(self.pallas_cif)

    @property
    def layernorm_pallas(self) -> bool:
        return self._resolve(self.pallas_layernorm)

    @property
    def d_head(self) -> int:
        if self.d_model % self.num_heads:
            raise ValueError(f"d_model {self.d_model} is not a multiple of "
                             f"num_heads {self.num_heads}")
        return self.d_model // self.num_heads

    @property
    def encoder_input_dim(self) -> int:
        return (self.d_input * self.lfr_m if self.input_layer == "linear"
                else self.d_input)

    def subsampled_length(self, t):
        """Encoder output length for input length t (frames)."""
        if self.input_layer == "conv2d":
            # two stride-2 convs, kernel 3, no padding (kaldi-style snip)
            t1 = (t - 1) // 2
            return (t1 - 1) // 2
        return (t + self.lfr_n - 1) // self.lfr_n

    # The conv2d front-end's geometry, from its two k=3 s=2 VALID convs
    # (models/conv.py). Streaming (decode/streaming.py) sizes its feature
    # windows from these.

    def _conv2d_only(self):
        if self.input_layer != "conv2d":
            raise ValueError(f"the conv geometry needs input_layer='conv2d',"
                             f" not {self.input_layer!r}")

    @property
    def conv_total_stride(self) -> int:
        """Input frames consumed per encoder output frame step."""
        self._conv2d_only()
        return 2 * 2

    @property
    def conv_receptive_field(self) -> int:
        """Input frames one encoder output frame depends on: k + (k-1)*s
        for the two stacked convs (k=3, s=2)."""
        self._conv2d_only()
        return 3 + (3 - 1) * 2

    def conv_input_window(self, n_out: int) -> int:
        """Input frames that produce n_out encoder frames from an output
        frame boundary: stride * (n_out - 1) + receptive field (4n + 3)."""
        return self.conv_total_stride * (n_out - 1) + self.conv_receptive_field
