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

`WhisperConfig` is a ModelConfig of the one model the reference lacks,
openai's Whisper: its own fields are a subclass's, so that ModelConfig
keeps exactly the reference's fields. `sos_id`, `eos_id` and
`prompt_ids` (the ids the decoder is fed after sos before its first
scored step) are properties: the last two of the vocabulary and no
prompt for the reference's models, Whisper's tokenizer ids for Whisper.
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

    @property
    def sos_id(self) -> int:
        return self.vocab_size - 2

    @property
    def eos_id(self) -> int:
        return self.vocab_size - 1

    @property
    def prompt_ids(self) -> tuple:
        return ()

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


@dataclasses.dataclass(frozen=True)
class WhisperConfig(ModelConfig):
    """openai/whisper's ModelDimensions (whisper/model.py) in the port's
    names: d_input n_mels, d_model n_audio_state = n_text_state,
    num_heads n_audio_head = n_text_head, num_enc_layers n_audio_layer,
    num_dec_layers n_text_layer, d_inner 4 n_state, vocab_size n_vocab,
    pe_maxlen n_text_ctx (the decoder's learned positions), audio_ctx
    n_audio_ctx (the encoder's frames over the 30 s window, after the
    stride-2 stem: input_layer "conv1d"). `eot` ends a hypothesis and
    `sot_sequence` starts it (<|startoftranscript|>, language, task,
    <|notimestamps|> of the multilingual tokenizer: the first is the
    sos, the rest are forced before the first scored step). Pre-LN
    blocks with exact-erf GELU MLPs, LayerNorm eps 1e-5, no key bias,
    the output tied to the token embedding unscaled (models/whisper.py).
    Only model_type "transformer" (no CTC head): decoded in mode beam."""
    model_type: str = "transformer"
    input_layer: str = "conv1d"
    dropout: float = 0.0
    audio_ctx: int = 1500
    eot: int = 50257
    sot_sequence: tuple = (50258, 50260, 50360, 50364)

    @property
    def sos_id(self) -> int:
        return self.sot_sequence[0]

    @property
    def eos_id(self) -> int:
        return self.eot

    @property
    def prompt_ids(self) -> tuple:
        return tuple(self.sot_sequence[1:])

    def subsampled_length(self, t):
        """Encoder frames of t mel frames: conv k3 s1 p1, then k3 s2 p1
        (ceil(t / 2))."""
        return (t + 1) // 2
