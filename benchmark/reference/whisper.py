"""Plain reference of Whisper (Radford et al. 2022, arXiv:2212.04356), for
the benchmark's check: openai/whisper's whisper/audio.py
(`log_mel_spectrogram`, `pad_or_trim`, `mel_filters`) and
whisper/model.py (`sinusoids`, `MultiHeadAttention.qkv_attention`,
`ResidualAttentionBlock`, `AudioEncoder`, `TextDecoder`) followed line by
line, in plain PyTorch, float32, with TF32 off: no kernel, cache or
batching trick of the measured program, and nothing imported from it.

Departures from openai's code, each one deliberate:
- parameters are named as the measured program's state_dict names them,
  which is how the harness hands both sides the same weights:
  blocks.{i} -> layers.{i}; attn -> slf_attn, cross_attn -> crs_attn;
  query/key/value/out -> q_proj/k_proj/v_proj/out_proj; cross_attn_ln
  -> crs_ln; mlp.0/mlp.2 -> ffn.w_1/ffn.w_2, mlp_ln -> ffn_ln;
  token_embedding -> embed, positional_embedding -> pe (an [n_ctx, D]
  table as openai's);
- float32 throughout (openai runs fp16 on a card), and every matmul and
  convolution operand passes through `Precision`, so the check's control
  can compute the same in float8;
- openai's scaled_dot_product_attention path is not taken: its
  fallback (q and k each scaled by d_head^-1/4, the -inf causal mask)
  is written out;
- an utterance's cross-attention K/V are projected once (`Decoded`)
  and read by every prefix, which openai's kv_cache hooks also do;
- `log_mel` returns the features with the number of frames that carry
  speech (samples // hop), which the length cap reads (the program's
  beam caps a hypothesis at maxlenratio times the encoder frames that
  carry speech, ceil(frames / 2), while both attend the whole window);
- the search is the program's: an attention beam of fixed width that
  forces `sot_sequence` before the first scored token, keeps an ended
  hypothesis in the beam (continuing with the end token at no cost) and
  ends each at `eot` or at the cap (no end token scored then), not
  openai's BeamSearchDecoder with its patience and length penalty.

There is no dropout in Whisper; `Dropout` is kept for serve.py's
interface and passes x through at p 0.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

NEG = -1e30
LN_EPS = 1e-5          # torch.nn.LayerNorm's default


def _fp8(x: torch.Tensor, dtype, top: float) -> torch.Tensor:
    """x rounded to a float8 format under a per-tensor scale that maps
    its largest magnitude to the format's largest value `top`."""
    scale = x.abs().amax().clamp(min=1e-30) / top
    return (x / scale).to(dtype).float() * scale


class Precision:
    """How matmuls and convolutions are computed: "f32" (in float32), or
    "fp8": every operand rounded to float8 e4m3 under its own scale (the
    lower precision that the check's control computes in)."""

    def __init__(self, kind: str = "f32"):
        if kind not in ("f32", "fp8"):
            raise ValueError(f"unknown precision {kind!r}")
        self.kind = kind

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        """A matmul operand."""
        if self.kind == "f32":
            return x
        return _fp8(x, torch.float8_e4m3fn, 448.0)

    def out(self, y: torch.Tensor) -> torch.Tensor:
        """A matmul's output (kept for the interface: serving computes no
        gradient)."""
        return y


class Dropout:
    """Whisper has no dropout: `p` 0 or training False pass x through."""

    def __init__(self, p: float, dtype: torch.dtype, training: bool):
        if training and p > 0.0:
            raise ValueError("Whisper has no dropout")
        self.p, self.dtype, self.training = p, dtype, training

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return x


# ---- parameters ----

def _dense(name, d_in, d_out, bias=True):
    out = [(f"{name}.weight", (d_out, d_in), "fan_in")]
    return out + ([(f"{name}.bias", (d_out,), "zeros")] if bias else [])


def _norm(name, d):
    return [(f"{name}.weight", (d,), "ones"), (f"{name}.bias", (d,), "zeros")]


def _mha(name, d):
    """query, value and out with a bias, key without (openai)."""
    return (_dense(f"{name}.q_proj", d, d)
            + _dense(f"{name}.k_proj", d, d, bias=False)
            + _dense(f"{name}.v_proj", d, d)
            + _dense(f"{name}.out_proj", d, d))


def _block(name, d, dff, cross):
    spec = _mha(f"{name}.slf_attn", d) + _norm(f"{name}.attn_ln", d)
    if cross:
        spec += _mha(f"{name}.crs_attn", d) + _norm(f"{name}.crs_ln", d)
    spec += _dense(f"{name}.ffn.w_1", d, dff) + \
        _dense(f"{name}.ffn.w_2", dff, d)
    return spec + _norm(f"{name}.ffn_ln", d)


def param_spec(cfg: dict) -> list[tuple[str, tuple, str]]:
    """(name, shape, init) of every parameter, in a fixed order. init is
    "fan_in" (normal, variance 1 / fan_in), "embed" (normal, variance
    1 / d_model: the token embedding and the learned decoder positions),
    "zeros" or "ones"."""
    d, dff, v = cfg["d_model"], cfg["d_inner"], cfg["vocab_size"]
    spec = [("encoder.conv1.weight", (d, cfg["d_input"], 3), "fan_in"),
            ("encoder.conv1.bias", (d,), "zeros"),
            ("encoder.conv2.weight", (d, d, 3), "fan_in"),
            ("encoder.conv2.bias", (d,), "zeros")]
    for i in range(cfg["num_enc_layers"]):
        spec += _block(f"encoder.layers.{i}", d, dff, cross=False)
    spec += _norm("encoder.ln_post", d)
    spec += [("decoder.embed.weight", (v, d), "embed"),
             ("decoder.pe.weight", (cfg["pe_maxlen"], d), "embed")]
    for i in range(cfg["num_dec_layers"]):
        spec += _block(f"decoder.layers.{i}", d, dff, cross=True)
    return spec + _norm("decoder.ln", d)


# ---- the model (whisper/model.py) ----

def sinusoids(length: int, channels: int, max_timescale: float = 10000):
    """Returns sinusoids for positional embedding (openai's, float32)."""
    assert channels % 2 == 0
    log_timescale_increment = np.log(max_timescale) / (channels // 2 - 1)
    inv_timescales = torch.exp(-log_timescale_increment
                               * torch.arange(channels // 2))
    scaled_time = torch.arange(length)[:, np.newaxis] * \
        inv_timescales[np.newaxis, :]
    return torch.cat([torch.sin(scaled_time), torch.cos(scaled_time)], dim=1)


class Model:
    """The forward pass over a parameter dict P (name -> float32 tensor)."""

    def __init__(self, cfg: dict, P: dict, prec: Precision, drop: Dropout):
        self.cfg, self.P, self.q, self.drop = cfg, P, prec, drop
        self.n_head = cfg["num_heads"]

    def linear(self, name, x):
        b = self.P.get(f"{name}.bias")
        return self.q.out(F.linear(self.q(x), self.q(self.P[f"{name}.weight"]),
                                   b))

    def conv1d(self, name, x, stride):
        return self.q.out(F.conv1d(
            self.q(x), self.q(self.P[f"{name}.weight"]),
            self.P[f"{name}.bias"], stride=stride, padding=1))

    def norm(self, name, x):
        return F.layer_norm(x, x.shape[-1:], self.P[f"{name}.weight"],
                            self.P[f"{name}.bias"], LN_EPS)

    def qkv_attention(self, q, k, v, mask=None):
        n_batch, n_ctx, n_state = q.shape
        scale = (n_state // self.n_head) ** -0.25
        q = q.view(*q.shape[:2], self.n_head, -1).permute(0, 2, 1, 3)
        k = k.view(*k.shape[:2], self.n_head, -1).permute(0, 2, 1, 3)
        v = v.view(*v.shape[:2], self.n_head, -1).permute(0, 2, 1, 3)
        qk = self.q.out(self.q(q * scale)
                        @ self.q(k * scale).transpose(-1, -2))
        if mask is not None:
            qk = qk + mask[:n_ctx, :n_ctx]
        w = F.softmax(qk.float(), dim=-1)
        out = self.q.out(self.q(w) @ self.q(v)).permute(0, 2, 1, 3)
        return out.flatten(start_dim=2)

    def kv(self, name, x):
        """An attention's key and value of x (key without a bias)."""
        return self.linear(f"{name}.k_proj", x), \
            self.linear(f"{name}.v_proj", x)

    def attention(self, name, x, kv, mask=None):
        q = self.linear(f"{name}.q_proj", x)
        k, v = kv
        return self.linear(f"{name}.out_proj",
                           self.qkv_attention(q, k, v, mask))

    def block(self, name, x, cross_kv=None, mask=None):
        """ResidualAttentionBlock; cross_kv: the block's cross K/V."""
        h = self.norm(f"{name}.attn_ln", x)
        x = x + self.attention(f"{name}.slf_attn", h,
                               self.kv(f"{name}.slf_attn", h), mask)
        if cross_kv is not None:
            x = x + self.attention(f"{name}.crs_attn",
                                   self.norm(f"{name}.crs_ln", x), cross_kv)
        h = self.norm(f"{name}.ffn_ln", x)
        h = self.linear(f"{name}.ffn.w_2",
                        F.gelu(self.linear(f"{name}.ffn.w_1", h)))
        return x + h

    def encode(self, feats: torch.Tensor) -> torch.Tensor:
        """AudioEncoder: feats [B, n_ctx * 2, n_mels] -> [B, n_ctx, D]."""
        c = self.cfg
        x = feats.permute(0, 2, 1)
        x = F.gelu(self.conv1d("encoder.conv1", x, 1))
        x = F.gelu(self.conv1d("encoder.conv2", x, 2))
        x = x.permute(0, 2, 1)
        pe = sinusoids(c["audio_ctx"], c["d_model"]).to(x.device)
        assert x.shape[1:] == pe.shape, "incorrect audio shape"
        x = x + pe
        for i in range(c["num_enc_layers"]):
            x = self.block(f"encoder.layers.{i}", x)
        return self.norm("encoder.ln_post", x)

    def cross_kv(self, xa: torch.Tensor) -> list:
        """Every decoder block's cross-attention key and value of xa."""
        return [self.kv(f"decoder.layers.{i}.crs_attn", xa)
                for i in range(self.cfg["num_dec_layers"])]

    def decode(self, ys: torch.Tensor, cross: list) -> torch.Tensor:
        """TextDecoder: ys [N, U] token ids against one utterance's cross
        K/V (rows broadcast) -> logits [N, U, V]."""
        c = self.cfg
        u = ys.shape[1]
        emb = self.P["decoder.embed.weight"]
        x = emb[ys] + self.P["decoder.pe.weight"][:u]
        mask = torch.empty(u, u, device=ys.device).fill_(-np.inf).triu_(1)
        for i in range(c["num_dec_layers"]):
            x = self.block(f"decoder.layers.{i}", x, cross[i], mask)
        x = self.norm("decoder.ln", x)
        return self.q.out(self.q(x) @ self.q(emb).T)


# ---- the frontend (whisper/audio.py) ----

def mel_filters(fe: dict, device) -> torch.Tensor:
    """[n_mels, 1 + n_fft // 2]: librosa.filters.mel(sr, n_fft, n_mels,
    fmin, fmax, htk=False, norm="slaney") rewritten in numpy float64
    (Whisper stores its result as mel_filters.npz, not in this
    repository): triangles on the Slaney scale, each scaled to area 1 in
    Hz / 2."""
    sr, n_mels = fe["sample_rate"], fe["num_mel_bins"]
    n_fft = int(sr * fe["frame_length_ms"] / 1000)
    f_sp, min_log_hz = 200.0 / 3, 1000.0
    min_log_mel = (min_log_hz - 0.0) / f_sp
    logstep = np.log(6.4) / 27.0

    def hz_to_mel(f):
        return (min_log_mel + np.log(f / min_log_hz) / logstep
                if f >= min_log_hz else f / f_sp)

    def mel_to_hz(m):
        return np.where(m >= min_log_mel,
                        min_log_hz * np.exp(logstep * (m - min_log_mel)),
                        f_sp * m)

    fftfreqs = np.fft.rfftfreq(n=n_fft, d=1.0 / sr)
    mel_f = mel_to_hz(np.linspace(hz_to_mel(fe["low_freq"]),
                                  hz_to_mel(fe["high_freq"]), n_mels + 2))
    fdiff = np.diff(mel_f)
    ramps = np.subtract.outer(mel_f, fftfreqs)
    weights = np.zeros((n_mels, len(fftfreqs)))
    for i in range(n_mels):
        lower = -ramps[i] / fdiff[i]
        upper = ramps[i + 2] / fdiff[i + 1]
        weights[i] = np.maximum(0, np.minimum(lower, upper))
    weights *= (2.0 / (mel_f[2:n_mels + 2] - mel_f[:n_mels]))[:, np.newaxis]
    return torch.from_numpy(weights.astype(np.float32)).to(device)


def log_mel(wav: torch.Tensor, fe: dict) -> tuple[torch.Tensor, int]:
    """One waveform [S] -> (log-mel [n_frames, n_mels] of its window,
    frames that carry speech): pad_or_trim to the window, then
    log_mel_spectrogram."""
    sr = fe["sample_rate"]
    n_fft = int(sr * fe["frame_length_ms"] / 1000)
    hop = int(sr * fe["frame_shift_ms"] / 1000)
    n_samples = int(round(fe["chunk_s"] * sr))
    audio = wav.float()[:n_samples]
    audio = F.pad(audio, (0, n_samples - audio.shape[-1]))
    window = torch.hann_window(n_fft).to(audio.device)
    stft = torch.stft(audio, n_fft, hop, window=window, return_complex=True)
    magnitudes = stft[..., :-1].abs() ** 2
    mel_spec = mel_filters(fe, audio.device) @ magnitudes
    log_spec = torch.clamp(mel_spec, min=fe["log_floor"]).log10()
    log_spec = torch.maximum(log_spec, log_spec.max() - 8.0)
    log_spec = (log_spec + 4.0) / 4.0
    return log_spec.T, min(int(wav.shape[0]) // hop, n_samples // hop)


# ---- serving: a hypothesis's score, the beam ----

class Decoded:
    """One utterance encoded once, from log_mel's (features, speech
    frames): its cross K/V, the encoder frames that carry speech (`t`,
    conv2's ceil(frames / 2), which the cap reads), and the decoder's
    log-probabilities of any prefixes after the prompt."""

    def __init__(self, model: Model, mel: tuple):
        feats, frames = mel
        self.model = model
        self.enc = model.encode(feats[None])
        self.cross = model.cross_kv(self.enc)
        self.t = (frames + 1) // 2
        self.prompt = list(model.cfg["sot_sequence"])
        self.eos = model.cfg["eot"]

    def att_logp(self, prefixes: list, last: bool = False) -> np.ndarray:
        """[N, P + len, V] log-probabilities after each of prompt +
        prefix (P prompt ids) for N prefixes of one length, or the last
        position's alone [N, V] (float64, host)."""
        ys = torch.tensor([self.prompt + list(p) for p in prefixes],
                          device=self.enc.device)
        logits = self.model.decode(ys, self.cross)
        if last:
            logits = logits[:, -1]
        return torch.log_softmax(logits, dim=-1).double().cpu().numpy()


def maxlen_of(t: int, beam: dict) -> int:
    """The length cap of an utterance of t speech encoder frames."""
    if beam["maxlenratio"] > 0:
        return int(min(max(math.floor(beam["maxlenratio"] * t), 1),
                       beam["max_len"]))
    return beam["max_len"]


def score_hypothesis(dec: Decoded, y: list, beam: dict) -> float:
    """The sum of the log-probabilities of y's tokens after the prompt,
    and of the end token unless the cap ended y."""
    att = dec.att_logp([y])[0]
    at = len(dec.prompt) - 1
    score = sum(att[at + j, tok] for j, tok in enumerate(y))
    if len(y) < maxlen_of(dec.t, beam):
        score += att[at + len(y), dec.eos]
    return float(score)


def _top(x: np.ndarray, k: int) -> np.ndarray:
    """Indices of the k largest, ties to the lower index."""
    return np.argsort(-x, kind="stable")[:k]


def joint_beam(dec: Decoded, beam: dict) -> tuple[list, float]:
    """The attention beam over the whole vocabulary (ctc_weight 0), one
    utterance -> (1-best, score)."""
    w, eos = beam["beam"], dec.eos
    cap = maxlen_of(dec.t, beam)
    hyps = [[] for _ in range(w)]
    scores = np.where(np.arange(w) == 0, 0.0, NEG)
    done = np.zeros(w, bool)
    pos = 0
    while pos < beam["max_len"] and not done.all():
        live = [b for b in range(w) if not done[b] and pos < cap]
        att = dict(zip(live, dec.att_logp([hyps[b] for b in live],
                                          last=True))) if live else {}
        v = len(next(iter(att.values()))) if att else eos + 1
        rows = []
        for b in range(w):
            if b in att:
                rows.append(att[b])
            else:                       # ended: the end token at no cost
                rows.append(np.where(np.arange(v) == eos, 0.0, NEG))
        total = np.concatenate([scores[b] + rows[b] for b in range(w)])
        best = _top(total, w)
        new_h, new_s, new_d = [], [], []
        for i in best:
            b, tok = divmod(int(i), v)
            new_s.append(total[i])
            if b not in att or tok == eos:
                new_h.append(hyps[b])
                new_d.append(True)
            else:
                new_h.append(hyps[b] + [tok])
                new_d.append(False)
        hyps, scores, done = new_h, np.asarray(new_s), np.asarray(new_d)
        pos += 1
    b = int(_top(scores, 1)[0])
    return hyps[b], float(scores[b])
