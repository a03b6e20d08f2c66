"""Plain reference of the hybrid CTC/attention Speech-Transformer (Dong et
al. 2018; kaituoxu/Speech-Transformer) and of its conformer encoder
(Gulati et al. 2020, arXiv:2005.08100), for the benchmark's check.

Plain PyTorch, float32, with TF32 off: no kernel, cache or batching
trick of the measured program, and nothing imported from it. It follows
the published layers:

- conv2d subsampling: two 3x3 stride-2 convolutions with ReLU, the
  (frequency, channel) plane flattened channel-fastest into a linear
  layer to d_model;
- transformer encoder: sinusoidal positions added, then post-norm layers
  LN(x + drop(MHA(x))), LN(x + drop(FFN(x))), FFN = w2 drop(relu(w1 x));
- conformer encoder: pre-norm macaron layers x + FFN/2, x + drop(rel-pos
  MHSA), x + conv module (pointwise GLU, depthwise conv, LN, swish,
  pointwise, drop), x + FFN/2, then LN; Transformer-XL relative scores
  (q + u) k^T + shift((q + v) p^T) over a descending sinusoid table;
- decoder: tied embedding scaled by sqrt(d_model) plus positions, post-
  norm layers of causal self-attention, cross-attention and FFN, the
  output projection by the embedding;
- objective: 0.3 CTC (the forward algorithm, each row's NLL over its
  label count, averaged over real rows) + 0.7 label-smoothed CE (eps 0.1
  spread over the other V - 1 classes, over the real target positions);
- Adam (0.9, 0.98, 1e-9) under the Noam schedule, after clipping the
  gradients to a global norm of 5.

LayerNorm takes eps 1e-6. Masked scores take a finite -1e30, so a row
with no valid key (a padding row) stays finite. Parameters are named as
the measured program's state_dict names them, which is how the harness
hands both sides the same weights.

Randomness is replayed, not copied: SpecAugment is drawn here from a
generator seeded as the program's, in the same order, and each dropout
mask is drawn by dropping a tensor of ones of the program's shape and
compute dtype from the device's default generator, in the order the
layers run. The masks so drawn are the program's when both run the
published layer order from the same generator state.

`Precision("fp8")` computes every matmul and convolution on float8
values, forward (operands in e4m3) and backward (the incoming gradient
in e5m2), each tensor under its own scale: the lower precision that the
check's control computes in.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

NEG = -1e30
LN_EPS = 1e-6
IGNORE = -1


def _fp8(x: torch.Tensor, dtype, top: float) -> torch.Tensor:
    """x rounded to a float8 format under a per-tensor scale that maps
    its largest magnitude to the format's largest value `top`."""
    scale = x.abs().amax().clamp(min=1e-30) / top
    return (x / scale).to(dtype).float() * scale


class _Fp8Grad(torch.autograd.Function):
    """Identity forward; the gradient rounded to float8 e5m2 backward."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _fp8(g, torch.float8_e5m2, 57344.0)


class Precision:
    """How matmuls and convolutions (the depthwise one too) are computed:
    "f32" (in float32), or "fp8": every operand rounded to float8 e4m3
    (gradients passed straight through) and the gradient that reaches
    each one's output rounded to e5m2, so the backward's products run on
    float8 values too."""

    def __init__(self, kind: str = "f32"):
        if kind not in ("f32", "fp8"):
            raise ValueError(f"unknown precision {kind!r}")
        self.kind = kind

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        """A matmul operand."""
        if self.kind == "f32":
            return x
        with torch.no_grad():
            xq = _fp8(x, torch.float8_e4m3fn, 448.0)
        return x + (xq - x).detach()

    def out(self, y: torch.Tensor) -> torch.Tensor:
        """A matmul's output (its gradient is a backward matmul's
        operand)."""
        if self.kind == "f32" or not y.requires_grad:
            return y
        return _Fp8Grad.apply(y)


class Dropout:
    """Dropout that draws its mask as the program's layer does (see the
    module docstring); `p` 0 or training False passes x through."""

    def __init__(self, p: float, dtype: torch.dtype, training: bool):
        self.p, self.dtype, self.training = p, dtype, training

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.p <= 0.0:
            return x
        ones = torch.ones(x.shape, dtype=self.dtype, device=x.device)
        keep = F.dropout(ones, self.p, True) != 0
        return torch.where(keep, x / (1.0 - self.p), 0.0)


# ---- parameters ----

def _dense(name, d_in, d_out, bias=True):
    out = [(f"{name}.weight", (d_out, d_in), "fan_in")]
    return out + ([(f"{name}.bias", (d_out,), "zeros")] if bias else [])


def _norm(name, d):
    return [(f"{name}.weight", (d,), "ones"), (f"{name}.bias", (d,), "zeros")]


def _mha(name, d):
    return [s for p in ("q_proj", "k_proj", "v_proj", "out_proj")
            for s in _dense(f"{name}.{p}", d, d)]


def _ffn(name, d, dff):
    return _dense(f"{name}.w_1", d, dff) + _dense(f"{name}.w_2", dff, d)


def param_spec(cfg: dict) -> list[tuple[str, tuple, str]]:
    """(name, shape, init) of every parameter, in a fixed order. init is
    "fan_in" (normal, variance 1 / fan_in), "embed" (normal, variance
    1 / d_model), "zeros" or "ones"."""
    d, dff, v = cfg["d_model"], cfg["d_inner"], cfg["vocab_size"]
    h = cfg["num_heads"]
    c1, c2 = cfg["conv_channels"]
    f2 = ((cfg["d_input"] - 1) // 2 - 1) // 2
    spec = [("encoder.subsample.conv1.weight", (c1, 1, 3, 3), "fan_in"),
            ("encoder.subsample.conv1.bias", (c1,), "zeros"),
            ("encoder.subsample.conv2.weight", (c2, c1, 3, 3), "fan_in"),
            ("encoder.subsample.conv2.bias", (c2,), "zeros")]
    spec += _dense("encoder.subsample.out", f2 * c2, d)
    for i in range(cfg["num_enc_layers"]):
        p = f"encoder.layers.{i}"
        if cfg["encoder_type"] == "conformer":
            k = cfg["conv_kernel"]
            spec += _ffn(f"{p}.ffn1", d, dff) + _ffn(f"{p}.ffn2", d, dff)
            spec += [s for n in ("q_proj", "k_proj", "v_proj")
                     for s in _dense(f"{p}.slf_attn.{n}", d, d)]
            spec += _dense(f"{p}.slf_attn.pos_proj", d, d, bias=False)
            spec += _dense(f"{p}.slf_attn.out_proj", d, d)
            spec += [(f"{p}.slf_attn.u_bias", (h, d // h), "zeros"),
                     (f"{p}.slf_attn.v_bias", (h, d // h), "zeros")]
            spec += _dense(f"{p}.conv.pw1", d, 2 * d)
            spec += [(f"{p}.conv.depthwise.weight", (d, 1, k), "fan_in"),
                     (f"{p}.conv.depthwise.bias", (d,), "zeros")]
            spec += _norm(f"{p}.conv.norm", d) + _dense(f"{p}.conv.pw2", d, d)
            for n in ("norm_ffn1", "norm_attn", "norm_conv", "norm_ffn2",
                      "norm_out"):
                spec += _norm(f"{p}.{n}", d)
        else:
            spec += _mha(f"{p}.slf_attn", d) + _ffn(f"{p}.ffn", d, dff)
            spec += _norm(f"{p}.post_attn.norm", d)
            spec += _norm(f"{p}.post_ffn.norm", d)
    spec.append(("decoder.embed.weight", (v, d), "embed"))
    for i in range(cfg["num_dec_layers"]):
        p = f"decoder.layers.{i}"
        spec += _mha(f"{p}.slf_attn", d) + _mha(f"{p}.crs_attn", d)
        spec += _ffn(f"{p}.ffn", d, dff)
        for n in ("post_slf", "post_crs", "post_ffn"):
            spec += _norm(f"{p}.{n}.norm", d)
    spec += _dense("ctc_head.ctc_proj", d, v)
    return spec


# ---- layers ----

def sinusoid(n_pos: np.ndarray, d: int) -> np.ndarray:
    """Sinusoidal encodings of the positions n_pos (float64 -> float32)."""
    pos = np.asarray(n_pos, np.float64)[:, None]
    dim = np.arange(d, dtype=np.float64)[None, :]
    angle = pos / np.power(10000.0, 2 * (dim // 2) / d)
    return np.where(dim % 2 == 0, np.sin(angle),
                    np.cos(angle)).astype(np.float32)


class Model:
    """The forward pass over a parameter dict P (name -> float32 tensor)."""

    def __init__(self, cfg: dict, P: dict, prec: Precision, drop: Dropout):
        self.cfg, self.P, self.q, self.drop = cfg, P, prec, drop
        self.h = cfg["num_heads"]
        self.dh = cfg["d_model"] // self.h

    def linear(self, name, x, bias=True):
        b = self.P[f"{name}.bias"] if bias else None
        return self.q.out(F.linear(self.q(x), self.q(self.P[f"{name}.weight"]),
                                   b))

    def norm(self, name, x):
        return F.layer_norm(x, x.shape[-1:], self.P[f"{name}.weight"],
                            self.P[f"{name}.bias"], LN_EPS)

    def ffn(self, name, x):
        return self.linear(f"{name}.w_2",
                           self.drop(F.relu(self.linear(f"{name}.w_1", x))))

    def heads(self, x):
        return x.reshape(*x.shape[:-1], self.h, self.dh)

    def attend(self, q, k, v, bias):
        """q [B,Tq,H,dh], k/v [B,Tk,H,dh], bias [B|1,1,Tq|1,Tk]."""
        s = self.q.out(torch.einsum("bqhd,bkhd->bhqk", self.q(q), self.q(k)))
        p = torch.softmax(s / math.sqrt(self.dh) + bias, dim=-1)
        out = self.q.out(torch.einsum("bhqk,bkhd->bqhd", self.q(p),
                                      self.q(v)))
        return out.reshape(*out.shape[:2], -1)

    def mha(self, name, x, kv, bias):
        q = self.heads(self.linear(f"{name}.q_proj", x))
        k = self.heads(self.linear(f"{name}.k_proj", kv))
        v = self.heads(self.linear(f"{name}.v_proj", kv))
        return self.linear(f"{name}.out_proj", self.attend(q, k, v, bias))

    def rel_mha(self, name, x, bias):
        t, d = x.shape[1], self.cfg["d_model"]
        q = self.heads(self.linear(f"{name}.q_proj", x))
        k = self.heads(self.linear(f"{name}.k_proj", x))
        v = self.heads(self.linear(f"{name}.v_proj", x))
        table = torch.from_numpy(sinusoid(np.arange(t - 1, -t, -1), d)).to(
            x.device)                                       # [2T-1, D]
        p = self.heads(self.linear(f"{name}.pos_proj", table, bias=False))
        qu = q + self.P[f"{name}.u_bias"]
        qv = q + self.P[f"{name}.v_bias"]
        content = self.q.out(torch.einsum("bqhd,bkhd->bhqk", self.q(qu),
                                          self.q(k)))
        raw = self.q.out(torch.einsum("bqhd,nhd->bhqn", self.q(qv),
                                      self.q(p)))
        # score of query i and key j: table row (T - 1) - (i - j)
        i = torch.arange(t, device=x.device)
        idx = (t - 1) - (i[:, None] - i[None, :])
        pos = raw.gather(3, idx.expand(raw.shape[0], self.h, t, t))
        probs = torch.softmax((content + pos) / math.sqrt(self.dh) + bias,
                              dim=-1)
        out = self.q.out(torch.einsum("bhqk,bkhd->bqhd", self.q(probs),
                                      self.q(v)))
        return self.linear(f"{name}.out_proj", out.reshape(*out.shape[:2], -1))

    def conv_module(self, name, x, valid):
        pad = ~valid[..., None]
        a, g = self.linear(f"{name}.pw1", x.masked_fill(pad, 0.0)).chunk(
            2, dim=-1)
        h = (a * torch.sigmoid(g)).masked_fill(pad, 0.0)
        k = self.cfg["conv_kernel"]
        h = F.pad(h, (0, 0, (k - 1) // 2, k // 2))
        h = self.q(h)
        w = self.q(self.P[f"{name}.depthwise.weight"][:, 0])  # [C, k]
        t = x.shape[1]
        out = self.q.out(sum(h[:, i:i + t] * w[:, i] for i in range(k)))
        h = self.norm(f"{name}.norm", out + self.P[f"{name}.depthwise.bias"])
        return self.drop(self.linear(f"{name}.pw2", h * torch.sigmoid(h)))

    def encode(self, feats, flens):
        """feats [B, T, D_in], flens [B] -> (enc [B, T', D], lens [B])."""
        c = self.cfg
        x = feats[:, None]
        for n in ("conv1", "conv2"):
            w = self.P[f"encoder.subsample.{n}.weight"]
            x = F.relu(self.q.out(F.conv2d(
                self.q(x), self.q(w), self.P[f"encoder.subsample.{n}.bias"],
                stride=2)))
        b, ch, t, f = x.shape
        x = self.linear("encoder.subsample.out",
                        x.permute(0, 2, 3, 1).reshape(b, t, f * ch))
        lens = (((flens - 1) // 2 - 1) // 2).clamp(min=0)
        valid = torch.arange(t, device=x.device)[None, :] < lens[:, None]
        bias = torch.where(valid, 0.0, NEG)[:, None, None, :]
        if c["encoder_type"] == "conformer":
            x = self.drop(x)
            for i in range(c["num_enc_layers"]):
                p = f"encoder.layers.{i}"
                x = x + 0.5 * self.ffn(f"{p}.ffn1", self.norm(
                    f"{p}.norm_ffn1", x))
                x = x + self.drop(self.rel_mha(
                    f"{p}.slf_attn", self.norm(f"{p}.norm_attn", x), bias))
                x = x + self.conv_module(
                    f"{p}.conv", self.norm(f"{p}.norm_conv", x), valid)
                x = x + 0.5 * self.ffn(f"{p}.ffn2", self.norm(
                    f"{p}.norm_ffn2", x))
                x = self.norm(f"{p}.norm_out", x)
        else:
            pe = torch.from_numpy(sinusoid(np.arange(t), c["d_model"]))
            x = self.drop(x + pe.to(x.device))
            for i in range(c["num_enc_layers"]):
                p = f"encoder.layers.{i}"
                a = self.mha(f"{p}.slf_attn", x, x, bias)
                x = self.norm(f"{p}.post_attn.norm", x + self.drop(a))
                f_ = self.ffn(f"{p}.ffn", x)
                x = self.norm(f"{p}.post_ffn.norm", x + self.drop(f_))
        return x.masked_fill(~valid[..., None], 0.0), lens

    def ctc_logits(self, enc):
        return self.linear("ctc_head.ctc_proj", enc)

    def decode(self, enc, enc_lens, ys_in):
        """Teacher-forced decoder: ys_in [B, U] -> logits [B, U, V]."""
        c = self.cfg
        u, t = ys_in.shape[1], enc.shape[1]
        emb = self.P["decoder.embed.weight"]
        pe = torch.from_numpy(sinusoid(np.arange(u), c["d_model"]))
        y = self.drop(emb[ys_in] * math.sqrt(c["d_model"])
                      + pe.to(enc.device))
        causal = torch.ones((u, u), dtype=torch.bool,
                            device=enc.device).tril()
        self_bias = torch.where(causal, 0.0, NEG)[None, None]
        valid = torch.arange(t, device=enc.device)[None, :] < enc_lens[:, None]
        cross_bias = torch.where(valid, 0.0, NEG)[:, None, None, :]
        for i in range(c["num_dec_layers"]):
            p = f"decoder.layers.{i}"
            a = self.mha(f"{p}.slf_attn", y, y, self_bias)
            y = self.norm(f"{p}.post_slf.norm", y + self.drop(a))
            a = self.mha(f"{p}.crs_attn", y, enc, cross_bias)
            y = self.norm(f"{p}.post_crs.norm", y + self.drop(a))
            f_ = self.ffn(f"{p}.ffn", y)
            y = self.norm(f"{p}.post_ffn.norm", y + self.drop(f_))
        return self.q.out(torch.einsum("bud,vd->buv", self.q(y), self.q(emb)))


# ---- losses ----

def ctc_nll(logits, targets, in_lens, tgt_lens, blank: int = 0):
    """-log P(targets | logits) of each row by the CTC forward algorithm
    in log space. logits [B, T, V]; targets [B, U] (pads any id);
    in_lens, tgt_lens [B]. Rows of length 0 give a finite number."""
    logp = torch.log_softmax(logits, dim=-1)
    b, t, _ = logp.shape
    u = targets.shape[1]
    s = 2 * u + 1
    ext = torch.full((b, s), blank, dtype=torch.long, device=logp.device)
    ext[:, 1::2] = targets
    emit = logp.gather(2, ext[:, None, :].expand(b, t, s))      # [B, T, S]
    prev2 = torch.cat([torch.full_like(ext[:, :2], blank), ext[:, :-2]], 1)
    skip = (ext != blank) & (ext != prev2)
    skip[:, :2] = False
    neg = torch.full((b, 1), NEG, device=logp.device)
    pos = torch.arange(s, device=logp.device)[None, :]
    alpha = torch.where(pos < 2, emit[:, 0], NEG)
    for i in range(1, t):
        a1 = torch.cat([neg, alpha[:, :-1]], 1)
        a2 = torch.where(skip, torch.cat([neg, neg, alpha[:, :-2]], 1), NEG)
        nxt = torch.logsumexp(torch.stack([alpha, a1, a2]), 0) + emit[:, i]
        alpha = torch.where((i < in_lens)[:, None], nxt, alpha)
    end = (2 * tgt_lens).clamp(max=s - 1)[:, None]
    last = torch.cat([alpha.gather(1, end),
                      torch.where(tgt_lens[:, None] > 0,
                                  alpha.gather(1, (end - 1).clamp(min=0)),
                                  NEG)], 1)
    return -torch.logsumexp(last, dim=1)


def objective(model: Model, feats, flens, targets, tlens) -> dict:
    """The hybrid loss of a padded batch; targets [B, U] IGNORE-padded;
    rows with flens 0 carry no loss."""
    c = model.cfg
    v = c["vocab_size"]
    sos, eos = v - 2, v - 1
    enc, elens = model.encode(feats, flens)
    row_valid = flens > 0
    b, u = targets.shape
    safe = torch.where(targets == IGNORE, eos, targets)
    ys_in = torch.cat([torch.full((b, 1), sos, device=targets.device),
                       safe], 1)
    pos = torch.arange(u + 1, device=targets.device)[None, :]
    base = torch.cat([targets, torch.full((b, 1), IGNORE,
                                          device=targets.device)], 1)
    ys_out = torch.where(pos == tlens[:, None], eos, base)
    ys_out = torch.where(row_valid[:, None], ys_out, IGNORE)
    logp = torch.log_softmax(model.decode(enc, elens, ys_in), dim=-1)
    valid = ys_out != IGNORE
    tgt = logp.gather(2, torch.where(valid, ys_out, 0)[..., None])[..., 0]
    eps = c["label_smoothing"]
    off = eps / (v - 1)
    ce = -((1.0 - eps - off) * tgt + off * logp.sum(-1))
    loss_att = torch.where(valid, ce, 0.0).sum() / valid.sum().clamp(min=1)
    nll = ctc_nll(model.ctc_logits(enc),
                  torch.where(targets == IGNORE, 0, targets), elens, tlens)
    per_row = nll / tlens.clamp(min=1)
    loss_ctc = torch.where(row_valid, per_row, 0.0).sum() / \
        row_valid.sum().clamp(min=1)
    w = c["ctc_weight"]
    return {"loss": w * loss_ctc + (1.0 - w) * loss_att,
            "loss_att": loss_att, "loss_ctc": loss_ctc}


# ---- SpecAugment, drawn as the program draws it ----

def spec_augment(gen: torch.Generator, feats, flens, sa: dict):
    """Frequency and time masks (no warp): widths uniform on 0..W, starts
    uniform over the room left, time widths capped at the utterance
    length times time_mask_max_ratio; draws in the order f widths, f
    starts, t widths, t starts, each [B, M]."""
    if sa.get("time_warp_window", 0):
        raise NotImplementedError("the reference draws no time warp")
    b, t, d = feats.shape
    dev = feats.device
    lens = flens.to(torch.int32)

    def randint(high, shape):
        return torch.randint(0, high, shape, generator=gen, device=dev,
                             dtype=torch.int32)

    def uniform(shape):
        return torch.rand(shape, generator=gen, device=dev)

    nf, nt = sa["num_freq_masks"], sa["num_time_masks"]
    f_w = randint(sa["freq_mask_width"] + 1, (b, nf))
    f_s = (uniform((b, nf)) * torch.clamp(d - f_w, min=1)).int()
    cap = torch.clamp((lens.float() * sa["time_mask_max_ratio"]).int(),
                      max=sa["time_mask_width"])
    t_w = torch.minimum(randint(sa["time_mask_width"] + 1, (b, nt)),
                        cap[:, None])
    t_s = (uniform((b, nt)) * torch.clamp(lens[:, None] - t_w, min=1)).int()

    def band(start, width, size):
        i = torch.arange(size, device=dev)[None, None, :]
        return ((i >= start[..., None]) & (i < (start + width)[..., None])
                ).any(1)

    out = torch.where(band(f_s, f_w, d)[:, None, :], sa["mask_value"], feats)
    return torch.where(band(t_s, t_w, t)[:, :, None], sa["mask_value"], out)


# ---- the training steps ----

def noam_lr(step: int, train: dict, d_model: int) -> float:
    """Learning rate of update number `step` (1-based)."""
    return (train["lr_k"] * d_model ** -0.5
            * min(step ** -0.5, step * train["warmup_steps"] ** -1.5))


def train_steps(cfg: dict, train: dict, weights: dict, batches: list,
                specaug_seed: int, dropout_states: list,
                prec: Precision, device) -> dict:
    """Follow the program's first steps from the same weights on the same
    batches. batches: dicts of feats [B, T, D], feat_lengths, targets
    (IGNORE-padded), target_lengths, at the program's padded shapes;
    dropout_states: the device generator's state before each step.
    -> losses, the clipped gradient's norm of each leaf at step 1
    ("grad"), the raw gradient's ("raw_grad"), and the norm of each
    leaf's change after the last step ("change")."""
    names = list(weights)
    P = {n: weights[n].detach().to(device, torch.float32).clone()
         .requires_grad_(True) for n in names}
    start = {n: P[n].detach().clone() for n in names}
    m = {n: torch.zeros_like(P[n]) for n in names}
    v = {n: torch.zeros_like(P[n]) for n in names}
    b1, b2 = train["adam_betas"]
    eps = train["adam_eps"]
    gen = torch.Generator(device=device).manual_seed(specaug_seed)
    dtype = getattr(torch, cfg["dtype"])
    out = {"losses": []}
    for k, batch in enumerate(batches):
        set_rng_state(device, dropout_states[k])
        model = Model(cfg, P, prec, Dropout(cfg["dropout"], dtype, True))
        feats = batch["feats"].to(device)
        flens = batch["feat_lengths"].to(device).long()
        feats = spec_augment(gen, feats, flens, train["specaug"])
        loss = objective(model, feats, flens,
                         batch["targets"].to(device).long(),
                         batch["target_lengths"].to(device).long())["loss"]
        grads = torch.autograd.grad(loss, [P[n] for n in names])
        out["losses"].append(float(loss.detach()))
        with torch.no_grad():
            norm = torch.sqrt(sum((g.double() ** 2).sum() for g in grads))
            scale = (train["grad_clip"] / norm).clamp(max=1.0).float()
            if k == 0:
                out["raw_grad"] = {n: float(g.norm())
                                   for n, g in zip(names, grads)}
                out["grad"] = {n: float((g * scale).norm())
                               for n, g in zip(names, grads)}
            lr = noam_lr(k + 1, train, cfg["d_model"])
            for n, g in zip(names, grads):
                g = g * scale
                m[n].mul_(b1).add_(g, alpha=1 - b1)
                v[n].mul_(b2).addcmul_(g, g, value=1 - b2)
                m_hat = m[n] / (1 - b1 ** (k + 1))
                v_hat = v[n] / (1 - b2 ** (k + 1))
                P[n].sub_(lr * m_hat / (v_hat.sqrt() + eps))
        del model, loss, grads
    with torch.no_grad():
        out["change"] = {n: float((P[n] - start[n]).norm()) for n in names}
    return out


def set_rng_state(device, state):
    """Put the device's default generator back to a recorded state."""
    if torch.device(device).type == "cuda":
        torch.cuda.set_rng_state(state, torch.device(device))
    else:
        torch.set_rng_state(state)


# ---- serving: the frontend, a hypothesis's joint score, the joint beam ----

def log_mel(wav: torch.Tensor, fe: dict) -> torch.Tensor:
    """Kaldi-style fbank of one waveform [S] (snip edges, DC removed,
    preemphasis, povey window, power spectrum of a zero-padded FFT,
    triangular mel filters on 1127 ln(1 + f/700), natural log with a
    floor), then per-utterance mean and variance normalization."""
    sr = fe["sample_rate"]
    n = int(sr * fe["frame_length_ms"] / 1000)
    hop = int(sr * fe["frame_shift_ms"] / 1000)
    n_fft = 1 << (n - 1).bit_length()
    frames = wav.float().unfold(0, n, hop)                  # [T, n]
    frames = frames - frames.mean(dim=1, keepdim=True)
    prev = torch.cat([frames[:, :1], frames[:, :-1]], dim=1)
    frames = frames - fe["preemphasis"] * prev
    i = torch.arange(n, dtype=torch.float64)
    win = (0.5 - 0.5 * torch.cos(2 * math.pi * i / (n - 1))) ** 0.85
    spec = torch.fft.rfft(frames * win.float().to(wav.device), n=n_fft)
    power = spec.real ** 2 + spec.imag ** 2                 # [T, n_fft/2+1]

    def mel(hz):
        return 1127.0 * np.log(1.0 + np.asarray(hz, np.float64) / 700.0)

    high = fe["high_freq"] if fe["high_freq"] > 0 else \
        sr / 2 + fe["high_freq"]
    pts = np.linspace(mel(fe["low_freq"]), mel(high), fe["num_mel_bins"] + 2)
    fm = mel(np.arange(n_fft // 2 + 1) * sr / n_fft)[:, None]
    up = (fm - pts[None, :-2]) / (pts[1:-1] - pts[:-2])[None, :]
    down = (pts[None, 2:] - fm) / (pts[2:] - pts[1:-1])[None, :]
    bank = torch.from_numpy(np.maximum(0.0, np.minimum(up, down)).astype(
        np.float32)).to(wav.device)
    feats = torch.log(torch.clamp(power @ bank, min=fe["log_floor"]))
    mean = feats.mean(dim=0, keepdim=True)
    var = (feats - mean).square().mean(dim=0, keepdim=True)
    return (feats - mean) * torch.rsqrt(var + 1e-8)


def _lae(a, b):
    return np.logaddexp(a, b)


class PrefixScorer:
    """CTC prefix probabilities over one utterance's log-posteriors
    x [T, V] (float64, host): the forward variables r_nb, r_b [T] of a
    prefix, extended one label at a time (Watanabe et al. 2017)."""

    def __init__(self, x: np.ndarray, blank: int = 0):
        self.x, self.blank = x, blank
        self.t = x.shape[0]

    def empty(self):
        """(r_nb, r_b) of the empty prefix."""
        return (np.full(self.t, NEG), np.cumsum(self.x[:, self.blank]))

    def extend(self, state, last: int | None, cands: np.ndarray):
        """Prefix g (state, last label or None) extended by each of cands
        [K] -> (psi [K], r_nb [T, K], r_b [T, K])."""
        psi, nb, bb = self.extend_many([state], [last], cands[None])
        return psi[0], nb[:, 0], bb[:, 0]

    def extend_many(self, states, lasts, cands: np.ndarray):
        """W prefixes at once: states [(r_nb, r_b)] and last labels of W
        prefixes of one length, cands [W, K] -> (psi [W, K], r_nb and r_b
        [T, W, K])."""
        r_nb = np.stack([s[0] for s in states], 1)[:, :, None]  # [T, W, 1]
        r_b = np.stack([s[1] for s in states], 1)[:, :, None]
        last = np.asarray([-1 if x is None else x for x in lasts])
        xc = self.x[:, cands]                                 # [T, W, K]
        same = (cands == last[:, None])[None]
        phi = np.where(same, r_b, _lae(r_b, r_nb))
        nb = np.full(xc.shape, NEG)
        bb = np.full(xc.shape, NEG)
        nb[0] = np.where((last < 0)[:, None], xc[0], NEG)
        psi = nb[0].copy()
        xb = self.x[:, self.blank]
        for t in range(1, self.t):
            nb[t] = _lae(nb[t - 1], phi[t - 1]) + xc[t]
            bb[t] = _lae(nb[t - 1], bb[t - 1]) + xb[t]
            psi = _lae(psi, phi[t - 1] + xc[t])
        return psi, nb, bb

    def complete(self, state) -> float:
        """log P(g) of the whole utterance: g ends at the last frame."""
        return float(_lae(state[0][-1], state[1][-1]))


def joint_score(att_logp: np.ndarray, scorer: PrefixScorer, y: list,
                forced: bool, ctc_weight: float, eos: int) -> float:
    """The joint score of hypothesis y: (1 - l) sum of attention log-
    probabilities + l CTC log-probability, with eos and the complete
    sequence's CTC probability when y ended by itself, or the prefix
    probability and no eos when the length cap ended it.
    att_logp [len(y) + 1, V] teacher-forced on sos + y."""
    att = sum(att_logp[i, tok] for i, tok in enumerate(y))
    state, last = scorer.empty(), None
    psi = 0.0
    for tok in y:
        p, nb, bb = scorer.extend(state, last, np.asarray([tok]))
        state, last, psi = (nb[:, 0], bb[:, 0]), tok, float(p[0])
    if forced:
        ctc = psi
    else:
        att += att_logp[len(y), eos]
        ctc = scorer.complete(state)
    return float((1.0 - ctc_weight) * att + ctc_weight * ctc)


class Decoded:
    """One utterance encoded once: its CTC log-posteriors, and the
    decoder's log-probabilities of any prefixes."""

    def __init__(self, model: Model, feats: torch.Tensor):
        flens = torch.tensor([feats.shape[0]], device=feats.device)
        enc, lens = model.encode(feats[None], flens)
        self.model, self.enc, self.lens = model, enc, lens
        self.t = int(lens[0])
        x = torch.log_softmax(model.ctc_logits(enc)[0, :self.t], dim=-1)
        self.scorer = PrefixScorer(x.double().cpu().numpy())

    def att_logp(self, prefixes: list) -> np.ndarray:
        """[N, len + 1, V] decoder log-probabilities of sos + prefix for
        N prefixes of one length (float64, host)."""
        v = self.model.cfg["vocab_size"]
        ys = torch.tensor([[v - 2] + list(p) for p in prefixes],
                          device=self.enc.device)
        n = len(prefixes)
        logits = self.model.decode(self.enc.expand(n, -1, -1),
                                   self.lens.expand(n), ys)
        return torch.log_softmax(logits, dim=-1).double().cpu().numpy()


def maxlen_of(t: int, beam: dict) -> int:
    """The length cap of an utterance of t encoder frames."""
    if beam["maxlenratio"] > 0:
        return int(min(max(math.floor(beam["maxlenratio"] * t), 1),
                       beam["max_len"]))
    return beam["max_len"]


def score_hypothesis(dec: Decoded, y: list, beam: dict) -> float:
    eos = dec.model.cfg["vocab_size"] - 1
    att = dec.att_logp([y])[0]
    forced = len(y) >= maxlen_of(dec.t, beam)
    return joint_score(att, dec.scorer, y, forced, beam["ctc_weight"], eos)


def _top(x: np.ndarray, k: int) -> np.ndarray:
    """Indices of the k largest, ties to the lower index."""
    return np.argsort(-x, kind="stable")[:k]


def joint_beam(dec: Decoded, beam: dict) -> tuple[list, float]:
    """Joint CTC/attention beam search (espnet's pre-beam of the 2W
    attention candidates plus eos), one utterance -> (1-best, score)."""
    w, lam = beam["beam"], beam["ctc_weight"]
    v = dec.model.cfg["vocab_size"]
    eos = v - 1
    k = min(beam.get("ctc_cand") or 2 * w, v)
    cap = maxlen_of(dec.t, beam)
    hyps = [[] for _ in range(w)]
    scores = np.where(np.arange(w) == 0, 0.0, NEG)
    done = np.zeros(w, bool)
    states = [dec.scorer.empty()] * w
    psis = np.zeros(w)
    pos = 0
    while pos < beam["max_len"] and not done.all():
        live = [b for b in range(w) if not done[b] and pos < cap]
        att = dict(zip(live, dec.att_logp([hyps[b] for b in live])[:, -1])
                   if live else {})                       # b -> [V]
        rows = [(np.where(np.arange(k + 1) == k, 0.0, NEG), None, None)
                for _ in range(w)]
        if live:
            cands = np.stack([_top(att[b], k) for b in live])  # [L, K]
            lasts = [hyps[b][-1] if hyps[b] else None for b in live]
            psi, nb, bb = dec.scorer.extend_many(
                [states[b] for b in live], lasts, cands)
            for j, b in enumerate(live):
                whole = dec.scorer.complete(states[b])
                p = np.append(np.where(cands[j] == eos, whole, psi[j]), whole)
                cl = np.append(att[b][cands[j]], att[b][eos])
                step = (1.0 - lam) * cl + lam * (p - psis[b])
                rows[b] = (step, np.append(cands[j], eos),
                           (p, nb[:, j], bb[:, j]))
        total = np.concatenate([scores[b] + rows[b][0] for b in range(w)])
        best = _top(total, w)
        new_h, new_s, new_d, new_st, new_p = [], [], [], [], []
        for i in best:
            b, slot = divmod(int(i), k + 1)
            new_s.append(total[i])
            ended = rows[b][1] is None or rows[b][1][slot] == eos
            if ended:
                new_h.append(hyps[b])
                new_d.append(True)
                new_st.append(states[b])
                new_p.append(psis[b])
                continue
            _, cands, (psi, nb, bb) = rows[b]
            new_h.append(hyps[b] + [int(cands[slot])])
            new_d.append(False)
            new_st.append((nb[:, slot], bb[:, slot]))
            new_p.append(psi[slot])
        hyps, scores, done = new_h, np.asarray(new_s), np.asarray(new_d)
        states, psis = new_st, np.asarray(new_p)
        pos += 1
    b = int(_top(scores, 1)[0])
    return hyps[b], float(scores[b])
