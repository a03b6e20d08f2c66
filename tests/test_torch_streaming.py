"""Port streaming (tpu_asr_torch.decode.streaming and the chunk encoder)
vs tpu_asr on the CPU, from the same flax params at hybrid_dev,
conformer_dev, cif_dev and transducer_dev widths with enc_chunk_size 4,
and the same numpy features.

Encoder frames and caches within atol 1e-5 (float32); every push's
return, the final hypothesis and the emission times equal; confidences
within 1e-4.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_asr.decode import streaming as js
from tpu_asr.models import Transformer as JaxTransformer
from tpu_asr.models.encoder import Encoder as JaxEncoder
from tpu_asr_torch.decode import streaming as ts
from tpu_asr_torch.decode.recognizer import Recognizer
from tpu_asr_torch.models.cif import CifModel
from tpu_asr_torch.weights import load_jax_params
from torch_port_util import (VOCAB, cif_flax_params, cif_jax_cfg,
                             cif_torch_cfg, conformer_flax_params,
                             conformer_jax_cfg,
                             conformer_torch_cfg, conformer_torch_model,
                             flax_params, jax_cfg, lm_cfgs, lm_pair,
                             torch_cfg, torch_model, transducer_flax_params,
                             transducer_jax_cfg, transducer_torch_cfg,
                             transducer_torch_model)

CHUNK = 4
ATOL = 1e-5
CONF_TOL = 1e-4
T = 150                      # feature frames: 36 encoder frames, 9 chunks
SEGMENTATIONS = {"7": (7,), "37": (37,), "all": (T,)}


def _feats(seed=3, t=T):
    rng = np.random.default_rng(seed)
    # scaled so that argmax ids vary and repeats and blanks occur
    return (rng.standard_normal((t, 80)) * 3).astype(np.float32)


def _stream(rec, feats, sizes):
    """Push feats in pieces of sizes (the last repeated) -> [each push's
    return, ..., finish()'s]."""
    outs, pos, i = [], 0, 0
    while pos < len(feats):
        n = sizes[min(i, len(sizes) - 1)]
        outs.append(list(rec.push(feats[pos:pos + n])))
        pos, i = pos + n, i + 1
    outs.append(list(rec.finish()))
    return outs


def _hybrid(encoder, left=-1):
    """(jax cfg, flax params, port cfg, port model) with chunk 4."""
    kw = dict(enc_chunk_size=CHUNK, enc_left_chunks=left)
    if encoder == "conformer":
        return (conformer_jax_cfg(**kw), conformer_flax_params(),
                conformer_torch_cfg(**kw), conformer_torch_model(**kw))
    return jax_cfg(**kw), flax_params(), torch_cfg(**kw), torch_model(**kw)


# ---- geometry ----

def test_conv_window_geometry_and_assigner_lookahead():
    """conv_input_window(n) frames make exactly n encoder frames (one
    fewer make n - 1), as the reference's; the assigner constants are
    its conv's."""
    from tpu_asr.models.cif import ASSIGNER_LOOKAHEAD as JAX_LA
    from tpu_asr_torch.models.cif import (ASSIGNER_CONV_WIDTH,
                                          ASSIGNER_LOOKAHEAD)
    cfg, jcfg = torch_cfg(), jax_cfg()
    for n in (1, 2, 4, 7, 16):
        w = cfg.conv_input_window(n)
        assert cfg.subsampled_length(w) == n
        assert cfg.subsampled_length(w - 1) == n - 1
        assert w == jcfg.conv_input_window(n)
    assert (cfg.conv_total_stride, cfg.conv_receptive_field) == (4, 7)
    model = CifModel(cif_torch_cfg())
    width = model.assigner.conv.kernel_size[0]
    assert width == ASSIGNER_CONV_WIDTH
    assert model.assigner.conv.padding == (ASSIGNER_LOOKAHEAD,)
    assert ASSIGNER_LOOKAHEAD == (width - 1) // 2 == JAX_LA
    with pytest.raises(ValueError):
        dataclasses.replace(cfg, input_layer="linear").conv_total_stride


# ---- the chunk encoder ----

@pytest.mark.parametrize("left", [-1, 1])
@pytest.mark.parametrize("encoder", ["transformer", "conformer"])
def test_encode_chunk_matches_reference(encoder, left):
    """Every chunk's output and every cache (k, v; the conformer's conv)
    within 1e-5 of tpu_asr's Encoder.encode_chunk, the last chunk partial
    (valid_upto); the chunks' concatenation within 1e-5 of the port's own
    full pass under the chunk mask."""
    jcfg, params, cfg, model = _hybrid(encoder, left)
    jm = JaxTransformer(jcfg)
    n = 141                                # 34 encoder frames: 8.5 chunks
    feats = _feats(seed=5, t=n)
    el = cfg.subsampled_length(n)
    n_chunks = -(-el // CHUNK)
    assert el % CHUNK
    t_max = n_chunks * CHUNK
    win = cfg.conv_input_window(CHUNK)
    buf = np.zeros((1, n + win, 80), np.float32)
    buf[0, :n] = feats
    jc = JaxEncoder(jcfg).init_cache(1, t_max)
    tc = model.encoder.init_cache(1, t_max)
    assert set(tc["layer_0"]) == set(jc["layer_0"])

    def fwd(m, w, k, v, c):
        return m.encoder.encode_chunk(w, k, c, valid_upto=v)

    outs = []
    for k in range(n_chunks):
        w = buf[:, 4 * CHUNK * k: 4 * CHUNK * k + win]
        want, jc = jm.apply(params, jnp.asarray(w), k, el, jc, method=fwd)
        with torch.no_grad():
            got, tc = model.encoder.encode_chunk(torch.from_numpy(w), k, tc,
                                                 valid_upto=el)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                                   rtol=0)
        for layer, entry in tc.items():
            for key, x in entry.items():
                np.testing.assert_allclose(
                    x.numpy(), np.asarray(jc[layer][key]), atol=ATOL, rtol=0,
                    err_msg=f"chunk {k} {layer} {key}")
        outs.append(got.numpy()[0])
    with torch.no_grad():
        full, _ = model.encode(torch.from_numpy(feats[None]),
                               torch.tensor([n]))
    np.testing.assert_allclose(np.concatenate(outs)[:el], full[0].numpy(),
                               atol=ATOL, rtol=0)


def test_encoder_layer_step_still_writes_one_row():
    """The chunk step's slice write keeps the CIF decoder's one-row use:
    a step at pos writes row pos of the caches and no other."""
    model = CifModel(cif_torch_cfg())
    layer = model.decoder.layers[0]
    cfg = model.cfg
    k = torch.zeros(1, 6, cfg.num_heads, cfg.d_head)
    v = torch.zeros_like(k)
    x = torch.randn(1, 1, cfg.d_model, generator=torch.Generator()
                    .manual_seed(0))
    with torch.no_grad():
        layer.step(x, 3, k, v, None)
        want = layer.slf_attn.project_kv(x)
    assert torch.equal(k[:, 3], want[0][:, 0])
    assert torch.equal(v[:, 3], want[1][:, 0])
    assert not k[:, [0, 1, 2, 4, 5]].any()


# ---- each recognizer against its tpu_asr counterpart ----

def _check_times_confs(jrec, trec):
    assert trec.hypothesis_times == jrec.hypothesis_times
    got = np.asarray(trec.hypothesis_confidence, np.float64)
    want = np.asarray(jrec.hypothesis_confidence, np.float64)
    assert got.shape == want.shape
    if got.size:
        assert np.abs(got - want).max() <= CONF_TOL


@pytest.mark.parametrize("seg", list(SEGMENTATIONS))
@pytest.mark.parametrize("encoder,incremental", [
    ("transformer", True), ("transformer", False), ("conformer", True)])
def test_ctc_recognizer_matches_reference(encoder, incremental, seg):
    jcfg, params, cfg, model = _hybrid(encoder)
    feats = _feats()
    want_rec = js.StreamingCTCRecognizer(jcfg, params, max_frames=192,
                                         incremental=incremental)
    got_rec = ts.StreamingCTCRecognizer(cfg, model, max_frames=192,
                                        incremental=incremental,
                                        device="cpu")
    want = _stream(want_rec, feats, SEGMENTATIONS[seg])
    got = _stream(got_rec, feats, SEGMENTATIONS[seg])
    assert got == want
    assert len(got[-1]) >= 5
    _check_times_confs(want_rec, got_rec)


@pytest.mark.parametrize("seg", list(SEGMENTATIONS))
@pytest.mark.parametrize("fused", [False, True])
def test_ctc_beam_recognizer_matches_reference(fused, seg):
    """The 1-best after every push and at finish equal, without and with
    a small seeded LM fused in (weight 0.5)."""
    jcfg, params, cfg, model = _hybrid("transformer")
    feats = _feats(seed=4)
    jlm_kw, lm_kw = {}, {}
    if fused:
        jlm_cfg, _ = lm_cfgs()
        _, lm_params, lm = lm_pair()
        jlm_kw = dict(lm_cfg=jlm_cfg, lm_params=lm_params, lm_weight=0.5)
        lm_kw = dict(lm=lm, lm_weight=0.5)
    want = _stream(js.StreamingCTCBeamRecognizer(
        jcfg, params, beam=3, max_frames=192, max_tokens=40, **jlm_kw),
        feats, SEGMENTATIONS[seg])
    got = _stream(ts.StreamingCTCBeamRecognizer(
        cfg, model, beam=3, max_frames=192, max_tokens=40, device="cpu",
        **lm_kw), feats, SEGMENTATIONS[seg])
    assert got == want
    assert len(got[-1]) >= 3


@pytest.fixture(scope="module")
def cif_pair():
    """CIF params with the decoder's fuse kernel scaled x10, so that the
    fired vectors move its argmax (random weights otherwise emit one
    token throughout) -> (jax cfg, params, port cfg, port model)."""
    v = jax.tree_util.tree_map(np.asarray, cif_flax_params())
    fuse = v["params"]["decoder"]["fuse"]
    fuse["kernel"] = fuse["kernel"] * 10.0
    cfg = cif_torch_cfg(enc_chunk_size=CHUNK)
    model = CifModel(cfg)
    load_jax_params(model, v)
    return cif_jax_cfg(enc_chunk_size=CHUNK), v, cfg, model


@pytest.mark.parametrize("seg", list(SEGMENTATIONS))
@pytest.mark.parametrize("incremental", [True, False])
def test_cif_recognizer_matches_reference(cif_pair, incremental, seg):
    """Every push and finish equal, and the decoder steps taken; max
    tokens 8, under the ~11 fires, so the max_tokens rule binds."""
    jcfg, params, cfg, model = cif_pair
    feats = _feats(seed=5)
    want_rec = js.StreamingCIFRecognizer(jcfg, params, max_frames=192,
                                         max_tokens=8,
                                         incremental=incremental)
    got_rec = ts.StreamingCIFRecognizer(cfg, model, max_frames=192,
                                        max_tokens=8,
                                        incremental=incremental,
                                        device="cpu")
    want = _stream(want_rec, feats, SEGMENTATIONS[seg])
    got = _stream(got_rec, feats, SEGMENTATIONS[seg])
    assert got == want
    assert got_rec._pos == want_rec._pos == 8
    assert len(set(got[-1])) >= 2


@pytest.mark.parametrize("seg", list(SEGMENTATIONS))
@pytest.mark.parametrize("preset", ["transducer_dev",
                                    "conformer_transducer_dev"])
def test_transducer_recognizer_matches_reference(preset, seg):
    feats = _feats(seed=6)
    want_rec = js.StreamingTransducerRecognizer(
        transducer_jax_cfg(preset, enc_chunk_size=CHUNK),
        transducer_flax_params(preset), max_frames=192, max_tokens=40)
    got_rec = ts.StreamingTransducerRecognizer(
        transducer_torch_cfg(preset, enc_chunk_size=CHUNK),
        transducer_torch_model(preset, enc_chunk_size=CHUNK),
        max_frames=192, max_tokens=40, device="cpu")
    want = _stream(want_rec, feats, SEGMENTATIONS[seg])
    got = _stream(got_rec, feats, SEGMENTATIONS[seg])
    assert got == want
    assert got_rec.hypothesis == want_rec.hypothesis
    assert len(got[-1]) >= 5
    _check_times_confs(want_rec, got_rec)


# ---- behaviour of the port's recognizers ----

def _ctc(model_kw=None, **kw):
    cfg = torch_cfg(enc_chunk_size=CHUNK, **(model_kw or {}))
    model = torch_model(enc_chunk_size=CHUNK, **(model_kw or {}))
    return ts.StreamingCTCRecognizer(cfg, model, max_frames=256,
                                     device="cpu", **kw)


def test_incremental_equals_recompute_at_every_push():
    feats = _feats(seed=7, t=173)
    recs = [_ctc(incremental=True), _ctc(incremental=False)]
    assert recs[0].incremental and not recs[1].incremental
    for pos in range(0, 173, 17):
        outs = [r.push(feats[pos:pos + 17]) for r in recs]
        assert outs[0] == outs[1], pos
    assert recs[0].finish() == recs[1].finish()
    assert recs[0].hypothesis_times == recs[1].hypothesis_times


def test_segmentation_invariance_and_tokens_before_finish():
    feats = _feats(seed=5, t=T)
    hyps = []
    for sizes in ((T,), (10,), (33,)):
        rec = _ctc()
        outs = _stream(rec, feats, sizes)
        mid = [x for o in outs[:-1] for x in o]
        assert mid == outs[-1][:len(mid)]           # finish only appends
        if sizes == (10,):
            assert len(mid) > 0 and rec._emitted_enc > 0
        hyps.append((outs[-1], rec.hypothesis_times))
    assert hyps[0] == hyps[1] == hyps[2]


def test_streamed_equals_offline_recognizer():
    """Tokens and times equal the port's offline greedy_ctc on the
    chunk-masked model; confidences within 1e-4."""
    feats = _feats(seed=9, t=T)
    rec = _ctc()
    _stream(rec, feats, (64,))
    offline = Recognizer(torch_cfg(enc_chunk_size=CHUNK),
                         torch_model(enc_chunk_size=CHUNK),
                         mode="greedy_ctc", device="cpu")
    want = offline.decode_batch_nbest({
        "feats": feats[None], "feat_lengths": np.asarray([T], np.int32)})[0][0]
    # the offline clean-up drops eos (vocab - 1); the stream keeps it
    kept = [j for j, tok in enumerate(rec.hypothesis) if tok != VOCAB - 1]
    assert len(kept) < len(rec.hypothesis)
    assert [rec.hypothesis[j] for j in kept] == want["yseq"]
    assert [rec.hypothesis_times[j] for j in kept] == want["times"]
    np.testing.assert_allclose([rec.hypothesis_confidence[j] for j in kept],
                               want["confidence"], atol=CONF_TOL, rtol=0)


def test_full_context_model_emits_nothing_before_finish():
    cfg = torch_cfg()
    assert cfg.enc_chunk_size == 0
    rec = ts.StreamingCTCRecognizer(cfg, torch_model(), max_frames=160,
                                    device="cpu")
    assert not rec.incremental
    feats = _feats(seed=11, t=120)
    assert rec.push(feats[:60]) == [] and rec.push(feats[60:]) == []
    offline = Recognizer(cfg, torch_model(), mode="greedy_ctc", device="cpu")
    want = offline.decode_batch({"feats": feats[None],
                                 "feat_lengths": np.asarray([120])})[0]
    hyp = rec.finish()
    assert [tok for tok in hyp if tok != VOCAB - 1] == want and want
    with pytest.raises(ValueError, match="enc_chunk_size"):
        ts.StreamingCTCRecognizer(cfg, torch_model(), incremental=True,
                                  device="cpu")
    with pytest.raises(ValueError, match="enc_chunk_size"):
        ts.StreamingTransducerRecognizer(
            transducer_torch_cfg(), transducer_torch_model(), device="cpu")


def test_no_push_after_finish_and_max_frames():
    feats = _feats(t=40)
    for rec in (_ctc(), ts.StreamingCTCBeamRecognizer(
            torch_cfg(enc_chunk_size=CHUNK),
            torch_model(enc_chunk_size=CHUNK), beam=2, device="cpu")):
        rec.push(feats)
        hyp = rec.finish()
        assert rec.finish() == hyp               # finishing twice is a no-op
        with pytest.raises(RuntimeError, match="after finish"):
            rec.push(feats)
    rec = _ctc()
    with pytest.raises(ValueError, match="max_frames"):
        rec.push(np.zeros((257, 80), np.float32))


def test_cif_fire_count_matches_ops_oracle(cif_pair):
    """The decoder steps equal the unscaled fire count of ops.cif on the
    whole utterance's alphas (no eos, max_tokens not reached)."""
    from tpu_asr_torch.ops.cif import fire_count
    _, _, cfg, model = cif_pair
    feats = _feats(seed=17, t=140)
    rec = ts.StreamingCIFRecognizer(cfg, model, max_frames=160,
                                    max_tokens=64, device="cpu")
    _stream(rec, feats, (23,))
    with torch.no_grad():
        _, _, alphas, valid = model.encode(torch.from_numpy(feats[None]),
                                           torch.tensor([140]))
    want = int(fire_count(alphas, valid, cfg.cif_tail_threshold)[0])
    assert not rec._saw_eos and want > 5
    assert rec._pos == want


def test_transducer_streamed_equals_offline_greedy():
    from tpu_asr_torch.decode.transducer_decode import \
        transducer_greedy_decode
    cfg = transducer_torch_cfg(enc_chunk_size=CHUNK)
    model = transducer_torch_model(enc_chunk_size=CHUNK)
    feats = _feats(seed=8)
    rec = ts.StreamingTransducerRecognizer(cfg, model, max_frames=192,
                                           max_tokens=60, device="cpu")
    outs = _stream(rec, feats, (29,))
    with torch.no_grad():
        toks, lens, times, confs, _ = transducer_greedy_decode(
            model, torch.from_numpy(feats[None]), torch.tensor([T]),
            max_tokens=60)
    n = int(lens[0])
    assert outs[-1] == toks[0, :n].tolist() and n > 5
    mid = [x for o in outs[:-1] for x in o]          # append-only
    assert mid and mid == outs[-1][:len(mid)]
    assert rec.hypothesis_times == times[0, :n].tolist()
    np.testing.assert_allclose(rec.hypothesis_confidence,
                               confs[0, :n].numpy(), atol=CONF_TOL, rtol=0)


def test_recognizers_need_a_card_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = torch_cfg(enc_chunk_size=CHUNK)
    model = torch_model(enc_chunk_size=CHUNK)
    for cls in (ts.StreamingCTCRecognizer, ts.StreamingCTCBeamRecognizer):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cls(cfg, model)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ts.StreamingCIFRecognizer(cif_torch_cfg(enc_chunk_size=CHUNK),
                                  CifModel(cif_torch_cfg(
                                      enc_chunk_size=CHUNK)))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ts.StreamingTransducerRecognizer(
            transducer_torch_cfg(enc_chunk_size=CHUNK),
            transducer_torch_model(enc_chunk_size=CHUNK))
    assert next(model.parameters()).device.type == "cpu"
