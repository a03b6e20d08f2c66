"""The port's spans (tpu_asr_torch/utils/tracing.py) and counters on the
CPU, and the benchmark's readers of them (benchmark/metrics/).

`span` enters no record_function unless the calling thread is profiled;
under the profiler a train step's phases and a joint beam search's steps
and syncs appear as named ranges in the order the program runs them,
and the spans leave the search's result as it was: the same tokens and
scores as without a profiler and as tpu_asr's beam search on the same
inputs, in the same number of steps. AsrServer sums each request's
queue wait and each group's decode time, and warmup zeroes every
counter. Each reader returns None without its input and its value on a
small context built as the benchmark's drivers build one."""

import os
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmark import harness
from benchmark.trace import Stretch
from tpu_asr.decode.beam import BeamConfig as JaxBeam
from tpu_asr.decode.beam import attention_beam_search as jax_beam_search
from tpu_asr.models.decoder import Decoder as JaxDecoder
from tpu_asr_torch.augment import SpecAugmentConfig
from tpu_asr_torch.decode.beam import BeamConfig, attention_beam_search
from tpu_asr_torch.decode.recognizer import Recognizer
from tpu_asr_torch.serve import AsrServer
from tpu_asr_torch.train import NoamAdam, TrainStep
from tpu_asr_torch.utils import tracing
from torch_port_util import (VOCAB, flax_params, jax_cfg, torch_cfg,
                             torch_model, wav_batch)

SOS, EOS = VOCAB - 2, VOCAB - 1
TRAIN_SPANS = ["train.h2d", "train.specaug", "train.forward",
               "train.backward", "train.optimizer"]


def metric(name):
    return harness.load_module(
        os.path.join(harness.HERE, "metrics", name + ".py"),
        "test_metric_" + name)


@pytest.fixture
def counted(monkeypatch):
    """torch.profiler.record_function, counting the ranges it opens."""
    calls = []
    real = torch.profiler.record_function

    def counting(name, *a, **kw):
        calls.append(name)
        return real(name, *a, **kw)
    monkeypatch.setattr(torch.profiler, "record_function", counting)
    return calls


def traced(fn):
    """fn() inside a CPU stretch of the benchmark's profiler -> (fn's
    result, the stretch's marks (name, start_us, dur_us, thread))."""
    st = Stretch("cpu")
    st.start()
    try:
        out = fn()
    finally:
        st.stop()
    return out, st.summary["marks"]


def train_batch(seed=0, b=4, t=61, u=6, flens=(61, 50, 0, 37)):
    rng = np.random.default_rng(seed)
    targets = np.full((b, u), -1, np.int32)
    tlens = np.zeros(b, np.int32)
    for i, fl in enumerate(flens):
        if fl:
            n = int(rng.integers(2, u + 1))
            targets[i, :n] = rng.integers(2, VOCAB - 2, n)
            tlens[i] = n
    return {"feats": rng.standard_normal((b, t, 80)).astype(np.float32),
            "feat_lengths": np.asarray(flens, np.int32),
            "targets": targets, "target_lengths": tlens}


def train_step():
    model = torch_model()
    opt = NoamAdam(model.parameters(), 64, 100, 1.0, 5.0)
    return TrainStep(model, opt, specaug=SpecAugmentConfig(), device="cpu",
                     seed=3)


# ---- the span helper ----

def test_span_off_enters_no_record_function(counted):
    assert not torch._C._autograd._profiler_enabled()
    with tracing.span("a.b"):
        with tracing.span("a.c"):
            pass
    assert tracing.span("a.b") is tracing.span("a.d")     # one shared no-op
    train_step()(train_batch())
    with torch.no_grad():
        beam_search(maxlenratio=0.3)
    assert counted == []


def test_span_on_another_thread_than_the_profiled_one_enters_nothing(
        counted):
    seen = []

    def other():
        seen.append(torch._C._autograd._profiler_enabled())
        with tracing.span("other.thread"):
            torch.ones(4).sum()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        assert torch._C._autograd._profiler_enabled()
        th = threading.Thread(target=other)
        th.start()
        th.join(timeout=60)
        assert not th.is_alive()
    assert seen == [False] and counted == []


def test_span_records_a_named_range_under_the_profiler(counted):
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with tracing.span("unit.range"):
            torch.ones(8).sum()
    assert counted == ["unit.range"]
    assert "unit.range" in [e.name for e in prof.events()]


# ---- spans of the train step ----

def test_train_step_emits_its_phases_once_each_in_order():
    ts = train_step()
    batch = train_batch()
    ts(batch)                       # the first step's lazy set-up
    metrics, marks = traced(lambda: ts(batch))
    names = [m[0] for m in marks if m[0].startswith("train.")]
    assert names == TRAIN_SPANS
    assert torch.isfinite(metrics["loss"])
    got = {m[0]: m for m in marks if m[0] in TRAIN_SPANS}
    for a, b in zip(TRAIN_SPANS, TRAIN_SPANS[1:]):   # disjoint, in order
        assert got[a][1] + got[a][2] <= got[b][1] + 1.0
    ctx = {"kind": "train", "traced_steps": [[(61, 3)]],
           "trace": {"marks": marks}}
    assert metric("h2d_ms").read(ctx) == pytest.approx(
        got["train.h2d"][2] / 1e3)
    assert metric("optimizer_ms").read(ctx) == pytest.approx(
        got["train.optimizer"][2] / 1e3)


# ---- spans of the beam loop ----

def enc_inputs(b=3, t=14, lens=(14, 9, 5), seed=3):
    rng = np.random.default_rng(seed)
    enc = rng.standard_normal((b, t, 64)).astype(np.float32)
    lens = np.asarray(lens, np.int32)
    enc[np.arange(t)[None, :] >= lens[:, None]] = 0.0
    lg = (2.0 * rng.standard_normal((b, t, VOCAB))).astype(np.float32)
    logp = lg - np.log(np.exp(lg).sum(-1, keepdims=True))
    return enc, lens, logp


def beam_search(**kw):
    enc, lens, logp = enc_inputs()
    cfg = BeamConfig(beam=3, max_len=8, ctc_weight=0.3, **kw)
    return attention_beam_search(
        torch_model().decoder, torch.from_numpy(enc), torch.from_numpy(lens),
        SOS, EOS, cfg, ctc_logp=torch.from_numpy(logp))


@pytest.mark.parametrize("maxlenratio", [0.3, 0.0])
def test_joint_beam_spans_leave_the_search_as_it_was(maxlenratio):
    """beam.step once a step taken, beam.sync once a check of the early
    exit; the result equals the untraced run's exactly, and tpu_asr's
    (tokens and lengths exactly, scores within 1e-4), in as many steps
    as tpu_asr's while_loop takes (the longest hypothesis + 1)."""
    with torch.no_grad():
        plain = beam_search(maxlenratio=maxlenratio)
        got, marks = traced(lambda: beam_search(maxlenratio=maxlenratio))
    steps = got["steps"]
    n_step = sum(1 for m in marks if m[0] == "beam.step")
    n_sync = sum(1 for m in marks if m[0] == "beam.sync")
    assert n_step == steps == plain["steps"]
    assert n_sync == (steps + 1 if steps < 8 else steps)
    for k in ("tokens", "scores", "lengths"):
        assert torch.equal(got[k], plain[k]), k
    enc, lens, logp = enc_inputs()
    want = jax_beam_search(
        JaxDecoder(jax_cfg()), {"params": flax_params()["params"]["decoder"]},
        jnp.asarray(enc), jnp.asarray(lens), SOS, EOS,
        JaxBeam(beam=3, max_len=8, ctc_weight=0.3, maxlenratio=maxlenratio),
        ctc_logp=jnp.asarray(logp))
    np.testing.assert_array_equal(got["tokens"].numpy(), want["tokens"])
    np.testing.assert_array_equal(got["lengths"].numpy(), want["lengths"])
    np.testing.assert_allclose(got["scores"].numpy(), want["scores"],
                               atol=1e-4)
    assert steps == min(8, int(np.asarray(want["lengths"]).max()) + 1)
    ctx = {"kind": "serve", "trace": {"marks": marks}}
    step_ms = [m[2] / 1e3 for m in marks if m[0] == "beam.step"]
    sync_ms = [m[2] / 1e3 for m in marks if m[0] == "beam.sync"]
    assert metric("beam_step_ms").read(ctx) == pytest.approx(
        sum(step_ms) / steps)
    assert metric("beam_sync_ms").read(ctx) == pytest.approx(
        sum(sync_ms) / steps)


def test_recognizer_batch_emits_its_phases_in_order():
    rec = Recognizer(torch_cfg(), torch_model(), mode="joint", device="cpu",
                     beam=BeamConfig(beam=2, max_len=6, ctc_weight=0.3))
    batch = wav_batch([9600, 6400], seed=5)
    plain = rec.decode_batch_nbest(batch)
    got, marks = traced(lambda: rec.decode_batch_nbest(batch))
    assert got == plain
    names = [m[0] for m in marks]
    order = ["recognizer.features", "recognizer.encode", "beam.sync",
             "beam.step", "recognizer.fetch"]
    firsts = [names.index(n) for n in order]
    assert firsts == sorted(firsts)
    assert names.count("recognizer.features") == 1
    assert names.count("recognizer.encode") == 1
    assert names.count("recognizer.fetch") == 1


# ---- the server's counters ----

def test_server_counts_queue_wait_and_decode_and_warmup_zeroes_all():
    rec = Recognizer(torch_cfg(), torch_model(), mode="joint", device="cpu",
                     beam=BeamConfig(beam=2, max_len=4, ctc_weight=0.3))
    srv = AsrServer(rec, bucket_frames=(64, 128), batch_size=2,
                    window_ms=20.0, device="cpu")
    srv.warmup(kinds=("wav",))
    assert set(srv.stats.values()) == {0}
    assert {"queue_wait_s", "decode_s"} <= set(srv.stats)
    b = wav_batch([9600, 6400, 12000], seed=9)
    srv.start()
    try:
        before = dict(srv.stats)
        threads = [threading.Thread(target=srv.submit,
                                    args=("wav", b["wav"][i, :n]),
                                    kwargs={"timeout": 120})
                   for i, n in enumerate([9600, 6400, 12000])]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=180)
            assert not th.is_alive()
        after = dict(srv.stats)
    finally:
        srv.stop()
    assert after["requests"] == 3
    assert after["queue_wait_s"] > 0 and after["decode_s"] > 0
    ctx = {"kind": "serve", "stats0": before, "stats1": after}
    assert metric("queue_wait_ms").read(ctx) == pytest.approx(
        1e3 * after["queue_wait_s"] / 3)
    srv.warmup(kinds=("wav",))
    assert set(srv.stats.values()) == {0}


# ---- the readers without their input ----

PARENT_MARKS = [("decode_batch", 0.0, 9000.0, 1), ("TrainStep", 0.0, 90.0, 1),
                ("loader.next", 0.0, 5.0, 1)]
PARENT_STATS = {"requests": 10, "batches": 2, "rows_decoded": 64}


@pytest.mark.parametrize("name", ["h2d_ms", "optimizer_ms", "queue_wait_ms",
                                  "beam_step_ms", "beam_sync_ms"])
def test_reader_finds_nothing_without_its_input(name):
    read = metric(name).read
    for kind in ("train", "serve"):
        assert read({"kind": kind}) is None
        assert read({"kind": kind, "traced_steps": [[(100, 3)]],
                     "trace": {"marks": PARENT_MARKS},
                     "stats0": dict(PARENT_STATS),
                     "stats1": dict(PARENT_STATS, requests=20)}) is None
    other = "serve" if name in ("h2d_ms", "optimizer_ms") else "train"
    marks = [(n, 0.0, 1000.0, 1) for n in TRAIN_SPANS + ["beam.step",
                                                         "beam.sync"]]
    stats = dict(PARENT_STATS, queue_wait_s=1.0, decode_s=1.0)
    assert read({"kind": other, "traced_steps": [[(100, 3)]],
                 "trace": {"marks": marks}, "stats0": stats,
                 "stats1": dict(stats, requests=20)}) is None


@pytest.mark.parametrize("name,ctx,want", [
    ("h2d_ms", {"kind": "train", "traced_steps": [[(100, 3)]] * 2,
                "trace": {"marks": [("train.h2d", 0.0, 3000.0, 1),
                                    ("train.forward", 3000.0, 50000.0, 1),
                                    ("train.h2d", 60000.0, 5000.0, 1)]}},
     4.0),
    ("optimizer_ms", {"kind": "train", "traced_steps": [[(100, 3)]] * 4,
                      "trace": {"marks": [("train.optimizer", 0.0, 8000.0,
                                           1)] * 4
                                + [("train.backward", 0.0, 1.0, 1)]}},
     8.0),
    ("queue_wait_ms", {"kind": "serve",
                       "stats0": dict(PARENT_STATS, queue_wait_s=2.0,
                                      decode_s=1.0),
                       "stats1": dict(PARENT_STATS, requests=50,
                                      queue_wait_s=38.0, decode_s=9.0)},
     900.0),
    ("beam_step_ms", {"kind": "serve",
                      "trace": {"marks": [("beam.step", 0.0, 4000.0, 1),
                                          ("beam.sync", 0.0, 1000.0, 1),
                                          ("beam.step", 0.0, 6000.0, 1)]}},
     5.0),
    ("beam_sync_ms", {"kind": "serve",
                      "trace": {"marks": [("beam.sync", 0.0, 1000.0, 1),
                                          ("beam.step", 0.0, 4000.0, 1),
                                          ("beam.sync", 0.0, 2000.0, 1),
                                          ("beam.step", 0.0, 6000.0, 1),
                                          ("beam.sync", 0.0, 3000.0, 1)]}},
     3.0),
])
def test_reader_value_on_a_small_context(name, ctx, want):
    assert metric(name).read(ctx) == pytest.approx(want)
