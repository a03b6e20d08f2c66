"""The Whisper cell: its pieces found by name, its four per-layer readers
and `flops_whisper` against known values, and its driver end to end on
the CPU at a tiny size (a copy of benchmark/ with a tiny Whisper
configuration, float32 so that the CPU's plain versions match the
reference, and a tiny serving mix), as the other serve tests run theirs.
The tiny cell takes the real cell's limits."""

import copy
import json
import os
import shutil
import time

import pytest
import torch

from benchmark import flops, flops_whisper, harness
from benchmark.drivers import serve as serve_drv

ROOT = harness.ROOT
CELL = "whisper_lv3_serve_beam5_c64"
SEED = 2 ** 31 + 23
# whisper_dev's sizes: a 1 s window of 128 mel bins (100 frames, 50
# encoder frames), a 96-id vocabulary whose last six ids are specials
TINY_MODEL = dict(vocab_size=96, d_model=64, d_inner=256, num_heads=2,
                  num_enc_layers=2, num_dec_layers=2, pe_maxlen=128,
                  audio_ctx=50, eot=90, sot_sequence=[91, 92, 93, 94],
                  dtype="float32")
TINY_SERVE = dict(requests=16, clients=4, lead_s=1.0, check_sample=16,
                  traced_s=0.5,
                  frames={"median": 60, "sigma": 0.35, "min": 30,
                          "max": 100},
                  server={"batch_size": 4, "bucket_frames": [100],
                          "window_ms": 15},
                  decode={"mode": "beam", "beam": 3, "max_len": 12,
                          "ctc_weight": 0.0, "maxlenratio": 0.25})


def _load(path):
    with open(path) as f:
        return json.load(f)


def _dump(obj, path):
    with open(path, "w") as f:
        json.dump(obj, f, indent=1)


@pytest.fixture
def tiny_whisper(tmp_path):
    """tmp/BENCHMARK.json + tmp/benchmark/ with the cell tiny_whisper
    added beside the real one -> its harness.Cell."""
    root = str(tmp_path)
    here = os.path.join(root, "benchmark")
    shutil.copytree(os.path.join(ROOT, "benchmark"), here,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = _load(os.path.join(ROOT, "BENCHMARK.json"))
    cfg = _load(os.path.join(here, "configs", "whisper_large_v3.json"))
    cfg["name"] = "tiny_whisper"
    cfg["model"].update(TINY_MODEL)
    cfg["frontend"]["chunk_s"] = 1.0
    _dump(cfg, os.path.join(here, "configs", "tiny_whisper.json"))
    mix = _load(os.path.join(here, "traffic", "serve_whisper_c64.json"))
    mix.update(copy.deepcopy(TINY_SERVE))
    _dump(mix, os.path.join(here, "traffic", "tiny_whisper.json"))
    bench["configs"].append({"name": "tiny_whisper", "source": "test",
                             "file": "benchmark/configs/tiny_whisper.json",
                             "reduced": [], "why": "CPU tests"})
    bench["workloads"].append({"name": "tiny_whisper",
                               "config": "tiny_whisper",
                               "traffic": "tiny_whisper", "chips": 1,
                               "why": "CPU tests"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if CELL in m.get("workloads", []):
            m["workloads"].append("tiny_whisper")
    shutil.copy(os.path.join(here, "limits", CELL + ".json"),
                os.path.join(here, "limits", "tiny_whisper.json"))
    _dump(bench, os.path.join(root, "BENCHMARK.json"))
    return harness.Cell("tiny_whisper", root=root, here=here)


def _run(cell, program_cls=None, trace=False):
    kw = {} if program_cls is None else {"program_cls": program_cls}
    return cell.driver.run(cell, seed=SEED, seconds=1.5, trace=trace,
                           device="cpu", t_start=time.perf_counter(), **kw)


def test_cell_pieces_found_by_name():
    cell = harness.Cell(CELL)
    assert cell.config["name"] == "whisper_large_v3"
    assert cell.traffic["kind"] == "serve_whisper"
    assert hasattr(cell.driver, "run")
    assert hasattr(cell.reference, "param_spec")
    assert set(cell.limits) == {"score_gap"}
    names = {m["name"] for m in cell.per_layer()}
    assert {"encode_issue_ms", "cross_kv_issue_ms", "decode_mfu.whisper",
            "flash_roofline.whisper", "beam_graph_share",
            "device_idle.serve"} <= names
    assert not names & {"decode_mfu", "flash_roofline.serve",
                        "prefix_scan_roofline.serve"}
    assert [m["name"] for m in cell.end_to_end()] == [
        "setup_s", "decode_audio_s_per_s", "peak_mem_gib"]
    for m in cell.per_layer():
        assert callable(cell.module("metrics", m["name"]).read)


def test_config_builds_the_port_at_the_published_widths():
    """The configuration's blocks build the port's WhisperConfig and
    frontend (serve_whisper's own conversions), at 1.55 B parameters."""
    cell = harness.Cell(CELL)
    drv = cell.driver
    cfg = drv.program_config(cell.config["model"])
    fe = drv.frontend_config(cell.config["frontend"])
    assert (cfg.d_model, cfg.num_heads, cfg.num_enc_layers,
            cfg.num_dec_layers, cfg.vocab_size, cfg.audio_ctx,
            cfg.pe_maxlen) == (1280, 20, 32, 32, 51866, 1500, 448)
    assert cfg.prompt_ids == (50260, 50360, 50364) and cfg.eos_id == 50257
    assert fe.window_frames == 2 * cfg.audio_ctx == 3000
    n = sum(torch.Size(s).numel()
            for _, s, _ in cell.reference.param_spec(cell.config["model"]))
    assert 1.54e9 < n < 1.56e9


def test_readers_on_a_synthetic_context():
    cell = harness.Cell(CELL)
    c = cell.config["model"]
    # (name, start_us, dur_us, thread): one traced batch of two answered
    # rows, two encode and two cross K/V spans; its flash kernels ran 10 ms
    marks = [("decode_batch", 0.0, 50000.0, 1),
             ("decode_rows [[430, 13], [250, 7]]", 50001.0, 1.0, 1),
             ("recognizer.encode", 51000.0, 2000.0, 1),
             ("decoder.cross_kv", 52000.0, 300.0, 1),
             ("recognizer.encode", 53000.0, 4000.0, 1),
             ("decoder.cross_kv", 54000.0, 500.0, 1)]
    kernels = [("flash_attention_fwd_wgmma_kernel", 100.0, 4000.0),
               ("flash_attention_fwd_wgmma_kernel", 5000.0, 6000.0),
               ("ampere_bf16_gemm", 12000.0, 9000.0)]
    ctx = {"kind": "serve", "config": c, "decode": cell.traffic["decode"],
           "window_s": 2.0, "answered": [(430, 13), (250, 7)],
           "trace": {"marks": marks, "kernels": kernels, "span_s": 1.0,
                     "busy_s": 0.5}}

    def read(name):
        return cell.module("metrics", name).read(ctx)
    assert read("encode_issue_ms") == pytest.approx(3.0)
    assert read("cross_kv_issue_ms") == pytest.approx(0.4)
    want = sum(flops_whisper.request_flops(u, 5, c) for u in (13, 7))
    assert read("decode_mfu.whisper") == pytest.approx(
        100.0 * want / 2.0 / flops.BF16_FLOP_PER_S)
    bound = 2 * 32 * flops.flash_fwd_bound_s(1500, 1500, 20, 64, False)
    assert read("flash_roofline.whisper") == pytest.approx(
        100.0 * bound / 0.010)
    # nothing to read: no trace, no span, another configuration
    assert cell.module("metrics", "cross_kv_issue_ms").read(
        dict(ctx, trace=dict(ctx["trace"], marks=marks[:3]))) is None
    st = harness.Cell("st_serve_joint_c64").config["model"]
    for name in ("decode_mfu.whisper", "flash_roofline.whisper"):
        assert cell.module("metrics", name).read(dict(ctx, config=st)) \
            is None
    for name in ("encode_issue_ms", "flash_roofline.whisper"):
        assert cell.module("metrics", name).read(dict(ctx, trace=None)) \
            is None


def test_flops_whisper_by_hand():
    cfg = {"audio_ctx": 4, "d_input": 3, "d_model": 2, "d_inner": 8,
           "num_enc_layers": 1, "num_dec_layers": 1, "vocab_size": 5,
           "sot_sequence": [1, 2]}
    stem = 2 * 8 * 3 * 3 * 2 + 2 * 4 * 2 * 3 * 2
    layer = 8 * 4 * 4 + 4 * 16 * 2 + 4 * 4 * 2 * 8
    assert flops_whisper.encoder_flops(cfg) == stem + layer
    assert flops_whisper.cross_kv_flops(cfg) == 4 * 4 * 4
    # 1 token: the prompt's 2 positions and the token's (u = 3, 6 causal
    # pairs), logits at 2 positions
    dec = (8 * 3 * 4 + 4 * 6 * 2 + 4 * 3 * 4 + 4 * 3 * 4 * 2
           + 4 * 3 * 2 * 8) + 2 * 2 * 2 * 5
    assert flops_whisper.decoder_flops(1, cfg) == dec
    assert flops_whisper.request_flops(1, 3, cfg) == \
        stem + layer + 64 + 3 * dec
    # large-v3's encoder: ~2.25 TFLOP a window, as its shapes give
    big = harness.Cell(CELL).config["model"]
    assert 2.2e12 < flops_whisper.encoder_flops(big) < 2.35e12


def test_serve_program_is_correct(tiny_whisper):
    out = _run(tiny_whisper, trace=True)
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    assert {"server_p95_ms", "batch_fill", "decode_batch_ms",
            "queue_wait_ms", "beam_step_ms", "encode_issue_ms",
            "cross_kv_issue_ms", "decode_mfu.whisper",
            "device_idle.serve"} <= \
        set(out["metrics"])
    assert "flash_roofline.whisper" not in out["metrics"]   # no card


def test_serve_control_is_not_correct(tiny_whisper):
    """The float8 reference answers every request of the pool in the
    server's place (its own beam's 1-best and score) and fails."""
    from benchmark import traffic
    cell = tiny_whisper
    requests = traffic.make_requests(cell.traffic, SEED, "cpu")
    picked = [(i, 0.0, 0.0, None) for i in range(len(requests.wavs))]
    rows = serve_drv.reference_answers(cell, picked, requests, SEED, "cpu",
                                       control=True)
    got = serve_drv.compare(rows)
    assert not harness.judge([(k, got[k], cell.limits[k])
                              for k in cell.limits])


def _altered_program(base):
    class AlteredToken(base):
        """Each answer's first token altered where the beam produces
        it."""

        def __init__(self, cell, seed, device):
            super().__init__(cell, seed, device)
            import tpu_asr_torch.decode.recognizer as rec_mod
            search = rec_mod.attention_beam_search

            def altered(*a, **kw):
                out = search(*a, **kw)
                toks = out["tokens"].clone()
                toks[:, :, 0] = torch.where(toks[:, :, 0] == 2, 3, 2)
                return dict(out, tokens=toks)

            self._restore = (rec_mod, search)
            rec_mod.attention_beam_search = altered

        def close(self):
            super().close()
            mod, search = self._restore
            mod.attention_beam_search = search
    return AlteredToken


def test_serve_altered_token_is_not_correct(tiny_whisper):
    prog = _altered_program(tiny_whisper.driver.Program)
    out = _run(tiny_whisper, program_cls=prog)
    assert not out["correct"], out["checks"]
