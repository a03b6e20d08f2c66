"""chip_smoke.py's helpers that need no card: the readers of what the
build made, the flash bounds and the rounding-flip count, the kernel
names it times and the CTC kernels' launch plans, on the CPU."""

import dataclasses
import importlib.util
import json
import os
import re

import numpy as np
import pytest
import torch

from tpu_asr_torch.ops import cif_fire, ctc_loss, ctc_prefix
from tpu_asr_torch.ops.flash_attention import (flash_attention_bwd_reference,
                                               flash_attention_reference)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_spec = importlib.util.spec_from_file_location(
    "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)

FWD = ("_ZN51_GLOBAL__N__9ea0bfd5_18_flash_attention_cu_fac575e832flash_"
       "attention_fwd_wgmma_kernelILi{}EEEv14CUtensorMap_stS1_S1_PKhP13__nv_"
       "bfloat16Pfiiifi")
DKV = "_ZN12_GLOBAL__N_136flash_attention_bwd_dkv_wgmma_kernelILi{}EEEvv"
DQ = "_ZN12_GLOBAL__N_135flash_attention_bwd_dq_wgmma_kernelILi{}EEEvv"
LN_BWD = ("_ZN12_GLOBAL__N_130layer_norm_residual_bwd_kernelI13__nv_bfloat16"
          "Li8ELi{}EEEvv")
SIMT = "_ZN12_GLOBAL__N_131flash_attention_fwd_simt_kernelIfLi{}EEEvv"
PREFIX = ("_ZN12_GLOBAL__N_122ctc_prefix_scan_kernelEPKfS1_S1_S1_S1_S1_"
          "PKiPfS4_S4_iiii")
BWD_WARP = ("_ZN12_GLOBAL__N_125ctc_beta_grad_warp_kernelILi2ELb1EEEvPKfPKhS4_"
            "PKiS6_S2_S2_Pfiiii")
FWD_WARP = ("_ZN12_GLOBAL__N_121ctc_alpha_warp_kernelILi2ELb1EEEvPKfPKhS4_"
            "PKiS6_PfS7_iiii")
CIF = "_ZN12_GLOBAL__N_115cif_fire_kernelILi{}EEEvPKfS2_S2_Pfiii"

RESOURCE_USAGE = """
Fatbin elf code:
================
arch = sm_90a
code version = [1,8]
host = linux
compile_size = 64bit

Resource usage:
 Common:
  GLOBAL:0
 Function {fwd}:
  REG:154 STACK:0 SHARED:0 LOCAL:0 CONSTANT[0]:1008 TEXTURE:0 SURFACE:0 SAMPLER:0
 Function {simt}:
  REG:40 STACK:232 SHARED:8192 LOCAL:0 CONSTANT[0]:600 TEXTURE:0 SURFACE:0 SAMPLER:0
""".format(fwd=FWD.format(64), simt=SIMT.format(128))

SASS = """
        code for sm_90a
                Function : {fwd}
        .headerflags    @"EF_CUDA_SM90 EF_CUDA_VIRTUAL_SM(EF_CUDA_SM90)"
        /*0a70*/                   HGMMA.64x64x16.F32.BF16 R24, gdesc[UR8], RZ ;
        /*0a80*/                   HGMMA.64x64x16.F32.BF16 R24, gdesc[UR12], R24 ;
                ..........
                Function : {simt}
        /*0000*/                   FFMA R1, R2, R3, R1 ;
""".format(fwd=FWD.format(64), simt=SIMT.format(128))


def test_parse_resource_usage():
    usage = chip_smoke.parse_resource_usage(RESOURCE_USAGE)
    assert usage[FWD.format(64)] == {
        "REG": 154, "STACK": 0, "SHARED": 0, "LOCAL": 0, "CONSTANT[0]": 1008,
        "TEXTURE": 0, "SURFACE": 0, "SAMPLER": 0}
    assert usage[SIMT.format(128)]["STACK"] == 232
    assert usage[SIMT.format(128)]["SHARED"] == 8192


def test_parse_hgmma():
    assert chip_smoke.parse_hgmma(SASS) == {FWD.format(64): 2,
                                            SIMT.format(128): 0}


class CachedLibrary:
    """A library loaded from the build cache: this process ran no nvcc, so
    its build log is empty."""
    name = "flash"
    build_log = ""

    def _target(self):
        return "libflash-cached.so"


def report_of(only=None, drop=(), **changed):
    """A fake cuobjdump report of the flash, LN, CTC and CIF libraries:
    every wgmma kernel at dh 32, 64 and 128 with HGMMA and no spills, two
    LN backward instantiations, the CTC prefix scan, the CTC forward's and
    backward's warp routes and the CIF fire kernel's two load widths
    without spills, a float32 SIMT kernel with a stack frame;
    `changed` applies to the kernels named in `only` (default: every wgmma
    kernel), `drop` leaves kernels out."""
    def report(path):
        assert path == "libflash-cached.so"
        kernels = {}
        for dh in (32, 64, 128):
            for name in (FWD.format(dh), DQ.format(dh), DKV.format(dh)):
                kernels[name] = dict(hgmma=8, registers=150, stack_bytes=0,
                                     local_bytes=0, static_smem_bytes=0)
        for ch in (2, 8):
            kernels[LN_BWD.format(ch)] = dict(
                hgmma=0, registers=112, stack_bytes=0, local_bytes=0,
                static_smem_bytes=17408)
        for name in (PREFIX, BWD_WARP, FWD_WARP, CIF.format(4), CIF.format(1)):
            kernels[name] = dict(hgmma=0, registers=40, stack_bytes=0,
                                 local_bytes=0, static_smem_bytes=0)
        for name in (only if only is not None else
                     [k for k in kernels if "wgmma" in k]):
            kernels[name].update(changed)
        for name in drop:
            del kernels[name]
        kernels[SIMT.format(128)] = dict(hgmma=0, registers=40,
                                         stack_bytes=232, local_bytes=0,
                                         static_smem_bytes=8192)
        return kernels
    return report


@pytest.mark.parametrize("changed,passes", [
    ({}, True),
    ({"stack_bytes": 232}, False),
    ({"local_bytes": 16}, False),
    ({"registers": None}, False),
    ({"hgmma": 0}, False),
])
def test_check_build_reads_the_library_not_the_build_log(changed, passes):
    """A cached library has no build log; check_build reads spills and
    HGMMA from the library itself, so it passes or fails on the kernels
    alone. The float32 SIMT kernel's stack frame is not checked."""
    libs = [CachedLibrary()]
    if passes:
        found = chip_smoke.check_build(libs, report=report_of(**changed))
        assert len(found) == 16
    else:
        with pytest.raises(AssertionError):
            chip_smoke.check_build(libs, report=report_of(**changed))


@pytest.mark.parametrize("only,drop,changed", [
    ([DQ.format(64)], (), {"hgmma": 0}),          # dq without HGMMA at dh 64
    ([DQ.format(128)], (), {"stack_bytes": 232}),  # dq spills at dh 128
    ([DQ.format(32)], (), {"local_bytes": 16}),
    ((), (DQ.format(128),), {}),                  # dq missing a head size
    ([LN_BWD.format(8)], (), {"stack_bytes": 96}),  # the LN backward spills
    ([LN_BWD.format(2)], (), {"registers": None}),
    ((), (LN_BWD.format(2), LN_BWD.format(8)), {}),  # no LN backward kernel
])
def test_check_build_fails_on_a_dq_or_ln_backward_fault(only, drop, changed):
    """The bf16 dq kernel must have HGMMA at every head size and spill
    nothing; every LN backward instantiation must spill nothing."""
    with pytest.raises(AssertionError):
        chip_smoke.check_build([CachedLibrary()],
                               report=report_of(only, drop, **changed))


@pytest.mark.parametrize("only,drop,changed", [
    ([PREFIX], (), {"stack_bytes": 40}),       # the prefix scan spills
    ([PREFIX], (), {"local_bytes": 8}),
    ([BWD_WARP], (), {"stack_bytes": 16}),     # the warp backward spills
    ([BWD_WARP], (), {"registers": None}),
    ((), (PREFIX,), {}),                       # not in the library
    ((), (BWD_WARP,), {}),
    ([FWD_WARP], (), {"stack_bytes": 16}),     # the warp forward spills
    ([FWD_WARP], (), {"local_bytes": 8}),
    ((), (FWD_WARP,), {}),
    ([CIF.format(4)], (), {"stack_bytes": 64}),  # CIF fire, float4 loads
    ([CIF.format(1)], (), {"registers": None}),
    ((), (CIF.format(4), CIF.format(1)), {}),
])
def test_check_build_fails_when_a_ctc_kernel_spills(only, drop, changed):
    """The CTC prefix scan and the CTC forward's and backward's warp routes
    keep their step chains in registers and shared memory, and the CIF
    fire kernel its frames' loads of h in registers: phase 2 fails if any
    spills, or is missing from the built library."""
    with pytest.raises(AssertionError):
        chip_smoke.check_build([CachedLibrary()],
                               report=report_of(only, drop, **changed))


def _globals(source):
    path = os.path.join(REPO, "tpu_asr_torch", "csrc", source)
    with open(path) as f:
        return set(re.findall(r"__global__\s+void\s+(\w+)\s*\(",
                              f.read()))


@pytest.mark.parametrize("symbol,source", [
    (ctc_prefix.KERNEL_SYMBOL, "ctc_prefix_scan.cu"),
    (ctc_prefix.PROBE_SYMBOL, "ctc_prefix_scan.cu"),
    (ctc_loss.FWD_SYMBOLS["block"], "ctc_loss.cu"),
    (ctc_loss.BWD_SYMBOLS["warp"], "ctc_loss.cu"),
    (ctc_loss.BWD_SYMBOLS["block"], "ctc_loss.cu"),
    (ctc_loss.PROBE_SYMBOLS["bwd"], "ctc_loss.cu"),
    (ctc_loss.FWD_SYMBOLS["warp"], "ctc_loss.cu"),
    (ctc_loss.PROBE_SYMBOLS["fwd"], "ctc_loss.cu"),
    (cif_fire.KERNEL_SYMBOL, "cif_fire.cu"),
])
def test_ctc_profiler_symbols_are_kernels_of_their_source(symbol, source):
    """kernel_device_ms matches a kernel by a substring of its name: each
    CTC and CIF symbol chip_smoke passes it is a __global__ of its source,
    and matches no other kernel there (the profiler would add their
    times)."""
    names = _globals(source)
    assert symbol in names
    assert [n for n in names if symbol in n] == [symbol]


@pytest.mark.parametrize("symbol", [ctc_prefix.KERNEL_SYMBOL,
                                    ctc_loss.BWD_SYMBOLS["warp"],
                                    ctc_loss.FWD_SYMBOLS["warp"],
                                    cif_fire.KERNEL_SYMBOL])
def test_rebuilt_ctc_kernels_are_watched_for_spills(symbol):
    assert symbol in chip_smoke.NO_SPILL_KERNELS


@pytest.mark.parametrize("s,route", [
    (1, "warp"), (49, "warp"), (61, "warp"), (63, "warp"), (65, "warp"),
    (127, "warp"), (128, "warp"), (129, "block"), (401, "block"),
    (1023, "block"), (1024, "block"),
])
def test_ctc_bwd_route_by_s(s, route):
    """The CTC backward's route by S, the one launch decision the wrapper
    makes (the kernels' sources work out the rest): the warp route up to
    128 positions (four a lane), the block route above, up to MAX_S."""
    assert ctc_loss.bwd_route(s) == route


@pytest.mark.parametrize("s,route", [
    (1, "warp"), (49, "warp"), (61, "warp"), (63, "warp"), (65, "warp"),
    (127, "warp"), (128, "warp"), (129, "block"), (401, "block"),
    (1023, "block"), (1024, "block"),
])
def test_ctc_fwd_route_by_s(s, route):
    """The CTC forward's route by S: as the backward's, the warp route up
    to 128 positions, the block route above, up to MAX_S."""
    assert ctc_loss.fwd_route(s) == route


def test_training_shapes_take_the_forward_warp_route():
    """Every training lattice (S = 17, 33, 49 or 65; see below) and the
    fixed shape's S = 49 take the forward's warp route too."""
    from tpu_asr_torch.data.bucketing import _round_up
    shapes = {2 * _round_up(u, 8) + 1 for u in range(8, 31)} | {49}
    assert {ctc_loss.fwd_route(s) for s in shapes} == {"warp"}


def test_training_shapes_take_the_warp_route():
    """Training's labels are 8-30 tokens, which the loader's buckets pad
    to U = 8, 16, 24 or 32 (S = 2U + 1 <= 65); the fixed shape's U = 24:
    every one takes the warp route."""
    from tpu_asr_torch.data.bucketing import _round_up
    shapes = {2 * _round_up(u, 8) + 1 for u in range(8, 31)}
    assert shapes == {17, 33, 49, 65}
    assert {ctc_loss.bwd_route(s) for s in shapes | {49}} == {"warp"}


@pytest.mark.parametrize("which", ["fwd", "dq", "dkv"])
def test_flash_symbol_names_the_routed_kernel(which):
    """kernel_device_ms times the kernel the wrapper launches: bf16 on
    wgmma (dq too), float32 on the SIMT kernels."""
    stem = {"fwd": "fwd", "dq": "bwd_dq", "dkv": "bwd_dkv"}[which]
    assert chip_smoke.flash_symbol(which, torch.bfloat16) == \
        f"flash_attention_{stem}_wgmma_kernel"
    assert chip_smoke.flash_symbol(which, torch.float32) == \
        f"flash_attention_{stem}_simt_kernel"


class _Event:
    """One row of a fake trace's key_averages()."""

    def __init__(self, key, count, us):
        from torch.autograd import DeviceType
        self.key, self.count, self.self_device_time_total = key, count, us
        self.device_type = DeviceType.CUDA


def _fake_profiler(monkeypatch, traces):
    """torch.profiler.profile replaced by one that hands out `traces` in
    turn (each a list of _Event), and no CUDA synchronize: what
    kernel_device_ms sees of the profiler, on the CPU."""
    traces = iter(traces)

    class Profile:
        def __init__(self, **_):
            self.events = next(traces)

        def __enter__(self):
            return self

        def __exit__(self, *_):
            return False

        def key_averages(self):
            return self.events
    monkeypatch.setattr(torch.profiler, "profile", Profile)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)


@pytest.mark.parametrize("traces,want,calls", [
    # traced at the second try: 30 of its 40 launches, 60 us in all; a
    # kernel of another name is not counted
    ([[], [_Event("x_kernel_y", 30, 60.0), _Event("other", 5, 1e3)]],
     0.002, 1 + 20 + 40),
    # four empty traces: unknown, not a time of something else
    ([[], [], [], [_Event("other", 160, 1e3)]], None,
     1 + 20 + 40 + 80 + 160),
])
def test_kernel_device_ms_retries_and_never_substitutes(monkeypatch, traces,
                                                        want, calls):
    """kernel_device_ms averages over the launches a trace holds, takes an
    empty trace again with twice the calls, and gives None when four
    traces hold none: never the wrapper's time by CUDA events, which
    includes its other launches."""
    _fake_profiler(monkeypatch, traces)
    made = []
    got = chip_smoke.kernel_device_ms(lambda: made.append(1), "x_kernel")
    assert got == (None if want is None else pytest.approx(want))
    assert len(made) == calls
    assert chip_smoke.ms4(got) == ("not traced" if want is None
                                   else "0.0020")


@pytest.mark.parametrize("empty,ok", [(0, True), (2, True), (3, True),
                                       (4, False)])
def test_device_events_retries_then_fails(monkeypatch, empty, ok):
    """device_events takes a trace without the kernel again with twice
    the calls, up to 4 traces, and returns every device event of the
    first that holds it with its number of calls; 4 such traces fail."""
    found = [_Event("x_kernel_y", 7, 1.0), _Event("Memset", 2, 1.0)]
    traces = [[_Event("other", 3, 1.0)]] * empty + [found]
    _fake_profiler(monkeypatch, traces[:4])
    made = []
    if ok:
        events, calls = chip_smoke.device_events(lambda: made.append(1),
                                                 "x_kernel")
        assert events == {"x_kernel_y": 7, "Memset": 2}
        assert calls == 10 << empty
        assert len(made) == 1 + sum(10 << i for i in range(empty + 1))
    else:
        with pytest.raises(AssertionError):
            chip_smoke.device_events(lambda: made.append(1), "x_kernel")
        assert len(made) == 1 + 10 + 20 + 40 + 80


def _case(lens, tq=5, tk=7, h=2, dh=32, dtype=torch.bfloat16, seed=0):
    rng = np.random.default_rng(seed)
    b = len(lens)
    q = torch.from_numpy(rng.standard_normal((b, tq, h, dh))).to(dtype)
    k = torch.from_numpy(rng.standard_normal((b, tk, h, dh))).to(dtype)
    v = torch.from_numpy(rng.standard_normal((b, tk, h, dh))).to(dtype)
    valid = torch.arange(tk)[None, :] < torch.tensor(lens)[:, None]
    return q, k, v, valid


@pytest.mark.parametrize("which", [None, "dq", "dkv"])
def test_flash_bounds_charge_k_and_v_only_for_valid_keys(which):
    """Masking keys lowers the byte bound by exactly their k and v rows;
    the rows written and q, dO, lse, delta stay charged."""
    q, k, _, full = _case([7, 7, 7])
    _, _, _, ragged = _case([7, 3, 0])

    def bound(valid):
        if which is None:
            return chip_smoke.flash_bound_ms(q, k, valid, False)
        return chip_smoke.flash_bwd_bound_ms(q, k, valid, False, which)
    (hi, by_hi), (lo, by_lo) = bound(full), bound(ragged)
    assert by_hi == by_lo == "bytes"
    masked = 4 + 7             # keys that the ragged mask drops
    saved = 2 * 2 * 2 * 32 * masked / chip_smoke.HBM_BYTES_PER_S * 1e3
    assert hi - lo == pytest.approx(saved, rel=1e-9)


def test_rounding_flips_counts_against_exact_scores():
    """With the plain backward standing in for the kernels, the kernel and
    plain readings agree; flips are counted only where the mask lets a
    term through."""
    q, k, v, valid = _case([7, 4, 0], tq=6, tk=7)
    out, lse = flash_attention_reference(q, k, v, valid)
    dout = torch.from_numpy(np.random.default_rng(1).standard_normal(
        q.shape)).to(q.dtype)
    plain = flash_attention_bwd_reference(q, k, v, out, dout, lse, valid)
    flips = chip_smoke.rounding_flips(q, k, v, out, dout, lse, valid, False,
                                      plain)
    assert flips["terms"] == 6 * 2 * (7 + 4)
    assert 0 <= flips["p_flips"] <= flips["terms"]
    assert 0 <= flips["ds_flips"] <= flips["terms"]
    assert flips["kernel_ulps"] == flips["plain_ulps"]
    assert all(u <= 1.0 for u in flips["plain_ulps"].values())


# ---- phase 10's helpers ----

def test_write_wav_manifest_round_trips(tmp_path):
    from tpu_asr_torch.data import load_manifest
    from tpu_asr_torch.data.synthetic import make_synthetic_dataset
    utts, waves = make_synthetic_dataset(3, 64, seed=0)
    path = chip_smoke.write_wav_manifest(utts, waves, str(tmp_path))
    back = load_manifest(path)
    assert [(u.id, u.tokens) for u in back] == \
        [(u.id, u.tokens) for u in utts]
    for u in back:
        np.testing.assert_array_equal(np.load(u.wav), waves[u.id])
        assert u.num_samples == len(waves[u.id])
        assert u.wav.startswith(str(tmp_path))


def test_run_cli_returns_and_parses_the_summary(capsys):
    def main(argv):
        print("buckets: ...")
        out = {"n_utts": len(argv), "cer": 0.25}
        print(json.dumps(out))
        return out

    got, printed = chip_smoke.run_cli(main, ["a", "b"])
    assert got == printed == {"n_utts": 2, "cer": 0.25}
    assert "buckets" in capsys.readouterr().out       # echoed
    assert chip_smoke.last_json_line('x\n{"a": 1}\n\n') == {"a": 1}
    with pytest.raises(AssertionError):
        chip_smoke.last_json_line("\n  \n")


@pytest.mark.parametrize("got,want,ok", [
    ({"ctc_prefix_scan": 40}, {"ctc_prefix_scan": 40}, True),
    ({}, {}, True),                               # ctc_beam: no kernel
    ({"ctc_prefix_scan": 39}, {"ctc_prefix_scan": 40}, False),
    ({}, {"ctc_prefix_scan": 0}, False),           # a path that never ran
    ({"flash_attention_fwd": 18, "layer_norm_residual_fwd": 30},
     {"flash_attention_fwd": 18}, False),          # an unexpected kernel
])
def test_check_launches(got, want, ok):
    if ok:
        chip_smoke.check_launches("path", got, want)
    else:
        with pytest.raises(AssertionError):
            chip_smoke.check_launches("path", got, want)


def test_count_full_passes_counts_what_the_kernels_launch_for():
    """A use_pallas hybrid_dev forward with >= 512 encoder and decoder
    rows: one flash call per full-pass attention, one fused LN per
    post-norm block, one decoder pass; nothing without use_pallas."""
    import dataclasses
    from tpu_asr_torch.configs.presets import get_preset
    from tpu_asr_torch.models.transformer import Transformer
    rng = np.random.default_rng(0)
    batch = chip_smoke.pallas_train_batch(rng)
    args = [torch.from_numpy(batch[k]) for k in
            ("feats", "feat_lengths", "targets", "target_lengths")]
    for use_pallas in (True, False):
        cfg = dataclasses.replace(get_preset("hybrid_dev").model,
                                  vocab_size=64, use_pallas=use_pallas)
        counts = {"flash_attention_fwd": 0, "layer_norm_residual_fwd": 0,
                  "decoder_passes": 0}
        with chip_smoke.count_full_passes(counts), torch.no_grad():
            Transformer(cfg)(*args)
        n = use_pallas
        assert counts == {"flash_attention_fwd": n * (2 + 2 * 2),
                          "layer_norm_residual_fwd": n * (2 * 2 + 3 * 2),
                          "decoder_passes": 1}
    with torch.no_grad():                         # the hook is gone
        Transformer(cfg)(*args)
    assert counts["decoder_passes"] == 1


def test_wrap_method_calls_around_and_restores():
    class Thing:
        def step(self, x):
            return x + 1

    seen = []
    with chip_smoke.wrap_method(Thing, "step", before=lambda: seen.append(
            "before"), after=seen.append):
        assert Thing().step(1) == 2
    assert seen == ["before", 2]
    assert Thing().step(5) == 6 and seen == ["before", 2]
    assert "step" in vars(Thing)


def test_count_beam_steps_counts_the_steps_the_search_reports():
    """The decoder steps of each beam search a Recognizer runs inside the
    context, as the search reports them (a step replayed from its CUDA
    graph runs no Python method of the decoder); none once it is left."""
    from tpu_asr_torch.decode.beam import BeamConfig
    from tpu_asr_torch.decode.recognizer import Recognizer
    from torch_port_util import torch_cfg, torch_model, wav_batch
    rec = Recognizer(torch_cfg(), torch_model(), mode="joint", device="cpu",
                     beam=BeamConfig(beam=2, max_len=6, ctc_weight=0.3))
    batch = wav_batch([9600, 6400], seed=5)
    steps = [0]
    with chip_smoke.count_beam_steps(steps):
        rec.decode_batch_nbest(batch)
        rec.decode_batch_nbest(batch)
    assert steps[0] == rec.decode_steps > 0
    rec.decode_batch_nbest(batch)
    assert 2 * rec.decode_steps == 3 * steps[0]


def test_record_prefix_inputs_runs_a_graphed_search_again_eagerly(
        monkeypatch):
    """A joint search made with beam graphs (here a stand-in that runs the
    eager step unseen by the recording, as a replay calls no Python
    wrapper, and credits its launches) runs once more eagerly while its
    T' has had fewer than LATER_PREFIX_CALL prefix-scan calls: both labels
    of the T' are kept, the steps counted and the launches left are the
    graphed searches' alone, and the next search at that T' runs once."""
    from tpu_asr_torch.decode import beam
    from tpu_asr_torch.decode import ctc_prefix as scorer_module
    from tpu_asr_torch.decode import recognizer as rec_module
    from tpu_asr_torch.decode.beam import BeamConfig
    from tpu_asr_torch.decode.recognizer import Recognizer
    from torch_port_util import torch_cfg, torch_model, wav_batch
    eager_search, runs = beam.attention_beam_search, []

    def eager(*args, **kwargs):
        out = eager_search(*args, **kwargs)
        ctc_prefix.ctc_prefix_scan.launches += out["steps"]
        runs.append("eager")
        return out

    def graphed(*args, graphs=None, **kwargs):
        assert graphs is not None
        with monkeypatch.context() as m:
            m.setattr(scorer_module, "ctc_prefix_scan",
                      ctc_prefix.ctc_prefix_scan)
            out = eager_search(*args, **kwargs)
        ctc_prefix.ctc_prefix_scan.launches += out["steps"]
        runs.append("graphed")
        return dict(out, graph_steps=out["steps"])

    class Graphs:
        def ctc_logp_buffer(self, shape, device):
            return torch.empty(shape, device=device)
    monkeypatch.setattr(beam, "attention_beam_search", eager)
    monkeypatch.setattr(rec_module, "attention_beam_search", graphed)
    monkeypatch.setattr(ctc_prefix.ctc_prefix_scan, "launches", 0)
    rec = Recognizer(torch_cfg(), torch_model(), mode="joint", device="cpu",
                     beam=BeamConfig(beam=2, max_len=12, ctc_weight=0.3,
                                     minlenratio=1.0))
    rec.beam_graphs = Graphs()
    batch = wav_batch([9600, 6400], seed=5)
    caps, steps = {}, [0]
    labels = chip_smoke.PathLabels("p")
    with chip_smoke.count_beam_steps(steps), \
            chip_smoke.record_prefix_inputs(caps, labels):
        rec.decode_batch_nbest(batch)
        rec.decode_batch_nbest(batch)
    assert runs == ["graphed", "eager", "graphed"]
    assert steps[0] == rec.decode_steps == rec.graph_steps >= 20
    assert ctc_prefix.ctc_prefix_scan.launches == rec.decode_steps
    (t,) = labels.calls
    assert sorted(caps) == [f"p T'={t} call 1",
                            f"p T'={t} call {chip_smoke.LATER_PREFIX_CALL}"]
    chip_smoke.check_prefix_labels(caps, "p")
    assert rec_module.attention_beam_search is graphed        # restored


@pytest.mark.parametrize("kept,ok", [
    ((), True),
    (("p T'=7 call 1", "p T'=7 call 10", "p T'=9 call 1",
      "p T'=9 call 10"), True),
    (("p T'=7 call 1",), False),
    (("p T'=7 call 1", "p T'=7 call 10", "p T'=9 call 1"), False)])
def test_check_prefix_labels_wants_both_calls_at_each_t(kept, ok):
    """A T' whose later prefix-scan call was not kept fails the check."""
    caps = {label: () for label in kept}
    if ok:
        chip_smoke.check_prefix_labels(caps, "p")
    else:
        with pytest.raises(AssertionError, match="T'=9|T'=7"):
            chip_smoke.check_prefix_labels(caps, "p")


def test_path_labels_name_each_kind_once_per_bucket():
    """The kernel calls of two attn_rescore batches (encoder T' 62 and
    30; 2 encoder and 2 decoder blocks, as a use_pallas model makes them)
    recorded under PathLabels: one capture per flash kind and per LN part
    at each T'; the prefix-scan labels keep the first and the
    LATER_PREFIX_CALL-th call of each T'."""
    class Ops:
        @staticmethod
        def flash(q, k, v, valid, causal):
            return q

        @staticmethod
        def ln(r, h, g, b, eps):
            return r

    def batch(t, b=4, u=9):
        z = torch.zeros
        for _ in range(2):                         # encoder blocks
            Ops.flash(z(b, t, 2, 8), z(b, t, 2, 8), None, None, False)
            Ops.ln(z(b, t, 16), None, None, None, 1e-5)
            Ops.ln(z(b, t, 16), None, None, None, 1e-5)
        for _ in range(2):                         # decoder blocks
            Ops.flash(z(b, u, 2, 8), z(b, u, 2, 8), None, None, True)
            Ops.ln(z(b, u, 16), None, None, None, 1e-5)
            Ops.flash(z(b, u, 2, 8), z(b, t, 2, 8), None, None, False)
            Ops.ln(z(b, u, 16), None, None, None, 1e-5)
            Ops.ln(z(b, u, 16), None, None, None, 1e-5)

    labels = chip_smoke.PathLabels("LM path")
    flash_caps, ln_caps = {}, {}
    with chip_smoke.record_inputs(Ops, "flash", flash_caps, labels.flash), \
            chip_smoke.record_inputs(Ops, "ln", ln_caps, labels.ln):
        batch(62)
        batch(30)
    kinds = ("encoder self-attention", "decoder self-attention (causal)",
             "decoder cross-attention")
    assert sorted(flash_caps) == sorted(f"LM path T'={t} {kind}"
                                        for t in (62, 30) for kind in kinds)
    assert sorted(ln_caps) == sorted(f"LM path T'={t} {part} LN"
                                     for t in (62, 30)
                                     for part in ("encoder", "decoder"))
    for t in (62, 30):
        assert ln_caps[f"LM path T'={t} encoder LN"][0].shape[1] == t
        assert ln_caps[f"LM path T'={t} decoder LN"][0].shape[1] == 9
        q, k = flash_caps[f"LM path T'={t} decoder cross-attention"][:2]
        assert (q.shape[1], k.shape[1]) == (9, t)
    assert "flash" in vars(Ops) and "ln" in vars(Ops)     # restored

    plain = chip_smoke.PathLabels()
    x = torch.zeros(2, 7, 3)
    got = [plain.prefix(x) for _ in range(chip_smoke.LATER_PREFIX_CALL)]
    assert got[0] == "T'=7 call 1"
    assert got[-1] == f"T'=7 call {chip_smoke.LATER_PREFIX_CALL}"
    assert got[1:-1] == [None] * (chip_smoke.LATER_PREFIX_CALL - 2)
    assert plain.prefix(torch.zeros(2, 9, 3)) == "T'=9 call 1"


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_lm_cv_floor_is_the_length_aware_uniform_model(seed):
    """lm_cv_floor equals the mean loss, scored target by target, of the
    model that knows the set's own length distribution and draws tokens
    uniformly; it lies under ln V, and with one length eos is free."""
    import math
    rng = np.random.default_rng(seed)
    seqs = [[2] * int(rng.integers(8, 31)) for _ in range(51)]
    lens = np.array([len(x) for x in seqs])
    total = 0.0
    for n in lens:
        for k in range(n + 1):
            hazard = (lens == k).sum() / (lens >= k).sum()
            total += (-math.log(hazard) if k == n else
                      math.log(4229) - math.log1p(-hazard))
    want = total / (lens + 1).sum()
    got = chip_smoke.lm_cv_floor(seqs, 4229)
    assert got == pytest.approx(want, rel=1e-12)
    assert got < math.log(4229) < math.log(4233)
    assert chip_smoke.lm_cv_floor([[5] * 12] * 4, 4229) == \
        pytest.approx(12 * math.log(4229) / 13, rel=1e-12)


# ---- phase 11's helpers ----

def _small_aishell(n=20):
    """synthetic_aishell's corpus (8-30 tokens of 320 ms over 4233
    tokens, a tenth for cv) at `n` utterances."""
    from tpu_asr_torch.data.synthetic import make_synthetic_dataset
    utts, waves = make_synthetic_dataset(n, 4233, min_tokens=8,
                                         max_tokens=30, tone_ms=320,
                                         seed=chip_smoke.SEED)
    return utts[n // 10:], utts[:n // 10], "wav", waves


def test_write_kaldi_split_round_trips(tmp_path):
    """The .wav files read back as the waves at RECIPE_GAIN within one
    16-bit step; wav.scp and text list the utterances in order, each
    token t as chr(RECIPE_CHAR0 + t)."""
    from tpu_asr_torch.data.audio import read_wav
    train, _, _, waves = _small_aishell(6)
    scp, text = chip_smoke.write_kaldi_split(str(tmp_path), "train", train,
                                             waves)
    with open(scp) as f:
        scp_lines = [x.split() for x in f.read().splitlines()]
    with open(text, encoding="utf-8") as f:
        text_lines = [x.split() for x in f.read().splitlines()]
    assert [x[0] for x in scp_lines] == [u.id for u in train]
    assert text_lines == [[u.id, "".join(chr(chip_smoke.RECIPE_CHAR0 + t)
                                         for t in u.tokens)] for u in train]
    for (_, path), u in zip(scp_lines, train):
        back = read_wav(path)
        assert back.shape == waves[u.id].shape
        np.testing.assert_allclose(back, waves[u.id] * chip_smoke.RECIPE_GAIN,
                                   atol=1.0 / 32768)


def test_prepare_recipe_data_runs_the_recipes_stage_1(tmp_path):
    """prepare_data on the Kaldi splits, as egs/aishell/run.sh: the dict
    from the train text (its characters, sorted, between the specials),
    train tokens through it, dev tokens through it or <unk>."""
    from tpu_asr_torch.data import load_manifest
    from tpu_asr_torch.utils.vocab import Vocab
    data = _small_aishell()
    train_m, dev_m, dict_path, dev = chip_smoke.prepare_recipe_data(
        str(tmp_path), data)
    vocab = Vocab.load(dict_path)
    chars = sorted({chr(chip_smoke.RECIPE_CHAR0 + t) for u in data[0]
                    for t in u.tokens})
    assert vocab.tokens == ["<blank>", "<unk>"] + chars + ["<sos>", "<eos>"]
    train = load_manifest(train_m)
    assert [u.id for u in train] == [u.id for u in data[0]]
    assert [u.tokens for u in train] == [
        [vocab.tokens.index(chr(chip_smoke.RECIPE_CHAR0 + t))
         for t in u.tokens] for u in data[0]]
    assert [u.id for u in load_manifest(dev_m)] == [u.id for u in dev] == \
        [u.id for u in data[1]]
    assert all(u.wav.endswith(".wav") and os.path.exists(u.wav)
               for u in dev)


@pytest.mark.parametrize("shift,ok", [(0.0, True), (2.5e-5, True),
                                      (1.5e-4, False)])
def test_recipe_cmvn_holds_the_card_to_the_cpu(tmp_path, monkeypatch, shift,
                                               ok):
    """recipe_cmvn with compute_cmvn run on the CPU in place of the card,
    the "card's" mean shifted by `shift`: within atol 5e-5 it passes and
    writes the stats, past it the phase fails."""
    from tpu_asr_torch import compute_cmvn, prepare_data
    manifest = str(tmp_path / "all.jsonl")
    prepare_data.main(["--synthetic", "4", "--vocab-size", "16", "--out",
                       manifest])
    real = compute_cmvn.main

    def on_cpu(argv):
        argv = list(argv)
        if "--device" not in argv:
            argv += ["--device", chip_smoke.DEVICE]
        card = argv[argv.index("--device") + 1] != "cpu"
        argv[argv.index("--device") + 1] = "cpu"
        out = real(argv)
        return dict(out, mean=out["mean"] + shift) if card else out
    monkeypatch.setattr(compute_cmvn, "main", on_cpu)
    if ok:
        stats = chip_smoke.recipe_cmvn("cpu", str(tmp_path), manifest)
        with np.load(stats) as z:
            assert int(z["frames"]) > 0
    else:
        with pytest.raises(AssertionError, match="differ"):
            chip_smoke.recipe_cmvn("cpu", str(tmp_path), manifest)


def test_post_recognize_answers_through_http():
    """The one POST of phases 6, 10 and 11, against a CPU server."""
    from tpu_asr_torch.configs.presets import get_preset
    from tpu_asr_torch.decode.beam import BeamConfig
    from tpu_asr_torch.decode.recognizer import Recognizer
    from tpu_asr_torch.models.transformer import Transformer
    from tpu_asr_torch.serve import AsrServer
    from tpu_asr_torch.weights import init_random
    cfg = dataclasses.replace(get_preset("conformer_dev").model,
                              vocab_size=16)
    rec = Recognizer(cfg, init_random(Transformer(cfg), 0), mode="joint",
                     device="cpu", beam=BeamConfig(beam=2, max_len=4,
                                                   nbest=2))
    server = AsrServer(rec, bucket_frames=(128,), batch_size=2,
                       device="cpu")
    wav = np.random.default_rng(0).standard_normal(8000).astype(np.float32)
    server.start()
    try:
        status, body = chip_smoke.post_recognize(server, wav)
        want = server.submit("wav", wav)
    finally:
        server.stop()
    assert status == 200
    assert body["tokens"] == want[0]["yseq"]


# ---- phase 12: the transducer family ----

def test_transducer_loss_label_keeps_a_train_step_not_a_cv_batch():
    """record_inputs with transducer_loss_label keeps the inputs of the
    first call under autograd only (a train step, not a cv batch), and
    the loss the model sees is unchanged."""
    from tpu_asr_torch.models import transducer as module
    from tpu_asr_torch.ops.transducer import transducer_loss
    rng = np.random.default_rng(1)
    args = [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
            for s in ((2, 4, 3), (2, 3, 3), (3, 5), (5,))]
    args += [torch.tensor([[1, 2], [3, 0]]), torch.tensor([4, 2]),
             torch.tensor([2, 1])]
    want = transducer_loss(*args, reduction="none")
    caps = {}
    with chip_smoke.record_inputs(module, "transducer_loss", caps,
                                  chip_smoke.transducer_loss_label):
        with torch.no_grad():
            module.transducer_loss(*args, reduction="none")
        assert caps == {}
        got = module.transducer_loss(*args, reduction="none")
        module.transducer_loss(*[a + 1 if a.is_floating_point() else a
                                 for a in args], reduction="none")
    assert torch.equal(got, want)
    assert list(caps) == ["transducer training"]
    assert all(torch.equal(a, b) for a, b in zip(caps["transducer training"],
                                                 args))
    assert module.transducer_loss is transducer_loss      # restored


@pytest.mark.parametrize("card_times,cpu_times,ok", [
    ([0, 0, 3, 5], [0, 0, 3, 5], True),
    ([], [], True),
    ([0, 3, 2], [0, 3, 2], False),                # out of order
    ([0, 1, 99], [0, 1, 99], False),              # past the encoder length
    ([0, 1, 2], [0, 1, 3], False),                # card != CPU
])
def test_check_greedy_times(card_times, cpu_times, ok):
    from tpu_asr_torch.configs.presets import get_preset
    cfg = get_preset("transducer_dev").model
    lens = np.array([16000, 0])                   # 98 frames, 23 encoder
    card = [[{"times": card_times}], [{"times": []}]]
    cpu = [[{"times": cpu_times}], [{"times": []}]]
    assert cfg.subsampled_length(98) == 23
    if ok:
        chip_smoke.check_greedy_times(card, cpu, lens, cfg, "t")
    else:
        with pytest.raises(AssertionError):
            chip_smoke.check_greedy_times(card, cpu, lens, cfg, "t")


def test_transducer_decodes_cover_the_three_modes_and_the_lm():
    """Phase 12 decodes through recognize in the three modes, the beam
    also with the LM (weight 0.3), rescore at the preset's beam 10 and
    ctc weight 0.5; the modes parse."""
    from tpu_asr_torch.configs.presets import get_preset
    from tpu_asr_torch.recognize import parse_args
    modes = [parse_args(["--ckpt", "c", "--manifest", "m"] + [
        "x" if a == "LM" else a for a in flags]).mode
        for _, flags in chip_smoke.TRANSDUCER_DECODES]
    assert modes == ["transducer_greedy", "transducer_beam",
                     "transducer_beam", "transducer_rescore"]
    flags = dict(chip_smoke.TRANSDUCER_DECODES)
    assert flags["transducer_beam_lm"][-2:] == ["--lm-weight", "0.3"]
    rescore = parse_args(["--ckpt", "c", "--manifest", "m"]
                         + flags["transducer_rescore"])
    beam = get_preset("transducer").beam
    assert (rescore.beam, rescore.ctc_weight) == (beam.beam, beam.ctc_weight)
    assert [p for p, _ in chip_smoke.TRANSDUCER_AGREEMENT] == [
        "transducer_dev", "conformer_transducer_dev",
        "conformer_transducer_dev"]


def test_time_transducer_lattice_counts_what_it_times(monkeypatch):
    """On the CPU with the CUDA timers stubbed: the loss, the lattice
    alone and the materialized logits each run; the shares divide by the
    step's device time."""
    from tpu_asr_torch.ops import transducer as tt

    class Event:
        def record(self):
            pass

        def synchronize(self):
            pass

        def elapsed_time(self, other):
            return 1.0

    monkeypatch.setattr(torch.cuda, "Event", lambda **kw: Event())
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    for name in ("reset_peak_memory_stats", "max_memory_allocated",
                 "memory_allocated"):
        monkeypatch.setattr(torch.cuda, name, lambda *a: 0)
    calls = []
    monkeypatch.setattr(chip_smoke, "profile_device", lambda fn, what, card: (
        calls.append(what), fn(), {"device_ms": 2.0, "wall_ms": 4.0,
                                   "device_events": 7})[2])
    rng = np.random.default_rng(0)
    b, t, u1, v, h = 2, 5, 3, 7, 4
    args = (torch.from_numpy(rng.standard_normal((b, t, h)).astype(
        np.float32)), torch.from_numpy(rng.standard_normal((b, u1, h)).astype(
            np.float32)), torch.randn(h, v), torch.zeros(v),
        torch.tensor([[1, 2], [3, 4]]), torch.tensor([5, 3]),
        torch.tensor([2, 1]))
    out = chip_smoke.time_transducer_lattice("card", args, 8.0)
    assert calls == ["transducer lattice fwd+bwd (B=2 T'=5 U+1=3 V=7 "
                     "d_joint=4)"] and out["lattice_share_of_step"] == 0.25
    assert out["loss_ms"] == 1.0 and "loss_device_ms" not in out
    assert out["shape"] == "B=2 T'=5 U+1=3 V=7 d_joint=4"
    assert tt.JOINT_CHUNK_BYTES > 0


# ---- phase 17's helpers ----

@pytest.mark.parametrize("fault", [None, "twice a layer", "an eager step"])
def test_whisper_serving_counts_the_encoders_flash_launches(monkeypatch,
                                                            fault):
    """Phase 17's serving on the CPU at whisper_dev's size, with the card's
    parts stood in for: the flash forward (counting its launches as the
    wrapper does, on the plain version), the graphed beam (crediting every
    step as replayed) and the profiler (counting the launches it saw). The
    launches equal one an encoder layer a batch in both runs, the
    encoder's first call is kept, and a second launch a layer or a step
    left eager fails the phase."""
    from tpu_asr_torch.configs import presets
    from tpu_asr_torch.decode import recognizer as rec_module
    from tpu_asr_torch.models import attention
    from tpu_asr_torch.ops import flash_attention as fa
    search = rec_module.attention_beam_search
    dev = presets.PRESETS["whisper_dev"]       # as large-v3: flash attention
    monkeypatch.setitem(presets.PRESETS, "whisper_dev", dataclasses.replace(
        dev, model=dataclasses.replace(dev.model, use_pallas=True)))

    def fwd(q, k, v, valid, causal=False):
        fa.flash_attention_fwd.launches += 2 if fault == "twice a layer" \
            else 1
        return flash_attention_reference(q, k, v, valid, causal)

    def flash(q, k, v, bias=None):
        assert bias is None                      # Whisper's encoder: no mask
        valid = torch.ones(k.shape[:2], dtype=torch.bool)
        return fa.flash_attention_fwd(q, k, v, valid, False)[0]

    def graphed(*args, **kwargs):
        out = search(*args, **kwargs)
        return out if fault == "an eager step" else dict(
            out, graph_steps=out["steps"])

    def profile_serving(server, wavs, card, what, threads):
        n = fa.flash_attention_fwd.launches
        chip_smoke.serve_requests(server, wavs, 1)      # a batch a request
        symbol = chip_smoke.flash_symbol("fwd", server.rec.cfg.dtype)
        return {"kernels": {symbol: fa.flash_attention_fwd.launches - n}}

    fwd.launches = 0
    monkeypatch.setattr(fa, "flash_attention_fwd", fwd)
    monkeypatch.setattr(attention, "flash_attention", flash)
    monkeypatch.setattr(rec_module, "attention_beam_search", graphed)
    monkeypatch.setattr(chip_smoke, "profile_serving", profile_serving)
    for name, value in (("DEVICE", "cpu"), ("WHISPER_PRESET", "whisper_dev"),
                        ("WHISPER_BATCH", 4), ("WHISPER_BUCKET", 100),
                        ("WHISPER_MAXLENRATIO", 0.25)):
        monkeypatch.setattr(chip_smoke, name, value)
    monkeypatch.setattr(chip_smoke, "request_lengths",
                        lambda n, seed: [160 * f for f in (100, 70, 41, 96)])
    for name in ("synchronize", "empty_cache"):
        monkeypatch.setattr(torch.cuda, name, lambda *a: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda *a: 0)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    caps = {}
    if fault:
        with pytest.raises(AssertionError, match="flash launches"):
            chip_smoke.run_whisper_serving("card", caps)
        return
    out = chip_smoke.run_whisper_serving("card", caps)
    assert out["per_batch"] == 2 and 1 <= out["batches"] <= 4
    assert out["launches"] == 2 * out["batches"]      # of the first run
    assert list(caps) == [f"{chip_smoke.WHISPER_PATH} T'=50 encoder "
                          f"self-attention"]
    q, k, v, valid, causal = caps[list(caps)[0]]
    assert q.shape == (4, 50, 2, 32) and valid.all() and not causal


@pytest.mark.parametrize("n_tokens,ok", [(0, True), (6, True), (7, False)])
def test_check_whisper_answers_holds_each_1best_to_its_cap(n_tokens, ok):
    """0.0625 x the speech encoder frames of 1000 mel frames (500) caps a
    1-best at 31 tokens; of 200 frames (100), at 6."""
    from tpu_asr_torch.configs.presets import get_preset
    cfg = get_preset("whisper_large_v3").model
    wavs = [np.zeros(160 * 1000, np.float32), np.zeros(160 * 200,
                                                       np.float32)]
    results = [([{"yseq": [5] * 31}], 0.1), ([{"yseq": [7] * n_tokens}],
                                              0.1)]
    if ok:
        chip_smoke.check_whisper_answers(cfg, wavs, results)
    else:
        with pytest.raises(AssertionError, match="cap 6"):
            chip_smoke.check_whisper_answers(cfg, wavs, results)


# ---- phase 13's helpers ----

def test_latency_summary():
    got = chip_smoke.latency_summary([0.004, 0.002, 0.010])
    assert got == {"n": 3, "p50_ms": 4.0, "max_ms": 10.0}
    assert chip_smoke.latency_summary([]) == {"n": 0, "p50_ms": None,
                                              "max_ms": None}


def test_top2_margins_names_the_frames_that_differ():
    logits = torch.tensor([[0.0, 3.0, 1.0], [2.0, 1.99, 0.0],
                           [5.0, 0.0, 0.0]])
    got = chip_smoke.top2_margins(logits, [1, 1, 0])
    assert [(f, round(m, 4)) for f, m in got] == [(1, 0.01)]
    assert chip_smoke.top2_margins(logits, [1, 0, 0]) == []


def _hyp(yseq, times=None, conf=None):
    out = {"yseq": yseq, "score": 0.0}
    if times is not None:
        out.update(times=times, confidence=conf)
    return out


def test_compare_streamed_drops_eos_and_holds_times_and_confidences():
    eos = 9
    streamed = {"a": ([3, eos, 4], [1, 2, 5], [0.5, 0.9, 0.25]),
                "b": ([], [], [])}
    offline = {"a": _hyp([3, 4], [1, 5], [0.50004, 0.25]),
               "b": _hyp([], [], [])}
    got = chip_smoke.compare_streamed("x", streamed, offline, eos)
    assert got["n_utts"] == 2 and got["n_tokens"] == 2 and not got["ties"]
    assert got["max_conf_gap"] == pytest.approx(4e-5)
    for bad in ({"a": _hyp([3, 5], [1, 5], [0.5, 0.25])},    # a token
                {"a": _hyp([3, 4], [1, 6], [0.5, 0.25])},    # a time
                {"a": _hyp([3, 4], [1, 5], [0.6, 0.25])}):   # a confidence
        with pytest.raises(AssertionError):
            chip_smoke.compare_streamed("x", {"a": streamed["a"]}, bad, eos)
    beams = {"a": ([3, eos, 4], None, None)}
    assert chip_smoke.compare_streamed("x", beams, {"a": _hyp([3, 4])},
                                       eos)["n_tokens"] == 2


@pytest.mark.parametrize("offline_conf,ok", [(0.9007, True), (0.9006, False)])
def test_compare_streamed_holds_rounded_confidences_to_one_step(
        offline_conf, ok):
    """Confidences rounded to 4 places on both sides: one step (1e-4) is
    within STREAM_CONF_TOL although 0.9008 - 0.9007 > 1e-4 in floats;
    two steps are not."""
    assert 0.9008 - 0.9007 > chip_smoke.STREAM_CONF_TOL
    streamed = {"a": ([3], [1], [0.9008])}
    offline = {"a": _hyp([3], [1], [offline_conf])}
    if ok:
        got = chip_smoke.compare_streamed("x", streamed, offline, 0)
        assert got["max_conf_gap"] == pytest.approx(1e-4)
    else:
        with pytest.raises(AssertionError, match="confidence gap"):
            chip_smoke.compare_streamed("x", streamed, offline, 0)


@pytest.mark.parametrize("margin,ok", [(5e-5, True), (1e-3, False)])
def test_compare_streamed_reports_a_rounding_tie(margin, ok):
    """A differing utterance passes only when every differing frame's
    offline top-2 margin is a rounding tie (<= STREAM_TIE_MARGIN)."""
    streamed = {"a": ([3, 4], [1, 5], [0.5, 0.25])}
    offline = {"a": _hyp([3, 7], [1, 5], [0.5, 0.25])}
    margins = lambda uid: [(5, margin)]        # noqa: E731
    if ok:
        got = chip_smoke.compare_streamed("x", streamed, offline, 0, margins)
        assert got["ties"] == {"a": [(5, margin)]}
    else:
        with pytest.raises(AssertionError, match="margins"):
            chip_smoke.compare_streamed("x", streamed, offline, 0, margins)


@pytest.mark.parametrize("margin", [1.5e-5, 5e-4])
def test_compare_streamed_holds_the_beams_1best_and_reports_the_parting(
        margin):
    """The streamed beam's check: a differing 1-best passes as a tie
    only when the two searches part at a margin within STREAM_TIE_MARGIN
    (1.5e-5, as a trained checkpoint parted on the card), else it fails
    and the failure reports where they part; an equal 1-best has no
    tie."""
    streamed = {"a": ([3, 4], None, None)}
    offline = {"a": _hyp([3, 7])}
    margins = lambda uid: [(12, margin)]       # noqa: E731
    if margin <= chip_smoke.STREAM_TIE_MARGIN:
        got = chip_smoke.compare_streamed("x", streamed, offline, 0, margins)
        assert got["ties"] == {"a": [(12, margin)]}
    else:
        with pytest.raises(AssertionError, match=f"margins.*12, {margin}"):
            chip_smoke.compare_streamed("x", streamed, offline, 0, margins)
    assert chip_smoke.compare_streamed("x", streamed, {"a": _hyp([3, 4])}, 0,
                                       margins)["ties"] == {}


def test_stream_pushes_covers_the_features_once():
    class Rec:
        def __init__(self):
            self.seen = []

        def push(self, x):
            self.seen.append(len(x))
            return [len(self.seen)]

        def finish(self):
            return [0]

    rec = Rec()
    outs, hyp, waits = chip_smoke.stream_pushes(rec, np.zeros((150, 2)), 64)
    assert rec.seen == [64, 64, 22] and outs == [[1], [2], [3]]
    assert hyp == [0] and len(waits) == 3


def _tiny_ctc(chunk=4):
    from tpu_asr_torch.configs.presets import get_preset
    from tpu_asr_torch.models import build_model
    from tpu_asr_torch.weights import init_random
    cfg = dataclasses.replace(get_preset("hybrid_dev").model, vocab_size=24,
                              model_type="ctc", enc_chunk_size=chunk)
    return cfg, init_random(build_model(cfg), 0)


def test_beam_divergence_finds_the_frame_and_its_margin():
    gen = torch.Generator().manual_seed(0)
    logp = torch.log_softmax(torch.randn(1, 12, 24, generator=gen), -1)
    assert chip_smoke.beam_divergence(logp, logp.clone(), 12, 3) is None
    other = logp.clone()
    other[0, 6] = torch.log_softmax(torch.randn(24, generator=gen), -1)
    frame, margin = chip_smoke.beam_divergence(logp, other, 12, 3)
    assert frame == 6 and margin > 0


def test_beam_composition_and_scores_on_streamed_frames(monkeypatch):
    """On the CPU: the streaming beam's frames (recorded from
    encode_chunk) searched in one call give its 1-best and score
    exactly; check_beam_scores passes equal scores and fails a gap
    without a pruning tie."""
    from tpu_asr_torch.decode.ctc_beam import beam_finalize
    from tpu_asr_torch.decode.streaming import StreamingCTCBeamRecognizer
    monkeypatch.setattr(chip_smoke, "DEVICE", "cpu")
    monkeypatch.setattr(chip_smoke, "STREAM_BEAM", 3)
    cfg, model = _tiny_ctc()
    x = (np.random.default_rng(1).standard_normal((90, 80)) * 3).astype(
        np.float32)
    rows = []
    with chip_smoke.wrap_method(model.encoder, "encode_chunk",
                                after=lambda out: rows.append(out[0][0])):
        rec = StreamingCTCBeamRecognizer(cfg, model, beam=3, max_frames=128,
                                         device="cpu")
        _, hyp, _ = chip_smoke.stream_pushes(rec, x, 37)
    score = float(beam_finalize(rec._bstate)[2][0, 0])
    frames = {"a": torch.cat(rows)}
    el = cfg.subsampled_length(90)
    gap = chip_smoke.check_beam_composition(
        "t", model, frames, {"a": el}, {"a": (hyp, None, None)},
        {"a": score})
    assert gap == 0.0 and hyp
    # a tie outside the first STREAM_COMPOSE_UTTS is held as well
    monkeypatch.setattr(chip_smoke, "STREAM_COMPOSE_UTTS", 0)
    with pytest.raises(AssertionError, match="in one call"):
        chip_smoke.check_beam_composition(
            "t", model, frames, {"a": el}, {"a": (hyp + [1], None, None)},
            {"a": score}, also={"a": [(3, 0.0)]})
    feats = {"a": x}
    assert chip_smoke.check_beam_scores("t", model, feats, frames,
                                        {"a": score}, {"a": score}) == (0.0,
                                                                        {})
    with pytest.raises(AssertionError, match="part at None"):
        chip_smoke.check_beam_scores("t", model, feats, frames,
                                     {"a": score}, {"a": score - 0.5})


def test_streaming_agreement_covers_the_four_recognizers():
    from tpu_asr_torch.decode import streaming
    classes = {cls for _, _, cls, _ in chip_smoke.STREAMING_AGREEMENT}
    assert classes == {"StreamingCTCRecognizer", "StreamingCTCBeamRecognizer",
                       "StreamingCIFRecognizer",
                       "StreamingTransducerRecognizer"}
    assert all(hasattr(streaming, c) for c in classes)
    kinds = {(p, kw.get("incremental", True))
             for _, p, c, kw in chip_smoke.STREAMING_AGREEMENT
             if c == "StreamingCIFRecognizer"}
    assert kinds == {("cif_dev", True), ("cif_dev", False)}


# ---- phase 15: data- and tensor-parallel training and decode ----

def _metrics(loss=4.0, att=3.0, ctc=6.0, norm=10.0):
    return {"loss": loss, "loss_att": att, "loss_ctc": ctc, "acc": 0.1,
            "grad_norm": norm}


@pytest.mark.parametrize("got,ok", [
    (_metrics(), True),
    (_metrics(loss=4.0099, ctc=5.991), True),
    (_metrics(norm=10.049), True),
    (_metrics(att=3.011), False),                 # a loss 0.011 off
    (_metrics(norm=10.051), False),               # grad norm 0.51% off
    (_metrics(loss=float("nan")), False),
])
def test_parallel_step_held_to_the_bf16_bounds(got, ok):
    """A step against the 1-process step within tests/test_torch_bf16.py's
    bounds (each loss within +0.01, the grad norm within 0.5%), as
    compare_parallel_step holds it to any bounds it is given."""
    bounds = {"loss_atol": 0.01, "grad_norm_rtol": 0.005, "grad_rtol": 0.0}
    if ok:
        gaps = chip_smoke.compare_parallel_step("t", got, _metrics(), bounds)
        assert set(gaps) == {"loss", "loss_att", "loss_ctc", "grad_norm_rel"}
    else:
        with pytest.raises(AssertionError):
            chip_smoke.compare_parallel_step("t", got, _metrics(), bounds)


def _gap(x):
    return {"max": x, "worst": "w"}


@pytest.mark.parametrize("got,grad_gap,ok", [
    (_metrics(loss=4.0009), _gap(0.0), True),
    (_metrics(norm=10.009), _gap(0.0), True),
    (_metrics(), _gap(chip_smoke.PARALLEL_BOUNDS["dp"]["grad_rtol"]), True),
    (_metrics(ctc=6.0011), _gap(0.0), False),     # a loss 1.1e-3 off
    (_metrics(norm=10.011), _gap(0.0), False),    # grad norm 0.11% off
    (_metrics(), _gap(1.01 * chip_smoke.PARALLEL_BOUNDS["dp"]["grad_rtol"]),
     False),                                      # a gradient off
])
def test_dp_step_held_to_its_bounds(got, grad_gap, ok):
    """The dp 2 step: each loss within 1e-3, the grad norm within 1e-3
    relative, every gradient within the gradient bound; the gaps name the
    gradient farthest off."""
    bounds = chip_smoke.PARALLEL_BOUNDS["dp"]
    if ok:
        gaps = chip_smoke.compare_parallel_step("t", got, _metrics(), bounds,
                                                grad_gap)
        assert gaps["grad_worst"] == "w"
    else:
        with pytest.raises(AssertionError):
            chip_smoke.compare_parallel_step("t", got, _metrics(), bounds,
                                             grad_gap)


def test_tp_bounds_keep_the_bf16_bounds_and_catch_an_unsummed_slice():
    """tp keeps tests/test_torch_bf16.py's loss and norm bounds; its
    gradient bound lies between run 15-7's reading (8.1e-2) and the
    unsummed sliced gradients' (0.74), and the error names the bound."""
    bounds = chip_smoke.PARALLEL_BOUNDS["tp"]
    assert (bounds["loss_atol"], bounds["grad_norm_rtol"]) == (0.01, 0.005)
    assert 8.1e-2 < bounds["grad_rtol"] < 0.74
    chip_smoke.compare_parallel_step("t", _metrics(), _metrics(), bounds,
                                     _gap(8.1e-2))
    with pytest.raises(AssertionError, match=r"exceed \['grad_rtol'\]"):
        chip_smoke.compare_parallel_step("t", _metrics(), _metrics(), bounds,
                                         _gap(0.74))


def test_faults_are_injected_into_the_train_step(monkeypatch):
    """inject_fault breaks the step as PARALLEL_FAULTS says: no sliced
    parameters to sum, or counts taken from the rank's own shard times
    the data axis's size (a mean taken a shard)."""
    from tpu_asr_torch.parallel.mesh import Axis, Mesh
    from tpu_asr_torch.train import loop
    monkeypatch.setattr(loop, "sliced_params", loop.sliced_params)
    monkeypatch.setattr(loop.TrainStep, "__call__", loop.TrainStep.__call__)
    assert set(chip_smoke.PARALLEL_FAULTS) == {"mean_a_shard",
                                               "no_sliced_sum"}
    chip_smoke.inject_fault("no_sliced_sum")
    assert loop.sliced_params(None) == set()
    seen = {}

    def fake_call(self, batch):
        seen["counts"] = loop.global_counts(batch, loop.FrontendConfig(),
                                            torch.device("cpu"))[1]
    monkeypatch.setattr(loop.TrainStep, "__call__", fake_call)
    chip_smoke.inject_fault("mean_a_shard")
    step = loop.TrainStep.__new__(loop.TrainStep)
    step.mesh = Mesh(2, 1, 1, Axis(None, 2, 1), Axis(None, 1, 0))
    batch = chip_smoke.parallel_batch(b=8, t=64, u=5)
    step(batch)
    real = int((batch["feat_lengths"][4:] > 0).sum())
    assert int(seen["counts"]["rows"]) == 2 * real
    assert loop.global_counts.__name__ == "global_counts"


def test_grad_tree_gap_is_relative_l2_per_gradient():
    """Each gradient's L2 gap over its own norm, or over GRAD_FLOOR of
    the whole tree's norm where it is smaller (a gradient that is 0 in
    exact arithmetic)."""
    want = {"a": torch.full((4,), 100.0), "b": torch.full((2,), 2.0),
            "k": torch.full((2,), 1e-6)}
    got = {"a": torch.full((4,), 100.0), "b": torch.tensor([2.0, 0.0]),
           "k": torch.full((2,), -1e-6)}
    gap = chip_smoke.grad_tree_gap(got, want)
    tree = (4e4 + 8.0 + 2e-12) ** 0.5
    assert gap["worst"] == "b" and gap["max"] == pytest.approx(2.0 / 8 ** 0.5)
    assert gap["tree_norm"] == pytest.approx(tree)
    k = [row for row in gap["top"] if row[0] == "k"][0]
    assert k[1] == pytest.approx(2 * 2 ** 0.5 * 1e-6 / (1e-3 * tree))
    assert chip_smoke.grad_tree_gap(want, want)["max"] == 0.0
    with pytest.raises(AssertionError, match="one side"):
        chip_smoke.grad_tree_gap({"a": want["a"]}, want)


def test_parallel_batch_is_uneven_across_shards():
    """The two dp shards of phase 15's batch hold other frame, token and
    row counts (a dummy row: no frames, no targets), so a mean taken a
    shard differs from the global mean; every padded position is zero
    or IGNORE_ID."""
    from tpu_asr_torch.ops.losses import loss_counts
    b = chip_smoke.parallel_batch()
    counts = [loss_counts(*(torch.as_tensor(b[k][half]).long() for k in (
        "feat_lengths", "targets", "target_lengths")))
        for half in (slice(0, 16), slice(16, 32))]
    assert counts[0]["rows"] == 16 and 0 < counts[1]["rows"] < 16
    assert counts[0]["tokens"] / counts[0]["rows"] != \
        counts[1]["tokens"] / counts[1]["rows"]
    assert b["feat_lengths"][:16].sum() != b["feat_lengths"][16:].sum()
    for i, (n, u) in enumerate(zip(b["feat_lengths"], b["target_lengths"])):
        assert not b["feats"][i, n:].any()
        assert (b["targets"][i, u:] == -1).all()
        assert (b["targets"][i, :u] >= 2).all()


def test_parallel_launches_per_rank():
    """The aishell preset's step on one rank: the CTC pair once; with
    use_pallas also 18 flash calls (6 encoder + 2 x 6 decoder attentions)
    and 30 fused LN calls (2 x 6 + 3 x 6 post-norm blocks)."""
    cfg = chip_smoke.parallel_cfg({})
    ctc = {"ctc_loss_fwd": 1, "ctc_loss_bwd": 1}
    chip_smoke.check_parallel_launches("dp", ctc, cfg)
    with pytest.raises(AssertionError):
        chip_smoke.check_parallel_launches("dp", {"ctc_loss_fwd": 1}, cfg)
    pallas = dataclasses.replace(cfg, use_pallas=True)
    want = dict(ctc, flash_attention_fwd=18, flash_attention_bwd_dq=18,
                flash_attention_bwd_dkv=18, layer_norm_residual_fwd=30,
                layer_norm_residual_bwd=30)
    chip_smoke.check_parallel_launches("tp", want, pallas)
    with pytest.raises(AssertionError):
        chip_smoke.check_parallel_launches("tp", ctc, pallas)
    assert chip_smoke.rank_sum([want, ctc]) == dict(
        want, ctc_loss_fwd=2, ctc_loss_bwd=2)
    assert chip_smoke.rank_max([{"a": 1.0, "b": 0.0}, {"a": 0.5, "c": 2.0}]) \
        == {"a": 1.0, "b": 0.0, "c": 2.0}


def test_rank_inputs_recorded_without_moving_the_counts():
    """record_rank_inputs keeps the first CTC backward's inputs of a
    train step (its forward's five inputs, alpha and nll) and leaves the
    wrapper's launch count where it was (a CPU call launches nothing)."""
    from tpu_asr_torch.configs.presets import get_preset
    from tpu_asr_torch.models import build_model
    from tpu_asr_torch.ops import ctc_loss
    from tpu_asr_torch.train import NoamAdam, TrainStep
    from tpu_asr_torch.weights import init_random
    cfg = dataclasses.replace(get_preset("hybrid_dev").model, vocab_size=32,
                              conv_channels=(8, 16), pallas_ctc=True,
                              num_enc_layers=1, num_dec_layers=1)
    model = init_random(build_model(cfg), 0)
    ts = TrainStep(model, NoamAdam(model.parameters(), cfg.d_model, 10),
                   device="cpu")
    b = chip_smoke.parallel_batch(b=8, t=64, u=5)
    b["targets"] = np.where(b["targets"] >= 0, b["targets"] % 30 + 2, -1)
    wrapper = ctc_loss.ctc_loss_bwd
    before = wrapper.launches
    caps = {}
    with chip_smoke.record_rank_inputs(caps, "t"):
        ts(b)
        ts(b)
    assert set(caps) == set(chip_smoke.RANK_CAPTURES)
    assert list(caps["ctc"]) == ["t: first CTC backward"]
    assert len(caps["ctc"]["t: first CTC backward"]) == 7
    assert ctc_loss.ctc_loss_bwd is wrapper and wrapper.launches == before


def test_parallel_layouts_and_backend_choice(monkeypatch):
    """Phase 15's layouts are a data and a model split of its 2 ranks;
    ranks that share the card take gloo, ranks with a card each NCCL,
    CPU ranks gloo."""
    from tpu_asr_torch.parallel.mesh import choose_backend
    assert {(d, m) for _, d, m, _ in chip_smoke.PARALLEL_LAYOUTS} == {
        (chip_smoke.PARALLEL_RANKS, 1), (1, chip_smoke.PARALLEL_RANKS)}
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert choose_backend(2, torch.device("cuda", 0)) == "gloo"
    assert choose_backend(1, torch.device("cuda", 0)) == "nccl"
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert choose_backend(4, torch.device("cuda", 0)) == "nccl"
    assert choose_backend(2, torch.device("cpu")) == "gloo"


def _dp_line(tokens, score, second, second_score):
    return {"hyp_tokens": tokens,
            "nbest": [{"yseq": tokens, "score": score},
                      {"yseq": second, "score": second_score}]}


def test_dp_hyps_equal_to_their_shards():
    """recognize --dp's n-best against one process decoding the same
    shards: the 1-best equal and every score within 1e-5."""
    want = {"a": _dp_line([1, 2], -3.0, [1], -5.0),
            "b": _dp_line([4], -2.0, [4, 5], -2.0005)}
    worst = chip_smoke.compare_shard_hyps(
        want, {"a": _dp_line([1, 2], -3.000004, [1], -5.0),
               "b": _dp_line([4], -2.0, [4, 5], -2.000505)})
    assert worst == pytest.approx(5e-6)
    with pytest.raises(AssertionError, match="--dp b"):       # a tie moved
        chip_smoke.compare_shard_hyps(want, dict(
            want, b=_dp_line([4, 5], -2.0004, [4], -2.0006)))
    with pytest.raises(AssertionError, match="--dp a"):       # 2e-5 off
        chip_smoke.compare_shard_hyps(want, dict(
            want, a=_dp_line([1, 2], -3.00002, [1], -5.0)))
    with pytest.raises(AssertionError, match="ids"):
        chip_smoke.compare_shard_hyps(want, {"a": want["a"]})


# ---- phase 16: checkpoints in and out, the recipe as users run it ----

def test_alias_fixtures_fire_every_rule_and_import_alike(tmp_path):
    """The export's keys, alias_fixture of them and an untied linear-input
    model's keys with a `model.` head fire every KEY_ALIASES rule; the
    fixture imports to the export's flax tree bit for bit."""
    import dataclasses as dc
    from tpu_asr_torch.configs.presets import get_preset
    from tpu_asr_torch.models import build_model
    from tpu_asr_torch.parity.torch_export import export_model
    from tpu_asr_torch.parity.torch_import import (KEY_ALIASES,
                                                   load_torch_checkpoint)
    from tpu_asr_torch.weights import init_random
    dev = get_preset("hybrid_dev").model
    keys = set()
    for name, cfg in (("conv", dc.replace(dev, vocab_size=32)),
                      ("linear", dc.replace(dev, vocab_size=32,
                                            input_layer="linear",
                                            tie_embedding=False))):
        path = str(tmp_path / f"{name}.pth.tar")
        export_model(path, init_random(build_model(cfg), 0), cfg)
        blob = torch.load(path, weights_only=True)
        sd = blob["state_dict"]
        keys |= set(sd)
        if name == "conv":
            fixture = chip_smoke.alias_fixture(sd)
            keys |= set(fixture)
            assert all(k.startswith("module.") for k in fixture)
            assert "module.ctc_lo.weight" in fixture
            torch.save(dict(blob, state_dict=fixture),
                       str(tmp_path / "f.pth.tar"))
            want, want_cfg = load_torch_checkpoint(path)
            got, got_cfg = load_torch_checkpoint(str(tmp_path / "f.pth.tar"))
            assert got_cfg == want_cfg
            for a, b in zip(nested_leaves(got), nested_leaves(want)):
                assert a[0] == b[0] and np.array_equal(a[1], b[1]), a[0]
        else:
            keys |= {f"model.{k}" for k in sd
                     if k.startswith(("encoder.", "decoder."))}
    assert chip_smoke.aliases_fired(keys) == set(range(len(KEY_ALIASES)))
    assert chip_smoke.aliases_fired({"enc_layers.0.ffn.w_1.weight"}) == set()


def nested_leaves(tree, prefix=""):
    """(path, array) of a nested dict, in key order."""
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from nested_leaves(v, f"{prefix}/{k}")
        else:
            yield f"{prefix}/{k}", np.asarray(v)


def test_same_hyp_files(tmp_path):
    a, b = tmp_path / "a.jsonl", tmp_path / "b.jsonl"
    line = {"id": "u1", "hyp_tokens": [3, 4],
            "nbest": [{"yseq": [3, 4], "score": -1.2345678901234567}]}
    a.write_text(json.dumps(line) + "\n")
    b.write_text(json.dumps(line) + "\n")
    assert chip_smoke.same_hyp_files(str(a), str(b)) == 1
    line["nbest"][0]["score"] = float(np.nextafter(-1.2345678901234567, 0))
    b.write_text(json.dumps(line) + "\n")
    with pytest.raises(AssertionError, match="line 0"):
        chip_smoke.same_hyp_files(str(a), str(b))
    b.write_text("")
    with pytest.raises(AssertionError, match="1 lines"):
        chip_smoke.same_hyp_files(str(a), str(b))


def test_fork_server_runs_the_recipes_python(tmp_path):
    """The recipe's $PYTHON (counted_python, a client of fork_server)
    runs `-c`, `-` (a script on standard input) and `-m <cli>` with the
    client's cwd, environment, streams and exit code; each `-m` run
    leaves counted_cli's record."""
    import subprocess
    out = tmp_path / "counts"
    out.mkdir()
    work = tmp_path / "w"
    work.mkdir()
    with chip_smoke.fork_server_running(str(out)) as python:
        def run(argv, stdin=""):
            return subprocess.run([python] + argv, input=stdin, cwd=work,
                                  env=dict(os.environ, MARK="m7"),
                                  capture_output=True, text=True,
                                  timeout=120)
        done = run(["-c", "import os, sys; print(6 * 7, os.getcwd(), "
                    "os.environ['MARK'], sys.argv[1:])", "a"])
        assert done.returncode == 0, done.stderr
        assert done.stdout.split() == ["42", str(work), "m7",
                                              "['a']"]
        done = run(["-", "x"], "import sys; print(sys.argv); sys.exit(3)")
        assert (done.returncode, done.stdout) == (3, "['-', 'x']\n")
        done = run(["-c", "raise ValueError('boom')"])
        assert done.returncode == 1 and "ValueError: boom" in done.stderr
        done = run(["-m", "tpu_asr_torch.recognize", "--manifest",
                    "m.jsonl"])
        assert done.returncode == 2           # argparse: no checkpoint
        assert "--ckpt or --torch-ckpt is required" in done.stderr
        assert not os.listdir(work)
    (record,) = [json.load(open(out / f)) for f in os.listdir(out)]
    assert record.pop("wall_s") >= 0.0 and record.pop("start_s") >= 0.0
    assert record == {"module": "tpu_asr_torch.recognize",
                      "argv": ["--manifest", "m.jsonl"], "exit": 2,
                      "launches": {}, "decoder_steps": 0,
                      "kernel_errs": {}}


def _run(module, argv, launches, steps=0, exit=0):
    return {"module": module, "argv": argv, "exit": exit,
            "launches": launches, "decoder_steps": steps,
            "kernel_errs": {}}


def test_recipe_counts():
    history = [{"train_steps": 7, "cv_batches": 2},
               {"train_steps": 7, "cv_batches": 2}]
    runs = [_run("tpu_asr_torch.prepare_data", ["--out", "x"], {}),
            _run("tpu_asr_torch.train", ["--preset", "hybrid_dev"],
                 {"ctc_loss_fwd": 18, "ctc_loss_bwd": 14}),
            _run("tpu_asr_torch.recognize", ["--mode", "attn_rescore"], {}),
            _run("tpu_asr_torch.recognize", ["--mode", "joint"],
                 {"ctc_prefix_scan": 40}, steps=40)]
    assert chip_smoke.recipe_counts(runs, history) == {
        "training": {"ctc_loss_fwd": 18, "ctc_loss_bwd": 14},
        "joint": {"ctc_prefix_scan": 40}}
    for bad in (
            _run("tpu_asr_torch.train", [], {"ctc_loss_fwd": 17,
                                             "ctc_loss_bwd": 14}),
            _run("tpu_asr_torch.recognize", ["--mode", "joint"],
                 {"ctc_prefix_scan": 39}, steps=40),
            _run("tpu_asr_torch.recognize", ["--mode", "attn_rescore"],
                 {"ctc_prefix_scan": 1}),
            _run("tpu_asr_torch.compute_cmvn", [], {}, exit=1)):
        swapped = [r if r["module"] != bad["module"] or
                   r["argv"][-1:] != bad["argv"][-1:] else bad for r in runs]
        if bad not in swapped:
            swapped.append(bad)
        with pytest.raises(AssertionError):
            chip_smoke.recipe_counts(swapped, history)
    with pytest.raises(AssertionError, match="no training or no joint"):
        chip_smoke.recipe_counts(runs[:3], history)


def test_tree_kept(tmp_path):
    """What exists is put back as it was; what the run made goes, with
    the folders above it that it made."""
    kept = tmp_path / "exp" / "run"
    kept.mkdir(parents=True)
    (kept / "mine.txt").write_text("keep")
    made = tmp_path / "data" / "aishell"
    with chip_smoke.tree_kept([str(made), str(kept)]):
        assert not kept.exists()
        made.mkdir(parents=True)
        kept.mkdir()
        (kept / "new.txt").write_text("x")
        (made / "train.jsonl").write_text("x")
    assert sorted(os.listdir(kept)) == ["mine.txt"]
    assert not (tmp_path / "data").exists()
