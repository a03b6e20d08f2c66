"""chip_smoke.py's helpers that need no card: the readers of what the
build made, the flash bounds and the rounding-flip count, the kernel
names it times and the CTC kernels' launch plans, on the CPU."""

import importlib.util
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
