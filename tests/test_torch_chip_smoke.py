"""chip_smoke.py's helpers that need no card: the readers of what the
build made, the flash bounds and the rounding-flip count, on the CPU."""

import importlib.util
import os

import numpy as np
import pytest
import torch

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
    """A fake cuobjdump report of the flash and LN libraries: every wgmma
    kernel at dh 32, 64 and 128 with HGMMA and no spills, two LN backward
    instantiations without spills, a float32 SIMT kernel with a stack
    frame; `changed` applies to the kernels named in `only` (default:
    every wgmma kernel), `drop` leaves kernels out."""
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
        assert len(found) == 11
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


@pytest.mark.parametrize("which", ["fwd", "dq", "dkv"])
def test_flash_symbol_names_the_routed_kernel(which):
    """kernel_device_ms times the kernel the wrapper launches: bf16 on
    wgmma (dq too), float32 on the SIMT kernels."""
    stem = {"fwd": "fwd", "dq": "bwd_dq", "dkv": "bwd_dkv"}[which]
    assert chip_smoke.flash_symbol(which, torch.bfloat16) == \
        f"flash_attention_{stem}_wgmma_kernel"
    assert chip_smoke.flash_symbol(which, torch.float32) == \
        f"flash_attention_{stem}_simt_kernel"


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
