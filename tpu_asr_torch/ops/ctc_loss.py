"""CTC loss with a hand-written forward/backward pair: the CUDA kernels'
wrappers, their plain PyTorch versions, and the autograd Function.

Port of tpu_asr/ops/pallas/ctc.py (ctc_loss_pallas and its custom VJP
ctc_nll_from_emissions). The vocabulary-sized work stays in PyTorch: the
caller gathers emissions E[b,t,s] = log_softmax(logits)[b,t,z_s] (S = 2U+1,
a few dozen positions against V = 4233) and autograd scatters grad_E back
into the logits. The kernels (csrc/ctc_loss.cu) do only the sequential
part: the alpha pass (nll and the alpha history) and the beta pass
(grad_E = -exp(alpha + beta - ll)). Each pass takes one of two routes by
S (`fwd_route`, `bwd_route`): a chain warp per utterance, fed and
drained by a second warp through shared memory, for S <= 128 (every
training shape: the loader pads U to a multiple of 8, so S is 17 .. 65),
a block per utterance above. See the source note for what bounds them
on the card.

`ctc_loss_fwd` / `ctc_loss_bwd` dispatch on the device of their inputs:
CUDA tensors launch the kernel (or raise), CPU tensors run the plain
version. There is no fallback from one to the other.
"""

from __future__ import annotations

import ctypes

import torch

from tpu_asr_torch.ops.ctc import (NEG_INF, _interleave_blanks,
                                   lattice_emissions, lattice_masks,
                                   reduce_nll)
from tpu_asr_torch.ops.cuda_build import KernelLibrary, check_tensor

LIBRARY = KernelLibrary("ctc_loss")
MAX_S = 1024          # the block routes: a thread a position
WARP_MAX_S = 128      # the warp routes: up to 4 positions a lane
FWD_SYMBOLS = {"warp": "ctc_alpha_warp_kernel",   # the __global__ names
               "block": "ctc_alpha_kernel"}
BWD_SYMBOLS = {"warp": "ctc_beta_grad_warp_kernel",
               "block": "ctc_beta_grad_block_kernel"}
PROBE_SYMBOLS = {"fwd": "ctc_alpha_chain_probe_kernel",
                 "bwd": "ctc_beta_chain_probe_kernel"}
# launches by route, beside ctc_loss_fwd.launches and ctc_loss_bwd.launches
FWD_ROUTE_LAUNCHES = {"warp": 0, "block": 0}
BWD_ROUTE_LAUNCHES = {"warp": 0, "block": 0}
WARP_PLAN_KEYS = ("positions", "tile_rows", "stages", "utterances_per_block",
                  "threads", "smem_bytes")


def bwd_route(s: int) -> str:
    """The kernel for S lattice positions: "warp" up to WARP_MAX_S,
    "block" above (up to MAX_S). The forward and the backward route
    alike."""
    return "warp" if s <= WARP_MAX_S else "block"


fwd_route = bwd_route


def _bind(lib: ctypes.CDLL):
    if lib.ctc_loss_fwd_block_launch.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        for name in ("ctc_loss_fwd_block_launch", "ctc_loss_fwd_warp_launch"):
            getattr(lib, name).argtypes = [p] * 7 + [i] * 3 + [p]
            getattr(lib, name).restype = i
        for name in ("ctc_loss_bwd_block_launch", "ctc_loss_bwd_warp_launch"):
            getattr(lib, name).argtypes = [p] * 8 + [i] * 3 + [p]
            getattr(lib, name).restype = i
        for name in ("ctc_loss_fwd_warp_plan", "ctc_loss_bwd_warp_plan"):
            getattr(lib, name).argtypes = [i, p]
            getattr(lib, name).restype = i
        for name in ("ctc_alpha_chain_probe_launch",
                     "ctc_beta_chain_probe_launch"):
            getattr(lib, name).argtypes = [p, i, i, p]
            getattr(lib, name).restype = i
        lib.ctc_log_check_launch.argtypes = [p, p]
        lib.ctc_log_check_launch.restype = i
        lib.ctc_loss_error_string.argtypes = [i]
        lib.ctc_loss_error_string.restype = ctypes.c_char_p
    return lib


# ---- plain versions (the CPU path, and what the kernels are held to) ----

def _lae3(a, b, c):
    """The TPU kernel's _logaddexp3, term for term."""
    m = torch.maximum(torch.maximum(a, b), c)
    ms = torch.clamp(m, min=NEG_INF)
    out = ms + torch.log(torch.exp(a - ms) + torch.exp(b - ms)
                         + torch.exp(c - ms))
    return torch.where(m <= NEG_INF / 2, NEG_INF, out)


def _shift(x, k):
    """x[:, s-k] at position s (k > 0: right; k < 0: left), NEG_INF fill."""
    fill = torch.full_like(x[:, :abs(k)], NEG_INF)
    if k > 0:
        return torch.cat([fill, x[:, :-k]], dim=1)
    return torch.cat([x[:, -k:], fill], dim=1)


def ctc_loss_fwd_reference(emissions, skip, valid, ilen, llen):
    """Alpha pass as a loop of torch ops. emissions [B, T, S] float32;
    skip/valid [B, S] bool; ilen/llen [B] int. Returns (nll [B], alpha
    [B, T, S])."""
    b, t, s = emissions.shape
    col = torch.arange(s, device=emissions.device)[None, :]
    ilen, llen = ilen[:, None], llen[:, None]
    emit0 = emissions[:, 0]
    alpha = torch.where(col == 0, emit0, NEG_INF)
    alpha = torch.where((col == 1) & (llen > 0), emit0, alpha)
    alpha = torch.where(valid, alpha, NEG_INF)
    rows = [alpha]
    for step in range(1, t):
        a2 = torch.where(skip, _shift(alpha, 2), NEG_INF)
        new = _lae3(alpha, _shift(alpha, 1), a2) + emissions[:, step]
        new = torch.where(valid, new, NEG_INF)
        alpha = torch.where(step < ilen, new, alpha)
        rows.append(alpha)
    end = 2 * llen
    is_end = (col == end) | ((col == end - 1) & (llen > 0))
    masked = torch.where(is_end, alpha, NEG_INF)
    m = masked.max(dim=1, keepdim=True).values
    ms = torch.clamp(m, min=NEG_INF)
    ll = ms + torch.log(torch.exp(masked - ms).sum(dim=1, keepdim=True))
    nll = -torch.where(m <= NEG_INF / 2, NEG_INF, ll)
    return nll[:, 0], torch.stack(rows, dim=1)


def ctc_loss_bwd_reference(emissions, skip, valid, ilen, llen, alpha, nll):
    """Beta pass and grad_E = -exp(alpha + beta - ll), 0 where alpha or
    beta is <= NEG_INF/2. Returns grad_E [B, T, S] (not yet scaled by the
    incoming gradient)."""
    b, t, s = emissions.shape
    col = torch.arange(s, device=emissions.device)[None, :]
    ilen, llen = ilen[:, None], llen[:, None]
    skip_l2 = _shift(skip.float(), -2) > 0.5        # skip[s+2] at s
    ll = -nll[:, None]
    end = 2 * llen
    end_init = torch.where((col == end) | ((col == end - 1) & (llen > 0)),
                           0.0, NEG_INF)
    beta = torch.full((b, s), NEG_INF, device=emissions.device)
    grads = [None] * t
    for step in range(t - 1, -1, -1):
        tmp = beta + emissions[:, min(step + 1, t - 1)]
        cand = _lae3(tmp, _shift(tmp, -1),
                     torch.where(skip_l2, _shift(tmp, -2), NEG_INF))
        beta = torch.where(step == ilen - 1, end_init,
                           torch.where(step < ilen - 1, cand, NEG_INF))
        beta = torch.where(valid, beta, NEG_INF)
        a_t = alpha[:, step]
        grads[step] = torch.where((a_t > NEG_INF / 2) & (beta > NEG_INF / 2),
                                  -torch.exp(a_t + beta - ll), 0.0)
    return torch.stack(grads, dim=1)


def ctc_nll_from_emissions_reference(emissions, skip, valid, ilen, llen):
    """Both plain passes: (nll [B], grad_E [B, T, S]), the contract of
    the kernel pair."""
    nll, alpha = ctc_loss_fwd_reference(emissions, skip, valid, ilen, llen)
    return nll, ctc_loss_bwd_reference(emissions, skip, valid, ilen, llen,
                                       alpha, nll)


# ---- kernel wrappers ----

def _check_inputs(emissions, skip, valid, ilen, llen):
    if emissions.device.type != "cuda":
        raise ValueError(f"no CTC loss kernel for device {emissions.device}")
    b, t, s = emissions.shape
    if t < 1 or not 1 <= s <= MAX_S:
        raise ValueError(f"CTC kernels need T >= 1 and 1 <= S <= {MAX_S}, "
                         f"got T={t}, S={s}")
    dev = emissions.device
    check_tensor("emissions", emissions, (b, t, s), torch.float32, dev)
    check_tensor("skip", skip, (b, s), torch.bool, dev)
    check_tensor("valid", valid, (b, s), torch.bool, dev)
    check_tensor("ilen", ilen, (b,), torch.int32, dev)
    check_tensor("llen", llen, (b,), torch.int32, dev)
    return b, t, s, dev


def _raise_on(err: int, which: str):
    if err:
        msg = LIBRARY.load().ctc_loss_error_string(err).decode()
        raise RuntimeError(f"{which} launch failed: {msg} ({err})")


def ctc_loss_fwd(emissions, skip, valid, ilen, llen):
    """Alpha pass: (nll [B], alpha [B, T, S]). On CUDA tensors (float32
    emissions, bool masks, int32 lengths, all contiguous) launches the
    kernel on the route fwd_route(S) picks, on the current stream, and
    counts it in `ctc_loss_fwd.launches` and in FWD_ROUTE_LAUNCHES; on
    CPU tensors runs ctc_loss_fwd_reference."""
    if emissions.device.type == "cpu":
        return ctc_loss_fwd_reference(emissions, skip, valid, ilen, llen)
    b, t, s, dev = _check_inputs(emissions, skip, valid, ilen, llen)
    lib = _bind(LIBRARY.load())
    nll = torch.empty((b,), dtype=torch.float32, device=dev)
    alpha = torch.empty((b, t, s), dtype=torch.float32, device=dev)
    route = fwd_route(s)
    launch = (lib.ctc_loss_fwd_warp_launch if route == "warp"
              else lib.ctc_loss_fwd_block_launch)
    with torch.cuda.device(dev):
        err = launch(emissions.data_ptr(), skip.data_ptr(), valid.data_ptr(),
                     ilen.data_ptr(), llen.data_ptr(), nll.data_ptr(),
                     alpha.data_ptr(), b, t, s,
                     torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(err, f"ctc_loss_fwd ({route} route)")
    ctc_loss_fwd.launches += 1
    FWD_ROUTE_LAUNCHES[route] += 1
    return nll, alpha


def ctc_loss_bwd(emissions, skip, valid, ilen, llen, alpha, nll):
    """Beta pass: grad_E [B, T, S] (unscaled). Kernel on CUDA tensors, on
    the route bwd_route(S) picks, counted in `ctc_loss_bwd.launches` and
    in BWD_ROUTE_LAUNCHES; ctc_loss_bwd_reference on CPU."""
    if emissions.device.type == "cpu":
        return ctc_loss_bwd_reference(emissions, skip, valid, ilen, llen,
                                      alpha, nll)
    b, t, s, dev = _check_inputs(emissions, skip, valid, ilen, llen)
    check_tensor("alpha", alpha, (b, t, s), torch.float32, dev)
    check_tensor("nll", nll, (b,), torch.float32, dev)
    lib = _bind(LIBRARY.load())
    grad = torch.empty((b, t, s), dtype=torch.float32, device=dev)
    route = bwd_route(s)
    launch = (lib.ctc_loss_bwd_warp_launch if route == "warp"
              else lib.ctc_loss_bwd_block_launch)
    with torch.cuda.device(dev):
        err = launch(emissions.data_ptr(), skip.data_ptr(), valid.data_ptr(),
                     ilen.data_ptr(), llen.data_ptr(), alpha.data_ptr(),
                     nll.data_ptr(), grad.data_ptr(), b, t, s,
                     torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(err, f"ctc_loss_bwd ({route} route)")
    ctc_loss_bwd.launches += 1
    BWD_ROUTE_LAUNCHES[route] += 1
    return grad


ctc_loss_fwd.launches = 0   # kernel launches (not CPU reference calls)
ctc_loss_bwd.launches = 0


def warp_plan(s: int, which: str) -> dict:
    """The launch the warp route of the forward (which="fwd") or the
    backward ("bwd") makes at S positions (any B, any T), as its library
    reports it (WARP_PLAN_KEYS): positions a lane of the chain warp, rows
    a ring slot, slots in the ring, utterances a block (a chain warp and
    a helper warp each), threads and dynamic shared bytes a block. Needs
    the built library."""
    lib = _bind(LIBRARY.load())
    plan = (ctypes.c_int * len(WARP_PLAN_KEYS))()
    fn = getattr(lib, f"ctc_loss_{which}_warp_plan")
    _raise_on(fn(s, plan), f"{which} warp plan at S={s}")
    return dict(zip(WARP_PLAN_KEYS, plan))


def chain_probe(steps: int, s: int, which: str,
                device="cuda") -> torch.Tensor:
    """Launch a chain's probe: one warp running the warp route's step of
    the forward (which="fwd": two shuffles up, two lae3) or the backward
    ("bwd": two shuffles down, two lae3) at two positions a lane `steps`
    times at S = s <= 64 on operands in registers, no memory traffic (its
    time alone is the chain's floor). Not a port of anything; needs the
    card. Returns the warp's 32 results."""
    dev = torch.device(device)
    if dev.type != "cuda":
        raise ValueError(f"the chain probe runs on the card, not {dev}")
    lib = _bind(LIBRARY.load())
    out = torch.empty(32, dtype=torch.float32, device=dev)
    kernel = PROBE_SYMBOLS[which]
    with torch.cuda.device(dev):
        err = getattr(lib, kernel.replace("_kernel", "_launch"))(
            out.data_ptr(), steps, s,
            torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(err, kernel)
    return out


def log_mismatches(device="cuda") -> int:
    """The number of floats x in [1, 3] (all of them, one launch) where
    the forward's branch-free log (its lae3's, on sums of three exps) and
    the toolkit's logf differ in any bit: 0 when the forward's lae3 is
    the plain version's. Needs the card."""
    dev = torch.device(device)
    if dev.type != "cuda":
        raise ValueError(f"the log check runs on the card, not {dev}")
    lib = _bind(LIBRARY.load())
    count = torch.zeros(1, dtype=torch.int64, device=dev)
    with torch.cuda.device(dev):
        err = lib.ctc_log_check_launch(
            count.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(err, "ctc_log_check")
    return int(count.item())


class CTCNLLFromEmissions(torch.autograd.Function):
    """nll [B] from emissions [B, T, S]; the backward is the beta pass,
    scaled per row by the incoming gradient. skip/valid/ilen/llen get no
    gradient."""

    @staticmethod
    def forward(ctx, emissions, skip, valid, ilen, llen):
        nll, alpha = ctc_loss_fwd(emissions, skip, valid, ilen, llen)
        ctx.save_for_backward(emissions, skip, valid, ilen, llen, alpha, nll)
        return nll

    @staticmethod
    def backward(ctx, g):
        emissions, skip, valid, ilen, llen, alpha, nll = ctx.saved_tensors
        grad = ctc_loss_bwd(emissions, skip, valid, ilen, llen, alpha, nll)
        return grad * g[:, None, None], None, None, None, None


ctc_nll_from_emissions = CTCNLLFromEmissions.apply


def ctc_loss_kernel(logits: torch.Tensor, labels: torch.Tensor,
                    logit_lengths: torch.Tensor, label_lengths: torch.Tensor,
                    blank: int = 0,
                    reduction: str = "mean_label") -> torch.Tensor:
    """CTC negative log-likelihood of unnormalized logits through the
    kernel pair (the counterpart of ctc_loss_pallas). Infeasible
    utterances (logit_len < label_len, or no path at all) get 0, like
    zero_infinity=True; see reduce_nll for the reductions."""
    z = _interleave_blanks(labels, blank)
    emissions = lattice_emissions(logits, z).contiguous()
    skip, valid = lattice_masks(z, label_lengths, blank)
    nll = ctc_nll_from_emissions(emissions, skip.contiguous(),
                                 valid.contiguous(),
                                 logit_lengths.to(torch.int32).contiguous(),
                                 label_lengths.to(torch.int32).contiguous())
    return reduce_nll(nll, logit_lengths, label_lengths, reduction)
