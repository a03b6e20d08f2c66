"""What decides `correct`, driven end to end at a small size on the CPU
(the harness's look for a card skipped): the program passes the cell's
limits, and the control and each fault that the cell can have fail
them. The tiny cells take the limits of the cells they stand for."""

import time

import pytest
import torch

from benchmark import harness
from benchmark.drivers import serve as serve_drv
from benchmark.drivers import train as train_drv
from benchmark.readings import FAULTS, readings

SEED = 2 ** 31 + 11


def _run(cell, program_cls=None, trace=False):
    kw = {} if program_cls is None else {"program_cls": program_cls}
    return cell.driver.run(cell, seed=SEED, seconds=1.5, trace=trace,
                           device="cpu", t_start=time.perf_counter(), **kw)


@pytest.mark.parametrize("encoder", ["transformer", "conformer"])
def test_train_program_is_correct(tiny, encoder):
    cell = tiny("tiny_train", encoder=encoder)
    out = _run(cell, trace=True)
    assert out["correct"], out["checks"]
    assert out["attempted"] > 3 and out["failed"] == 0
    assert {"loader_wait_ms", "train_mfu", "device_idle.train"} <= \
        set(out["metrics"])
    assert out["device"]["window_s"] > 0


def test_train_control_is_not_correct(tiny):
    cell = tiny("tiny_train")
    rows = []
    readings(cell, [SEED], "cpu", control=True, log=rows.append)
    import json
    got = json.loads(rows[0])
    assert harness.judge([(k, got["program"][k], cell.limits[k])
                          for k in cell.limits])
    assert not harness.judge([(k, got["control"][k], cell.limits[k])
                              for k in cell.limits])


class HalfBatch(train_drv.Program):
    """Half of each batch's real rows left out, the mean over the rest."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        FAULTS["half_batch"](self)


class Unchanged(train_drv.Program):
    """A step that returns its state unchanged."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.step.optimizer.update = lambda grads, norm=None: False


@pytest.mark.parametrize("fault", [HalfBatch, Unchanged])
def test_train_faults_are_not_correct(tiny, fault):
    out = _run(tiny("tiny_train"), program_cls=fault)
    assert not out["correct"], out["checks"]


def test_serve_program_is_correct(tiny):
    out = _run(tiny("tiny_serve"), trace=True)
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    assert {"server_p95_ms", "batch_fill", "decode_batch_ms",
            "decode_mfu", "device_idle.serve"} <= set(out["metrics"])


def test_serve_control_is_not_correct(tiny):
    """The float8 reference answers every request of the pool in the
    server's place (its own beam's 1-best and score) and fails."""
    from benchmark import traffic
    cell = tiny("tiny_serve")
    requests = traffic.make_requests(cell.traffic, SEED, "cpu")
    picked = [(i, 0.0, 0.0, None) for i in range(len(requests.wavs))]
    rows = serve_drv.reference_answers(cell, picked, requests, SEED, "cpu",
                                       control=True)
    got = serve_drv.compare(rows)
    assert not harness.judge([(k, got[k], cell.limits[k])
                              for k in cell.limits])


class AlteredToken(serve_drv.Program):
    """Each answer's first token altered where the beam produces it."""

    def __init__(self, cell, seed, device):
        super().__init__(cell, seed, device)
        import tpu_asr_torch.decode.recognizer as rec_mod
        search = rec_mod.attention_beam_search
        v = cell.config["model"]["vocab_size"]

        def altered(*a, **kw):
            out = search(*a, **kw)
            toks = out["tokens"].clone()
            toks[:, :, 0] = torch.where(toks[:, :, 0] == 2, 3, 2)
            toks[:, :, 0] = torch.where(out["lengths"] > 0, toks[:, :, 0],
                                        v - 1)
            return dict(out, tokens=toks)

        self._restore = (rec_mod, search)
        rec_mod.attention_beam_search = altered

    def close(self):
        super().close()
        mod, search = self._restore
        mod.attention_beam_search = search


def test_serve_altered_token_is_not_correct(tiny):
    out = _run(tiny("tiny_serve"), program_cls=AlteredToken)
    assert not out["correct"], out["checks"]
