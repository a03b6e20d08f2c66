"""The port stands alone: tpu_asr_torch/ and chip_smoke.py import no JAX
and nothing of tpu_asr, and its entry points never fall back to the CPU
quietly."""

import ast
import os
import re
import subprocess
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "tpu_asr")


def _port_files():
    root = os.path.join(REPO, "tpu_asr_torch")
    files = [os.path.join(REPO, "chip_smoke.py")]
    for dirpath, _, names in os.walk(root):
        files += [os.path.join(dirpath, n) for n in names if n.endswith(".py")]
    return files


def _imported_roots(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.module and \
                node.level == 0:
            yield node.module.split(".")[0]


def test_no_jax_or_reference_imports():
    files = _port_files()
    assert len(files) > 20
    bad = [(os.path.relpath(f, REPO), m) for f in files
           for m in _imported_roots(f) if m in FORBIDDEN]
    assert not bad, bad


def test_package_imports_with_jax_blocked():
    code = (
        "import sys\n"
        "for m in ('jax', 'jaxlib', 'flax', 'optax', 'orbax', 'tpu_asr'):\n"
        "    sys.modules[m] = None\n"
        "import pkgutil, importlib, tpu_asr_torch\n"
        "for m in pkgutil.walk_packages(tpu_asr_torch.__path__, "
        "'tpu_asr_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_entry_points_refuse_cpu_without_asking(monkeypatch):
    from tpu_asr_torch.decode.recognizer import Recognizer
    from tpu_asr_torch.models.transformer import Transformer
    from tpu_asr_torch.serve import AsrServer
    from tpu_asr_torch.utils.device import resolve_device
    from torch_port_util import torch_cfg

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = torch_cfg()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Recognizer(cfg, Transformer(cfg), mode="joint")
    with pytest.raises(RuntimeError):
        resolve_device("cuda")
    rec = Recognizer(cfg, Transformer(cfg), mode="joint", device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        AsrServer(rec)
    AsrServer(rec, device="cpu")

    from tpu_asr_torch.train import EvalStep, NoamAdam, TrainStep
    model = Transformer(cfg)
    opt = NoamAdam(model.parameters(), cfg.d_model)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TrainStep(model, opt)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        EvalStep(model)
    TrainStep(model, opt, device="cpu")


def test_train_cli_refuses_cpu_without_asking(tmp_path):
    out = subprocess.run(
        [sys.executable, "-c",
         "import torch; torch.cuda.is_available = lambda: False\n"
         "from tpu_asr_torch.train.__main__ import main\n"
         f"main(['--synthetic', '4', '--preset', 'hybrid_dev', "
         f"'--save-folder', {str(tmp_path)!r}])"],
        cwd=REPO, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert "no CUDA device" in out.stderr
    assert not os.listdir(tmp_path)          # nothing trained or written


def test_serve_cli_refuses_cpu_without_asking():
    out = subprocess.run(
        [sys.executable, "-c",
         "import torch; torch.cuda.is_available = lambda: False\n"
         "from tpu_asr_torch.serve import main\n"
         "main(['--random-init', '--preset', 'hybrid_dev'])"],
        cwd=REPO, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert "no CUDA device" in out.stderr


def test_chip_smoke_refuses_without_card():
    out = subprocess.run(
        [sys.executable, "-c",
         "import sys, torch; torch.cuda.is_available = lambda: False\n"
         "sys.argv = ['chip_smoke.py']\n"
         "import runpy; runpy.run_path('chip_smoke.py', "
         "run_name='__main__')"],
        cwd=REPO, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_recipe_and_conformer_modules_are_covered():
    """The import checks above walk the modules of the recipe CLIs and of
    the conformer."""
    files = {os.path.relpath(f, REPO) for f in _port_files()}
    for name in ("models/conformer.py", "prepare_data.py",
                 "compute_cmvn.py"):
        path = os.path.join("tpu_asr_torch", name)
        assert path in files
        assert not [m for m in _imported_roots(os.path.join(REPO, path))
                    if m in FORBIDDEN]


def test_compute_cmvn_refuses_cpu_without_asking(tmp_path):
    manifest = tmp_path / "m.jsonl"
    manifest.write_text("")
    out = subprocess.run(
        [sys.executable, "-c",
         "import torch; torch.cuda.is_available = lambda: False\n"
         "from tpu_asr_torch.compute_cmvn import main\n"
         f"main(['--manifest', {str(manifest)!r}, '--out', "
         f"{str(tmp_path / 's.npz')!r}])"],
        cwd=REPO, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert "no CUDA device" in out.stderr
    assert not (tmp_path / "s.npz").exists()


def test_transducer_modules_are_covered(monkeypatch):
    """The import checks above walk the transducer's modules, and its
    Recognizer and TrainStep refuse the CPU unless asked."""
    files = {os.path.relpath(f, REPO) for f in _port_files()}
    for name in ("ops/transducer.py", "models/transducer.py",
                 "decode/transducer_decode.py"):
        path = os.path.join("tpu_asr_torch", name)
        assert path in files
        assert not [m for m in _imported_roots(os.path.join(REPO, path))
                    if m in FORBIDDEN]
    from tpu_asr_torch.decode.recognizer import Recognizer
    from tpu_asr_torch.models.transducer import TransducerModel
    from tpu_asr_torch.train import NoamAdam, TrainStep
    from torch_port_util import transducer_torch_cfg

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = transducer_torch_cfg()
    model = TransducerModel(cfg)
    for mode in ("transducer_greedy", "transducer_beam",
                 "transducer_rescore"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            Recognizer(cfg, model, mode=mode)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TrainStep(model, NoamAdam(model.parameters(), cfg.d_model))


def test_streaming_modules_are_covered():
    """The import checks above walk the streaming recognizers and the
    stream demo, and neither imports JAX or tpu_asr."""
    files = {os.path.relpath(f, REPO) for f in _port_files()}
    for name in ("decode/streaming.py", "stream_demo.py", "serve.py"):
        path = os.path.join("tpu_asr_torch", name)
        assert path in files
        assert not [m for m in _imported_roots(os.path.join(REPO, path))
                    if m in FORBIDDEN]


def test_serve_cli_with_streams_refuses_cpu_without_asking():
    """serve with /stream on (a chunked model) still needs the card."""
    out = subprocess.run(
        [sys.executable, "-c",
         "import torch; torch.cuda.is_available = lambda: False\n"
         "from tpu_asr_torch.serve import main\n"
         "main(['--random-init', '--preset', 'streaming', "
         "'--stream-beam', '3'])"],
        cwd=REPO, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert "no CUDA device" in out.stderr


def test_input_alignment_and_averaging_modules_are_covered():
    """The import checks above walk the Kaldi ark reader, the frontend's
    pitch and LFR, align and average_checkpoints; their CLIs refuse the
    CPU unless asked."""
    files = {os.path.relpath(f, REPO) for f in _port_files()}
    for name in ("data/kaldi_io.py", "data/loader.py", "frontend.py",
                 "align.py", "average_checkpoints.py", "ops/ctc.py"):
        path = os.path.join("tpu_asr_torch", name)
        assert path in files
        assert not [m for m in _imported_roots(os.path.join(REPO, path))
                    if m in FORBIDDEN]
    for module, argv in (
            ("align", "['--ckpt', 'x', '--manifest', 'y']"),
            ("average_checkpoints", "['--ckpt', 'x', '--out', 'y']")):
        out = subprocess.run(
            [sys.executable, "-c",
             "import torch; torch.cuda.is_available = lambda: False\n"
             f"from tpu_asr_torch.{module} import main\n"
             f"main({argv})"],
            cwd=REPO, capture_output=True, text=True, timeout=120)
        assert out.returncode != 0
        assert "no CUDA device" in out.stderr, module


def test_parallel_modules_are_covered(monkeypatch):
    """The import checks above walk the parallel layer, and its ranks and
    the CLIs' multi-rank launches refuse the CPU unless asked."""
    files = {os.path.relpath(f, REPO) for f in _port_files()}
    for name in ("parallel/__init__.py", "parallel/mesh.py",
                 "parallel/sharding.py"):
        path = os.path.join("tpu_asr_torch", name)
        assert path in files
        assert not [m for m in _imported_roots(os.path.join(REPO, path))
                    if m in FORBIDDEN]
    from tpu_asr_torch.parallel.mesh import initialize_distributed, rank_device
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        rank_device(0, None)
    assert rank_device(3, "cpu") == torch.device("cpu")
    monkeypatch.setenv("COORDINATOR_ADDRESS", "localhost:1")
    monkeypatch.setenv("NUM_PROCESSES", "2")
    monkeypatch.setenv("PROCESS_ID", "1")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        initialize_distributed()            # before any connection


def test_checkpoint_bridge_modules_are_covered():
    """The import checks above walk the reference-format import and
    export (parity/), export_torch and import_params. tools/orbax_to_npz.py
    is the JAX side of the orbax bridge and lies outside the port on
    purpose: it imports tpu_asr and runs JAX, which the port never does,
    and it never runs on the card."""
    files = {os.path.relpath(f, REPO) for f in _port_files()}
    for name in ("parity/__init__.py", "parity/torch_import.py",
                 "parity/torch_export.py", "export_torch.py",
                 "import_params.py", "weights.py", "recognize.py"):
        path = os.path.join("tpu_asr_torch", name)
        assert path in files
        assert not [m for m in _imported_roots(os.path.join(REPO, path))
                    if m in FORBIDDEN]
    tool = os.path.join("tools", "orbax_to_npz.py")
    assert tool not in files
    assert "tpu_asr" in set(_imported_roots(os.path.join(REPO, tool)))


@pytest.mark.parametrize("module,argv", [
    ("recognize", "['--torch-ckpt', 'x.pth.tar', '--manifest', 'y']"),
    ("import_params", "['--src', 'x', '--out', {out!r}]")])
def test_bridge_clis_refuse_cpu_without_asking(tmp_path, module, argv):
    out = str(tmp_path / "port")
    done = subprocess.run(
        [sys.executable, "-c",
         "import torch; torch.cuda.is_available = lambda: False\n"
         f"from tpu_asr_torch.{module} import main\n"
         f"main({argv.format(out=out)})"],
        cwd=REPO, capture_output=True, text=True, timeout=120)
    assert done.returncode != 0
    assert "no CUDA device" in done.stderr, done.stderr[-2000:]
    assert not os.path.exists(out)


def test_recipes_name_no_jax_and_nothing_of_tpu_asr():
    """egs_torch/ (shell and Python) calls only the port: no bin/ script,
    no tpu_asr module (tpu_asr_torch is the port), no JAX, no
    --platform."""
    root = os.path.join(REPO, "egs_torch")
    files = [os.path.join(d, n) for d, _, names in os.walk(root)
             for n in names if n.endswith((".sh", ".py"))]
    assert len(files) >= 3
    for path in files:
        code = "\n".join(line for line in open(path).read().splitlines()
                         if not line.lstrip().startswith("#"))
        what = os.path.relpath(path, REPO)
        assert not re.search(r"\bbin/\w+\.py", code), what
        assert not re.search(r"\btpu_asr\b", code), what
        assert not re.search(r"\b(import|from)\s+(jax|jaxlib|flax|optax|"
                             r"orbax)\b|\bjax\.", code), what
        assert "--platform" not in code, what
        if path.endswith(".py"):
            assert not [m for m in _imported_roots(path) if m in FORBIDDEN]
