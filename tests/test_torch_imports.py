"""Guards of the port's boundaries: it imports no JAX and nothing of the
JAX package, its renderer copy is the original byte for byte, and its
entry points refuse to run quietly on the CPU when no GPU is there."""

import ast
import os

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "rnn_speech_tpu_torch")
FORBIDDEN = ("jax", "jaxlib", "rnn_speech_tpu")


def _port_sources():
    out = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, _, files in os.walk(PKG):
        out += [os.path.join(dirpath, f) for f in files if f.endswith(".py")]
    return sorted(out)


def _imported_roots(path):
    tree = ast.parse(open(path).read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", _port_sources(),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_port_imports_no_jax_and_nothing_of_the_jax_package(path):
    for name in _imported_roots(path):
        root = name.split(".")[0]
        assert root not in FORBIDDEN, f"{path} imports {name}"


@pytest.mark.parametrize("seed", [0, 7])
def test_synth_renders_byte_identical_to_make_demo_corpus(seed):
    import sys

    sys.path.insert(0, os.path.join(ROOT, "tools"))
    import make_demo_corpus as original

    from rnn_speech_tpu_torch import synth

    assert synth.WORDS == original.WORDS
    texts = synth.sample_sentences(3, np.random.default_rng(seed))
    assert texts == original.sample_sentences(3, np.random.default_rng(seed))
    for text in texts + ["A", " "]:
        a = synth.render_syllables_clean(text, 22050, np.random.default_rng(seed))
        b = original.render_syllables_clean(text, 22050, np.random.default_rng(seed))
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


def _no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_default_device_entry_points_raise_without_cuda(monkeypatch, tmp_path):
    """Without a GPU and without device="cpu" the entry points raise; with
    device="cpu" they run."""
    _no_cuda(monkeypatch)
    from rnn_speech_tpu_torch import cli, resolve_device
    from rnn_speech_tpu_torch.models import acoustic
    from rnn_speech_tpu_torch.params import load_bundle
    from rnn_speech_tpu_torch.ops.frontend import DeviceFrontend

    cfg = acoustic.AcousticConfig(num_layers=1, hidden_size=16, input_dim=120,
                                  num_labels=80)
    gen = torch.Generator().manual_seed(0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    with pytest.raises(RuntimeError):
        acoustic.init_params(gen, cfg)
    with pytest.raises(RuntimeError):
        load_bundle(os.path.join(ROOT, "trained_models", "english-syllables"))
    with pytest.raises(RuntimeError):
        DeviceFrontend("fbank")
    params = acoustic.init_params(gen, cfg, device="cpu")
    audio = np.zeros((1, 4000), np.float32)
    with pytest.raises(RuntimeError):
        cli.transcribe(params, cfg, audio, [4000])
    texts = cli.transcribe(params, cfg, audio, [4000], device="cpu")
    assert len(texts) == 1 and isinstance(texts[0], str)
    with pytest.raises(RuntimeError):
        cli.main(["--file", str(tmp_path / "x.wav"), "--config", "none.ini"])


def test_cli_modes_of_later_slices_raise_not_implemented():
    from rnn_speech_tpu_torch import cli

    for argv in (["--evaluate"], ["--record"], ["--train_acoustic"],
                 ["--file", "x.wav", "--lm_weight", "0.5"]):
        with pytest.raises(NotImplementedError):
            cli.main(argv + ["--device", "cpu"])


def test_flac_raises_a_clear_error(tmp_path):
    from rnn_speech_tpu_torch import audio_io

    path = tmp_path / "x.flac"
    path.write_bytes(b"fLaC" + b"\0" * 64)
    with pytest.raises(audio_io.AudioFormatError, match="runtime slice"):
        audio_io.load(str(path))


# The port's modules, slice by slice; each must exist, be scanned above and
# import without JAX in a fresh interpreter.
PORT_MODULES = [
    # slice 1: serving
    "rnn_speech_tpu_torch.cli", "rnn_speech_tpu_torch.params",
    "rnn_speech_tpu_torch.models.acoustic", "rnn_speech_tpu_torch.ops.frontend",
    "rnn_speech_tpu_torch.ops.decode", "rnn_speech_tpu_torch.ops.lstm",
    "rnn_speech_tpu_torch.ops.lstm_recurrence", "rnn_speech_tpu_torch.ops.lstm_wavefront",
    "rnn_speech_tpu_torch.train.checkpoint",
    # slice 2: the train step
    "rnn_speech_tpu_torch.ops.grad_matmul", "rnn_speech_tpu_torch.ops.ctc",
    "rnn_speech_tpu_torch.ops.editdistance", "rnn_speech_tpu_torch.train.optim",
    "rnn_speech_tpu_torch.train.step",
    # slice 3: the default train step
    "rnn_speech_tpu_torch.ops.random_bits", "rnn_speech_tpu_torch.ops.dropout",
    "rnn_speech_tpu_torch.ops.ctc_kernel",
    # slice 4: the layered training route
    "rnn_speech_tpu_torch.ops.lstm_layer_train",
    # slice 5: the fused fbank frontend
    "rnn_speech_tpu_torch.ops.frontend_kernel",
]


@pytest.mark.parametrize("module", PORT_MODULES)
def test_port_module_is_scanned(module):
    path = os.path.join(ROOT, *module.split(".")) + ".py"
    assert path in _port_sources()


def test_port_modules_import_without_jax():
    import subprocess
    import sys

    code = ("import sys\n"
            + "".join(f"import {m}\n" for m in PORT_MODULES)
            + "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            + repr(FORBIDDEN) + ")\nassert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
