"""Guards of the port's boundaries: it imports no JAX, nothing of the JAX
package and nothing of the top-level ``tools/`` (by name or through a
``sys.path`` entry), its renderer copy is the original byte for byte, and
its entry points refuse to run quietly on the CPU when no GPU is there."""

import ast
import os

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "rnn_speech_tpu_torch")
FORBIDDEN = ("jax", "jaxlib", "rnn_speech_tpu")
# The top-level tools/ directory and the modules in it, which import JAX.
TOOLS = ("tools",) + tuple(sorted(
    f[:-3] for f in os.listdir(os.path.join(ROOT, "tools")) if f.endswith(".py")))


def _port_sources():
    out = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, _, files in os.walk(PKG):
        out += [os.path.join(dirpath, f) for f in files if f.endswith(".py")]
    return sorted(out)


def _imported_roots_of(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module


def _imported_roots(path):
    with open(path) as fh:
        yield from _imported_roots_of(ast.parse(fh.read(), filename=path))


def _tools_path_entries(tree):
    """The ``sys.path`` insertions and appends whose arguments name a
    ``tools`` directory (a string constant "tools" or ending in it)."""
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
                and node.func.attr in ("insert", "append", "extend")
                and ast.unparse(node.func.value) == "sys.path"):
            for arg in node.args:
                for sub in ast.walk(arg):
                    if (isinstance(sub, ast.Constant) and isinstance(sub.value, str)
                            and sub.value.rstrip("/").split("/")[-1] == "tools"):
                        yield ast.unparse(node)


def _tools_refs(source, path="<src>"):
    tree = ast.parse(source, filename=path)
    roots = [n.split(".")[0] for n in _imported_roots_of(tree)]
    return [r for r in roots if r in TOOLS] + list(_tools_path_entries(tree))


@pytest.mark.parametrize("path", _port_sources(),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_port_imports_no_jax_and_nothing_of_the_jax_package(path):
    for name in _imported_roots(path):
        root = name.split(".")[0]
        assert root not in FORBIDDEN, f"{path} imports {name}"
    with open(path) as fh:
        assert not _tools_refs(fh.read(), path), f"{path} reaches the top-level tools/"


@pytest.mark.parametrize("source", [
    "import make_demo_corpus",
    "from flagship_accuracy_run import decode_table",
    "import tools.sweep",
    "import sys, os\nsys.path.insert(0, os.path.join(ROOT, 'tools'))",
    "import sys\nsys.path.append('/repo/tools/')",
])
def test_tools_guard_catches_each_form(source):
    """The guard above flags an import of a top-level tool by name and a
    ``sys.path`` entry into ``tools/``; the port's own ``tools`` package
    and other path entries pass."""
    assert _tools_refs(source)
    assert not _tools_refs("from rnn_speech_tpu_torch.tools import sweep\n"
                           "import sys\nsys.path.insert(0, ROOT)")


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
    from rnn_speech_tpu_torch.parallel import dryrun

    with pytest.raises(RuntimeError, match="device='cpu'"):
        dryrun.dryrun_multichip(2)
    # The accuracy tools, before they render a clip.
    from rnn_speech_tpu_torch.tools import accuracy_benchmark, flagship_accuracy_run

    for tool in (flagship_accuracy_run, accuracy_benchmark):
        workdir = tmp_path / tool.__name__.rsplit(".", 1)[1]
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tool.main(["--workdir", str(workdir), "--out", ""])
        assert not workdir.exists()


def test_cli_modes_of_later_slices_raise_not_implemented(monkeypatch):
    """No mode raises ``NotImplementedError`` any more.  A mesh larger than
    the ranks there are raises ``ValueError`` naming
    ``torch.distributed.run`` before reading any file (it never trains on
    one card), and ``RST_MULTIHOST=1`` with a bad ``RST_PROCESS_ID`` exits
    with the JAX CLI's message."""
    from rnn_speech_tpu import cli as jcli
    from rnn_speech_tpu_torch import cli

    for argv in (["--train_acoustic", "--mesh_data", "2"],
                 ["--evaluate", "--mesh_model", "2"],
                 ["--train_acoustic", "--timeline", "--mesh_data", "4", "--mesh_model", "2"]):
        with pytest.raises(ValueError, match="python -m torch.distributed.run"):
            cli.main(argv + ["--device", "cpu", "--config", "none.ini"])
    monkeypatch.setenv("RST_MULTIHOST", "1")
    monkeypatch.setenv("RST_COORD_ADDR", "localhost:1")
    monkeypatch.setenv("RST_NUM_PROCESSES", "2")
    monkeypatch.setenv("RST_PROCESS_ID", "one")
    with pytest.raises(SystemExit) as port:
        cli.main(["--train_acoustic", "--device", "cpu", "--config", "none.ini"])
    with pytest.raises(SystemExit) as ref:
        jcli.main(["--train_acoustic", "--config", "none.ini"])
    assert str(port.value) == str(ref.value)
    assert "RST_PROCESS_ID must be a non-negative integer (got 'one')" in str(port.value)


def test_flac_raises_a_clear_error(tmp_path):
    """FLAC decodes (the native decoder, ``runtime/audiodec.py``): a file
    without a valid stream raises the decoder's error, and an Ogg file
    still raises ``AudioFormatError`` naming its container."""
    from rnn_speech_tpu_torch import audio_io

    path = tmp_path / "x.flac"
    path.write_bytes(b"fLaC" + b"\0" * 64)
    with pytest.raises(ValueError, match="FLAC decode failed"):
        audio_io.load(str(path))
    ogg = tmp_path / "x.ogg"
    ogg.write_bytes(b"OggS" + b"\0" * 64)
    with pytest.raises(audio_io.AudioFormatError, match="Ogg/Vorbis decoding is not supported"):
        audio_io.load(str(ogg))
    with pytest.raises(audio_io.AudioFormatError, match="Ogg"):
        audio_io.probe_duration(str(ogg))


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
    # slice 14: training and evaluation from the CLI
    "rnn_speech_tpu_torch.audio_io", "rnn_speech_tpu_torch.frontend",
    "rnn_speech_tpu_torch.runtime.flac_py", "rnn_speech_tpu_torch.runtime.flac_enc",
    "rnn_speech_tpu_torch.corpus", "rnn_speech_tpu_torch.models.recognizer",
    "rnn_speech_tpu_torch.train.pipeline", "rnn_speech_tpu_torch.ops.augment",
    "rnn_speech_tpu_torch.train.metrics", "rnn_speech_tpu_torch.train.tbevents",
    "rnn_speech_tpu_torch.train.loop", "rnn_speech_tpu_torch.synth",
    # slice 15: the native host runtime
    "rnn_speech_tpu_torch.runtime.native_build", "rnn_speech_tpu_torch.runtime.audiodec",
    "rnn_speech_tpu_torch.runtime.loader", "rnn_speech_tpu_torch.runtime.tsan_check",
    # slice 19: the char LM, its training and chunk-carried streaming
    "rnn_speech_tpu_torch.models.language", "rnn_speech_tpu_torch.train.lm_loop",
    "rnn_speech_tpu_torch.streaming",
    # slice 20: multi-GPU training and evaluation
    "rnn_speech_tpu_torch.parallel", "rnn_speech_tpu_torch.parallel.launch",
    "rnn_speech_tpu_torch.parallel.mesh", "rnn_speech_tpu_torch.parallel.lockstep",
    "rnn_speech_tpu_torch.parallel.sharding", "rnn_speech_tpu_torch.parallel.dryrun",
    # slice 22: the accuracy tools
    "rnn_speech_tpu_torch.tools", "rnn_speech_tpu_torch.tools.make_demo_corpus",
    "rnn_speech_tpu_torch.tools.flagship_accuracy_run",
    "rnn_speech_tpu_torch.tools.beam_quality_run",
    "rnn_speech_tpu_torch.tools.accuracy_benchmark", "rnn_speech_tpu_torch.tools.sweep",
]


@pytest.mark.parametrize("module", PORT_MODULES)
def test_port_module_is_scanned(module):
    path = os.path.join(ROOT, *module.split(".")) + ".py"
    if not os.path.exists(path):
        path = os.path.join(ROOT, *module.split("."), "__init__.py")
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
