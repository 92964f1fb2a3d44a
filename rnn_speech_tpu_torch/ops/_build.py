"""Build and load the hand-written CUDA kernels (``csrc/*.cu``).

Each ``.cu`` file has a plain C interface and is compiled by ``nvcc`` into
its own shared library for Hopper (``sm_90a``), then loaded with
``ctypes``: no PyTorch headers, so a build takes seconds.  Libraries go to
``rnn_speech_tpu_torch/_build/`` (git-ignored) under a name that carries a
hash of the sources, so an edited kernel is rebuilt and a current one is
reused.  Nothing is built when the package is imported: the first launch
builds, and ``build_all`` builds every kernel at once, one ``nvcc`` per
source, all started together.

There is no fallback: a failed build raises with the compiler's output.

``RST_BOUNDS_CHECK=1`` in the environment selects the checked build: the
kernels are compiled with ``-DRST_BOUNDS_CHECK``, which makes every
``RST_CHECK(index, bound)`` of ``csrc/bounds_check.cuh`` trap with the
kernel, the index and its bound.  The flag is hashed into the library's
name (``<kernel>-checked-<hash>.so``), so a checked library and a default
one never stand in for each other; off by default, the default names and
code are unchanged.

A library's kernels launch on the CURRENT device, whatever device holds
the tensors, so each wrapper takes its stream from ``launch_stream``,
which raises ``ValueError`` when a CUDA input is not on the current
device (a rank makes its ``cuda:LOCAL_RANK`` current at start,
``parallel/launch.py``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, List, Tuple

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
KERNELS = ("lstm_recurrence", "lstm_wavefront", "lstm_wavefront_train",
           "lstm_wavefront_bwd", "grad_matmul", "dropout", "ctc", "lstm_layer_train",
           "lstm_layer_bwd", "fbank", "lstm_layer_lean",
           "lstm_layer_bwd_persistent", "lstm_wavefront_persistent", "lstm_wavefront_eval",
           "lstm_wavefront_bwd_persistent", "lstm_layer_bwd_f32", "lstm_layer_fwd_f32")

_NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

CHECK_ENV = "RST_BOUNDS_CHECK"
_CHECK_FLAG = "-DRST_BOUNDS_CHECK"

_lock = threading.Lock()
_libs: Dict[Tuple[str, bool], ctypes.CDLL] = {}


def checked() -> bool:
    """Whether the environment selects the bounds-checked build."""
    return os.environ.get(CHECK_ENV, "0") not in ("", "0")


def nvcc_flags() -> List[str]:
    """The kernels' nvcc flags: the default ones, and the check flag where
    ``checked()``."""
    return _NVCC_FLAGS + ([_CHECK_FLAG] if checked() else [])


def nvcc() -> str:
    """Path of nvcc: $CUDA_HOME/bin, then /usr/local/cuda/bin, then PATH."""
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (set CUDA_HOME): the CUDA kernels are built from "
            "rnn_speech_tpu_torch/csrc at first use"
        )
    return found


def _sources(name: str) -> List[Path]:
    return [CSRC_DIR / f"{name}.cu"] + sorted(CSRC_DIR.glob("*.cuh"))


def library_path(name: str) -> Path:
    """The library of kernel ``name`` for the current sources and flags."""
    digest = hashlib.sha1()
    for src in _sources(name):
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    digest.update(" ".join(nvcc_flags()).encode())
    tag = "-checked" if checked() else ""
    return BUILD_DIR / f"{name}{tag}-{digest.hexdigest()[:12]}.so"


def tree_digest(extra: Iterable[Path] = ()) -> str:
    """sha256 of every file of the package (its relative path and bytes, in
    sorted order; the build directory and bytecode left out) and of the
    ``extra`` files: ties a run's record to one tree."""
    digest = hashlib.sha256()
    files = [f for f in PKG_DIR.rglob("*") if f.is_file()
             and BUILD_DIR not in f.parents and "__pycache__" not in f.parts]
    for f in sorted(files) + [Path(e) for e in extra]:
        digest.update(str(f.relative_to(PKG_DIR.parent) if f.is_relative_to(PKG_DIR.parent)
                          else f.name).encode())
        digest.update(f.read_bytes())
    return digest.hexdigest()


def build_all(names: Iterable[str] = KERNELS) -> Dict[str, str]:
    """Compile every named kernel whose library is missing, one nvcc per
    source, all in parallel.  Returns {name: ptxas report}; raises with
    the compiler output if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc(), *nvcc_flags(), "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
        procs[name] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        ), tmp, out)
    reports, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        reports[name] = log
        if proc.returncode != 0:
            failed.append(f"--- {name} (nvcc exit {proc.returncode})\n{log}")
            continue
        os.replace(tmp, out)
        out.with_suffix(".log").write_text(log)
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return reports


def launch_stream(device) -> int:
    """The handle of the current stream for a launch on ``device``'s
    tensors; ``ValueError`` when ``device`` is not the current CUDA device,
    where the library would launch."""
    import torch

    device = torch.device(device)
    if device.type == "cuda" and device.index is not None:
        current = torch.cuda.current_device()
        if device.index != current:
            raise ValueError(f"a CUDA kernel's inputs are on {device} but the current "
                             f"device is cuda:{current}; make it current "
                             f"(torch.cuda.set_device) before the call")
    return torch.cuda.current_stream(device).cuda_stream


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed."""
    key = (name, checked())
    with _lock:
        lib = _libs.get(key)
        if lib is None:
            path = library_path(name)
            if not path.exists():
                build_all([name])
            lib = ctypes.CDLL(str(path))
            _libs[key] = lib
        return lib
