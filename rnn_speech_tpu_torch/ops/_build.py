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
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, List

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
KERNELS = ("lstm_recurrence", "lstm_wavefront", "lstm_wavefront_train",
           "lstm_wavefront_bwd", "grad_matmul", "dropout", "ctc", "lstm_layer_train",
           "lstm_layer_bwd", "fbank", "lstm_layer_lean",
           "lstm_layer_bwd_persistent", "lstm_wavefront_persistent", "lstm_wavefront_eval",
           "lstm_wavefront_bwd_persistent")

_NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


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
    digest = hashlib.sha1()
    for src in _sources(name):
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    digest.update(" ".join(_NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:12]}.so"


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
        cmd = [nvcc(), *_NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
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


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            if not library_path(name).exists():
                build_all([name])
            lib = ctypes.CDLL(str(library_path(name)))
            _libs[name] = lib
        return lib
