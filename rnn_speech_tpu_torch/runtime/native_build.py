"""Build and load the host runtime library (``native/*.cpp``).

``native/flacdec.cpp`` (the FLAC decoder) and ``native/loader.cpp`` (the
async decode-and-resample thread pool) are compiled by the host's C++
compiler (``$CXX``, else ``g++``) into one shared library at first use,
then loaded with ``ctypes``.  The library goes to
``rnn_speech_tpu_torch/_build/`` (git-ignored) under a name that carries a
hash of the sources and flags, so an edited source is rebuilt and a current
one is reused.  The compiler writes to a temporary name that is renamed
into place, under an ``fcntl.flock`` on a lock file in ``_build/``: test
workers and decode workers that arrive at once build it once.  Nothing is
built when the package is imported.

There is no fallback: a failed build raises ``RuntimeError`` with the
compiler's output.  ``build(tsan=True)`` compiles the ThreadSanitizer
variant (``-fsanitize=thread``) under its own name, which
``runtime/tsan_check.py`` loads.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

NATIVE_DIR = Path(__file__).resolve().parent / "native"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
SOURCES = ("flacdec.cpp", "loader.cpp")

_CXX_FLAGS = ["-O2", "-fPIC", "-std=c++17", "-Wall", "-Wextra", "-shared"]
_TSAN_FLAGS = ["-fsanitize=thread", "-g"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def _flags(tsan: bool):
    return _CXX_FLAGS + (_TSAN_FLAGS if tsan else [])


def library_path(tsan: bool = False) -> Path:
    digest = hashlib.sha1()
    for name in SOURCES:
        digest.update(name.encode())
        digest.update((NATIVE_DIR / name).read_bytes())
    digest.update(" ".join(_flags(tsan)).encode())
    kind = "host_runtime_tsan" if tsan else "host_runtime"
    return BUILD_DIR / f"{kind}-{digest.hexdigest()[:12]}.so"


def build(tsan: bool = False) -> Path:
    """The library's path, compiled first if it is missing."""
    out = library_path(tsan)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / "host_runtime.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if out.exists():            # built while this process waited
            return out
        tmp = out.with_name(f"{out.name}.{os.getpid()}.{threading.get_ident()}.tmp")
        cmd = [os.environ.get("CXX") or "g++", *_flags(tsan), "-o", str(tmp),
               *(str(NATIVE_DIR / name) for name in SOURCES), "-lpthread"]
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
        except (OSError, subprocess.TimeoutExpired) as exc:
            raise RuntimeError(f"host runtime build failed: {' '.join(cmd)}: {exc}") from exc
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"host runtime build failed (exit {proc.returncode}): "
                               f"{' '.join(cmd)}\n{proc.stderr}")
        os.replace(tmp, out)
    return out


def load() -> ctypes.CDLL:
    """The loaded host runtime library, built first if needed."""
    global _lib
    with _lock:
        if _lib is None:
            path = build()
            try:
                _lib = ctypes.CDLL(str(path))
            except OSError as exc:
                raise RuntimeError(f"host runtime {path} does not load: {exc}") from exc
        return _lib
