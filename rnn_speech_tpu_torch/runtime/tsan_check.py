"""ThreadSanitizer harness for the native async loader (``native/loader.cpp``).

Builds the host runtime with ``-fsanitize=thread``
(``native_build.build(tsan=True)``) and drives the loader's concurrency
surface through its C ABI:

  * many submit/next cycles over a multi-thread pool with a tiny capacity
    (maximal contention on the done-map / order-queue / capacity predicate)
  * ``destroy()`` with work still queued (the dying path)
  * interleaved submit and next, with ``close()`` racing in-flight decodes

TSan reports go to stderr; a nonzero exit means a race or a hang.

Run:  python -m rnn_speech_tpu_torch.runtime.tsan_check

libtsan must be loaded before the interpreter allocates its thread-local
storage; where loading the library fails on that, the harness runs itself
again with ``LD_PRELOAD`` set to the compiler's ``libtsan.so``.
"""

from __future__ import annotations

import ctypes
import os
import signal
import subprocess
import sys
import tempfile

import numpy as np

from rnn_speech_tpu_torch import audio_io
from rnn_speech_tpu_torch.runtime import native_build
from rnn_speech_tpu_torch.runtime.loader import _bind

_REEXEC = "_RST_TORCH_TSAN_REEXEC"
MAX_SAMPLES = 1 << 18


def make_corpus(root: str, n: int = 12):
    """n 16 kHz WAV clips of noise and one missing path (the error branch
    under contention)."""
    rng = np.random.default_rng(0)
    paths = []
    for i in range(n):
        p = os.path.join(root, f"c{i}.wav")
        audio_io.write_wav(
            p, (rng.normal(0, 0.2, 4000 + 317 * i) * 20000).astype(np.int16), 16000)
        paths.append(p.encode())
    paths.append(os.path.join(root, "missing.wav").encode())
    return paths


def next_item(lib, handle, buf) -> int:
    index = ctypes.c_int64()
    n = ctypes.c_int64()
    return lib.rst_loader_next(
        handle, ctypes.byref(index), buf.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        len(buf), ctypes.byref(n))


def drain(lib, handle, buf) -> int:
    got = 0
    while next_item(lib, handle, buf) != -1:
        got += 1
    return got


def load_tsan_lib() -> ctypes.CDLL:
    path = native_build.build(tsan=True)
    try:
        return ctypes.CDLL(str(path))
    except OSError as exc:
        if "static TLS" not in str(exc) or os.environ.get(_REEXEC):
            raise
    cxx = os.environ.get("CXX") or "g++"
    tsan = subprocess.run([cxx, "-print-file-name=libtsan.so"], capture_output=True,
                          text=True, check=True).stdout.strip()
    pkg_root = str(native_build.NATIVE_DIR.parent.parent.parent)
    pythonpath = os.pathsep.join(p for p in (pkg_root, os.environ.get("PYTHONPATH")) if p)
    env = dict(os.environ, LD_PRELOAD=tsan, PYTHONPATH=pythonpath, **{_REEXEC: "1"})
    os.execve(sys.executable, [sys.executable, "-m", __spec__.name], env)


def main() -> int:
    # A loader deadlock (the bug class this harness hunts) would block
    # rst_loader_next forever: die loudly instead of hanging.
    def on_timeout(signum, frame):
        raise SystemExit("TSAN HARNESS TIMEOUT: loader appears deadlocked")

    signal.signal(signal.SIGALRM, on_timeout)
    signal.alarm(600)

    lib = _bind(load_tsan_lib())
    with tempfile.TemporaryDirectory() as root:
        paths = make_corpus(root)
        buf = np.empty((MAX_SAMPLES,), np.float32)

        # 1) Contended submit/next cycles, tiny capacity.
        for round_i in range(30):
            handle = lib.rst_loader_create(4, MAX_SAMPLES, 22050, 2)
            for i, p in enumerate(paths):
                lib.rst_loader_submit(handle, i, p)
            lib.rst_loader_close(handle)
            got = drain(lib, handle, buf)
            assert got == len(paths), (round_i, got)
            lib.rst_loader_destroy(handle)

        # 2) Destroy with work still queued (the dying path races workers).
        for _ in range(30):
            handle = lib.rst_loader_create(4, MAX_SAMPLES, 22050, 2)
            for i, p in enumerate(paths):
                lib.rst_loader_submit(handle, i, p)
            lib.rst_loader_destroy(handle)

        # 3) Interleaved submit and next (consumer ahead of producer), then
        # close() while decodes are still in flight.
        handle = lib.rst_loader_create(3, MAX_SAMPLES, 22050, 4)
        taken = 0
        for i, p in enumerate(paths * 5):
            lib.rst_loader_submit(handle, i, p)
            if i % 3 == 0:
                assert next_item(lib, handle, buf) != -1
                taken += 1
        lib.rst_loader_close(handle)
        taken += drain(lib, handle, buf)
        assert taken == len(paths) * 5, taken
        lib.rst_loader_destroy(handle)

    print("TSAN HARNESS PASSED (check stderr for sanitizer reports)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
