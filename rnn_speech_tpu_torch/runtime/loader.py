"""ctypes binding to the native async audio loader (``native/loader.cpp``).

The port's copy of ``rnn_speech_tpu/runtime/loader.py``.
``NativeAudioLoader`` drives the C++ thread pool: submit a list of audio
paths, iterate decoded (float32 mono, resampled, truncated) clips back in
submission order.  Worker threads write PCM straight into buffers this
side copies out, so no clip goes through pickle.  The library is built at
first use (``native_build``) and there is no fallback: where it cannot be
built, the loader raises ``RuntimeError``.

Delivery order is deterministic (submission order) regardless of worker
scheduling, so training batches are reproducible across runs.
"""

from __future__ import annotations

import ctypes
from typing import Iterator, List, Optional, Tuple

import numpy as np

from rnn_speech_tpu_torch.runtime import audiodec

# Items (decoded or not) that every loader of this process delivered.
delivered = 0


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    if getattr(lib, "_loader_bound", False):
        return lib
    lib.rst_loader_create.restype = ctypes.c_void_p
    lib.rst_loader_create.argtypes = [
        ctypes.c_int, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
    ]
    lib.rst_loader_submit.restype = ctypes.c_int
    lib.rst_loader_submit.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_char_p,
    ]
    lib.rst_loader_close.restype = None
    lib.rst_loader_close.argtypes = [ctypes.c_void_p]
    lib.rst_loader_next.restype = ctypes.c_int
    lib.rst_loader_next.argtypes = [
        ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_float),
        ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64),
    ]
    lib.rst_loader_destroy.restype = None
    lib.rst_loader_destroy.argtypes = [ctypes.c_void_p]
    lib._loader_bound = True
    return lib


class NativeAudioLoader:
    """Asynchronously decode a list of files with native worker threads.

    Iterating yields ``(index, audio or None, rc)`` in submission order:
    ``audio`` is float32 mono at ``target_rate`` truncated to
    ``max_samples``; ``rc`` is nonzero (audio None) for undecodable files.
    """

    def __init__(
        self,
        paths: List[str],
        *,
        max_samples: int,
        target_rate: int,
        n_threads: int = 4,
        capacity: int = 64,
    ):
        self._handle = None
        self._lib = _bind(audiodec.get_native_lib())
        self._max_samples = int(max_samples)
        self._paths = [str(p).encode() for p in paths]
        self._handle = self._lib.rst_loader_create(
            int(n_threads), self._max_samples, int(target_rate), int(capacity)
        )
        # Lazy submission: keep ~2x capacity in flight instead of pushing
        # the whole (possibly corpus-sized) path list through the FFI and
        # into the C++ task deque up front.
        self._submitted = 0
        self._delivered = 0
        self._window = max(2 * int(capacity), int(n_threads) * 2)
        self._closed = False
        self._fill()
        self._buf = np.empty((self._max_samples,), np.float32)

    def _fill(self) -> None:
        # Keep at most `window` undelivered items in flight: the target is
        # anchored to items *delivered*, not items submitted, so submission
        # advances in lockstep with consumption instead of by `window` per
        # __next__ call (which would eagerly push the whole corpus).
        target = min(len(self._paths), self._delivered + self._window)
        while self._submitted < target:
            self._lib.rst_loader_submit(
                self._handle, self._submitted, self._paths[self._submitted]
            )
            self._submitted += 1
        if self._submitted == len(self._paths) and not self._closed:
            self._lib.rst_loader_close(self._handle)
            self._closed = True

    def __iter__(self) -> Iterator[Tuple[int, Optional[np.ndarray], int]]:
        return self

    def __next__(self):
        if self._handle is None:
            raise StopIteration
        self._fill()
        index = ctypes.c_int64()
        n = ctypes.c_int64()
        rc = self._lib.rst_loader_next(
            self._handle, ctypes.byref(index),
            self._buf.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            self._max_samples, ctypes.byref(n),
        )
        if rc == -1:
            self.close()
            raise StopIteration
        global delivered
        self._delivered += 1
        delivered += 1
        if rc != 0:
            return int(index.value), None, rc
        return int(index.value), self._buf[: n.value].copy(), 0

    def close(self) -> None:
        if self._handle is not None:
            self._lib.rst_loader_destroy(self._handle)
            self._handle = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):  # pragma: no cover - GC safety net
        try:
            self.close()
        except Exception:
            pass
