"""ctypes binding to the native FLAC decoder (``native/flacdec.cpp``).

The port's copy of ``rnn_speech_tpu/runtime/audiodec.py``.  The library is
built at first use by ``native_build`` and there is no fallback: where it
cannot be built, decoding raises ``RuntimeError``.  The pure-Python decoder
``flac_py`` is the plain version the tests hold this one against; nothing
on the main path calls it.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import numpy as np

from rnn_speech_tpu_torch.runtime import native_build


def get_native_lib() -> ctypes.CDLL:
    """The host runtime library (built if needed) with the decoder bound."""
    lib = native_build.load()
    if not getattr(lib, "_decoder_bound", False):
        lib.rst_flac_decode.restype = ctypes.c_int
        lib.rst_flac_decode.argtypes = [
            ctypes.c_char_p,
            ctypes.POINTER(ctypes.POINTER(ctypes.c_int32)),
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32),
        ]
        lib.rst_free.restype = None
        lib.rst_free.argtypes = [ctypes.c_void_p]
        lib._decoder_bound = True
    return lib


def decode_flac_native(path: str) -> Tuple[np.ndarray, int]:
    """Decode via the C++ library -> (float32 (n, ch) in [-1, 1], rate)."""
    lib = get_native_lib()
    samples = ctypes.POINTER(ctypes.c_int32)()
    count = ctypes.c_int64()
    channels = ctypes.c_int32()
    rate = ctypes.c_int32()
    bps = ctypes.c_int32()
    rc = lib.rst_flac_decode(
        path.encode(),
        ctypes.byref(samples),
        ctypes.byref(count),
        ctypes.byref(channels),
        ctypes.byref(rate),
        ctypes.byref(bps),
    )
    if rc != 0:
        raise ValueError(f"FLAC decode failed (code {rc}): {path}")
    # Same corrupt-STREAMINFO guard as the C++ consumer (loader.cpp): rc 0
    # with bogus header fields must fail cleanly, not crash on a negative
    # shift or a zero-channel reshape downstream.
    if not (0 < rate.value <= 1_000_000 and channels.value > 0
            and 4 <= bps.value <= 32):
        lib.rst_free(samples)
        raise ValueError(
            f"FLAC decode returned corrupt STREAMINFO (rate {rate.value}, "
            f"channels {channels.value}, bps {bps.value}): {path}"
        )
    try:
        n = count.value * channels.value
        arr = np.ctypeslib.as_array(samples, shape=(n,)).copy()
    finally:
        lib.rst_free(samples)
    scale = float(1 << (bps.value - 1))
    out = (arr.astype(np.float32) / scale).reshape(-1, channels.value)
    return out, rate.value


# The JAX package's decode_flac chooses between this and flac_py; the port
# has only the native decoder.
decode_flac = decode_flac_native
