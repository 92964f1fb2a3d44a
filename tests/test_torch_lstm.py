"""The port's LSTM (plain layer, stack dispatch, both kernels' plain
versions) against the JAX package: the scan path and both Pallas inference
kernels in interpret mode.

Tolerances: float32 against float32 differs only in summation order, so
1e-5 absolute; with bf16 compute both sides round h and the weights to
bf16 identically and sum in float32, so a rare bf16 rounding flip of an
h element is the only divergence, bounded at 2e-3 over these short runs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rnn_speech_tpu.ops import lstm as jlstm
from rnn_speech_tpu.ops import lstm_pallas as jpallas
from rnn_speech_tpu.ops import lstm_wavefront as jwave
from rnn_speech_tpu_torch.ops import lstm as tlstm
from rnn_speech_tpu_torch.ops import lstm_recurrence as trec
from rnn_speech_tpu_torch.ops import lstm_wavefront as twave

F32_TOL = 1e-5
BF16_TOL = 2e-3
DTYPES = {"f32": (jnp.float32, torch.float32, F32_TOL),
          "bf16": (jnp.bfloat16, torch.bfloat16, BF16_TOL)}


def _stack(seed, L, D, H):
    rng = np.random.default_rng(seed)
    layers = []
    for l in range(L):
        d = D if l == 0 else H
        layers.append({
            "w_x": rng.normal(0, 0.3, (d, 4 * H)).astype(np.float32),
            "w_h": rng.normal(0, 0.3, (H, 4 * H)).astype(np.float32),
            "b": rng.normal(0, 0.1, (4 * H,)).astype(np.float32),
        })
    return layers


def _inputs(seed, T, B, D, H, L, lengths):
    rng = np.random.default_rng(seed + 1)
    x = rng.normal(0, 1, (T, B, D)).astype(np.float32)
    states = [(rng.normal(0, 0.2, (B, H)).astype(np.float32),
               rng.normal(0, 0.2, (B, H)).astype(np.float32)) for _ in range(L)]
    return x, np.asarray(lengths, np.int32), states


def _j(tree):
    return jax.tree.map(jnp.asarray, tree)


def _t(tree):
    return jax.tree.map(torch.as_tensor, tree)


def _close(a, b, tol):
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               np.asarray(b.detach().numpy(), np.float32),
                               rtol=0, atol=tol)


# Ragged rows including a zero-length row and a full-length one.
LENGTHS = [[9, 4, 0, 1, 9], [16, 16, 3, 11, 0]]


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("lengths", LENGTHS)
def test_layer_scan_matches_jax(dtype, lengths):
    jd, td, tol = DTYPES[dtype]
    T, B, D, H = max(lengths), 5, 7, 32
    layer = _stack(0, 1, D, H)[0]
    x, lens, states = _inputs(0, T, B, D, H, 1, lengths)
    ref, (rc, rh) = jlstm.lstm_layer_scan(_j(layer), jnp.asarray(x),
                                          jnp.asarray(lens), _j(states[0]),
                                          compute_dtype=jd)
    out, (c, h) = tlstm.lstm_layer_scan(_t(layer), torch.as_tensor(x),
                                        torch.as_tensor(lens), _t(states[0]),
                                        compute_dtype=td)
    _close(ref, out, tol)
    _close(rc, c, tol)
    _close(rh, h, tol)


@pytest.mark.parametrize("use_kernels,wavefront",
                         [(False, False), (True, False), (True, True)])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_stack_matches_jax_scan(use_kernels, wavefront, dtype):
    """Every dispatch of the port's stack (scan, layered kernel path,
    wavefront) against the JAX scan stack."""
    jd, td, tol = DTYPES[dtype]
    T, B, D, H, L = 12, 4, 6, 32, 3
    lengths = [12, 7, 0, 1]
    layers = _stack(1, L, D, H)
    x, lens, states = _inputs(1, T, B, D, H, L, lengths)
    ref, ref_states = jlstm.lstm_stack(_j(layers), jnp.asarray(x),
                                       jnp.asarray(lens), _j(states),
                                       compute_dtype=jd)
    out, new_states = tlstm.lstm_stack(_t(layers), torch.as_tensor(x),
                                       torch.as_tensor(lens), _t(states),
                                       compute_dtype=td, use_kernels=use_kernels,
                                       wavefront=wavefront)
    _close(ref, out, tol)
    for (rc, rh), (c, h) in zip(ref_states, new_states):
        _close(rc, c, tol)
        _close(rh, h, tol)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("lengths", LENGTHS)
def test_recurrence_plain_matches_pallas_interpret(dtype, lengths):
    """The recurrence kernel's plain version against the TPU kernel
    ``lstm_recurrence_pallas`` run in interpret mode, same inputs."""
    from jax.experimental.pallas import tpu as pltpu

    jd, td, tol = DTYPES[dtype]
    T, B, H = max(lengths), 5, 32
    rng = np.random.default_rng(2)
    xp = rng.normal(0, 1, (T, B, 4 * H)).astype(np.float32)
    w_h = rng.normal(0, 0.3, (H, 4 * H)).astype(np.float32)
    h0 = rng.normal(0, 0.2, (B, H)).astype(np.float32)
    c0 = rng.normal(0, 0.2, (B, H)).astype(np.float32)
    mask = (np.arange(T)[:, None] < np.asarray(lengths)[None]).astype(
        np.float32)[:, None, :]
    with pltpu.force_tpu_interpret_mode():
        ref = jpallas.lstm_recurrence_pallas(
            jnp.asarray(xp), jnp.asarray(w_h).astype(jd), jnp.asarray(mask),
            jnp.asarray(h0), jnp.asarray(c0))
    got = trec.lstm_recurrence(
        torch.as_tensor(xp), torch.as_tensor(w_h).to(td), torch.as_tensor(mask),
        torch.as_tensor(h0), torch.as_tensor(c0))
    for r, g in zip(ref, got):
        _close(r, g, tol)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("L", [2, 3])
def test_wavefront_plain_matches_pallas_interpret(dtype, L):
    """The wavefront kernel's plain version against the TPU kernel through
    ``lstm_stack_wavefront_apply(..., interpret=True)``."""
    jd, td, tol = DTYPES[dtype]
    T, B, D, H = 10, 3, 5, 32
    lengths = [10, 0, 4]
    layers = _stack(3, L, D, H)
    x, lens, states = _inputs(3, T, B, D, H, L, lengths)
    ref, ref_states = jwave.lstm_stack_wavefront_apply(
        _j(layers), jnp.asarray(x), jnp.asarray(lens), _j(states),
        compute_dtype=jd, interpret=True)
    out, new_states = twave.lstm_stack_wavefront_apply(
        _t(layers), torch.as_tensor(x), torch.as_tensor(lens), _t(states),
        compute_dtype=td)
    _close(ref, out, tol)
    for (rc, rh), (c, h) in zip(ref_states, new_states):
        _close(rc, c, tol)
        _close(rh, h, tol)


def test_wavefront_reads_carried_state_of_lower_layer():
    """Layer l >= 1 takes the lower layer's carried h (frozen past a row's
    length), not its zeroed output: with zero-length rows and a nonzero
    h0 the two differ, and the plain version must follow the carry."""
    T, B, D, H, L = 6, 2, 4, 16, 2
    layers = _stack(4, L, D, H)
    x, lens, states = _inputs(4, T, B, D, H, L, [0, 6])
    ref, _ = jwave.lstm_stack_wavefront_apply(
        _j(layers), jnp.asarray(x), jnp.asarray(lens), _j(states),
        interpret=True)
    out, _ = twave.lstm_stack_wavefront_apply(
        _t(layers), torch.as_tensor(x), torch.as_tensor(lens), _t(states))
    _close(ref, out, F32_TOL)


def test_wrappers_take_plain_path_on_cpu_and_count_no_launch():
    trec.lstm_recurrence.launches = 0
    twave.lstm_stack_wavefront.launches = 0
    T, B, D, H, L = 4, 2, 3, 16, 2
    layers = _stack(5, L, D, H)
    x, lens, states = _inputs(5, T, B, D, H, L, [4, 2])
    for wavefront in (False, True):
        tlstm.lstm_stack(_t(layers), torch.as_tensor(x), torch.as_tensor(lens),
                         _t(states), use_kernels=True, wavefront=wavefront)
    assert trec.lstm_recurrence.launches == 0
    assert twave.lstm_stack_wavefront.launches == 0
