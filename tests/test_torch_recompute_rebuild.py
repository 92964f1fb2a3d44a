"""The recompute backward's chunked design (``ops/lstm_layer_train.py``):
the gates of a chunk of steps rebuilt by one product (``rebuild_gates``),
then the chunk's serial steps, chunks last first.

* ``rebuild_gates_plain``, the plain version the card holds the rebuild
  kernel against, against the formula in float64 numpy.
* The chunked decomposition in plain PyTorch (a model of the kernel's
  loop: ``rebuild_chunks``' order, ``rebuild_gates_plain`` on the chunk's
  rows, then the reverse steps) against ``recurrence_bwd_recompute_plain``
  and against the JAX package's ``_lstm_recurrence_bwd_recompute`` in TPU
  interpret mode, at H=64, D=128, B=5 and 18 (not multiples of 16) with a
  zero-length row, and T = 1, C-1, C, C+1, 2C+3 for a chunk of C=4 steps.
* The chunk planner: the chunk buffer stays within ``REBUILD_BYTES``,
  C >= 1, and the chunks cover [0, T) once, last first (``rebuild_chunks``
  is the plan the wrapper hands the kernel, which runs it in that order).

Tolerances: the float64 oracle of the rebuild, 1e-6 absolute on values in
(0, 1) (float32 sums of 192 products).  The chunked model against the
per-step plain version: in float32 the same operations on the same rows,
1e-5 relative and absolute; in bf16 both round the same float32 values
to bf16, so equal up to a rare rounding flip, 4e-3 as
``tests/test_torch_layered_train.py`` states for bf16.  Against JAX: the
same float32 arithmetic in another order, 1e-5 in float32 and 4e-3 in
bf16 (a rounding flip of a bf16 dgates element propagates).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from rnn_speech_tpu.ops import lstm_pallas as jpal
from rnn_speech_tpu_torch.ops import lstm_layer_train as tlt

H, D, C = 64, 128, 4
F32 = dict(rtol=1e-5, atol=1e-5)
BF16 = dict(rtol=4e-3, atol=4e-3)
DTYPES = {"f32": (jnp.float32, torch.float32, F32),
          "bf16": (jnp.bfloat16, torch.bfloat16, BF16)}


def _t(a, dtype):
    return torch.tensor(np.asarray(a, np.float32)).to(dtype)


def _problem(T, B, seed, jd):
    """The recompute backward's inputs: residuals x, h_prev, cseq rounded to
    ``jd``, weights in ``jd``, an f32 bias, states and cotangents, ragged
    lengths with a zero-length row and a full one."""
    rng = np.random.default_rng(seed)
    f = lambda *s, scale: rng.normal(0, scale, s).astype(np.float32)
    rd = lambda a: np.asarray(jnp.asarray(a, jd).astype(jnp.float32))
    lens = np.asarray([T if b == 0 else (0 if b == 2 else 1 + (7 * b) % T) for b in range(B)])
    return dict(dout=f(T, B, H, scale=1.0), x=rd(f(T, B, D, scale=1.0)),
                h_prev=rd(f(T, B, H, scale=0.5)), cseq=rd(f(T, B, H, scale=0.7)),
                c0=rd(f(B, H, scale=0.5)),
                mask=(np.arange(T)[:, None] < lens[None]).astype(np.float32)[:, None, :],
                w_x=rd(f(D, 4 * H, scale=0.15)), b=f(4 * H, scale=0.1),
                w_h=rd(f(H, 4 * H, scale=0.15)), dhn=f(B, H, scale=0.5),
                dcn=f(B, H, scale=0.5))


ORDER = ("dout", "x", "h_prev", "cseq", "c0", "mask", "w_x", "b", "w_h", "dhn", "dcn")


def _torch_args(p, td):
    in_rd = {"x", "h_prev", "cseq", "w_x", "w_h"}
    return [_t(p[k], td if k in in_rd else torch.float32) for k in ORDER]


def chunked_bwd(dout, x, h_prev, cseq, c0, mask, w_x, b, w_h, dhn, dcn, chunk):
    """The kernel's loop in plain PyTorch: for the chunks of
    ``rebuild_chunks`` (last first), the chunk's activated gates from one
    ``rebuild_gates_plain`` over its (steps·B) rows, then its reverse
    steps reading them."""
    T, B, _ = cseq.shape
    chunks = iter(tlt.rebuild_chunks(T, chunk))
    held = {"t0": T}

    def acts(t):
        if t < held["t0"]:                   # the chain has left the chunk: the next one
            t0, t1 = next(chunks)
            assert t1 == held["t0"] and t0 <= t < t1
            rows = tlt.rebuild_gates_plain(x[t0:t1].reshape(-1, x.shape[-1]),
                                           h_prev[t0:t1].reshape(-1, H), w_x, w_h, b)
            held.update(t0=t0, act=rows.reshape(t1 - t0, B, 4 * H))
        return held["act"][t - held["t0"]].split(H, dim=-1)

    dgates = cseq.new_empty((T, B, 4 * H), dtype=x.dtype)
    out = tlt._backward_plain(dout, acts, cseq, c0, mask, w_h, dhn, dcn, dgates)
    assert held["t0"] == 0 and next(chunks, None) is None
    return out


def _close(ref, got, tol):
    for r, g in zip(ref, got):
        np.testing.assert_allclose(g.detach().to(torch.float32).numpy(),
                                   np.asarray(r, np.float32), **tol)


def test_rebuild_gates_plain_matches_the_formula():
    rng = np.random.default_rng(3)
    rows = 37
    x, h = rng.normal(0, 1, (rows, D)), rng.normal(0, 0.5, (rows, H))
    w_x, w_h = rng.normal(0, 0.15, (D, 4 * H)), rng.normal(0, 0.15, (H, 4 * H))
    b = rng.normal(0, 0.1, 4 * H)
    to = lambda a: torch.tensor(a, dtype=torch.float32)
    got = tlt.rebuild_gates_plain(to(x).to(torch.bfloat16), to(h).to(torch.bfloat16),
                                  to(w_x).to(torch.bfloat16), to(w_h).to(torch.bfloat16), to(b))
    r = lambda a: to(a).to(torch.bfloat16).to(torch.float64).numpy()
    pre = r(x) @ r(w_x) + r(h) @ r(w_h) + to(b).double().numpy()
    sig = lambda v: 1.0 / (1.0 + np.exp(-v))
    i, g, f, o = np.split(pre, 4, axis=1)
    ref = np.concatenate([sig(i), np.tanh(g), sig(f + 1.0), sig(o)], axis=1)
    assert got.dtype == torch.float32 and got.shape == (rows, 4 * H)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-6)


@pytest.mark.parametrize("B", [5, 18])
@pytest.mark.parametrize("T", [1, C - 1, C, C + 1, 2 * C + 3])
@pytest.mark.parametrize("rd", list(DTYPES))
def test_chunked_backward_matches_plain_and_jax(rd, T, B):
    jd, td, tol = DTYPES[rd]
    p = _problem(T, B, seed=10 * T + B, jd=jd)
    args = _torch_args(p, td)
    got = chunked_bwd(*args, chunk=C)
    per_step = tlt.recurrence_bwd_recompute_plain(*args)
    assert got[0].dtype == td
    _close([a.to(torch.float32).numpy() for a in per_step], got, tol)

    j = {k: jnp.asarray(p[k], jd if k in ("x", "h_prev", "cseq", "w_x", "w_h") else
                        jnp.float32) for k in ORDER}
    c_prev = jnp.concatenate([j["c0"].astype(jd)[None], j["cseq"][:-1]], axis=0)
    with pltpu.force_tpu_interpret_mode():
        ref = jax.jit(jpal._lstm_recurrence_bwd_recompute)(
            j["dout"], j["x"], j["h_prev"], j["cseq"], c_prev, j["mask"], j["w_x"],
            j["b"].reshape(1, -1), j["w_h"], j["dhn"], j["dcn"])
    _close([np.asarray(a.astype(jnp.float32)) for a in ref], got, tol)


@pytest.mark.parametrize("T,B,Hh", [(3510, 400, 1024), (3510, 473, 1024), (3510, 64, 1024),
                                    (235, 70, 1024), (1, 5, 64), (11, 18, 64),
                                    (7, 100_000, 1024)])
def test_chunk_planner_covers_the_steps_within_the_cap(T, B, Hh):
    chunk = tlt.rebuild_chunk(T, B, Hh)
    assert 1 <= chunk <= T
    assert chunk == 1 or chunk * B * 4 * Hh * 4 <= tlt.REBUILD_BYTES
    if chunk < T:                            # the cap, not T, set it
        assert (chunk + 1) * B * 4 * Hh * 4 > tlt.REBUILD_BYTES
    chunks = tlt.rebuild_chunks(T, chunk)
    assert chunks[0][1] == T and chunks[-1][0] == 0
    for (a0, a1), (b0, b1) in zip(chunks, chunks[1:]):
        assert b1 == a0                      # last first, no gap, no overlap
    assert all(0 < t1 - t0 <= chunk for t0, t1 in chunks)
    assert sum(t1 - t0 for t0, t1 in chunks) == T


def test_planner_at_the_flagship_recompute_batch():
    """B=400, H=1024: 40 steps of (400, 4096) float32, 262 MB, a chunk."""
    assert tlt.rebuild_chunk(3510, 400, 1024) == 40
    assert len(tlt.rebuild_chunks(3510, 40)) == 88
