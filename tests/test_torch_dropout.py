"""The port's dropout: the counter-based generator (``ops/random_bits.py``),
the fused dropout's plain version and its gradient (``ops/dropout.py``),
the dropout sites and ``_DroppedDense`` (``models/acoustic.py``) against the
JAX package's ``_dense`` on the explicitly masked input.

The bits cannot match the TPU's (its core generator has no CPU model:
interpret mode draws zeros), so the generator is held against a numpy
reimplementation of Philox4x32-10 and the published known-answer vectors
(bit for bit), and the masks by their statistics: a kept fraction within
4 sigma of the keep (sigma = sqrt(k(1-k)/n)), independent boundaries
agreeing at kp^2 + (1-kp)^2 within 4 sigma.  Dropout outputs are exact:
0 or x times the scale rounded to x's dtype.  ``_DroppedDense`` against
JAX: float32 1e-5 (the same products in another order); bf16 2e-3
(bf16 operands; JAX rounds the projection's input cotangent to bf16 before
the mask scale, the port after).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from rnn_speech_tpu.models import acoustic as jac
from rnn_speech_tpu_torch.models import acoustic as tac
from rnn_speech_tpu_torch.ops import dropout as tdrop
from rnn_speech_tpu_torch.ops import random_bits as rb

M32 = np.uint64(0xFFFFFFFF)


def _philox_np(ctr, key):
    """Philox4x32-10 in numpy uint64 arithmetic (products < 2^64)."""
    c = [np.asarray(v, np.uint64) for v in ctr]
    k0, k1 = np.uint64(key[0]), np.uint64(key[1])
    for r in range(10):
        if r:
            k0 = (k0 + np.uint64(0x9E3779B9)) & M32
            k1 = (k1 + np.uint64(0xBB67AE85)) & M32
        p0 = np.uint64(0xD2511F53) * c[0]
        p1 = np.uint64(0xCD9E8D57) * c[2]
        c = [(p1 >> np.uint64(32)) ^ c[1] ^ k0, p1 & M32,
             (p0 >> np.uint64(32)) ^ c[3] ^ k1, p0 & M32]
    return c


KAT = [  # Random123's known-answer vectors for philox4x32-10
    ((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2,
     (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344), (0xA4093822, 0x299F31D0),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
]


@pytest.mark.parametrize("case", range(len(KAT)))
def test_philox_known_answers(case):
    ctr, key, want = KAT[case]
    got = rb.philox4x32(*[torch.tensor([c], dtype=torch.int64) for c in ctr], key)
    assert [int(w) for w in got] == list(want)
    assert [int(w) for w in _philox_np(ctr, key)] == list(want)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_plain_generator_matches_numpy_on_a_grid(seed):
    """Random counters (full 32-bit range) and keys: bit-equal words."""
    rng = np.random.default_rng(seed)
    ctr = rng.integers(0, 2 ** 32, (4, 4096), dtype=np.uint64)
    key = [int(v) for v in rng.integers(0, 2 ** 32, 2, dtype=np.uint64)]
    got = rb.philox4x32(*[torch.as_tensor(c.astype(np.int64)) for c in ctr], key)
    for g, w in zip(got, _philox_np(ctr, key)):
        np.testing.assert_array_equal(g.numpy().astype(np.uint64), w)


def test_counter_layouts_follow_logical_coordinates():
    """Dropout: element n is word n & 3 of counter (n >> 2, n >> 34, k, 0);
    wavefront: (l, t, b, j) is word j & 3 of counter (j >> 2, b, t, l)."""
    seed, keep = (12345, 678910), 0.6
    thr = rb.threshold(keep)
    n = np.arange(1001, dtype=np.uint64)
    for k in (0, 1):
        w = _philox_np((n >> np.uint64(2), n >> np.uint64(34), n * 0 + k, n * 0), seed)
        want = np.choose((n & np.uint64(3)).astype(np.int64), w) < thr
        got = rb.flat_keep_mask(seed, 1001, k, keep, "cpu").numpy()
        np.testing.assert_array_equal(got, want)
    L1, T, B, H = 2, 3, 5, 8
    l, t, b, j = np.meshgrid(*[np.arange(d, dtype=np.uint64) for d in (L1, T, B, H)],
                             indexing="ij")
    w = _philox_np((j >> np.uint64(2), b, t, l), seed)
    want = np.choose((j & np.uint64(3)).astype(np.int64), w) < thr
    got = rb.wavefront_masks(seed, L1, T, B, H, keep, "cpu").numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("keep", [0.8, 0.5, 0.4])
def test_kept_fraction_within_four_sigma(keep):
    n = 3 * 64 * 1024
    for mask in (rb.flat_keep_mask((7, 11), n, 0, keep, "cpu"),
                 rb.wavefront_masks((7, 11), 1, 3, 64, 1024, keep, "cpu")):
        frac = float(mask.float().mean())
        assert abs(frac - keep) <= 4 * (keep * (1 - keep) / n) ** 0.5


def test_boundaries_draw_independent_masks():
    """Two boundaries' masks agree at kp^2 + (1 - kp)^2 (independent), and
    another seed gives another mask."""
    kp = 0.4
    m = rb.wavefront_masks((3, 4), 2, 4, 64, 512, kp, "cpu")
    n = m[0].numel()
    p = kp ** 2 + (1 - kp) ** 2
    agree = float((m[0] == m[1]).float().mean())
    assert abs(agree - p) <= 4 * (p * (1 - p) / n) ** 0.5
    other = rb.wavefront_masks((3, 5), 2, 4, 64, 512, kp, "cpu")
    assert abs(float((m == other).float().mean()) - p) <= 4 * (p * (1 - p) / n) ** 0.5


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dropout_output_is_zero_or_scaled(dtype):
    x = (torch.randn((37, 5, 64), generator=torch.Generator().manual_seed(0)) + 3).to(dtype)
    out = tdrop.dropout_kernel(x, (1, 2), [0.8])
    scaled = x * torch.tensor(1 / 0.8, dtype=dtype)
    kept = out != 0
    assert out.dtype == dtype and out.shape == x.shape
    assert torch.equal(out[kept], scaled[kept])
    assert abs(float(kept.float().mean()) - 0.8) < 0.02
    assert torch.equal(kept.reshape(-1), rb.flat_keep_mask((1, 2), x.numel(), 0, 0.8, "cpu"))


def test_two_keeps_compose_as_independent_masks():
    x = torch.ones((64, 1024))
    out = tdrop.dropout_kernel(x, (5, 6), [0.8, 0.5])
    kept = out != 0
    n = x.numel()
    assert abs(float(kept.float().mean()) - 0.4) <= 4 * (0.24 / n) ** 0.5
    assert bool((out[kept] == 2.5).all())
    both = (rb.flat_keep_mask((5, 6), n, 0, 0.8, "cpu")
            & rb.flat_keep_mask((5, 6), n, 1, 0.5, "cpu"))
    assert torch.equal(kept.reshape(-1), both)


def test_backward_regenerates_the_forward_mask():
    x = torch.full((33, 70), 2.0, requires_grad=True)
    out = tdrop.dropout(x, (9, 10), [0.7])
    out.sum().backward()
    assert torch.equal(x.grad, out.detach() / 2.0)


def test_keeps_of_one_are_dropped_and_bad_keeps_raise():
    x = torch.randn((4, 8))
    assert tdrop.dropout(x, (1, 1), [1.0]) is x
    assert tdrop.dropout_site(None, x, [0.5]) is x
    assert torch.equal(tdrop.dropout(x, (1, 1), [1.0, 0.5]),
                       tdrop.dropout(x, (1, 1), [0.5]))
    for bad in ([0.0], [-0.5], [0.5, 0.5, 0.5]):
        with pytest.raises(ValueError):
            tdrop.dropout(x, (1, 1), bad)


def test_dropout_site_draws_one_seed_per_site_from_a_cpu_generator():
    x = torch.ones((8, 128))
    g1, g2 = torch.Generator().manual_seed(3), torch.Generator().manual_seed(3)
    a = tdrop.dropout_site(g1, x, [0.5])
    assert torch.equal(a, tdrop.dropout(x, rb.seed_words(g2), [0.5]))
    assert rb.seed_words(g1) == rb.seed_words(g2)        # one draw each


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_dropped_dense_matches_jax_dense_on_masked_input(dtype):
    """``_DroppedDense`` (dropout kernel, projection, weight-gradient
    kernel, mask rebuilt from the seed in the backward) against JAX
    ``_dense`` applied to h·mask·scale and the same mask on its dh."""
    jd, td = {"f32": (jnp.float32, torch.float32),
              "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    tol = dict(rtol=1e-5, atol=1e-5) if dtype == "f32" else dict(rtol=2e-3, atol=2e-3)
    T, B, H, V, keep, seed = 6, 4, 32, 9, 0.5, (21, 22)
    rng = np.random.default_rng(1)
    h = rng.normal(0, 1, (T, B, H)).astype(np.float32)
    w = rng.normal(0, 0.3, (H, V)).astype(np.float32)
    b = rng.normal(0, 0.1, (V,)).astype(np.float32)
    g = rng.normal(0, 1, (T, B, V)).astype(np.float32)
    mask = rb.dropout_mask(seed, (T, B, H), [keep], "cpu").numpy()
    scale = np.float32(1 / keep)

    def jfn(h, w, b):
        hm = jnp.where(mask, h * jnp.asarray(scale, h.dtype), 0).astype(h.dtype)
        return jac._dense(hm, w, b, jd)

    with pltpu.force_tpu_interpret_mode():
        hj = jnp.asarray(h).astype(jd)
        ref, vjp = jax.vjp(jfn, hj, jnp.asarray(w), jnp.asarray(b))
        ref_g = vjp(jnp.asarray(g))
    th = torch.tensor(h).to(td).requires_grad_(True)
    tw = torch.tensor(w, requires_grad=True)
    tb = torch.tensor(b, requires_grad=True)
    out = tac._DroppedDense.apply(th, tw, tb, seed, keep, td)
    out.backward(torch.as_tensor(g))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), **tol)
    for got, want in zip((th.grad, tw.grad, tb.grad), ref_g):
        np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), **tol)
