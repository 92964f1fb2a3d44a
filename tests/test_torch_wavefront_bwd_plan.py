"""The persistent reverse diagonal (row 4: ``ops/lstm_wavefront.py``
``wavefront_bwd_plan``, ``wavefront_bwd_layout``;
``csrc/lstm_wavefront_bwd_persistent.cu``), on the CPU.  The kernel runs
only on the card; what decides its grid and shared memory, how it cuts
W_hᵀ and W_xᵀ over the CTAs (a slice of 96 units a layer, its K split in
four, one gate each), the fixed order in which the split's partials meet,
and the order in which the layers' counters pace the passes, is tested
here.

The order of work against the JAX package: a walk in which CTA (l, u, q)
forms, per pass, the partial products of its gate's H columns of K with
its slice's rows of W_x,l+1 (dout) and W_h,l (the carry), the four
partials of a slice are summed in the order of q, and each CTA's cells
run on the sums; the layers step as the kernel's counter waits let them
(the top layer first, layer l's dout once layer l+1 has published the
step, its carry once its own layer has published the step before).
Against ``_wavefront_bwd`` with its Pallas kernel in TPU interpret mode
in drop modes 0 and 1 (dgates, dh0, dc0 and xdrop), at T=9, H=256, L = 2
and 3, xavier-uniform weights, B=5 (ragged lengths, a zero-length row)
and B=64 (the plan's widest batch; B=70 goes to the per-diagonal kernel);
in drop mode 2 equal to itself in mode 1 fed ``random_bits.wavefront_masks``,
bit for bit.  Both sides round dgates to bf16 and sum their products in
float32 in another order: where two sums straddle a bf16 rounding the
result moves by one step (2^-8 relative) and propagates: 4e-3 relative
and absolute, the layered route's bf16 tolerance (as in
``tests/test_torch_wavefront_persistent_plan.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from rnn_speech_tpu.ops import lstm_wavefront as jwave
from rnn_speech_tpu_torch.ops import lstm_wavefront as twave
from rnn_speech_tpu_torch.ops import random_bits as rb

SMEM_OPT_IN = 232448          # bytes of shared memory a block may use on the H100
BF16 = dict(rtol=4e-3, atol=4e-3)
f32, bf16 = torch.float32, torch.bfloat16
NU = twave.WAVEFRONT_BWD_UNITS     # units of a slice
SPLIT = twave.WAVEFRONT_BWD_SPLIT  # CTAs of a slice


# --------------------------------------------------------------- the plan


def test_default_step_gets_132_ctas_and_14_resident_w_h_chunks():
    """B=64 at 3 x 1024: 11 slices of 96 units (the last 64 of them past H)
    x 4 CTAs a layer, 132 in all: the H100's SMs.  Beside a ring of two 12
    KiB W boxes and four 8 KiB A boxes each keeps 14 of the 16 K chunks of
    its gate's W_h columns for its 96 units resident (168 KiB); a 15th does
    not fit the block's shared memory."""
    plan = twave.wavefront_bwd_plan(64, 1024, 3)
    assert plan["kernel"] == "persistent"
    assert (plan["slices"], plan["grid"], plan["resident"]) == (11, 132, 14)
    assert (NU, SPLIT) == (96, 4) and 10 * NU < 1024 <= 11 * NU
    assert plan["smem"] == twave.wavefront_bwd_smem(14) <= SMEM_OPT_IN
    assert twave.wavefront_bwd_smem(15) > SMEM_OPT_IN


@pytest.mark.parametrize("B", [1, 5, 16, 63, 64])
def test_plan_takes_every_unfused_batch_of_one_tile(B):
    plan = twave.wavefront_bwd_plan(B, 1024, 3)
    assert plan == {"kernel": "persistent", **twave.wavefront_bwd_layout(64, 1024, 3)}


@pytest.mark.parametrize("B,H,L,fuse,sms", [
    (64, 1024, 3, True, 132),     # the fused dW_x
    (96, 1024, 3, True, 132),     # the fused pass's timing batch
    (394, 1024, 3, False, 132),   # the wide step's batch, unfused
    (70, 1024, 3, False, 132),    # two tiles
    (65, 256, 3, False, 132),
    (64, 1024, 4, False, 132),    # 4 x 44 CTAs, past the card
    (64, 1024, 3, False, 131),    # a card of fewer SMs
    (64, 1280, 3, False, 132),    # 3 x 56 CTAs
    (64, 1024, 1, False, 132),    # one layer
    (0, 1024, 3, False, 132),     # no batch
    (64, 48, 2, False, 132),      # H % 64
])
def test_plan_sends_the_other_shapes_to_the_per_diagonal_kernel(B, H, L, fuse, sms):
    assert twave.wavefront_bwd_plan(B, H, L, fuse, sms) == {"kernel": "per_diagonal"}


@pytest.mark.parametrize("H", [64, 128, 192, 256, 512, 768, 1024])
def test_layout_keeps_as_much_of_w_h_resident_as_fits_beside_its_rings(H):
    lay = twave.wavefront_bwd_layout(5, H, 3)
    assert lay["slices"] == -(-H // NU) and lay["grid"] == 3 * SPLIT * lay["slices"] <= 132
    res = lay["resident"]
    assert lay["smem"] == twave.wavefront_bwd_smem(res) <= SMEM_OPT_IN
    assert res == H // 64 or twave.wavefront_bwd_smem(res + 1) > SMEM_OPT_IN


# ------------------------------------------- the cut of W over the CTAs


def _cta_block(w, u, q):
    """CTA (u, q)'s W operand as its TMA boxes read it from the layer's own
    (H, 4H) rows: rows 96u .. 96u + 95 (zero fill past H), columns q·H ..
    q·H + H (gate q's K block)."""
    H = w.shape[0]
    block = torch.zeros((NU, H), dtype=w.dtype)
    rows = w[NU * u: NU * (u + 1), q * H: (q + 1) * H]
    block[: rows.shape[0]] = rows
    return block


@pytest.mark.parametrize("H", [256, 1024])
def test_ctas_hold_every_weight_once(H):
    """Over a layer's CTAs (u, q) every element (j, k) of W_h (and of
    W_x,l+1) is held exactly once; only the last slice reads rows past H,
    which are zeros."""
    S = twave.wavefront_bwd_layout(5, H, 3)["slices"]
    w = torch.arange(1, H * 4 * H + 1, dtype=torch.float64).reshape(H, 4 * H)
    seen = torch.zeros((H, 4 * H), dtype=torch.int64)
    for u in range(S):
        for q in range(SPLIT):
            block = _cta_block(w, u, q)
            n = min(NU, H - NU * u)
            assert torch.equal(block[:n], w[NU * u: NU * u + n, q * H: (q + 1) * H])
            assert not block[n:].any() and (n < NU) == (u == S - 1 and H % NU != 0)
            seen[NU * u: NU * u + n, q * H: (q + 1) * H] += 1
    assert bool((seen == 1).all())


def test_slice_partials_sum_to_the_whole_product():
    """A slice's four partials (dgates' gate-q columns times the CTA's W
    block), summed in the order of q, give dgates·W[units]ᵀ."""
    H, B = 256, 7
    g = torch.Generator().manual_seed(0)
    w = torch.randn((H, 4 * H), generator=g)
    dg = torch.randn((B, 4 * H), generator=g)
    S = -(-H // NU)
    for u in range(S):
        acc = torch.zeros((B, NU))
        for q in range(SPLIT):
            acc = acc + dg[:, q * H: (q + 1) * H] @ _cta_block(w, u, q).t()
        n = min(NU, H - NU * u)
        torch.testing.assert_close(acc[:, :n], dg @ w[NU * u: NU * u + n].t(), rtol=1e-5,
                                   atol=1e-4)
        assert not acc[:, n:].any()


# ------------------------------------------------- the order of work


def _kernel_keeps(seed, keep, l, t, B, H):
    """Boundary l's keep bits at step t as the kernel's threads draw them:
    one Philox4x32-10 call of counter (j/4, b, t, l) for the four units j ..
    j + 3 a thread holds (j % 4 == 0), words 0 .. 3."""
    j4 = torch.arange(H // 4)
    b = torch.arange(B)[:, None]
    words = torch.stack(rb.philox4x32(j4[None] + 0 * b, b + 0 * j4, torch.full_like(b + j4, t),
                                      torch.full_like(b + j4, l), seed), dim=-1)
    return (words < rb.threshold(keep)).reshape(B, H).to(f32)


def _walk(dout_top, w_h, w_x_rest, mask, gates, cseq, c0, dhn, dcn, outs=None, keeps=None,
          scale=1.0, seed=None, keep=1.0):
    """The reverse diagonal in the persistent kernel's order of work.  Pass
    s (0 .. T) of layer l runs step t = T-1-s: CTA (l, u, q) forms its
    partials dgates_{l+1}(t)[:, gate q]·W_x,l+1[slice u, gate q]ᵀ (l < L-1)
    and dgates_l(t+1)[:, gate q]·W_h,l[slice u, gate q]ᵀ (s > 0), read from
    the dgates written over ``gates``; the slice's four partials are summed
    in the order of q; the cells run on the sums (dout times boundary l's
    keep·scale below the top) and write dgates over gates[l, t] (xdrop with
    ``keeps`` or ``seed``); pass T gives dh0.  The layers step as their
    waits let them, the top layer first.  Returns (dgates, dh0, dc0) and
    xdrop in drop modes 1 and 2."""
    L, T, B, G = gates.shape
    H = G // 4
    S = twave.wavefront_bwd_layout(B, H, L)["slices"]
    gates = gates.clone()
    wh = [[[_cta_block(w_h[l].to(f32), u, q) for q in range(SPLIT)] for u in range(S)]
          for l in range(L)]
    wx = [[[_cta_block(w_x_rest[l].to(f32), u, q) for q in range(SPLIT)] for u in range(S)]
          for l in range(L - 1)]
    dropped = keeps is not None or seed is not None
    xdrop = torch.zeros((L - 1, T, B, H), dtype=bf16) if dropped else None
    dh, dc = dhn.to(f32).clone(), dcn.to(f32).clone()
    written = torch.zeros((L, T), dtype=torch.bool)  # dgates over gates[l, t]
    passes = [0] * L

    def slice_sums(a, w):
        """(B, H) sums of each slice's four partials in the order of q."""
        out = torch.zeros((B, S * NU))
        for u in range(S):
            acc = torch.zeros((B, NU))
            for q in range(SPLIT):
                acc = acc + a[:, q * H: (q + 1) * H].to(f32) @ w[u][q].t()
            out[:, NU * u: NU * (u + 1)] = acc
        return out[:, :H]

    def ready(l):                                    # layer l+1 has published step t
        s = passes[l]
        return s <= T and (l + 1 == L or s == T or passes[l + 1] >= s + 1)

    while min(passes) <= T:
        l = next(l for l in reversed(range(L)) if passes[l] <= T and ready(l))
        s, t = passes[l], T - 1 - passes[l]
        ph = torch.zeros((B, H))
        if s > 0:
            assert bool(written[l, t + 1])
            ph = slice_sums(gates[l, t + 1], wh[l])
        if s == T:
            dh[l] = dh[l] + ph
            passes[l] += 1
            continue
        if l + 1 < L:
            assert bool(written[l + 1, t])
            ks = torch.ones((B, H))
            if dropped:
                kt = keeps[l, t] if seed is None else _kernel_keeps(seed, keep, l, t, B, H)
                ks = kt * scale
                xdrop[l, t] = (outs[l, t].to(f32) * ks).to(bf16)
            dout = slice_sums(gates[l + 1, t], wx[l]) * ks
        else:
            dout = dout_top[t].to(f32)
        i_a, g_a, f_a, o_a = gates[l, t].to(f32).split(H, dim=-1)
        m = mask[t, 0][:, None]
        tanh_c = torch.tanh(cseq[l, t].to(f32))
        c_prev = cseq[l, t - 1].to(f32) if t > 0 else c0[l].to(f32)
        dh_carry = dh[l] + ph
        dh_new = m * (dout + dh_carry)
        do_pre = dh_new * tanh_c * o_a * (1 - o_a)
        dc_new = dh_new * o_a * (1 - tanh_c * tanh_c) + m * dc[l]
        dgt = torch.cat([dc_new * g_a * i_a * (1 - i_a), dc_new * i_a * (1 - g_a * g_a),
                         dc_new * c_prev * f_a * (1 - f_a), do_pre], dim=-1)
        gates[l, t] = dgt.to(bf16)
        written[l, t] = True
        dh[l] = (1 - m) * dh_carry
        dc[l] = (1 - m) * dc[l] + dc_new * f_a
        passes[l] += 1
    res = (gates, dh, dc)
    return res if xdrop is None else res + (xdrop,)


T, H = 9, 256
KP = 0.4


def _problem(L, B, mode, seed):
    """Inputs of the reverse diagonal: the residuals of the port's plain
    training forward on xavier-uniform weights, and cotangents."""
    rng = np.random.default_rng(seed)
    lim = (6.0 / (H + 4 * H)) ** 0.5
    w = lambda *s: torch.tensor(rng.uniform(-lim, lim, s).astype(np.float32)).to(bf16)
    f = lambda *s, scale: torch.tensor(rng.normal(0, scale, s).astype(np.float32))
    lens = np.asarray([T if b % 4 == 0 else (7 * b) % (T + 1) for b in range(B)], np.int32)
    lens[min(2, B - 1)] = 0
    mask = torch.tensor((np.arange(T)[:, None] < lens[None]).astype(np.float32)[:, None, :])
    masks = torch.tensor((rng.random((L - 1, T, B, H)) < KP).astype(np.float32))
    w_h, w_x_rest = w(L, H, 4 * H), w(L - 1, H, 4 * H)
    h0, c0 = f(L, B, H, scale=0.3), f(L, B, H, scale=0.3)
    drop = (1, masks, 1.0 / KP, 1.0) if mode else ()
    outs, gates, cseq, _, _ = twave.wavefront_train_plain(
        f(T, B, H, scale=1.0).to(bf16), w(H, 4 * H), w_h, w_x_rest, f(L, 4 * H, scale=0.1), mask,
        h0, c0, bf16, *drop)
    args = [f(T, B, H, scale=0.5).to(bf16), w_h, w_x_rest, mask, gates, cseq, c0,
            f(L, B, H, scale=0.1), f(L, B, H, scale=0.1), outs]
    return args, masks


def _jax(args, mode, masks):
    dout_top, w_h, w_x_rest, mask, gates, cseq, c0, dhn, dcn, outs = args
    j = lambda a: jnp.asarray(a.float().numpy(), jnp.bfloat16 if a.dtype == bf16 else None)
    L = gates.shape[0]
    drop = (1, j(masks.to(bf16)), 1.0 / KP, 1.0) if mode else (0, None, 1.0, 1.0)
    with pltpu.force_tpu_interpret_mode():
        dgates, xdrops, dwx, dh0, dc0 = jwave._wavefront_bwd(
            j(dout_top), j(w_h), j(w_x_rest), *drop, j(mask),
            [j(gates[l]) for l in range(L)], [j(cseq[l]) for l in range(L)],
            [j(outs[l]) for l in range(L)], j(c0), j(dhn), j(dcn))
    assert dwx is None
    f = lambda a: np.asarray(jnp.asarray(a, jnp.float32))
    res = [np.stack([f(g) for g in dgates]), f(dh0), f(dc0)]
    return res + ([np.stack([f(x) for x in xdrops])] if mode else [])


@pytest.mark.parametrize("mode", [0, 1])
@pytest.mark.parametrize("B", [5, 64])
@pytest.mark.parametrize("L", [2, 3])
def test_kernel_order_matches_jax_wavefront_bwd(L, B, mode, monkeypatch):
    monkeypatch.delenv("RST_WAVEFRONT_FUSE_DWX", raising=False)
    args, masks = _problem(L, B, mode, 60 + L + B + mode)
    assert twave.wavefront_bwd_plan(B, H, L)["kernel"] == "persistent"
    ref = _jax(args, mode, masks)
    drop = dict(keeps=masks, scale=1.0 / KP) if mode else {}
    got = _walk(*args, **drop)
    plain = twave.wavefront_bwd_plain(*args[:4], args[4].clone(), *args[5:],
                                      *((1, masks, 1.0 / KP, 1.0) if mode else ()))
    assert len(got) == len(plain) == len(ref) == (4 if mode else 3)
    for r, g_, q in zip(ref, got, plain):
        np.testing.assert_allclose(g_.float().numpy(), r, **BF16)
        np.testing.assert_allclose(q.float().numpy(), r, **BF16)
    # The zero-length row: zero dgates, its carries pass through.
    assert not got[0][:, :, 2].any()
    assert torch.equal(got[1][:, 2], args[7][:, 2]) and torch.equal(got[2][:, 2], args[8][:, 2])


def test_mode2_equals_mode1_fed_the_generators_masks():
    """The kernel's threads draw boundary l's bits at step t from Philox
    counters (j/4, b, t, l), one call for four units: its walk in drop mode
    2 is mode 1's fed ``wavefront_masks`` of the same seed words (the bits
    the forward drew), bit for bit, dgates, dh0, dc0 and xdrop; within the
    bf16 tolerance of the plain version in mode 2; and not mode 0's."""
    L, B, seed = 3, 5, (4321, 56789)
    args, _ = _problem(L, B, 0, 9)
    masks = rb.wavefront_masks(seed, L - 1, T, B, H, KP, "cpu").to(f32)
    mode2 = _walk(*args, seed=seed, keep=KP, scale=1.0 / KP)
    fed = _walk(*args, keeps=masks, scale=1.0 / KP)
    for a, b in zip(mode2, fed):
        assert torch.equal(a, b)
    plain2 = twave.wavefront_bwd_plain(*args[:4], args[4].clone(), *args[5:], 2, seed, 1.0 / KP,
                                       KP)
    for a, b in zip(mode2, plain2):
        np.testing.assert_allclose(a.float().numpy(), b.float().numpy(), **BF16)
    none = _walk(*args)
    assert not torch.equal(mode2[0][:-1], none[0][:-1])
    assert torch.equal(mode2[0][-1], none[0][-1])    # the top layer's dout is not dropped
