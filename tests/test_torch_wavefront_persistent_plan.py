"""The persistent wavefront training forward (row 3: ``ops/lstm_wavefront.py``
``wavefront_plan``, ``wavefront_layout``, ``wavefront_weights``;
``csrc/lstm_wavefront_persistent.cu``), on the CPU.  The kernel runs only on
the card; what decides its grid and shared memory, how it cuts the three
layers' weights over the CTAs, and the order in which it paces the layers
through their rings of h, is tested here.

The order of work against the JAX package: a walk that computes each CTA's
96 gate columns from the arranged weights, paces the layers through per-layer rings of ``ring`` steps
as the kernel's counters do (layer 0 first, each layer as far ahead as its
waits let it), and runs the cells, in drop modes 0 and 1 against
``_wavefront_train`` with its Pallas kernel in TPU interpret mode, and in
drop mode 2 equal to itself in mode 1 fed ``random_bits.wavefront_masks``.
T=9, B=5 (ragged lengths, a zero-length row), H = D = 256, L = 2 and 3,
xavier-uniform weights.  Both sides round the same operands to bf16 and
sum in float32 in another order: where two sums straddle a bf16 rounding
(of h, or of a residual) the result moves by one step (2^-8 relative) and
propagates: 4e-3 relative and absolute, the layered route's bf16
tolerance.
"""

import jax
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
U = twave.WAVEFRONT_UNITS
N = 4 * U                     # a CTA's gate columns


# --------------------------------------------------------------- the plan


def test_default_step_shape_gets_43_ctas_a_layer_and_14_resident_w_h_chunks():
    """B=64, H = D = 1024, L = 3: 43 CTAs a layer (42 of 24 units, one of
    16), 129 on the H100's 132 SMs; beside a ring of two 12 KiB W boxes and
    four 8 KiB A boxes each keeps 14 of the 16 K chunks of its 96 W_h
    columns resident (168 KiB; a 15th does not fit the block's shared
    memory)."""
    plan = twave.wavefront_plan(64, 1024, 3, 1024)
    assert plan["kernel"] == "persistent"
    assert (plan["slices"], plan["grid"], plan["resident"], plan["ring"]) == (43, 129, 14, 8)
    assert (twave.WAVEFRONT_W_STAGES, twave.WAVEFRONT_A_STAGES) == (2, 4)
    assert 42 * U + 16 == 1024
    assert 14 * N * 64 * 2 == 168 << 10
    assert plan["smem"] == twave.wavefront_smem(14) <= SMEM_OPT_IN
    assert twave.wavefront_smem(15) > SMEM_OPT_IN
    assert all(twave.wavefront_plan(64, 1024, 3, 1024) == plan for _ in range(3))


@pytest.mark.parametrize("B", [1, 5, 16, 63, 64])
def test_plan_takes_every_batch_of_one_tile(B):
    """Every batch of one 64-row tile at the flagship width, the fused
    route's B=16 among them, gets the same grid."""
    plan = twave.wavefront_plan(B, 1024, 3, 1024)
    assert plan == {"kernel": "persistent", **twave.wavefront_layout(64, 1024, 3, 1024)}


@pytest.mark.parametrize("B,H,L,D,sms", [
    (394, 1024, 3, 1024, 132),    # the wide step
    (65, 1024, 3, 1024, 132),     # two tiles
    (64, 1024, 3, 120, 132),      # D != H
    (64, 1024, 4, 1024, 132),     # 4 x 43 CTAs, past the card
    (64, 1024, 3, 1024, 114),     # a card of fewer SMs
    (64, 1280, 3, 1280, 132),     # 3 x 54 CTAs
    (64, 1024, 1, 1024, 132),     # one layer
    (0, 1024, 3, 1024, 132),      # no batch
    (70, 128, 3, 128, 132),       # two tiles at a narrow width
    (64, 48, 2, 48, 132),         # H % 64
    (4, 16, 2, 6, 132),           # the CPU tests' stack
])
def test_plan_sends_the_other_shapes_to_the_per_diagonal_kernel(B, H, L, D, sms):
    assert twave.wavefront_plan(B, H, L, D, sms) == {"kernel": "per_diagonal"}


@pytest.mark.parametrize("B,H,L", [(64, 512, 3), (5, 256, 3), (3, 64, 2), (17, 128, 4)])
def test_plan_routes_the_narrower_widths_by_the_layout_alone(B, H, L):
    """No width threshold: every shape the layout takes (one tile, D = H,
    a grid within the card) goes to the persistent kernel."""
    plan = twave.wavefront_plan(B, H, L, H)
    assert plan == {"kernel": "persistent", **twave.wavefront_layout(B, H, L, H)}


@pytest.mark.parametrize("H", [64, 128, 192, 256, 320, 384, 448, 512, 640, 768, 896, 1024])
def test_layout_keeps_as_much_of_w_h_resident_as_fits_beside_its_rings(H):
    """The rings get their stages first; W_h keeps as many of its H/64 K
    chunks resident as fit beside them (all of them at the narrow widths),
    within the block's shared memory."""
    lay = twave.wavefront_layout(5, H, 3, H)
    assert lay["slices"] == -(-H // U) and lay["grid"] == 3 * lay["slices"] <= 132
    res = lay["resident"]
    assert lay["smem"] == twave.wavefront_smem(res) <= SMEM_OPT_IN
    assert res == H // 64 or twave.wavefront_smem(res + 1) > SMEM_OPT_IN
    assert twave.wavefront_layout(5, H + 32, 3, H + 32) is None      # H % 64


# ------------------------------------------- the cut of W over the CTAs


@pytest.mark.parametrize("H", [256, 1024])
def test_ctas_own_every_gate_column_once(H):
    """Over a layer's CTAs every gate column g·H + j appears exactly once;
    CTA u's 96 columns are the four gates of the same units 24u .. 24u +
    23, and only the last CTA has padding (-1) past H."""
    S = -(-H // U)
    cols = twave.wavefront_column_order(H, S).reshape(S, 4, U)
    assert sorted(cols[cols >= 0].tolist()) == list(range(4 * H))
    for u in range(S):
        n = min(U, H - U * u)                         # the CTA's units
        for g in range(4):
            assert cols[u, g, :n].tolist() == list(range(g * H + U * u, g * H + U * u + n))
            assert bool((cols[u, g, n:] == -1).all())
        assert (n < U) == (u == S - 1 and H % U != 0)


@pytest.mark.parametrize("H", [256, 1000])
def test_arranged_weights_give_each_ctas_columns(H):
    """A (rows, K) times a CTA's (96, K) slice of ``wavefront_weights`` (K
    contiguous, as TMA loads it) is A·W on the CTA's gate columns, and zero
    on its padding."""
    L = 3
    S = -(-H // U)
    g = torch.Generator().manual_seed(0)
    w = torch.randn((L, H, 4 * H), generator=g)
    a = torch.randn((5, H), generator=g)
    wp = twave.wavefront_weights(w, S).reshape(L, S, N, H)
    cols = twave.wavefront_column_order(H, S).reshape(S, N)
    for l in range(L):
        for u in range(S):
            prod = a @ wp[l, u].t()
            ok = cols[u] >= 0
            torch.testing.assert_close(prod[:, ok], a @ w[l][:, cols[u][ok]], rtol=1e-5,
                                       atol=1e-4)
            assert not prod[:, ~ok].any()


# ------------------------------------------------- the order of work


def _kernel_keeps(seed, keep, l, t, B, H):
    """Boundary l's keep bits at step t as the kernel's threads draw them:
    one Philox4x32-10 call of counter (j/4, b, t, l) for the unit pair
    (j, j + 1) (j even) a thread holds, words j % 4 and (j + 1) % 4."""
    j = torch.arange(0, H, 2)
    b = torch.arange(B)[:, None]
    words = torch.stack(rb.philox4x32(j[None] >> 2, b + 0 * j, torch.full_like(b + j, t),
                                      torch.full_like(b + j, l), seed), dim=-1)
    pair = torch.stack([words.gather(-1, (j % 4).expand(B, -1)[..., None])[..., 0],
                        words.gather(-1, ((j + 1) % 4).expand(B, -1)[..., None])[..., 0]], -1)
    return (pair < rb.threshold(keep)).reshape(B, H).to(f32)


def _walk(x, w_x0, w_h, w_x_rest, b_all, mask, h0, c0, keeps=None, scale=1.0, ring=None,
          seed=None, keep=1.0):
    """The training forward in the persistent kernel's order of work: CTA u
    of layer l computes its 96 gate columns as two products, x_l(t) and
    h_l(t-1) times its slices of the arranged W_x,l and W_h,l, adds the
    bias and runs the cells of its units.  Layer l reads x_l(t) from slot t % R of the lower layer's ring
    (its dropped copy with ``keeps``) and h_l(t-1) from slot (t-1) % R of
    its own (with ``seed``, the bits its threads draw, ``_kernel_keeps``),
    and writes slot t % R of both only once the layer above has
    finished step t - R: the counters' waits.  The layers step lowest
    first, each as far as its waits let it, so layer 0 runs R - 1 steps
    ahead and every slot is reused.  Returns (outs, gates, cseq, hn, cn)."""
    T, B, H = x.shape
    L = w_h.shape[0]
    R = ring or twave.WAVEFRONT_RING
    S = twave.wavefront_layout(B, H, L, H)["slices"]
    wx = twave.wavefront_weights(torch.cat([w_x0[None], w_x_rest]), S).reshape(L, S, N, H)
    wh = twave.wavefront_weights(w_h, S).reshape(L, S, N, H)
    wx, wh = wx.to(f32), wh.to(f32)
    rows = twave.WAVEFRONT_ROWS
    ring_h = torch.zeros((L, R, rows, H), dtype=bf16)
    ring_h[:, R - 1, :B] = h0.to(bf16)
    ring_x = torch.zeros((L - 1, R, rows, H), dtype=bf16)
    h, c = h0.clone().to(f32), c0.clone().to(f32)
    outs = torch.zeros((L, T, B, H), dtype=bf16)
    gates = torch.zeros((L, T, B, 4 * H), dtype=bf16)
    cseq = torch.zeros((L, T, B, H), dtype=bf16)
    done = [0] * L                                   # steps each layer has published
    read = [[-1] * R for _ in range(L)]              # the step of each lower-ring slot last read
    while min(done) < T:
        l = next(l for l in range(L) if done[l] < T and (l == 0 or done[l - 1] > done[l])
                 and (l + 1 == L or done[l] < R or done[l + 1] >= done[l] - R + 1))
        t = done[l]
        if l == 0:
            x_in = torch.zeros((rows, H), dtype=bf16)
            x_in[:B] = x[t].to(bf16)
        else:
            x_in = (ring_x if keeps is not None or seed is not None else ring_h)[l - 1, t % R]
            read[l - 1][t % R] = t
        prod = torch.empty((rows, S, N))
        for u in range(S):
            prod[:, u] = (x_in.to(f32) @ wx[l, u].t()
                          + ring_h[l, (t - 1) % R].to(f32) @ wh[l, u].t())
        pre = prod.reshape(rows, S, 4, U).permute(0, 2, 1, 3).reshape(rows, 4, S * U)[:B, :, :H]
        pre = pre + b_all[l].to(f32).reshape(4, H)
        i_a, g_a = torch.sigmoid(pre[:, 0]), torch.tanh(pre[:, 1])
        f_a, o_a = torch.sigmoid(pre[:, 2] + 1.0), torch.sigmoid(pre[:, 3])
        c_new = f_a * c[l] + i_a * g_a
        h_new = o_a * torch.tanh(c_new)
        m = mask[t, 0][:, None]
        c[l] = m * c_new + (1 - m) * c[l]
        h[l] = m * h_new + (1 - m) * h[l]
        if l + 1 < L and t >= R:                     # the slot's last step was read
            assert read[l][t % R] == t - R
        ring_h[l, t % R, :B] = h[l].to(bf16)
        if l + 1 < L and (keeps is not None or seed is not None):
            kt = keeps[l, t] if seed is None else _kernel_keeps(seed, keep, l, t, B, H)
            ring_x[l, t % R, :B] = (h[l] * (kt * scale)).to(bf16)
        outs[l, t], cseq[l, t] = (m * h_new).to(bf16), c[l].to(bf16)
        gates[l, t] = torch.cat([i_a, g_a, f_a, o_a], dim=-1).to(bf16)
        done[l] += 1
    return outs, gates, cseq, h, c


T, B, H = 9, 5, 256
LENS = np.asarray([9, 4, 0, 7, 1], np.int32)
KP = 0.4


def _problem(L, seed):
    rng = np.random.default_rng(seed)
    lim = (6.0 / (H + 4 * H)) ** 0.5
    w = lambda *s: rng.uniform(-lim, lim, s).astype(np.float32)
    f = lambda *s, scale: rng.normal(0, scale, s).astype(np.float32)
    mask = (np.arange(T)[:, None] < LENS[None]).astype(np.float32)[:, None, :]
    masks = (rng.random((L - 1, T, B, H)) < KP).astype(np.float32)
    return dict(x=f(T, B, H, scale=1.0), w_x0=w(H, 4 * H), w_h=w(L, H, 4 * H),
                w_x_rest=w(L - 1, H, 4 * H), b_all=f(L, 4 * H, scale=0.1), mask=mask,
                h0=f(L, B, H, scale=0.3), c0=f(L, B, H, scale=0.3)), masks


ARGS = ("x", "w_x0", "w_h", "w_x_rest", "b_all", "mask", "h0", "c0")


def _torch_args(p):
    bf = {"x", "w_x0", "w_h", "w_x_rest"}
    return [torch.tensor(np.asarray(jnp.asarray(p[k], jnp.bfloat16).astype(jnp.float32)))
            .to(bf16) if k in bf else torch.tensor(p[k]) for k in ARGS]


@pytest.mark.parametrize("mode", [0, 1])
@pytest.mark.parametrize("L", [2, 3])
def test_kernel_order_matches_jax_wavefront_train(L, mode):
    p, masks = _problem(L, 20 + L + 10 * mode)
    jargs = [jnp.asarray(p[k], jnp.bfloat16) for k in ("x", "w_x0", "w_h", "w_x_rest")]
    drop = (1, jnp.asarray(masks, jnp.bfloat16), 1.0 / KP, 1.0) if mode else (0, None, 1.0, 1.0)
    with pltpu.force_tpu_interpret_mode():
        ref = jwave._wavefront_train(*jargs, jnp.asarray(p["b_all"])[:, None, :], *drop,
                                     p["mask"], p["h0"], p["c0"], jnp.bfloat16)
    ref = [np.stack([np.asarray(a.astype(jnp.float32)) for a in r]) for r in ref[:3]] + \
        [np.asarray(r) for r in ref[3:]]
    args = _torch_args(p)
    keeps = torch.tensor(masks) if mode else None
    got = _walk(*args, keeps=keeps, scale=1.0 / KP)
    plain = twave.wavefront_train_plain(*args, bf16, *((1, keeps, 1.0 / KP, 1.0) if mode
                                                        else ()))
    for r, g_, q in zip(ref, got, plain):
        np.testing.assert_allclose(g_.float().numpy(), r, **BF16)
        np.testing.assert_allclose(q.float().numpy(), r, **BF16)
    # The zero-length row keeps its state and stores zero outputs.
    assert not got[0][:, :, 2].float().any()
    assert torch.equal(got[3][:, 2], args[6][:, 2]) and torch.equal(got[4][:, 2], args[7][:, 2])


def test_mode2_equals_mode1_fed_the_generators_masks():
    """The kernel's threads draw boundary l's bits at step t from Philox
    counters (j/4, b, t, l), one call for a unit pair: its walk in drop mode
    2 is mode 1's fed ``wavefront_masks`` of the same seed words (the bits
    the backward regenerates), bit for bit; within the bf16 tolerance of
    the plain version in mode 2; and not mode 0's."""
    L, seed = 3, (1234, 98765)
    p, _ = _problem(L, 7)
    args = _torch_args(p)
    masks = rb.wavefront_masks(seed, L - 1, T, B, H, KP, "cpu").to(f32)
    mode2 = _walk(*args, seed=seed, keep=KP, scale=1.0 / KP)
    fed = _walk(*args, keeps=masks, scale=1.0 / KP)
    for a, b in zip(mode2, fed):
        assert torch.equal(a, b)
    plain2 = twave.wavefront_train_plain(*args, bf16, 2, seed, 1.0 / KP, KP)
    for a, b in zip(mode2, plain2):
        np.testing.assert_allclose(a.float().numpy(), b.float().numpy(), **BF16)
    none = _walk(*args)
    assert not torch.equal(mode2[0][1:], none[0][1:])
    assert torch.equal(mode2[0][0], none[0][0])      # layer 0 reads no dropped input


@pytest.mark.parametrize("ring", [2, 3])
def test_shallow_rings_give_the_same_result(ring):
    """The ring's depth bounds how far a layer runs ahead, not what it
    computes: rings of 2 and 3 steps (reused every step or two) give the
    walk's result at the default depth bit for bit."""
    p, masks = _problem(3, 5)
    args = _torch_args(p)
    keeps = torch.tensor(masks)
    deep = _walk(*args, keeps=keeps, scale=1.0 / KP)
    for a, b in zip(_walk(*args, keeps=keeps, scale=1.0 / KP, ring=ring), deep):
        assert torch.equal(a, b)
