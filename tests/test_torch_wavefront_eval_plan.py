"""The persistent wavefront inference forward (row 1: ``ops/lstm_wavefront.py``
``wavefront_eval_plan``, ``wavefront_eval_layout``, ``wavefront_weights``;
``csrc/lstm_wavefront_eval.cu``), on the CPU.  The kernel runs only on the
card; what decides its grid, its row groups and its shared memory, how it
cuts the layers' weights over the CTAs, and the order in which it paces the
layers through their rings of h, is tested here.

The order of work against the JAX package: a walk in which each CTA's
consumer warpgroups compute its 96 gate columns for their own 64 rows from
the arranged weights (layer 0 the h product alone plus the step's float32
xp0, the layers above the x product and then the h product plus their
bias), paces the layers through per-layer rings of ``ring`` steps as the
kernel's counters do (layer 0 first, each layer as far ahead as its waits
let it), and runs the cells; against ``lstm_stack_wavefront`` with its
Pallas kernel in TPU interpret mode at T=9, H=256, L = 2 and 3,
xavier-uniform weights, B=5 (one row group; ragged lengths, a zero-length
row) and B=70 (two row groups).  Both sides round h to bf16 and sum in
float32 in another order: where two sums straddle a bf16 rounding of h
the result moves by one step (2^-8 relative) and propagates: 4e-3
relative and absolute, the layered route's bf16 tolerance (as in
``tests/test_torch_wavefront_persistent_plan.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from rnn_speech_tpu.ops import lstm_wavefront as jwave
from rnn_speech_tpu_torch.ops import lstm_wavefront as twave

SMEM_OPT_IN = 232448          # bytes of shared memory a block may use on the H100
BF16 = dict(rtol=4e-3, atol=4e-3)
f32, bf16 = torch.float32, torch.bfloat16
U = twave.WAVEFRONT_UNITS
N = 4 * U                     # a CTA's gate columns
ROWS = twave.WAVEFRONT_ROWS   # rows of a row group


# --------------------------------------------------------------- the plan


@pytest.mark.parametrize("B,groups,resident", [(128, 2, 11), (1, 1, 14)])
def test_serving_batches_get_43_ctas_a_layer(B, groups, resident):
    """The eval batch (B=128) and ``--file`` (B=1) at 3 x 1024: 43 CTAs a
    layer, 129 on the H100's 132 SMs.  Two row groups double the A ring
    (four stages of 16 KiB), so 11 of W_h's 16 K chunks stay resident
    beside it (132 KiB); one row group keeps 14 (168 KiB).  One more chunk
    does not fit the block's shared memory."""
    plan = twave.wavefront_eval_plan(B, 1024, 3)
    assert plan["kernel"] == "persistent"
    assert (plan["slices"], plan["grid"], plan["groups"], plan["resident"], plan["ring"]) == (
        43, 129, groups, resident, twave.WAVEFRONT_RING)
    assert plan["smem"] == twave.wavefront_eval_smem(resident, groups) <= SMEM_OPT_IN
    assert twave.wavefront_eval_smem(resident + 1, groups) > SMEM_OPT_IN
    assert twave.wavefront_eval_smem(resident, 1) == twave.wavefront_smem(resident)


@pytest.mark.parametrize("B", [1, 5, 63, 64, 65, 70, 127, 128])
def test_plan_takes_every_batch_of_two_row_groups(B):
    """Up to 64 rows one group, up to 128 two, at the flagship width."""
    plan = twave.wavefront_eval_plan(B, 1024, 3)
    assert plan == {"kernel": "persistent", **twave.wavefront_eval_layout(B, 1024, 3)}
    assert plan["groups"] == (1 if B <= ROWS else 2)


@pytest.mark.parametrize("B,H,L,sms", [
    (129, 1024, 3, 132),      # three row groups
    (394, 1024, 3, 132),      # the wide step's batch
    (128, 1024, 4, 132),      # 4 x 43 CTAs, past the card
    (128, 1024, 3, 114),      # a card of fewer SMs
    (128, 1280, 3, 132),      # 3 x 54 CTAs
    (128, 1024, 1, 132),      # one layer
    (0, 1024, 3, 132),        # no batch
    (64, 48, 2, 132),         # H % 64
])
def test_plan_sends_the_other_shapes_to_the_per_diagonal_kernel(B, H, L, sms):
    assert twave.wavefront_eval_plan(B, H, L, sms) == {"kernel": "per_diagonal"}


@pytest.mark.parametrize("groups", [1, 2])
@pytest.mark.parametrize("H", [64, 128, 256, 512, 640, 768, 896, 1024])
def test_layout_keeps_as_much_of_w_h_resident_as_fits_beside_its_rings(H, groups):
    """The rings get their stages first; W_h keeps as many of its H/64 K
    chunks resident as fit beside them (all of them at the narrow widths),
    within the block's shared memory."""
    lay = twave.wavefront_eval_layout(ROWS * groups, H, 3)
    assert lay["groups"] == groups
    assert lay["slices"] == -(-H // U) and lay["grid"] == 3 * lay["slices"] <= 132
    res = lay["resident"]
    assert lay["smem"] == twave.wavefront_eval_smem(res, groups) <= SMEM_OPT_IN
    assert res == H // 64 or twave.wavefront_eval_smem(res + 1, groups) > SMEM_OPT_IN


@pytest.mark.parametrize("H", [256, 1024])
def test_ctas_own_every_gate_column_once(H):
    """Over a layer's CTAs of the eval plan every gate column g·H + j appears
    exactly once, and padding (-1) only past H in the last CTA."""
    S = twave.wavefront_eval_layout(128, H, 3)["slices"]
    cols = twave.wavefront_column_order(H, S)
    assert cols.numel() == S * N
    assert sorted(cols[cols >= 0].tolist()) == list(range(4 * H))
    pad = (cols < 0).reshape(S, N)
    assert not pad[:-1].any() and int(pad[-1].sum()) == 4 * (S * U - H)


# ------------------------------------------------- the order of work


def _walk(xp0, w_h, w_x_rest, b_rest, mask, h0, c0, ring=None):
    """The inference forward in the persistent kernel's order of work: CTA
    u of layer l computes its 96 gate columns for each row group g (rows
    64g .. 64g + 63, one consumer warpgroup each, both on one A box of
    64·groups rows) from its slices of the arranged W_x,l and W_h,l: the x
    product first (layers above 0), then the h product, then the bias (the
    step's float32 xp0 for layer 0).  Layer l reads x_l(t) from slot t % R of
    the lower layer's ring and h_l(t-1) from slot (t-1) % R of its own, and
    writes slot t % R only once the layer above has finished step t - R:
    the counters' waits.  The layers step lowest first, each as far as its
    waits let it.  Returns (out, hn, cn)."""
    T, B, G = xp0.shape
    H, L = G // 4, w_h.shape[0]
    R = ring or twave.WAVEFRONT_RING
    lay = twave.wavefront_eval_layout(B, H, L)
    S, groups = lay["slices"], lay["groups"]
    rows = groups * ROWS
    wh = twave.wavefront_weights(w_h, S).reshape(L, S, N, H).to(f32)
    wx = twave.wavefront_weights(w_x_rest, S).reshape(L - 1, S, N, H).to(f32)
    ring_h = torch.zeros((L, R, rows, H), dtype=bf16)
    ring_h[:, R - 1, :B] = h0.to(bf16)
    h, c = h0.clone().to(f32), c0.clone().to(f32)
    out = torch.zeros((T, B, H))
    done = [0] * L                                   # steps each layer has published
    read = [[-1] * R for _ in range(L)]              # the step of each ring slot last read above
    while min(done) < T:
        l = next(l for l in range(L) if done[l] < T and (l == 0 or done[l - 1] > done[l])
                 and (l + 1 == L or done[l] < R or done[l + 1] >= done[l] - R + 1))
        t = done[l]
        prod = torch.empty((rows, S, N))
        for g in range(groups):
            r = slice(ROWS * g, ROWS * (g + 1))
            h_in = ring_h[l, (t - 1) % R, r].to(f32)
            for u in range(S):
                acc = torch.zeros((ROWS, N))
                if l > 0:
                    acc = acc + ring_h[l - 1, t % R, r].to(f32) @ wx[l - 1, u].t()
                prod[r, u] = acc + h_in @ wh[l, u].t()
        if l > 0:
            read[l - 1][t % R] = t
        pre = prod.reshape(rows, S, 4, U).permute(0, 2, 1, 3).reshape(rows, 4, S * U)[:B, :, :H]
        pre = pre + (xp0[t].reshape(B, 4, H) if l == 0 else b_rest[l - 1, 0].reshape(4, H))
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
        if l + 1 == L:
            out[t] = m * h_new
        done[l] += 1
    return out, h, c


T, H = 9, 256
KP = 0.4


def _problem(L, B, seed):
    rng = np.random.default_rng(seed)
    lim = (6.0 / (H + 4 * H)) ** 0.5
    w = lambda *s: rng.uniform(-lim, lim, s).astype(np.float32)
    f = lambda *s, scale: rng.normal(0, scale, s).astype(np.float32)
    lens = np.asarray([T if b % 4 == 0 else (7 * b) % (T + 1) for b in range(B)], np.int32)
    lens[min(2, B - 1)] = 0
    mask = (np.arange(T)[:, None] < lens[None]).astype(np.float32)[:, None, :]
    return dict(xp0=f(T, B, 4 * H, scale=0.5), w_h=w(L, H, 4 * H), w_x_rest=w(L - 1, H, 4 * H),
                b_rest=f(L - 1, 1, 4 * H, scale=0.1), mask=mask, h0=f(L, B, H, scale=0.3),
                c0=f(L, B, H, scale=0.3))


ARGS = ("xp0", "w_h", "w_x_rest", "b_rest", "mask", "h0", "c0")


def _torch_args(p):
    bf = {"w_h", "w_x_rest"}
    return [torch.tensor(np.asarray(jnp.asarray(p[k], jnp.bfloat16).astype(jnp.float32)))
            .to(bf16) if k in bf else torch.tensor(p[k]) for k in ARGS]


@pytest.mark.parametrize("B", [5, 70])
@pytest.mark.parametrize("L", [2, 3])
def test_kernel_order_matches_jax_wavefront(L, B):
    p = _problem(L, B, 40 + L + B)
    jargs = [jnp.asarray(p[k], jnp.bfloat16) if k in ("w_h", "w_x_rest") else jnp.asarray(p[k])
             for k in ARGS]
    with pltpu.force_tpu_interpret_mode():
        ref = jwave.lstm_stack_wavefront(*jargs)
    ref = [np.asarray(r) for r in ref]
    args = _torch_args(p)
    assert twave.wavefront_eval_layout(B, H, L)["groups"] == (1 if B <= ROWS else 2)
    got = _walk(*args)
    plain = twave.lstm_stack_wavefront_plain(*args)
    for r, g_, q in zip(ref, got, plain):
        np.testing.assert_allclose(g_.numpy(), r, **BF16)
        np.testing.assert_allclose(q.numpy(), r, **BF16)
    # The zero-length row keeps its state and stores zero outputs.
    assert not got[0][:, 2].any()
    assert torch.equal(got[1][:, 2], args[5][:, 2]) and torch.equal(got[2][:, 2], args[6][:, 2])


@pytest.mark.parametrize("ring", [2, 3])
def test_shallow_rings_give_the_same_result(ring):
    """The ring's depth bounds how far a layer runs ahead, not what it
    computes: rings of 2 and 3 steps give the walk's result at the default
    depth bit for bit, with two row groups."""
    p = _problem(3, 70, 5)
    args = _torch_args(p)
    deep = _walk(*args)
    for a, b in zip(_walk(*args, ring=ring), deep):
        assert torch.equal(a, b)
