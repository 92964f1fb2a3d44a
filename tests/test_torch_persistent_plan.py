"""The persistent layered backward (row 6: ``ops/lstm_layer_train.py``
``bwd_plan``, ``bwd_smem``; ``csrc/lstm_layer_bwd_persistent.cu``) and the
persistent forward as the inference recurrence (row 2:
``ops/lstm_recurrence.py`` ``lean_plan(..., x_f32=True)``;
``csrc/lstm_layer_lean.cu``), on the CPU.  The kernels run only on the card;
what decides their grids and shared memory, and the order in which they
split and sum the work, is tested here.

The orders of work against the JAX package, at T=7, B=5, H=128 with ragged
lengths and a zero-length row, the JAX kernels in TPU interpret mode:
* the backward: a walk that forms the carry's product as the kernel does,
  per 64-unit slice and eighth of K = 4H (W_h's own rows J of the slice,
  the eighth's columns: a (B, 64) partial each), sums a slice's eight
  partials in the order of the eighths, and runs the cell backward of each
  CTA's 8 units, against ``_lstm_recurrence_bwd`` on the JAX forward's own
  bf16 residuals;
* the forward: a walk that reads float32 x_proj as the kernel's TMA boxes
  hold it (per CTA of 16 units and gate, columns g·H + 16u .. + 16) and W_h
  in ``lean_column_order``, against ``lstm_recurrence_pallas``.
Both sides round the same operands to bf16 and sum in float32 in another
order; where two sums straddle a bf16 rounding (of h, or of a dgate) the
result moves by one step (2^-8 relative) and propagates: 4e-3 relative and
absolute, the layered route's bf16 tolerance.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from rnn_speech_tpu.ops import lstm_pallas as jpal
from rnn_speech_tpu_torch.ops import lstm_layer_train as tlt
from rnn_speech_tpu_torch.ops import lstm_recurrence as trec

SMEM_OPT_IN = 232448          # bytes of shared memory a block may use on the H100
BF16 = dict(rtol=4e-3, atol=4e-3)
f32, bf16 = torch.float32, torch.bfloat16


# ------------------------------------------------ the backward's plan (row 6)


@pytest.mark.parametrize("H", [128, 512, 1024])
@pytest.mark.parametrize("B", [1, 5, 17, 64])
def test_bwd_plan_takes_the_persistent_kernel_and_fits(B, H):
    """The layered step's batch (B=64 at H=1024) and the small shapes go to
    the persistent backward on the H100's 132 SMs: the grid fits one CTA
    an SM, the row groups cover the batch, and the resident W_h slice with
    an eighth of a step's dgates fits the shared memory; the same plan
    comes back on every call."""
    plan = tlt.bwd_plan(B, H)
    assert plan["kernel"] == "persistent"
    assert plan["slices"] == H // tlt.BWD_UNITS
    assert plan["grid"] == plan["groups"] * plan["slices"] * tlt.BWD_SPLIT <= tlt.H100_SMS
    assert plan["rows"] == plan["groups"] * tlt.BWD_ROWS >= B
    assert plan["rows"] - B < tlt.BWD_ROWS                   # no row group left empty
    assert plan["smem"] == tlt.bwd_smem(H) <= SMEM_OPT_IN
    assert all(tlt.bwd_plan(B, H) == plan for _ in range(3))
    assert tlt.bwd_plan(B, H, sms=tlt.H100_SMS) == plan


def test_layered_step_shape_gets_one_row_group_of_128_ctas():
    """B=64, H=1024: 16 slices of 64 units, eight CTAs each (an eighth of
    K = 4H each), and the A-stream budget of the source note: a 64 KiB W_h
    slice beside a 64 KiB eighth of the step's dgates, 8 boxes each."""
    plan = tlt.bwd_plan(64, 1024)
    assert (plan["groups"], plan["slices"], plan["grid"], plan["rows"]) == (1, 16, 128, 64)
    assert plan["smem"] == 8 * (64 * 64 * 2) + 8 * (64 * 64 * 2) + 8 * 10 + 1024
    assert 64 * 512 * 2 == 64 << 10


@pytest.mark.parametrize("B,H,sms", [(65, 1024, 114), (64, 1024, 114), (64, 96, 132),
                                     (64, 64, 132), (64, 1152, 132), (64, 3968, 1000),
                                     (0, 1024, 132), (129, 512, 60)])
def test_bwd_plan_sends_what_the_persistent_kernel_cannot_take_to_the_per_step_kernel(
        B, H, sms):
    """A grid larger than the card (128 CTAs at H=1024 on 114 SMs, 18 slices
    at H=1152, 64 CTAs at H=512 on 60 SMs; the row groups, walked in turn,
    no longer grow the grid), H not a multiple of 128, shared memory past
    the card's (H=3968 on a card of 1000 SMs), or no batch."""
    assert tlt.bwd_plan(B, H, sms) == {"kernel": "per_step"}


@pytest.mark.parametrize("H", [128, 256, 1024])
def test_bwd_ctas_partition_w_h_and_the_cells(H):
    """CTA (u, q) holds W_h[64u .. 64u + 64, Kq .. Kq + K) with K = 4H/8:
    over all CTAs every element of W_h exactly once; and it runs the cells
    of units 64u + 8q .. + 8 (a thread 4 of them): every unit exactly once."""
    U, S = tlt.BWD_UNITS, tlt.BWD_SPLIT
    K = 4 * H // S
    seen = torch.zeros((H, 4 * H), dtype=torch.int64)
    units = []
    for u in range(H // U):
        for q in range(S):
            seen[U * u:U * u + U, q * K:(q + 1) * K] += 1
            for half in range(2):
                units += [U * u + 8 * q + 4 * half + e for e in range(4)]
    assert bool((seen == 1).all())
    assert sorted(units) == list(range(H))


def _bwd_in_kernel_order(dout, gates, cseq, c0, mask, w_h, dhn, dcn):
    """The gates-mode backward in the persistent kernel's order of work:
    pass s = 0 .. T forms the carry's product of dgates(T - s) per slice
    and eighth of K and sums the eight partials in order, then (s < T)
    runs the cell of step T-1-s per CTA's 8 units, writing bf16 dgates over
    the gates; the last pass gives dh0.  Returns (dgates, dh0, dc0)."""
    T, B, H = cseq.shape
    U, S = tlt.BWD_UNITS, tlt.BWD_SPLIT
    w = w_h.to(f32)
    dgates = gates.clone()
    dh, dc = dhn.to(f32).clone(), dcn.to(f32).clone()
    for s in range(T + 1):
        t = T - 1 - s
        ph = torch.zeros((B, H))
        if s > 0:
            a = dgates[T - s].to(f32)
            for u in range(H // U):
                J = slice(U * u, U * u + U)
                acc = torch.zeros((B, U))
                for q in range(S):
                    K = slice(q * 4 * H // S, (q + 1) * 4 * H // S)
                    acc = acc + a[:, K] @ w[J, K].t()
                ph[:, J] = acc
        if s == T:
            return dgates, dh + ph, dc
        m = mask[t, 0][:, None]
        i_a, g_a, f_a, o_a = gates[t].to(f32).split(H, dim=-1)
        c_t = cseq[t].to(f32)
        c_p = cseq[t - 1].to(f32) if t > 0 else c0.to(f32)
        for u in range(H // U):
            for q in range(S):
                J = slice(U * u + 8 * q, U * u + 8 * q + 8)
                dh_carry = dh[:, J] + ph[:, J]
                tanh_c = torch.tanh(c_t[:, J])
                dh_new = m * (dout[t][:, J] + dh_carry)
                do_pre = dh_new * tanh_c * o_a[:, J] * (1 - o_a[:, J])
                dc_new = dh_new * o_a[:, J] * (1 - tanh_c * tanh_c) + m * dc[:, J]
                di = dc_new * g_a[:, J] * i_a[:, J] * (1 - i_a[:, J])
                dgg = dc_new * i_a[:, J] * (1 - g_a[:, J] * g_a[:, J])
                df = dc_new * c_p[:, J] * f_a[:, J] * (1 - f_a[:, J])
                for g, v in enumerate((di, dgg, df, do_pre)):
                    cols = slice(g * H + J.start, g * H + J.stop)
                    dgates[t][:, cols] = v.to(dgates.dtype)
                dh[:, J] = (1 - m) * dh_carry
                dc[:, J] = (1 - m) * dc[:, J] + dc_new * f_a[:, J]


def _inputs(seed, T=7, B=5, H=128):
    rng = np.random.default_rng(seed)
    f = lambda *s, scale: rng.normal(0, scale, s).astype(np.float32)
    lens = np.asarray([7, 4, 0, 6, 1], np.int32)
    mask = (np.arange(T)[:, None] < lens[None]).astype(np.float32)[:, None, :]
    return dict(x_proj=f(T, B, 4 * H, scale=1.0), w_h=f(H, 4 * H, scale=0.1), mask=mask,
                h0=f(B, H, scale=0.3), c0=f(B, H, scale=0.3), dout=f(T, B, H, scale=0.5),
                dhn=f(B, H, scale=0.3), dcn=f(B, H, scale=0.3))


def _t(a):
    a = np.asarray(a.astype(jnp.float32)) if hasattr(a, "dtype") and a.dtype == jnp.bfloat16 \
        else np.asarray(a)
    return torch.tensor(a)


@pytest.mark.parametrize("seed", [0, 1])
def test_bwd_kernel_order_matches_jax_gates_backward(seed):
    x = _inputs(seed)
    w_h = jnp.asarray(x["w_h"], jnp.bfloat16)
    with pltpu.force_tpu_interpret_mode():
        _, _, _, gates, cseq = jax.jit(jpal._lstm_recurrence_train, static_argnums=5)(
            jnp.asarray(x["x_proj"]), w_h, x["mask"], x["h0"], x["c0"], jnp.bfloat16)
        c0_rd = jnp.asarray(x["c0"]).astype(jnp.bfloat16)
        c_prev = jnp.concatenate([c0_rd[None], cseq[:-1]], axis=0)
        ref = jax.jit(jpal._lstm_recurrence_bwd)(
            x["dout"], gates, cseq, c_prev, x["mask"], w_h, x["dhn"], x["dcn"])
    args = (torch.tensor(x["dout"]), _t(gates).to(bf16), _t(cseq).to(bf16),
            _t(c0_rd), torch.tensor(x["mask"]), _t(w_h).to(bf16), torch.tensor(x["dhn"]),
            torch.tensor(x["dcn"]))
    got = _bwd_in_kernel_order(*args)
    plain = tlt.recurrence_bwd_plain(args[0], args[1].clone(), *args[2:])
    assert got[0].dtype == bf16
    for r, g_, p in zip(ref, got, plain):
        r = np.asarray(r.astype(jnp.float32))
        np.testing.assert_allclose(g_.float().numpy(), r, **BF16)
        np.testing.assert_allclose(p.float().numpy(), r, **BF16)
    # The zero-length row: no dgates, dh and dc pass through.
    assert not got[0][:, 2].float().any()
    assert torch.equal(got[2][2], args[7][2])


# ---------------------------------- the inference recurrence's plan (row 2)


def test_recurrence_plan_at_the_serving_shapes():
    """B=128 (the eval batch): 2 row groups x 64 slices of one tile each,
    128 CTAs, 8 ring stages beside the resident W_h slice and two step
    buffers of f32 x_proj; B=1 (a ``--file`` clip): one padded tile."""
    plan = trec.lean_plan(128, 1024, x_f32=True)
    assert (plan["groups"], plan["tiles"], plan["grid"], plan["stages"]) == (2, 1, 128, 8)
    one = trec.lean_plan(1, 1024, x_f32=True)
    assert (one["groups"], one["tiles"], one["grid"], one["rows"]) == (1, 1, 64, 64)
    for p in (plan, one):
        assert p["smem"] == trec.lean_smem(1024, 1, 8, x_f32=True) <= SMEM_OPT_IN


@pytest.mark.parametrize("H", [128, 1024])
@pytest.mark.parametrize("B", [1, 5, 64, 128, 200])
def test_recurrence_plan_fits_and_counts_the_x_buffers(B, H):
    """f32 x_proj adds two step buffers of four 64x16 f32 boxes a tile and
    their four mbarriers to the bf16 plan's shared memory; the geometry is
    the bf16 plan's, the ring the deepest that still fits."""
    plan = trec.lean_plan(B, H, x_f32=True)
    lean = trec.lean_plan(B, H)
    assert plan["kernel"] == "persistent"
    assert {k: plan[k] for k in ("groups", "tiles", "grid", "rows")} == \
        {k: lean[k] for k in ("groups", "tiles", "grid", "rows")}
    tiles, stages = plan["tiles"], plan["stages"]
    assert plan["smem"] == trec.lean_smem(H, tiles, stages, x_f32=True) <= SMEM_OPT_IN
    assert trec.lean_smem(H, tiles, stages, x_f32=True) - trec.lean_smem(H, tiles, stages) \
        == 2 * tiles * 4 * 64 * 16 * 4 + 8 * 4
    assert trec.lean_smem(H, tiles, stages + 1, x_f32=True) > SMEM_OPT_IN or \
        stages == trec.LEAN_MAX_STAGES


@pytest.mark.parametrize("B,H,sms", [(400, 1024, 132), (600, 1024, 132), (128, 1024, 60),
                                     (128, 96, 132), (0, 1024, 132)])
def test_recurrence_plan_sends_what_the_persistent_kernel_cannot_take_to_the_per_step_kernel(
        B, H, sms):
    """Four tiles a CTA leave no room for two stages beside the x buffers
    (B=400), a grid larger than the card, H not a multiple of 64, no batch."""
    assert trec.lean_plan(B, H, sms, x_f32=True) == {"kernel": "per_step"}


@pytest.mark.parametrize("H", [64, 128, 1024])
def test_x_boxes_are_the_ctas_columns_in_kernel_order(H):
    """The f32 x_proj box of CTA u and gate g (columns g·H + 16u .. + 16 of
    a (T·B, 4H) row) holds the x_proj of the columns the CTA's W_h slice
    computes, slots 64u + 16g .. + 16 of ``lean_column_order``."""
    perm = trec.lean_column_order(H)
    for u in range(H // 16):
        for g in range(4):
            assert perm[64 * u + 16 * g:64 * u + 16 * g + 16].tolist() == \
                list(range(g * H + 16 * u, g * H + 16 * u + 16))


def _recurrence_in_kernel_order(x_proj, w_h, mask, h0, c0):
    """``lstm_recurrence_plain`` as the persistent forward walks it: W_h's
    columns in ``lean_column_order``, each CTA's f32 x_proj read from its
    four boxes and added to its float32 product, the cell per CTA."""
    T, B, four_h = x_proj.shape
    H = four_h // 4
    wp = trec.lean_weights(w_h).to(f32).t()                 # (H, 4H), slots in kernel order
    h, c = h0.clone(), c0.clone()
    out = torch.zeros((T, B, H))
    for t in range(T):
        prod = h.to(bf16).to(f32) @ wp
        h_new, c_new = torch.empty_like(h), torch.empty_like(c)
        for u in range(H // 16):
            pre = [prod[:, 64 * u + 16 * g:64 * u + 16 * g + 16]
                   + x_proj[t][:, g * H + 16 * u:g * H + 16 * u + 16] for g in range(4)]
            i, g_, f, o = (torch.sigmoid(pre[0]), torch.tanh(pre[1]),
                           torch.sigmoid(pre[2] + 1.0), torch.sigmoid(pre[3]))
            J = slice(16 * u, 16 * u + 16)
            c_new[:, J] = f * c[:, J] + i * g_
            h_new[:, J] = o * torch.tanh(c_new[:, J])
        m = mask[t, 0][:, None]
        c = m * c_new + (1 - m) * c
        h = m * h_new + (1 - m) * h
        out[t] = m * h_new
    return out, h, c


@pytest.mark.parametrize("seed", [0, 1])
def test_recurrence_kernel_order_matches_jax(seed):
    x = _inputs(seed)
    w_h = jnp.asarray(x["w_h"], jnp.bfloat16)
    with pltpu.force_tpu_interpret_mode():
        ref = jax.jit(jpal.lstm_recurrence_pallas)(
            jnp.asarray(x["x_proj"]), w_h, x["mask"], x["h0"], x["c0"])
    args = (torch.tensor(x["x_proj"]), _t(w_h).to(bf16), torch.tensor(x["mask"]),
            torch.tensor(x["h0"]), torch.tensor(x["c0"]))
    got = _recurrence_in_kernel_order(*args)
    plain = trec.lstm_recurrence_plain(*args)
    for r, g_, p in zip(ref, got, plain):
        np.testing.assert_allclose(g_.numpy(), np.asarray(r), **BF16)
        np.testing.assert_allclose(p.numpy(), np.asarray(r), **BF16)
    assert not got[0][:, 2].any() and torch.equal(got[1][2], args[3][2])


# ------------------------------------- the gates-mode forward's plan (row 5)


def test_train_plan_at_the_layered_step_shape():
    """The gates-mode forward takes the inference recurrence's plan: at the
    layered step's B=64, H=1024 one row group of 64 slices (64 CTAs), one
    tile each, 8 ring stages beside the W_h slice and the f32 x_proj
    buffers; the gates and c residuals take no shared memory."""
    plan = tlt.lean_plan(64, 1024, x_f32=True)
    assert plan["kernel"] == "persistent"
    assert (plan["groups"], plan["tiles"], plan["grid"], plan["stages"], plan["rows"]) == \
        (1, 1, 64, 8, 64)
    assert plan["smem"] == trec.lean_smem(1024, 1, 8, x_f32=True) <= SMEM_OPT_IN
    assert tlt.lean_plan(260, 1024, x_f32=True) == {"kernel": "per_step"}


def _train_in_kernel_order(x_proj, w_h, mask, h0, c0):
    """``recurrence_train_plain`` as the persistent forward's gates instance
    walks it: ``_recurrence_in_kernel_order``'s products and cells, and
    each CTA storing its 16 units' four activated gates at their columns
    g·H + 16u .. + 16 of the (T, B, 4H) residual and its units' carried c,
    both bf16.  Returns (out, hn, cn, gates, cseq)."""
    T, B, four_h = x_proj.shape
    H = four_h // 4
    wp = trec.lean_weights(w_h).to(f32).t()
    h, c = h0.clone(), c0.clone()
    out = torch.zeros((T, B, H))
    gates = torch.zeros((T, B, four_h), dtype=bf16)
    cseq = torch.zeros((T, B, H), dtype=bf16)
    for t in range(T):
        prod = h.to(bf16).to(f32) @ wp
        m = mask[t, 0][:, None]
        h_new = torch.empty_like(h)
        for u in range(H // 16):
            J = slice(16 * u, 16 * u + 16)
            cols = [slice(g * H + 16 * u, g * H + 16 * u + 16) for g in range(4)]
            pre = [prod[:, 64 * u + 16 * g:64 * u + 16 * g + 16] + x_proj[t][:, cols[g]]
                   for g in range(4)]
            act = (torch.sigmoid(pre[0]), torch.tanh(pre[1]), torch.sigmoid(pre[2] + 1.0),
                   torch.sigmoid(pre[3]))
            c_new = act[2] * c[:, J] + act[0] * act[1]
            h_new[:, J] = act[3] * torch.tanh(c_new)
            c[:, J] = m * c_new + (1 - m) * c[:, J]
            for g in range(4):
                gates[t][:, cols[g]] = act[g].to(bf16)
        h = m * h_new + (1 - m) * h
        out[t] = m * h_new
        cseq[t] = c.to(bf16)
    return out, h, c, gates, cseq


@pytest.mark.parametrize("seed", [0, 1])
def test_train_kernel_order_matches_jax_and_feeds_the_backward(seed):
    """The walk against ``_lstm_recurrence_train`` (TPU interpret mode): out,
    hn, cn and both residuals; then its gates and c, in the order row 6
    reads them, through the gates-mode backward against
    ``_lstm_recurrence_bwd`` on the JAX forward's own residuals."""
    x = _inputs(seed)
    lim = (6.0 / (5 * 128)) ** 0.5                       # xavier-uniform W_h
    w_np = np.random.default_rng(10 + seed).uniform(-lim, lim, (128, 512)).astype(np.float32)
    w_h = jnp.asarray(w_np, jnp.bfloat16)
    with pltpu.force_tpu_interpret_mode():
        ref = jax.jit(jpal._lstm_recurrence_train, static_argnums=5)(
            jnp.asarray(x["x_proj"]), w_h, x["mask"], x["h0"], x["c0"], jnp.bfloat16)
        _, _, _, gates, cseq = ref
        c0_rd = jnp.asarray(x["c0"]).astype(jnp.bfloat16)
        c_prev = jnp.concatenate([c0_rd[None], cseq[:-1]], axis=0)
        ref_b = jax.jit(jpal._lstm_recurrence_bwd)(
            x["dout"], gates, cseq, c_prev, x["mask"], w_h, x["dhn"], x["dcn"])
    args = (torch.tensor(x["x_proj"]), _t(w_h).to(bf16), torch.tensor(x["mask"]),
            torch.tensor(x["h0"]), torch.tensor(x["c0"]))
    got = _train_in_kernel_order(*args)
    plain = tlt.recurrence_train_plain(*args, bf16)
    for r, g_, p in zip(ref, got, plain):
        r = np.asarray(r.astype(jnp.float32))
        np.testing.assert_allclose(g_.float().numpy(), r, **BF16)
        np.testing.assert_allclose(p.float().numpy(), r, **BF16)
    assert got[3].dtype == got[4].dtype == bf16
    assert not got[0][:, 2].any() and torch.equal(got[1][2], args[3][2])
    dgates = tlt.recurrence_bwd_plain(torch.tensor(x["dout"]), got[3].clone(), got[4],
                                      _t(c0_rd), args[2], args[1], torch.tensor(x["dhn"]),
                                      torch.tensor(x["dcn"]))
    for r, g_ in zip(ref_b, dgates):
        np.testing.assert_allclose(g_.float().numpy(), np.asarray(r.astype(jnp.float32)),
                                   **BF16)
