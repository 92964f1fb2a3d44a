"""The float32 training forward's layer sweep (row 3) and the float32
skinny weight-gradient tile (row 15), on the CPU against the JAX package.

* ``fwd_f32_plan`` (``csrc/lstm_layer_fwd_f32.cu``): the grid within the
  card (H/32 slices x 4 CTAs), the shared memory within a block's, the K
  quarters covering H once in whole 32-column boxes, the batch in
  ceil(B/64) row groups.
* The sweep's plain decomposition (``sweep_fwd_plain`` a layer, bottom
  up: the input product into the gates residual, the recurrence on it,
  the next layer's input h·keep·scale) and a walk in the chain's order of
  work (each step's carry product as the four K quarters' partials of
  each 32-unit slice's 128 gate columns, summed in the order of q, per
  64-row group) against JAX's ``_wavefront_train`` (``_wavefront_train_kernel``,
  TPU interpret mode) in float32 at L=3, H=128 (4 slices), ragged lengths,
  drop modes 0 and 1 (explicit masks; mode 2's TPU bits have no torch
  counterpart): outs, gates, cseq, hn, cn.
* The float32 skinny tile's plan (``grad_matmul._skinny_f32_plan``): which
  operand is wide, chunks covering it once, K slices covering N once in
  whole 16-row stages, the grid filling the card at two blocks an SM, the
  shared memory; and a walk of its split (each block's rows in order, the
  slices' partials summed in order, db from dg's columns) against JAX's
  ``weight_grad`` (``_single_grad_kernel``) in float32, TPU interpret mode.

Tolerance: float32 throughout, another summation order than JAX's, so
each tensor within TOL = 1e-4 of its largest magnitude (readings ~1e-6).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from rnn_speech_tpu.ops import grad_matmul_pallas as jgm
from rnn_speech_tpu.ops import lstm_wavefront as jwave
from rnn_speech_tpu_torch.ops import grad_matmul as gm
from rnn_speech_tpu_torch.ops import lstm_layer_train as tlt
from rnn_speech_tpu_torch.ops import lstm_recurrence as trec
from rnn_speech_tpu_torch.ops import lstm_wavefront as twave

f32 = torch.float32
TOL = 1e-4
SMS = trec.H100_SMS
SM_SMEM = 233472          # an H100 SM's shared memory, of which each block reserves 1 KiB


def _rel(got, ref):
    ref = np.asarray(ref, np.float32)
    got = got.detach().to(f32).numpy()
    assert got.shape == ref.shape
    return float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30))


# ---------------------------------------------------------------- row 3


@pytest.mark.parametrize("H", [128, 256, 512, 1024, 1152, 2048])
@pytest.mark.parametrize("B", [1, 63, 64, 65, 70, 129, 394, 400])
def test_fwd_f32_plan_arithmetic(B, H):
    """The chain's grid (H/32 slices x 4 CTAs, one an SM), its shared
    memory (W_h's quarter of K for 128 gate columns, rows padded by 4; the
    eight-stage ring of (64, 32 + 4) boxes) within a block's, the K
    quarters in whole 32-column boxes covering H once, ceil(B/64) row
    groups covering B once; past the card (H=1152: 144 CTAs; H=2048) the
    per-step answer."""
    plan = tlt.fwd_f32_plan(B, H)
    if H // 8 > SMS:
        assert plan == {"kernel": "per_step"}
        return
    smem = 4 * (128 * (H // 4 + 4) + 8 * 64 * 36)
    assert smem <= trec.SMEM_LIMIT
    assert plan == {"kernel": "persistent_f32", "groups": -(-B // 64), "slices": H // 32,
                    "grid": H // 8, "stages": 8, "smem": smem}
    quarters = [(q * H // 4, (q + 1) * H // 4) for q in range(4)]
    assert quarters[0][0] == 0 and quarters[-1][1] == H
    assert all(a[1] == b[0] and (a[1] - a[0]) % tlt.FWD_F32_KBOX == 0
               for a, b in zip(quarters, quarters[1:] + [(H, H)]))
    rows = [(g * 64, min(B, g * 64 + 64)) for g in range(plan["groups"])]
    assert rows[-1][1] == B and all(lo < hi for lo, hi in rows)
    assert tlt.fwd_f32_plan(B, 1024, sms=100) == {"kernel": "per_step"}   # 128 CTAs > 100


def test_fwd_f32_plan_refuses_other_widths():
    for H in (64, 192, 320, 1000):
        assert tlt.fwd_f32_plan(64, H) == {"kernel": "per_step"}
        assert twave.wavefront_plan(64, H, 3, H, dtype=f32) == {"kernel": "per_diagonal"}


T, L, H, D = 12, 3, 128, 40
B = 70                    # two 64-row groups
LENS = np.asarray([T - (5 * b) % (T + 1) for b in range(B)], np.int32)
KEEP = 0.6


def _jax_fwd(drop_mode, seed=3):
    """JAX's training forward (``_wavefront_train``, TPU interpret mode),
    float32 compute and residuals; numpy in and out."""
    rng = np.random.default_rng(seed)
    lim = np.sqrt(6.0 / (5 * H))
    u = lambda *s: rng.uniform(-lim, lim, s).astype(np.float32)
    n = lambda *s, scale=1.0: (rng.normal(size=s) * scale).astype(np.float32)
    arrs = dict(x=n(T, B, D), w_x0=u(D, 4 * H), w_h=u(L, H, 4 * H), w_x_rest=u(L - 1, H, 4 * H),
                b_all=n(L, 1, 4 * H, scale=0.1),
                mask=(np.arange(T)[:, None] < LENS[None]).astype(np.float32)[:, None, :],
                h0=n(L, B, H, scale=0.2), c0=n(L, B, H, scale=0.2))
    masks = (rng.uniform(size=(L - 1, T, B, H)) < KEEP).astype(np.float32)
    drop_arr = masks if drop_mode == 1 else None
    scale = 1 / KEEP if drop_mode else 1.0
    j = lambda a: None if a is None else jnp.asarray(a)
    with pltpu.force_tpu_interpret_mode():
        outs, gates, cseqs, hn, cn = jwave._wavefront_train(
            j(arrs["x"]), j(arrs["w_x0"]), j(arrs["w_h"]), j(arrs["w_x_rest"]),
            j(arrs["b_all"]), drop_mode, j(drop_arr), scale, KEEP, j(arrs["mask"]),
            j(arrs["h0"]), j(arrs["c0"]), jnp.float32)
    ref = [np.stack([np.asarray(a) for a in t]) for t in (outs, gates, cseqs)]
    ref += [np.asarray(hn), np.asarray(cn)]
    return {k: torch.as_tensor(v) for k, v in arrs.items()}, torch.as_tensor(masks), ref


def _chain_walk(xp, w_h, mask, h0, c0):
    """One layer's recurrence in the chain's order of work: per step and
    64-row group, for each 32-unit slice u the four K quarters' partial
    products over the slice's 128 gate columns (gate-major: column 32·gate
    + i is gate column gate·H + 32u + i), summed in the order of q, added
    to xp; then the cell.  Returns (outs, gates, cseq, hn, cn, hcar)."""
    Tn, Bn, G = xp.shape
    Hn = G // 4
    KQ, slices = Hn // 4, Hn // 32
    cols = [torch.cat([g * Hn + 32 * u + torch.arange(32) for g in range(4)])
            for u in range(slices)]
    h, c = h0.clone(), c0.clone()
    outs, cseq, hcar = (torch.empty((Tn, Bn, Hn)) for _ in range(3))
    gates = torch.empty((Tn, Bn, G))
    for t in range(Tn):
        pre = torch.empty((Bn, G))
        for g0 in range(0, Bn, 64):
            rows = slice(g0, min(Bn, g0 + 64))
            for u in range(slices):
                acc = torch.zeros((rows.stop - rows.start, 128))
                for q in range(4):
                    ks = slice(q * KQ, (q + 1) * KQ)
                    acc = acc + h[rows, ks] @ w_h[ks][:, cols[u]]
                pre[rows, cols[u]] = xp[t, rows][:, cols[u]] + acc
        i_a, g_a, f_a, o_a = (torch.sigmoid(pre[:, :Hn]), torch.tanh(pre[:, Hn:2 * Hn]),
                              torch.sigmoid(pre[:, 2 * Hn:3 * Hn] + 1.0),
                              torch.sigmoid(pre[:, 3 * Hn:]))
        c_new = f_a * c + i_a * g_a
        h_new = o_a * torch.tanh(c_new)
        m = mask[t, 0][:, None]
        c = m * c_new + (1.0 - m) * c
        h = m * h_new + (1.0 - m) * h
        outs[t], cseq[t], hcar[t] = m * h_new, c, h
        gates[t] = torch.cat([i_a, g_a, f_a, o_a], dim=-1)
    return outs, gates, cseq, h, c, hcar


def _check(got, ref):
    worst = max(_rel(g, r) for g, r in zip(got, ref))
    assert worst <= TOL, worst


@pytest.mark.parametrize("drop_mode", [0, 1])
def test_sweep_decomposition_matches_wavefront_train(drop_mode):
    """``sweep_fwd_plain`` a layer from the bottom up (the input product
    into the gates residual, the recurrence, the next layer's input h·keep·
    scale) against JAX's diagonal, beside ``wavefront_train_plain``."""
    a, masks, ref = _jax_fwd(drop_mode)
    keep_scale = masks / KEEP if drop_mode else None
    res = [[] for _ in range(5)]
    x_in = a["x"]
    for l in range(L):
        w_x = a["w_x0"] if l == 0 else a["w_x_rest"][l - 1]
        ks = None if keep_scale is None or l == L - 1 else keep_scale[l]
        out = twave.sweep_fwd_plain(x_in, w_x, a["b_all"][l, 0], a["w_h"][l], a["mask"],
                                    a["h0"][l], a["c0"][l], ks, feed=l + 1 < L)
        for acc, v in zip(res, out[:5]):
            acc.append(v)
        assert (out[5] is None) == (l == L - 1)
        x_in = out[5]
    _check([torch.stack(r) for r in res], ref)
    drop = (drop_mode, masks if drop_mode else None, 1 / KEEP if drop_mode else 1.0, KEEP)
    plain = twave.wavefront_train_plain(a["x"], a["w_x0"], a["w_h"], a["w_x_rest"],
                                        a["b_all"][:, 0], a["mask"], a["h0"], a["c0"], f32,
                                        *drop)
    _check(plain, ref)


def test_chain_walk_matches_wavefront_train():
    """The chain's order of work (K quarters of 32-unit slices, row groups
    of 64, partials summed in the order of q) layer by layer, drop mode 1,
    against JAX's diagonal."""
    a, masks, ref = _jax_fwd(1, seed=5)
    keep_scale = masks / KEEP
    res = [[] for _ in range(5)]
    x_in = a["x"]
    for l in range(L):
        w_x = a["w_x0"] if l == 0 else a["w_x_rest"][l - 1]
        xp = a["b_all"][l, 0] + x_in @ w_x
        *out, hcar = _chain_walk(xp, a["w_h"][l], a["mask"], a["h0"][l], a["c0"][l])
        for acc, v in zip(res, out):
            acc.append(v)
        if l + 1 < L:
            x_in = hcar * keep_scale[l]
    _check([torch.stack(r) for r in res], ref)


# --------------------------------------------------------------- row 15

PROJECTIONS = [(120, 1024, "dg"), (1024, 80, "x")]


@pytest.mark.parametrize("Dn,G,wide", PROJECTIONS)
def test_skinny_f32_plan_at_the_projections(Dn, G, wide):
    """Both float32 projections take the float32 skinny tile: the 1024-wide
    operand in 8 chunks of 128 columns, the narrow side whole, 33 K slices
    of 6,816 rows (426 stages of 16): 264 blocks, two an SM on 132 SMs."""
    N = 3510 * 64
    pl = gm.plan([Dn], N, G, f32, SMS, f32, compute_dtype=f32)
    assert pl.path == "skinny_f32" and pl.wide == wide
    assert (pl.chunks, pl.splits, pl.rows_per_split) == (8, 33, 6816)
    assert pl.chunks * pl.splits <= 2 * SMS
    assert pl.smem == gm.skinny_f32_smem(min(Dn, G)) <= trec.SMEM_LIMIT
    assert 2 * (pl.smem + 1024) <= SM_SMEM                     # two blocks an SM fit
    assert gm.skinny_f32_narrow(min(Dn, G)) == {120: 8, 80: 5}[min(Dn, G)]


@pytest.mark.parametrize("Dn,N,G", [(120, 3510 * 64, 1024), (1024, 3510 * 64, 80),
                                    (1024, 3510 * 394, 80), (7, 100003, 13), (256, 5000, 256),
                                    (136, 4999, 200), (256, 1, 300), (8, 70001, 1032),
                                    (1, 17, 1)])
def test_skinny_f32_covers_each_element_once(Dn, N, G):
    """The chunks cover the wide operand's columns once (the last may be
    ragged, never empty), the K slices cover [0, N) once in whole 16-row
    stages (none empty, at least 1024 rows unless one slice), the narrow
    side fits one block's 16 thread groups, the grid stays within two
    blocks an SM (one past a narrow side of 128), the shared memory within
    a block's."""
    pl = gm.plan([Dn], N, G, f32, SMS, f32, compute_dtype=f32)
    assert pl.path == "skinny_f32"
    w, n = (G, Dn) if pl.wide == "dg" else (Dn, G)
    assert w >= n and n <= gm.SKINNY_NARROW and 16 * gm.skinny_f32_narrow(n) >= n
    assert (pl.chunks - 1) * 128 < w <= pl.chunks * 128
    assert pl.rows_per_split % 16 == 0
    assert (pl.splits - 1) * pl.rows_per_split < N <= pl.splits * pl.rows_per_split
    assert pl.splits == 1 or pl.rows_per_split >= 1024
    per_sm = 2 if gm.skinny_f32_narrow(n) <= 8 else 1
    assert pl.chunks * pl.splits <= max(per_sm * SMS, pl.chunks)
    assert pl.smem <= trec.SMEM_LIMIT
    assert pl == gm.plan([Dn], N, G, f32, SMS, f32, compute_dtype=f32)   # every call


def _skinny_walk(x, dg, pl):
    """dW, db in the float32 skinny tile's order of work: each K slice's
    rows in order into its partial (every block of a slice sums its own
    columns; db from dg's columns), the slices' partials summed in order."""
    dw = torch.zeros((x.shape[1], dg.shape[1]))
    db = torch.zeros((dg.shape[1],))
    for s in range(pl.splits):
        rows = slice(s * pl.rows_per_split, min(x.shape[0], (s + 1) * pl.rows_per_split))
        part, part_db = torch.zeros_like(dw), torch.zeros_like(db)
        for r in range(rows.start, rows.stop):
            part += torch.outer(x[r], dg[r])
            part_db += dg[r]
        dw, db = dw + part, db + part_db
    return dw, db


@pytest.mark.parametrize("Dn,N,G,sms", [(24, 2600, 200, 8), (40, 2100, 16, 4), (7, 1003, 13, 132)])
def test_skinny_f32_split_matches_single_grad_kernel(Dn, N, G, sms):
    """The float32 skinny tile's split walked in its order (several K
    slices on a small card), and ``weight_grad``'s plain version, against
    JAX's ``weight_grad`` with compute_dtype float32 (TPU interpret mode):
    dW and db within TOL of their largest magnitude."""
    rng = np.random.default_rng(Dn + N)
    x = rng.normal(size=(N, Dn)).astype(np.float32)
    dg = (rng.normal(size=(N, G)) * 0.1).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        ref = jgm.weight_grad(jnp.asarray(x), jnp.asarray(dg), compute_dtype=jnp.float32)
    pl = gm.plan([Dn], N, G, f32, sms, f32, compute_dtype=f32)
    assert pl.path == "skinny_f32" and (pl.splits > 1 or N < 2048)
    tx, tdg = torch.as_tensor(x), torch.as_tensor(dg)
    for got in (_skinny_walk(tx, tdg, pl), gm.weight_grad(tx, tdg, compute_dtype=f32)):
        for g, r in zip(got, ref):
            assert _rel(g, r) <= TOL
