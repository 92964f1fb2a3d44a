"""The persistent reverse diagonal past one 64-row tile and with the fused
dW_x (rows 4 and 4f: ``ops/lstm_wavefront.py`` ``wavefront_bwd_plan``,
``wavefront_bwd_layout``, ``wavefront_bwd_row_groups``;
``csrc/lstm_wavefront_bwd_persistent.cu``, ``csrc/dwx_windows.cuh``), on
the CPU.  The kernel runs only on the card; its plan and the order in which
its launches take the pass are tested here.

The plan: every batch at 3x1024 goes to the persistent kernel, unfused and
fused; a CTA runs one or two 64-row groups (two consumer warpgroups past
64 rows, which cost W_h chunks in shared memory), and row groups of at most
128 rows run in turn.

The order of work: a walk that takes the pass as the host loop launches
it, window by window of W diagonals (layer l runs its passes s whose
diagonal s + L-1-l lies in the window; the last window also takes every
layer's pass T) and, within a window, row group by row group (at a test
size a group's tile is 2 rows, so B=5 is a launch of two 2-row tiles and
one of one).  Inside a launch the layers step as the kernel's counter
waits let them, a slice's four gate partials summed in the order of q, as
``tests/test_torch_wavefront_bwd_plan.py``'s walk does; at a window's end
the f32 carries leave and come back unchanged; after a window's launches
its dW_x products run over all rows, from the outs residual (drop mode 0)
or from the (L-1, W, B, H) ring the cells wrote (drop mode 2).  At L=3,
T=20, W=8 (22 diagonals: windows of 8, 8 and 6), H = 64 and 128, B=5 with
ragged lengths and a zero-length row: its dgates, dh0 and dc0 equal the
same walk's unfused pass (one window) bit for bit; its dW_x in drop mode 0
matches the JAX fused route (``_wavefront_bwd`` with
``RST_WAVEFRONT_FUSE_DWX=1``, its Pallas kernel in TPU interpret mode)
within the bf16 tolerance that
``tests/test_torch_fuse_dwx.py::test_fused_route_matches_jax_fused_route``
states (2e-3: both sides round the same operands to bf16 and sum in
float32), and in drop mode 2, whose bits JAX cannot reproduce, the port's
plain fused pass within it.
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
FUSED = dict(rtol=2e-3, atol=2e-3)
f32, bf16 = torch.float32, torch.bfloat16
NU = twave.WAVEFRONT_BWD_UNITS     # units of a slice
SPLIT = twave.WAVEFRONT_BWD_SPLIT  # CTAs of a slice


# --------------------------------------------------------------- the plan


@pytest.mark.parametrize("fuse", [False, True])
@pytest.mark.parametrize("B,groups,warpgroups", [
    (5, 1, 1), (64, 1, 1), (65, 1, 2), (96, 1, 2), (128, 1, 2), (129, 2, 2), (394, 4, 2),
])
def test_plan_takes_every_batch_at_the_default_width(B, groups, warpgroups, fuse):
    """3 x 1024 at any batch: 132 CTAs; ceil(B/128) row-group launches; one
    consumer warpgroup up to 64 rows, two past it; 14 of the 16 W_h chunks
    resident with one (225.1 KiB), 11 with two (221.1 KiB: each A stage
    holds two 64-row boxes), each as many as fit; the fused pass's window
    is FUSE_DWX_WINDOW diagonals."""
    plan = twave.wavefront_bwd_plan(B, 1024, 3, fuse)
    resident = {1: 14, 2: 11}[warpgroups]
    assert plan == {"kernel": "persistent", "slices": 11, "grid": 132, "groups": groups,
                    "warpgroups": warpgroups, "resident": resident,
                    "smem": twave.wavefront_bwd_smem(resident, warpgroups),
                    "window": twave.FUSE_DWX_WINDOW if fuse else 0}
    assert plan["smem"] <= SMEM_OPT_IN < twave.wavefront_bwd_smem(resident + 1, warpgroups)
    assert plan["smem"] == {1: 230504, 2: 226408}[warpgroups]


@pytest.mark.parametrize("H", [64, 128, 256, 512, 1024])
@pytest.mark.parametrize("warpgroups", [1, 2])
def test_resident_chunks_are_as_many_as_fit_beside_the_rings(H, warpgroups):
    res = twave.wavefront_bwd_resident(H, warpgroups)
    assert twave.wavefront_bwd_smem(res, warpgroups) <= SMEM_OPT_IN
    assert res == H // 64 or twave.wavefront_bwd_smem(res + 1, warpgroups) > SMEM_OPT_IN
    if warpgroups == 2:
        assert res <= twave.wavefront_bwd_resident(H, 1)


@pytest.mark.parametrize("B", [1, 5, 64, 65, 96, 128, 129, 200, 394])
def test_row_groups_cover_the_batch_once(B):
    """Launches of at most two 64-row tiles, in order, covering rows 0..B-1
    once; two warpgroups exactly where a launch has more than 64 rows; the
    last launch of B=394 is one warpgroup of 10 rows."""
    groups = twave.wavefront_bwd_row_groups(B)
    assert len(groups) == -(-B // 128) == twave.wavefront_bwd_layout(B, 1024, 3)["groups"]
    seen = []
    for r0, n, wg in groups:
        assert 1 <= n <= 128 and wg == (2 if n > 64 else 1)
        seen += range(r0, r0 + n)
    assert seen == list(range(B))
    if B == 394:
        assert groups[-1] == (384, 10, 1)


# ------------------------------------------------- the order of work


def _cta_block(w, u, q):
    """CTA (u, q)'s W operand: rows 96u .. 96u + 95 of the layer's (H, 4H)
    W (zero past H), gate q's K columns."""
    H = w.shape[0]
    block = torch.zeros((NU, H), dtype=w.dtype)
    rows = w[NU * u: NU * (u + 1), q * H: (q + 1) * H]
    block[: rows.shape[0]] = rows
    return block


def _kernel_keeps(seed, keep, l, t, B, H):
    """Boundary l's keep bits at step t as the kernel's threads draw them:
    one Philox4x32-10 call of counter (j/4, b, t, l) for units j .. j + 3."""
    j4 = torch.arange(H // 4)
    b = torch.arange(B)[:, None]
    words = torch.stack(rb.philox4x32(j4[None] + 0 * b, b + 0 * j4, torch.full_like(b + j4, t),
                                      torch.full_like(b + j4, l), seed), dim=-1)
    return (words < rb.threshold(keep)).reshape(B, H).to(f32)


TILE = 2            # rows of a warpgroup's tile at the test size (64 on the card)


def _walk(dout_top, w_h, w_x_rest, mask, gates, cseq, c0, dhn, dcn, outs, seed=None,
          keep=1.0, scale=1.0, window=0, tile=TILE, keep_carries=True):
    """The reverse diagonal as the persistent kernel's host loop runs it:
    windows of ``window`` diagonals (0: one window, the unfused pass) and,
    in each, the row groups of ``wavefront_bwd_row_groups(B, tile)`` in
    turn; inside a launch the layers step as their counter waits let them,
    each product a slice's four gate partials summed in the order of q;
    with ``seed`` drop mode 2 (the kernel's Philox bits).  Fused (``window``
    > 0): after each window's launches, the dW_x products of
    ``csrc/dwx_windows.cuh`` over all rows, from the ring (mode 2) or outs
    (mode 0).  ``keep_carries`` False leaves the carries behind at a
    window's end (the kernel's planted fault).  Returns (dgates, dh0, dc0)
    and xdrop (mode 2, unfused) or dwx (fused)."""
    L, T, B, G = gates.shape
    H = G // 4
    S = -(-H // NU)
    gates = gates.clone()
    wh = [[[_cta_block(w_h[l].to(f32), u, q) for q in range(SPLIT)] for u in range(S)]
          for l in range(L)]
    wx = [[[_cta_block(w_x_rest[l].to(f32), u, q) for q in range(SPLIT)] for u in range(S)]
          for l in range(L - 1)]
    n_diag = T + L - 1
    step = window or n_diag
    fused = window > 0
    xdrop = torch.zeros((L - 1, window if fused else T, B, H), dtype=bf16) if seed else None
    dwx = torch.zeros((L - 1, H, G)) if fused else None
    dhc, dcc = dhn.to(f32).clone(), dcn.to(f32).clone()     # the carries between launches
    launches = twave.wavefront_bwd_row_groups(B, tile)
    written = torch.zeros((len(launches), L, T), dtype=torch.bool)   # a group's dgates(l, t)
    published = [[0] * L for _ in launches]                 # each row group's layer counters

    def slice_sums(a, w):
        """(rows, H) sums of each slice's four partials in the order of q."""
        out = torch.zeros((a.shape[0], S * NU))
        for u in range(S):
            acc = torch.zeros((a.shape[0], NU))
            for q in range(SPLIT):
                acc = acc + a[:, q * H: (q + 1) * H].to(f32) @ w[u][q].t()
            out[:, NU * u: NU * (u + 1)] = acc
        return out[:, :H]

    for s0 in range(0, n_diag, step):
        s1 = min(s0 + step, n_diag) - 1
        d1 = n_diag if s1 == n_diag - 1 else s1
        for g, (r0, n, _) in enumerate(launches):
            rows = slice(r0, r0 + n)
            done, wrote = published[g], written[g]
            lo = [max(0, s0 - (L - 1 - l)) for l in range(L)]
            hi = [min(T, d1 - (L - 1 - l)) for l in range(L)]
            nxt = list(lo)
            dh, dc = dhc[:, rows].clone(), dcc[:, rows].clone()

            def ready(l):
                s = nxt[l]
                return s <= hi[l] and (l + 1 == L or s == T or done[l + 1] >= s + 1)

            while any(nxt[l] <= hi[l] for l in range(L)):
                l = next(l for l in reversed(range(L)) if ready(l))
                s, t = nxt[l], T - 1 - nxt[l]
                assert s == 0 or done[l] >= s               # the carry's wait
                ph = torch.zeros((n, H))
                if s > 0:
                    assert bool(wrote[l, t + 1])
                    ph = slice_sums(gates[l, t + 1, rows], wh[l])
                if s == T:
                    dhc[l, rows], dcc[l, rows] = dh[l] + ph, dc[l]
                    nxt[l] += 1
                    continue
                if l + 1 < L:
                    assert bool(wrote[l + 1, t])
                    ks = torch.ones((n, H))
                    if seed is not None:
                        ks = _kernel_keeps(seed, keep, l, t, B, H)[rows] * scale
                        slot = window - 1 - (s + L - 1 - l) % window if fused else t
                        xdrop[l, slot, rows] = (outs[l, t, rows].to(f32) * ks).to(bf16)
                    dout = slice_sums(gates[l + 1, t, rows], wx[l]) * ks
                else:
                    dout = dout_top[t, rows].to(f32)
                i_a, g_a, f_a, o_a = gates[l, t, rows].to(f32).split(H, dim=-1)
                m = mask[t, 0, rows][:, None]
                tanh_c = torch.tanh(cseq[l, t, rows].to(f32))
                c_prev = cseq[l, t - 1, rows].to(f32) if t > 0 else c0[l, rows].to(f32)
                dh_carry = dh[l] + ph
                dh_new = m * (dout + dh_carry)
                do_pre = dh_new * tanh_c * o_a * (1 - o_a)
                dc_new = dh_new * o_a * (1 - tanh_c * tanh_c) + m * dc[l]
                dgt = torch.cat([dc_new * g_a * i_a * (1 - i_a), dc_new * i_a * (1 - g_a * g_a),
                                 dc_new * c_prev * f_a * (1 - f_a), do_pre], dim=-1)
                gates[l, t, rows] = dgt.to(bf16)
                wrote[l, t] = True
                dh[l] = (1 - m) * dh_carry
                dc[l] = (1 - m) * dc[l] + dc_new * f_a
                nxt[l] += 1
                done[l] = s + 1
            for l in range(L):                              # the window ends before pass T
                if lo[l] <= hi[l] and hi[l] < T and keep_carries:
                    dhc[l, rows], dcc[l, rows] = dh[l], dc[l]
        if fused:                                           # the window's products
            for l in range(L - 1):
                off = L - 1 - l
                t_lo, t_hi = max(0, T - 1 - s1 + off), min(T - 1, T - 1 - s0 + off)
                if t_lo > t_hi:
                    continue
                slot = t_lo - (T - window + off - s0)
                a = (outs[l, t_lo: t_hi + 1] if seed is None
                     else xdrop[l, slot: slot + t_hi - t_lo + 1])
                dg = gates[l + 1, t_lo: t_hi + 1]
                dwx[l] += a.to(f32).reshape(-1, H).t() @ dg.to(f32).reshape(-1, G)
    res = (gates, dhc, dcc)
    if fused:
        return res + (dwx,)
    return res if xdrop is None else res + (xdrop,)


L, T, B, W = 3, 20, 5, 8
KP, SEED = 0.4, (4321, 56789)


def _problem(H, seed):
    """Inputs of the reverse diagonal: the residuals of the port's plain
    training forward (drop mode 0) on xavier-uniform weights, cotangents."""
    rng = np.random.default_rng(seed)
    lim = (6.0 / (H + 4 * H)) ** 0.5
    w = lambda *s: torch.tensor(rng.uniform(-lim, lim, s).astype(np.float32)).to(bf16)
    f = lambda *s, scale: torch.tensor(rng.normal(0, scale, s).astype(np.float32))
    lens = np.asarray([T, 13, 0, 17, T], np.int32)
    mask = torch.tensor((np.arange(T)[:, None] < lens[None]).astype(np.float32)[:, None, :])
    w_h, w_x_rest = w(L, H, 4 * H), w(L - 1, H, 4 * H)
    h0, c0 = f(L, B, H, scale=0.3), f(L, B, H, scale=0.3)
    outs, gates, cseq, _, _ = twave.wavefront_train_plain(
        f(T, B, H, scale=1.0).to(bf16), w(H, 4 * H), w_h, w_x_rest, f(L, 4 * H, scale=0.1), mask,
        h0, c0, bf16)
    return [f(T, B, H, scale=0.5).to(bf16), w_h, w_x_rest, mask, gates, cseq, c0,
            f(L, B, H, scale=0.1), f(L, B, H, scale=0.1), outs]


def _jax_fused_dwx(args, monkeypatch):
    """dW_x of the JAX fused route in drop mode 0: ``_wavefront_bwd`` with
    RST_WAVEFRONT_FUSE_DWX=1, its Pallas kernel in TPU interpret mode."""
    monkeypatch.setenv("RST_WAVEFRONT_FUSE_DWX", "1")
    dout_top, w_h, w_x_rest, mask, gates, cseq, c0, dhn, dcn, outs = args
    j = lambda a: jnp.asarray(a.float().numpy(), jnp.bfloat16 if a.dtype == bf16 else None)
    with pltpu.force_tpu_interpret_mode():
        _, _, dwx, _, _ = jwave._wavefront_bwd(
            j(dout_top), j(w_h), j(w_x_rest), 0, None, 1.0, 1.0, j(mask),
            [j(gates[l]) for l in range(L)], [j(cseq[l]) for l in range(L)],
            [j(outs[l]) for l in range(L)], j(c0), j(dhn), j(dcn))
    assert dwx is not None
    return np.asarray(jnp.asarray(dwx, jnp.float32))


@pytest.mark.parametrize("mode", [0, 2])
@pytest.mark.parametrize("H", [64, 128])
def test_windowed_walk_matches_the_unfused_pass_and_the_fused_routes(H, mode, monkeypatch):
    args = _problem(H, 70 + H + mode)
    drop = dict(seed=SEED, keep=KP, scale=1.0 / KP) if mode else {}
    assert twave.wavefront_bwd_plan(B, H, L, True)["kernel"] == "persistent"
    assert len(twave.wavefront_bwd_row_groups(B, TILE)) == 2
    fused = _walk(*args, window=W, **drop)
    unfused = _walk(*args, **drop)
    assert len(fused) == 4 and fused[3].shape == (L - 1, H, 4 * H)
    assert len(unfused) == (4 if mode else 3)
    for a, b in zip(fused[:3], unfused[:3]):
        assert torch.equal(a, b)
    # The zero-length row: zero dgates, its carries pass through.
    assert not fused[0][:, :, 2].any()
    assert torch.equal(fused[1][:, 2], args[7][:, 2]) and torch.equal(fused[2][:, 2], args[8][:, 2])
    plain = twave.wavefront_bwd_plain(*args[:4], args[4].clone(), *args[5:],
                                      *((2, SEED, 1.0 / KP, KP) if mode else ()), fuse_dwx=True)
    np.testing.assert_allclose(fused[3].numpy(), plain[3].numpy(), **FUSED)
    for got, want in zip(fused[:3], plain[:3]):
        np.testing.assert_allclose(got.float().numpy(), want.float().numpy(), **FUSED)
    if mode == 0:
        np.testing.assert_allclose(fused[3].numpy(), _jax_fused_dwx(args, monkeypatch), **FUSED)
    else:                     # the ring holds what the unfused pass streams, window by window
        x_in = unfused[3]
        want = torch.stack([x_in[l].to(f32).reshape(-1, H).t()
                            @ unfused[0][l + 1].to(f32).reshape(-1, 4 * H) for l in range(L - 1)])
        np.testing.assert_allclose(fused[3].numpy(), want.numpy(), rtol=1e-5, atol=1e-5)


def test_carries_left_behind_at_a_window_end_change_the_pass():
    """The planted fault of the card's checks (``skip_carries``): launches
    that do not hand their f32 carries to the next window restart each
    window from dhn, dcn.  The first window's steps (t >= T - W + L - 1 in
    every layer) stay; the top layer's later steps move."""
    args = _problem(64, 91)
    good = _walk(*args, window=W)
    stale = _walk(*args, window=W, keep_carries=False)
    first = T - W + L - 1
    assert torch.equal(good[0][:, first:], stale[0][:, first:])
    assert not torch.equal(good[0][-1, :T - W], stale[0][-1, :T - W])
