"""The persistent lean forward's plan and layout (``ops/lstm_recurrence.py``:
``lean_plan``, ``lean_column_order``, ``lean_weights``), on the CPU.  The
kernel (``csrc/lstm_layer_lean.cu``) runs only on the card; what decides
its grid, its shared memory and the order of W_h's columns is Python,
tested here.

The layout against the JAX package: a forward that reads its gates the
kernel's way (W_h's columns in the kernel's order, the gate blocks read back
per CTA tile) against ``_lstm_recurrence_train_lean`` in TPU interpret mode
at H=128 in bf16.  Both round the same operands to bf16 and sum in float32
in another order; where two sums straddle a bf16 rounding of h the result
moves by one step (2^-8 relative) and propagates: 4e-3 relative and
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
from rnn_speech_tpu_torch.ops import lstm_recurrence as rec

SMEM_OPT_IN = 232448          # bytes of shared memory a block may use on the H100
BF16 = dict(rtol=4e-3, atol=4e-3)


@pytest.mark.parametrize("H", [128, 1024])
@pytest.mark.parametrize("B", [1, 17, 64, 400, 473])
def test_plan_takes_the_persistent_kernel_and_fits(B, H):
    """Both path shapes (B=400 and 473 at H=1024) and the small ones go to
    the persistent kernel on the H100's 132 SMs: the grid fits one CTA an
    SM, the row groups cover the batch, and the resident W_h slice and the
    h ring fit the shared memory; the same plan comes back on every call."""
    plan = rec.lean_plan(B, H)
    assert plan["kernel"] == "persistent"
    assert plan["slices"] == H // 16 and plan["grid"] == plan["groups"] * plan["slices"]
    assert plan["grid"] <= rec.H100_SMS
    assert 1 <= plan["tiles"] <= 4 and 2 <= plan["stages"] <= rec.LEAN_MAX_STAGES
    assert plan["rows"] == plan["groups"] * plan["tiles"] * 64 >= B
    assert plan["rows"] - B < plan["groups"] * 64            # no row group left empty
    assert plan["smem"] == rec.lean_smem(H, plan["tiles"], plan["stages"]) <= SMEM_OPT_IN
    assert rec.lean_smem(H, plan["tiles"], plan["stages"] + 1) > SMEM_OPT_IN or \
        plan["stages"] == rec.LEAN_MAX_STAGES
    assert all(rec.lean_plan(B, H) == plan for _ in range(3))
    assert rec.lean_plan(B, H, sms=rec.H100_SMS) == plan


def test_flagship_path_shapes_use_two_row_groups_of_four_tiles():
    for B in (400, 473):
        plan = rec.lean_plan(B, 1024)
        assert (plan["groups"], plan["tiles"], plan["grid"], plan["stages"]) == (2, 4, 128, 3)


@pytest.mark.parametrize("B,H,sms", [(513, 1024, 132), (400, 1024, 114), (64, 96, 132),
                                     (64, 2176, 132), (0, 1024, 132)])
def test_plan_sends_what_the_persistent_kernel_cannot_take_to_the_per_step_kernel(B, H, sms):
    """A grid larger than the card, H not a multiple of 64, or no batch."""
    assert rec.lean_plan(B, H, sms) == {"kernel": "per_step"}


@pytest.mark.parametrize("H", [64, 128, 1024])
def test_column_order_is_a_permutation_with_each_ctas_slice_contiguous(H):
    perm = rec.lean_column_order(H)
    inv = torch.argsort(perm)
    assert torch.equal(perm[inv], torch.arange(4 * H))
    assert torch.equal(inv[perm], torch.arange(4 * H))
    for u in range(H // 16):
        want = [g * H + 16 * u + v for g in range(4) for v in range(16)]
        assert perm[64 * u:64 * u + 64].tolist() == want


def _tile_gates(pre, H):
    """Gate pre-activations (..., 4H) in the kernel's column order, read
    back per gate as its tiles hold them: (i, g, f, o), each (..., H) in
    hidden-unit order (CTA u, gate g, unit v -> column 64u + 16g + v)."""
    t = pre.reshape(*pre.shape[:-1], H // 16, 4, 16)
    return tuple(t[..., g, :].reshape(*pre.shape[:-1], H) for g in range(4))


def test_weights_and_tile_gates_undo_each_other():
    """``lean_weights`` puts CTA u's 64 columns in rows 64u .. 64u + 63 of a
    (4H, H) array; reading a product in that order per tile gives back the
    (i, g, f, o) blocks, exactly (integer-valued data)."""
    H = 128
    g = torch.Generator().manual_seed(0)
    w = torch.randint(-4, 5, (H, 4 * H), generator=g).float()
    h = torch.randint(-4, 5, (3, H), generator=g).float()
    wp = rec.lean_weights(w)
    assert wp.shape == (4 * H, H) and wp.is_contiguous()
    assert torch.equal(wp, w.t()[rec.lean_column_order(H)])
    for got, want in zip(_tile_gates(h @ wp.t(), H), (h @ w).split(H, dim=-1)):
        assert torch.equal(got, want)


def _lean_forward_in_kernel_order(x_proj, w_h, mask, h0, c0):
    """``recurrence_train_lean_plain`` with its operands in the kernel's
    column order (x_proj and W_h permuted) and each step's gates read back
    per CTA tile (``_tile_gates``)."""
    T, B, four_h = x_proj.shape
    H = four_h // 4
    perm = rec.lean_column_order(H)
    xp, wp = x_proj[..., perm], rec.lean_weights(w_h).to(torch.float32).t()
    h, c = h0.clone(), c0.clone()
    out = torch.zeros((T, B, H))
    cseq = torch.empty((T, B, H), dtype=torch.bfloat16)
    for t in range(T):
        pre = xp[t].float() + h.to(torch.bfloat16).float() @ wp
        i, g, f, o = _tile_gates(pre, H)
        i, g, f, o = torch.sigmoid(i), torch.tanh(g), torch.sigmoid(f + 1.0), torch.sigmoid(o)
        c_new = f * c + i * g
        h_new = o * torch.tanh(c_new)
        m = mask[t, 0][:, None]
        c = m * c_new + (1 - m) * c
        h = m * h_new + (1 - m) * h
        out[t] = m * h_new
        cseq[t] = c
    return out, h, c, cseq


@pytest.mark.parametrize("seed", [0, 1])
def test_kernel_order_forward_matches_jax_lean_recurrence(seed):
    T, B, H = 7, 5, 128
    rng = np.random.default_rng(seed)
    f = lambda *s, scale: rng.normal(0, scale, s).astype(np.float32)
    lens = np.asarray([7, 4, 0, 6, 1], np.int32)
    mask = (np.arange(T)[:, None] < lens[None]).astype(np.float32)[:, None, :]
    xp = jnp.asarray(f(T, B, 4 * H, scale=1.0), jnp.bfloat16)
    w_h = jnp.asarray(f(H, 4 * H, scale=0.1), jnp.bfloat16)
    h0, c0 = f(B, H, scale=0.3), f(B, H, scale=0.3)
    with pltpu.force_tpu_interpret_mode():
        ref = jax.jit(jpal._lstm_recurrence_train_lean, static_argnums=5)(
            xp, w_h, mask, h0, c0, jnp.bfloat16)
    bf = lambda a: torch.tensor(np.asarray(a.astype(jnp.float32))).to(torch.bfloat16)
    args = (bf(xp), bf(w_h), torch.tensor(mask), torch.tensor(h0), torch.tensor(c0))
    got = _lean_forward_in_kernel_order(*args)
    plain = tlt.recurrence_train_lean_plain(*args, torch.bfloat16)
    for r, g_, p in zip(ref, got, plain):
        r = np.asarray(r.astype(jnp.float32))
        np.testing.assert_allclose(g_.float().numpy(), r, **BF16)
        np.testing.assert_allclose(p.float().numpy(), r, **BF16)
    assert not got[0][:, 2].any() and torch.equal(got[1][2], args[3][2])
