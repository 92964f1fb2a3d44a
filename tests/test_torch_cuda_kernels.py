"""The hand-written CUDA kernels against their plain PyTorch versions on
the card, at small ragged shapes the checks in ``chip_smoke.py`` do not
reach: batch sizes that fill a 64-row tile partly or spill into a third
one, T shorter than the stack depth, zero-length rows, T = 0, and
weight-gradient shapes with ragged D, G and N edges; the layered training
route's four kernels and its stack options (wavefront off, recompute,
remat, time_chunk) on the card against their plain versions; the Bernoulli
mask kernel, the alpha-stream CTC pair and the fbank kernel (an FFT), with the
routes that launch them (the layered stack backward, the alpha-stream CTC
backward, the fbank frontend); the reverse diagonal's fused dW_x over
several accumulation windows; the recompute backward's rebuild product
alone and the recompute backward at the edges of its chunks; the
persistent recompute-mode forward at B=1 to 473 (and without its step
barrier, a planted fault that must fail) and the per-step one past its
plan; the persistent gates-mode backward (row 6) and the inference
recurrence on the persistent forward (row 2) at the layered step's and the
serving batches and small ones, bit for bit on repeat, without their step
barriers (planted faults), and the per-step kernels past their plans; the
redesigned CTC backward bit for bit on repeat; the persistent gates-mode
forward (row 5) and the persistent wavefront training forward (row 3, in
drop modes 0, 1 and 2) at the default steps' batch and small ragged ones,
bit for bit on repeat, without their waits (planted faults), and the
per-step and per-diagonal kernels they replace there, launched past the
plans; likewise the persistent wavefront inference forward (row 1: one
and two row groups) and the persistent reverse diagonal (row 4, in drop
modes 0, 1 and 2), and the per-diagonal kernels past their plans.

Every test carries the ``cuda`` marker and takes the ``cuda`` fixture,
which skips it, with the reason, where no NVIDIA GPU is present.  On a
machine with a GPU and ``nvcc`` (no JAX needed there; ``--noconftest``
keeps the JAX set-up of ``tests/conftest.py`` out) run, from the
repository root:

    python -m pytest --noconftest -q tests/test_torch_cuda_kernels.py

Tolerances: kernel and plain version round the same operands to bf16 and
sum in float32; only the summation order differs, which now and then
flips one bf16 rounding (a 2^-8 relative step) and then propagates.  The
inference kernels' float32 outputs stay below 2e-3 over these short
runs; the training kernels' bf16 residuals and dgates may differ by such
a flip of values of magnitude <= 2, hence 1e-2 there; the weight
gradients sum up to ~5000 rows of magnitude-1 products, 1e-4 relative
plus 1e-3 absolute.  The dropout kernel draws the plain version's bits
and rounds as it does: equal bit for bit.  The CTC kernels run the plain
versions' float32 recursion with other exp/log roundings: 1e-4; the
alpha stream repeats the checkpoint kernel's rows bit for bit.  The mask
kernel draws its plain version's bits: equal bit for bit.  The fbank
kernel (an FFT) sums float32 products in another order than the plain
version's DFT and mel matmuls: 2e-3 of the largest magnitude, the JAX
package's limit for its own kernel.  The persistent recompute-mode forward
and gates-mode backward keep the per-step kernels' tolerances, relative to
each output's largest magnitude: 8e-3 at T=16, 1.2e-2 longer; the
inference recurrence on the persistent forward keeps 2e-3; the persistent
gates-mode and wavefront training forwards keep 8e-3 and 1.2e-2 of each
output's largest magnitude, with xavier-uniform weights.  The redesigned CTC backward sums
the same posteriors in another fixed order: 1e-5.  The rebuild product sums the same bf16
products in float32 in another order than its plain version: 1e-5
relative Frobenius, and equal bit for bit on repeat.  The
fused dW_x sums T·B products of those bf16 dgates: 1e-2 of each
boundary's own largest magnitude, a bound that one accumulation window
left out fails; the fused pass's dgates, dh0 and dc0 equal the same per-diagonal
kernel's unfused pass's bit for bit.  The persistent wavefront inference
forward (row 1) keeps 2e-3 absolute on its float32 outputs; the
persistent reverse diagonal (row 4) keeps the training kernels' 8e-3 and
1.2e-2 of each output's largest magnitude, with xavier-uniform weights.
"""

import pytest
import torch

from rnn_speech_tpu_torch.ops import ctc_kernel as tck
from rnn_speech_tpu_torch.ops import dropout as tdrop
from rnn_speech_tpu_torch.ops import grad_matmul as tgm
from rnn_speech_tpu_torch.ops import lstm as tlstm
from rnn_speech_tpu_torch.ops import lstm_layer_train as tlt
from rnn_speech_tpu_torch.ops import lstm_recurrence as trec
from rnn_speech_tpu_torch.ops import lstm_wavefront as twave

TOL = 2e-3
TRAIN_TOL = 1e-2
GRAD_TOL = dict(rtol=1e-4, atol=1e-3)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    assert torch.backends.cuda.matmul.allow_tf32 is False
    return torch.device("cuda")


def _lengths(T, B):
    """Ragged lengths with a zero-length row and a full-length row."""
    lens = [T - (7 * b) % (T + 1) for b in range(B)]
    lens[0] = T
    if B > 2:
        lens[2] = 0
    return torch.as_tensor(lens)


def _inputs(L, T, B, H, seed, dev):
    g = torch.Generator().manual_seed(seed)
    r = lambda *s, scale: (torch.randn(s, generator=g) * scale)
    lens = _lengths(T, B)
    mask = (torch.arange(T)[:, None] < lens[None]).float()[:, None, :]
    return dict(
        xp0=r(T, B, 4 * H, scale=0.5).to(dev),
        w_h=r(L, H, 4 * H, scale=0.1).to(dev, torch.bfloat16),
        w_x_rest=r(L - 1, H, 4 * H, scale=0.1).to(dev, torch.bfloat16),
        b_rest=r(L - 1, 1, 4 * H, scale=0.1).to(dev),
        mask=mask.to(dev),
        h0=r(L, B, H, scale=0.2).to(dev),
        c0=r(L, B, H, scale=0.2).to(dev),
    )


def _close(got, ref):
    for g, r in zip(got, ref):
        assert g.shape == r.shape and g.dtype == r.dtype == torch.float32
        assert bool(torch.isfinite(g).all())
        if g.numel():
            assert float((g - r).abs().max()) <= TOL


@pytest.mark.parametrize("B,H,T", [(1, 64, 7), (17, 64, 9), (70, 128, 12),
                                   (130, 256, 5), (4, 64, 1)])
def test_recurrence_kernel_matches_plain(cuda, B, H, T):
    x = _inputs(1, T, B, H, seed=B + H + T, dev=cuda)
    args = (x["xp0"], x["w_h"][0], x["mask"], x["h0"][0], x["c0"][0])
    got = trec.lstm_recurrence(*args)
    ref = trec.lstm_recurrence_plain(*args)
    torch.cuda.synchronize()
    _close(got, ref)


@pytest.mark.parametrize("L,B,H,T", [(2, 3, 64, 7), (3, 70, 128, 10),
                                     (4, 17, 64, 3), (2, 130, 64, 1)])
def test_wavefront_kernel_matches_plain(cuda, L, B, H, T):
    x = _inputs(L, T, B, H, seed=L + B + H + T, dev=cuda)
    args = (x["xp0"], x["w_h"], x["w_x_rest"], x["b_rest"], x["mask"],
            x["h0"], x["c0"])
    got = twave.lstm_stack_wavefront(*args)
    ref = twave.lstm_stack_wavefront_plain(*args)
    torch.cuda.synchronize()
    _close(got, ref)


@pytest.mark.parametrize("wavefront", [False, True])
def test_stack_through_kernels_matches_scan_on_card(cuda, wavefront):
    """The stack's kernel dispatch against the plain time loop, both on the
    card in bf16, from the layered calling shape (x, lengths, states)."""
    L, T, B, D, H = 3, 9, 5, 40, 64
    g = torch.Generator().manual_seed(3)
    layers = tlstm.init_lstm_stack(g, L, D, H, cuda)
    for p in layers:
        p["b"] = (torch.randn(p["b"].shape, generator=g) * 0.1).to(cuda)
    x = torch.randn((T, B, D), generator=g).to(cuda)
    lens = _lengths(T, B).to(cuda)
    states = [((torch.randn((B, H), generator=g) * 0.2).to(cuda),
               (torch.randn((B, H), generator=g) * 0.2).to(cuda))
              for _ in range(L)]
    kw = dict(compute_dtype=torch.bfloat16)
    got, got_states = tlstm.lstm_stack(layers, x, lens, states, use_kernels=True,
                                       wavefront=wavefront, **kw)
    ref, ref_states = tlstm.lstm_stack(layers, x, lens, states, **kw)
    torch.cuda.synchronize()
    _close([got], [ref])
    for (gc, gh), (rc, rh) in zip(got_states, ref_states):
        _close([gc, gh], [rc, rh])


def test_empty_sequence_returns_initial_state(cuda):
    x = _inputs(2, 0, 3, 64, seed=1, dev=cuda)
    out, hn, cn = twave.lstm_stack_wavefront(
        x["xp0"], x["w_h"], x["w_x_rest"], x["b_rest"], x["mask"], x["h0"], x["c0"])
    assert out.shape == (0, 3, 64)
    assert torch.equal(hn, x["h0"]) and torch.equal(cn, x["c0"])


def test_launch_counters_count_kernel_calls(cuda):
    x = _inputs(2, 4, 3, 64, seed=2, dev=cuda)
    trec.lstm_recurrence.launches = 0
    twave.lstm_stack_wavefront.launches = 0
    trec.lstm_recurrence(x["xp0"], x["w_h"][0], x["mask"], x["h0"][0], x["c0"][0])
    twave.lstm_stack_wavefront(x["xp0"], x["w_h"], x["w_x_rest"], x["b_rest"],
                               x["mask"], x["h0"], x["c0"])
    trec.lstm_recurrence_plain(x["xp0"], x["w_h"][0], x["mask"], x["h0"][0],
                               x["c0"][0])
    assert (trec.lstm_recurrence.launches, twave.lstm_stack_wavefront.launches) == (1, 1)


def test_wrappers_reject_what_the_kernels_do_not_take(cuda):
    """A CUDA tensor the kernel cannot take raises; it never falls back to
    the plain version."""
    x = _inputs(1, 4, 3, 64, seed=4, dev=cuda)
    good = dict(x_proj=x["xp0"], w_h=x["w_h"][0], mask=x["mask"],
                h0=x["h0"][0], c0=x["c0"][0])
    bad = [
        (TypeError, dict(w_h=good["w_h"].float())),
        (ValueError, dict(h0=good["h0"].t().contiguous().t())),
        (ValueError, dict(mask=good["mask"].cpu())),
    ]
    for exc, change in bad:
        with pytest.raises(exc):
            trec.lstm_recurrence(**{**good, **change})
    y = _inputs(1, 4, 3, 32, seed=5, dev=cuda)
    with pytest.raises(ValueError, match="H % 64"):
        trec.lstm_recurrence(y["xp0"], y["w_h"][0], y["mask"], y["h0"][0],
                             y["c0"][0])


# ------------------------------------------------------------- training


def _train_inputs(L, T, B, H, D, seed, dev):
    g = torch.Generator().manual_seed(seed)
    r = lambda *s, scale: (torch.randn(s, generator=g) * scale)
    lens = _lengths(T, B)
    mask = (torch.arange(T)[:, None] < lens[None]).float()[:, None, :]
    bf = torch.bfloat16
    return dict(
        x=r(T, B, D, scale=1.0).to(dev, bf),
        w_x0=r(D, 4 * H, scale=0.1).to(dev, bf),
        w_h=r(L, H, 4 * H, scale=0.1).to(dev, bf),
        w_x_rest=r(L - 1, H, 4 * H, scale=0.1).to(dev, bf),
        b_all=r(L, 4 * H, scale=0.1).to(dev),
        mask=mask.to(dev),
        h0=r(L, B, H, scale=0.2).to(dev),
        c0=r(L, B, H, scale=0.2).to(dev),
    )


def _close_to(got, ref, tol):
    for g, r in zip(got, ref):
        assert g.shape == r.shape and g.dtype == r.dtype
        assert bool(torch.isfinite(g).all())
        if g.numel():
            assert float((g.float() - r.float()).abs().max()) <= tol


@pytest.mark.parametrize("L,B,H,D,T", [(2, 3, 64, 64, 7), (3, 70, 128, 128, 10),
                                       (2, 17, 64, 128, 3), (3, 5, 64, 64, 1)])
def test_wavefront_train_kernel_matches_plain(cuda, L, B, H, D, T):
    x = _train_inputs(L, T, B, H, D, seed=L + B + H + T, dev=cuda)
    args = [x[k] for k in ("x", "w_x0", "w_h", "w_x_rest", "b_all", "mask", "h0", "c0")]
    got = twave.wavefront_train(*args, torch.bfloat16)
    ref = twave.wavefront_train_plain(*args, torch.bfloat16)
    torch.cuda.synchronize()
    _close_to(got, ref, TRAIN_TOL)


def _bwd_inputs(L, T, B, H, seed, dev):
    """Residuals from the plain training forward, plus cotangents."""
    x = _train_inputs(L, T, B, H, H, seed, dev)
    outs, gates, cseq, _, _ = twave.wavefront_train_plain(
        *[x[k] for k in ("x", "w_x0", "w_h", "w_x_rest", "b_all", "mask", "h0", "c0")],
        torch.bfloat16)
    g = torch.Generator().manual_seed(seed + 1)
    r = lambda *s: torch.randn(s, generator=g).to(dev)
    return dict(dout_top=r(T, B, H).to(torch.bfloat16), w_h=x["w_h"],
                w_x_rest=x["w_x_rest"], mask=x["mask"], gates=gates, cseq=cseq,
                c0=x["c0"], dhn=r(L, B, H) * 0.5, dcn=r(L, B, H) * 0.5)


@pytest.mark.parametrize("L,B,H,T", [(2, 3, 64, 7), (3, 70, 128, 10),
                                     (4, 17, 64, 3), (2, 5, 64, 1)])
def test_wavefront_bwd_kernel_matches_plain(cuda, L, B, H, T):
    x = _bwd_inputs(L, T, B, H, seed=L + B + H + T, dev=cuda)
    names = ("dout_top", "w_h", "w_x_rest", "mask", "gates", "cseq", "c0", "dhn", "dcn")
    ref = twave.wavefront_bwd_plain(*[x[k].clone() for k in names])
    got = twave.wavefront_bwd(*[x[k] for k in names])
    torch.cuda.synchronize()
    assert got[0].data_ptr() == x["gates"].data_ptr()   # dgates in place
    _close_to(got, ref, TRAIN_TOL)


@pytest.mark.parametrize("dg_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("N,H,D,G", [(21, 64, 120, 256), (5000, 64, 120, 80),
                                     (333, 200, 24, 1030)])
def test_grad_matmul_kernels_match_plain(cuda, dg_dtype, N, H, D, G):
    g = torch.Generator().manual_seed(N + G)
    h, x, dg = (torch.randn(s, generator=g).to(cuda)
                for s in ((N, H), (N, D), (N, G)))
    dg = dg.to(dg_dtype)
    got = tgm.dgates_weight_grads(h, x, dg)
    ref = tgm.dgates_weight_grads_plain(h, x, dg)
    got1 = tgm.weight_grad(x, dg)
    ref1 = tgm.weight_grad_plain(x, dg)
    torch.cuda.synchronize()
    for a, b in zip(got + got1, ref + ref1):
        assert a.shape == b.shape and a.dtype == torch.float32
        torch.testing.assert_close(a, b, **GRAD_TOL)
    again = tgm.weight_grad(x, dg)
    assert all(torch.equal(a, b) for a, b in zip(again, got1))   # bit for bit


@pytest.mark.parametrize("two", [False, True], ids=["one operand", "two operands"])
@pytest.mark.parametrize("N,D,G", [(1, 128, 256), (333, 128, 4096), (4999, 1024, 256),
                                   (2085, 1024, 4096), (64, 128, 256)])
def test_hopper_weight_grad_tile_matches_plain(cuda, two, N, D, G):
    """The Hopper tile (TMA + wgmma; the plan picks it for bf16 dg, widths
    that are multiples of 64 and G of 256) against the plain versions at
    ragged N (the K tail TMA fills with zeros, split K at N=4999),
    bit for bit on repeat; the wrapper counts it."""
    g = torch.Generator().manual_seed(N + D + G)
    h, x, dg = (torch.randn(s, generator=g).to(cuda, torch.bfloat16)
                for s in ((N, D), (N, 64 if two else D), (N, G)))
    dims = [D, 64] if two else [D]
    assert tgm.product_path(dims, G, torch.bfloat16) == "wgmma"
    counted = tgm.dgates_weight_grads if two else tgm.weight_grad
    counted.launches = counted.wgmma_launches = 0
    if two:
        run = lambda: tgm.dgates_weight_grads(h, x, dg)
        ref = tgm.dgates_weight_grads_plain(h, x, dg)
    else:
        run = lambda: tgm.weight_grad(h, dg)
        ref = tgm.weight_grad_plain(h, dg)
    got, again = run(), run()
    torch.cuda.synchronize()
    for a, b in zip(got, ref):
        assert a.shape == b.shape and a.dtype == torch.float32
        torch.testing.assert_close(a, b, **GRAD_TOL)
    assert all(torch.equal(a, b) for a, b in zip(got, again))   # bit for bit
    assert counted.wgmma_launches == counted.launches == 2


def test_train_stack_through_kernels_matches_plain_versions_on_card(cuda):
    """The differentiable stack on the card (both training kernels and the
    weight-gradient kernel) against the same Function's plain versions on
    the CPU: outputs, final states and every gradient."""
    L, T, B, D, H = 3, 9, 5, 64, 64
    g = torch.Generator().manual_seed(5)
    layers = tlstm.init_lstm_stack(g, L, D, H)
    x = torch.randn((T, B, D), generator=g)
    lens = _lengths(T, B)
    states = [(torch.randn((B, H), generator=g) * 0.2,
               torch.randn((B, H), generator=g) * 0.2) for _ in range(L)]
    cot = torch.randn((T, B, H), generator=g)
    results = []
    for dev in ("cpu", cuda):
        tl = [{k: v.detach().to(dev).requires_grad_(True) for k, v in p.items()}
              for p in layers]
        tx = x.detach().to(dev).requires_grad_(True)
        out, ns = twave.lstm_stack_wavefront_train(
            tl, tx, lens.to(dev), [(c.to(dev), h.to(dev)) for c, h in states],
            compute_dtype=torch.bfloat16)
        loss = (out.float() * cot.to(dev)).sum() + sum(c.sum() + h.sum() for c, h in ns)
        loss.backward()
        results.append([out.float(), *[t for pair in ns for t in pair]]
                       + [p[k].grad for p in tl for k in sorted(p)] + [tx.grad])
    torch.cuda.synchronize()
    for a, b in zip(*results):
        a, b = a.detach(), b.detach().cpu()
        scale = max(1.0, float(a.abs().max()))
        assert float((a - b).abs().max()) <= TRAIN_TOL * scale


def test_training_launch_counters_count_kernel_calls(cuda):
    x = _train_inputs(2, 4, 3, 64, 64, seed=6, dev=cuda)
    for fn in (twave.wavefront_train, twave.wavefront_bwd, tgm.weight_grad,
               tgm.dgates_weight_grads):
        fn.launches = 0
    args = [x[k] for k in ("x", "w_x0", "w_h", "w_x_rest", "b_all", "mask", "h0", "c0")]
    outs, gates, cseq, _, _ = twave.wavefront_train(*args, torch.bfloat16)
    twave.wavefront_bwd(outs[-1], x["w_h"], x["w_x_rest"], x["mask"], gates, cseq,
                        x["c0"], x["h0"], x["c0"])
    tgm.weight_grad(outs[0], outs[1])
    tgm.dgates_weight_grads(outs[0], outs[1], gates[0])
    twave.wavefront_train_plain(*args, torch.bfloat16)
    tgm.weight_grad_plain(outs[0], outs[1])
    assert [fn.launches for fn in (twave.wavefront_train, twave.wavefront_bwd,
                                   tgm.weight_grad, tgm.dgates_weight_grads)] == [1] * 4


# ------------------------------------------- dropout, drop modes and CTC


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,keeps", [((37, 5, 64), [0.8]), ((1001,), [0.5]),
                                         ((3, 7, 130), [0.8, 0.5]), ((2,), [0.4])])
def test_dropout_kernel_matches_plain_bit_for_bit(cuda, dtype, shape, keeps):
    x = torch.randn(shape, generator=torch.Generator().manual_seed(len(shape))).to(
        cuda, dtype)
    got = tdrop.dropout_kernel(x, (123, 456), keeps)
    ref = tdrop.dropout_plain(x, (123, 456), keeps)
    torch.cuda.synchronize()
    assert torch.equal(got, ref)


def _drop(mode, L, T, B, H, seed):
    if mode == 1:
        g = torch.Generator().manual_seed(seed)
        masks = (torch.rand((L - 1, T, B, H), generator=g) < 0.4).float()
        return (1, masks.to("cuda"), 2.5, 1.0)
    return (2, (seed, seed + 7), 2.5, 0.4)


@pytest.mark.parametrize("mode", [1, 2])
@pytest.mark.parametrize("L,B,H,D,T", [(2, 3, 64, 64, 7), (3, 70, 128, 128, 10),
                                       (3, 5, 64, 64, 1)])
def test_wavefront_train_and_bwd_drop_modes_match_plain(cuda, mode, L, B, H, D, T):
    x = _train_inputs(L, T, B, H, D, seed=L + B + T + mode, dev=cuda)
    drop = _drop(mode, L, T, B, H, seed=B + T)
    args = [x[k] for k in ("x", "w_x0", "w_h", "w_x_rest", "b_all", "mask", "h0", "c0")]
    got = twave.wavefront_train(*args, torch.bfloat16, *drop)
    ref = twave.wavefront_train_plain(*args, torch.bfloat16, *drop)
    torch.cuda.synchronize()
    _close_to(got, ref, TRAIN_TOL)
    outs, gates, cseq = ref[:3]
    g = torch.Generator().manual_seed(T)
    dtop = torch.randn((T, B, H), generator=g).to(cuda, torch.bfloat16)
    dhn, dcn = (torch.randn((L, B, H), generator=g).to(cuda) * 0.5 for _ in "hc")
    bwd = lambda fn, gt: fn(dtop, x["w_h"], x["w_x_rest"], x["mask"], gt, cseq, x["c0"],
                            dhn, dcn, outs, *drop)
    ref_b = bwd(twave.wavefront_bwd_plain, gates.clone())
    got_b = bwd(twave.wavefront_bwd, gates.clone())
    torch.cuda.synchronize()
    assert len(got_b) == len(ref_b) == 4
    _close_to(got_b, ref_b, TRAIN_TOL)


def _per_diagonal_bwd(*args):
    """The per-diagonal reverse diagonal (the fused pass's kernel), unfused,
    whatever the plan says: ``wavefront_bwd``'s positional arguments up to
    outs, then the drop mode's four (none: drop mode 0)."""
    mode, arr, scale, keep = args[10:] or (0, None, 1.0, 1.0)
    T, B, H = args[0].shape
    launch = twave._drop_launch_args(mode, arr, keep, scale, (len(args[2]), T, B, H),
                                     args[4].device)
    return twave._bwd_per_diagonal_launch(*args[:10], (mode, *launch))


@pytest.mark.parametrize("mode", [0, 2])
@pytest.mark.parametrize("L,B,H,T", [(3, 5, 64, 10), (2, 17, 128, 7), (3, 70, 64, 3)])
def test_wavefront_bwd_fused_dwx_matches_plain(cuda, mode, L, B, H, T, monkeypatch):
    """The fused pass in windows of 4 diagonals (several windows, a
    ragged last one) against its plain version; its dgates, dh0 and dc0
    bit for bit against the unfused pass's; the fused calls counted."""
    monkeypatch.setattr(twave, "FUSE_DWX_WINDOW", 4)
    x = _train_inputs(L, T, B, H, H, seed=L + B + T + 11 * mode, dev=cuda)
    drop = _drop(2, L, T, B, H, seed=B + T) if mode == 2 else (0, None, 1.0, 1.0)
    args = [x[k] for k in ("x", "w_x0", "w_h", "w_x_rest", "b_all", "mask", "h0", "c0")]
    outs, gates, cseq, _, _ = twave.wavefront_train_plain(*args, torch.bfloat16, *drop)
    g = torch.Generator().manual_seed(T + 1)
    dtop = torch.randn((T, B, H), generator=g).to(cuda, torch.bfloat16)
    dhn, dcn = (torch.randn((L, B, H), generator=g).to(cuda) * 0.5 for _ in "hc")
    bwd = lambda fn, **kw: fn(dtop, x["w_h"], x["w_x_rest"], x["mask"], gates.clone(), cseq,
                              x["c0"], dhn, dcn, outs, *drop, **kw)
    ref = bwd(twave.wavefront_bwd_plain, fuse_dwx=True)
    twave.wavefront_bwd.fused_launches = 0
    got = bwd(twave.wavefront_bwd, fuse_dwx=True)
    unfused = bwd(_per_diagonal_bwd)                 # the same kernel, unfused
    torch.cuda.synchronize()
    assert twave.wavefront_bwd.fused_launches == 1
    assert got[3].shape == (L - 1, H, 4 * H) and got[3].dtype == torch.float32
    _close_to(got[:3], ref[:3], TRAIN_TOL)
    w = min(4, T)
    for l in range(L - 1):
        bound = TRAIN_TOL * float(ref[3][l].abs().max())
        assert float((got[3][l] - ref[3][l]).abs().max()) <= bound
        # A planted fault fails the same bound: in mode 0 the last window's
        # steps left out, in mode 2 keep·scale left out.
        if mode == 0:
            faulty = ref[3][l] - tgm.weight_grad_plain(outs[l, T - w:],
                                                       ref[0][l + 1, T - w:])[0]
        else:
            faulty = tgm.weight_grad_plain(outs[l], ref[0][l + 1])[0]
        assert float((faulty - ref[3][l]).abs().max()) > bound
    assert all(torch.equal(a, b) for a, b in zip(got[:3], unfused[:3]))


@pytest.mark.parametrize("mode", [0, 2])
def test_fused_dwx_windows_on_the_hopper_tile(cuda, mode, monkeypatch):
    """The fused pass at H=128 (the window products take the Hopper tile)
    in windows of 8 diagonals over T + L - 1 = 23 (a ragged last window of
    7), against its plain version; dgates, dh0 and dc0 bit for bit against
    the unfused pass; the window products counted on the Hopper tile; and
    the window products alone (``dwx_windows``, drop mode 0's operands)
    against their plain version."""
    monkeypatch.setattr(twave, "FUSE_DWX_WINDOW", 8)
    L, B, H, T = 3, 9, 128, 21
    assert tgm.product_path([H], 4 * H, torch.bfloat16) == "wgmma"
    x = _train_inputs(L, T, B, H, H, seed=31 + mode, dev=cuda)
    drop = _drop(2, L, T, B, H, seed=B + T) if mode == 2 else (0, None, 1.0, 1.0)
    args = [x[k] for k in ("x", "w_x0", "w_h", "w_x_rest", "b_all", "mask", "h0", "c0")]
    outs, gates, cseq, _, _ = twave.wavefront_train_plain(*args, torch.bfloat16, *drop)
    g = torch.Generator().manual_seed(T + 3)
    dtop = torch.randn((T, B, H), generator=g).to(cuda, torch.bfloat16)
    dhn, dcn = (torch.randn((L, B, H), generator=g).to(cuda) * 0.5 for _ in "hc")
    bwd = lambda fn, **kw: fn(dtop, x["w_h"], x["w_x_rest"], x["mask"], gates.clone(), cseq,
                              x["c0"], dhn, dcn, outs, *drop, **kw)
    ref = bwd(twave.wavefront_bwd_plain, fuse_dwx=True)
    twave.wavefront_bwd.wgmma_products = 0
    got = bwd(twave.wavefront_bwd, fuse_dwx=True)
    unfused = bwd(_per_diagonal_bwd)                 # the same kernel, unfused
    torch.cuda.synchronize()
    assert twave.wavefront_bwd.wgmma_products == 3 * (L - 1)   # 3 windows per boundary
    for l in range(L - 1):
        bound = TRAIN_TOL * float(ref[3][l].abs().max())
        assert float((got[3][l] - ref[3][l]).abs().max()) <= bound
    assert all(torch.equal(a, b) for a, b in zip(got[:3], unfused[:3]))
    alone = twave.dwx_windows(outs, got[0], window=8)
    plain = twave.dwx_windows_plain(outs, got[0])
    torch.cuda.synchronize()
    torch.testing.assert_close(alone, plain, **GRAD_TOL)


def _ctc_inputs(T, B, V, U, seed):
    g = torch.Generator().manual_seed(seed)
    logits = torch.randn((T, B, V), generator=g) * 2
    ll = torch.as_tensor([T - (5 * b) % (T + 1) for b in range(B)])
    ll[0] = T
    ul = torch.as_tensor([(3 * b) % (U + 1) for b in range(B)])
    labels = torch.randint(0, V - 1, (B, U), generator=g)
    labels[torch.arange(U)[None] >= ul[:, None]] = -1
    return logits, ll, labels, ul


@pytest.mark.parametrize("T,B,V,U", [(9, 3, 5, 2), (70, 17, 29, 12), (200, 5, 80, 60)])
def test_ctc_kernels_match_plain(cuda, T, B, V, U):
    """Loss-only and checkpoint recursions, then the fused backward, against
    their plain versions: same float32 recursion, 1e-4 relative."""
    logits, ll, labels, ul = (t.to(cuda) for t in _ctc_inputs(T, B, V, U, T + B))
    log_probs, ext, skip_ok, ll, ul, valid = tck._setup(logits, ll, labels, ul, -1)
    K = tck.ctc_block(ext.shape[1], V)
    ck, last = tck.ctc_alpha_ckpt(log_probs, ext, skip_ok, ll, ul, K)
    ck_p, last_p = tck.alpha_plain(log_probs, ext, skip_ok, ll, ul, K, True)
    last_l = tck.ctc_alpha_lossonly(log_probs, ext, skip_ok, ll, ul)
    logp = tck._loss(last_p, ul, valid)[1]
    lists = tck.label_lists(ext, ul, V)
    post = tck.ctc_beta_post(log_probs, ext, skip_ok, ll, ul, logp, ck_p, K, lists)
    post_p = tck.beta_post_plain(log_probs, ext, skip_ok, ll, ul, logp, ck_p, K)
    again = tck.ctc_beta_post(log_probs, ext, skip_ok, ll, ul, logp, ck_p, K, lists)
    torch.cuda.synchronize()
    assert torch.equal(last, last_l) and torch.equal(post, again)
    for a, b in ((ck, ck_p), (last, last_p), (post, post_p)):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)


def test_new_launch_counters_count_kernel_calls(cuda):
    for fn in (tdrop.dropout_kernel, tck.ctc_alpha_ckpt, tck.ctc_alpha_lossonly,
               tck.ctc_beta_post):
        fn.launches = 0
    logits, ll, labels, ul = (t.to(cuda) for t in _ctc_inputs(12, 4, 6, 3, 1))
    z = logits.clone().requires_grad_(True)
    tck.ctc_loss(z, ll, labels, ul).sum().backward()
    with torch.no_grad():
        tck.ctc_loss(logits, ll, labels, ul)
    tdrop.dropout(z, (1, 2), [0.5]).sum().backward()
    tdrop.dropout_plain(logits, (1, 2), [0.5])
    assert [fn.launches for fn in (tdrop.dropout_kernel, tck.ctc_alpha_ckpt,
                                   tck.ctc_alpha_lossonly, tck.ctc_beta_post)] == [2, 1, 1, 1]


# ------------------------------------------------ the layered training route


def _layer_inputs(T, B, H, D, seed, dev):
    """One layer's kernel inputs: f32 x_proj, bf16 weights and layer input,
    f32 bias, states and cotangents, the (T, 1, B) mask."""
    g = torch.Generator().manual_seed(seed)
    r = lambda *s, scale: torch.randn(s, generator=g) * scale
    lens = _lengths(T, B)
    bf = torch.bfloat16
    return dict(
        x_proj=r(T, B, 4 * H, scale=1.0).to(dev), w_h=r(H, 4 * H, scale=0.1).to(dev, bf),
        w_x=r(D, 4 * H, scale=0.1).to(dev, bf), b=r(4 * H, scale=0.1).to(dev),
        x=r(T, B, D, scale=1.0).to(dev, bf),
        mask=(torch.arange(T)[:, None] < lens[None]).float()[:, None, :].to(dev),
        h0=r(B, H, scale=0.2).to(dev), c0=r(B, H, scale=0.2).to(dev),
        dout=r(T, B, H, scale=1.0).to(dev), dhn=r(B, H, scale=0.5).to(dev),
        dcn=r(B, H, scale=0.5).to(dev))


LAYER_SHAPES = [(3, 64, 64, 7), (70, 128, 128, 10), (17, 64, 128, 3), (5, 64, 64, 1),
                (130, 64, 192, 4)]


@pytest.mark.parametrize("B,H,D,T", LAYER_SHAPES)
def test_layer_train_kernels_match_plain(cuda, B, H, D, T):
    """Both layer training forwards: gates mode (f32 x_proj) and the lean
    recompute mode (bf16 x_proj)."""
    x = _layer_inputs(T, B, H, D, seed=B + H + T, dev=cuda)
    tail = (x["w_h"], x["mask"], x["h0"], x["c0"], torch.bfloat16)
    got = tlt.recurrence_train(x["x_proj"], *tail)
    ref = tlt.recurrence_train_plain(x["x_proj"], *tail)
    xp_bf = x["x_proj"].to(torch.bfloat16)
    got_l = tlt.recurrence_train_lean(xp_bf, *tail)
    ref_l = tlt.recurrence_train_lean_plain(xp_bf, *tail)
    torch.cuda.synchronize()
    _close_to(got, ref, TRAIN_TOL)
    _close_to(got_l, ref_l, TRAIN_TOL)


@pytest.mark.parametrize("B,H,D,T", LAYER_SHAPES)
def test_layer_bwd_kernels_match_plain(cuda, B, H, D, T):
    """Both layer backwards on the plain forward's residuals: gates mode
    (dgates in place of the gates) and recompute mode (gates rebuilt from
    x and h_prev, B not a multiple of 16 included)."""
    x = _layer_inputs(T, B, H, D, seed=B + H + T + 1, dev=cuda)
    bf = torch.bfloat16
    out, _, _, gates, cseq = tlt.recurrence_train_plain(
        x["x_proj"], x["w_h"], x["mask"], x["h0"], x["c0"], bf)
    c0 = x["c0"].to(bf).float()
    tail = (x["mask"], x["w_h"], x["dhn"], x["dcn"])
    ref = tlt.recurrence_bwd_plain(x["dout"], gates.clone(), cseq, c0, *tail)
    res = gates.clone()
    got = tlt.recurrence_bwd(x["dout"], res, cseq, c0, *tail)
    h_prev = torch.cat([x["h0"].to(bf)[None], out.to(bf)[:-1]])
    rargs = (x["dout"], x["x"], h_prev, cseq, c0, x["mask"], x["w_x"], x["b"], x["w_h"],
             x["dhn"], x["dcn"])
    ref_r = tlt.recurrence_bwd_recompute_plain(*rargs)
    got_r = tlt.recurrence_bwd_recompute(*rargs)
    torch.cuda.synchronize()
    assert got[0].data_ptr() == res.data_ptr()           # dgates in place
    _close_to(got, ref, TRAIN_TOL)
    _close_to(got_r, ref_r, TRAIN_TOL)


@pytest.mark.parametrize("kw", [dict(wavefront=False), dict(residual_mode="recompute"),
                                dict(remat=True), dict(time_chunk=4)],
                         ids=["layered", "recompute", "remat", "time_chunk"])
def test_layered_stack_through_kernels_matches_plain_versions_on_card(cuda, kw):
    """The layered training route on the card (both kernels of its residual
    mode, the weight-gradient kernel) against the same route's plain
    versions on the CPU: outputs, final states and every gradient."""
    L, T, B, D, H = 2, 9, 5, 64, 64
    g = torch.Generator().manual_seed(7)
    layers = tlstm.init_lstm_stack(g, L, D, H)
    x = torch.randn((T, B, D), generator=g)
    lens = _lengths(T, B)
    states = [(torch.randn((B, H), generator=g) * 0.2,
               torch.randn((B, H), generator=g) * 0.2) for _ in range(L)]
    cot = torch.randn((T, B, H), generator=g)
    results = []
    for dev in ("cpu", cuda):
        tl = [{k: v.detach().to(dev).requires_grad_(True) for k, v in p.items()}
              for p in layers]
        tx = x.detach().to(dev).requires_grad_(True)
        out, ns = tlstm.lstm_stack(
            tl, tx, lens.to(dev), [(c.to(dev), h.to(dev)) for c, h in states],
            compute_dtype=torch.bfloat16, use_kernels=True,
            dropout_rng=torch.Generator().manual_seed(1),
            **{"wavefront": True, **kw})
        loss = (out.float() * cot.to(dev)).sum() + sum(c.sum() + h.sum() for c, h in ns)
        loss.backward()
        results.append([out.float(), *[t for pair in ns for t in pair]]
                       + [p[k].grad for p in tl for k in sorted(p)] + [tx.grad])
    torch.cuda.synchronize()
    for a, b in zip(*results):
        a, b = a.detach(), b.detach().cpu()
        scale = max(1.0, float(a.abs().max()))
        assert float((a - b).abs().max()) <= TRAIN_TOL * scale


def test_layer_launch_counters_count_kernel_calls(cuda):
    x = _layer_inputs(4, 3, 64, 64, seed=8, dev=cuda)
    kernels = (tlt.recurrence_train, tlt.recurrence_bwd, tlt.recurrence_train_lean,
               tlt.recurrence_bwd_recompute)
    for fn in kernels:
        fn.launches = 0
    bf = torch.bfloat16
    tail = (x["w_h"], x["mask"], x["h0"], x["c0"], bf)
    out, _, _, gates, cseq = tlt.recurrence_train(x["x_proj"], *tail)
    tlt.recurrence_train_lean(x["x_proj"].to(bf), *tail)
    tlt.recurrence_train_plain(x["x_proj"], *tail)
    tlt.recurrence_bwd(x["dout"], gates, cseq, x["c0"], x["mask"], x["w_h"], x["dhn"],
                       x["dcn"])
    tlt.recurrence_bwd_recompute(x["dout"], x["x"], out.to(bf), cseq, x["c0"], x["mask"],
                                 x["w_x"], x["b"], x["w_h"], x["dhn"], x["dcn"])
    assert [fn.launches for fn in kernels] == [1] * 4


def test_layer_wrappers_reject_what_the_kernels_do_not_take(cuda):
    """A CUDA tensor the layer kernels cannot take raises; they never fall
    back to the plain version."""
    x = _layer_inputs(4, 3, 64, 64, seed=9, dev=cuda)
    bf = torch.bfloat16
    with pytest.raises(TypeError):          # the lean forward takes bf16 x_proj
        tlt.recurrence_train_lean(x["x_proj"], x["w_h"], x["mask"], x["h0"], x["c0"], bf)
    with pytest.raises(TypeError):          # bf16 residuals only
        tlt.recurrence_train(x["x_proj"], x["w_h"], x["mask"], x["h0"], x["c0"],
                             torch.float32)
    y = _layer_inputs(4, 3, 64, 40, seed=10, dev=cuda)
    hc = torch.zeros((4, 3, 64), dtype=bf, device=cuda)
    with pytest.raises(ValueError, match="D % 64"):
        tlt.recurrence_bwd_recompute(y["dout"], y["x"], hc, hc, y["c0"], y["mask"],
                                     y["w_x"], y["b"], y["w_h"], y["dhn"], y["dcn"])


@pytest.mark.parametrize("rows,H,D", [(1, 64, 64), (70, 64, 128), (333, 128, 64),
                                       (1000, 64, 192)])
def test_rebuild_gates_kernel_matches_plain(cuda, rows, H, D):
    """The recompute backward's rebuild product alone (TMA + wgmma): within
    1e-5 relative Frobenius of its plain version (float32 sums of the same
    bf16 products in another order) and bit for bit on repeat."""
    g = torch.Generator().manual_seed(rows + H + D)
    bf = torch.bfloat16
    r = lambda *s, scale: (torch.randn(s, generator=g) * scale).to(cuda)
    args = (r(rows, D, scale=1.0).to(bf), r(rows, H, scale=0.5).to(bf),
            r(D, 4 * H, scale=0.1).to(bf), r(H, 4 * H, scale=0.1).to(bf), r(4 * H, scale=0.1))
    got = tlt.rebuild_gates(*args)
    again = tlt.rebuild_gates(*args)
    ref = tlt.rebuild_gates_plain(*args)
    torch.cuda.synchronize()
    assert got.shape == ref.shape == (rows, 4 * H) and got.dtype == torch.float32
    assert float((got - ref).norm()) <= 1e-5 * float(ref.norm())
    assert torch.equal(got, again)


@pytest.mark.parametrize("T", [3, 4, 5, 9])
def test_recompute_bwd_at_chunk_edges_matches_plain(cuda, T, monkeypatch):
    """The recompute backward with the rebuild in chunks of 4 steps (the
    byte cap patched down), B=70 (not a multiple of 16): T shorter than a
    chunk, one chunk, one step past it, two chunks and a step."""
    B, H, D, chunk = 70, 64, 128, 4
    monkeypatch.setattr(tlt, "REBUILD_BYTES", chunk * B * 4 * H * 4)
    assert tlt.rebuild_chunk(T, B, H) == min(T, chunk)
    x = _layer_inputs(T, B, H, D, seed=T + 40, dev=cuda)
    bf = torch.bfloat16
    out, _, _, cseq = tlt.recurrence_train_lean_plain(
        x["x_proj"].to(bf), x["w_h"], x["mask"], x["h0"], x["c0"], bf)
    h_prev = torch.cat([x["h0"].to(bf)[None], out.to(bf)[:-1]])
    args = (x["dout"], x["x"], h_prev, cseq, x["c0"].to(bf).float(), x["mask"], x["w_x"],
            x["b"], x["w_h"], x["dhn"], x["dcn"])
    before = tlt.recurrence_bwd_recompute.rebuild_launches
    got = tlt.recurrence_bwd_recompute(*args)
    ref = tlt.recurrence_bwd_recompute_plain(*args)
    torch.cuda.synchronize()
    assert tlt.recurrence_bwd_recompute.rebuild_launches - before == -(-T // chunk)
    _close_to(got, ref, TRAIN_TOL)


@pytest.mark.parametrize("sr", [16000, 22050])
def test_fft_fbank_kernel_matches_plain_at_full_width(cuda, sr):
    """The FFT kernel on 10.24 s rows with an empty row and one shorter
    than a frame: 2e-3 of the largest magnitude, finite, and the empty
    row's banks exactly the eps floor, as the plain version's."""
    from rnn_speech_tpu_torch.ops import frontend_kernel as tfk
    from rnn_speech_tpu_torch.ops.frontend import DeviceFrontend

    width = int(sr * 10.24)
    audio, _ = _fbank_signals(sr, [width, 0, 300, width - 4321], width, seed=sr)
    fe = DeviceFrontend("fbank", sr=sr, max_samples=width, device=cuda)
    pre = torch.cat([audio[:, :1], audio[:, 1:] - 0.97 * audio[:, :-1]], dim=1).to(cuda)
    n_frames = fe._frames_for_width(width)
    args = (pre, fe._basis, fe._mel, fe.frame_step, n_frames, fe.n_fft)
    got = tfk.fbank_banks(*args)
    ref = tfk.fbank_banks_plain(*args)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(got).all())
    assert float((got - ref).abs().max()) <= 2e-3 * float(ref.abs().max())
    assert torch.equal(got[1], ref[1])


# ------------------- the mask stream, the alpha-stream CTC pair, the fbank kernel


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(37, 5, 64), (1001,), (2, 3, 7, 130), (2,)])
def test_bernoulli_mask_kernel_matches_plain_bit_for_bit(cuda, dtype, shape):
    got = tdrop.bernoulli_mask((77, 9), shape, 0.4, dtype, cuda)
    ref = tdrop.bernoulli_mask_plain((77, 9), shape, 0.4, dtype, cuda)
    torch.cuda.synchronize()
    assert got.dtype == dtype and torch.equal(got, ref)


@pytest.mark.parametrize("T,B,V,U", [(9, 3, 5, 2), (70, 17, 29, 12), (200, 5, 80, 60)])
def test_ctc_stream_kernels_match_plain(cuda, T, B, V, U):
    """The alpha stream equals the checkpoint kernel's rows at every block
    end bit for bit; both stream kernels against their plain versions at
    the CTC kernels' 1e-4."""
    logits, ll, labels, ul = (t.to(cuda) for t in _ctc_inputs(T, B, V, U, T + B + 1))
    log_probs, ext, skip_ok, ll, ul, valid = tck._setup(logits, ll, labels, ul, -1)
    K = tck.ctc_block(ext.shape[1], V)
    ck, last_ck = tck.ctc_alpha_ckpt(log_probs, ext, skip_ok, ll, ul, K)
    alphas, last = tck.ctc_alpha_stream(log_probs, ext, skip_ok, ll, ul)
    alphas_p, last_p = tck.alpha_stream_plain(log_probs, ext, skip_ok, ll, ul)
    logp = tck._loss(last_p, ul, valid)[1]
    post = tck.ctc_beta_post_stream(log_probs, ext, skip_ok, ll, ul, logp, alphas_p,
                                    tck.label_lists(ext, ul, V))
    post_p = tck.beta_post_stream_plain(log_probs, ext, skip_ok, ll, ul, logp, alphas_p)
    torch.cuda.synchronize()
    ends = [min(T, (i + 1) * K) - 1 for i in range(ck.shape[0])]
    assert torch.equal(alphas[ends], ck) and torch.equal(last, last_ck)
    for a, b in ((alphas, alphas_p), (last, last_p), (post, post_p)):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)


def _fbank_signals(sr, lengths, width, seed):
    g = torch.Generator().manual_seed(seed)
    audio = torch.randn((len(lengths), width), generator=g) * 0.1
    t = torch.arange(width) / sr
    audio += 0.3 * torch.sin(2 * torch.pi * 220.0 * t)[None]
    for i, n in enumerate(lengths):
        audio[i, n:] = 0.0
    return audio, torch.as_tensor(lengths)


@pytest.mark.parametrize("sr,lengths,width", [(22050, [22050, 0, 9000, 700], 22050),
                                              (16000, [3000, 16000, 401], 16000),
                                              (16000, [150, 399, 2000], 2000)])
def test_fbank_kernel_matches_plain(cuda, sr, lengths, width):
    """The banks against the plain version (2e-3 of their largest
    magnitude, the JAX kernel's own limit; float32 sums in another order),
    then the whole frontend with and without the kernel."""
    from rnn_speech_tpu_torch.ops import frontend_kernel as tfk
    from rnn_speech_tpu_torch.ops.frontend import DeviceFrontend

    audio, lens = _fbank_signals(sr, lengths, width, seed=sr + width)
    fe = DeviceFrontend("fbank", sr=sr, max_samples=width, device=cuda)
    fk = DeviceFrontend("fbank", sr=sr, max_samples=width, device=cuda, use_kernel=True)
    pre = torch.cat([audio[:, :1], audio[:, 1:] - 0.97 * audio[:, :-1]], dim=1).to(cuda)
    n_frames = fe._frames_for_width(width)
    args = (pre, fe._basis, fe._mel, fe.frame_step, n_frames, fe.n_fft)
    got = tfk.fbank_banks(*args)
    ref = tfk.fbank_banks_plain(*args)
    feats, nf = fk(audio.to(cuda), lens.to(cuda))
    feats_p, nf_p = fe(audio.to(cuda), lens.to(cuda))
    torch.cuda.synchronize()
    assert got.shape == ref.shape == (len(lengths), n_frames, 40)
    for a, b in ((got, ref), (feats, feats_p)):
        assert bool(torch.isfinite(a).all())
        assert float((a - b).abs().max()) <= 2e-3 * float(b.abs().max())
    assert torch.equal(nf, nf_p)


def test_alt_route_launch_counters_count_kernel_calls(cuda, monkeypatch):
    """The layered stack backward, the alpha-stream CTC backward and the
    fbank frontend each launch their kernels; the reverse diagonal and the
    checkpoint backward stay idle there."""
    from rnn_speech_tpu_torch.ops import frontend_kernel as tfk
    from rnn_speech_tpu_torch.ops.frontend import DeviceFrontend

    kernels = (tdrop.bernoulli_mask, twave.wavefront_train, twave.wavefront_bwd,
               tlt.recurrence_bwd, tck.ctc_alpha_stream, tck.ctc_beta_post_stream,
               tck.ctc_beta_post, tfk.fbank_banks)
    for fn in kernels:
        fn.launches = 0
    monkeypatch.setenv("RST_WAVEFRONT_BWD", "0")
    monkeypatch.setenv("RST_CTC_ALPHA_STREAM", "1")
    L, T, B, D, H = 3, 6, 4, 64, 64
    g = torch.Generator().manual_seed(9)
    layers = [{k: v.requires_grad_(True) for k, v in p.items()}
              for p in tlstm.init_lstm_stack(g, L, D, H, cuda)]
    states = [(torch.zeros((B, H), device=cuda),) * 2 for _ in range(L)]
    out, _ = twave.lstm_stack_wavefront_train(
        layers, torch.randn((T, B, D), generator=g).to(cuda), _lengths(T, B).to(cuda),
        states, drop_seed=(3, 4), drop_keep=0.4, drop_scale=2.5,
        compute_dtype=torch.bfloat16)
    out.float().sum().backward()
    logits, ll, labels, ul = (t.to(cuda) for t in _ctc_inputs(12, 4, 6, 3, 2))
    tck.ctc_loss(logits.requires_grad_(True), ll, labels, ul).sum().backward()
    fe = DeviceFrontend("fbank", sr=16000, max_samples=4000, device=cuda, use_kernel=True)
    fe(torch.zeros((2, 4000), device=cuda), torch.as_tensor([4000, 100], device=cuda))
    assert [fn.launches for fn in kernels] == [1, 1, 0, L, 1, 1, 0, 1]


def test_new_wrappers_reject_what_the_kernels_do_not_take(cuda):
    from rnn_speech_tpu_torch.ops import frontend_kernel as tfk

    with pytest.raises(TypeError):          # the mask kernel writes f32 or bf16
        tdrop.bernoulli_mask((1, 2), (8,), 0.5, torch.float16, cuda)
    logits, ll, labels, ul = (t.to(cuda) for t in _ctc_inputs(9, 3, 5, 2, 3))
    log_probs, ext, skip_ok, ll, ul, valid = tck._setup(logits, ll, labels, ul, -1)
    with pytest.raises(ValueError):         # the stream has T rows
        tck.ctc_beta_post_stream(log_probs, ext, skip_ok, ll, ul, torch.zeros(3, device=cuda),
                                 torch.zeros((8, 3, ext.shape[1]), device=cuda),
                                 tck.label_lists(ext, ul, 5))
    pre = torch.zeros((2, 1000), device=cuda)
    basis = torch.zeros((551, 514), device=cuda)
    mel = torch.zeros((257, 40), device=cuda)
    with pytest.raises(ValueError, match="step % 4"):
        tfk.fbank_banks(pre, basis, mel, 221, 3, 512)
    with pytest.raises(ValueError):         # float32 only
        tfk.fbank_banks(pre.double(), basis, mel, 220, 3, 512)


# ------------------------------------- the persistent lean forward (row 7)


def _rel_max(got, ref):
    """The largest error of each output over that output's own largest
    magnitude (the checks' measure in chip_smoke.py)."""
    out = []
    for g, r in zip(got, ref):
        assert g.shape == r.shape and g.dtype == r.dtype
        assert bool(torch.isfinite(g).all())
        scale = float(r.float().abs().max())
        out.append(float((g.float() - r.float()).abs().max()) / scale if scale else 0.0)
    return max(out)


@pytest.mark.parametrize("T,B", [(16, 1), (512, 17), (512, 400), (3510, 400), (512, 473)])
def test_persistent_lean_forward_matches_plain(cuda, T, B):
    """The recompute-mode forward at H=1024 on the persistent kernel (the
    plan's choice at these shapes, counted at its launch site) against its
    plain version, ragged lengths with a zero-length row: 8e-3 of each
    output's largest magnitude at T=16, 1.2e-2 longer (a bf16 rounding of
    h flipped by the summation order propagates, as for the per-step
    kernel); equal bit for bit on repeat."""
    H, bf = 1024, torch.bfloat16
    assert trec.lean_plan(B, H)["kernel"] == "persistent"
    g = torch.Generator().manual_seed(T + B)
    lim = (6.0 / (5 * H)) ** 0.5
    lens = _lengths(T, B)
    mask = (torch.arange(T)[:, None] < lens[None]).float()[:, None, :].to(cuda)
    xp = (torch.randn((T, B, 4 * H), generator=g) * 0.5).to(cuda, bf)
    w_h = ((torch.rand((H, 4 * H), generator=g) * 2 - 1) * lim).to(cuda, bf)
    h0 = (torch.randn((B, H), generator=g) * 0.2).to(cuda)
    c0 = (torch.randn((B, H), generator=g) * 0.2).to(cuda)
    before = tlt.recurrence_train_lean.persistent_launches
    got = tlt.recurrence_train_lean(xp, w_h, mask, h0, c0, bf)
    again = tlt.recurrence_train_lean(xp, w_h, mask, h0, c0, bf)
    torch.cuda.synchronize()
    assert tlt.recurrence_train_lean.persistent_launches - before == 2
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    del again
    ref = tlt.recurrence_train_lean_plain(xp, w_h, mask, h0, c0, bf)
    assert _rel_max(got, ref) <= (8e-3 if T <= 16 else 1.2e-2)
    if B > 2:                                # the zero-length row keeps its state
        assert torch.equal(got[1][2], h0[2]) and torch.equal(got[2][2], c0[2])
        assert not bool(got[0][:, 2].any())


def test_lean_forward_past_the_plans_grid_runs_the_per_step_kernel(cuda):
    """B=600 at H=1024 needs three row groups, 192 CTAs, more than the
    card's SMs: the plan sends it to the per-step kernel, which must still
    match the plain version (8e-3 at T=16)."""
    T, B, H, bf = 16, 600, 1024, torch.bfloat16
    assert trec.lean_plan(B, H)["kernel"] == "per_step"
    g = torch.Generator().manual_seed(5)
    lens = _lengths(T, B)
    mask = (torch.arange(T)[:, None] < lens[None]).float()[:, None, :].to(cuda)
    xp = (torch.randn((T, B, 4 * H), generator=g) * 0.5).to(cuda, bf)
    w_h = (torch.randn((H, 4 * H), generator=g) * 0.02).to(cuda, bf)
    h0 = (torch.randn((B, H), generator=g) * 0.2).to(cuda)
    c0 = (torch.randn((B, H), generator=g) * 0.2).to(cuda)
    before = tlt.recurrence_train_lean.persistent_launches
    got = tlt.recurrence_train_lean(xp, w_h, mask, h0, c0, bf)
    ref = tlt.recurrence_train_lean_plain(xp, w_h, mask, h0, c0, bf)
    torch.cuda.synchronize()
    assert tlt.recurrence_train_lean.persistent_launches == before
    assert _rel_max(got, ref) <= 8e-3


def test_persistent_lean_forward_without_its_barrier_fails_the_check(cuda):
    """The planted fault of chip_smoke.py: each CTA reads h without waiting
    for the others; the result must leave the tolerance (and not hang)."""
    T, B, H, bf = 512, 400, 1024, torch.bfloat16
    g = torch.Generator().manual_seed(3)
    lim = (6.0 / (5 * H)) ** 0.5
    mask = torch.ones((T, 1, B), device=cuda)
    xp = (torch.randn((T, B, 4 * H), generator=g) * 0.5).to(cuda, bf)
    w_h = ((torch.rand((H, 4 * H), generator=g) * 2 - 1) * lim).to(cuda, bf)
    h0 = (torch.randn((B, H), generator=g) * 0.2).to(cuda)
    c0 = (torch.randn((B, H), generator=g) * 0.2).to(cuda)
    bad = tlt._lean_persistent_launch(xp, w_h, mask, h0, c0, trec.lean_plan(B, H),
                                      skip_barrier=1)
    ref = tlt.recurrence_train_lean_plain(xp, w_h, mask, h0, c0, bf)
    torch.cuda.synchronize()
    assert _rel_max(bad, ref) > 1.2e-2


@pytest.mark.parametrize("T,B,V,U", [(9, 3, 5, 2), (70, 17, 29, 12), (200, 5, 80, 60),
                                     (100, 6, 80, 40), (1500, 4, 80, 700),
                                     (1800, 4, 80, 800)])
def test_ctc_backward_kernels_match_plain_bit_for_bit_on_repeat(cuda, T, B, V, U):
    """The redesigned backward (blank by a tree, rebuild beside beta) and its
    stream variant against their plain versions at 1e-5, at ragged input
    lengths and labels of 0, 1 and U, equal bit for bit on repeat.  The last
    two cases reach the states past the prefetched ones (S > 1280), the
    last at a K that ``ctc_block`` halves (S = 1601)."""
    logits, ll, labels, ul = (t.to(cuda) for t in _ctc_inputs(T, B, V, U, T + 2 * B))
    ul[0], ul[1], ul[-1] = 0, 1, U
    labels = torch.where(torch.arange(U, device=cuda)[None] < ul[:, None],
                         labels.clamp(min=0), -1)
    log_probs, ext, skip_ok, ll, ul, valid = tck._setup(logits, ll, labels, ul, -1)
    K = tck.ctc_block(ext.shape[1], V)
    args = (log_probs, ext, skip_ok, ll, ul)
    ck, last = tck.alpha_plain(*args, K, True)
    alphas, _ = tck.alpha_stream_plain(*args)
    logp = tck._loss(last, ul, valid)[1]
    lists = tck.label_lists(ext, ul, V)
    post = tck.ctc_beta_post(*args, logp, ck, K, lists)
    again = tck.ctc_beta_post(*args, logp, ck, K, lists)
    post_s = tck.ctc_beta_post_stream(*args, logp, alphas, lists)
    again_s = tck.ctc_beta_post_stream(*args, logp, alphas, lists)
    ref = tck.beta_post_plain(*args, logp, ck, K)
    torch.cuda.synchronize()
    assert torch.equal(post, again) and torch.equal(post_s, again_s)
    for a in (post, post_s):
        torch.testing.assert_close(a, ref, rtol=1e-5, atol=1e-5)


# ------------------ the persistent layered backward (row 6) and recurrence (row 2)


def _bwd_case(T, B, H, seed, dev):
    """The gates-mode backward's inputs on the plain forward's bf16
    residuals: (dout, gates, cseq, c0 as the residual stores it, mask, w_h,
    dhn, dcn), ragged lengths with a zero-length row.  W_h is
    xavier-uniform, as the model initialises it (``_layer_inputs``' N(0,
    0.1) at H=1024 makes the reverse carry grow ~1e8-fold over 512 steps,
    where any two summation orders part)."""
    bf = torch.bfloat16
    x = _layer_inputs(T, B, H, H, seed=seed, dev=dev)
    g = torch.Generator().manual_seed(seed)
    lim = (6.0 / (5 * H)) ** 0.5
    w_h = ((torch.rand((H, 4 * H), generator=g) * 2 - 1) * lim).to(dev, bf)
    _, _, _, gates, cseq = tlt.recurrence_train_plain(x["x_proj"], w_h, x["mask"], x["h0"],
                                                      x["c0"], bf)
    return (x["dout"], gates, cseq, x["c0"].to(bf).float(), x["mask"], w_h, x["dhn"],
            x["dcn"])


@pytest.mark.parametrize("T,B,H", [(16, 64, 1024), (512, 64, 1024), (16, 5, 1024),
                                   (9, 33, 128), (1, 64, 1024)])
def test_persistent_bwd_matches_plain(cuda, T, B, H):
    """The gates-mode backward on the persistent kernel (the plan's choice
    at these shapes, counted at its launch site) against its plain version:
    8e-3 of each output's largest magnitude at T <= 16, 1.2e-2 longer (a
    bf16 rounding of a dgate flipped by the summation order propagates, as
    for the per-step kernel); equal bit for bit on repeat; dgates in place
    of the gates."""
    assert tlt.bwd_plan(B, H)["kernel"] == "persistent"
    dout, gates, *rest = _bwd_case(T, B, H, seed=T + B, dev=cuda)
    ref = tlt.recurrence_bwd_plain(dout, gates.clone(), *rest)
    res = gates.clone()
    before = tlt.recurrence_bwd.persistent_launches
    got = tlt.recurrence_bwd(dout, res, *rest)
    again = tlt.recurrence_bwd(dout, gates.clone(), *rest)
    torch.cuda.synchronize()
    assert tlt.recurrence_bwd.persistent_launches - before == 2
    assert got[0].data_ptr() == res.data_ptr()
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    assert _rel_max(got, ref) <= (8e-3 if T <= 16 else 1.2e-2)
    if B > 2:                                # the zero-length row: dh, dc pass through
        assert not bool(got[0][:, 2].float().any())
        assert torch.equal(got[2][2], rest[-1][2])


def test_bwd_past_the_plans_grid_runs_the_per_step_kernel(cuda):
    """B=70 at H=1024 needs two row groups, 256 CTAs, more than the card's
    SMs: the plan sends it to the per-step kernel, which must still match
    the plain version (8e-3 at T=16)."""
    T, B, H = 16, 70, 1024
    assert tlt.bwd_plan(B, H)["kernel"] == "per_step"
    dout, gates, *rest = _bwd_case(T, B, H, seed=6, dev=cuda)
    ref = tlt.recurrence_bwd_plain(dout, gates.clone(), *rest)
    before = tlt.recurrence_bwd.persistent_launches
    got = tlt.recurrence_bwd(dout, gates, *rest)
    torch.cuda.synchronize()
    assert tlt.recurrence_bwd.persistent_launches == before
    assert _rel_max(got, ref) <= 8e-3


def test_persistent_bwd_without_its_barrier_fails_the_check(cuda):
    """The planted fault of chip_smoke.py: each CTA reads the step's dgates
    without waiting for the others; the result must leave the tolerance
    (and not hang)."""
    T, B, H = 512, 64, 1024
    dout, gates, *rest = _bwd_case(T, B, H, seed=7, dev=cuda)
    ref = tlt.recurrence_bwd_plain(dout, gates.clone(), *rest)
    bad = tlt._bwd_persistent_launch(dout, gates, *rest, tlt.bwd_plan(B, H), skip_barrier=1)
    torch.cuda.synchronize()
    assert _rel_max(bad, ref) > 1.2e-2


def _recurrence_case(T, B, H, seed, dev):
    """The inference recurrence's arguments (x_proj, w_h, mask, h0, c0) with
    ragged lengths and a zero-length row, W_h xavier-uniform as the model
    initialises it (``_inputs``' N(0, 0.1) at H=1024 saturates the gates,
    where a flipped bf16 rounding of h moves the outputs past 2e-3 on
    either kernel)."""
    x = _inputs(1, T, B, H, seed=seed, dev=dev)
    g = torch.Generator().manual_seed(seed)
    lim = (6.0 / (5 * H)) ** 0.5
    w_h = ((torch.rand((H, 4 * H), generator=g) * 2 - 1) * lim).to(dev, torch.bfloat16)
    return x["xp0"], w_h, x["mask"], x["h0"][0], x["c0"][0]


@pytest.mark.parametrize("T,B,H", [(16, 1, 1024), (16, 5, 1024), (200, 128, 1024),
                                   (64, 64, 1024), (9, 130, 128)])
def test_persistent_recurrence_matches_plain(cuda, T, B, H):
    """The inference recurrence on the persistent forward (f32 x_proj staged
    by TMA; the plan's choice, counted at its launch site) against its
    plain version within the inference kernels' 2e-3, bit for bit on
    repeat."""
    assert trec.lean_plan(B, H, x_f32=True)["kernel"] == "persistent"
    args = _recurrence_case(T, B, H, seed=T + B + H, dev=cuda)
    before = trec.lstm_recurrence.persistent_launches
    got = trec.lstm_recurrence(*args)
    again = trec.lstm_recurrence(*args)
    ref = trec.lstm_recurrence_plain(*args)
    torch.cuda.synchronize()
    assert trec.lstm_recurrence.persistent_launches - before == 2
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    _close(got, ref)
    if B > 2:                                # the zero-length row keeps its state
        assert torch.equal(got[1][2], args[3][2]) and not bool(got[0][:, 2].any())


def test_persistent_recurrence_adds_x_proj_in_float32(cuda):
    """x_proj is added in float32, as the TPU kernel adds it: at B=128,
    T=16 the mean abs error of each output stays within chip_smoke.py's
    XPROJ_MEAN_TOL, 6e-5 (the kernel's own sums and transcendentals give
    ~1e-5), while the same kernel fed bf16(x_proj), what a kernel that
    rounds it computes, leaves that bound (~3e-4).  The largest error alone
    cannot tell them apart."""
    T, B, H = 16, 128, 1024
    x_proj, *rest = _recurrence_case(T, B, H, seed=13, dev=cuda)
    ref = trec.lstm_recurrence_plain(x_proj, *rest)
    got = trec.lstm_recurrence(x_proj, *rest)
    bad = trec.lstm_recurrence(x_proj.to(torch.bfloat16).float(), *rest)
    torch.cuda.synchronize()
    mean = lambda res: max(float((g - r).abs().mean()) for g, r in zip(res, ref))
    assert mean(got) <= 6e-5 < mean(bad)


def test_recurrence_past_the_plans_grid_runs_the_per_step_kernel(cuda):
    """B=400 at H=1024: four tiles a CTA leave no room for two ring stages
    beside the f32 x_proj buffers; the per-step kernel runs, within 2e-3."""
    T, B, H = 16, 400, 1024
    assert trec.lean_plan(B, H, x_f32=True)["kernel"] == "per_step"
    args = _recurrence_case(T, B, H, seed=11, dev=cuda)
    before = trec.lstm_recurrence.persistent_launches
    got = trec.lstm_recurrence(*args)
    ref = trec.lstm_recurrence_plain(*args)
    torch.cuda.synchronize()
    assert trec.lstm_recurrence.persistent_launches == before
    _close(got, ref)


def test_persistent_recurrence_without_its_barrier_fails_the_check(cuda):
    """Each CTA reads h without waiting for the others: stale h must leave
    the tolerance (and not hang)."""
    T, B, H = 512, 128, 1024
    args = _recurrence_case(T, B, H, seed=12, dev=cuda)
    bad = trec._persistent_launch(*args, trec.lean_plan(B, H, x_f32=True), skip_barrier=1)
    ref = trec.lstm_recurrence_plain(*args)
    torch.cuda.synchronize()
    assert max(float((g - r).abs().max()) for g, r in zip(bad, ref)) > TOL


# ------- the persistent gates-mode forward (row 5) and wavefront forward (row 3)


def _train_case(T, B, H, seed, dev):
    """The gates-mode forward's arguments (x_proj f32, w_h, mask, h0, c0),
    ragged lengths with a zero-length row, W_h xavier-uniform as the model
    initialises it."""
    x_proj, w_h, mask, h0, c0 = _recurrence_case(T, B, H, seed, dev)
    return x_proj * 2.0, w_h, mask, h0, c0


@pytest.mark.parametrize("T,B,H", [(16, 64, 1024), (512, 64, 1024), (16, 5, 1024),
                                   (1, 64, 1024), (9, 130, 128)])
def test_persistent_layer_train_matches_plain(cuda, T, B, H):
    """The gates-mode forward on the persistent kernel (the plan's choice,
    counted at its launch site) against its plain version: 8e-3 of each
    output's largest magnitude at T <= 16, 1.2e-2 longer (the per-step
    kernel's tolerance), bit for bit on repeat; its gates, in the residual's
    [i | g | f | o] order, give the backward's plain version the plain
    forward's dgates within the same bound."""
    bf = torch.bfloat16
    assert tlt.lean_plan(B, H, x_f32=True)["kernel"] == "persistent"
    args = _train_case(T, B, H, seed=T + B + H, dev=cuda)
    before = tlt.recurrence_train.persistent_launches
    got = tlt.recurrence_train(*args, bf)
    again = tlt.recurrence_train(*args, bf)
    ref = tlt.recurrence_train_plain(*args, bf)
    torch.cuda.synchronize()
    assert tlt.recurrence_train.persistent_launches - before == 2
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    tol = 8e-3 if T <= 16 else 1.2e-2
    assert _rel_max(got, ref) <= tol
    g = torch.Generator().manual_seed(T)
    dout = (torch.randn((T, B, H), generator=g) * 0.5).to(cuda)
    dhn, dcn = (torch.randn((2, B, H), generator=g) * 0.5).to(cuda)
    tail = (args[4].to(bf).float(), args[2], args[1], dhn, dcn)
    dg = tlt.recurrence_bwd_plain(dout, got[3].clone(), got[4], *tail)
    dg_ref = tlt.recurrence_bwd_plain(dout, ref[3].clone(), ref[4], *tail)
    assert _rel_max(dg, dg_ref) <= tol
    if B > 2:                                # the zero-length row keeps its state
        assert torch.equal(got[1][2], args[3][2]) and not bool(got[0][:, 2].any())


def test_layer_train_past_the_plans_grid_runs_the_per_step_kernel(cuda):
    """B=260 at H=1024: three tiles a CTA leave no ring stage beside the W_h
    slice and the f32 x_proj buffers; the per-step kernel runs, within
    8e-3 at T=16."""
    T, B, H = 16, 260, 1024
    assert tlt.lean_plan(B, H, x_f32=True)["kernel"] == "per_step"
    args = _train_case(T, B, H, seed=21, dev=cuda)
    before = tlt.recurrence_train.persistent_launches
    got = tlt.recurrence_train(*args, torch.bfloat16)
    ref = tlt.recurrence_train_plain(*args, torch.bfloat16)
    torch.cuda.synchronize()
    assert tlt.recurrence_train.persistent_launches == before
    assert _rel_max(got, ref) <= 8e-3


def test_persistent_layer_train_without_its_barrier_fails_the_check(cuda):
    """Each CTA reads h without waiting for the others: stale h must leave
    the tolerance (and not hang)."""
    T, B, H = 512, 64, 1024
    args = _train_case(T, B, H, seed=22, dev=cuda)
    bad = tlt._train_persistent_launch(*args, tlt.lean_plan(B, H, x_f32=True), skip_barrier=1)
    ref = tlt.recurrence_train_plain(*args, torch.bfloat16)
    torch.cuda.synchronize()
    assert _rel_max(bad, ref) > 1.2e-2


def _wavefront_case(L, T, B, H, seed, dev):
    """The training forward's arguments at D = H, ragged lengths with a
    zero-length row, xavier-uniform weights as the model initialises them."""
    x = _train_inputs(L, T, B, H, H, seed, dev)
    g = torch.Generator().manual_seed(seed)
    lim = (6.0 / (5 * H)) ** 0.5
    w = lambda *s: ((torch.rand(s, generator=g) * 2 - 1) * lim).to(dev, torch.bfloat16)
    x.update(w_x0=w(H, 4 * H), w_h=w(L, H, 4 * H), w_x_rest=w(L - 1, H, 4 * H))
    return [x[k] for k in ("x", "w_x0", "w_h", "w_x_rest", "b_all", "mask", "h0", "c0")]


def _launch_drop(drop):
    """``_persistent_launch``'s drop tuple for a ``_drop`` result."""
    if not drop:
        return (0, None, 0, 0, 0, 1.0)
    mode, arr, scale, keep = drop
    if mode == 1:
        return (1, *twave._drop_launch_args(1, arr, keep, scale, arr.shape, arr.device))
    return (2, *twave._drop_launch_args(2, arr, keep, scale, None, None))


@pytest.mark.parametrize("mode", [0, 1, 2])
@pytest.mark.parametrize("L,T,B,H", [(3, 7, 5, 256), (2, 40, 17, 512), (3, 16, 64, 1024),
                                     (3, 9, 1, 1024), (2, 3, 64, 256), (3, 11, 5, 64),
                                     (2, 9, 33, 128)])
def test_persistent_wavefront_train_matches_plain(cuda, mode, L, T, B, H):
    """The wavefront training forward on the persistent kernel (the plan's
    choice at every one of these widths) against its plain version in drop
    modes 0, 1 and 2: 8e-3 of each output's largest magnitude (T <= 16) or
    1.2e-2, bit for bit on repeat; in mode 2 equal to mode 1 fed
    ``random_bits.wavefront_masks`` of the same seed words."""
    from rnn_speech_tpu_torch.ops import random_bits as rb

    bf = torch.bfloat16
    args = _wavefront_case(L, T, B, H, seed=L + T + B + H + mode, dev=cuda)
    drop = _drop(mode, L, T, B, H, seed=B + T) if mode else ()
    layout = twave.wavefront_layout(B, H, L, H)
    assert twave.wavefront_plan(B, H, L, H) == {"kernel": "persistent", **layout}
    before = twave.wavefront_train.persistent_launches
    got = twave.wavefront_train(*args, bf, *drop)
    assert twave.wavefront_train.persistent_launches - before == 1
    again = twave._persistent_launch(*args, _launch_drop(drop), layout)
    ref = twave.wavefront_train_plain(*args, bf, *drop)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    assert _rel_max(got, ref) <= (8e-3 if T <= 16 else 1.2e-2)
    if mode == 2:
        masks = rb.wavefront_masks(drop[1], L - 1, T, B, H, drop[3], cuda).float()
        fed = twave._persistent_launch(*args, _launch_drop((1, masks, drop[2], 1.0)), layout)
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(got, fed))
    if B > 2:                                # the zero-length row keeps its state
        assert torch.equal(got[3][:, 2], args[6][:, 2]) and not bool(got[0][:, :, 2].any())


@pytest.mark.parametrize("mode", [0, 1, 2])
@pytest.mark.parametrize("L,T,B,H", [(2, 7, 3, 64), (3, 1, 5, 64), (3, 10, 33, 128)])
def test_per_diagonal_wavefront_train_past_the_plan_matches_plain(cuda, mode, L, T, B, H):
    """The per-diagonal training forward (the wide step's kernel) launched
    at shapes the plan sends to the persistent kernel (partly filled
    16-row tiles, T shorter than the stack) against its plain version in
    drop modes 0, 1 and 2, within 1e-2."""
    args = _wavefront_case(L, T, B, H, seed=L + T + B + H + mode, dev=cuda)
    drop = _drop(mode, L, T, B, H, seed=B + T) if mode else ()
    assert twave.wavefront_plan(B, H, L, H)["kernel"] == "persistent"
    got = twave._per_diagonal_launch(*args, _launch_drop(drop))
    ref = twave.wavefront_train_plain(*args, torch.bfloat16, *drop)
    torch.cuda.synchronize()
    _close_to(got, ref, TRAIN_TOL)


def test_persistent_wavefront_without_its_waits_fails_the_check(cuda):
    """The layers read their rings without waiting for their producers:
    stale h must leave the tolerance (and not hang)."""
    L, T, B, H = 3, 64, 64, 1024
    args = _wavefront_case(L, T, B, H, seed=31, dev=cuda)
    bad = twave._persistent_launch(*args, (0, None, 0, 0, 0, 1.0),
                                   twave.wavefront_plan(B, H, L, H), skip_waits=1)
    ref = twave.wavefront_train_plain(*args, torch.bfloat16)
    torch.cuda.synchronize()
    assert _rel_max(bad, ref) > 1.2e-2


def _wavefront_eval_case(L, T, B, H, seed, dev):
    """The inference forward's arguments: ragged lengths with a zero-length
    row, xavier-uniform weights as the model initialises them."""
    x = _inputs(L, T, B, H, seed, dev)
    g = torch.Generator().manual_seed(seed)
    lim = (6.0 / (5 * H)) ** 0.5
    w = lambda *s: ((torch.rand(s, generator=g) * 2 - 1) * lim).to(dev, torch.bfloat16)
    x.update(w_h=w(L, H, 4 * H), w_x_rest=w(L - 1, H, 4 * H))
    return [x[k] for k in ("xp0", "w_h", "w_x_rest", "b_rest", "mask", "h0", "c0")]


@pytest.mark.parametrize("L,T,B,H", [(3, 16, 128, 1024), (3, 9, 1, 1024), (2, 7, 70, 256),
                                     (3, 11, 5, 64), (2, 40, 128, 512), (4, 3, 17, 64),
                                     (3, 12, 64, 128)])
def test_persistent_wavefront_eval_matches_plain(cuda, L, T, B, H):
    """The wavefront inference forward on the persistent kernel (the plan's
    choice: one row group up to B=64, two up to 128) against its plain
    version within 2e-3, counted at its launch site, bit for bit on
    repeat; the zero-length row keeps its state."""
    args = _wavefront_eval_case(L, T, B, H, seed=L + T + B + H, dev=cuda)
    layout = twave.wavefront_eval_layout(B, H, L)
    assert twave.wavefront_eval_plan(B, H, L) == {"kernel": "persistent", **layout}
    assert layout["groups"] == (1 if B <= 64 else 2)
    before = twave.lstm_stack_wavefront.persistent_launches
    got = twave.lstm_stack_wavefront(*args)
    assert twave.lstm_stack_wavefront.persistent_launches - before == 1
    again = twave._eval_persistent_launch(*args, layout)
    ref = twave.lstm_stack_wavefront_plain(*args)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    _close(got, ref)
    if B > 2:
        assert torch.equal(got[1][:, 2], args[5][:, 2]) and not bool(got[0][:, 2].any())


@pytest.mark.parametrize("L,T,B,H", [(2, 7, 3, 64), (3, 1, 5, 64), (3, 10, 100, 128)])
def test_per_diagonal_wavefront_eval_past_the_plan_matches_plain(cuda, L, T, B, H):
    """The per-diagonal inference forward launched at shapes the plan sends
    to the persistent kernel, against its plain version within 2e-3."""
    args = _wavefront_eval_case(L, T, B, H, seed=L + T + B + H + 1, dev=cuda)
    assert twave.wavefront_eval_plan(B, H, L)["kernel"] == "persistent"
    got = twave._eval_per_diagonal_launch(*args)
    ref = twave.lstm_stack_wavefront_plain(*args)
    torch.cuda.synchronize()
    _close(got, ref)


def test_persistent_wavefront_eval_without_its_waits_fails_the_check(cuda):
    """The layers read their rings without waiting for their producers:
    stale h must leave the tolerance (and not hang)."""
    L, T, B, H = 3, 64, 128, 1024
    args = _wavefront_eval_case(L, T, B, H, seed=32, dev=cuda)
    bad = twave._eval_persistent_launch(*args, twave.wavefront_eval_plan(B, H, L), skip_waits=1)
    ref = twave.lstm_stack_wavefront_plain(*args)
    torch.cuda.synchronize()
    assert max(float((a - b).abs().max()) for a, b in zip(bad, ref)) > TOL


def _wavefront_bwd_case(L, T, B, H, mode, seed, dev):
    """The reverse diagonal's arguments (``wavefront_bwd``'s, outs last) from
    the plain training forward of ``_wavefront_case`` in drop mode ``mode``,
    and its drop tuple."""
    args = _wavefront_case(L, T, B, H, seed, dev)
    drop = _drop(mode, L, T, B, H, seed=B + T) if mode else ()
    outs, gates, cseq, _, _ = twave.wavefront_train_plain(*args, torch.bfloat16, *drop)
    g = torch.Generator().manual_seed(seed + 1)
    r = lambda *s: torch.randn(s, generator=g).to(dev)
    bwd = [r(T, B, H).to(torch.bfloat16) * 0.1, args[2], args[3], args[5], gates, cseq, args[7],
           r(L, B, H) * 0.1, r(L, B, H) * 0.1, outs]
    return bwd, drop


@pytest.mark.parametrize("mode", [0, 1, 2])
@pytest.mark.parametrize("L,T,B,H", [(3, 7, 5, 256), (2, 40, 17, 512), (3, 16, 64, 1024),
                                     (3, 9, 1, 1024), (3, 11, 5, 64), (2, 9, 33, 128)])
def test_persistent_wavefront_bwd_matches_plain(cuda, mode, L, T, B, H):
    """The reverse diagonal on the persistent kernel (the plan's choice at
    every one of these widths) against its plain version in drop modes 0,
    1 and 2: 8e-3 of each output's largest magnitude (T <= 16) or 1.2e-2,
    dgates in place, counted at its launch site, bit for bit on repeat; in
    mode 2 (dgates, dh0, dc0 and xdrop) equal to mode 1 fed
    ``random_bits.wavefront_masks`` of the same seed words."""
    from rnn_speech_tpu_torch.ops import random_bits as rb

    bwd, drop = _wavefront_bwd_case(L, T, B, H, mode, seed=L + T + B + H + mode, dev=cuda)
    with_gates = lambda: bwd[:4] + [bwd[4].clone()] + bwd[5:]
    layout = twave.wavefront_bwd_layout(B, H, L)
    assert twave.wavefront_bwd_plan(B, H, L) == {"kernel": "persistent", **layout}
    before = twave.wavefront_bwd.persistent_launches
    gates = bwd[4].clone()
    got = twave.wavefront_bwd(*bwd[:4], gates, *bwd[5:], *drop)
    assert twave.wavefront_bwd.persistent_launches - before == 1
    assert got[0].data_ptr() == gates.data_ptr()
    again = twave._bwd_persistent_launch(*with_gates(), _launch_drop(drop), layout)
    ref = twave.wavefront_bwd_plain(*with_gates(), *drop)
    torch.cuda.synchronize()
    assert len(got) == len(ref) == (4 if mode else 3)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    assert _rel_max(got, ref) <= (8e-3 if T <= 16 else 1.2e-2)
    if mode == 2:
        masks = rb.wavefront_masks(drop[1], L - 1, T, B, H, drop[3], cuda).float()
        fed = twave._bwd_persistent_launch(*with_gates(), _launch_drop((1, masks, drop[2], 1.0)),
                                           layout)
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(got, fed))


@pytest.mark.parametrize("mode", [0, 1, 2])
@pytest.mark.parametrize("L,T,B,H", [(2, 7, 3, 64), (3, 1, 5, 64), (3, 10, 33, 128)])
def test_per_diagonal_wavefront_bwd_past_the_plan_matches_plain(cuda, mode, L, T, B, H):
    """The per-diagonal reverse diagonal (the fused pass's and the wide
    step's kernel) launched at shapes the plan sends to the persistent
    kernel, against its plain version in drop modes 0, 1 and 2, within
    8e-3 of each output's largest magnitude."""
    bwd, drop = _wavefront_bwd_case(L, T, B, H, mode, seed=L + T + B + H + mode + 1, dev=cuda)
    assert twave.wavefront_bwd_plan(B, H, L)["kernel"] == "persistent"
    got = _per_diagonal_bwd(*bwd[:4], bwd[4].clone(), *bwd[5:], *drop)
    ref = twave.wavefront_bwd_plain(*bwd[:4], bwd[4].clone(), *bwd[5:], *drop)
    torch.cuda.synchronize()
    assert _rel_max(got, ref) <= 8e-3


def test_wavefront_bwd_past_the_plans_grid_runs_the_per_diagonal_kernel(cuda):
    """B=70 (past one tile) and the fused pass take the per-diagonal kernel
    through the plan: no persistent launch."""
    L, T, H = 3, 5, 128
    for B, fuse in ((70, False), (5, True)):
        bwd, drop = _wavefront_bwd_case(L, T, B, H, 2, seed=40 + B, dev=cuda)
        assert twave.wavefront_bwd_plan(B, H, L, fuse)["kernel"] == "per_diagonal"
        before = twave.wavefront_bwd.persistent_launches
        got = twave.wavefront_bwd(*bwd[:4], bwd[4].clone(), *bwd[5:], *drop, fuse_dwx=fuse)
        ref = twave.wavefront_bwd_plain(*bwd[:4], bwd[4].clone(), *bwd[5:], *drop, fuse_dwx=fuse)
        torch.cuda.synchronize()
        assert twave.wavefront_bwd.persistent_launches == before
        assert _rel_max(got[:3], ref[:3]) <= 8e-3


def test_persistent_wavefront_bwd_without_its_waits_fails_the_check(cuda):
    """The layers read dgates without waiting for their writers: the result
    must leave the tolerance (and not hang)."""
    L, T, B, H = 3, 64, 64, 1024
    bwd, _ = _wavefront_bwd_case(L, T, B, H, 0, seed=33, dev=cuda)
    bad = twave._bwd_persistent_launch(*bwd[:4], bwd[4].clone(), *bwd[5:],
                                       (0, None, 0, 0, 0, 1.0), twave.wavefront_bwd_plan(B, H, L),
                                       skip_waits=1)
    ref = twave.wavefront_bwd_plain(*bwd[:4], bwd[4].clone(), *bwd[5:])
    torch.cuda.synchronize()
    assert _rel_max(bad, ref) > 1.2e-2
