"""Both hand-written CUDA kernels against their plain PyTorch versions on
the card, at small ragged shapes the serving check in ``chip_smoke.py``
does not reach: batch sizes that fill a 64-row tile partly or spill into a
third one, T shorter than the stack depth, zero-length rows, and T = 0.

Every test takes the ``cuda`` fixture, which skips it, with the reason,
where no NVIDIA GPU is present.  On a machine with a GPU and ``nvcc`` (no
JAX needed there; ``--noconftest`` keeps the JAX set-up of
``tests/conftest.py`` out) run, from the repository root:

    python -m pytest --noconftest -q tests/test_torch_cuda_kernels.py

Tolerance: kernel and plain version both round h to bf16 before each
product and sum in float32; only the summation order differs, which now
and then flips one bf16 rounding of an h element (a 2^-8 relative step).
Over these short runs that stays below 2e-3 absolute.
"""

import pytest
import torch

from rnn_speech_tpu_torch.ops import lstm as tlstm
from rnn_speech_tpu_torch.ops import lstm_recurrence as trec
from rnn_speech_tpu_torch.ops import lstm_wavefront as twave

TOL = 2e-3


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
