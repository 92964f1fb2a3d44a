"""The port's on-card parity tool (``rnn_speech_tpu_torch/tools/hw_parity.py``)
on the CPU, where both of its sides run plain versions: its ``main`` passes
with ``--device cpu`` and prints the JAX tool's lines; each of its seven
checks fails under a planted fault sized past that check's tolerance (a
kernel route's output scaled by 1.1, a beam score 0.05 off, a keep
probability 0.01 low); its host beam-search oracle equals the JAX tool's
(``tools/hw_parity.py``, where it is a nested function of ``check_beam``)
on the same log-probs, bit for bit; and ``check_ctc``'s losses, the
length-0 row's 0.0 included, equal JAX's ``ctc.ctc_loss`` on the same numpy
inputs within 1e-5 relative (the same float32 recursion in another order).
"""

import functools
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rnn_speech_tpu.ops import ctc as jctc
from rnn_speech_tpu_torch.ops import ctc_kernel as tck
from rnn_speech_tpu_torch.ops import decode as tdec
from rnn_speech_tpu_torch.ops import dropout as tdrop
from rnn_speech_tpu_torch.ops import frontend_kernel as tfk
from rnn_speech_tpu_torch.ops import grad_matmul as tgm
from rnn_speech_tpu_torch.ops import lstm_layer_train as tlt
from rnn_speech_tpu_torch.ops import lstm_wavefront as twave
from rnn_speech_tpu_torch.tools import hw_parity
from tools import hw_parity as jax_tool

CPU = torch.device("cpu")


def test_main_passes_on_the_cpu(capsys):
    assert hw_parity.main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    for line in ("LSTM kernels-vs-scan on hardware: OK",
                 "LSTM recompute-mode backward on hardware: OK",
                 "cross-layer wavefront stack (fwd + fused bwd) on hardware: OK",
                 "CTC kernels-vs-scan on hardware: OK",
                 "frontend kernel-vs-matmul on hardware: OK",
                 "beam search vs host oracle on hardware: OK",
                 "fused dropout statistics + VJP mask identity on hardware: OK",
                 "fused weight-grad contraction vs einsums on hardware: OK",
                 "ALL HARDWARE PARITY CHECKS PASSED"):
        assert line in out
    assert "(tolerance" in out


def _scaled(fn, index=None, by=1.1):
    """``fn`` with its result (or its result's ``index``-th element) times
    ``by``; its attributes (the launch counters) carried over."""
    @functools.wraps(fn)
    def faulty(*args, **kw):
        res = fn(*args, **kw)
        if index is None:
            return res * by
        return tuple(r * by if i == index else r for i, r in enumerate(res))
    return faulty


def _beam_off(fn):
    @functools.wraps(fn)
    def faulty(*args, **kw):
        labels, lengths, scores = fn(*args, **kw)
        return labels, lengths, scores + 0.05
    return faulty


def _keep_low(fn):
    @functools.wraps(fn)
    def faulty(x, seed, keeps):
        return fn(x, seed, [k - 0.01 for k in keeps])
    return faulty


# check -> (module, attribute, fault): each one past its check's tolerance.
FAULTS = {
    "check_lstm": (tlt, "recurrence_train", lambda f: _scaled(f, index=0)),
    "check_wavefront": (twave, "wavefront_train", lambda f: _scaled(f, index=0)),
    "check_ctc": (tck, "ctc_alpha_lossonly", _scaled),
    "check_frontend": (tfk, "fbank_banks", _scaled),
    "check_beam": (tdec, "beam_search_decode", _beam_off),
    "check_dropout": (tdrop, "dropout_kernel", _keep_low),
    "check_grad_matmul": (tgm, "dgates_weight_grads", lambda f: _scaled(f, index=0)),
}


def test_every_check_has_a_fault():
    assert sorted(FAULTS) == sorted(c.__name__ for c in hw_parity.CHECKS)


@pytest.mark.parametrize("check", sorted(FAULTS))
def test_each_check_fails_under_its_planted_fault(check, monkeypatch):
    module, name, fault = FAULTS[check]
    monkeypatch.setattr(module, name, fault(getattr(module, name)))
    with pytest.raises(AssertionError):
        getattr(hw_parity, check)(CPU)


def _jax_oracle():
    """The JAX tool's ``host_prefix_beam_search``, nested in its
    ``check_beam``, as a function."""
    code = next(c for c in jax_tool.check_beam.__code__.co_consts
                if isinstance(c, types.CodeType) and c.co_name == "host_prefix_beam_search")
    return types.FunctionType(code, {"np": np})


@pytest.mark.parametrize("seed,T,V,K", [(5, 60, 10, 8), (11, 25, 6, 4), (3, 40, 12, 16)])
def test_host_oracle_equals_the_jax_tools(seed, T, V, K):
    lp = torch.log_softmax(torch.as_tensor(
        np.random.default_rng(seed).normal(0, 2, (T, V)).astype(np.float32)), dim=-1).numpy()
    ours = hw_parity.host_prefix_beam_search(lp, K, blank=V - 1)
    theirs = _jax_oracle()(lp, K, V - 1)
    assert [labels for labels, _ in ours] == [labels for labels, _ in theirs]
    assert [score for _, score in ours] == [score for _, score in theirs]


def test_check_ctc_losses_equal_jax_ctc_loss():
    logits, ll, labels, lab_len = hw_parity.ctc_inputs(CPU)
    with torch.no_grad():
        ours = tck.ctc_loss(logits, ll, labels, lab_len).numpy()
    ref = np.asarray(jctc.ctc_loss(jnp.asarray(logits.numpy()), jnp.asarray(ll.numpy()),
                                   jnp.asarray(labels.numpy()), jnp.asarray(lab_len.numpy())))
    assert ref[4] == 0.0 and ours[4] == 0.0
    np.testing.assert_allclose(ours, ref, rtol=1e-5, atol=0)
    assert [c["check"] for c in hw_parity.check_ctc(CPU)] == ["ctc_loss", "ctc_grad"]
