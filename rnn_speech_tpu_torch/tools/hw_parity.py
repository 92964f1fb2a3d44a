"""On-card numerics check: the kernels against the scan and plain paths.

    python -m rnn_speech_tpu_torch.tools.hw_parity [--device cuda|cpu]

The port's counterpart of ``tools/hw_parity.py``, with its seven checks,
their shapes, lengths, losses and tolerances, and its printed lines: the
LSTM layer (gates and recompute residuals, float32 compute) and the
wavefront stack (the reverse diagonal and the layered backward, float32
residuals) against the time loop, the CTC kernels against the scan CTC,
the fbank kernel against the matmul frontend, the beam search against a
host dict-based oracle (``host_prefix_beam_search``), the dropout kernel's
statistics and its backward's mask, and the weight-gradient kernel against
its einsum forms.  The kernel route is held against the port's scan and
plain paths on the same device; each check prints its measured error
beside its tolerance and returns both.  On ``cuda`` (the default; there is
no fallback) the wrappers launch their CUDA kernels; with ``--device cpu``
both sides run plain versions, which proves the control flow only.

Inputs come from numpy seeds and explicit ``torch.Generator``s with the
JAX tool's distributions and shapes (not threefry's bits).  Float32
matmuls run without TF32 (the float32 compute mode is float32).
"""

from __future__ import annotations

import argparse
import math
from typing import Dict, List

import numpy as np
import torch

from rnn_speech_tpu_torch.ops import ctc, ctc_kernel, decode, dropout, grad_matmul, lstm
from rnn_speech_tpu_torch.ops import lstm_layer_train, lstm_wavefront, random_bits
from rnn_speech_tpu_torch.ops.frontend import DeviceFrontend

f32 = torch.float32


def _tensor(a, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a), device=device)


def _leaves(tree) -> List[torch.Tensor]:
    """The tensors of nested lists, tuples and dicts, in a fixed order."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in _leaves(tree[k])]
    return [t for v in tree for t in _leaves(v)]


def _grads(loss_fn, params, x, states):
    """Gradients of ``loss_fn(params, x, states)`` w.r.t. every leaf of
    (params, x, states), in ``_leaves`` order."""
    params = [{k: v.detach().clone().requires_grad_() for k, v in p.items()} for p in params]
    x = x.detach().clone().requires_grad_()
    states = [tuple(s.detach().clone().requires_grad_() for s in st) for st in states]
    leaves = _leaves((params, x, states))
    return torch.autograd.grad(loss_fn(params, x, states), leaves)


def _grad_rel(ref, got) -> float:
    """The largest max-abs difference over the largest magnitude (+1e-6) of
    any pair of gradients: the JAX tool's measure."""
    return max(float((r - g).abs().max()) / (float(r.abs().max()) + 1e-6)
               for r, g in zip(ref, got))


def _record(name: str, err: float, tol: float, **more) -> Dict:
    print(f"  {name}: error {err:.3e} (tolerance {tol:.1e})")
    return {"check": name, "err": err, "tol": tol, **more}


def check_lstm(device) -> List[Dict]:
    """One layer (T=96, B=8, D=16, H=256, float32 compute) through the
    layer kernels (gates residuals, then recompute residuals) against the
    time loop: gradients of every parameter, the input and the initial
    state within 2e-2 of the largest magnitude; the inference recurrence's
    outputs within 1e-3."""
    T, B, D, H = 96, 8, 16, 256
    layer = lstm.init_lstm_stack(torch.Generator().manual_seed(0), 1, D, H, device)[0]
    x = _tensor(np.random.default_rng(1).normal(size=(T, B, D)).astype(np.float32), device)
    lens = _tensor(np.array([96, 50, 0, 96, 31, 96, 7, 96], np.int32), device)
    state = (torch.zeros((B, H), device=device) + 0.2, torch.zeros((B, H), device=device) - 0.1)
    wy = _tensor(np.random.default_rng(2).normal(size=(T, B, H)).astype(np.float32) * 0.1,
                 device)

    def loss(fn):
        def inner(params, xx, sts):
            ys, (c, h) = fn(params[0], xx, lens, sts[0])
            return (ys * wy).sum() + (c ** 2).sum() + h.abs().sum()
        return inner

    layer_train = lambda mode: lambda p, xx, ln, st: lstm_layer_train.lstm_layer_train(
        p, xx, ln, st, compute_dtype=f32, residual_mode=mode)
    ref = _grads(loss(lstm.lstm_layer_scan), [layer], x, [state])
    out = []
    rel = _grad_rel(ref, _grads(loss(layer_train("gates")), [layer], x, [state]))
    out.append(_record("lstm_grads", rel, 2e-2))
    assert rel < 2e-2, f"LSTM grad rel diff {rel:.3e}"
    with torch.no_grad():
        y1, _ = lstm.lstm_layer_scan(layer, x, lens, state)
        y2, _ = lstm.lstm_layer(layer, x, lens, state)
    diff = float((y1 - y2).abs().max())
    out.append(_record("lstm_forward", diff, 1e-3))
    assert diff < 1e-3, f"LSTM fwd diff {diff:.3e}"
    print("LSTM kernels-vs-scan on hardware: OK")

    # Recompute residuals (the cell sequence only, the gates rebuilt in the
    # backward): the same gradients within the same bound.
    rel = _grad_rel(ref, _grads(loss(layer_train("recompute")), [layer], x, [state]))
    out.append(_record("lstm_recompute_grads", rel, 2e-2))
    assert rel < 2e-2, f"LSTM recompute grad rel diff {rel:.3e}"
    print("LSTM recompute-mode backward on hardware: OK")
    return out


def check_wavefront(device) -> List[Dict]:
    """The wavefront stack (L=3, D=H=128, T=64, B=8, float32 compute and
    residuals) against the layered time loop: gradients with the reverse
    diagonal and with the layered backward within 2e-2, and the inference
    forward's outputs within 1e-3."""
    T, B, D, H, L = 64, 8, 128, 128, 3
    layers = lstm.init_lstm_stack(torch.Generator().manual_seed(0), L, D, H, device)
    x = _tensor(np.random.default_rng(1).normal(size=(T, B, D)).astype(np.float32), device)
    lens = _tensor(np.array([64, 50, 0, 64, 31, 64, 7, 13], np.int32), device)
    states = [tuple(_tensor(np.random.default_rng(s + i).normal(size=(B, H))
                            .astype(np.float32) * 0.1, device) for s in (10, 20))
              for i in range(L)]
    wy = _tensor(np.random.default_rng(2).normal(size=(T, B, H)).astype(np.float32) * 0.1,
                 device)

    def ref_stack(params, xx, sts):
        out, new = xx, []
        for p, st in zip(params, sts):
            out, st = lstm.lstm_layer_scan(p, out, lens, st)
            new.append(st)
        return out, new

    def loss(fn):
        def inner(params, xx, sts):
            ys, new = fn(params, xx, sts)
            return (ys * wy).sum() + sum(c.sum() * 0.3 + h.sum() * 0.7 for c, h in new)
        return inner

    ref = _grads(loss(ref_stack), layers, x, states)
    out = []
    for flag in (True, False):
        wave = lambda p, xx, sts: lstm_wavefront.lstm_stack_wavefront_train(
            p, xx, lens, sts, compute_dtype=f32, residual_dtype=f32, bwd_wavefront=flag)
        rel = _grad_rel(ref, _grads(loss(wave), layers, x, states))
        out.append(_record(f"wavefront_grads_bwd_{int(flag)}", rel, 2e-2))
        assert rel < 2e-2, f"wavefront(bwd={int(flag)}) grad rel diff {rel:.3e}"
    with torch.no_grad():
        y_ref, _ = ref_stack(layers, x, states)
        y_app, _ = lstm_wavefront.lstm_stack_wavefront_apply(layers, x, lens, states)
    diff = float((y_ref - y_app).abs().max())
    out.append(_record("wavefront_apply_forward", diff, 1e-3))
    assert diff < 1e-3, f"wavefront apply fwd diff {diff:.3e}"
    print("cross-layer wavefront stack (fwd + fused bwd) on hardware: OK")
    return out


CTC_SHAPE = (640, 6, 80, 120)     # T, B, V, label buffer


def ctc_inputs(device):
    """``check_ctc``'s batch: logits N(0, 1) (T, B, V), input lengths with a
    zero-length row (label length 5), labels from numpy seed 0."""
    T, B, V, U = CTC_SHAPE
    rng = np.random.default_rng(0)
    logits = _tensor(rng.normal(0, 1, (T, B, V)).astype(np.float32), device)
    ll = _tensor(np.array([640, 300, 640, 50, 0, 640], np.int32), device)
    labels = _tensor(rng.integers(0, 78, (B, U)).astype(np.int32), device)
    lab_len = _tensor(np.array([120, 60, 30, 10, 5, 119], np.int32), device)
    return logits, ll, labels, lab_len


def check_ctc(device) -> List[Dict]:
    """The CTC kernels against the scan CTC at T=640, B=6, V=80, U=120:
    losses (the loss-only kernel) within 5e-4 relative (over max(|loss|,
    1)), gradients (the checkpoint forward and the backward) within 5e-2."""
    logits, ll, labels, lab_len = ctc_inputs(device)
    with torch.no_grad():
        l_s = ctc.ctc_loss(logits, ll, labels, lab_len)
        l_p = ctc_kernel.ctc_loss(logits, ll, labels, lab_len)
    rel = float(((l_s - l_p).abs() / l_s.abs().clamp(min=1.0)).max())
    out = [_record("ctc_loss", rel, 5e-4, losses=[float(v) for v in l_p])]
    assert rel < 5e-4, f"CTC loss rel diff {rel:.3e}"

    def grad(fn):
        lg = logits.detach().clone().requires_grad_()
        return torch.autograd.grad(fn(lg, ll, labels, lab_len).sum(), lg)[0]

    diff = float((grad(ctc.ctc_loss) - grad(ctc_kernel.ctc_loss)).abs().max())
    out.append(_record("ctc_grad", diff, 5e-2))
    assert diff < 5e-2, f"CTC grad diff {diff:.3e}"
    print("CTC kernels-vs-scan on hardware: OK")
    return out


def check_frontend(device) -> List[Dict]:
    """The fbank kernel against the matmul frontend at 22050 Hz on 2 s of
    N(0, 0.2) audio in four rows (full, 1/2, 1/3 and 1000 samples): equal
    frame counts, banks within 5e-3 of max(1, largest magnitude)."""
    sr = 22050
    max_samples = sr * 2
    rng = np.random.default_rng(7)
    x = _tensor(rng.normal(0, 0.2, (4, max_samples)).astype(np.float32), device)
    lens = _tensor(np.array([max_samples, max_samples // 2, max_samples // 3, 1000],
                            np.int32), device)
    fe_x = DeviceFrontend("fbank", sr=sr, max_samples=max_samples, device=device)
    fe_p = DeviceFrontend("fbank", sr=sr, max_samples=max_samples, device=device,
                          use_kernel=True)
    with torch.no_grad():
        feats_x, nf_x = fe_x(x, lens)
        feats_p, nf_p = fe_p(x, lens)
    assert torch.equal(nf_x.cpu(), nf_p.cpu())
    scale = max(1.0, float(feats_x.abs().max()))
    diff = float((feats_x - feats_p).abs().max()) / scale
    out = [_record("frontend_fbank", diff, 5e-3)]
    assert diff < 5e-3, f"frontend fbank rel diff {diff:.3e}"
    print("frontend kernel-vs-matmul on hardware: OK")
    return out


def host_prefix_beam_search(log_probs, beam_width, blank):
    """Prefix beam search over (T, V) log-probs on the host with a dict of
    prefixes: the oracle of ``check_beam``.  Returns [(labels, score)]
    best first."""
    T, V = log_probs.shape
    beams = {(): (0.0, -np.inf)}
    for t in range(T):
        new = {}

        def add(prefix, pb, pnb):
            opb, opnb = new.get(prefix, (-np.inf, -np.inf))
            new[prefix] = (np.logaddexp(opb, pb), np.logaddexp(opnb, pnb))

        for prefix, (pb, pnb) in beams.items():
            total = np.logaddexp(pb, pnb)
            add(prefix, total + log_probs[t, blank], -np.inf)
            if prefix:
                add(prefix, -np.inf, pnb + log_probs[t, prefix[-1]])
            for c in range(V):
                if c == blank:
                    continue
                p_base = pb if (prefix and c == prefix[-1]) else total
                add(prefix + (c,), -np.inf, p_base + log_probs[t, c])
        beams = dict(sorted(new.items(),
                            key=lambda kv: -np.logaddexp(*kv[1]))[:beam_width])
    return sorted(((list(k), np.logaddexp(*v)) for k, v in beams.items()),
                  key=lambda kv: -kv[1])


def check_beam(device) -> List[Dict]:
    """The beam search (K=8) on the device against ``host_prefix_beam_search``
    on logits N(0, 2) (T=60, B=3, V=10): the best beam's labels equal, its
    score within 2e-2."""
    T, B, V, K = 60, 3, 10, 8
    logits = np.random.default_rng(5).normal(0, 2, (T, B, V)).astype(np.float32)
    ll = np.array([60, 37, 60], np.int32)
    with torch.no_grad():
        labels, lengths, scores = decode.beam_search_decode(
            _tensor(logits, device), _tensor(ll, device), beam_width=K)
    labels, lengths, scores = labels.cpu(), lengths.cpu(), scores.cpu()
    oracles = [host_prefix_beam_search(
        torch.log_softmax(torch.as_tensor(logits[:, b]), dim=-1).numpy()[: int(ll[b])], K,
        blank=V - 1)[0] for b in range(B)]
    out = [_record("beam_score", max(abs(float(scores[b, 0]) - oracles[b][1])
                                     for b in range(B)), 2e-2)]
    for b, (best, score) in enumerate(oracles):
        got = [int(v) for v in labels[b, 0, : int(lengths[b, 0])]]
        assert got == best, (b, got, best)
        assert math.isclose(float(scores[b, 0]), score, rel_tol=0, abs_tol=2e-2), (
            b, float(scores[b, 0]), score)
    print("beam search vs host oracle on hardware: OK")
    return out


def check_dropout(device) -> List[Dict]:
    """The dropout kernel's statistics on (2000, 1024) twos: the kept
    fraction within 0.005 of 0.8, the mean within 0.02 of 2, values in
    {0, 2/0.8}, another seed's mask differing on > 20%, two fused keeps
    keeping 0.4 within 0.005, and the backward's regenerated mask equal to
    the forward's."""
    x = torch.ones((2000, 1024), dtype=f32, device=device) * 2.0
    seed = random_bits.seed_words(torch.Generator().manual_seed(42))
    out = dropout.dropout_kernel(x, seed, [0.8])
    kept = out != 0
    keep_frac = float(kept.float().mean())
    mean = float(out.mean())
    res = [_record("dropout_keep_fraction", abs(keep_frac - 0.8), 0.005),
           _record("dropout_mean", abs(mean - 2.0), 0.02)]
    assert abs(keep_frac - 0.8) < 0.005, keep_frac
    assert abs(mean - 2.0) < 0.02, mean
    support = set(np.unique(out.cpu().numpy()).tolist())
    assert support <= {0.0, float(np.float32(2.0 / 0.8))}, "support"

    other = dropout.dropout_kernel(x, random_bits.seed_words(torch.Generator().manual_seed(43)),
                                   [0.8])
    assert float((out != other).float().mean()) > 0.2, "masks must differ across seeds"

    # two fused masks compose: keep fraction ~ k1*k2
    two = dropout.dropout_kernel(x, seed, [0.8, 0.5])
    res.append(_record("dropout_two_keeps", abs(float((two != 0).float().mean()) - 0.4),
                       0.005))
    assert abs(float((two != 0).float().mean()) - 0.4) < 0.005

    # backward regenerates the identical mask
    v = x.clone().requires_grad_()
    g = torch.autograd.grad(dropout.dropout(v, seed, [0.8]).sum(), v)[0]
    assert torch.equal(g != 0, kept), "the backward's mask differs from the forward's"
    print("fused dropout statistics + VJP mask identity on hardware: OK")
    return res


def _allclose_err(got, ref, rtol, atol) -> float:
    """max |got - ref| / (atol + rtol·|ref|): at most 1 where
    ``numpy.testing.assert_allclose(got, ref, rtol, atol)`` passes."""
    return float(((got - ref).abs() / (atol + rtol * ref.abs())).max())


def check_grad_matmul(device) -> List[Dict]:
    """The weight-gradient kernel (bf16 compute: D=120 runs the WMMA tile)
    against its einsum forms on bf16 operands with float32 sums, T=96,
    B=8, H=256, D=120, G=1024: dW within rtol 3e-2, atol 3e-1, db within
    rtol 1e-3, atol 1e-2 (the reported error is max |diff| / (atol + rtol ·
    |ref|), passing at 1)."""
    T, B, H, D, G = 96, 8, 256, 120, 1024
    rng = np.random.default_rng(5)
    h, x, dg = (_tensor(rng.normal(size=s).astype(np.float32), device)
                for s in ((T, B, H), (T, B, D), (T, B, G)))
    dwh, dwx, db = grad_matmul.dgates_weight_grads(h, x, dg)
    bf = lambda t: t.to(torch.bfloat16).to(f32)
    rwh = torch.einsum("tbh,tbg->hg", bf(h), bf(dg))
    rwx = torch.einsum("tbd,tbg->dg", bf(x), bf(dg))
    rdb = dg.sum(dim=(0, 1))
    errs = [_allclose_err(dwh, rwh, 3e-2, 3e-1), _allclose_err(dwx, rwx, 3e-2, 3e-1),
            _allclose_err(db, rdb, 1e-3, 1e-2)]
    out = [_record("grad_matmul", max(errs), 1.0, dw_h=errs[0], dw_x=errs[1], db=errs[2])]
    assert max(errs) <= 1.0, f"weight grads off their einsums: {errs}"
    print("fused weight-grad contraction vs einsums on hardware: OK")
    return out


CHECKS = (check_lstm, check_wavefront, check_ctc, check_frontend, check_beam, check_dropout,
          check_grad_matmul)


def run(device) -> List[Dict]:
    """Every check on ``device``, in the JAX tool's order, and the closing
    line once all passed; returns their records.  A failed check raises
    AssertionError."""
    records = []
    for check in CHECKS:
        records += check(device)
    print("ALL HARDWARE PARITY CHECKS PASSED")
    return records


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                        help="cuda (the kernels, the default) or cpu (plain versions)")
    args = parser.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("hw_parity: no CUDA device (pass --device cpu for the plain versions)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = torch.cuda.get_device_name(0) if args.device == "cuda" else "cpu"
    print(f"devices: {args.device} ({name})")
    run(torch.device(args.device))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
