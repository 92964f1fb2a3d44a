"""CTC loss: log-space forward/backward (alpha/beta) with an analytic
gradient, in plain PyTorch.

Counterpart of ``rnn_speech_tpu/ops/ctc.py`` (the scan CTC, which the
JAX train step runs with ``use_pallas_ctc = False``):

* Dense inputs: labels are a padded (B, U) int array plus lengths.
  Labels padded with -1 map to blank; blank is the last class.
* The alpha recursion is a loop over time with the whole (B, S) state
  vectorised (S = 2U + 1 extended states).  The beta recursion runs only
  in the backward, which assembles the exact gradient softmax - posterior
  from the saved log-probs and alphas.
* ``ignore_longer_outputs_than_inputs``: examples whose label is longer
  than their input (or whose input is empty) have zero loss and zero
  gradient.
* -1e30 stands in for -inf, so masked states never produce NaN via
  inf - inf.

The CTC kernels of the JAX package (``ops/ctc_pallas.py``) are ported in
``ops/ctc_kernel.py``, which the train step takes with ``use_pallas_ctc``;
its plain versions share this module's lattice helpers (``_prepare``,
``_alpha_init``/``_alpha_step``, ``_beta_setup``/``_beta_step``,
``_terminal_logp``) and ``ctc_grad``.
"""

from __future__ import annotations

from typing import Tuple

import torch

from rnn_speech_tpu_torch import stages

Tensor = torch.Tensor
NEG_INF = -1.0e30
f32 = torch.float32


def _shift(x: Tensor, by: int, fill, right: bool = True) -> Tensor:
    """Shift along the last axis by ``by`` (right: towards higher s),
    filling with ``fill``."""
    if by >= x.shape[-1]:
        return torch.full_like(x, fill)
    if right:
        return torch.nn.functional.pad(x[..., :-by], (by, 0), value=fill)
    return torch.nn.functional.pad(x[..., by:], (0, by), value=fill)


def _log_add3(a: Tensor, b: Tensor, c: Tensor) -> Tensor:
    m = torch.maximum(torch.maximum(a, b), c)
    m_safe = torch.clamp(m, min=NEG_INF)
    out = m_safe + torch.log(torch.exp(a - m_safe) + torch.exp(b - m_safe)
                             + torch.exp(c - m_safe))
    return torch.where(m <= NEG_INF, NEG_INF, out)


def _prepare(labels: Tensor, blank_id: int) -> Tuple[Tensor, Tensor]:
    """(ext (B, 2U+1) labels interleaved with blanks, skip_ok (B, S): the
    s-2 -> s transition is allowed)."""
    labels = torch.where(labels < 0, torch.full_like(labels, blank_id), labels)
    B, U = labels.shape
    ext = torch.full((B, 2 * U + 1), blank_id, dtype=labels.dtype,
                     device=labels.device)
    ext[:, 1::2] = labels
    ext_m2 = _shift(ext, 2, -1)
    return ext, (ext != blank_id) & (ext != ext_m2)


def _alpha_init(lp_0: Tensor, states: Tensor = None) -> Tensor:
    """The first alpha row (B, S): the first two extended states (of
    ``states`` where given) take their log-prob, the rest the sentinel."""
    s_idx = torch.arange(lp_0.shape[-1], device=lp_0.device)[None, :]
    first = s_idx < 2 if states is None else states & (s_idx < 2)
    return torch.where(first, lp_0, torch.full_like(lp_0, NEG_INF))


def _alpha_step(alpha: Tensor, lp_t: Tensor, skip_ok: Tensor, live: Tensor,
                states: Tensor = None) -> Tensor:
    """One step of the alpha recursion; rows whose ``live`` (B,) is False
    keep their alpha, and states outside ``states`` (B, S) stay at the
    sentinel."""
    a1 = _shift(alpha, 1, NEG_INF)
    a2 = torch.where(skip_ok, _shift(alpha, 2, NEG_INF), NEG_INF)
    new = torch.where(live[:, None], _log_add3(alpha, a1, a2) + lp_t, alpha)
    return new if states is None else torch.where(states, new, NEG_INF)


def _beta_setup(skip_ok: Tensor, label_lengths: Tensor) -> Tuple[Tensor, Tensor]:
    """(beta_init (B, S): 0 at the terminal states, the sentinel elsewhere;
    skip_next2 (B, S): the s -> s+2 transition is allowed)."""
    S = skip_ok.shape[1]
    dev = skip_ok.device
    s_idx = torch.arange(S, device=dev)[None, :]
    end = (2 * label_lengths.to(torch.int64))[:, None]
    beta_init = torch.where(
        (s_idx == end) | ((s_idx == end - 1) & (label_lengths[:, None] > 0)),
        torch.zeros((), device=dev), torch.full((), NEG_INF, device=dev))
    return beta_init, _shift(skip_ok.to(f32), 2, 0.0, right=False) > 0.5


def _beta_step(bstar: Tensor, skip_next2: Tensor, restart: Tensor,
               beta_init: Tensor) -> Tensor:
    """beta_t from bstar = beta_{t+1} + lp_{t+1}; rows whose ``restart``
    (B,) is True (their last frame) start again from ``beta_init``."""
    b1 = _shift(bstar, 1, NEG_INF, right=False)
    b2 = torch.where(skip_next2, _shift(bstar, 2, NEG_INF, right=False), NEG_INF)
    return torch.where(restart[:, None], beta_init, _log_add3(bstar, b1, b2))


def _forward_alphas(lp_ext: Tensor, logit_lengths: Tensor,
                    skip_ok: Tensor) -> Tensor:
    """alphas (T, B, S) from the log-probs of the extended labels (frozen
    past each example's true input length)."""
    alphas = torch.empty_like(lp_ext)
    alpha = alphas[0] = _alpha_init(lp_ext[0])
    for t in range(1, lp_ext.shape[0]):
        alpha = alphas[t] = _alpha_step(alpha, lp_ext[t], skip_ok, t < logit_lengths)
    return alphas


def _terminal_logp(last_alpha: Tensor, label_lengths: Tensor) -> Tensor:
    end = (2 * label_lengths).to(torch.int64)
    a_end = last_alpha.gather(1, end[:, None])[:, 0]
    a_pre = last_alpha.gather(1, (end - 1).clamp(min=0)[:, None])[:, 0]
    a_pre = torch.where(label_lengths > 0, a_pre, torch.full_like(a_pre, NEG_INF))
    return torch.logaddexp(a_end, a_pre)


def _ctc_fwd_impl(logits, logit_lengths, labels, label_lengths, blank_id):
    """(loss (B,), residuals for the backward)."""
    T, B, V = logits.shape
    if blank_id < 0:
        blank_id = V + blank_id
    logit_lengths = logit_lengths.to(logits.device)
    label_lengths = label_lengths.to(logits.device)
    log_probs = torch.log_softmax(logits.to(f32), dim=-1)
    ext, skip_ok = _prepare(labels.to(logits.device).to(torch.int64), blank_id)
    S = ext.shape[1]
    lp_ext = log_probs.gather(2, ext[None].expand(T, B, S))
    alphas = _forward_alphas(lp_ext, logit_lengths, skip_ok)
    logp = _terminal_logp(alphas[-1], label_lengths)
    valid = (label_lengths <= logit_lengths) & (logit_lengths > 0)
    loss = torch.where(valid, -logp, torch.zeros_like(logp))
    return loss, (log_probs, lp_ext, alphas, logp, ext, skip_ok, logit_lengths,
                  label_lengths, valid)


def ctc_grad(log_probs: Tensor, label_post: Tensor, logit_lengths: Tensor,
             valid: Tensor, g: Tensor) -> Tensor:
    """d loss / d logits (T, B, V) float32 from the label posteriors:
    exp(log_probs) - label_post, zero past each row's length and on
    invalid rows, times the cotangent ``g`` (B,)."""
    T = log_probs.shape[0]
    dev = log_probs.device
    grad = torch.exp(log_probs) - label_post
    t_mask = (torch.arange(T, device=dev)[:, None] < logit_lengths[None, :])[:, :, None]
    keep = t_mask & valid[None, :, None]
    return torch.where(keep, grad, torch.zeros((), device=dev)) * g.to(f32)[None, :, None]


def _ctc_bwd(residuals, g: Tensor) -> Tensor:
    """d loss / d logits (T, B, V) float32 for the cotangent ``g`` (B,)."""
    (log_probs, lp_ext, alphas, logp, ext, skip_ok, logit_lengths,
     label_lengths, valid) = residuals
    T, B, V = log_probs.shape
    beta_init, skip_next2 = _beta_setup(skip_ok, label_lengths)
    betas = torch.empty_like(alphas)
    beta = betas[T - 1] = torch.where((logit_lengths == T)[:, None], beta_init, NEG_INF)
    for t in range(T - 2, -1, -1):
        # The recursion restarts from the terminal condition at each
        # example's last frame; later frames are masked in ctc_grad.
        beta = betas[t] = _beta_step(beta + lp_ext[t + 1], skip_next2,
                                     t == logit_lengths - 1, beta_init)
    gamma = alphas + betas - logp[None, :, None]
    post = torch.exp(torch.clamp(gamma, max=0.0))                  # (T, B, S)
    onehot = torch.nn.functional.one_hot(ext, V).to(f32)           # (B, S, V)
    label_post = torch.einsum("tbs,bsv->tbv", post, onehot)
    return ctc_grad(log_probs, label_post, logit_lengths, valid, g)


class _CTCLoss(torch.autograd.Function):
    @staticmethod
    def forward(ctx, logits, logit_lengths, labels, label_lengths, blank_id):
        loss, residuals = _ctc_fwd_impl(logits, logit_lengths, labels,
                                        label_lengths, blank_id)
        ctx.residuals = residuals
        ctx.logits_dtype = logits.dtype
        return loss

    @staticmethod
    def backward(ctx, g):
        stages.mark("ctc_backward")
        grad = _ctc_bwd(ctx.residuals, g)
        del ctx.residuals
        return grad.to(ctx.logits_dtype), None, None, None, None


def ctc_loss(logits: Tensor, logit_lengths: Tensor, labels: Tensor,
             label_lengths: Tensor, blank_id: int = -1) -> Tensor:
    """Per-example CTC negative log-likelihood (B,) of time-major logits
    (T, B, V); labels (B, U) padded with -1 (or blank)."""
    return _CTCLoss.apply(logits, torch.as_tensor(logit_lengths),
                          torch.as_tensor(labels), torch.as_tensor(label_lengths),
                          blank_id)


def mean_of(loss_fn, logits, logit_lengths, labels, label_lengths, blank_id=-1):
    """Reference-style mean: per-example loss / input length, then the
    batch mean."""
    per = loss_fn(logits, logit_lengths, labels, label_lengths, blank_id)
    denom = torch.clamp(torch.as_tensor(logit_lengths, device=per.device).to(f32),
                        min=1.0)
    return torch.mean(per / denom)


def ctc_loss_mean(logits, logit_lengths, labels, label_lengths, blank_id=-1):
    return mean_of(ctc_loss, logits, logit_lengths, labels, label_lengths, blank_id)
