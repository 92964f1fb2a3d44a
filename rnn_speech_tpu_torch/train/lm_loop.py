"""Language-model training loop with the acoustic loop's policies.

The port's counterpart of ``rnn_speech_tpu/train/lm_loop.py``: shuffled,
length-batched epochs over a text corpus (``TextBatcher``, the same
``random.Random`` seeds and so the same batches), the checkpoint cadence
(``steps_per_checkpoint``; bundles in ``checkpoint_dir/language/`` under
the acoustic prefix, ``acousticmodel-<step>.npz``, as in the JAX
package), held-out perplexity every ``steps_per_evaluation`` steps,
plateau learning-rate decay (``train/loop.py``'s ``PlateauPolicy`` and
``MIN_LEARNING_RATE``) on the held-out NLL when an evaluation cadence is
set and on the train-window loss otherwise, the ``lm/*`` scalars, and
resume at the checkpoint's step and learning rate.

One step is the masked next-char loss (``models/language.py``) with
dropout at ``[lm_network_params] dropout``, its gradient by autograd,
global-norm clipping and TF-style Adam (``train/optim.py``).  Dropout
seed words come from a CPU ``torch.Generator`` seeded 0.  Runs on
``cuda`` unless ``device`` says otherwise.
"""

from __future__ import annotations

import logging
from random import Random
from typing import Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from rnn_speech_tpu_torch import resolve_device
from rnn_speech_tpu_torch.models import language
from rnn_speech_tpu_torch.train import checkpoint as ckpt
from rnn_speech_tpu_torch.train import metrics as metrics_mod
from rnn_speech_tpu_torch.train import optim
from rnn_speech_tpu_torch.train.loop import MIN_LEARNING_RATE, PlateauPolicy, to_device

logger = logging.getLogger(__name__)

MAX_TEXT_LEN = 128      # characters per training row (and max_target_seq_length)


def split_texts(texts: List[str], train_frac: float = 0.95,
                min_eval: int = 1) -> Tuple[List[str], List[str]]:
    """Deterministic train/held-out split; a corpus of two or more
    sentences keeps at least ``min_eval`` for evaluation."""
    texts = list(texts)
    if len(texts) < 2:
        return texts, []
    n_train = int(len(texts) * train_frac)
    n_train = min(max(n_train, 1), len(texts) - min_eval)
    return texts[:n_train], texts[n_train:]


class TextBatcher:
    """Shuffled, length-ordered (T, B) int32 id batches of a text list:
    each epoch shuffles the corpus, then sorts within windows of 16
    batches by length; rows are padded with -1 and a short last batch
    with zero-length rows, which the masked loss ignores."""

    def __init__(self, texts: List[str], char_map, max_len: int,
                 batch_size: int, seed: int = 0, shuffle: bool = True):
        self.encoded = [
            ids[:max_len]
            for ids in (char_map.encode(t, add_eos=True) for t in texts)
            if len(ids) >= 2           # at least one next-char prediction
        ]
        self.max_len = max_len
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.rng = Random(seed)

    def __len__(self) -> int:
        return len(self.encoded)

    def epoch(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        order = list(range(len(self.encoded)))
        if self.shuffle:
            self.rng.shuffle(order)
        window = self.batch_size * 16
        B = self.batch_size
        for w in range(0, len(order), window):
            chunk = sorted(order[w:w + window], key=lambda i: len(self.encoded[i]))
            for b in range(0, len(chunk), B):
                chars = np.full((self.max_len, B), -1, np.int32)
                lengths = np.zeros((B,), np.int32)
                for j, idx in enumerate(chunk[b:b + B]):
                    ids = self.encoded[idx]
                    chars[: len(ids), j] = ids
                    lengths[j] = len(ids)
                yield chars, lengths


def language_config(config, char_map) -> language.LanguageConfig:
    """The LM of ``config`` (``lm_resolved()``: unset fields inherit the
    acoustic section) over ``char_map``."""
    lm = config.lm_resolved()
    return language.LanguageConfig(num_layers=lm.num_layers, hidden_size=lm.hidden_size,
                                   num_labels=len(char_map))


def make_step(cfg: language.LanguageConfig, lm_params, batch_size: int, device):
    """(step, evaluate): one Adam step on a (T, B) batch -> (params,
    opt_state, loss), and the masked mean NLL of a batch."""
    keep = lm_params.dropout_keep_prob

    def step(params, opt_state, lr, chars, lengths, gen):
        tree = optim.tree_map(lambda t: t.detach().requires_grad_(True), params)
        loss = language.next_char_loss(
            tree, cfg, chars, lengths, language.zero_state(cfg, batch_size, device),
            dropout_rng=gen, input_keep_prob=keep, output_keep_prob=keep)
        grads = iter(torch.autograd.grad(loss, optim.tree_leaves(tree)))
        grads = optim.tree_map(lambda _: next(grads), tree)
        grads, _ = optim.clip_by_global_norm(grads, lm_params.grad_clip)
        params, opt_state = optim.adam_update(params, grads, opt_state, lr)
        return params, opt_state, loss.detach()

    def evaluate(params, chars, lengths):
        with torch.no_grad():
            return language.next_char_loss(params, cfg, chars, lengths,
                                           language.zero_state(cfg, batch_size, device))

    return step, evaluate


def train_language(
    config,
    texts: List[str],
    char_map,
    *,
    max_steps: Optional[int] = None,
    max_epoch: Optional[int] = None,
    learn_rate_override: Optional[float] = None,
    tb_name: Optional[str] = None,
    step_hook: Optional[Callable[[int, Dict], None]] = None,
    device=None,
):
    """One LM training session on ``device`` (default cuda).  Returns
    (params, final step)."""
    dev = resolve_device(device)
    lm_params = config.lm_resolved()
    cfg = language_config(config, char_map)
    B = lm_params.batch_size
    T = min(config.max_target_seq_length, MAX_TEXT_LEN)

    params = language.init_params(torch.Generator().manual_seed(0), cfg, dev)
    ckpt_dir = config.checkpoint_dir + "/language/"
    restored = ckpt.restore(ckpt_dir, params)
    step0, lr = 0, lm_params.learning_rate
    if restored is not None:
        params, step0, lr = restored
    if learn_rate_override is not None:
        lr = learn_rate_override
    lr = torch.tensor(lr, dtype=torch.float32, device=dev)

    train_texts, eval_texts = split_texts(texts)
    train_batches = TextBatcher(train_texts, char_map, T, B, seed=1)
    eval_batches = TextBatcher(eval_texts, char_map, T, B, shuffle=False)
    if not len(train_batches):
        raise ValueError("LM corpus has no usable sentences (>= 2 tokens)")
    logger.info("LM corpus: %d train / %d eval sentences",
                len(train_batches), len(eval_batches))

    opt_state = optim.init_adam(params)
    lm_step, lm_eval = make_step(cfg, lm_params, B, dev)

    def eval_perplexity(params) -> Tuple[float, float]:
        """(mean next-char NLL, perplexity) over the held-out sentences,
        each batch's mean weighted by its count of predicted tokens."""
        total_nll, total_tokens = 0.0, 0.0
        for c, n in eval_batches.epoch():
            tokens = float(np.maximum(n - 1, 0).sum())
            if tokens == 0.0:
                continue
            mean = float(lm_eval(params, to_device(c, dev), to_device(n, dev)))
            total_nll += mean * tokens
            total_tokens += tokens
        if total_tokens == 0.0:
            return 0.0, 1.0
        mean = total_nll / total_tokens
        return mean, float(np.exp(mean))

    writer = None
    if config.tensorboard_dir:
        writer = metrics_mod.MetricsWriter(config.tensorboard_dir, tb_name or "language")
    policy = PlateauPolicy(lm_params.lr_decay_factor)
    gen = torch.Generator().manual_seed(0)

    step, epoch = step0, 0
    batch_iter = iter(train_batches.epoch())
    total_steps = 0
    stop = False
    try:
        while not stop:
            window_loss, window_n = 0.0, 0
            for _ in range(config.steps_per_checkpoint):
                try:
                    chars, lengths = next(batch_iter)
                except StopIteration:
                    epoch += 1
                    if max_epoch is not None and epoch > max_epoch:
                        stop = True
                        break
                    batch_iter = iter(train_batches.epoch())
                    chars, lengths = next(batch_iter)
                params, opt_state, loss = lm_step(
                    params, opt_state, lr, to_device(chars, dev), to_device(lengths, dev), gen)
                step += 1
                total_steps += 1
                loss_f = float(loss)
                window_loss += loss_f
                window_n += 1
                if step_hook is not None:
                    step_hook(step, {"mean_loss": loss_f})
                if max_steps is not None and total_steps >= max_steps:
                    stop = True
                    break
            if window_n == 0:
                break
            mean_window = window_loss / window_n
            logger.info("LM step %d: window loss %.4f", step, mean_window)
            ckpt.save(ckpt_dir, params, step, float(lr))
            if writer:
                writer.add_scalar("lm/learning_rate", float(lr), step)
                writer.add_scalar("lm/train_mean_loss", mean_window, step)

            decay_signal, ran_eval = mean_window, False
            if eval_texts and config.steps_per_evaluation \
                    and step % config.steps_per_evaluation == 0:
                nll, ppl = eval_perplexity(params)
                logger.info("LM evaluation at step %d : nll %.4f - perplexity %.3f",
                            step, nll, ppl)
                if writer:
                    writer.add_scalar("lm/test_mean_loss", nll, step)
                    writer.add_scalar("lm/test_perplexity", ppl, step)
                decay_signal, ran_eval = nll, True

            # Plateau decay on the held-out NLL when evaluation is
            # configured; without an eval cadence the train-window loss
            # stands in.
            eval_drives = bool(eval_texts and config.steps_per_evaluation)
            if (ran_eval or not eval_drives) and policy.update(decay_signal):
                lr = lr * policy.decay_factor
                logger.info("LM is not improving, decaying the learning rate")
                if float(lr) < MIN_LEARNING_RATE:
                    logger.info("LM learning rate is too low, exiting")
                    break
                ckpt.save(ckpt_dir, params, step, float(lr))
    finally:
        if writer:
            writer.close()
    return params, step
