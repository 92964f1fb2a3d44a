"""End-to-end learning test of the port: its train step drives CTC to zero
error on the tiny memorization task of ``tests/test_convergence.py``
(T=60, B=2, D=8, V=12, one layer of 64 units, lr 3e-3, no dropout), on
the CPU, which pins the gradient path, the optimizer, the greedy decoder
and the metric together."""

import numpy as np
import torch

from rnn_speech_tpu_torch.models import acoustic
from rnn_speech_tpu_torch.train import step as step_mod


def test_train_step_memorizes_tiny_task():
    T, B, D, V = 60, 2, 8, 12
    rng = np.random.default_rng(0)
    labels = np.full((1, B, 10), -1, np.int32)
    labels[0, 0, :4] = [1, 2, 3, 4]
    labels[0, 1, :5] = [5, 6, 7, 8, 9]
    batch = {
        "features": torch.as_tensor(rng.normal(0, 1, (1, B, T, D)).astype(np.float32)),
        "frame_lengths": torch.full((1, B), T, dtype=torch.int32),
        "labels": torch.as_tensor(labels),
        "label_lengths": torch.as_tensor([[4, 5]], dtype=torch.int32),
    }
    cfg = acoustic.AcousticConfig(num_layers=1, hidden_size=64, input_dim=D, num_labels=V)
    scfg = step_mod.StepConfig(model=cfg, input_keep_prob=1.0, output_keep_prob=1.0)
    state = step_mod.init_train_state(torch.Generator().manual_seed(0), cfg, B, 3e-3,
                                      device="cpu")

    first_loss = None
    for i in range(150):
        state, metrics = step_mod.train_step(scfg, state, batch,
                                             torch.Generator().manual_seed(i), True)
        if first_loss is None:
            first_loss = float(metrics["mean_loss"])

    # Thresholds of the JAX package's test: loss from above 0.01 to below it,
    # and the greedy decode exact on both rows.
    assert float(metrics["mean_loss"]) < 0.01 < first_loss
    assert float(metrics["mean_error_rate"]) == 0.0
