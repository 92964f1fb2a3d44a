"""Accuracy benchmark: train on the letters corpus, score a held-out split.

    python -m rnn_speech_tpu_torch.tools.accuracy_benchmark
        [--out chiprun_out/accuracy_curve.json] [--workdir DIR]
        [--clips 300] [--layers 2] [--hidden 256] [--batch 16]
        [--rounds 12] [--steps 200] [--wer_target 15] [--device cuda|cpu]

The port's counterpart of ``tools/accuracy_benchmark.py``, with the same
arguments and JSON keys.  The corpus is ``make_demo_corpus --mode
letters``: every character is a distinct tone, so the held-out sentences
(never seen in training) measure generalization, not memorization.  Each
round trains ``--steps`` more steps (``train/loop.train_acoustic``,
resuming from the round before's checkpoint) and greedy-decodes the
held-out clips one at a time (``evaluate_wer``); the run stops at the
first round whose WER reaches ``--wer_target``.  Writes
{"config", "curve": [{"step", "wer", "cer"}], "final", "best",
"wer_target", "reached_target"} and, beside them, the kernels the plans
pick at its shapes (``kernel_plans``) and each stage's seconds.  Runs on
``cuda`` unless ``--device cpu`` is given; a kernel that refuses a shape
raises.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time

import numpy as np

from rnn_speech_tpu_torch import resolve_device, to_device

SR = 16000
DEFAULT_OUT = os.path.join("chiprun_out", "accuracy_curve.json")


def build_corpus(workdir: str, clips: int, seed: int):
    """Letters-mode corpus + disjoint train/test sentence split."""
    from rnn_speech_tpu_torch import corpus, synth
    from rnn_speech_tpu_torch.tools.make_demo_corpus import render_letters

    rng = np.random.default_rng(seed)
    texts = synth.sample_sentences(clips, rng)
    sigs = [render_letters(t, SR, rng) for t in texts]
    synth.write_corpus(workdir, texts, sigs, SR)

    dp = corpus.DataProcessor(os.path.join(workdir, "demo"))
    dataset = dp.get_dataset()
    n_test = max(1, len(dataset) // 10)
    # Deterministic split; sentences are unique by construction, so the
    # test transcripts never appear in training.
    dataset = sorted(dataset, key=lambda item: item[0])
    rng.shuffle(dataset)
    return dataset[n_test:], dataset[:n_test]


def model_config(config, char_map, input_dim: int):
    """The AcousticConfig the training loop builds from ``config``: its
    widths, the ``[tpu]`` compute dtype and kernel switches."""
    import torch

    from rnn_speech_tpu_torch.models import acoustic

    return acoustic.AcousticConfig(
        num_layers=config.num_layers, hidden_size=config.hidden_size,
        input_dim=input_dim, num_labels=len(char_map),
        compute_dtype=(torch.bfloat16 if config.tpu.compute_dtype == "bfloat16"
                       else torch.float32),
        use_kernels=config.tpu.use_pallas_lstm, wavefront=config.tpu.wavefront,
    )


def kernel_plans(config, batch: int, sms=None) -> dict:
    """The kernels the plans pick, by shape alone, for the training
    forward and backward at ``batch`` rows and the B=1 decode of
    ``evaluate_wer``: "persistent", "per_diagonal" or "per_step"."""
    from rnn_speech_tpu_torch.ops import lstm_layer_train, lstm_recurrence, lstm_wavefront

    L, H = config.num_layers, config.hidden_size
    kw = {} if sms is None else {"sms": sms}
    if config.tpu.wavefront and L >= 2:
        return {"route": "wavefront",
                "train_forward": lstm_wavefront.wavefront_plan(batch, H, L, H, **kw)["kernel"],
                "train_backward": lstm_wavefront.wavefront_bwd_plan(batch, H, L, **kw)["kernel"],
                "decode_b1": lstm_wavefront.wavefront_eval_plan(1, H, L, **kw)["kernel"]}
    return {"route": "layered",
            "train_forward": lstm_recurrence.lean_plan(batch, H, x_f32=True, **kw)["kernel"],
            "train_backward": lstm_layer_train.bwd_plan(batch, H, **kw)["kernel"],
            "decode_b1": lstm_recurrence.lean_plan(1, H, x_f32=True, **kw)["kernel"]}


def evaluate_wer(config, char_map, test_set, device=None):
    """Greedy-decode WER/CER over the test set (the reference's
    per-utterance normalized formulas): each clip alone (B=1), its host
    features padded to ``max_input_seq_length`` frames, through the
    model the training loop trains (``model_config``) restored from
    ``checkpoint_dir/acoustic/``."""
    import torch

    from rnn_speech_tpu_torch import audio_io, frontend
    from rnn_speech_tpu_torch.models import acoustic
    from rnn_speech_tpu_torch.ops import decode as dec
    from rnn_speech_tpu_torch.train import checkpoint as ckpt
    from rnn_speech_tpu_torch.train.metrics import calculate_cer, calculate_wer

    dev = resolve_device(device)
    ap = frontend.AudioProcessor(
        config.max_input_seq_length, config.signal_processing
    )
    cfg = model_config(config, char_map, ap.feature_size)
    params = acoustic.init_params(torch.Generator().manual_seed(0), cfg, dev)
    restored = ckpt.restore(config.checkpoint_dir + "/acoustic/", params)
    if restored is None:
        raise RuntimeError(f"no checkpoint to evaluate under {config.checkpoint_dir!r}")
    params = restored[0]

    T = config.max_input_seq_length
    wers, cers = [], []
    for path, truth, _ in test_set:
        sig, sr = audio_io.load(path)
        feats, n = ap.process_signal(sig, sr)
        n = min(n, T)
        padded = np.zeros((T, 1, ap.feature_size), np.float32)
        padded[:len(feats), 0] = feats
        n_dev = torch.tensor([n], dtype=torch.int32, device=dev)
        with torch.no_grad():
            logits, _ = acoustic.forward(params, cfg, to_device(padded, dev), n_dev,
                                         acoustic.zero_state(cfg, 1, device=dev))
            ids, lens = dec.greedy_decode(logits, n_dev)
        ids, lens = ids.cpu().numpy(), lens.cpu().numpy()
        hyp = char_map.decode(list(ids[0, : int(lens[0])]))
        truth_norm = truth.lower()
        hyp_norm = hyp.lower().strip()
        n_words = max(len(truth_norm.split()), 1)
        n_chars = max(len(truth_norm), 1)
        wers.append(min(1.0, calculate_wer(truth_norm, hyp_norm) / n_words))
        cers.append(min(1.0, calculate_cer(truth_norm, hyp_norm) / n_chars))
    return 100.0 * float(np.mean(wers)), 100.0 * float(np.mean(cers))


def run(workdir: str, out_path: str, *, clips: int, layers: int,
        hidden: int, batch: int, rounds: int, steps: int,
        wer_target: float, seed: int = 0, lr: float = 3e-3, device=None) -> dict:
    import torch

    from rnn_speech_tpu_torch.config import Config
    from rnn_speech_tpu_torch.models.recognizer import SpeechRecognizer
    from rnn_speech_tpu_torch.train import loop

    device = resolve_device(device)
    t0 = time.perf_counter()
    train_set, test_set = build_corpus(workdir, clips, seed)
    stage_seconds = {"corpus": round(time.perf_counter() - t0, 3), "train": 0.0, "eval": 0.0}
    print(f"corpus: {len(train_set)} train + {len(test_set)} held-out clips, "
          f"{stage_seconds['corpus']} s", flush=True)
    char_map = SpeechRecognizer("english").get_char_map()
    config = Config(
        num_layers=layers, hidden_size=hidden, batch_size=batch,
        mini_batch_size=1, learning_rate=lr, lr_decay_factor=0.33,
        grad_clip=5.0, signal_processing="fbank",
        dropout_input_keep_prob=1.0, dropout_output_keep_prob=1.0,
        steps_per_checkpoint=steps, steps_per_evaluation=0,
        checkpoint_dir=os.path.join(workdir, "ckpt"),
        max_input_seq_length=600, max_target_seq_length=60,
        rnn_state_reset_ratio=1.0, dataset_size_ordering="False",
    )
    sms = (torch.cuda.get_device_properties(device).multi_processor_count
           if device.type == "cuda" else None)
    plans = kernel_plans(config, batch, sms)
    print(f"kernel plans at {layers}x{hidden}, B={batch} (decode B=1): {plans}", flush=True)

    curve = []
    reached = False
    for r in range(rounds):
        t0 = time.perf_counter()
        state = loop.train_acoustic(
            config, list(train_set), [], char_map, max_steps=steps, device=device
        )
        step = int(state["step"])
        stage_seconds["train"] += time.perf_counter() - t0
        t0 = time.perf_counter()
        wer, cer = evaluate_wer(config, char_map, test_set, device)
        stage_seconds["eval"] += time.perf_counter() - t0
        curve.append({"step": step, "wer": round(wer, 2),
                      "cer": round(cer, 2)})
        print(f"round {r + 1}: step {step} heldout WER {wer:.1f}% "
              f"CER {cer:.1f}%", flush=True)
        if wer <= wer_target:
            reached = True
            break
    stage_seconds = {k: round(v, 3) for k, v in stage_seconds.items()}
    print(f"stages: {stage_seconds}", flush=True)

    best = min(curve, key=lambda p: p["wer"]) if curve else None
    result = {
        "task": "letters-corpus held-out generalization",
        "config": {
            "clips": clips, "train": len(train_set), "test": len(test_set),
            "layers": layers, "hidden": hidden, "batch": batch,
            "features": "fbank-120", "lr": lr, "seed": seed,
            "device": str(device),
        },
        "curve": curve,
        "final": curve[-1] if curve else None,
        "best": best,
        "wer_target": wer_target,
        # The target counts as reached if ANY evaluation met it — late
        # rounds can fluctuate above a target the model already beat.
        "reached_target": reached or (
            best is not None and best["wer"] <= wer_target
        ),
        "kernel_plans": plans,
        "stage_seconds": stage_seconds,
    }
    if out_path:
        os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
        with open(out_path, "w") as fh:
            json.dump(result, fh, indent=2)
        print(f"Wrote {out_path}")
    return result


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--out", default=DEFAULT_OUT)
    parser.add_argument("--workdir", default=None,
                        help="corpus/checkpoint dir (default: temp)")
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                        help="device to train and decode on (default cuda)")
    parser.add_argument("--clips", type=int, default=300)
    parser.add_argument("--layers", type=int, default=2)
    parser.add_argument("--hidden", type=int, default=256)
    parser.add_argument("--batch", type=int, default=16)
    parser.add_argument("--rounds", type=int, default=12)
    parser.add_argument("--steps", type=int, default=200,
                        help="train steps per round (between evals)")
    parser.add_argument("--wer_target", type=float, default=15.0)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--lr", type=float, default=3e-3)
    args = parser.parse_args(argv)

    workdir = args.workdir or tempfile.mkdtemp(prefix="rst_accuracy_")
    result = run(
        workdir, args.out, clips=args.clips, layers=args.layers,
        hidden=args.hidden, batch=args.batch, rounds=args.rounds,
        steps=args.steps, wer_target=args.wer_target, seed=args.seed,
        lr=args.lr, device=args.device,
    )
    return 0 if result["reached_target"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
