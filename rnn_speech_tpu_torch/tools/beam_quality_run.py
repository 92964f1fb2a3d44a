"""Decode-only beam-vs-greedy quality statistics from the committed bundle.

    python -m rnn_speech_tpu_torch.tools.beam_quality_run
        [--bundle trained_models/english-syllables]
        [--out chiprun_out/beam_quality.json] [--clips 600]
        [--levels 2400,4200,4800,5400,6000] [--device cuda|cpu]

The port's counterpart of ``tools/beam_quality_run.py``, with the same
arguments and JSON keys.  It loads the bundle (its ``hyperparams.json``
and checkpoints, restored by ``train/checkpoint.py``), draws a FRESH
held-out set (``fresh_held_out``: sentences the bundle never trained on;
its training texts are replayed from the recorded corpus seed and
excluded), and runs ``flagship_accuracy_run.decode_table`` (greedy, beam
K, beam K with the LM; paired per-clip bootstrap deltas) at each noise
level.  Runs on ``cuda`` unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

BUNDLE = "trained_models/english-syllables"
DEFAULT_OUT = os.path.join("chiprun_out", "beam_quality.json")


def fresh_held_out(bundle_cfg_path: str, n: int, seed: int,
                   train_clips: int, train_test_clips: int, sr: int):
    """n (text, clean_render) pairs disjoint from the bundle's train set.

    The bundle's training texts are reproduced from the recorded corpus
    seed (the same rng call sequence build_corpus uses for its text draw),
    then a fresh stream seeded [seed, 0xBEA2] draws new distinct
    sentences until n survive the exclusion."""
    from rnn_speech_tpu_torch import synth

    rng = np.random.default_rng(seed)
    texts = synth.sample_sentences(train_clips + train_test_clips, rng)
    train_texts = set(texts[train_test_clips:])

    rng2 = np.random.default_rng([seed, 0xBEA2])
    out, seen = [], set(texts)      # exclude train AND original held-out
    while len(out) < n:
        for s in synth.sample_sentences(64, rng2):
            if s in seen:
                continue
            seen.add(s)
            out.append(s)
            if len(out) == n:
                break
    if set(out) & train_texts:
        raise RuntimeError("fresh held-out sentences overlap the training texts")
    return [(t, synth.render_syllables_clean(t, sr, rng2)) for t in out]


def load_bundle_config(bundle: str):
    """The bundle's Config from its ``hyperparams.json``, rooted at the
    bundle (``checkpoint_dir`` = ``bundle``, no metrics directory)."""
    from rnn_speech_tpu_torch.config import SIDECAR_NAME, Config

    with open(os.path.join(bundle, SIDECAR_NAME)) as fh:
        hp = json.load(fh)
    hp["checkpoint_dir"] = bundle
    hp["tensorboard_dir"] = ""
    return Config.from_dict(hp)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--bundle", default=BUNDLE)
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--clips", type=int, default=600)
    ap.add_argument("--levels", default="2400,4200,4800,5400,6000")
    ap.add_argument("--decode_batch", type=int, default=20)
    ap.add_argument("--beam_width", type=int, default=16)
    ap.add_argument("--lm_weight", type=float, default=0.4)
    ap.add_argument("--seed", type=int, default=0,
                    help="the corpus seed the bundle recorded")
    ap.add_argument("--train_clips", type=int, default=1100)
    ap.add_argument("--train_test_clips", type=int, default=160)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="device to decode on (default cuda)")
    args = ap.parse_args(argv)

    from rnn_speech_tpu_torch import resolve_device
    from rnn_speech_tpu_torch.models.recognizer import SpeechRecognizer
    from rnn_speech_tpu_torch.tools.flagship_accuracy_run import (
        decode_table, noisy_points,
    )
    from rnn_speech_tpu_torch.train.pipeline import PipelineConfig

    device = resolve_device(args.device)
    config = load_bundle_config(args.bundle)
    char_map = SpeechRecognizer(config.language).get_char_map()
    sr = PipelineConfig(batch_size=1).sample_rate

    levels = sorted(float(x) for x in args.levels.split(","))
    t0 = time.time()
    held_out = fresh_held_out(args.bundle, args.clips, args.seed,
                              args.train_clips, args.train_test_clips, sr)
    render_s = time.time() - t0
    n_words = sum(len(t.split()) for t, _ in held_out)
    print(f"held-out: {len(held_out)} fresh clips, {n_words} words "
          f"({render_s:.0f}s to render)", flush=True)

    t0 = time.time()
    eval_points = noisy_points(held_out, levels, args.seed)
    sweep, paired = decode_table(
        config, char_map, eval_points, args.beam_width, args.lm_weight,
        args.decode_batch, device,
    )
    decode_s = time.time() - t0
    print(f"decode: {decode_s:.1f} s", flush=True)

    significant = {
        lvl: p for lvl, p in paired.items()
        if p["delta_wer_ci95"][0] > 0.0
    }
    significant_lm = {
        lvl: p for lvl, p in paired.items()
        if "lm" in p and p["lm"]["delta_wer_ci95"][0] > 0.0
    }
    result = {
        "task": "decode-only beam-vs-greedy statistics from the committed "
                "bundle on a fresh disjoint held-out set",
        "bundle": args.bundle,
        "clips": len(held_out),
        "n_words": n_words,
        "levels": levels,
        "beam_width": args.beam_width,
        "lm_weight": args.lm_weight,
        "noise_sweep": sweep,
        "beam_vs_greedy_paired": paired,
        "significant_levels": sorted(significant),
        "beam_beats_greedy_significant": bool(significant),
        "significant_levels_lm": sorted(significant_lm),
        "beam_lm_beats_greedy_significant": bool(significant_lm),
        "device": str(device),
        "stage_seconds": {"render": round(render_s, 3), "decode": round(decode_s, 3)},
    }
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as fh:
        json.dump(result, fh, indent=1)
        fh.write("\n")
    print(json.dumps({k: result[k] for k in
                      ("clips", "n_words", "significant_levels",
                       "beam_beats_greedy_significant")}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
