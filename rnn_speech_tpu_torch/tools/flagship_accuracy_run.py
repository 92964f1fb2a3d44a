"""One continuous flagship-width accuracy session, decoded from its bundle.

    python -m rnn_speech_tpu_torch.tools.flagship_accuracy_run
        [--out chiprun_out/flagship_accuracy.json] [--workdir DIR]
        [--artifact_dir DIR] [--device cuda|cpu] [--resume]
        [--clips 1100] [--test_clips 160] [--layers 3] [--hidden 1024]
        [--batch 32] [--max_steps 3000] [--eval_noise_levels 900 2400 4800]
        ...

The port's counterpart of ``tools/flagship_accuracy_run.py``, with the
same functions, arguments and JSON keys, on the port's modules:

  1. ``build_corpus`` renders a coarticulated-syllables corpus
     (``synth.render_syllables_clean``) with a disjoint held-out split:
     training clips carry per-clip broadband noise drawn log-uniformly
     from ``train_noise`` and are written as a LibriSpeech-layout FLAC
     corpus; held-out clips render clean once, so ``noisy_points`` can add
     each sweep level's noise to the same renders.  Bit-identical to the
     JAX tool's corpus: one seeded numpy stream drives every draw.
  2. One ``train/loop.train_acoustic`` session at the reference topology
     (3x1024, fbank-120) with the loop's own evaluation cadence and
     plateau decay: the curves are read back from its ``events.jsonl``.
  3. A char LM on the training transcripts (``train/lm_loop.py``).
  4. ``export_weights`` re-encodes both final checkpoints as a bf16 bundle
     beside ``hyperparams.json`` and a README; ``decode_table`` decodes the
     held-out split FROM the bundle, greedy, beam K and beam K with the LM
     by shallow fusion (``cli.build_forward``, ``cli.load_lm_stepper``,
     ``cli.infer``), at every sweep level: per-clip mean WER/CER (x100),
     corpus totals, bootstrap CIs and a paired beam-vs-greedy delta.
  5. ``streaming_table`` feeds a held-out subset through
     ``cli.StreamingTranscriber`` in fixed chunks and records the
     chunked-vs-one-shot agreement and the streaming WER.

Everything runs on ``cuda`` unless ``--device cpu`` is given; there is no
fallback.  ``--resume`` skips training and picks up at the export: the
corpus replays bit for bit and the checkpoints and curves under
``--workdir`` are reused.  The result also records ``stage_seconds`` (the
corpus's render and FLAC encode, training, LM, export, decode and
streaming), each printed as it ends.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np

from rnn_speech_tpu_torch import resolve_device, to_device

INT16 = 32768.0
DEFAULT_OUT = os.path.join("chiprun_out", "flagship_accuracy.json")


def build_corpus(workdir: str, clips: int, test_clips: int, seed: int,
                 sr: int, train_noise, loop_eval_noise: float, *, timings=None):
    """Coarticulated-syllables corpus with a disjoint held-out split.

    Training clips render at per-clip noise drawn log-uniformly from the
    ``train_noise`` (lo, hi) range and are written as a LibriSpeech-layout
    corpus.  Held-out clips render CLEAN and are returned in memory so the
    SNR sweep can add each eval noise level to the same renders; a
    matched-noise copy is also written to disk for the training loop's
    eval cadence.  Returns (train_set, loop_test_set, held_out) with
    held_out = [(text, clean_signal_int16_scale_float)].  ``timings``, a
    dict, takes the seconds of the render and of the FLAC encode."""
    from rnn_speech_tpu_torch import corpus, synth

    t_render, t_encode = time.perf_counter(), 0.0
    rng = np.random.default_rng(seed)
    texts = synth.sample_sentences(clips + test_clips, rng)
    test_texts, train_texts = texts[:test_clips], texts[test_clips:]

    lo, hi = train_noise
    train_sigs = []
    for text in train_texts:
        std = float(np.exp(rng.uniform(np.log(lo), np.log(hi))))
        clean = synth.render_syllables_clean(text, sr, rng)
        train_sigs.append(np.clip(
            clean + rng.normal(0, std, len(clean)), -32000, 32000
        ).astype(np.int16))

    held_out, loop_sigs = [], []
    for text in test_texts:
        clean = synth.render_syllables_clean(text, sr, rng)
        held_out.append((text, clean))
        loop_sigs.append(np.clip(
            clean + rng.normal(0, loop_eval_noise, len(clean)),
            -32000, 32000,
        ).astype(np.int16))
    t_encode = time.perf_counter()
    t_render = t_encode - t_render
    synth.write_corpus(os.path.join(workdir, "train"), train_texts, train_sigs, sr)
    synth.write_corpus(os.path.join(workdir, "test"), test_texts, loop_sigs, sr)
    t_encode = time.perf_counter() - t_encode
    print(f"corpus: {len(train_texts)} train + {len(test_texts)} held-out clips, "
          f"render {t_render:.1f} s, FLAC encode {t_encode:.1f} s", flush=True)
    if timings is not None:
        timings.update(render=t_render, encode=t_encode)

    train_set = corpus.DataProcessor(
        os.path.join(workdir, "train", "demo")).get_dataset()
    loop_test_set = corpus.DataProcessor(
        os.path.join(workdir, "test", "demo")).get_dataset()
    return train_set, loop_test_set, held_out


def noisy_points(held_out, eval_noise_levels, seed: int):
    """{level: [(normalized_f32_signal, truth), ...]} — every level adds
    its noise to the SAME clean renders (deltas across the sweep are
    noise-only), with a level-keyed rng so the sweep is reproducible."""
    points = {}
    for level in eval_noise_levels:
        rng = np.random.default_rng([seed, int(level)])
        items = []
        for text, clean in held_out:
            sig = np.clip(
                clean + rng.normal(0, float(level), len(clean)),
                -32000, 32000,
            ).astype(np.float32) / INT16
            items.append((sig, text))
        points[float(level)] = items
    return points


def read_curves(tb_dir: str, run_name: str):
    """(step-indexed) train error, eval error and LR from events.jsonl."""
    path = os.path.join(tb_dir, run_name, "events.jsonl")
    by_tag: dict = {}
    if not os.path.exists(path):
        return by_tag
    with open(path) as fh:
        for line in fh:
            rec = json.loads(line)
            if rec.get("kind") != "scalar":
                continue
            by_tag.setdefault(rec["tag"], []).append(
                (int(rec["step"]), float(rec["value"]))
            )
    return by_tag


def _events_train_seconds(tb_dir: str, run_name: str) -> float:
    """Training wall-time reconstructed from scalar flush timestamps
    (resume path, where the live timer is gone).  Measures first->last
    flush and extrapolates the pre-first-flush window from the per-step
    rate; excludes the kernels' build, so it slightly understates a live
    measurement."""
    path = os.path.join(tb_dir, run_name, "events.jsonl")
    with open(path) as fh:
        recs = [json.loads(line) for line in fh]
    recs = [r for r in recs if r.get("kind") == "scalar" and "wall_time" in r]
    if len(recs) < 2:
        return 0.0
    steps = [int(r["step"]) for r in recs]
    walls = [float(r["wall_time"]) for r in recs]
    span = max(walls) - min(walls)
    step_span = max(steps) - min(steps)
    if step_span <= 0:
        return round(span, 1)
    return round(span * max(steps) / step_span, 1)


def export_weights(artifact_dir: str, config,
                   weights_dtype: str = "bfloat16") -> dict:
    """Re-encode the run's final acoustic + LM checkpoints into a
    ``trained_models/``-style bundle (bf16 halves its size; restore
    upcasts into the float32 parameter template) beside the Config's
    ``hyperparams.json``.  Raises if the acoustic checkpoint cannot be
    found: a weights-free bundle must never claim success."""
    from rnn_speech_tpu_torch.config import SIDECAR_NAME
    from rnn_speech_tpu_torch.train import checkpoint as ckpt

    copied = {}
    for sub in ("acoustic", "language"):
        src = ckpt.latest_path(os.path.join(config.checkpoint_dir, sub))
        if src is None:
            continue
        ckpt.convert_bundle(src, os.path.join(artifact_dir, sub),
                            weights_dtype=weights_dtype)
        copied[sub] = os.path.basename(src)
    if "acoustic" not in copied:
        raise RuntimeError(
            f"No acoustic checkpoint under {config.checkpoint_dir!r} — "
            "refusing to export a weights-free bundle"
        )
    if "language" not in copied:
        print("WARNING: no language checkpoint found; bundle has no LM",
              file=sys.stderr)

    # The bundle describes itself: its Config, checkpoint_dir rewritten to
    # the bundle.
    portable = config.replace(checkpoint_dir=artifact_dir,
                              tensorboard_dir="")
    with open(os.path.join(artifact_dir, SIDECAR_NAME), "w") as fh:
        json.dump(portable.to_dict(), fh, indent=2)
    return copied


def export_readme(artifact_dir: str, result: dict, copied: dict,
                  weights_dtype: str) -> None:
    from rnn_speech_tpu_torch.config import SIDECAR_NAME

    cfg = result["config"]
    lines = [
        "# Trained model bundle (coarticulated syllables corpus)",
        "",
        "Produced by `python -m rnn_speech_tpu_torch.tools.flagship_accuracy_run`",
        "— ONE continuous `train/loop.train_acoustic` session (plateau LR",
        f"decay active, {result['lr_decays_engaged']} decays engaged) plus a",
        "char-LM on the training transcripts.",
        "",
        "All WER/CER below were decoded FROM THIS BUNDLE (the",
        f"{weights_dtype} weights), not from the in-memory float32 params.",
        "",
    ]
    for level, table in sorted(result["noise_sweep"].items(),
                               key=lambda kv: float(kv[0])):
        greedy = table["greedy"]
        lines += [
            f"## Held-out split at eval noise sigma {level} "
            f"({greedy['clips']} clips, {greedy['n_words']} words)",
            "",
            "| decode | WER % | 95% CI | CER % | word edits |",
            "|---|---|---|---|---|",
        ]
        for name, entry in table.items():
            ci = entry["wer_ci95"]
            lines.append(
                f"| {name} | {entry['wer']} | [{ci[0]}, {ci[1]}] "
                f"| {entry['cer']} | {entry['word_edits']} |"
            )
        lines.append("")
    if result.get("streaming"):
        lines += ["## Streaming (chunked vs one-shot, same engine)", ""]
        for mode, data in result["streaming"].items():
            for cs, rec in data["chunks"].items():
                lines.append(
                    f"- `{mode}` chunk {cs}s: agreement "
                    f"{rec['agreement_pct']}% over {rec['clips']} clips, "
                    f"streaming WER {rec['wer']}%"
                )
        lines.append("")
    lines += [
        "## Training protocol",
        "",
        "```json",
        json.dumps(cfg, indent=2),
        "```",
        "",
        "## Files",
        "",
    ]
    for sub, name in copied.items():
        lines.append(f"- `{sub}/{name}` — final {sub} checkpoint "
                     f"(params + step + LR, {weights_dtype} npz)")
    lines += [
        f"- `{SIDECAR_NAME}` — the exact Config "
        "(fork-or-restore compatible)",
        "",
        "## Using the bundle",
        "",
        "Point a config's `checkpoint_dir` at this directory and run e.g.:",
        "",
        "```sh",
        "python -m rnn_speech_tpu_torch.cli --config <config-pointing-here> --file clip.wav",
        "```",
        "",
        "Regenerate the exact corpus (train + held-out split, per-clip",
        "noise draws included) with `flagship_accuracy_run.build_corpus`",
        f"with clips={cfg['clips']}, test_clips={cfg['test_clips']}, "
        f"seed={cfg['seed']},",
        f"train_noise={tuple(cfg['train_noise'])}, "
        f"loop_eval_noise={cfg['headline_noise_std']}; standalone corpora",
        "of the same font: `python -m rnn_speech_tpu_torch.tools.make_demo_corpus",
        "--mode syllables --clips N --seed S --noise_std X`.",
    ]
    with open(os.path.join(artifact_dir, "README.md"), "w") as fh:
        fh.write("\n".join(lines) + "\n")
    print(f"Exported trained bundle to {artifact_dir}")


def _bootstrap_ci(values, n_boot: int = 1000, seed: int = 0):
    """Percentile-bootstrap 95% CI of the mean, as percentages."""
    values = np.asarray(values, np.float64)
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, len(values), (n_boot, len(values)))
    means = values[idx].mean(axis=1)
    return [round(100.0 * float(np.percentile(means, 2.5)), 2),
            round(100.0 * float(np.percentile(means, 97.5)), 2)]


def decode_modes(config, char_map, beam_width: int, lm_weight: float, device=None):
    """(forward, modes): ``cli.build_forward``'s (model config, frontend,
    params) from ``checkpoint_dir/acoustic/`` on ``device``, and {name:
    (beam width, LM stepper, LM weight)}: greedy, beam K, and beam K with
    the LM where ``checkpoint_dir/language/`` holds one."""
    from rnn_speech_tpu_torch import cli

    forward = cli.build_forward(config, char_map, device)
    lm = cli.load_lm_stepper(config, char_map, lm_weight, device)
    modes = {
        "greedy": (1, None, 0.0),
        f"beam{beam_width}": (beam_width, None, 0.0),
    }
    if lm is not None:
        modes[f"beam{beam_width}_lm"] = (beam_width, lm, lm_weight)
    return forward, modes


def decode_texts(forward, items, mode, char_map, decode_batch: int, max_samples: int,
                 device=None):
    """The transcripts of ``items`` [(normalized signal, truth)] in one
    decode ``mode`` (``decode_modes``' (width, lm, weight)): batches of
    ``decode_batch`` rows, every row padded to the one audio width
    ``max_samples`` (each clip cut to it), rows past the last clip empty."""
    import torch

    from rnn_speech_tpu_torch import cli

    dev = resolve_device(device)
    model_cfg, fe, params = forward
    width, lm, lm_weight = mode
    hyps = []
    for start in range(0, len(items), decode_batch):
        batch = [sig[:max_samples] for sig, _ in items[start: start + decode_batch]]
        audio = np.zeros((decode_batch, max_samples), np.float32)
        lengths = np.zeros((decode_batch,), np.int32)
        for i, sig in enumerate(batch):
            audio[i, : len(sig)] = sig
            lengths[i] = len(sig)
        with torch.no_grad():
            labels, lens = cli.infer(params, model_cfg, fe, to_device(audio, dev),
                                     to_device(lengths, dev), width, lm, lm_weight)
        labels, lens = labels.cpu().numpy(), lens.cpu().numpy()
        hyps += [char_map.decode(list(labels[b, : int(lens[b])]))
                 for b in range(len(batch))]
    return hyps


def decode_table(config, char_map, eval_points, beam_width: int,
                 lm_weight: float, decode_batch: int, device=None):
    """Held-out WER/CER for greedy / beam / beam+LM at each sweep level.

    ``eval_points``: {noise_level: [(normalized_signal, truth)]}.  All
    clips pad to one fixed audio width (``cli.max_samples_for``), in
    batches of ``decode_batch`` rows, as the JAX tool pads them.  Per mode
    and level the entry carries the reference-convention per-clip mean
    WER/CER (x100), corpus-level totals (word/char edits over word/char
    counts) and a bootstrap CI; the return also includes a PAIRED
    beam-vs-greedy delta per level (resampling per-clip WER
    differences)."""
    from rnn_speech_tpu_torch import cli
    from rnn_speech_tpu_torch.train.metrics import calculate_cer, calculate_wer

    forward, modes = decode_modes(config, char_map, beam_width, lm_weight, device)
    max_samples = cli.max_samples_for(config)

    sweep, paired = {}, {}
    for level, items in eval_points.items():
        table, per_clip_wer = {}, {}
        for name, mode in modes.items():
            t0 = time.time()
            hyps = decode_texts(forward, items, mode, char_map, decode_batch,
                                max_samples, device)
            seconds = time.time() - t0
            wers, cers = [], []
            w_edits = c_edits = n_words_tot = n_chars_tot = 0
            for (_, truth), hyp in zip(items, hyps):
                truth_norm = truth.lower()
                hyp_norm = hyp.lower().strip()
                we = calculate_wer(truth_norm, hyp_norm)
                ce = calculate_cer(truth_norm, hyp_norm)
                n_words = max(len(truth_norm.split()), 1)
                n_chars = max(len(truth_norm), 1)
                wers.append(min(1.0, we / n_words))
                cers.append(min(1.0, ce / n_chars))
                w_edits += int(we)
                c_edits += int(ce)
                n_words_tot += n_words
                n_chars_tot += n_chars
            per_clip_wer[name] = np.asarray(wers)
            table[name] = {
                "wer": round(100.0 * float(np.mean(wers)), 2),
                "wer_ci95": _bootstrap_ci(wers),
                "cer": round(100.0 * float(np.mean(cers)), 2),
                "corpus_wer": round(100.0 * w_edits / n_words_tot, 2),
                "clips": len(wers),
                "n_words": n_words_tot,
                "n_chars": n_chars_tot,
                "word_edits": w_edits,
                "char_edits": c_edits,
                "decode_seconds": round(seconds, 1),
            }
            print(f"decode[noise={level}][{name}]: "
                  f"WER {table[name]['wer']}% CER {table[name]['cer']}% "
                  f"({w_edits}/{n_words_tot} word edits)", flush=True)
        beam_key = f"beam{beam_width}"

        def _paired(key, seed):
            # Positive delta = that decoder beats greedy.
            deltas = per_clip_wer["greedy"] - per_clip_wer[key]
            rng = np.random.default_rng(seed)
            idx = rng.integers(0, len(deltas), (1000, len(deltas)))
            boot = deltas[idx].mean(axis=1)
            return {
                "delta_wer": round(100.0 * float(deltas.mean()), 2),
                "delta_wer_ci95": [
                    round(100.0 * float(np.percentile(boot, 2.5)), 2),
                    round(100.0 * float(np.percentile(boot, 97.5)), 2),
                ],
                "delta_word_edits": int(table["greedy"]["word_edits"]
                                        - table[key]["word_edits"]),
            }

        paired[level] = _paired(beam_key, 1)
        lm_key = f"{beam_key}_lm"
        if lm_key in per_clip_wer:
            # Beam WITH shallow fusion is the production quality path; its
            # paired delta is the claim that matters.
            paired[level]["lm"] = _paired(lm_key, 2)
        sweep[str(level)] = table
    return sweep, {str(k): v for k, v in paired.items()}


def streaming_table(config, char_map, items, beam_width: int,
                    lm_weight: float, chunk_seconds_list,
                    max_clips: int = 24, device=None):
    """Chunked-vs-one-shot agreement + streaming WER on trained weights.

    One ``cli.StreamingTranscriber`` per mode (``reset()`` between
    utterances): each clip is transcribed one-shot (single feed + finish)
    as the whole-clip reference, then re-fed in fixed chunks at each
    chunk size — the chunked text must reproduce the one-shot text (the
    decoders' carry contract)."""
    from rnn_speech_tpu_torch import cli
    from rnn_speech_tpu_torch.train.metrics import calculate_wer

    items = items[:max_clips]
    out = {}
    mode_specs = {"greedy": (1, None, 0.0)}
    lm = cli.load_lm_stepper(config, char_map, lm_weight, device)
    if lm is not None:
        mode_specs[f"beam{beam_width}_lm"] = (beam_width, lm, lm_weight)
    for mode, (width, lm_arg, w) in mode_specs.items():
        tr = cli.StreamingTranscriber(
            config, char_map, chunk_seconds=max(chunk_seconds_list),
            beam_width=width, lm=lm_arg, lm_weight=w, device=device,
        )
        oneshot_texts, oneshot_wers = [], []
        for sig, truth in items:
            tr.reset()
            text = tr.feed(sig) + tr.finish()
            oneshot_texts.append(text)
            truth_norm = truth.lower()
            n_words = max(len(truth_norm.split()), 1)
            oneshot_wers.append(min(1.0, calculate_wer(
                truth_norm, text.lower().strip()) / n_words))
        chunks = {}
        for cs in chunk_seconds_list:
            step = max(1, int(round(cs * tr.sample_rate)))
            agree, wers = 0, []
            for (sig, truth), ref_text in zip(items, oneshot_texts):
                tr.reset()
                pieces = [
                    tr.feed(sig[off: off + step])
                    for off in range(0, len(sig), step)
                ]
                text = "".join(pieces) + tr.finish()
                agree += int(text == ref_text)
                truth_norm = truth.lower()
                n_words = max(len(truth_norm.split()), 1)
                wers.append(min(1.0, calculate_wer(
                    truth_norm, text.lower().strip()) / n_words))
            chunks[str(cs)] = {
                "agreement_pct": round(100.0 * agree / len(items), 1),
                "clips": len(items),
                "wer": round(100.0 * float(np.mean(wers)), 2),
            }
            print(f"streaming[{mode}][chunk={cs}s]: "
                  f"{chunks[str(cs)]['agreement_pct']}% agreement, "
                  f"WER {chunks[str(cs)]['wer']}%", flush=True)
        out[mode] = {
            "oneshot_wer": round(100.0 * float(np.mean(oneshot_wers)), 2),
            "chunks": chunks,
        }
    return out


def _stage(stage_seconds: dict, name: str, t0: float) -> None:
    stage_seconds[name] = round(time.perf_counter() - t0, 3)
    print(f"stage[{name}]: {stage_seconds[name]} s", flush=True)


def run(workdir: str, out_path, *, clips: int, test_clips: int, layers: int,
        hidden: int, batch: int, max_steps: int, steps_per_checkpoint: int,
        lr: float, beam_width: int, lm_weight: float, seed: int = 0,
        sr: int = 0, train_noise=(300.0, 3600.0),
        eval_noise_levels=(900.0, 2400.0, 4800.0),
        max_input_seq_length: int = 600, max_target_seq_length: int = 80,
        lm_layers: int = 1, lm_hidden: int = 256, lm_steps: int = 400,
        decode_batch: int = 10, frame_stack: int = 1,
        artifact_dir: str = "", weights_dtype: str = "bfloat16",
        streaming_chunk_seconds=(0.4, 1.2), streaming_max_clips: int = 24,
        run_streaming: bool = True, resume: bool = False,
        headline_noise: float = 0.0, device=None) -> dict:
    from rnn_speech_tpu_torch.config import Config, LmConfig, TpuConfig
    from rnn_speech_tpu_torch.models.recognizer import SpeechRecognizer
    from rnn_speech_tpu_torch.train import checkpoint as ckpt_mod
    from rnn_speech_tpu_torch.train import lm_loop, loop
    from rnn_speech_tpu_torch.train.pipeline import PipelineConfig

    device = resolve_device(device)      # no card, no run: before any render
    # The held-out renders are fed RAW into the inference frontend
    # (decode_table/streaming_table never resample), while training clips
    # pass through audio_io.load(sr=pipeline rate): the corpus must render
    # at the pipeline rate.
    pipeline_sr = PipelineConfig(batch_size=1).sample_rate
    sr = sr or pipeline_sr
    if sr != pipeline_sr:
        raise ValueError(
            f"corpus sample rate {sr} != inference pipeline rate "
            f"{pipeline_sr}: held-out renders are decoded without "
            "resampling, so the rates must match")

    eval_noise_levels = sorted(float(x) for x in eval_noise_levels)
    headline_noise = float(
        headline_noise or eval_noise_levels[len(eval_noise_levels) // 2]
    )
    if headline_noise not in eval_noise_levels:
        raise ValueError(f"headline_noise {headline_noise} not in sweep "
                         f"{eval_noise_levels}")
    stage_seconds, corpus_times = {}, {}
    train_set, loop_test_set, held_out = build_corpus(
        workdir, clips, test_clips, seed, sr, train_noise, headline_noise,
        timings=corpus_times,
    )
    stage_seconds.update({k: round(v, 3) for k, v in corpus_times.items()})
    char_map = SpeechRecognizer("english").get_char_map()
    tb_dir = os.path.join(workdir, "tb")
    os.makedirs(tb_dir, exist_ok=True)
    config = Config(
        num_layers=layers, hidden_size=hidden, batch_size=batch,
        mini_batch_size=1, learning_rate=lr, lr_decay_factor=0.33,
        grad_clip=5.0, signal_processing="fbank",
        dropout_input_keep_prob=0.9, dropout_output_keep_prob=0.6,
        steps_per_checkpoint=steps_per_checkpoint,
        steps_per_evaluation=steps_per_checkpoint,
        checkpoint_dir=os.path.join(workdir, "ckpt"),
        tensorboard_dir=tb_dir,
        max_input_seq_length=max_input_seq_length,
        max_target_seq_length=max_target_seq_length,
        rnn_state_reset_ratio=1.0, dataset_size_ordering="False",
        lm=LmConfig(num_layers=lm_layers, hidden_size=lm_hidden,
                    batch_size=16),
        tpu=TpuConfig(frame_stack=frame_stack),
    )

    # --- 2. one continuous acoustic session -----------------------------
    t0 = time.perf_counter()
    if resume:
        # Crash recovery: a finished training session already checkpointed
        # under workdir/ckpt and logged its curves — the corpus above was
        # rebuilt bit-identically; pick up at the export/decode stages.
        if ckpt_mod.latest_path(os.path.join(config.checkpoint_dir,
                                             "acoustic")) is None:
            raise RuntimeError(
                f"--resume: no acoustic checkpoint under "
                f"{config.checkpoint_dir!r}")
        train_seconds = _events_train_seconds(tb_dir, "flagship")
    else:
        loop.train_acoustic(
            config, list(train_set), list(loop_test_set), char_map,
            max_steps=max_steps, tb_name="flagship", device=device,
        )
        train_seconds = time.perf_counter() - t0
    _stage(stage_seconds, "train", t0)

    curves = read_curves(tb_dir, "flagship")
    lr_curve = curves.get("learning_rate", [])
    lr_values = [v for _, v in lr_curve]
    n_decays = sum(
        1 for a, b in zip(lr_values, lr_values[1:]) if b < a * 0.99
    )

    # --- 3. char-LM on the training transcripts -------------------------
    t0 = time.perf_counter()
    if resume:
        lm_path = ckpt_mod.latest_path(
            os.path.join(config.checkpoint_dir, "language"))
        lm_step = (int(os.path.basename(lm_path).rsplit("-", 1)[1]
                       .split(".")[0]) if lm_path else 0)
    else:
        train_texts = [label for _, label, _ in train_set]
        _, lm_step = lm_loop.train_language(
            config, train_texts, char_map, max_steps=lm_steps, device=device,
        )
    _stage(stage_seconds, "lm", t0)

    # --- 4. export the bundle, then decode FROM it -----------------------
    t0 = time.perf_counter()
    artifact_dir = artifact_dir or os.path.join(workdir, "bundle")
    copied = export_weights(artifact_dir, config, weights_dtype)
    bundle_config = config.replace(checkpoint_dir=artifact_dir,
                                   tensorboard_dir="")
    _stage(stage_seconds, "export", t0)

    t0 = time.perf_counter()
    eval_points = noisy_points(held_out, eval_noise_levels, seed)
    sweep, paired = decode_table(
        bundle_config, char_map, eval_points, beam_width, lm_weight,
        decode_batch, device,
    )
    _stage(stage_seconds, "decode", t0)

    # --- 5. streaming at flagship scale on the trained bundle -----------
    t0 = time.perf_counter()
    streaming = {}
    if run_streaming:
        streaming = streaming_table(
            bundle_config, char_map, eval_points[headline_noise],
            beam_width, lm_weight, list(streaming_chunk_seconds),
            max_clips=streaming_max_clips, device=device,
        )
    _stage(stage_seconds, "streaming", t0)

    headline = sweep[str(headline_noise)]
    greedy_wer = headline["greedy"]["wer"]
    beam_key = f"beam{beam_width}"
    n_words = headline["greedy"]["n_words"]
    one_word_pct = 100.0 / max(n_words, 1)
    result = {
        "task": "flagship-shape continuous accuracy run "
                "(coarticulated syllables corpus, held-out split, "
                "SNR sweep decoded from the exported bundle)",
        "config": {
            "clips": clips, "test_clips": test_clips,
            "train": len(train_set), "test": len(held_out),
            "layers": layers, "hidden": hidden, "batch": batch,
            "features": "fbank-120", "lr": lr, "seed": seed,
            "train_noise": list(train_noise),
            "eval_noise_levels": eval_noise_levels,
            "headline_noise_std": headline_noise,
            "max_steps": max_steps,
            "steps_per_checkpoint": steps_per_checkpoint,
            "beam_width": beam_width, "lm_weight": lm_weight,
            "weights_dtype": weights_dtype,
            "lm": {"layers": lm_layers, "hidden": lm_hidden,
                   "steps": lm_step},
            "train_seconds": round(train_seconds, 1),
            "device": str(device),
        },
        "curves": {
            "train_error_rate": curves.get("train/mean_error_rate", []),
            "eval_error_rate": curves.get("test/mean_error_rate", []),
            "learning_rate": lr_curve,
        },
        "lr_decays_engaged": n_decays,
        "headline_noise_std": headline_noise,
        "wer_table": headline,
        "noise_sweep": sweep,
        "beam_vs_greedy_paired": paired,
        "decode_delta_vs_greedy": {
            name: round(greedy_wer - entry["wer"], 2)
            for name, entry in headline.items() if name != "greedy"
        },
        # True only where pure beam beats greedy OUTSIDE the one-word
        # floor at that level.
        "beam_improves_beyond_floor": {
            level: bool(
                table["greedy"]["wer"] - table[beam_key]["wer"]
                > 100.0 / max(table["greedy"]["n_words"], 1)
            )
            for level, table in sweep.items()
        },
        "one_word_wer_pct": round(one_word_pct, 3),
        "streaming": streaming,
        "artifact_dir": artifact_dir,
        "stage_seconds": stage_seconds,
    }
    if out_path:
        os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
        with open(out_path, "w") as fh:
            json.dump(result, fh, indent=2)
        print(f"Wrote {out_path}")
    export_readme(artifact_dir, result, copied, weights_dtype)
    return result


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--out", default=DEFAULT_OUT)
    parser.add_argument("--workdir", default=None)
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                        help="device to train and decode on (default cuda)")
    parser.add_argument("--clips", type=int, default=1100,
                        help="training sentences (2-5 words each)")
    parser.add_argument("--test_clips", type=int, default=160,
                        help="held-out sentences (>=500 words at default)")
    parser.add_argument("--layers", type=int, default=3)
    parser.add_argument("--hidden", type=int, default=1024)
    parser.add_argument("--batch", type=int, default=32)
    parser.add_argument("--max_steps", type=int, default=3000)
    parser.add_argument("--steps_per_checkpoint", type=int, default=100)
    parser.add_argument("--lr", type=float, default=1e-3)
    parser.add_argument("--beam_width", type=int, default=16)
    parser.add_argument("--lm_weight", type=float, default=0.4)
    parser.add_argument("--lm_steps", type=int, default=400)
    parser.add_argument("--train_noise", type=float, nargs=2,
                        default=(300.0, 3600.0),
                        help="log-uniform per-clip training noise range")
    parser.add_argument("--eval_noise_levels", type=float, nargs="+",
                        default=(900.0, 2400.0, 4800.0))
    parser.add_argument("--headline_noise", type=float, default=0.0,
                        help="which sweep level is the headline wer_table "
                             "(0 = the middle level); on --resume keep it "
                             "at the ORIGINAL run's value so the corpus "
                             "rng replays exactly")
    parser.add_argument("--resume", action="store_true",
                        help="skip training: reuse checkpoints + curves "
                             "already under --workdir (crash recovery for "
                             "the multi-stage protocol)")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--decode_batch", type=int, default=10)
    parser.add_argument("--no_streaming", action="store_true")
    parser.add_argument("--streaming_max_clips", type=int, default=24)
    parser.add_argument("--artifact_dir", default="",
                        help="export the trained_models/-style bundle (bf16 "
                             "checkpoints + hyperparams + README) here; "
                             "default: <workdir>/bundle")
    args = parser.parse_args(argv)

    if args.resume and not args.workdir:
        parser.error("--resume requires --workdir")
    workdir = args.workdir or tempfile.mkdtemp(prefix="rst_flagship_")
    result = run(
        workdir, args.out, clips=args.clips, test_clips=args.test_clips,
        layers=args.layers, hidden=args.hidden, batch=args.batch,
        max_steps=args.max_steps,
        steps_per_checkpoint=args.steps_per_checkpoint, lr=args.lr,
        beam_width=args.beam_width, lm_weight=args.lm_weight,
        lm_steps=args.lm_steps, train_noise=tuple(args.train_noise),
        eval_noise_levels=tuple(args.eval_noise_levels), seed=args.seed,
        decode_batch=args.decode_batch, artifact_dir=args.artifact_dir,
        run_streaming=not args.no_streaming,
        streaming_max_clips=args.streaming_max_clips,
        resume=args.resume, headline_noise=args.headline_noise,
        device=args.device,
    )
    print(json.dumps(result["noise_sweep"], indent=2))
    print(json.dumps(result["beam_vs_greedy_paired"], indent=2))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
