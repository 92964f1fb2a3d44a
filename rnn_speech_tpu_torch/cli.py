"""Command line of the port: train, evaluate, transcribe and stream on the GPU.

    python -m rnn_speech_tpu_torch.cli --train_acoustic | --train_language |
        --file F | --record | --evaluate | --generate_text
        [--config INI] [--device cuda|cpu] [--beam_width K] [--lm_weight W]
        [--tb_name N] [--max_epoch E] [--learn_rate LR] [--max_steps S]
        [--timeline] [--mesh_data D] [--mesh_model M]

    python -m torch.distributed.run --nproc_per_node N \
        -m rnn_speech_tpu_torch.cli --train_acoustic --mesh_data 0 ...

Counterpart of ``rnn_speech_tpu/cli.py`` with the same ini: ``--file``
transcribes one clip (``checkpoint_dir`` names the bundle whose
``acoustic/`` checkpoint is restored), ``--train_acoustic`` trains from
the ``[training]`` corpora (``train/loop.py``; checkpoints under
``checkpoint_dir/acoustic/``, resumed at their step and learning rate),
``--evaluate`` prints the mean per-utterance WER and CER over
``test_dataset_dirs``, ``--train_language`` trains the char LM
(``train/lm_loop.py``; ``checkpoint_dir/language/``) on the
``text_corpus``, else the acoustic transcripts, else four built-in
sentences, ``--generate_text`` continues "O" by 10 characters of the
LM, and ``--record`` transcribes the microphone chunk by chunk
(``StreamingTranscriber``; it needs ``pyaudio``, and without it logs and
returns 1).  Decoding is the prefix beam search at ``--beam_width`` (16
by default, as in the JAX CLI), its best beam, or greedy CTC at width 1,
after the same on-device fbank/MFCC frontend and audio-width bucketing;
``--lm_weight`` above 0 adds the char LM by shallow fusion when a
language checkpoint exists (without one it warns and decodes AM-only, as
the JAX CLI does).  The LM's widths are ``config.lm_resolved()``'s, after
the config is resolved against the checkpoint's ``hyperparams.json``.
Everything runs on ``cuda`` unless ``--device cpu`` is given.

``transcribe(params, cfg, audio, lengths)`` is the library entry: raw
audio rows (B, S) in, one string per row out.  The module imports
``torch`` only inside its functions: the input pipeline's spawned decode
workers import the main module, which is this one under ``python -m``.

Multi-GPU: one process a GPU, started by ``torch.distributed.run`` or
with ``RST_MULTIHOST=1`` and ``RST_COORD_ADDR``, ``RST_NUM_PROCESSES``,
``RST_PROCESS_ID`` (``parallel/launch.py``; bad values exit with the JAX
CLI's message).  ``--mesh_data`` / ``--mesh_model`` (else ``[tpu]
mesh_data`` / ``mesh_model``; data 0 = every remaining rank) lay the ranks
out as ("data", "model"): ``--train_acoustic`` then runs the sharded step
(``parallel/sharding.py``), and ``--evaluate`` decodes each rank's
``shard_for_host`` slice of the test set and all-reduces the WER/CER sums
once at the end; only rank 0 prints.  A mesh larger than the ranks there
are raises ``ValueError`` naming ``torch.distributed.run``: it never
quietly runs on one card.  ``--timeline`` traces training steps 2 and 3
with ``torch.profiler`` into ``tensorboard_dir`` (``train/loop.py``); it
changes nothing in ``--evaluate``, as in the JAX CLI.
"""

from __future__ import annotations

import argparse
import logging
import sys
from typing import List, Optional

import numpy as np

from rnn_speech_tpu_torch import resolve_device

logger = logging.getLogger(__name__)

SAMPLE_RATE = 22050
DEFAULT_BEAM_WIDTH = 16    # the JAX CLI's --beam_width default

PENDING_WINDOW = 4         # --evaluate batches in flight before scoring


def max_samples_for(config) -> int:
    """Raw-sample budget covering max_input_seq_length frames."""
    from rnn_speech_tpu_torch import frontend

    step = int(round(frontend.FRAME_STRIDE * SAMPLE_RATE))
    length = int(round(frontend.FRAME_SIZE * SAMPLE_RATE))
    return config.max_input_seq_length * step + length


def build_forward(config, char_map, device=None):
    """(model config, frontend, params) for inference, the parameters
    restored from ``checkpoint_dir/acoustic/`` when a bundle is there."""
    import torch

    from rnn_speech_tpu_torch.models import acoustic
    from rnn_speech_tpu_torch.ops.frontend import DeviceFrontend
    from rnn_speech_tpu_torch.train import checkpoint

    dev = resolve_device(device)
    fe = DeviceFrontend(config.signal_processing, sr=SAMPLE_RATE,
                        max_samples=max_samples_for(config), device=dev)
    compute_dtype = (torch.bfloat16 if config.tpu.compute_dtype == "bfloat16"
                     else torch.float32)
    model_cfg = acoustic.AcousticConfig(
        num_layers=config.num_layers,
        hidden_size=config.hidden_size,
        input_dim=fe.feature_size,
        num_labels=len(char_map),
        normalization=config.batch_normalization,
        compute_dtype=compute_dtype,
        use_kernels=config.tpu.use_pallas_lstm,
        frame_stack=config.tpu.frame_stack,
        wavefront=config.tpu.wavefront,
    )
    params = acoustic.init_params(torch.Generator().manual_seed(0), model_cfg, dev)
    restored = checkpoint.restore(config.checkpoint_dir + "/acoustic/", params)
    if restored is not None:
        params = restored[0]
    return model_cfg, fe, params


def load_lm_stepper(config, char_map, lm_weight: float, device=None):
    """(init, advance) of the char LM for shallow fusion, on ``device``,
    or None: ``lm_weight`` must be above 0 and ``checkpoint_dir/language/``
    must hold a checkpoint; without one this warns and decoding stays
    AM-only."""
    import torch

    from rnn_speech_tpu_torch.models import language
    from rnn_speech_tpu_torch.train import checkpoint
    from rnn_speech_tpu_torch.train.lm_loop import language_config

    if lm_weight <= 0.0:
        return None
    cfg = language_config(config, char_map)
    params = language.init_params(torch.Generator().manual_seed(0), cfg,
                                  resolve_device(device))
    restored = checkpoint.restore(config.checkpoint_dir + "/language/", params)
    if restored is None:
        logger.warning("--lm_weight set but no language checkpoint found; decoding AM-only")
        return None
    return language.stepper(restored[0], cfg)


def infer(params, model_cfg, fe, audio, lengths,
          beam_width: int = 1, lm=None, lm_weight: float = 0.0):
    """Raw audio (B, S) -> (labels (B, U) padded with -1, lengths (B,)):
    frontend, forward with zero state, then greedy decode (``beam_width``
    1, the default: the eval program of ``bench.py``) or the beam search's
    best beam, with the LM stepper ``lm`` at ``lm_weight`` (``_make_infer``
    of the JAX CLI)."""
    from rnn_speech_tpu_torch.models import acoustic
    from rnn_speech_tpu_torch.ops import decode

    feats_bm, frame_lengths = fe(audio, lengths)
    states = acoustic.zero_state(model_cfg, feats_bm.shape[0], device=audio.device)
    logits, _ = acoustic.forward(
        params, model_cfg, feats_bm.transpose(0, 1), frame_lengths, states
    )
    out_lengths = acoustic.output_lengths(model_cfg, frame_lengths)
    if beam_width > 1:
        labels, label_lengths, _ = decode.beam_search_decode(
            logits, out_lengths, beam_width=beam_width, lm=lm, lm_weight=lm_weight)
        return labels[:, 0], label_lengths[:, 0]
    return decode.greedy_decode(logits, out_lengths)


def transcribe(params, cfg, audio, lengths, *, frontend=None, char_map=None,
               device=None, beam_width: int = DEFAULT_BEAM_WIDTH, lm=None,
               lm_weight: float = 0.0) -> List[str]:
    """Transcripts of raw audio rows: the best beam of the beam search at
    ``beam_width`` (16 by default, the CLI's), greedy at 1; ``lm`` (a
    ``models/language.stepper`` on the same device) joins the beam search
    by shallow fusion at ``lm_weight``.

    ``audio`` (B, S) float samples in [-1, 1] at 22050 Hz, ``lengths`` (B,)
    valid samples per row; ``cfg`` the AcousticConfig of ``params``, which
    must already lie on ``device`` (default cuda).  ``frontend`` defaults
    to the fbank (120-dim input) or MFCC (20-dim) featurizer."""
    import torch

    from rnn_speech_tpu_torch.charmap import get_char_map
    from rnn_speech_tpu_torch.ops.frontend import DeviceFrontend

    dev = resolve_device(device)
    w = params["input"]["w"]
    if w.device.type != dev.type:
        raise ValueError(f"params are on {w.device}, transcribe runs on {dev}")
    audio = torch.as_tensor(np.asarray(audio, np.float32), device=dev)
    lengths = torch.as_tensor(np.asarray(lengths, np.int32), device=dev)
    if frontend is None:
        kind = "fbank" if cfg.input_dim == 120 else "mfcc"
        frontend = DeviceFrontend(kind, sr=SAMPLE_RATE,
                                  max_samples=audio.shape[1], device=dev)
    char_map = char_map or get_char_map("english")
    with torch.no_grad():
        labels, out_lengths = infer(params, cfg, frontend, audio, lengths, beam_width,
                                    lm, lm_weight)
    labels = labels.cpu().numpy()
    out_lengths = out_lengths.cpu().numpy()
    return [char_map.decode(list(labels[b, : int(out_lengths[b])]))
            for b in range(labels.shape[0])]


def process_file(config, char_map, file_path, device,
                 beam_width: int = DEFAULT_BEAM_WIDTH, lm_weight: float = 0.0) -> int:
    from rnn_speech_tpu_torch import audio_io

    model_cfg, fe, params = build_forward(config, char_map, device)
    max_samples = max_samples_for(config)
    sig, _sr = audio_io.load(file_path, sr=SAMPLE_RATE)
    if len(sig) > max_samples:
        logger.warning("File too long")
        return 1
    # Pad to the smallest audio-width bucket covering the clip, not the
    # full max-length grid.
    bucket_count = max(config.tpu.bucket_count, 1)
    unit = -(-max_samples // bucket_count)
    width = min(max(1, -(-len(sig) // unit)) * unit, max_samples)
    padded = np.zeros((1, width), np.float32)
    padded[0, : len(sig)] = sig
    lm = load_lm_stepper(config, char_map, lm_weight, device)
    text = transcribe(params, model_cfg, padded, [len(sig)], frontend=fe,
                      char_map=char_map, device=device, beam_width=beam_width,
                      lm=lm, lm_weight=lm_weight)[0]
    print(text)
    return 0


def _mesh_shape(config, prog):
    """(data, model) from the flags, else the ``[tpu]`` section."""
    data = prog["mesh_data"] if prog["mesh_data"] is not None else config.tpu.mesh_data
    model = (prog["mesh_model"] if prog["mesh_model"] is not None
             else config.tpu.mesh_model)
    return data, model


def _make_mesh(data: int, model: int):
    """The mesh the shape asks for, or None for the single-device path:
    without a process group only 1x1 runs (anything larger raises
    ``ValueError`` naming ``torch.distributed.run``), and under one an
    explicit 1x1 stays unsharded, as the JAX CLI's does."""
    import torch.distributed as dist

    from rnn_speech_tpu_torch.parallel import launch
    from rnn_speech_tpu_torch.parallel import mesh as mesh_mod

    world, _ = launch.world_and_rank()
    mesh_mod.mesh_shape(data, model, world)          # raises for a wrong size
    if (data, model) == (1, 1) or not dist.is_initialized():
        return None
    return mesh_mod.make_mesh(data, model)


def train_acoustic(config, prog, char_map, device) -> int:
    """Train the acoustic model on the ``[training]`` corpora."""
    from rnn_speech_tpu_torch.models.recognizer import SpeechRecognizer
    from rnn_speech_tpu_torch.train import loop

    ordered = config.dataset_size_ordering in ("True", "First_run_only")
    train_set, test_set = SpeechRecognizer.load_acoustic_dataset(
        config.training_dataset_dirs, config.test_dataset_dirs,
        config.training_filelist_cache, ordered, config.train_frac)
    loop.train_acoustic(
        config, train_set, test_set, char_map,
        max_epoch=prog["max_epoch"], learn_rate_override=prog["learn_rate"],
        tb_name=prog["tb_name"], timeline=prog["timeline"],
        max_steps=prog["max_steps"], mesh=_make_mesh(*_mesh_shape(config, prog)),
        device=device)
    return 0


def evaluate(config, prog, char_map, device) -> int:
    """Mean per-utterance WER and CER over ``test_dataset_dirs``: clips in
    duration order, batches of ``batch_size`` padded to the smallest
    audio-width bucket that covers them (at most 2 buckets for the beam
    search), up to ``PENDING_WINDOW`` batches queued on the device before
    the oldest is scored on the host.

    Under a process group of more than one rank the ranks must form a mesh
    (``--mesh_data 0``): each decodes its ``shard_for_host`` slice in
    batches of ``batch_size // world`` rows, with no per-batch collective
    (greedy and beam decoding are row-independent), the WER/CER sums and
    counts are all-reduced once at the end, and only rank 0 prints: the
    single-process numbers.  Batch normalisation would normalise over each
    rank's rows instead of the whole batch, so it raises there."""
    import torch

    from rnn_speech_tpu_torch import corpus
    from rnn_speech_tpu_torch.parallel import launch, lockstep
    from rnn_speech_tpu_torch.parallel import mesh as mesh_mod
    from rnn_speech_tpu_torch.runtime import loader as native_loader
    from rnn_speech_tpu_torch.train import loop
    from rnn_speech_tpu_torch.train import metrics as metrics_mod
    from rnn_speech_tpu_torch.train import pipeline as pipe_mod

    if config.test_dataset_dirs is None:
        logger.fatal("Setting test_dataset_dirs in config file is mandatory "
                     "for evaluation mode")
        return 1
    test_set = corpus.DataProcessor(config.test_dataset_dirs).get_dataset()
    logger.info("Using %d size of test set", len(test_set))
    if not test_set:
        logger.fatal("No files in test set during an evaluation mode")
        return 1
    # Duration order keeps each batch length-homogeneous, so the bucketed
    # padding below cuts real compute.
    test_set = sorted(test_set, key=lambda item: item[2])

    n_proc, rank = launch.world_and_rank()
    mesh_mod.mesh_shape(*_mesh_shape(config, prog), n_proc)   # the mesh spans the ranks
    if n_proc > 1:
        if config.batch_size % n_proc:
            logger.fatal("batch_size %d not divisible by %d processes",
                         config.batch_size, n_proc)
            return 1
        if config.batch_normalization:
            raise ValueError(
                "batch_normalization normalises over the rows a rank sees, so a "
                "sharded --evaluate would print other numbers than one process; "
                "evaluate such a model on one rank")
        test_set = pipe_mod.shard_for_host(test_set)

    dev = resolve_device(device)
    host_B = config.batch_size // n_proc
    model_cfg, fe, params = build_forward(config, char_map, dev)
    max_samples = max_samples_for(config)
    beam_width = prog["beam_width"]
    bucket_count = max(config.tpu.bucket_count, 1)
    if beam_width > 1 and bucket_count > 2:
        logger.info("Beam evaluation: capping audio-width buckets at 2 "
                    "(bucket_count %d)", bucket_count)
        bucket_count = 2
    unit = -(-max_samples // bucket_count)
    lm = load_lm_stepper(config, char_map, prog["lm_weight"], dev)

    wer_list, cer_list = [], []
    batch_audio, batch_lengths, batch_truth = [], [], []
    pending_batches = []

    def score_oldest():
        labels, lab_lens, truths = pending_batches.pop(0)
        labels = labels.cpu().numpy()
        lab_lens = lab_lens.cpu().numpy()
        for j, truth in enumerate(truths):
            if not truth:
                continue
            text = char_map.decode(list(labels[j, : int(lab_lens[j])]))
            nb_words = len(truth.split())
            nb_chars = len(truth.replace(" ", ""))
            wer_list.append(metrics_mod.calculate_wer(text, truth) / float(nb_words))
            cer_list.append(metrics_mod.calculate_cer(text, truth) / float(nb_chars))

    def flush():
        if not batch_audio:
            return
        longest = max(batch_lengths)
        width = min(max(1, -(-longest // unit)) * unit, max_samples)
        audio = np.zeros((host_B, width), np.float32)
        lengths = np.zeros((host_B,), np.int32)
        for i, (a, n) in enumerate(zip(batch_audio, batch_lengths)):
            audio[i, :n] = a[:n]
            lengths[i] = n
        with torch.no_grad():
            labels, lab_lens = infer(params, model_cfg, fe, loop.to_device(audio, dev),
                                     loop.to_device(lengths, dev), beam_width, lm,
                                     prog["lm_weight"])
        pending_batches.append((labels, lab_lens, list(batch_truth)))
        if len(pending_batches) > PENDING_WINDOW:
            score_oldest()
        batch_audio.clear()
        batch_lengths.clear()
        batch_truth.clear()

    # Decode through the native async loader, in the test set's order, so
    # container decode and resampling overlap with inference on the device.
    # The loader truncates at max_samples + 1, so a clip delivered longer
    # than max_samples is exactly the "sample too long" case.
    with native_loader.NativeAudioLoader(
        [item[0] for item in test_set],
        max_samples=max_samples + 1,
        target_rate=SAMPLE_RATE,
        n_threads=pipe_mod.default_decode_threads(),
        capacity=max(4 * host_B, 8),
    ) as clips:
        for idx, sig, rc in clips:
            file, label, _ = test_set[idx]
            if sig is None:
                logger.warning("Skipping unreadable %s: native decoder rc %d", file, rc)
                continue
            if len(sig) > max_samples or len(label) > config.max_target_seq_length:
                logger.warning("Warning - sample too long : %s (input : %d)",
                               file, len(sig))
                continue
            batch_audio.append(sig)
            batch_lengths.append(len(sig))
            batch_truth.append(label)
            if len(batch_audio) == host_B:
                flush()
    flush()
    while pending_batches:
        score_oldest()

    wer_sum, cer_sum, count = float(sum(wer_list)), float(sum(cer_list)), len(wer_list)
    if n_proc > 1:
        wer_sum, cer_sum, count = lockstep.all_reduce_values([wer_sum, cer_sum, count])
    if not count:
        logger.fatal("No evaluable files")
        return 1
    if rank == 0:
        print("Resulting WER : {0:.3g} %".format(wer_sum * 100 / count))
        print("Resulting CER : {0:.3g} %".format(cer_sum * 100 / count))
    return 0


def train_language(config, prog, char_map, device) -> int:
    """Train the char LM (``train/lm_loop.py``).  Its corpus, in order of
    preference: the ``[lm_network_params] text_corpus`` file (a sentence a
    line), the transcripts of the acoustic training set, four built-in
    sentences."""
    from rnn_speech_tpu_torch.train import lm_loop

    lm_cfg = config.lm_resolved()
    texts = []
    if lm_cfg.text_corpus:
        try:
            with open(lm_cfg.text_corpus) as fh:
                texts = [line.strip() for line in fh if line.strip()]
        except OSError as exc:
            logger.warning("Cannot read text corpus (%s); falling back", exc)
    if not texts and config.training_dataset_dirs:
        try:
            from rnn_speech_tpu_torch.models.recognizer import SpeechRecognizer

            train_set, _ = SpeechRecognizer.load_acoustic_dataset(
                config.training_dataset_dirs,
                training_filelist_cache=config.training_filelist_cache)
            texts = [label for _, label, _ in train_set]
        except Exception as exc:  # noqa: BLE001 - the built-in corpus follows
            logger.warning("No acoustic dataset for LM (%s); using built-in", exc)
    if not texts:
        texts = ["the brown lazy fox", "the red quick fox",
                 "the white big horse", "the yellow small cat"]
    # --max_epoch alone governs the run length when given without --max_steps.
    if prog["max_steps"] is not None:
        max_steps = prog["max_steps"]
    elif prog["max_epoch"] is not None:
        max_steps = None
    else:
        max_steps = config.steps_per_checkpoint
    _, step = lm_loop.train_language(
        config, texts, char_map, max_steps=max_steps, max_epoch=prog["max_epoch"],
        learn_rate_override=prog["learn_rate"], tb_name=prog["tb_name"], device=device)
    print(f"Language model trained to step {step}")
    return 0


def generate_text(config, char_map, device) -> int:
    """Print "O" and the LM's 10 greedy characters after it (the LM of
    ``checkpoint_dir/language/``, its initial weights without one)."""
    import torch

    from rnn_speech_tpu_torch.models import language
    from rnn_speech_tpu_torch.train import checkpoint
    from rnn_speech_tpu_torch.train.lm_loop import language_config

    cfg = language_config(config, char_map)
    params = language.init_params(torch.Generator().manual_seed(0), cfg,
                                  resolve_device(device))
    restored = checkpoint.restore(config.checkpoint_dir + "/language/", params)
    if restored is not None:
        params = restored[0]
    with torch.no_grad():
        out_ids = language.generate(params, cfg, char_map.encode("O", add_eos=False), 10)
    print("O" + char_map.decode(out_ids))
    return 0


class StreamingTranscriber:
    """Chunk-at-a-time transcription (the ``--record`` engine).

    The recurrent state persists across chunks, and so does the decoder's:
    greedy carries its last frame's argmax (``greedy_stream_decode``), the
    beam search its ``BeamStream`` with the LM carry, emitting only the
    symbols every live beam agrees on.  Fbank features stream through
    ``streaming.StreamingFbank`` (frame phase, deltas and a running mean
    carried), so any chunking of a clip gives the same features and text.
    Each device step runs one fixed block of ``step_frames`` frames (a
    chunk's worth; longer feeds loop over blocks), so the input
    projection's matmul always has the same M; with ``frame_stack`` > 1 a
    partial stack group waits for more frames.  MFCC features, which have
    no streaming form, are computed chunk by chunk on the device.  The
    acoustic forward runs the config's kernels: the wavefront at B=1 with
    h0 and c0 carried from the last block.  Runs on ``cuda`` unless
    ``device`` says otherwise."""

    def __init__(self, config, char_map, chunk_seconds: float = 1.0,
                 beam_width: int = 1, lm=None, lm_weight: float = 0.0, device=None):
        from rnn_speech_tpu_torch import streaming
        from rnn_speech_tpu_torch.models import acoustic

        self.device = resolve_device(device)
        self._model_cfg, self._fe, self._params = build_forward(config, char_map,
                                                                self.device)
        self._acoustic = acoustic
        self._char_map = char_map
        self._beam_width = beam_width
        self._lm, self._lm_weight = lm, lm_weight
        self._stack = max(self._model_cfg.frame_stack, 1)
        self._max_samples = max_samples_for(config)
        self.sample_rate = SAMPLE_RATE
        self.chunk_samples = max(1, min(self._max_samples,
                                        int(round(SAMPLE_RATE * chunk_seconds))))
        self._streaming_dsp = config.signal_processing == "fbank"
        if self._streaming_dsp:
            self._streaming = streaming
            frame_step = streaming.StreamingFbank(SAMPLE_RATE).frame_step
            frames = self.chunk_samples // frame_step + 2
            self.step_frames = -(-frames // self._stack) * self._stack
        elif self._stack > 1:
            # A chunk whose frame count is a whole number of stack groups.
            n = self.chunk_samples
            while n > 1 and self._fe._frames_for_width(n) % self._stack:
                n -= 1
            if n > 1:
                self.chunk_samples = n
        self.reset()

    def reset(self) -> None:
        """Clear the per-utterance state (recurrent, decoder, featurizer and
        text continuation) so one transcriber serves utterances back to
        back."""
        import torch

        from rnn_speech_tpu_torch.ops import decode

        self._text_started = False
        if self._beam_width > 1:
            self._dec = decode.beam_stream_init(
                1, len(self._char_map), beam_width=self._beam_width, max_suffix=128,
                lm=self._lm, device=self.device)
        else:
            self._dec = torch.full((1,), -1, dtype=torch.int32, device=self.device)
        self._states = self._acoustic.zero_state(self._model_cfg, 1, device=self.device)
        if self._streaming_dsp:
            self._sfe = self._streaming.StreamingFbank(SAMPLE_RATE)
            self._feat_buf = np.zeros((0, self._sfe.feature_size), np.float32)

    def _step(self, feats_tm, n: int) -> list:
        """One device step: (T, 1, D) features with ``n`` valid frames ->
        the forward from the carried state, then the carried decode of the
        valid logits -> the label ids it emits."""
        import torch

        from rnn_speech_tpu_torch.ops import decode

        dev = self.device
        lengths = torch.tensor([n], dtype=torch.int32, device=dev)
        logits, self._states = self._acoustic.forward(
            self._params, self._model_cfg, feats_tm, lengths, self._states)
        n_out = -(-n // self._stack)
        out_len = torch.tensor([n_out], dtype=torch.int32, device=dev)
        logits = logits[:n_out]        # frames past n_out change no decoder state
        if self._beam_width > 1:
            self._dec, labels, count = decode.beam_stream_decode(
                self._dec, logits, out_len, lm=self._lm, lm_weight=self._lm_weight)
        else:
            labels, count, self._dec = decode.greedy_stream_decode(logits, out_len,
                                                                   self._dec)
        return labels[0, : int(count[0])].tolist()

    def _decode_frames(self, final: bool = False) -> list:
        """Run the buffered frames through the model in fixed blocks; a
        partial stack group waits for more frames unless ``final``."""
        import torch

        ids: list = []
        keep = 0 if final else len(self._feat_buf) % self._stack
        usable = len(self._feat_buf) - keep
        offset = 0
        while offset < usable:
            n = min(self.step_frames, usable - offset)
            block = np.zeros((self.step_frames, 1, self._feat_buf.shape[1]), np.float32)
            block[:n, 0] = self._feat_buf[offset:offset + n]
            ids.extend(self._step(torch.as_tensor(block, device=self.device), n))
            offset += n
        self._feat_buf = self._feat_buf[usable:]
        return ids

    def feed(self, sig: np.ndarray) -> str:
        """Consume one mono float32 chunk; return its decoded text."""
        import torch

        with torch.no_grad():
            if self._streaming_dsp:
                self._feat_buf = np.concatenate(
                    [self._feat_buf, self._sfe.feed(np.asarray(sig, np.float32))])
                return self._decode_text(self._decode_frames())
            n = min(len(sig), self._max_samples)
            width = min(self._max_samples, max(self.chunk_samples, n))
            padded = np.zeros((1, width), np.float32)
            padded[0, :n] = sig[:n]
            feats, nf = self._fe(torch.as_tensor(padded, device=self.device),
                                 torch.tensor([n], dtype=torch.int32, device=self.device))
            return self._decode_text(self._step(feats.transpose(0, 1), int(nf[0])))

    def _decode_text(self, ids: list) -> str:
        text = self._char_map.decode(ids, continuation=self._text_started)
        if text:
            self._text_started = True
        return text

    def finish(self) -> str:
        """Flush the featurizer (the delayed delta tail and the last
        zero-padded frame), decode what remains, and in beam mode emit the
        best beam's still-uncommitted suffix."""
        import torch

        from rnn_speech_tpu_torch.ops import decode

        ids: list = []
        with torch.no_grad():
            if self._streaming_dsp:
                self._feat_buf = np.concatenate([self._feat_buf, self._sfe.flush()])
                ids.extend(self._decode_frames(final=True))
            if self._beam_width > 1:
                tail, tail_len = decode.beam_stream_flush(self._dec)
                ids.extend(tail[0, : int(tail_len[0])].tolist())
        return self._decode_text(ids)


def record_and_write(config, prog, char_map, device) -> int:
    """Live microphone transcription with carried streaming state."""
    try:
        import pyaudio
    except ImportError:
        logger.fatal("--record requires pyaudio, which is not installed")
        return 1

    transcriber = StreamingTranscriber(
        config, char_map, beam_width=prog["beam_width"],
        lm=load_lm_stepper(config, char_map, prog["lm_weight"], device),
        lm_weight=prog["lm_weight"], device=device)
    chunk = transcriber.chunk_samples
    pa = pyaudio.PyAudio()
    stream = pa.open(format=pyaudio.paInt16, channels=1, rate=transcriber.sample_rate,
                     input=True, frames_per_buffer=chunk)
    print("NOW RECORDING...")
    # However the capture ends, the featurizer still holds a delayed delta
    # tail and any held-back frames: flush and print them.
    try:
        while True:
            data = stream.read(chunk)
            if not data:
                break
            sig = np.frombuffer(data, dtype=np.int16).astype(np.float32) / 32768.0
            print(transcriber.feed(sig), end="", flush=True)
    except (KeyboardInterrupt, EOFError, IOError):
        pass
    finally:
        print(transcriber.finish(), flush=True)
        stream.close()
        pa.terminate()
    return 0


def parse_args(argv=None) -> dict:
    parser = argparse.ArgumentParser(prog="python -m rnn_speech_tpu_torch.cli")
    parser.add_argument("--config", type=str, default="config.ini",
                        help="Path to configuration file with hyper-parameters.")
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                        help="Device to run on (default cuda; cpu runs the "
                             "plain PyTorch path)")
    parser.add_argument("--tb_name", type=str, default=None,
                        help="Metrics run name (multiple runs, same output dir)")
    parser.add_argument("--max_epoch", type=int, default=None,
                        help="Max epoch to train (no limitation if not provided)")
    parser.add_argument("--learn_rate", type=float, default=None,
                        help="Force learning rate to start from this value "
                             "(overriding checkpoint value)")
    parser.add_argument("--timeline", action="store_true", default=False,
                        help="Trace training steps 2-3 with torch.profiler into "
                             "tensorboard_dir")
    parser.add_argument("--beam_width", type=int, default=DEFAULT_BEAM_WIDTH,
                        help="CTC beam width for decoding (1 = greedy)")
    parser.add_argument("--lm_weight", type=float, default=0.0,
                        help="Shallow-fusion weight of the char LM during beam "
                             "decoding (0 = AM only; needs a trained language "
                             "checkpoint)")
    parser.add_argument("--mesh_data", type=int, default=None,
                        help="Data-parallel mesh axis size in ranks (default: [tpu] "
                             "mesh_data; 0 = all ranks of torch.distributed.run)")
    parser.add_argument("--mesh_model", type=int, default=None,
                        help="Model-parallel mesh axis size in ranks (default: [tpu] "
                             "mesh_model)")
    parser.add_argument("--max_steps", type=int, default=None,
                        help="Stop training after this many steps")
    group = parser.add_mutually_exclusive_group(required=True)
    group.add_argument("--train_acoustic", action="store_true", default=False,
                       help="Train the acoustic network")
    group.add_argument("--train_language", action="store_true", default=False,
                       help="Train the language network")
    group.add_argument("--file", type=str, default=None,
                       help="Path to an audio file to process")
    group.add_argument("--record", action="store_true", default=False,
                       help="Record and write result on the fly (needs pyaudio)")
    group.add_argument("--evaluate", action="store_true", default=False,
                       help="Evaluate WER and CER against the test set")
    group.add_argument("--generate_text", action="store_true", default=False,
                       help="Generate text from the language model")
    args = parser.parse_args(argv)
    return vars(args)


def main(argv: Optional[List[str]] = None) -> int:
    prog = parse_args(argv)
    from rnn_speech_tpu_torch.parallel import launch

    # Multi-process bring-up before anything touches the card: the rank's
    # device is cuda:LOCAL_RANK (torch.distributed.run or RST_MULTIHOST).
    device, owned = launch.init_from_env(prog["device"])
    try:
        return _run(prog, device)
    finally:
        if owned:
            import torch.distributed as dist

            dist.destroy_process_group()


def _run(prog, device) -> int:
    from rnn_speech_tpu_torch.charmap import get_char_map
    from rnn_speech_tpu_torch.config import (
        HyperParamStore, load_config, setup_logging,
    )
    from rnn_speech_tpu_torch.parallel import launch
    from rnn_speech_tpu_torch.parallel import mesh as mesh_mod

    if prog["train_acoustic"] or prog["evaluate"]:
        # The flags alone can ask for more ranks than there are; refuse
        # before reading any file.
        flags = [1 if prog[k] is None else prog[k] for k in ("mesh_data", "mesh_model")]
        if flags != [1, 1]:
            mesh_mod.mesh_shape(*flags, launch.world_and_rank()[0])
    config = load_config(prog["config"])
    setup_logging(config)
    config = HyperParamStore(config).config
    char_map = get_char_map(config.language)
    if prog["train_acoustic"]:
        return train_acoustic(config, prog, char_map, device)
    if prog["train_language"]:
        return train_language(config, prog, char_map, device)
    if prog["file"] is not None:
        return process_file(config, char_map, prog["file"], device, prog["beam_width"],
                            prog["lm_weight"])
    if prog["record"]:
        return record_and_write(config, prog, char_map, device)
    if prog["evaluate"]:
        return evaluate(config, prog, char_map, device)
    return generate_text(config, char_map, device)


if __name__ == "__main__":
    sys.exit(main())
