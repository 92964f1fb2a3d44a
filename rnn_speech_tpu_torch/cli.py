"""Command line of the port: transcribe a file on the GPU.

    python -m rnn_speech_tpu_torch.cli --file clip.wav --config my.ini
                                       [--device cuda|cpu]

Counterpart of the ``--file`` mode of ``rnn_speech_tpu/cli.py``: the same
ini (``checkpoint_dir`` names the bundle whose ``acoustic/`` checkpoint is
restored), the same on-device fbank/MFCC frontend, the same audio-width
bucketing, and greedy CTC decoding.  It runs on ``cuda`` unless
``--device cpu`` is given.

``transcribe(params, cfg, audio, lengths)`` is the library entry: raw
audio rows (B, S) in, one string per row out.

The other modes of the JAX CLI arrive with later slices of the port and
raise ``NotImplementedError`` naming the slice until then.
"""

from __future__ import annotations

import argparse
import logging
import sys
from typing import List, Optional

import numpy as np
import torch

from rnn_speech_tpu_torch import resolve_device

logger = logging.getLogger(__name__)

SAMPLE_RATE = 22050

_LATER = {
    "evaluate": "the evaluate slice (corpus readers, device edit distance, "
                "length bucketing)",
    "record": "the streaming slice (--record)",
    "train_acoustic": "the training slices (train step, loop and checkpoints)",
    "train_language": "the decoding slice (char LM training)",
    "generate_text": "the decoding slice (char LM)",
}


def max_samples_for(config) -> int:
    """Raw-sample budget covering max_input_seq_length frames."""
    from rnn_speech_tpu_torch import frontend

    step = int(round(frontend.FRAME_STRIDE * SAMPLE_RATE))
    length = int(round(frontend.FRAME_SIZE * SAMPLE_RATE))
    return config.max_input_seq_length * step + length


def build_forward(config, char_map, device=None):
    """(model config, frontend, params) for inference, the parameters
    restored from ``checkpoint_dir/acoustic/`` when a bundle is there."""
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


def infer(params, model_cfg, fe, audio: torch.Tensor, lengths: torch.Tensor):
    """Raw audio (B, S) -> (labels (B, U) padded with -1, lengths (B,)):
    frontend, forward with zero state, greedy decode."""
    from rnn_speech_tpu_torch.models import acoustic
    from rnn_speech_tpu_torch.ops import decode

    feats_bm, frame_lengths = fe(audio, lengths)
    states = acoustic.zero_state(model_cfg, feats_bm.shape[0], device=audio.device)
    logits, _ = acoustic.forward(
        params, model_cfg, feats_bm.transpose(0, 1), frame_lengths, states
    )
    out_lengths = acoustic.output_lengths(model_cfg, frame_lengths)
    return decode.greedy_decode(logits, out_lengths)


def transcribe(params, cfg, audio, lengths, *, frontend=None, char_map=None,
               device=None) -> List[str]:
    """Greedy transcripts of raw audio rows.

    ``audio`` (B, S) float samples in [-1, 1] at 22050 Hz, ``lengths`` (B,)
    valid samples per row; ``cfg`` the AcousticConfig of ``params``, which
    must already lie on ``device`` (default cuda).  ``frontend`` defaults
    to the fbank (120-dim input) or MFCC (20-dim) featurizer."""
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
    labels, out_lengths = infer(params, cfg, frontend, audio, lengths)
    labels = labels.cpu().numpy()
    out_lengths = out_lengths.cpu().numpy()
    return [char_map.decode(list(labels[b, : int(out_lengths[b])]))
            for b in range(labels.shape[0])]


def process_file(config, char_map, file_path, device) -> int:
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
    text = transcribe(params, model_cfg, padded, [len(sig)], frontend=fe,
                      char_map=char_map, device=device)[0]
    print(text)
    return 0


def parse_args(argv=None) -> dict:
    parser = argparse.ArgumentParser(prog="python -m rnn_speech_tpu_torch.cli")
    parser.add_argument("--config", type=str, default="config.ini",
                        help="Path to configuration file with hyper-parameters.")
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                        help="Device to run on (default cuda; cpu runs the "
                             "plain PyTorch path)")
    parser.add_argument("--beam_width", type=int, default=1,
                        help="CTC beam width (only 1 = greedy in this slice)")
    group = parser.add_mutually_exclusive_group(required=True)
    group.add_argument("--file", type=str, default=None,
                       help="Path to an audio file to process")
    for mode in _LATER:
        group.add_argument(f"--{mode}", action="store_true", default=False,
                           help=f"Not yet ported: {_LATER[mode]}")
    args = parser.parse_args(argv)
    return vars(args)


def main(argv: Optional[List[str]] = None) -> int:
    prog = parse_args(argv)
    device = resolve_device(prog["device"])
    for mode, slice_name in _LATER.items():
        if prog[mode]:
            raise NotImplementedError(f"--{mode} comes with {slice_name}")
    if prog["beam_width"] > 1:
        raise NotImplementedError(
            "beam search and LM fusion come with the decoding slice; use "
            "--beam_width 1"
        )

    from rnn_speech_tpu_torch.charmap import get_char_map
    from rnn_speech_tpu_torch.config import (
        HyperParamStore, load_config, setup_logging,
    )

    config = load_config(prog["config"])
    setup_logging(config)
    config = HyperParamStore(config).config
    char_map = get_char_map(config.language)
    return process_file(config, char_map, prog["file"], device)


if __name__ == "__main__":
    sys.exit(main())
