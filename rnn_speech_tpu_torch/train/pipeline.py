"""Host input pipeline: parallel decode and padded batching (numpy).

The port's own copy of the host half of ``rnn_speech_tpu/train/
pipeline.py``: a pipeline over ``[path, label, duration]`` triples that
yields numpy "macro batches": ``mini_batch_size`` microbatches of
``batch_size`` clips each, exactly the unit one train step consumes.

Two feed modes:
  * ``on_device_frontend=True`` (default): workers only decode + resample;
    raw padded audio goes to the device and featurization runs inside the
    step (``ops/frontend.py``).  Host CPU cost per clip is container decode.
    With ``num_workers > 0`` and ``use_native_loader`` (the default) the
    workers are the C++ loader's threads (``runtime/loader.py``); the main
    process only encodes labels and assembles batches.
  * ``on_device_frontend=False``: workers run the numpy frontend and ship
    features (kept for CPU-only use and tests).

Where neither the native loader nor ``num_workers`` 0 (decode inline)
applies, clips are decoded in a spawned process pool, as in the JAX
package.  A native loader whose library cannot be built raises; the
pipeline does not fall back to the pool.

Short final batches are padded with empty items (zero lengths); the CTC
loss and the metrics mask them to zero contribution.  With ``bucket_count
> 1`` each macro batch pads its audio to the smallest of ``bucket_count``
even divisions of the max length that covers it; ``order_by_duration``
windows keep batch members of similar length.
"""

from __future__ import annotations

import logging
from concurrent.futures import ProcessPoolExecutor, wait
from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np

from rnn_speech_tpu_torch import audio_io, frontend
from rnn_speech_tpu_torch.charmap import CharMap

logger = logging.getLogger(__name__)


def default_decode_threads() -> int:
    """Host decode parallelism: the cores this process may run on (not
    the host's count, which a container can exceed many times over),
    bounded to 4..32 workers."""
    import os

    cores = len(os.sched_getaffinity(0)) if hasattr(os, "sched_getaffinity") else None
    return max(4, min(32, cores or os.cpu_count() or 4))


@dataclass(frozen=True)
class PipelineConfig:
    batch_size: int
    mini_batch_size: int = 1
    max_input_seq_length: int = 1000
    max_target_seq_length: int = 300
    signal_processing: str = "fbank"
    sample_rate: int = 22050
    on_device_frontend: bool = True
    num_workers: int = 0              # 0 = synchronous (tests)
    prefetch_batches: int = 2
    add_eos: bool = False             # EOS id == CTC blank; see charmap notes
    use_native_loader: bool = True    # C++ thread pool (runtime/loader.py)
    bucket_count: int = 1             # audio-width buckets (1 = full padding)

    @property
    def max_samples(self) -> int:
        """Raw-sample budget covering max_input_seq_length frames."""
        step = int(round(frontend.FRAME_STRIDE * self.sample_rate))
        length = int(round(frontend.FRAME_SIZE * self.sample_rate))
        return self.max_input_seq_length * step + length


def _process_item(args):
    """Worker: decode one clip (+featurize in host mode). Returns a dict."""
    path, label, cfg, char_map_tokens = args
    cm = CharMap(char_map_tokens)
    try:
        sig, sr = audio_io.load(path, sr=cfg.sample_rate)
    except (audio_io.AudioFormatError, OSError, ValueError, EOFError) as exc:
        logger.warning("Skipping unreadable audio %s: %s", path, exc)
        return None
    labels, label_len = cm.encode_padded(
        label, cfg.max_target_seq_length, add_eos=cfg.add_eos
    )
    if cfg.on_device_frontend:
        sig = sig[: cfg.max_samples]
        return {
            "audio": sig.astype(np.float32),
            "audio_length": len(sig),
            "labels": labels,
            "label_length": label_len,
        }
    ap = frontend.AudioProcessor(cfg.max_input_seq_length, cfg.signal_processing)
    try:
        feats, n_frames = ap.process_signal(sig, sr)
    except (ValueError, FloatingPointError) as exc:
        # Degenerate clips (too short/empty for the DSP) are skipped like
        # undecodable audio, not allowed to abort the whole training run.
        logger.warning("Skipping unfeaturizable audio %s: %s", path, exc)
        return None
    return {
        "features": feats.astype(np.float32),
        "frame_length": min(n_frames, cfg.max_input_seq_length),
        "labels": labels,
        "label_length": label_len,
    }


def _empty_item(cfg: PipelineConfig, feature_size: int) -> Dict:
    if cfg.on_device_frontend:
        return {
            "audio": np.zeros((0,), np.float32),
            "audio_length": 0,
            "labels": np.full((cfg.max_target_seq_length,), -1, np.int32),
            "label_length": 0,
        }
    return {
        "features": np.zeros((0, feature_size), np.float32),
        "frame_length": 0,
        "labels": np.full((cfg.max_target_seq_length,), -1, np.int32),
        "label_length": 0,
    }


# Macro batches assembled from the native loader's clips, in this process.
native_batches = 0


class InputPipeline:
    """Iterates macro batches over a dataset of [path, label, duration]."""

    def __init__(
        self,
        dataset: Sequence,            # [audio_file, label, duration] triples
        char_map: CharMap,
        cfg: PipelineConfig,
    ):
        self.dataset = list(dataset)
        self.char_map = char_map
        self.cfg = cfg
        self.feature_size = frontend.AudioProcessor(
            cfg.max_input_seq_length, cfg.signal_processing
        ).feature_size

    # -------------------------------------------------------------- assembly

    def _bucket_width(self, items: List[Dict]) -> int:
        """Smallest bucket width (of cfg.bucket_count even divisions of
        max_samples) covering the longest clip in this macro batch.  The
        shorter buckets cut compute proportionally; combine with
        ``order_by_duration`` windows so batches stay length-homogeneous."""
        cfg = self.cfg
        if cfg.bucket_count <= 1:
            return cfg.max_samples
        longest = max((item["audio_length"] for item in items), default=0)
        unit = -(-cfg.max_samples // cfg.bucket_count)   # ceil division
        k = max(1, -(-longest // unit))
        return min(k * unit, cfg.max_samples)

    def _assemble(self, items: List[Dict]) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        mb, b = cfg.mini_batch_size, cfg.batch_size
        need = mb * b
        items = items + [
            _empty_item(cfg, self.feature_size) for _ in range(need - len(items))
        ]
        out: Dict[str, np.ndarray] = {}
        if cfg.on_device_frontend:
            audio = np.zeros((need, self._bucket_width(items)), np.float32)
            lengths = np.zeros((need,), np.int32)
            for i, item in enumerate(items):
                n = item["audio_length"]
                audio[i, :n] = item["audio"][:n]
                lengths[i] = n
            out["audio"] = audio.reshape(mb, b, -1)
            out["audio_lengths"] = lengths.reshape(mb, b)
        else:
            T = cfg.max_input_seq_length
            feats = np.zeros((need, T, self.feature_size), np.float32)
            lengths = np.zeros((need,), np.int32)
            for i, item in enumerate(items):
                f = item["features"][:T]
                feats[i, : len(f)] = f
                lengths[i] = item["frame_length"]
            out["features"] = feats.reshape(mb, b, T, self.feature_size)
            out["frame_lengths"] = lengths.reshape(mb, b)
        out["labels"] = np.stack([i["labels"] for i in items]).reshape(
            mb, b, -1
        ).astype(np.int32)
        out["label_lengths"] = np.asarray(
            [i["label_length"] for i in items], np.int32
        ).reshape(mb, b)
        return out

    def empty_batch(self) -> Dict[str, np.ndarray]:
        """A full-shape all-padding macro batch (every row zero-length);
        the metric masks ignore zero-length rows."""
        return self._assemble([])

    # ------------------------------------------------------------- iteration

    def _iter_native(self) -> Iterator[Dict[str, np.ndarray]]:
        """Decode through the C++ async loader (``runtime/loader.py``):
        native worker threads own decode/downmix/resample/truncate, the
        main process only encodes labels and assembles batches."""
        from rnn_speech_tpu_torch.runtime import loader as native_loader

        global native_batches
        cfg = self.cfg
        need = cfg.mini_batch_size * cfg.batch_size
        paths = [item[0] for item in self.dataset]
        texts = [item[1] for item in self.dataset]
        items: List[Dict] = []
        with native_loader.NativeAudioLoader(
            paths,
            max_samples=cfg.max_samples,
            target_rate=cfg.sample_rate,
            n_threads=cfg.num_workers,
            capacity=max(need * (cfg.prefetch_batches + 1), cfg.num_workers * 2),
        ) as ld:
            for idx, audio, rc in ld:
                if audio is None:
                    logger.warning(
                        "Skipping unreadable audio %s (native decoder rc %d)",
                        paths[idx], rc,
                    )
                    continue
                labels, label_len = self.char_map.encode_padded(
                    texts[idx], cfg.max_target_seq_length, add_eos=cfg.add_eos
                )
                items.append({
                    "audio": audio,
                    "audio_length": len(audio),
                    "labels": labels,
                    "label_length": label_len,
                })
                if len(items) == need:
                    native_batches += 1
                    yield self._assemble(items)
                    items = []
        if items:
            native_batches += 1
            yield self._assemble(items)

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        cfg = self.cfg
        need = cfg.mini_batch_size * cfg.batch_size

        if cfg.num_workers > 0 and cfg.on_device_frontend and cfg.use_native_loader:
            yield from self._iter_native()
            return

        tasks = [
            (path, label, cfg, self.char_map.tokens)
            for path, label, _ in self.dataset
        ]

        if cfg.num_workers <= 0:
            items: List[Dict] = []
            for task in tasks:
                item = _process_item(task)
                if item is None:
                    continue
                items.append(item)
                if len(items) == need:
                    yield self._assemble(items)
                    items = []
            if items:
                yield self._assemble(items)
            return

        # Async mode: keep ~prefetch window of decode tasks in flight.
        # Spawn (not fork): the parent holds a multithreaded CUDA runtime.
        import multiprocessing

        window = max(need * (cfg.prefetch_batches + 1), cfg.num_workers * 2)
        with ProcessPoolExecutor(
            max_workers=cfg.num_workers,
            mp_context=multiprocessing.get_context("spawn"),
        ) as pool:
            pending = set()
            task_iter = iter(tasks)
            items = []
            # Order preservation matters for reproducibility: consume
            # completed futures but emit in submission order.
            from collections import deque

            fifo = deque()
            while True:
                while len(pending) < window:
                    try:
                        task = next(task_iter)
                    except StopIteration:
                        break
                    fut = pool.submit(_process_item, task)
                    pending.add(fut)
                    fifo.append(fut)
                if not fifo:
                    break
                head = fifo[0]
                if not head.done():
                    # Wait on the head only: waiting on `pending` with
                    # FIRST_COMPLETED busy-spins once any non-head future
                    # finishes (done futures stay in the set until they
                    # reach the FIFO head).
                    wait([head])
                while fifo and fifo[0].done():
                    fut = fifo.popleft()
                    pending.discard(fut)
                    item = fut.result()
                    if item is not None:
                        items.append(item)
                        if len(items) == need:
                            yield self._assemble(items)
                            items = []
            if items:
                yield self._assemble(items)


def shard_for_host(
    dataset: Sequence,
    process_index: Optional[int] = None,
    process_count: Optional[int] = None,
) -> List:
    """Deterministic per-process slice of the dataset for multi-process
    training: strided, so duration-sorted datasets stay balanced across
    processes.  Rank and world size default to ``torch.distributed``'s
    when it is initialised, else 0 and 1 (the dataset unchanged)."""
    if process_index is None or process_count is None:
        rank, world = 0, 1
        import torch.distributed as dist

        if dist.is_available() and dist.is_initialized():
            rank, world = dist.get_rank(), dist.get_world_size()
        process_index = rank if process_index is None else process_index
        process_count = world if process_count is None else process_count
    if process_count <= 1:
        return list(dataset)
    return list(dataset)[process_index::process_count]


def order_by_duration(dataset: Sequence, window: Optional[int] = None) -> List:
    """Sort (optionally within shuffle windows) by duration — the bucketing
    complement to the reference's global dataset_size_ordering."""
    data = list(dataset)
    if window is None:
        return sorted(data, key=lambda item: item[2])
    out = []
    for i in range(0, len(data), window):
        out.extend(sorted(data[i : i + window], key=lambda item: item[2]))
    return out
