"""Typed configuration system (host-only).

The port's own copy of ``rnn_speech_tpu/config.py``: it reads the same
``config.ini`` schema into a frozen dataclass, and keeps the same
``hyperparams.json`` sidecar with fork-or-restore semantics: if a
checkpoint already holds a parameter snapshot and a *structural* field
changed (num_layers, hidden_size, signal_processing, language), either
restore the old snapshot or fork a new timestamped checkpoint directory,
depending on ``use_config_file_if_checkpoint_exists``.

The ``[tpu]`` section keeps its name and keys so one ini serves both
packages.  In the port ``use_pallas_lstm`` means "use the hand-written
CUDA kernels", ``compute_dtype`` names the matmul dtype, ``wavefront``
picks the whole-stack diagonal kernel, ``bucket_count`` the audio-width
buckets and ``frame_stack`` the frame stacking; the mesh, prefetch and
training keys are read and carried for the later slices that use them.
"""

from __future__ import annotations

import configparser
import dataclasses
import json
import logging
import os
import time
from dataclasses import dataclass, field
from typing import Optional, Tuple

logger = logging.getLogger(__name__)

STRUCTURAL_FIELDS = ("num_layers", "hidden_size", "signal_processing", "language")


@dataclass(frozen=True)
class TpuConfig:
    """Execution knobs of the ``[tpu]`` section (no reference counterpart)."""

    mesh_data: int = 1            # data-parallel axis size (0 = all devices)
    mesh_model: int = 1           # model-parallel axis size
    compute_dtype: str = "bfloat16"   # matmul dtype (f32 accumulation)
    param_dtype: str = "float32"      # master copy of parameters
    use_pallas_lstm: bool = True      # hand-written LSTM recurrence kernels
    use_pallas_ctc: bool = True       # CTC kernels (training slice)
    # Cross-layer wavefront: run the whole LSTM stack as one
    # diagonal-walking kernel (ops/lstm_wavefront.py).  Applies when the
    # kernels are on and the stack has >= 2 layers; the layered path runs
    # otherwise.
    wavefront: bool = True
    # Time-chunking of the LSTM stack during training (training slice).
    time_chunk: int = 0
    bucket_count: int = 8             # audio-width buckets for padding
    prefetch_depth: int = 2           # input prefetch depth
    remat: bool = False               # rematerialize LSTM layers in bwd
    # One fused device batch instead of a microbatch loop (training slice).
    fuse_microbatches: bool = False
    # Stack N adjacent feature frames and subsample time by N before the
    # LSTM (arXiv:1507.06947).  Changes the model (10*N ms logit frame
    # rate); train and decode with the same value.  1 = off.
    frame_stack: int = 1


@dataclass(frozen=True)
class LmConfig:
    """[lm_network_params] — the reference declares this section in its
    config.ini (:41-48) but never reads it; here it actually drives the
    char-LM.  ``None`` fields inherit the acoustic value at use time."""

    num_layers: Optional[int] = None
    hidden_size: Optional[int] = None
    dropout_keep_prob: float = 0.9    # the reference's single `dropout` key
    batch_size: Optional[int] = None
    learning_rate: Optional[float] = None
    lr_decay_factor: Optional[float] = None
    grad_clip: Optional[float] = None
    text_corpus: Optional[str] = None  # line-per-sentence training text file


@dataclass(frozen=True)
class Config:
    """Flat hyperparameter set, mirroring the reference's ~25 keys."""

    # [acoustic_network_params]
    num_layers: int = 2
    hidden_size: int = 256
    dropout_input_keep_prob: float = 0.8
    dropout_output_keep_prob: float = 0.5
    batch_size: int = 10
    mini_batch_size: int = 3
    learning_rate: float = 3e-4
    lr_decay_factor: float = 0.33
    grad_clip: float = 1.0
    signal_processing: str = "fbank"
    language: str = "english"
    rnn_state_reset_ratio: float = 1.0
    # [general]
    use_config_file_if_checkpoint_exists: bool = True
    steps_per_checkpoint: int = 100
    steps_per_evaluation: int = 1000
    checkpoint_dir: str = "data/checkpoints/"
    # [training]
    training_dataset_dirs: str = ""
    training_filelist_cache: Optional[str] = None
    test_dataset_dirs: Optional[str] = None
    train_frac: Optional[float] = None
    max_input_seq_length: int = 1000
    max_target_seq_length: int = 300
    tensorboard_dir: Optional[str] = None
    batch_normalization: bool = False
    dataset_size_ordering: str = "False"   # True | False | First_run_only
    # SpecAugment (arXiv:1904.08779): on-device time/frequency masking of
    # the training features inside the compiled step.  No reference
    # counterpart; off by default.
    spec_augment: bool = False
    # Cadence of the greedy-decode + edit-distance train metric: 1 =
    # every step (the reference's behavior — its graph tied prediction to
    # the error accumulator, AcousticModel.py:363-383), N > 1 = compute
    # it on every Nth step only (the loss still accumulates every step;
    # TensorBoard/plateau means average the metric-bearing steps).
    # Documented deviation: the metric is observability, not gradient.
    train_metric_every: int = 1
    # [logging]
    log_file: Optional[str] = None
    log_level: str = "WARNING"
    # [lm_network_params]
    lm: LmConfig = field(default_factory=LmConfig)
    # [tpu]
    tpu: TpuConfig = field(default_factory=TpuConfig)

    # -------------------------------------------------------------- helpers

    def lm_resolved(self) -> "LmConfig":
        """LM params with None fields filled from the acoustic section.

        Only ``None`` means "inherit" — an explicit 0 (e.g. grad_clip : 0
        to disable clipping) is preserved."""
        lm = self.lm
        pick = lambda v, default: default if v is None else v
        return LmConfig(
            num_layers=pick(lm.num_layers, self.num_layers),
            hidden_size=pick(lm.hidden_size, self.hidden_size),
            dropout_keep_prob=lm.dropout_keep_prob,
            batch_size=pick(lm.batch_size, self.batch_size),
            learning_rate=pick(lm.learning_rate, self.learning_rate),
            lr_decay_factor=pick(lm.lr_decay_factor, self.lr_decay_factor),
            grad_clip=pick(lm.grad_clip, self.grad_clip),
            text_corpus=lm.text_corpus,
        )

    @property
    def input_dim(self) -> int:
        """Feature dimensionality implied by the signal-processing mode."""
        return {"mfcc": 20, "fbank": 120}[self.signal_processing]

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)

    def structural_signature(self) -> Tuple:
        # tpu.frame_stack changes parameter shapes (the input projection is
        # frame_stack*input_dim wide), so it forks checkpoints like the
        # reference's structural fields do.
        return tuple(getattr(self, f) for f in STRUCTURAL_FIELDS) + (
            max(self.tpu.frame_stack, 1),    # <=1 all mean "off"
        )

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        return d

    @staticmethod
    def from_dict(d: dict) -> "Config":
        d = dict(d)
        tpu = d.pop("tpu", {})
        lm = d.pop("lm", {})
        known = {f.name for f in dataclasses.fields(Config)} - {"tpu", "lm"}
        tknown = {f.name for f in dataclasses.fields(TpuConfig)}
        lknown = {f.name for f in dataclasses.fields(LmConfig)}
        return Config(
            **{k: v for k, v in d.items() if k in known},
            lm=LmConfig(**{k: v for k, v in lm.items() if k in lknown}),
            tpu=TpuConfig(**{k: v for k, v in tpu.items() if k in tknown}),
        )


def load_config(config_file: str) -> Config:
    """Parse a reference-format ``config.ini`` into a Config."""
    cp = configparser.ConfigParser()
    read = cp.read(config_file)
    if not read:
        raise FileNotFoundError(f"Config file not found: {config_file}")

    ac, ge, tr, lo = "acoustic_network_params", "general", "training", "logging"

    def opt_get(section, key, conv=None):
        try:
            raw = cp.get(section, key)
        except (configparser.NoSectionError, configparser.NoOptionError):
            return None
        return conv(raw) if conv else raw

    tensorboard_dir = opt_get(tr, "tensorboard_dir")
    if tensorboard_dir is not None and not os.path.exists(tensorboard_dir):
        tensorboard_dir = None

    tpu_kwargs = {}
    if cp.has_section("tpu"):
        for f in dataclasses.fields(TpuConfig):
            if cp.has_option("tpu", f.name):
                if f.type == "bool" or isinstance(f.default, bool):
                    tpu_kwargs[f.name] = cp.getboolean("tpu", f.name)
                elif isinstance(f.default, int):
                    tpu_kwargs[f.name] = cp.getint("tpu", f.name)
                else:
                    tpu_kwargs[f.name] = cp.get("tpu", f.name)

    lm_kwargs = {}
    lm_sec = "lm_network_params"
    if cp.has_section(lm_sec):
        for key, conv in (
            ("num_layers", cp.getint),
            ("hidden_size", cp.getint),
            ("batch_size", cp.getint),
            ("learning_rate", cp.getfloat),
            ("lr_decay_factor", cp.getfloat),
            ("grad_clip", cp.getfloat),
        ):
            if cp.has_option(lm_sec, key):
                lm_kwargs[key] = conv(lm_sec, key)
        if cp.has_option(lm_sec, "dropout"):  # reference's key name
            lm_kwargs["dropout_keep_prob"] = cp.getfloat(lm_sec, "dropout")
        if cp.has_option(lm_sec, "text_corpus"):
            lm_kwargs["text_corpus"] = cp.get(lm_sec, "text_corpus")

    try:
        return _build_config(cp, ac, ge, tr, lo, opt_get, tensorboard_dir,
                             lm_kwargs, tpu_kwargs)
    except (configparser.NoSectionError, configparser.NoOptionError) as exc:
        # Raw configparser tracebacks don't say which file or what a valid
        # layout looks like; point the user at both.
        raise ValueError(
            f"{config_file}: {exc.message}. Required keys follow the "
            "reference config.ini schema (sections [acoustic_network_params]"
            " / [general] / [training] / [logging]); see the config.ini "
            "shipped at the repo root for a complete annotated example."
        ) from exc


def _build_config(cp, ac, ge, tr, lo, opt_get, tensorboard_dir,
                  lm_kwargs, tpu_kwargs) -> Config:
    return Config(
        num_layers=cp.getint(ac, "num_layers"),
        hidden_size=cp.getint(ac, "hidden_size"),
        dropout_input_keep_prob=cp.getfloat(ac, "dropout_input_keep_prob"),
        dropout_output_keep_prob=cp.getfloat(ac, "dropout_output_keep_prob"),
        batch_size=cp.getint(ac, "batch_size"),
        mini_batch_size=cp.getint(ac, "mini_batch_size"),
        learning_rate=cp.getfloat(ac, "learning_rate"),
        lr_decay_factor=cp.getfloat(ac, "lr_decay_factor"),
        grad_clip=cp.getfloat(ac, "grad_clip"),
        signal_processing=cp.get(ac, "signal_processing"),
        language=cp.get(ac, "language"),
        rnn_state_reset_ratio=cp.getfloat(ac, "rnn_state_reset_ratio"),
        use_config_file_if_checkpoint_exists=cp.getboolean(
            ge, "use_config_file_if_checkpoint_exists"
        ),
        steps_per_checkpoint=cp.getint(ge, "steps_per_checkpoint"),
        steps_per_evaluation=cp.getint(ge, "steps_per_evaluation"),
        checkpoint_dir=cp.get(ge, "checkpoint_dir"),
        training_dataset_dirs=cp.get(tr, "training_dataset_dirs", fallback=""),
        training_filelist_cache=opt_get(tr, "training_filelist_cache"),
        test_dataset_dirs=opt_get(tr, "test_dataset_dirs"),
        train_frac=opt_get(tr, "train_frac", float),
        max_input_seq_length=cp.getint(tr, "max_input_seq_length"),
        max_target_seq_length=cp.getint(tr, "max_target_seq_length"),
        tensorboard_dir=tensorboard_dir,
        batch_normalization=cp.getboolean(tr, "batch_normalization", fallback=False),
        dataset_size_ordering=cp.get(tr, "dataset_size_ordering", fallback="False"),
        spec_augment=cp.getboolean(tr, "spec_augment", fallback=False),
        train_metric_every=cp.getint(tr, "train_metric_every", fallback=1),
        log_file=opt_get(lo, "log_file"),
        log_level=cp.get(lo, "log_level", fallback="WARNING"),
        lm=LmConfig(**lm_kwargs),
        tpu=TpuConfig(**tpu_kwargs),
    )


SIDECAR_NAME = "hyperparams.json"


class HyperParamStore:
    """Checkpoint-side hyperparameter snapshot with fork-or-restore.

    Mirrors the reference handler's flow: on construction the checkpoint dir
    is created, an existing snapshot is compared structurally against the new
    config, and the effective config either (a) silently restores the *old*
    snapshot (``use_config_file_if_checkpoint_exists = False``), or (b) forks
    a fresh timestamped checkpoint directory for the new structure.
    """

    def __init__(self, config: Config):
        self.config = config
        os.makedirs(config.checkpoint_dir, exist_ok=True)
        self.path = os.path.join(config.checkpoint_dir, SIDECAR_NAME)

        old = self._load()
        if old is None:
            self._save(self.config)
            logger.info("No hyper params detected at checkpoint; using config file")
            return

        if old.structural_signature() == config.structural_signature():
            logger.info("No hyper parameter change detected, using old checkpoint")
            return

        if not config.use_config_file_if_checkpoint_exists:
            logger.info("Restoring hyper params from previous checkpoint")
            # Keep new runtime-ish fields? The reference restores the full old
            # dict; we follow suit.
            self.config = old
        else:
            sub = "{0}_hidden_size_{1}_numlayers_{2}_signal_processing_{3}".format(
                int(time.time()),
                config.hidden_size,
                config.num_layers,
                config.signal_processing,
            )
            new_dir = os.path.join(config.checkpoint_dir, sub)
            os.makedirs(new_dir, exist_ok=True)
            self.config = config.replace(checkpoint_dir=new_dir)
            self.path = os.path.join(new_dir, SIDECAR_NAME)
            self._save(self.config)
            logger.info("Structural change: forked checkpoint dir %s", new_dir)

    def _load(self) -> Optional[Config]:
        if not os.path.exists(self.path):
            return None
        with open(self.path) as fh:
            return Config.from_dict(json.load(fh))

    def _save(self, config: Config) -> None:
        with open(self.path, "w") as fh:
            json.dump(config.to_dict(), fh, indent=2)


def setup_logging(config: Config) -> None:
    """Configure the logging framework per config (file + level).

    basicConfig always runs: the reference logged through the root-logger
    module functions (which implicitly install a stderr handler); named
    loggers don't, so without this INFO-level progress lines would
    silently vanish."""
    if config.log_file:
        logging.basicConfig(filename=config.log_file)
    else:
        logging.basicConfig()
    level = getattr(logging, config.log_level, None)
    if not isinstance(level, int):
        raise ValueError(f"Invalid log level: {config.log_level}")
    logging.getLogger().setLevel(level)
