"""SpeechRecognizer wrapper: char-map selection + dataset split loading.

The port's own copy of ``rnn_speech_tpu/models/recognizer.py``: language
to char-map resolution (English only; other languages raise) and the
acoustic dataset split of the CLI's ``--train_acoustic``: optional
ascending sort by audio duration or shuffle (``random.shuffle``, so the
same ``random`` seed gives the same split in both packages), then the
test set from separate dirs OR a ``train_frac`` slice OR empty.
"""

from __future__ import annotations

import logging
from math import floor
from random import shuffle
from typing import List, Optional, Tuple

from rnn_speech_tpu_torch import corpus
from rnn_speech_tpu_torch.charmap import CharMap, get_char_map

logger = logging.getLogger(__name__)


class SpeechRecognizer:
    """Combines the char map with dataset handling (future AM+LM combiner)."""

    def __init__(self, language: str = "english"):
        self.char_map: CharMap = get_char_map(language)
        self.num_labels = len(self.char_map)

    def get_char_map(self) -> CharMap:
        return self.char_map

    def get_char_map_length(self) -> int:
        return len(self.char_map)

    @staticmethod
    def load_acoustic_dataset(
        training_dataset_dirs: str,
        test_dataset_dirs: Optional[str] = None,
        training_filelist_cache: Optional[str] = None,
        ordered: bool = False,
        train_frac: Optional[float] = None,
    ) -> Tuple[List, List]:
        """Returns (train_set, test_set) of [audio_file, label, duration].

        ``ordered`` sorts ascending by duration (the reference's
        dataset_size_ordering); otherwise the train set is shuffled.
        """
        dp = corpus.DataProcessor(
            training_dataset_dirs, file_cache=training_filelist_cache
        )
        train_set = dp.get_dataset()
        if ordered:
            train_set = sorted(train_set, key=lambda item: item[2])
        else:
            shuffle(train_set)

        if test_dataset_dirs is not None:
            test_set = corpus.DataProcessor(test_dataset_dirs).get_dataset()
        elif train_frac is not None:
            num_train = max(1, int(floor(train_frac * len(train_set))))
            test_set = train_set[num_train:]
            train_set = train_set[:num_train]
        else:
            test_set = []

        logger.info("Using %d files in train set", len(train_set))
        logger.info("Using %d size of test set", len(test_set))
        return train_set, test_set
