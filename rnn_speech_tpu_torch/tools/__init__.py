"""The port's accuracy tools, run as ``python -m rnn_speech_tpu_torch.tools.<name>``.

Counterparts of the JAX package's top-level ``tools/`` of the same names,
with the same functions, arguments and JSON keys: ``make_demo_corpus``
(synthetic LibriSpeech-layout corpora), ``flagship_accuracy_run`` (one
training session at the flagship width, its exported bundle decoded over
a noise sweep), ``beam_quality_run`` (the committed bundle on fresh
held-out clips), ``accuracy_benchmark`` (the letters corpus) and
``sweep`` (a CLI training run per grid point).  They run on ``cuda``
unless ``--device cpu`` is given, and import nothing of JAX.
"""
