"""radmmm_torch: the RADMMM text-to-speech system on PyTorch and CUDA.

A second package beside the JAX one, with the same layout and names so a
reader finds each counterpart: masked convolutions, LSTMs and norms under
``ops/``, the text encoder, attribute predictors and flow decoder under
``models/``, HiFi-GAN under ``vocoder/``, and the serving artifact and HTTP
daemon in ``serving.py`` / ``server.py``.

Tensors keep the channels-last ``(B, T, C)`` layout at module boundaries.
Every LSTM recurrence runs in a hand-written CUDA kernel
(``csrc/lstm_recurrence.cu``) when its tensors are on the card; on the CPU
the same recurrence runs as a plain PyTorch loop. The package imports
``torch`` and ``numpy``/``scipy`` only.
"""
