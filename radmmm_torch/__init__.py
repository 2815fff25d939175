"""radmmm_torch: the RADMMM text-to-speech system on PyTorch and CUDA.

A second package beside the JAX one, with the same layout and names so a
reader finds each counterpart: masked convolutions, LSTMs and norms under
``ops/``, the text encoder, attribute predictors and flow decoder under
``models/``, HiFi-GAN and Griffin-Lim under ``vocoder/``, the training
step, the trainer and its CLI under ``training/``, the datasets, loader
and device featurizer under ``data/``, the text frontend under ``text/``,
configs, checkpoints and logs under ``utils/``, the fused-WN bench entry
point under ``scripts/``, and the serving artifact and HTTP daemon in
``serving.py`` / ``server.py``.

Tensors keep the channels-last ``(B, T, C)`` layout at module boundaries.
Every kernel the JAX package wrote in Pallas runs as a hand-written CUDA
kernel under ``csrc/`` when its tensors are on the card; on the CPU the
same function runs as a plain PyTorch twin. The package imports
``torch``, ``numpy``, ``scipy`` and ``yaml`` only (``tensorboardX`` where
it is installed).
"""
