"""PyTorch/CUDA port of the video-LM serving and training paths for one NVIDIA H100.

Mirrors the layout of ``video_transformer_tpu``: ``models/`` (config,
tokenizers, encoder, decoder, VideoLM, int8 quant), ``ops/`` (norms, RoPE,
preprocess, attention and its training kernels, decode attention, grammar,
and ``_lib`` which builds the hand-written CUDA kernels in ``csrc/``),
``analyzer/`` (``schema.py``, ``prompts.py``), ``contracts/timefmt.py``,
``parallel/engine.py`` (``InferenceEngine.generate``) and ``train/``
(synthetic data, the distillation ``Trainer`` and its CLI). ``weights.py``
bridges JAX parameter trees and makes seeded random weights.
"""
