"""PyTorch/CUDA port of the video-LM serving path for one NVIDIA H100.

Mirrors the layout of ``video_transformer_tpu``: ``models/`` (config,
tokenizers, encoder, decoder, VideoLM, int8 quant), ``ops/`` (norms, RoPE,
preprocess, attention, decode attention, grammar, and ``_lib`` which builds
the hand-written CUDA kernels in ``csrc/``), ``analyzer/schema.py`` and
``parallel/engine.py`` (``InferenceEngine.generate``). ``weights.py`` bridges
JAX parameter trees and makes seeded random weights.
"""
