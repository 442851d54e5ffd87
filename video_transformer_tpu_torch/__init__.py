"""PyTorch/CUDA port of the video-LM serving and training paths for one NVIDIA H100.

Mirrors the layout of ``video_transformer_tpu``: ``models/`` (config,
tokenizers, encoder, decoder, VideoLM, int8 quant), ``ops/`` (norms, RoPE,
preprocess, attention and its training kernels, decode attention, grammar,
and ``_lib`` which builds the hand-written CUDA kernels in ``csrc/``),
``analyzer/`` (``ContentAnalyzer``, the grammars, prompts, JSON repair and
segment merge), ``contracts/`` (the note's data model and Markdown
renderers), ``utils/`` (config, budgets, pacing, logging, progress, note
refinement and quality gates), ``video/`` (clip
containers, segmenter), ``parallel/`` (``InferenceEngine``, the
``ContinuousBatcher``), ``train/`` (synthetic data, the distillation
``Trainer`` and its CLI, the grounding eval), ``pipeline/`` (the
``VideoPipeline`` of the five steps, its downloader, validator, auditor,
blueprint renderer and PNG codec, the watch service) and ``tools/`` (the
note linter); ``cli.py`` and ``__main__.py`` are the system's entry point,
``python -m video_transformer_tpu_torch``. ``weights.py`` bridges JAX
parameter trees and makes seeded random weights.
"""
