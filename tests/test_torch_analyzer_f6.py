"""The port's ContentAnalyzer on trained weights, against the JAX
package's (CPU).

F6 (ROADMAP.md §3, a departure from JAX on purpose) on the analyzer's
sequential segmented route, and the trained tiny checkpoint through both
analyzers' own engine construction (BPE, int8 weights, int8 KV; slow).
"""

import logging

import jax
import numpy as np
import pytest
import torch

from test_torch_analyzer_e2e import (
    REPO,
    APICounter,
    Capture,
    ContentAnalyzer,
    JAnalyzer,
    JCounter,
    analyzers,
    assert_same,
    comparable,
    events,
    make_config,
    write_npzv,
)

PAD_SCALE = 8.0


class TestInt8KvRoute:
    def test_int8_padded_chunk_keeps_the_unpadded_notes(self, tmp_path, monkeypatch):
        """F6 on the sequential segmented route (a departure from JAX on
        purpose, ROADMAP.md §3). Trained tiny weights in float32, an int8 KV
        cache, three segments in chunks of two: the last chunk is padded to
        two rows (``batch_bucket``), and the pad row's patches are scaled by
        8 (as ``tests/test_torch_grounding.py`` does) so that it would raise
        the KV scales. The JAX analyzer's padded chunk leaves its unpadded
        tokens; the port's padded chunk gives its unpadded tokens, which
        are JAX's unpadded ones, and the same analysis."""
        from test_torch_grounding import TINY_NPZ, TINY_ORBAX, jax_engine, port_engine
        from video_transformer_tpu_torch.train.grounded import render_topic_clip

        engines = (jax_engine(TINY_ORBAX, "tiny", f32=True, kv_quant="int8", max_new_tokens=256),
                   port_engine(TINY_NPZ, "tiny", f32=True, kv_quant="int8", max_new_tokens=256))
        # Topic 0 for 16 s, then topic 12, whose segment the scaled pad row
        # joins (a topic where it moves JAX's tokens).
        rng = np.random.default_rng(3)
        clip = tmp_path / "topics.npzv"
        write_npzv(clip, np.concatenate([render_topic_clip(0, 64, 64, rng), render_topic_clip(12, 56, 64, rng)]),
                   fps=4.0)

        def loud_pad_rows(engine, scale):
            preprocess = engine.preprocess

            def wrapped(frames):
                pad = np.asarray(frames).reshape(len(frames), -1).max(axis=1) == 0
                patches = preprocess(frames)
                return scale(patches, pad) if pad.any() else patches

            monkeypatch.setattr(engine, "preprocess", wrapped)

        loud_pad_rows(engines[0], lambda p, pad: p * jax.numpy.where(jax.numpy.asarray(pad)[:, None, None], PAD_SCALE, 1.0))
        loud_pad_rows(engines[1], lambda p, pad: p * torch.where(torch.from_numpy(pad)[:, None, None], PAD_SCALE, 1.0))

        def run(bucketed: bool):
            calls = [[], []]
            for engine, log in zip(engines, calls):
                generate = engine.__class__.generate.__get__(engine)

                def wrapped(frames, prompts, _generate=generate, _log=log, **kwargs):
                    bucket = kwargs.get("batch_bucket")
                    if not bucketed:
                        kwargs.pop("batch_bucket", None)
                    out = _generate(frames, prompts, **kwargs)
                    if bucket:  # a chunk of the sweep (re-asks pass no bucket)
                        _log.append(out[2])
                    return out

                monkeypatch.setattr(engine, "generate", wrapped)
            root = tmp_path / ("bucketed" if bucketed else "plain")
            config = make_config(root, continuous_batching=False, segment_batch_per_chip=2)
            config["analyzer"]["prompt_profile"] = "compact"
            pair = analyzers(engines, root, config, name=f"f6_{bucketed}")
            outcomes = []
            for analyzer, _ in pair:
                try:
                    outcomes.append(comparable(analyzer.analyze_video(clip)))
                except RuntimeError as exc:  # every segment's note failed: compared below
                    outcomes.append(str(exc))
            return calls, outcomes

        (j_padded, p_padded), padded_out = run(True)
        (j_plain, p_plain), plain_out = run(False)
        assert [len(ids) for ids in p_padded] == [2, 1]  # two chunks; the last one padded
        assert j_padded[1] != j_plain[1]  # JAX: the pad row moved the real row's tokens
        assert p_padded[1] == p_plain[1] == j_plain[1]  # the port: no pad row in the scales
        assert p_padded == p_plain == j_plain
        assert padded_out[1] == plain_out[1] == plain_out[0]


@pytest.mark.slow
class TestTrainedTinyCheckpoint:
    def test_trained_tiny_bpe_int8(self, tmp_path, monkeypatch):
        """The trained tiny checkpoint through both analyzers' own engine
        construction: BPE, int8 weights, int8 KV, compact prompts, greedy.
        The JAX analyzer restores the orbax checkpoint, the port's its
        ``.npz`` conversion; the JAX mesh is taken over one CPU device.
        Both presets compute in float32 (each package's ``get_preset`` is
        wrapped): in bfloat16 the two engines' roundings differ, and the
        scorecard compares them per topic (``tests/test_torch_grounding.py``),
        not token by token."""
        from dataclasses import replace

        from video_transformer_tpu.models import config as j_models_config
        from video_transformer_tpu.parallel import mesh as j_mesh
        from video_transformer_tpu_torch.models import config as models_config
        from video_transformer_tpu_torch.train.grounded import render_topic_clip

        build = j_mesh.build_mesh
        monkeypatch.setattr(j_mesh, "build_mesh", lambda cfg=None: build(cfg, devices=jax.devices()[:1]))
        for module in (j_models_config, models_config):
            get = module.get_preset
            monkeypatch.setattr(module, "get_preset", lambda name, _get=get: replace(_get(name), dtype="float32"))
        engine_cfg = {
            "model_preset": "tiny", "param_dtype": None, "quantize": "int8", "kv_quant": "int8",
            "max_new_tokens": 1536, "temperature": 0.0, "structure_bias": 0.0, "max_forced_run": 2,
            "tokenizer": {"type": "bpe", "path": str(REPO / "data" / "tokenizers" / "bpe-zh-2048.json")},
            "mesh": {"data": 1, "model": 1},
        }
        clip = tmp_path / "topic.npzv"
        write_npzv(clip, render_topic_clip(0, 16, 64), fps=4.0)
        results = []
        for side, cls, counter_cls, checkpoint in (
            ("j", JAnalyzer, JCounter, REPO / "data" / "checkpoints" / "tiny-zh-grounded-r5mix" / "params_4500"),
            ("p", ContentAnalyzer, APICounter, REPO / "data" / "torch_weights" / "tiny-zh-grounded-r5mix-params_4500.npz"),
        ):
            config = make_config(tmp_path / side)
            config["analyzer"]["prompt_profile"] = "compact"
            config["engine"] = dict(engine_cfg, checkpoint_dir=str(checkpoint))
            logger = logging.getLogger(f"vtx.e2e.trained.{side}")
            logger.setLevel(logging.INFO)
            handler = Capture()
            logger.handlers = [handler]
            analyzer = cls(config, counter_cls(10), logger, **({"device": "cpu"} if side == "p" else {}))
            results.append((analyzer, analyzer.analyze_video(clip), handler))
        (ja, want, jh), (pa, got, ph) = results
        assert events(ph, "event=engine_restored") and events(jh, "event=engine_restored")
        assert_same(want, got, ja, pa, modes=("static", "lecture"))
