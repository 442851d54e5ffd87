"""The port's ContentAnalyzer against the JAX package's: segment sweeps
through the continuous batcher (CPU).

The setting of ``tests/test_torch_analyzer_e2e.py`` (same micro weights in
both engines, greedy, ``note_dfa(512, scale=0.25)``): a three-segment
sweep forced through the batcher with two slots, and the shipped
``continuous_batching: auto``, which sends a sweep of more segments than
one batch to the batcher. The ``AnalysisResult``s must be equal (timings
aside) and the reports byte-equal.
"""

from test_torch_analyzer_e2e import (  # noqa: F401  (pair is a fixture)
    ContentAnalyzer,
    JAnalyzer,
    analyzers,
    assert_same,
    events,
    log_lines,
    make_config,
    pair,
    write_clip,
)


class TestBatcherRoute:
    def test_segmented_batcher_route(self, pair, tmp_path):
        """``continuous_batching: true`` with two slots: the sweep goes
        through the ContinuousBatcher, with the JAX batcher's notes."""
        clip = write_clip(tmp_path / "served.npzv", seconds=30, seed=1)
        config = make_config(tmp_path, continuous_batching=True, serving_slots_per_chip=2)
        (ja, jh), (pa, ph) = analyzers(pair, tmp_path, config, name="batcher_route")
        want, got = ja.analyze_video(clip), pa.analyze_video(clip)
        assert events(ph, "event=segment_serving slots=2 segments=3")
        assert got.metadata["segments_analyzed"] == 3
        assert_same(want, got, ja, pa)
        assert log_lines(ph) == log_lines(jh)

    def test_auto_routes_multi_wave_sweeps_to_the_batcher(self, pair, tmp_path):
        """The shipped ``auto``: more segments than one batch go to the
        batcher, one batch's worth to the engine."""
        clip = write_clip(tmp_path / "auto.npzv", seconds=30, seed=2)
        config = make_config(tmp_path, continuous_batching="auto", segment_batch_per_chip=2,
                             serving_slots_per_chip=2)
        (ja, jh), (pa, ph) = analyzers(pair, tmp_path, config, name="auto_route")
        want, got = ja.analyze_video(clip), pa.analyze_video(clip)
        assert events(ph, "event=segment_serving slots=2 segments=3")
        assert_same(want, got, ja, pa)
        assert ContentAnalyzer._route_to_batcher(3, 32, 8, "auto") is False
        for args in [(3, 2, 2, "auto"), (3, 32, 2, None), (2, 1, 2, True), (5, 8, 2, True), (9, 8, 8, False)]:
            assert ContentAnalyzer._route_to_batcher(*args) == JAnalyzer._route_to_batcher(*args)

