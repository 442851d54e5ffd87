"""The batcher slice's kernels and the engine's prompt log, against the JAX
package on the CPU.

K4 (``adopt_rows``) and K5 (``decode_attention_update`` on a bf16 cache)
take their plain versions here, because the tensors lie on the CPU. They
are held against the JAX functions: ``adopt_rows`` (its scan fallback) and
the Pallas kernels ``_adopt_rows_pallas`` and
``_decode_attention_update_pallas`` in interpret mode. Inputs are float32,
made with numpy from a seed. The row adoption is a copy and must be exact;
the attention agrees to atol = rtol = 2e-5, the JAX tests' own tolerance
for this kernel (summation order only).
"""

import logging
from dataclasses import replace
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from video_transformer_tpu.models.bpe import BpeTokenizer as JBpe
from video_transformer_tpu.models.config import get_preset as j_get_preset
from video_transformer_tpu.ops import decode_attention as j_dec
from video_transformer_tpu.parallel.engine import InferenceEngine as JEngine
from video_transformer_tpu_torch.models.bpe import BpeTokenizer
from video_transformer_tpu_torch.models.config import get_preset
from video_transformer_tpu_torch.ops import decode_attention as dec
from video_transformer_tpu_torch.ops.decode_attention import (
    adopt_rows,
    adopt_rows_reference,
    decode_attention,
    decode_attention_update,
    write_cache_rows,
)
from video_transformer_tpu_torch.parallel.engine import InferenceEngine

torch.set_num_threads(2)

F32_TOL = 2e-5
TOKENIZER = Path(__file__).resolve().parents[1] / "data" / "tokenizers" / "bpe-zh-2048.json"


def rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


class TestAdoptRows:
    def test_pad_lane_colliding_with_a_valid_row_writes_nothing(self):
        """Lanes at or past ``count`` are no-ops even when their pad row is a
        valid lane's row (the JAX package's pad-lane case); positions past
        park_len and untargeted rows stay untouched."""
        dst = np.zeros((5, 2, 32, 8), np.float32)
        src = np.stack([np.full((2, 16, 8), i + 1.0, np.float32) for i in range(3)])
        rows = np.array([4, 2, 4], np.int32)  # lane 2 is a pad (count=2)
        want = np.asarray(j_dec.adopt_rows(jnp.asarray(dst), jnp.asarray(src), jnp.asarray(rows), jnp.int32(2), 16))
        got = torch.from_numpy(dst.copy())
        adopt_rows(got, torch.from_numpy(src), torch.from_numpy(rows), 2, 16)
        np.testing.assert_array_equal(got.numpy(), want)
        assert (want[4, :, :16] == 1.0).all() and (want[2, :, :16] == 2.0).all()
        assert (want[4, :, 16:] == 0).all() and want[[0, 1, 3]].sum() == 0

    @pytest.mark.parametrize("count", [3, 2, 0])
    def test_matches_jax_scan_and_pallas_interpret(self, count):
        """Random pools, a park region shorter than the staged rows, k and v
        adopted in one call: equal to the JAX scan fallback and to the Pallas
        kernel in interpret mode, for each pool."""
        rng = np.random.default_rng(count)
        pools = [rand(rng, 6, 2, 48, 16) for _ in range(2)]
        staged = [rand(rng, 3, 2, 40, 16) for _ in range(2)]
        rows = np.array([5, 0, 3], np.int32)
        got = [torch.from_numpy(p.copy()) for p in pools]
        adopt_rows(got[0], torch.from_numpy(staged[0]), torch.from_numpy(rows), count, 32,
                   got[1], torch.from_numpy(staged[1]))
        for out, pool, src in zip(got, pools, staged):
            args = (jnp.asarray(pool), jnp.asarray(src), jnp.asarray(rows), jnp.int32(count), 32)
            np.testing.assert_array_equal(out.numpy(), np.asarray(j_dec.adopt_rows(*args)))
            np.testing.assert_array_equal(out.numpy(), np.asarray(j_dec._adopt_rows_pallas(*args, interpret=True)))

    def test_reference_is_the_lane_order_scan(self):
        """The plain version writes lane by lane: a later valid lane on the
        same row wins, as in the scan."""
        dst = torch.zeros(3, 1, 4, 2)
        src = torch.stack([torch.full((1, 4, 2), float(i + 1)) for i in range(3)])
        adopt_rows_reference(dst, src, torch.tensor([1, 1, 2], dtype=torch.int32), 2, 4)
        assert (dst[1] == 2.0).all() and dst[0].sum() == 0 and dst[2].sum() == 0

    def test_wrapper_checks_its_arguments(self):
        dst, src = torch.zeros(2, 1, 4, 2), torch.zeros(1, 1, 4, 2)
        with pytest.raises(ValueError, match="go together"):
            adopt_rows(dst, src, torch.zeros(1, dtype=torch.int32), 1, 4, dst_v=dst)
        meta = torch.empty(2, 1, 4, 128, device="meta", dtype=torch.bfloat16)
        with pytest.raises(ValueError, match="CUDA"):
            adopt_rows(meta, meta[:1], torch.zeros(1, dtype=torch.int32, device="meta"), 1, 4)


def fused_inputs(seed, b=2, hq=4, hkv=2, w=3, s=512, r=None):
    rng = np.random.default_rng(seed)
    r = r or b
    return (rand(rng, b, hq, w, 128), rand(rng, r, hkv, s, 128), rand(rng, r, hkv, s, 128),
            rand(rng, b, hkv, w, 128), rand(rng, b, hkv, w, 128))


class TestFusedUpdate:
    @pytest.mark.parametrize("rows,index,w", [
        (None, (99, 400), 3),
        ((3, 1), (7, 500), 3),
        ((0, 2), (127, 255), 5),  # new rows across the 128- and 256-position block edges
        ((2, 0), (63, 300), 1),
    ])
    def test_matches_pallas_interpret(self, rows, index, w):
        """Output and written cache region equal the JAX fused kernel's;
        the port writes only the W new positions, so everything else equals
        the input cache (the Pallas kernel's aligned slack is not compared)."""
        q, k_cache, v_cache, k_new, v_new = fused_inputs(len(index) + w, w=w, r=None if rows is None else 4)
        index = np.array(index, np.int32)
        rows_np = None if rows is None else np.array(rows, np.int32)
        want, k_want, v_want = j_dec._decode_attention_update_pallas(
            jnp.asarray(q), jnp.asarray(k_cache), jnp.asarray(v_cache), jnp.asarray(k_new), jnp.asarray(v_new),
            jnp.asarray(index), None if rows is None else jnp.asarray(rows_np), interpret=True,
        )
        k_t, v_t = torch.from_numpy(k_cache.copy()), torch.from_numpy(v_cache.copy())
        got = decode_attention_update(
            torch.from_numpy(q), k_t, v_t, torch.from_numpy(k_new), torch.from_numpy(v_new),
            torch.from_numpy(index), None if rows is None else torch.from_numpy(rows_np),
        )
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=F32_TOL, rtol=F32_TOL)
        phys = range(len(index)) if rows is None else rows_np
        for got_cache, want_cache, orig, new in ((k_t, k_want, k_cache, k_new), (v_t, v_want, v_cache, v_new)):
            want_cache, expected = np.asarray(want_cache), orig.copy()
            for logical, row in enumerate(phys):
                hi = index[logical] + w
                np.testing.assert_array_equal(got_cache[row, :, :hi].numpy(), want_cache[row, :, :hi])
                expected[row, :, index[logical]:hi] = new[logical]
            np.testing.assert_array_equal(got_cache.numpy(), expected)

    def test_fused_equals_split_path(self):
        """On a bf16 cache (K5's route on the card) the update gives the row
        write followed by the attention at lengths index + 1, K2 then K3's
        route: the same output and the same caches."""
        q, k_cache, v_cache, k_new, v_new = (torch.from_numpy(a).to(torch.bfloat16) for a in fused_inputs(3, r=3))
        index, rows = torch.tensor([10, 200], dtype=torch.int32), torch.tensor([2, 0], dtype=torch.int32)
        k_fused, v_fused, k_split, v_split = k_cache.clone(), v_cache.clone(), k_cache.clone(), v_cache.clone()
        out = decode_attention_update(q, k_fused, v_fused, k_new, v_new, index, rows)
        write_cache_rows(k_split, v_split, k_new, v_new, index, rows)
        want = decode_attention(q, k_split, v_split, index + 1, rows)
        assert torch.equal(out, want) and torch.equal(k_fused, k_split) and torch.equal(v_fused, v_split)

    @staticmethod
    def routes(monkeypatch, cache_dtype, **scales) -> list[str]:
        """The kernels ``decode_attention_update`` would launch for a cache
        of ``cache_dtype`` off the CPU (meta tensors; the launches recorded)."""
        launched = []
        monkeypatch.setattr(dec, "_fused_update", lambda *a: launched.append("K5"))
        monkeypatch.setattr(dec, "write_cache_rows", lambda *a, **scales: launched.append("K2"))
        monkeypatch.setattr(dec, "decode_attention", lambda *a: launched.append("K3"))
        meta = {"device": "meta"}
        q = torch.empty(2, 4, 3, 128, dtype=torch.bfloat16, **meta)
        cache = torch.empty(2, 2, 512, 128, dtype=cache_dtype, **meta)
        new = torch.empty(2, 2, 3, 128, dtype=torch.bfloat16, **meta)
        index = torch.empty(2, dtype=torch.int32, **meta)
        scales = {k: v.to("meta") for k, v in scales.items()}
        decode_attention_update(q, cache, cache.clone(), new, new.clone(), index, **scales)
        return launched

    def test_int8_cache_refuses_the_fused_route(self, monkeypatch):
        """An int8 cache needs the quantizing split path, as in the JAX
        package: K2 then K3, never K5."""
        scale = torch.full((2,), 0.02)
        assert self.routes(monkeypatch, torch.int8, k_scale=scale, v_scale=scale) == ["K2", "K3"]

    def test_bf16_cache_takes_the_fused_route(self, monkeypatch):
        """A bf16 cache off the CPU writes and attends in one K5 launch."""
        assert self.routes(monkeypatch, torch.bfloat16) == ["K5"]


def test_prompt_truncation_is_logged_as_in_jax(caplog):
    """An over-long prompt logs ``event=prompt_truncated`` with the JAX
    engine's count and prompt_len (F2)."""
    prompts = ["长提示 " * 80, "short", "another long prompt " * 30]
    j_tok = JBpe.load(TOKENIZER)
    j_cfg = j_get_preset("tiny")
    j_engine = JEngine(replace(j_cfg, decoder=replace(j_cfg.decoder, vocab_size=j_tok.vocab_size)),
                       tokenizer=j_tok, compilation_cache_dir=None)
    tok = BpeTokenizer.load(TOKENIZER)
    cfg = get_preset("tiny")
    engine = InferenceEngine(replace(cfg, dtype="float32", decoder=replace(cfg.decoder, vocab_size=tok.vocab_size)),
                             tokenizer=tok, max_new_tokens=2, temperature=0.0, device="cpu")
    frames = np.random.default_rng(0).integers(0, 256, (3, 4, 64, 64, 3), dtype=np.uint8)

    def logged(call) -> list[str]:
        caplog.clear()
        with caplog.at_level(logging.WARNING, logger="video_transformer"):
            call()
        return [r.getMessage() for r in caplog.records if r.name == "video_transformer" and r.levelno == logging.WARNING]

    want = logged(lambda: j_engine._assemble_inputs(prompts, None, 3, 128, None, with_video=True))
    got = logged(lambda: engine.generate(frames, prompts, prompt_len=128))
    assert want == ["event=prompt_truncated count=2 prompt_len=128"]
    assert got == want
    assert logged(lambda: engine.generate(frames, prompts)) == []  # the auto bucket fits every prompt
