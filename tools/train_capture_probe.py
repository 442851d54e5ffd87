"""Where a training step's first call on the graph route spends its time.

``Trainer.step`` on one card runs a key's first step eagerly on the graphs'
side stream (``GraphPool.warm``), then captures one step into a CUDA graph
(``StepGraph``), whose ``torch.cuda.graph`` first empties the allocator's
cache and then allocates the graph's private pool. This script builds a
trainer at the training CLI's shapes (seeded random f32 weights, batch
``--batch``, ``--text-len`` text positions after the video's), then times,
each after a device sync: one eager step on the current stream (the
process's first), the warm-up on the side stream, ``torch.cuda.empty_cache``
alone, the capture (which now only allocates its pool and records), a
second capture of the same step into the same pool (its blocks free and
reused: the capture without the pool's first allocation), and replays.
Prints one JSON line with the seconds and the allocator's reserved GiB
after each, then the card's name and power limit.

    python tools/train_capture_probe.py [--preset base] [--batch 2] [--text-len 2048] [--replays 5]
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from dataclasses import replace
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from video_transformer_tpu_torch.models.bpe import BpeTokenizer  # noqa: E402
from video_transformer_tpu_torch.models.config import get_preset  # noqa: E402
from video_transformer_tpu_torch.parallel.graphs import StepGraph  # noqa: E402
from video_transformer_tpu_torch.train.data import synthetic_batch  # noqa: E402
from video_transformer_tpu_torch.train.trainer import TRAIN_COUNTERS, TrainConfig, Trainer  # noqa: E402

TOKENIZER = Path(__file__).resolve().parents[1] / "data" / "tokenizers" / "bpe-zh-2048.json"


def timed(fn) -> float:
    torch.cuda.synchronize()
    start = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return time.perf_counter() - start


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--preset", default="base")
    parser.add_argument("--batch", type=int, default=2)
    parser.add_argument("--text-len", type=int, default=2048)
    parser.add_argument("--replays", type=int, default=5)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("train_capture_probe: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    config = get_preset(args.preset)
    config = replace(config, decoder=replace(config.decoder, vocab_size=BpeTokenizer.load(TOKENIZER).vocab_size))
    trainer = Trainer(config, TrainConfig(warmup_steps=1, total_steps=10), device="cuda")
    patches, tokens = synthetic_batch(np.random.default_rng(0), config, args.batch, args.text_len)
    prompt_lens = np.zeros((args.batch,), np.int32)
    entry = trainer._step_entry(patches, tokens, prompt_lens)
    pool = trainer._graph_pool

    def body() -> None:
        trainer._step_body(entry, True)

    gib = 2.0**30
    out = {"preset": config.name, "batch": args.batch, "positions": config.video_tokens + args.text_len}
    out["eager_first_step_s"] = timed(body)
    out["reserved_after_eager_gib"] = torch.cuda.memory_reserved() / gib
    out["warm_on_side_stream_s"] = timed(lambda: pool.warm(body))
    out["reserved_after_warm_gib"] = torch.cuda.memory_reserved() / gib
    out["empty_cache_s"] = timed(torch.cuda.empty_cache)
    out["reserved_after_empty_gib"] = torch.cuda.memory_reserved() / gib
    graphs = []
    out["capture_s"] = timed(lambda: graphs.append(StepGraph(body, 1, pool, TRAIN_COUNTERS)))
    out["capture_inner_s"] = graphs[0].seconds
    out["reserved_after_capture_gib"] = torch.cuda.memory_reserved() / gib
    out["capture_again_s"] = timed(lambda: graphs.append(StepGraph(body, 1, pool, TRAIN_COUNTERS)))
    out["reserved_after_capture_again_gib"] = torch.cuda.memory_reserved() / gib
    out["replay_s"] = [timed(graphs[0].replay) for _ in range(args.replays)]
    print(json.dumps(out), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())


if __name__ == "__main__":
    main()
