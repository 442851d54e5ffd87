#!/usr/bin/env python3
"""Convert an orbax parameter checkpoint into one numpy ``.npz`` file.

The PyTorch port (``video_transformer_tpu_torch``) imports neither JAX nor
orbax, so the trained checkpoints cross over as plain arrays: this tool runs
on a host with JAX and orbax, and the port reads its output with
``weights.load_npz`` (``InferenceEngine.restore`` takes the file directly).

  python tools/orbax_to_npz.py data/checkpoints/tiny-zh-grounded-r5mix/params_4500 \\
      data/torch_weights/tiny-zh-grounded-r5mix-params_4500.npz

``SRC`` is a ``params_N`` directory, or a parent of several (the highest
step is taken, as the JAX engine's ``restore`` does). Each key of the file
is a leaf's path joined by ``/`` (``params/decoder/layer_0/attn/q/kernel``).
Leaves keep their dtype: a bfloat16 leaf is stored as its uint16 bits, and
the ``__index__`` array (one ``[key, dtype name]`` row per leaf) records
every leaf's dtype (``weights.save_npz``). Nothing is pickled.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:  # run as a script from anywhere
    sys.path.insert(0, str(REPO))

from video_transformer_tpu_torch.parallel.engine import resolve_params_dir  # noqa: E402
from video_transformer_tpu_torch.weights import save_npz  # noqa: E402


def _leaves(tree: dict, prefix: str = ""):
    for key in sorted(tree):
        value = tree[key]
        if isinstance(value, dict):
            yield from _leaves(value, f"{prefix}{key}/")
        else:
            yield prefix + key, value


def restore_arrays(src: str | Path) -> dict[str, np.ndarray]:
    """``{path: numpy leaf}`` of an orbax checkpoint, restored on the CPU
    with no template (the saved dtypes are kept)."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    import orbax.checkpoint as ocp

    path = resolve_params_dir(src)
    if not path.is_dir():
        raise FileNotFoundError(f"no checkpoint at {path}")
    with ocp.StandardCheckpointer() as checkpointer:
        tree = checkpointer.restore(str(path.resolve()))
    return {key: np.asarray(leaf) for key, leaf in _leaves(tree)}


def convert(src: str | Path, dst: str | Path) -> Path:
    """Write ``src``'s leaves to ``dst`` (``.npz``); returns the path."""
    return save_npz(dst, restore_arrays(src))


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("src", help="params_N directory or a parent of several")
    parser.add_argument("dst", help="output .npz path")
    args = parser.parse_args(argv)
    out = convert(args.src, args.dst)
    print(f"{resolve_params_dir(args.src)} -> {out} ({out.stat().st_size} bytes)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
