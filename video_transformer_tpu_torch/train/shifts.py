"""Held-out style shifts: the out-of-distribution grounding harness.

Everything the shipped checkpoints were distilled on is synthetic
(train/grounded.py), and every grounding eval so far rendered clips from
the SAME pipeline the trainer uses — so a high score cannot distinguish
"reads the visual signature" from "memorized the render distribution".
This module supplies the missing generalization axis (VERDICT round-2,
Missing #2: an out-of-bank eval set "can be built now"): label-preserving
transformations that the training augmentation NEVER produces.

Training jitter (train/run.py::_grounded_batches.augment) is exactly
{brightness gain 0.82-1.18, offset +-12, sensor noise sigma<=6, temporal
roll, spatial roll}. Each shift below is categorically outside that set,
yet preserves all three signature channels (hue pair, stripe
orientation/frequency, moving-shape count), so the clip's topic label
stays valid:

- ``blur3``        3x3 box blur — low-pass filtering never seen in training;
                   stripe frequencies (2-5 cycles/frame) survive a 3px kernel.
- ``zoom_out``     squeeze to 75% onto a gray canvas (letterboxing); scale
                   change, unlike roll, moves content off the learned patch
                   grid AND rescales stripe frequency.
- ``time_reverse`` play the clip backwards: drift direction flips, per-frame
                   content is intact.
- ``posterize4``   quantize to 4 bits/channel — banding artifacts unseen in
                   training; hue ordering preserved.
- ``noise14``      sensor noise at sigma=14, >2x the training maximum.
- ``contrast``     contrast stretch x1.4 about mid-gray: equivalent to gain
                   1.4 with offset -51, both outside the training envelope.

The grounding score under these shifts (eval_grounding --shifts) measures
what the reference gets for free from Gemini (reference
content_analyzer.py:1296-1300 — a model that genuinely watches arbitrary
video): robustness of frame-reading beyond the training distribution.
"""

from __future__ import annotations

from typing import Callable

import numpy as np

__all__ = ["SHIFT_BANK", "apply_shift"]


def _blur3(frames: np.ndarray, rng: np.random.Generator) -> np.ndarray:
    """3x3 box blur per frame (edge-replicated), vectorized over T."""
    x = frames.astype(np.float32)
    pad = np.pad(x, ((0, 0), (1, 1), (1, 1), (0, 0)), mode="edge")
    out = np.zeros_like(x)
    for dy in (0, 1, 2):
        for dx in (0, 1, 2):
            out += pad[:, dy : dy + x.shape[1], dx : dx + x.shape[2]]
    return np.clip(out / 9.0, 0, 255).astype(np.uint8)


def _zoom_out(frames: np.ndarray, rng: np.random.Generator) -> np.ndarray:
    """Nearest-neighbor squeeze to 75% size, centered on a gray canvas."""
    t, h, w, _ = frames.shape
    nh, nw = int(h * 0.75), int(w * 0.75)
    rows = np.linspace(0, h - 1, nh).round().astype(int)
    cols = np.linspace(0, w - 1, nw).round().astype(int)
    small = frames[:, rows][:, :, cols]
    out = np.full_like(frames, 128)
    y0, x0 = (h - nh) // 2, (w - nw) // 2
    out[:, y0 : y0 + nh, x0 : x0 + nw] = small
    return out


def _time_reverse(frames: np.ndarray, rng: np.random.Generator) -> np.ndarray:
    return frames[::-1].copy()


def _posterize4(frames: np.ndarray, rng: np.random.Generator) -> np.ndarray:
    return ((frames >> 4) << 4) | 8


def _noise14(frames: np.ndarray, rng: np.random.Generator) -> np.ndarray:
    x = frames.astype(np.float32) + rng.normal(0.0, 14.0, frames.shape)
    return np.clip(x, 0, 255).astype(np.uint8)


def _contrast(frames: np.ndarray, rng: np.random.Generator) -> np.ndarray:
    x = (frames.astype(np.float32) - 128.0) * 1.4 + 128.0
    return np.clip(x, 0, 255).astype(np.uint8)


SHIFT_BANK: dict[str, Callable[[np.ndarray, np.random.Generator], np.ndarray]] = {
    "blur3": _blur3,
    "zoom_out": _zoom_out,
    "time_reverse": _time_reverse,
    "posterize4": _posterize4,
    "noise14": _noise14,
    "contrast": _contrast,
}


def apply_shift(
    name: str, frames: np.ndarray, rng: np.random.Generator
) -> np.ndarray:
    """Apply shift ``name`` to a uint8 [T, H, W, 3] clip."""
    if name not in SHIFT_BANK:
        raise KeyError(f"unknown shift {name!r}; have {sorted(SHIFT_BANK)}")
    out = SHIFT_BANK[name](frames, rng)
    assert out.shape == frames.shape and out.dtype == np.uint8
    return out
