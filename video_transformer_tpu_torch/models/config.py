"""Model configuration and size presets.

The same dataclasses and presets as the JAX package's ``models/config.py``,
kept as this package's own copy so the port imports nothing of the JAX
package. Every contraction dimension is a multiple of 128 and head_dim is
128. The ported Qwen2-VL preset waits for its vision tower's port.
"""

from __future__ import annotations

from dataclasses import dataclass, field

__all__ = ["EncoderConfig", "DecoderConfig", "VLMConfig", "get_preset", "PRESETS"]


@dataclass(frozen=True)
class EncoderConfig:
    """Video ViT encoder (tubelet embedding + bidirectional transformer)."""

    hidden_dim: int = 256
    num_layers: int = 2
    num_heads: int = 2
    head_dim: int = 128
    mlp_dim: int = 512
    # Frames are resized to image_size^2 and grouped into (tubelet_t, patch,
    # patch) non-overlapping tubelets.
    image_size: int = 256
    patch_size: int = 16
    tubelet_t: int = 2
    num_frames: int = 8
    dropout: float = 0.0

    @property
    def tokens_per_clip(self) -> int:
        spatial = (self.image_size // self.patch_size) ** 2
        temporal = self.num_frames // self.tubelet_t
        return spatial * temporal

    @property
    def patch_dim(self) -> int:
        return 3 * self.tubelet_t * self.patch_size * self.patch_size


@dataclass(frozen=True)
class DecoderConfig:
    """Decoder-only LM (pre-norm, RoPE, GQA, SwiGLU)."""

    vocab_size: int = 512
    hidden_dim: int = 256
    num_layers: int = 2
    num_heads: int = 2
    num_kv_heads: int = 1
    head_dim: int = 128
    mlp_dim: int = 512
    max_seq_len: int = 4096
    rope_theta: float = 10000.0
    dropout: float = 0.0
    qkv_bias: bool = False
    tied_embeddings: bool = True


@dataclass(frozen=True)
class VLMConfig:
    """Full video-language model: encoder -> projector -> decoder."""

    name: str = "tiny"
    encoder: EncoderConfig = field(default_factory=EncoderConfig)
    decoder: DecoderConfig = field(default_factory=DecoderConfig)
    dtype: str = "bfloat16"  # compute dtype

    @property
    def video_tokens(self) -> int:
        """Tokens the decoder sees per clip."""
        return self.encoder.tokens_per_clip


def _tiny() -> VLMConfig:
    # CPU-test-friendly: 64x64 frames, 4 frames, 2+2 layers, 128-dim heads.
    return VLMConfig(
        name="tiny",
        encoder=EncoderConfig(
            hidden_dim=128, num_layers=2, num_heads=1, head_dim=128,
            mlp_dim=256, image_size=64, patch_size=16, tubelet_t=2,
            num_frames=4,
        ),
        decoder=DecoderConfig(
            vocab_size=512, hidden_dim=128, num_layers=2, num_heads=1,
            num_kv_heads=1, head_dim=128, mlp_dim=256, max_seq_len=8192,
        ),
    )


def _base() -> VLMConfig:
    # ~0.4B params: the shipped serving preset.
    return VLMConfig(
        name="base",
        encoder=EncoderConfig(
            hidden_dim=1024, num_layers=12, num_heads=8, head_dim=128,
            mlp_dim=4096, image_size=256, patch_size=16, tubelet_t=2,
            num_frames=8,
        ),
        decoder=DecoderConfig(
            vocab_size=512, hidden_dim=1024, num_layers=24, num_heads=8,
            num_kv_heads=2, head_dim=128, mlp_dim=4096, max_seq_len=8192,
        ),
    )


def _7b() -> VLMConfig:
    # Qwen2-VL-7B-class body geometry with the small byte vocab.
    return VLMConfig(
        name="7b",
        encoder=EncoderConfig(
            hidden_dim=1280, num_layers=32, num_heads=10, head_dim=128,
            mlp_dim=5120, image_size=256, patch_size=16, tubelet_t=2,
            num_frames=16,
        ),
        decoder=DecoderConfig(
            vocab_size=512, hidden_dim=3584, num_layers=28, num_heads=28,
            num_kv_heads=4, head_dim=128, mlp_dim=18944, max_seq_len=32768,
        ),
    )


PRESETS = {"tiny": _tiny, "base": _base, "7b": _7b}


def get_preset(name: str) -> VLMConfig:
    """Look up a named model preset (tiny / base / 7b)."""
    try:
        return PRESETS[name]()
    except KeyError:
        raise ValueError(f"Unknown model preset {name!r}; options: {sorted(PRESETS)}")
