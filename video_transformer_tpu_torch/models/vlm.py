"""VideoLM: encoder -> GELU projector -> decoder, the video-language model.

With a ported Qwen2-VL tower (a ``QwenVisionConfig`` encoder) the tower is
the ``visual`` module and there is no projector: its PatchMerger already
lands in the decoder's width.

Methods map onto the inference engine's phases: ``encode_video`` (patches ->
projected video embeddings), ``prefill`` (video embeddings + prompt tokens
-> KV cache + each row's last logits), ``prefill_text`` (the same without
video: validator, consolidation and rewrite passes) and ``decode_block_pick`` (a block of
tokens against the cache, logits at one position per row). ``forward`` is
the teacher-forced training forward (video + text -> logits).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .config import EncoderConfig, VLMConfig
from .lm import Cache, Decoder
from .qwen_vit import QwenVisionEncoder
from .vit import Dense, VideoEncoder

__all__ = ["VideoLM"]


class VideoLM(nn.Module):
    def __init__(self, config: VLMConfig):
        super().__init__()
        self.config = config
        self.ported_vision = not isinstance(config.encoder, EncoderConfig)
        if self.ported_vision:
            if config.encoder.hidden_size != config.decoder.hidden_dim:
                raise ValueError(
                    f"vision hidden_size {config.encoder.hidden_size} != "
                    f"decoder hidden_dim {config.decoder.hidden_dim}"
                )
            self.visual = QwenVisionEncoder(config.encoder)
        else:
            self.encoder = VideoEncoder(config.encoder)
            self.projector_up = Dense(config.encoder.hidden_dim, config.decoder.hidden_dim)
            self.projector_down = Dense(config.decoder.hidden_dim, config.decoder.hidden_dim)
        self.decoder = Decoder(config.decoder)

    @property
    def compute_dtype(self) -> torch.dtype:
        return getattr(torch, self.config.dtype)

    def encode_video(self, patches: torch.Tensor) -> torch.Tensor:
        """[B, N, patch_dim] -> [B, Nv, decoder_hidden] video embeddings.

        Nv is N for the native encoder and N / 4 for a ported tower, whose
        merger output is returned in the compute type. The native
        projector computes in the promotion of the compute type with its
        weights' type, and its GELU is the tanh approximation (flax's
        ``nn.gelu`` default).
        """
        dtype = self.compute_dtype
        if self.ported_vision:
            return self.visual(patches, dtype=dtype).to(dtype)
        encoded = self.encoder(patches, dtype=dtype)
        hidden = F.gelu(self.projector_up(encoded.to(dtype)), approximate="tanh")
        return self.projector_down(hidden).to(dtype)

    def _splice(self, video_embeds: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
        """Concatenate video embeddings ahead of token embeddings."""
        text = self.decoder.embed_tokens(tokens, self.compute_dtype)
        return torch.cat([video_embeds, text], dim=1)

    @staticmethod
    def _ragged_last(logits, cache: Cache, lengths, offset: int):
        """Per-row last-valid logits, and the cache index set after them."""
        pos = offset + lengths.long() - 1
        last = logits[torch.arange(logits.shape[0], device=logits.device), pos]
        cache["index"] = (offset + lengths).to(torch.int32)
        return last, cache

    def prefill(self, patches, prompt_tokens, cache: Cache, lengths):
        """Encode video + prompt and fill the KV cache -> (last_logits, cache).

        ``lengths`` [B] counts each row's valid prompt positions."""
        video_embeds = self.encode_video(patches)
        inputs = self._splice(video_embeds, prompt_tokens)
        logits, cache = self.decoder(inputs, cache=cache, dtype=self.compute_dtype, prefill=True)
        return self._ragged_last(logits, cache, lengths, video_embeds.shape[1])

    def prefill_text(self, prompt_tokens, cache: Cache, lengths):
        """Text-only prefill -> (last_logits, cache); ``lengths`` [B] counts
        each row's valid positions (continuation prefixes are ragged)."""
        logits, cache = self.decoder(prompt_tokens, cache=cache, dtype=self.compute_dtype, prefill=True)
        return self._ragged_last(logits, cache, lengths, 0)

    def decode_block_pick(self, tokens, cache: Cache, pick):
        """[B, W] tokens -> (logits [B, V] at column ``pick`` [B], cache)."""
        logits, cache = self.decoder(tokens, cache=cache, dtype=self.compute_dtype, logits_at=pick)
        return logits[:, 0, :], cache

    def forward(self, patches: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
        """Training forward: logits [B, Nv + St, V] with teacher forcing."""
        inputs = self._splice(self.encode_video(patches), tokens)
        logits, _ = self.decoder(inputs, cache=None, dtype=self.compute_dtype)
        return logits
