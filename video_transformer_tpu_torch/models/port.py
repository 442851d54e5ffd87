"""Weight porting: HF Qwen2-VL state dicts -> the port's parameter tree.

This package's counterpart of the JAX package's ``models/port.py``. The
``qwen2vl-7b`` preset has Qwen2-VL-7B's geometry, so a hub checkpoint loads
as it is. The decoder's names map as

  model.embed_tokens.weight                        -> decoder/embed/embedding
  model.layers.{i}.input_layernorm.weight         -> decoder/layer_{i}/attn_norm/weight
  model.layers.{i}.self_attn.{q,k,v}_proj.weight  -> .../attn/{q,k,v}/kernel (T)
  model.layers.{i}.self_attn.{q,k,v}_proj.bias    -> .../attn/{q,k,v}/bias
  model.layers.{i}.self_attn.o_proj.weight        -> .../attn/out/kernel (T)
  model.layers.{i}.post_attention_layernorm.weight -> .../mlp_norm/weight
  model.layers.{i}.mlp.{gate,up,down}_proj.weight -> .../mlp/{gate,up,down}/kernel (T)
  model.norm.weight                                -> decoder/final_norm/weight
  lm_head.weight                                   -> decoder/lm_head (untied, [V, H])

and the vision tower's (``models/qwen_vit.py``) as

  visual.patch_embed.proj.weight [D, 3, Tp, P, P] -> visual/patch_embed/kernel
      (reshape(D, -1).T: the flattening (c, t, h, w) is qwen_patchify's layout)
  visual.blocks.{i}.norm{1,2}.{weight,bias}  -> visual/block_{i}/norm{1,2}_{scale,bias}
  visual.blocks.{i}.attn.qkv.{weight,bias}   -> visual/block_{i}/qkv (T)
  visual.blocks.{i}.attn.proj.{weight,bias}  -> visual/block_{i}/proj (T)
  visual.blocks.{i}.mlp.fc{1,2}.{weight,bias} -> visual/block_{i}/fc{1,2} (T)
  visual.merger.ln_q.{weight,bias}           -> visual/merger_ln_{scale,bias}
  visual.merger.mlp.{0,2}.{weight,bias}      -> visual/merger_fc{1,2} (T)

Torch linear weights are [out, in] and the port's dense kernels [in, out],
so every projection is transposed (T); biases and the [V, H] lm_head are
kept as they are. Leaves are torch tensors in the checkpoint's dtype.

``read_safetensors`` reads the safetensors format with numpy, without the
``safetensors`` package: an 8-byte little-endian header length, a JSON
header of ``dtype`` / ``shape`` / ``data_offsets``, then the raw
little-endian data. BF16 arrives as uint16 bits viewed as
``torch.bfloat16``; a dtype outside ``SAFETENSORS_DTYPES`` raises.
"""

from __future__ import annotations

import json
import logging
from pathlib import Path
from typing import Any, Mapping

import numpy as np
import torch

from ..weights import to_tensor
from .config import DecoderConfig, EncoderConfig
from .qwen_vit import QwenVisionConfig

__all__ = [
    "SAFETENSORS_DTYPES",
    "checkpoint_shard_paths",
    "decoder_key_map",
    "load_qwen2vl_dir",
    "load_safetensors",
    "normalize_qwen2vl_keys",
    "port_decoder_state",
    "port_vision_state",
    "read_safetensors",
    "vision_key_map",
]

logger = logging.getLogger("video_transformer")

# safetensors dtype -> (numpy dtype of the stored bits, torch dtype of the leaf)
SAFETENSORS_DTYPES = {
    "F64": ("<f8", torch.float64),
    "F32": ("<f4", torch.float32),
    "F16": ("<f2", torch.float16),
    "BF16": ("<u2", torch.bfloat16),
    "I64": ("<i8", torch.int64),
    "I32": ("<i4", torch.int32),
    "I16": ("<i2", torch.int16),
    "I8": ("i1", torch.int8),
    "U8": ("u1", torch.uint8),
    "BOOL": ("?", torch.bool),
}


def read_safetensors(path: str | Path) -> dict[str, torch.Tensor]:
    """Every tensor of one ``.safetensors`` file, as CPU torch tensors.

    Raises on a truncated header, an unknown dtype, or data offsets that do
    not fit the tensor's shape or the file."""
    path = Path(path)
    out: dict[str, torch.Tensor] = {}
    with open(path, "rb") as fh:
        head = fh.read(8)
        if len(head) != 8:
            raise ValueError(f"{path}: not a safetensors file (no header length)")
        header_len = int.from_bytes(head, "little")
        raw = fh.read(header_len)
        if len(raw) != header_len:
            raise ValueError(f"{path}: header of {header_len} bytes is truncated")
        header = json.loads(raw.decode("utf-8"))
        data_start = 8 + header_len
        data_len = path.stat().st_size - data_start
        for name, info in header.items():
            if name == "__metadata__":
                continue
            dtype = info["dtype"]
            if dtype not in SAFETENSORS_DTYPES:
                raise ValueError(f"{path}: tensor {name} has unsupported dtype {dtype}")
            np_dtype, torch_dtype = SAFETENSORS_DTYPES[dtype]
            shape = tuple(int(n) for n in info["shape"])
            begin, end = (int(n) for n in info["data_offsets"])
            count = int(np.prod(shape, dtype=np.int64))
            if not 0 <= begin <= end <= data_len or end - begin != count * np.dtype(np_dtype).itemsize:
                raise ValueError(f"{path}: tensor {name} has data offsets {begin}-{end} that do not fit {shape}")
            fh.seek(data_start + begin)
            array = np.fromfile(fh, dtype=np_dtype, count=count).reshape(shape)
            tensor = torch.from_numpy(array)
            out[name] = tensor.view(torch_dtype) if torch_dtype == torch.bfloat16 else tensor
    return out


def load_safetensors(paths: list[str | Path]) -> dict[str, torch.Tensor]:
    """(Sharded) safetensors files merged into one state dict."""
    state: dict[str, torch.Tensor] = {}
    for path in paths:
        state.update(read_safetensors(path))
    return state


def normalize_qwen2vl_keys(state: Mapping[str, Any]) -> dict[str, Any]:
    """Rename transformers>=4.52 in-memory names to the hub checkpoint layout
    (``model.language_model.`` -> ``model.``, ``model.visual.`` ->
    ``visual.``); hub-layout names pass unchanged."""
    out: dict[str, Any] = {}
    for key, value in state.items():
        if key.startswith("model.language_model."):
            key = "model." + key[len("model.language_model."):]
        elif key.startswith("model.visual."):
            key = key[len("model."):]
        out[key] = value
    return out


def decoder_key_map(
    num_layers: int, qkv_bias: bool = False, tied_embeddings: bool = True
) -> dict[str, tuple[tuple[str, ...], bool]]:
    """HF name -> (parameter path under the VideoLM tree, transpose?)."""
    mapping: dict[str, tuple[tuple[str, ...], bool]] = {
        "model.embed_tokens.weight": (("decoder", "embed", "embedding"), False),
        "model.norm.weight": (("decoder", "final_norm", "weight"), False),
    }
    if not tied_embeddings:
        mapping["lm_head.weight"] = (("decoder", "lm_head"), False)
    for i in range(num_layers):
        hf, fx = f"model.layers.{i}", f"layer_{i}"
        mapping[f"{hf}.input_layernorm.weight"] = (("decoder", fx, "attn_norm", "weight"), False)
        mapping[f"{hf}.post_attention_layernorm.weight"] = (("decoder", fx, "mlp_norm", "weight"), False)
        for src, dst in (("q_proj", "q"), ("k_proj", "k"), ("v_proj", "v"), ("o_proj", "out")):
            mapping[f"{hf}.self_attn.{src}.weight"] = (("decoder", fx, "attn", dst, "kernel"), True)
        if qkv_bias:
            for src, dst in (("q_proj", "q"), ("k_proj", "k"), ("v_proj", "v")):
                mapping[f"{hf}.self_attn.{src}.bias"] = (("decoder", fx, "attn", dst, "bias"), False)
        for src, dst in (("gate_proj", "gate"), ("up_proj", "up"), ("down_proj", "down")):
            mapping[f"{hf}.mlp.{src}.weight"] = (("decoder", fx, "mlp", dst, "kernel"), True)
    return mapping


def _leaf(value: Any, transpose: bool) -> torch.Tensor:
    tensor = to_tensor(value)
    return tensor.T.contiguous() if transpose else tensor


def _set_path(tree: dict, path: tuple[str, ...], value: Any) -> None:
    node = tree
    for key in path[:-1]:
        node = node.setdefault(key, {})
    node[path[-1]] = value


def _expected_shape(path: tuple[str, ...], config: DecoderConfig) -> tuple[int, ...] | None:
    h = config.hidden_dim
    q_dim = config.num_heads * config.head_dim
    kv_dim = config.num_kv_heads * config.head_dim
    if path[-2:] == ("embed", "embedding") or path[-1] == "lm_head":
        return (config.vocab_size, h)
    if path[-1] == "weight":  # norms
        return (h,)
    return {
        ("q", "kernel"): (h, q_dim),
        ("k", "kernel"): (h, kv_dim),
        ("v", "kernel"): (h, kv_dim),
        ("out", "kernel"): (q_dim, h),
        ("gate", "kernel"): (h, config.mlp_dim),
        ("up", "kernel"): (h, config.mlp_dim),
        ("down", "kernel"): (config.mlp_dim, h),
        ("q", "bias"): (q_dim,),
        ("k", "bias"): (kv_dim,),
        ("v", "bias"): (kv_dim,),
    }.get(path[-2:])


def port_decoder_state(state: Mapping[str, Any], config: DecoderConfig, strict: bool = True) -> dict[str, Any]:
    """The ``{"decoder": ...}`` subtree of an HF-style state dict (numpy
    arrays or torch tensors). ``strict`` raises on missing keys; otherwise
    what is found is ported. A shape that does not fit ``config`` raises."""
    mapping = decoder_key_map(config.num_layers, qkv_bias=config.qkv_bias, tied_embeddings=config.tied_embeddings)
    tree: dict[str, Any] = {}
    missing: list[str] = []
    for hf_name, (path, transpose) in mapping.items():
        if hf_name not in state:
            missing.append(hf_name)
            continue
        leaf = _leaf(state[hf_name], transpose)
        expected = _expected_shape(path, config)
        if expected is not None and tuple(leaf.shape) != expected:
            raise ValueError(f"{hf_name}: shape {tuple(leaf.shape)} != expected {expected} for {'/'.join(path)}")
        _set_path(tree, path, leaf)
    unmapped = [k for k in state if k not in mapping and not k.startswith("visual.")]
    if unmapped:
        logger.warning(
            f"event=port_unmapped_keys count={len(unmapped)} sample={unmapped[:4]} "
            f"(config qkv_bias={config.qkv_bias} tied_embeddings={config.tied_embeddings})"
        )
    if missing:
        if strict:
            raise KeyError(f"state dict missing {len(missing)} keys: {missing[:4]}...")
        logger.warning(f"event=port_missing_keys count={len(missing)}")
    return tree


def vision_key_map(depth: int) -> dict[str, tuple[tuple[str, ...], bool]]:
    """HF vision name -> (parameter path under the tower, transpose?)."""
    mapping: dict[str, tuple[tuple[str, ...], bool]] = {
        "merger.ln_q.weight": (("merger_ln_scale",), False),
        "merger.ln_q.bias": (("merger_ln_bias",), False),
        "merger.mlp.0.weight": (("merger_fc1", "kernel"), True),
        "merger.mlp.0.bias": (("merger_fc1", "bias"), False),
        "merger.mlp.2.weight": (("merger_fc2", "kernel"), True),
        "merger.mlp.2.bias": (("merger_fc2", "bias"), False),
    }
    for i in range(depth):
        hf, fx = f"blocks.{i}", f"block_{i}"
        for norm in ("norm1", "norm2"):
            mapping[f"{hf}.{norm}.weight"] = ((fx, f"{norm}_scale"), False)
            mapping[f"{hf}.{norm}.bias"] = ((fx, f"{norm}_bias"), False)
        for src, dst in (("attn.qkv", "qkv"), ("attn.proj", "proj"), ("mlp.fc1", "fc1"), ("mlp.fc2", "fc2")):
            mapping[f"{hf}.{src}.weight"] = ((fx, dst, "kernel"), True)
            mapping[f"{hf}.{src}.bias"] = ((fx, dst, "bias"), False)
    return mapping


def port_vision_state(state: Mapping[str, Any], config: QwenVisionConfig, strict: bool = True) -> dict[str, Any]:
    """The tower's parameter tree from an HF vision state dict; names with
    or without the ``visual.`` prefix (a full model's or a tower's)."""
    state = {(k[len("visual."):] if k.startswith("visual.") else k): v for k, v in state.items()}
    tree: dict[str, Any] = {}
    missing: list[str] = []
    conv_key = "patch_embed.proj.weight"
    if conv_key in state:
        conv = to_tensor(state[conv_key])
        expected = (config.embed_dim, config.in_channels, config.temporal_patch_size,
                    config.patch_size, config.patch_size)
        if tuple(conv.shape) != expected:
            raise ValueError(f"{conv_key}: shape {tuple(conv.shape)} != expected {expected}")
        # A conv3d with stride == kernel is a product; reshape(D, -1) flattens
        # (c, t, h, w), qwen_patchify's patch layout.
        _set_path(tree, ("patch_embed", "kernel"), conv.reshape(conv.shape[0], -1).T.contiguous())
    else:
        missing.append(conv_key)
    for hf_name, (path, transpose) in vision_key_map(config.depth).items():
        if hf_name not in state:
            missing.append(hf_name)
            continue
        _set_path(tree, path, _leaf(state[hf_name], transpose))
    if missing:
        if strict:
            raise KeyError(f"vision state dict missing {len(missing)} keys: {missing[:4]}...")
        logger.warning(f"event=port_vision_missing_keys count={len(missing)}")
    return tree


def checkpoint_shard_paths(directory: str | Path) -> list[str]:
    """The shard files of an HF checkpoint directory: those that
    ``model.safetensors.index.json``'s weight_map names, else every
    ``*.safetensors``."""
    d = Path(directory)
    index = d / "model.safetensors.index.json"
    if index.exists():
        weight_map = json.loads(index.read_text())["weight_map"]
        return sorted({str(d / shard) for shard in weight_map.values()})
    return sorted(str(p) for p in d.glob("*.safetensors"))


def load_qwen2vl_dir(directory: str | Path, config, strict: bool = True) -> dict[str, Any]:
    """An HF Qwen2-VL checkpoint directory (sharded safetensors + index)
    -> the ``{"decoder": ..., "visual": ...}`` tree that goes under
    ``params`` of a VideoLM of the matching preset (``qwen2vl-7b``).

    ``config`` is the VLMConfig; its encoder must be a QwenVisionConfig, as
    the native encoder has no HF counterpart.
    ``InferenceEngine.restore`` calls this for a directory of safetensors.
    """
    if isinstance(config.encoder, EncoderConfig):
        raise ValueError(
            "HF checkpoint load needs a ported-tower preset (QwenVisionConfig encoder, e.g. "
            f"get_preset('qwen2vl-7b')); the native VideoEncoder has no HF counterpart (config: {config.name})"
        )
    paths = checkpoint_shard_paths(directory)
    if not paths:
        raise FileNotFoundError(f"no .safetensors shards under {directory}")
    logger.info(f"event=hf_checkpoint_load dir={directory} shards={len(paths)}")
    state = normalize_qwen2vl_keys(load_safetensors(paths))
    tree = port_decoder_state(state, config.decoder, strict=strict)
    tree["visual"] = port_vision_state(state, config.encoder, strict=strict)
    return tree
