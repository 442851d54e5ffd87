"""The weight bridge: JAX parameter trees -> the port's VideoLM, and seeded
random weights made directly on the device.

The port's parameter names are the JAX package's parameter paths joined by dots
(``params/decoder/layer_0/attn/q/kernel`` -> ``decoder.layer_0.attn.q.kernel``;
``quant/decoder/.../scale`` -> ``...q.scale``), and dense kernels keep flax's
[in, out] layout, so the bridge is a rename and nothing is transposed.
"""

from __future__ import annotations

import math
from typing import Any, Iterator

import numpy as np
import torch

from .models.config import VLMConfig
from .models.vlm import VideoLM

__all__ = ["cast_weights", "from_jax_params", "random_params"]


def _flatten(tree: dict, prefix: str = "") -> Iterator[tuple[str, Any]]:
    for key, value in tree.items():
        if isinstance(value, dict):
            yield from _flatten(value, f"{prefix}{key}.")
        else:
            yield prefix + key, value


def _to_tensor(array: Any) -> torch.Tensor:
    array = np.asarray(array)
    if array.dtype.name == "bfloat16":  # ml_dtypes bfloat16: same bits as torch's
        return torch.from_numpy(array.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(array, copy=True, order="C"))


def _assign(model: torch.nn.Module, name: str, tensor: torch.Tensor) -> None:
    """Set a parameter or buffer by its dotted name; a float parameter
    requires grad, an int8 or uint8 one does not."""
    owner_name, _, leaf = name.rpartition(".")
    owner = model.get_submodule(owner_name)
    if leaf in owner._parameters:
        tensor = torch.nn.Parameter(tensor, requires_grad=tensor.is_floating_point())
    setattr(owner, leaf, tensor)


def _check_shape(model: torch.nn.Module, name: str, tensor: torch.Tensor) -> None:
    """Raise unless ``tensor`` fits the meta model's leaf ``name``: its shape,
    a packed int4 kernel's uint8 [in/2, out] for an [in, out] kernel, or a
    quantization scale's [out]."""
    owner_name, _, leaf = name.rpartition(".")
    owner = model.get_submodule(owner_name)
    if leaf == "scale":
        want = (owner.kernel.shape[1],)
    else:
        want = tuple(getattr(owner, leaf).shape)
        if leaf == "kernel" and tensor.dtype == torch.uint8 and len(want) == 2 and want[0] % 2 == 0:
            want = (want[0] // 2, want[1])
    if tuple(tensor.shape) != want:
        raise ValueError(f"JAX leaf {name} has shape {tuple(tensor.shape)} ({tensor.dtype}), expected {want}")


def from_jax_params(
    variables: dict, config: VLMConfig, device: str | torch.device = "cuda"
) -> VideoLM:
    """A VideoLM holding the JAX package's variables (numpy leaves).

    ``variables`` is ``{"params": ..., "quant": ...}`` as the JAX engine
    serves it (``quant`` present after int8 or int4 quantization). Leaves
    keep their dtypes (f32, bf16, int8, or uint8 for packed int4 kernels
    [in/2, out]). Raises on a missing or unknown leaf, or on one whose shape
    does not fit the model.
    """
    with torch.device("meta"):
        model = VideoLM(config)
    expected = set(model.state_dict())
    seen = set()
    for collection in ("params", "quant"):
        for name, leaf in _flatten(variables.get(collection, {})):
            if name not in expected and not name.endswith(".scale"):
                raise KeyError(f"unknown JAX leaf {collection}.{name}")
            tensor = _to_tensor(leaf)
            _check_shape(model, name, tensor)
            _assign(model, name, tensor)
            seen.add(name)
    missing = expected - seen
    if missing:
        raise KeyError(f"JAX tree lacks {sorted(missing)[:4]}")
    return model.to(device)


@torch.no_grad()
def random_params(
    config: VLMConfig,
    generator: torch.Generator,
    device: str | torch.device = "cuda",
    dtype: torch.dtype = torch.float32,
) -> VideoLM:
    """A VideoLM with seeded weights at flax's init scales, made on ``device``.

    Dense kernels: lecun normal (truncated at two standard deviations);
    embedding and lm_head: normal(0.02); norms: ones. ``generator`` must live
    on ``device``. Weights are stored in ``dtype`` (the serving config's
    ``param_dtype``).
    """
    with torch.device(device):
        model = VideoLM(config)
    for name, param in model.named_parameters():
        if name.endswith(".kernel"):
            fan_in = param.shape[0]
            std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
            torch.nn.init.trunc_normal_(param, 0.0, std, -2 * std, 2 * std, generator=generator)
        elif name.endswith("embedding") or name.endswith("lm_head"):
            param.normal_(0.0, 0.02, generator=generator)
    return cast_weights(model, dtype).to(device)


@torch.no_grad()
def cast_weights(model: VideoLM, dtype: torch.dtype) -> VideoLM:
    """Cast the float weights and scales (not the int8 or packed int4
    kernels, the position or RoPE tables) to ``dtype`` in place: the serving
    config's ``param_dtype``. Each tensor is looked up by name as it is
    cast, so that the old copy is freed before the next cast: the peak is the
    uncast model plus one tensor (27 GiB at ``7b`` from f32), not both
    copies of the model."""
    names = [name for name, t in model.state_dict(keep_vars=True).items()
             if t.is_floating_point() and t.dtype != dtype]
    for name in names:
        owner_name, _, leaf = name.rpartition(".")
        tensor = getattr(model.get_submodule(owner_name), leaf)
        _assign(model, name, tensor.detach().to(dtype))
    return model
