"""The weight bridge: JAX parameter trees (live, or converted checkpoints in
``.npz`` files) and the port trainer's state dicts -> the port's VideoLM, and
seeded random weights made directly on the device.

The port's parameter names are the JAX package's parameter paths joined by dots
(``params/decoder/layer_0/attn/q/kernel`` -> ``decoder.layer_0.attn.q.kernel``;
``quant/decoder/.../scale`` -> ``...q.scale``), and dense kernels keep flax's
[in, out] layout, so the bridge is a rename and nothing is transposed.

A trained orbax checkpoint crosses over as one ``.npz`` that ``save_npz``
writes (``tools/orbax_to_npz.py`` runs it on a host with JAX): each key is a
leaf's path joined by ``/``, a bfloat16 leaf is stored as its uint16 bits,
and the ``__index__`` array lists every leaf with its dtype. ``load_npz``
reads it back into the nested tree that ``from_jax_params`` takes.
"""

from __future__ import annotations

import math
from pathlib import Path
from typing import Any, Iterable, Iterator

import numpy as np
import torch

from .models.config import VLMConfig
from .models.vlm import VideoLM

__all__ = ["cast_weights", "flatten_tree", "from_jax_params", "from_state_dict", "load_npz", "random_params",
           "save_npz", "to_tensor"]

NPZ_INDEX_KEY = "__index__"
_NPZ_DTYPES = ("float32", "bfloat16", "int8", "uint8")  # what the JAX trees hold


def flatten_tree(tree: dict, prefix: str = "") -> Iterator[tuple[str, Any]]:
    """(dotted path, leaf) of every leaf of a nested dict."""
    for key, value in tree.items():
        if isinstance(value, dict):
            yield from flatten_tree(value, f"{prefix}{key}.")
        else:
            yield prefix + key, value


def to_tensor(array: Any) -> torch.Tensor:
    """A torch tensor of a numpy (or ml_dtypes bfloat16) array; a tensor passes as it is."""
    if isinstance(array, torch.Tensor):
        return array
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


def _build(items: Iterable[tuple[str, torch.Tensor]], config: VLMConfig, device, source: str) -> VideoLM:
    """A VideoLM holding ``(dotted name, tensor)`` leaves; raises on a
    missing or unknown leaf, or on one whose shape does not fit the model."""
    with torch.device("meta"):
        model = VideoLM(config)
    expected = set(model.state_dict())
    seen = set()
    for name, tensor in items:
        if name not in expected and not name.endswith(".scale"):
            raise KeyError(f"unknown {source} leaf {name}")
        _check_shape(model, name, tensor)
        _assign(model, name, tensor)
        seen.add(name)
    missing = expected - seen
    if missing:
        raise KeyError(f"{source} tree lacks {sorted(missing)[:4]}")
    return model.to(device)


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
    unknown = set(variables) - {"params", "quant"}
    if unknown:
        raise KeyError(f"unknown JAX collection {sorted(unknown)}")
    items = (
        (name, to_tensor(leaf))
        for collection in ("params", "quant")
        for name, leaf in flatten_tree(variables.get(collection, {}))
    )
    return _build(items, config, device, "JAX")


def from_state_dict(
    state: dict[str, torch.Tensor], config: VLMConfig, device: str | torch.device = "cuda"
) -> VideoLM:
    """A VideoLM holding a state dict (the port trainer's ``params.pt``);
    raises on a missing, unknown or misshapen leaf, as ``from_jax_params``."""
    return _build(state.items(), config, device, "state dict")


def save_npz(path: str | Path, leaves: dict[str, np.ndarray]) -> Path:
    """Write ``{leaf path: numpy array}`` as a converted checkpoint: bf16
    leaves as their uint16 bits, and the index of every leaf's dtype."""
    payload: dict[str, np.ndarray] = {}
    index = []
    for key, leaf in leaves.items():
        if key == NPZ_INDEX_KEY:
            raise ValueError(f"leaf path {key!r} collides with the index key")
        dtype = leaf.dtype.name
        if dtype not in _NPZ_DTYPES:
            raise ValueError(f"leaf {key} has unsupported dtype {dtype}")
        payload[key] = leaf.view(np.uint16) if dtype == "bfloat16" else leaf
        index.append((key, dtype))
    payload[NPZ_INDEX_KEY] = np.array(index, dtype=np.str_).reshape(-1, 2)
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "wb") as handle:  # a handle: np.savez would append ".npz"
        np.savez(handle, **payload)
    return path


def load_npz(path: str | Path) -> dict:
    """The nested ``{"params": ..., "quant": ...}`` tree of a converted
    checkpoint (``save_npz``, run by ``tools/orbax_to_npz.py``), for
    ``from_jax_params``.

    Leaves are numpy arrays, except bfloat16 leaves, which come back from
    their uint16 bits as torch bfloat16 tensors (numpy has no bfloat16).
    Nothing is unpickled. Raises on a file without the index, on a key the
    index does not list or lists without an array, on an unknown dtype, and
    on a path outside the ``params`` and ``quant`` collections.
    """
    tree: dict = {}
    with np.load(Path(path), allow_pickle=False) as data:
        if NPZ_INDEX_KEY not in data.files:
            raise KeyError(f"{path} has no {NPZ_INDEX_KEY} array: not a converted checkpoint")
        index = {str(key): str(dtype) for key, dtype in data[NPZ_INDEX_KEY]}
        extra = set(data.files) - set(index) - {NPZ_INDEX_KEY}
        if extra:
            raise KeyError(f"{path} holds leaves its index does not list: {sorted(extra)[:4]}")
        for key, dtype in index.items():
            if key not in data.files:
                raise KeyError(f"{path} lists leaf {key} but holds no array for it")
            if dtype not in _NPZ_DTYPES:
                raise ValueError(f"leaf {key} has unsupported dtype {dtype}")
            collection, *parts = key.split("/")
            if collection not in ("params", "quant") or not parts:
                raise KeyError(f"cannot place leaf {key}: not under params/ or quant/")
            leaf = data[key]
            if dtype == "bfloat16":
                if leaf.dtype != np.uint16:
                    raise ValueError(f"bfloat16 leaf {key} is stored as {leaf.dtype}, not uint16 bits")
                leaf = torch.from_numpy(leaf.copy()).view(torch.bfloat16)
            elif leaf.dtype.name != dtype:
                raise ValueError(f"leaf {key} is {leaf.dtype}, its index says {dtype}")
            node = tree.setdefault(collection, {})
            for part in parts[:-1]:
                node = node.setdefault(part, {})
            node[parts[-1]] = leaf
    return tree


@torch.no_grad()
def random_params(
    config: VLMConfig,
    generator: torch.Generator,
    device: str | torch.device = "cuda",
    dtype: torch.dtype = torch.float32,
) -> VideoLM:
    """A VideoLM with seeded weights at flax's init scales, made on ``device``.

    Dense kernels: lecun normal (truncated at two standard deviations);
    embedding and lm_head: normal(0.02); norm and LayerNorm scales: ones;
    biases (the Qwen2 q/k/v and every dense layer of a ported vision
    tower) and LayerNorm offsets: zeros. ``generator`` must live
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
