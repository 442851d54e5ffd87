"""HF Qwen2-VL checkpoints into the port, against the JAX package (CPU).

``models/port.py``: the key maps, the ported decoder and vision trees (leaf
for leaf, exactly), the key normalization, the strict and shape checks, the
shard discovery and ``load_qwen2vl_dir`` on a hub-layout directory (an
index and two shards, bf16 and f32 leaves, written with the
``safetensors`` package): every leaf equals the JAX loader's bit for bit.
``read_safetensors`` (the port's numpy reader) equals the package on every
dtype it takes and refuses the rest. ``InferenceEngine.restore`` on such a
directory (``_restore_hf``) serves the JAX engine's restored weights and
its greedy tokens, and raises on a tree that does not fit the preset with
``missing=``, ``extra=`` and ``shape_drift=``, as JAX's does.
"""

import json
from dataclasses import replace

import jax
import ml_dtypes
import numpy as np
import pytest
import torch

safetensors_torch = pytest.importorskip("safetensors.torch")

import chip_smoke  # noqa: E402  (the smoke's HF-named state and its own safetensors writer)
from video_transformer_tpu.models import port as j_port  # noqa: E402
from video_transformer_tpu.models.config import DecoderConfig as JDecoderConfig  # noqa: E402
from video_transformer_tpu.models.config import VLMConfig as JVLMConfig  # noqa: E402
from video_transformer_tpu.models.config import get_preset as j_get_preset  # noqa: E402
from video_transformer_tpu.models.qwen_vit import QwenVisionConfig as JQwenVisionConfig  # noqa: E402
from video_transformer_tpu.parallel.engine import InferenceEngine as JEngine  # noqa: E402
from video_transformer_tpu_torch.models import port  # noqa: E402
from video_transformer_tpu_torch.models.config import get_preset  # noqa: E402
from video_transformer_tpu_torch.models.quant import quantize_decoder  # noqa: E402
from video_transformer_tpu_torch.parallel import engine as engine_module  # noqa: E402
from video_transformer_tpu_torch.parallel.engine import InferenceEngine  # noqa: E402
from video_transformer_tpu_torch.weights import flatten_tree, from_jax_params  # noqa: E402

torch.set_num_threads(2)

CONFIG = replace(chip_smoke.qwen_tiny_config(512), dtype="float32")
J_CONFIG = JVLMConfig(name=CONFIG.name, encoder=JQwenVisionConfig(**vars(CONFIG.encoder)),
                      decoder=JDecoderConfig(**vars(CONFIG.decoder)), dtype="float32")


def hf_state(seed: int = 0) -> dict[str, torch.Tensor]:
    """HF-named weights of CONFIG's geometry, seeded: bf16 matrices, f32 vectors."""
    return chip_smoke.hf_state_dict(CONFIG, torch.Generator().manual_seed(seed), torch.device("cpu"))


def numpy_state(state: dict[str, torch.Tensor]) -> dict[str, np.ndarray]:
    """The same state as numpy (bf16 as ml_dtypes), what the JAX porter reads."""
    return {k: (v.view(torch.uint16).numpy().view(ml_dtypes.bfloat16) if v.dtype == torch.bfloat16 else v.numpy())
            for k, v in state.items()}


def bits(leaf) -> np.ndarray:
    """A leaf's dtype name and raw bits, comparable across torch and numpy."""
    if isinstance(leaf, torch.Tensor):
        name = str(leaf.dtype).removeprefix("torch.")
        array = leaf.view(torch.uint16).numpy() if leaf.dtype == torch.bfloat16 else leaf.numpy()
    else:
        name = leaf.dtype.name
        array = leaf.view(np.uint16) if leaf.dtype == ml_dtypes.bfloat16 else np.asarray(leaf)
    return name, np.ascontiguousarray(array)


def assert_trees_equal(got: dict, want: dict) -> None:
    got, want = dict(flatten_tree(got)), dict(flatten_tree(want))
    assert sorted(got) == sorted(want)
    for name in want:
        (g_dtype, g), (w_dtype, w) = bits(got[name]), bits(want[name])
        assert g_dtype == w_dtype and g.shape == w.shape, name
        np.testing.assert_array_equal(g, w, err_msg=name)


@pytest.mark.parametrize("layers,qkv_bias,tied", [(2, False, True), (2, True, False), (28, True, False)])
def test_decoder_key_map_equals_jax(layers, qkv_bias, tied):
    assert port.decoder_key_map(layers, qkv_bias, tied) == j_port.decoder_key_map(layers, qkv_bias, tied)


@pytest.mark.parametrize("depth", [1, 2, 32])
def test_vision_key_map_equals_jax(depth):
    assert port.vision_key_map(depth) == j_port.vision_key_map(depth)


@pytest.mark.parametrize("seed", [0, 1])
def test_ported_trees_equal_jax(seed):
    """The decoder and vision trees of one state, leaf for leaf: the same
    paths, dtypes, shapes and bits (projections transposed, the conv
    kernel flattened)."""
    state = hf_state(seed)
    j_state = numpy_state(state)
    assert_trees_equal(port.port_decoder_state(state, CONFIG.decoder),
                       j_port.port_decoder_state(j_state, J_CONFIG.decoder))
    assert_trees_equal(port.port_vision_state(state, CONFIG.encoder),
                       j_port.port_vision_state(j_state, J_CONFIG.encoder))


def test_numpy_f32_state_ports_as_jax():
    """A state of plain numpy f32 arrays (a converted torch state dict)."""
    state = {k: v.float().numpy() for k, v in hf_state(2).items()}
    assert_trees_equal(port.port_decoder_state(state, CONFIG.decoder),
                       j_port.port_decoder_state(state, J_CONFIG.decoder))
    assert_trees_equal(port.port_vision_state(state, CONFIG.encoder),
                       j_port.port_vision_state(state, J_CONFIG.encoder))


@pytest.mark.parametrize("prefix", ["model.visual.", "visual.", ""])
def test_vision_prefixes_are_accepted(prefix):
    """transformers>=4.52's ``model.visual.`` (normalized), the hub's
    ``visual.`` and a tower-only state with no prefix port alike."""
    state = hf_state(3)
    vision = {prefix + k.removeprefix("visual."): v for k, v in state.items() if k.startswith("visual.")}
    want = port.port_vision_state({k: v for k, v in state.items() if k.startswith("visual.")}, CONFIG.encoder)
    normalized = port.normalize_qwen2vl_keys(vision)
    assert normalized.keys() == j_port.normalize_qwen2vl_keys(vision).keys()
    assert_trees_equal(port.port_vision_state(normalized, CONFIG.encoder), want)


def test_normalize_keys_equals_jax():
    state = {"model.language_model.layers.0.mlp.up_proj.weight": 1, "model.visual.blocks.0.norm1.bias": 2,
             "model.embed_tokens.weight": 3, "visual.merger.ln_q.weight": 4, "lm_head.weight": 5}
    assert port.normalize_qwen2vl_keys(state) == j_port.normalize_qwen2vl_keys(state)
    assert set(port.normalize_qwen2vl_keys(state)) == {
        "model.layers.0.mlp.up_proj.weight", "visual.blocks.0.norm1.bias", "model.embed_tokens.weight",
        "visual.merger.ln_q.weight", "lm_head.weight"}


@pytest.mark.parametrize("gone", ["model.layers.1.self_attn.k_proj.bias", "lm_head.weight",
                                  "visual.blocks.0.attn.qkv.bias", "visual.patch_embed.proj.weight"])
def test_strict_raises_and_lenient_ports_the_rest_as_jax(gone):
    state = hf_state(4)
    del state[gone]
    j_state = numpy_state(state)
    fn, j_fn, cfg, j_cfg = ((port.port_vision_state, j_port.port_vision_state, CONFIG.encoder, J_CONFIG.encoder)
                            if gone.startswith("visual.") else
                            (port.port_decoder_state, j_port.port_decoder_state, CONFIG.decoder, J_CONFIG.decoder))
    for porter, src, config in ((fn, state, cfg), (j_fn, j_state, j_cfg)):
        with pytest.raises(KeyError, match="missing 1 keys"):
            porter(src, config)
    assert_trees_equal(fn(state, cfg, strict=False), j_fn(j_state, j_cfg, strict=False))


def test_shape_checks_raise_as_jax():
    state = hf_state(5)
    bad = dict(state, **{"model.layers.0.self_attn.q_proj.weight": torch.zeros(3, 3)})
    for porter, src, config in ((port.port_decoder_state, bad, CONFIG.decoder),
                                (j_port.port_decoder_state, numpy_state(bad), J_CONFIG.decoder)):
        with pytest.raises(ValueError, match="shape"):
            porter(src, config)
    conv = dict(state, **{"visual.patch_embed.proj.weight": torch.zeros(CONFIG.encoder.embed_dim, 3, 14, 14)})
    for porter, src, config in ((port.port_vision_state, conv, CONFIG.encoder),
                                (j_port.port_vision_state, numpy_state(conv), J_CONFIG.encoder)):
        with pytest.raises(ValueError, match="patch_embed.proj.weight: shape"):
            porter(src, config)


# -- the files ----------------------------------------------------------------------------


@pytest.fixture(scope="module")
def hf_dir(tmp_path_factory):
    """A hub-layout directory: two shards (bf16 matrices, f32 vectors) and
    the index that maps each name to its shard, written by the package."""
    state = hf_state(6)
    directory = tmp_path_factory.mktemp("qwen_hf")
    names = sorted(state)
    weight_map = {}
    for i, part in enumerate((names[: len(names) // 2], names[len(names) // 2:])):
        file = f"model-{i + 1:05d}-of-00002.safetensors"
        safetensors_torch.save_file({k: state[k] for k in part}, str(directory / file))
        weight_map.update({k: file for k in part})
    (directory / "model.safetensors.index.json").write_text(json.dumps({"metadata": {}, "weight_map": weight_map}))
    return directory, state


def test_load_qwen2vl_dir_equals_jax(hf_dir):
    directory, state = hf_dir
    assert {str(state[k].dtype) for k in state} == {"torch.bfloat16", "torch.float32"}
    assert port.checkpoint_shard_paths(directory) == j_port.checkpoint_shard_paths(str(directory))
    assert_trees_equal(port.load_qwen2vl_dir(directory, CONFIG), j_port.load_qwen2vl_dir(str(directory), J_CONFIG))


def test_shard_discovery_without_an_index(tmp_path):
    for name in ("b.safetensors", "a.safetensors"):
        safetensors_torch.save_file({"x": torch.zeros(2)}, str(tmp_path / name))
    assert port.checkpoint_shard_paths(tmp_path) == j_port.checkpoint_shard_paths(str(tmp_path)) == \
        [str(tmp_path / "a.safetensors"), str(tmp_path / "b.safetensors")]


def test_native_encoder_preset_is_rejected(hf_dir):
    directory, _ = hf_dir
    for loader, config in ((port.load_qwen2vl_dir, get_preset("tiny")),
                           (j_port.load_qwen2vl_dir, j_get_preset("tiny"))):
        with pytest.raises(ValueError, match="ported-tower"):
            loader(str(directory), config)
    with pytest.raises(FileNotFoundError, match="no .safetensors"):
        port.load_qwen2vl_dir(directory / "absent", CONFIG)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32, torch.float16, torch.bfloat16, torch.int64,
                                   torch.int32, torch.int16, torch.int8, torch.uint8, torch.bool])
def test_read_safetensors_equals_the_package(dtype, tmp_path):
    gen = torch.Generator().manual_seed(7)
    tensors = {"a": (torch.randn(3, 5, generator=gen) * 50).to(dtype), "b.c": (torch.randn(7, generator=gen) * 9).to(dtype),
               "empty": torch.zeros(0, 4, dtype=dtype), "scalar_like": torch.ones(1, dtype=dtype)}
    path = tmp_path / "one.safetensors"
    safetensors_torch.save_file(tensors, str(path), metadata={"format": "pt"})
    got, want = port.read_safetensors(path), safetensors_torch.load_file(str(path))
    assert got.keys() == want.keys()
    for name in want:
        assert got[name].dtype == want[name].dtype and torch.equal(got[name], want[name]), name


def test_smoke_writer_is_read_by_the_package(tmp_path):
    """``chip_smoke.write_hf_checkpoint`` (the card's round trip) writes
    files that the package reads as the port's reader does."""
    state = hf_state(8)
    chip_smoke.write_hf_checkpoint(tmp_path, state)
    index = json.loads((tmp_path / "model.safetensors.index.json").read_text())
    assert set(index["weight_map"]) == set(state) and len(set(index["weight_map"].values())) == 2
    for path in sorted(tmp_path.glob("*.safetensors")):
        got, want = port.read_safetensors(path), safetensors_torch.load_file(str(path))
        assert got.keys() == want.keys() and all(torch.equal(got[k], want[k]) for k in want)
        assert all(torch.equal(got[k], state[k]) for k in got)


def write_raw(path, header: dict, data: bytes) -> None:
    raw = json.dumps(header).encode()
    path.write_bytes(len(raw).to_bytes(8, "little") + raw + data)


def test_read_safetensors_refuses_what_it_cannot_read(tmp_path):
    write_raw(tmp_path / "fp8.safetensors", {"x": {"dtype": "F8_E4M3", "shape": [2], "data_offsets": [0, 2]}}, b"\0\0")
    with pytest.raises(ValueError, match="unsupported dtype F8_E4M3"):
        port.read_safetensors(tmp_path / "fp8.safetensors")
    write_raw(tmp_path / "short.safetensors", {"x": {"dtype": "F32", "shape": [4], "data_offsets": [0, 16]}}, b"\0" * 8)
    with pytest.raises(ValueError, match="data offsets"):
        port.read_safetensors(tmp_path / "short.safetensors")
    write_raw(tmp_path / "shape.safetensors", {"x": {"dtype": "F32", "shape": [3], "data_offsets": [0, 16]}}, b"\0" * 16)
    with pytest.raises(ValueError, match="data offsets"):
        port.read_safetensors(tmp_path / "shape.safetensors")
    (tmp_path / "cut.safetensors").write_bytes((100).to_bytes(8, "little") + b"{}")
    with pytest.raises(ValueError, match="truncated"):
        port.read_safetensors(tmp_path / "cut.safetensors")
    (tmp_path / "tiny.safetensors").write_bytes(b"\1\2")
    with pytest.raises(ValueError, match="no header length"):
        port.read_safetensors(tmp_path / "tiny.safetensors")


# -- restore ------------------------------------------------------------------------------


FRAMES = np.random.default_rng(9).integers(0, 256, (2, 4, 56, 56, 3), dtype=np.uint8)
PROMPTS = ["describe", "分析视频"]


def restored_pair(directory, **kwargs):
    kwargs = dict(max_new_tokens=12, temperature=0.0, **kwargs)
    j_engine = JEngine(J_CONFIG, seed=0, compilation_cache_dir=None, **kwargs)
    j_engine.restore(str(directory))
    engine = InferenceEngine(CONFIG, seed=1, device="cpu", **kwargs)
    engine.restore(directory)
    return j_engine, engine


def assert_states_equal(got: dict, want: dict) -> None:
    assert got.keys() == want.keys()
    for name in want:
        assert got[name].dtype == want[name].dtype and torch.equal(got[name], want[name]), name


def test_restore_serves_the_jax_engines_weights_and_tokens(hf_dir):
    """``restore(dir)`` on both engines: the port serves the tree that
    ``from_jax_params`` makes of the JAX engine's restored variables (the
    checkpoint's bf16 and f32 leaves as they are), and greedy f32 decoding
    gives the JAX engine's tokens."""
    j_engine, engine = restored_pair(hf_dir[0])
    want = from_jax_params(jax.tree_util.tree_map(np.asarray, j_engine.params), CONFIG, device="cpu")
    assert_states_equal(engine.model.state_dict(), want.state_dict())
    j_out = j_engine.generate(FRAMES, PROMPTS, return_tokens=True)
    out = engine.generate(FRAMES, PROMPTS, return_tokens=True)
    assert out[1] == j_out[1] and out[0] == j_out[0]


def test_restore_quantizes_the_restored_tree(hf_dir):
    """With ``quantize="int8"`` the port serves its own quantization of the
    restored tree. The JAX engine quantizes inside a jitted program, where
    XLA divides by 127 through a reciprocal: its scales lie within one f32
    step of the port's (an exact division), and its int8 values within 1
    of the port's, where ``w / scale`` sits at a rounding tie. Greedy
    tokens equal the JAX engine's on this checkpoint."""
    j_engine, engine = restored_pair(hf_dir[0], quantize="int8", kv_quant="int8")
    plain = InferenceEngine(CONFIG, device="cpu", max_new_tokens=4)
    plain.restore(hf_dir[0])
    quantize_decoder(plain.model, "int8")
    assert_states_equal(engine.model.state_dict(), plain.model.state_dict())
    j_state = from_jax_params(jax.tree_util.tree_map(np.asarray, j_engine.params), CONFIG, device="cpu").state_dict()
    for name, tensor in engine.model.state_dict().items():
        if name.endswith(".scale"):
            assert torch.all((tensor - j_state[name]).abs() <= torch.finfo(torch.float32).eps * tensor.abs()), name
        elif tensor.dtype == torch.int8:
            assert (tensor.int() - j_state[name].int()).abs().max() <= 1, name
        else:
            assert torch.equal(tensor, j_state[name]), name
    j_out = j_engine.generate(FRAMES, PROMPTS, return_tokens=True)
    out = engine.generate(FRAMES, PROMPTS, return_tokens=True)
    assert out[1] == j_out[1]


def dropped(tree: dict) -> dict:
    del tree["decoder"]["layer_1"]["attn"]["v"]["bias"]
    return tree


def added(tree: dict) -> dict:
    tree["visual"]["block_0"]["qkv"]["extra"] = torch.zeros(1)
    return tree


def drifted(tree: dict) -> dict:
    tree["visual"]["merger_fc2"]["bias"] = torch.zeros(7)
    return tree


@pytest.mark.parametrize("change,field,leaf", [(dropped, "missing", "decoder.layer_1.attn.v.bias"),
                                               (added, "extra", "visual.block_0.qkv.extra"),
                                               (drifted, "shape_drift", "visual.merger_fc2.bias")])
def test_restore_raises_on_a_tree_that_does_not_fit(hf_dir, monkeypatch, change, field, leaf):
    """A ported tree with a leaf missing, an extra leaf or a drifted shape:
    ``_restore_hf`` raises naming it and keeps the weights it served."""
    directory, _ = hf_dir
    engine = InferenceEngine(CONFIG, seed=1, device="cpu", max_new_tokens=4)
    before = {k: v.clone() for k, v in engine.model.state_dict().items()}
    load = engine_module.load_qwen2vl_dir
    monkeypatch.setattr(engine_module, "load_qwen2vl_dir", lambda path, cfg: change(load(path, cfg)))
    with pytest.raises(ValueError, match=rf"does not match preset qwen-tiny: .*{field}=\[[^]]*{leaf}"):
        engine.restore(directory)
    assert all(torch.equal(v, before[k]) for k, v in engine.model.state_dict().items())


def test_restore_raises_on_a_checkpoint_of_another_geometry(hf_dir):
    """A checkpoint one decoder layer short raises in the strict port (a
    KeyError naming the HF keys), as JAX's does; a tower of another width
    raises the engine's shape drift."""
    directory, _ = hf_dir
    deeper = replace(CONFIG, decoder=replace(CONFIG.decoder, num_layers=3))
    with pytest.raises(KeyError, match="model.layers.2"):
        InferenceEngine(deeper, device="cpu", max_new_tokens=4).restore(directory)
    j_deeper = replace(J_CONFIG, decoder=replace(J_CONFIG.decoder, num_layers=3))
    with pytest.raises(KeyError, match="model.layers.2"):
        JEngine(j_deeper, compilation_cache_dir=None, max_new_tokens=4).restore(str(directory))
    wider = replace(CONFIG, encoder=replace(CONFIG.encoder, mlp_ratio=4.0))
    with pytest.raises(ValueError, match="shape_drift=.*fc1"):
        InferenceEngine(wider, device="cpu", max_new_tokens=4).restore(directory)
