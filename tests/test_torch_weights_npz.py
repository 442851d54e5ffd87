"""Trained weights across the bridge: orbax -> ``.npz`` -> the port (CPU).

``tools/orbax_to_npz.py`` converts an orbax checkpoint on a host with JAX;
``weights.load_npz`` and ``InferenceEngine.restore`` read the file with numpy
and torch only. The committed tiny checkpoint must be what the converter
writes today, a bfloat16 leaf must survive as its bits, ``restore`` must give
the leaves orbax restores (and the JAX engine's served variables after the
serving transform), and every malformed input must raise.
"""

from dataclasses import replace
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tools import orbax_to_npz
from video_transformer_tpu.models.config import get_preset as j_get_preset
from video_transformer_tpu.models.quant import quantize_decoder as j_quantize_decoder
from video_transformer_tpu.parallel.engine import InferenceEngine as JEngine
from video_transformer_tpu_torch.models.config import get_preset
from video_transformer_tpu_torch.parallel.engine import InferenceEngine
from video_transformer_tpu_torch.parallel.engine import resolve_params_dir
from video_transformer_tpu_torch.weights import from_jax_params, load_npz, save_npz

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]
ORBAX = REPO / "data" / "checkpoints" / "tiny-zh-grounded-r5mix" / "params_4500"
NPZ = REPO / "data" / "torch_weights" / "tiny-zh-grounded-r5mix-params_4500.npz"
VOCAB = 2048


def tiny(dtype: str | None = None):
    cfg = get_preset("tiny")
    cfg = replace(cfg, decoder=replace(cfg.decoder, vocab_size=VOCAB))
    return replace(cfg, dtype=dtype) if dtype else cfg


def engine(**kwargs) -> InferenceEngine:
    return InferenceEngine(tiny(kwargs.pop("dtype", None)), device="cpu", **kwargs)


@pytest.fixture(scope="module")
def orbax_leaves() -> dict[str, np.ndarray]:
    return orbax_to_npz.restore_arrays(ORBAX)


def write_npz(path: Path, arrays: dict[str, np.ndarray]) -> Path:
    with open(path, "wb") as handle:
        np.savez(handle, **arrays)
    return path


def test_converter_reproduces_the_committed_file(tmp_path):
    """Converting the checkpoint again gives the committed arrays bit for bit."""
    out = orbax_to_npz.convert(ORBAX, tmp_path / "again.npz")
    with np.load(out, allow_pickle=False) as got, np.load(NPZ, allow_pickle=False) as want:
        assert sorted(got.files) == sorted(want.files)
        for key in want.files:
            assert got[key].dtype == want[key].dtype, key
            assert got[key].tobytes() == want[key].tobytes(), key
        assert len(want["__index__"]) == 42


def test_converter_takes_the_highest_step_of_a_parent():
    assert resolve_params_dir(ORBAX.parent).name == "params_5000"
    assert resolve_params_dir(ORBAX) == ORBAX


def test_bf16_leaf_round_trips_through_its_bits(tmp_path):
    rng = np.random.default_rng(0)
    leaf = np.asarray(jnp.asarray(rng.standard_normal((5, 7)), jnp.bfloat16))
    arrays = {"params/decoder/final_norm/weight": leaf, "params/x/y": np.arange(3, dtype=np.float32)}
    path = save_npz(tmp_path / "bf16.npz", arrays)
    with np.load(path, allow_pickle=False) as data:
        assert data["params/decoder/final_norm/weight"].dtype == np.uint16
    tree = load_npz(path)
    got = tree["params"]["decoder"]["final_norm"]["weight"]
    assert got.dtype == torch.bfloat16
    assert got.view(torch.uint16).numpy().tobytes() == leaf.view(np.uint16).tobytes()
    np.testing.assert_array_equal(tree["params"]["x"]["y"], np.arange(3, dtype=np.float32))


def test_restore_npz_gives_the_orbax_leaves(orbax_leaves):
    eng = engine(dtype="float32")
    eng.restore(NPZ)
    state = eng.model.state_dict()
    assert len(orbax_leaves) == len(state) == 42
    for key, leaf in orbax_leaves.items():
        name = key.removeprefix("params/").replace("/", ".")
        assert state[name].dtype == torch.float32
        np.testing.assert_array_equal(state[name].numpy(), leaf, err_msg=name)


@pytest.mark.parametrize("param_dtype,quantize", [("bfloat16", None), ("bfloat16", "int8"), (None, "int4")])
def test_restore_applies_the_serving_transform_as_jax(param_dtype, quantize):
    """After a restore the port serves the JAX engine's variables: the
    ``param_dtype`` cast first, then the JAX package's ``quantize_decoder``.
    (That function is applied eagerly here: inside the JAX engine's jit, XLA
    turns its scale division into a reciprocal product, which moves a few
    scales by one ulp.)"""
    j_cfg = j_get_preset("tiny")
    j_cfg = replace(j_cfg, decoder=replace(j_cfg.decoder, vocab_size=VOCAB))
    j_engine = JEngine(j_cfg, param_dtype=param_dtype, compilation_cache_dir=None)
    j_engine.restore(str(ORBAX))
    variables = jax.tree_util.tree_map(np.asarray, j_engine.params)
    if quantize:
        variables = jax.tree_util.tree_map(np.asarray, j_quantize_decoder(variables, quantize))
    want = from_jax_params(variables, tiny(), device="cpu")
    eng = engine(param_dtype=param_dtype, quantize=quantize)
    eng.restore(NPZ)
    want_state, got_state = want.state_dict(), eng.model.state_dict()
    assert sorted(got_state) == sorted(want_state)
    for name, tensor in want_state.items():
        assert got_state[name].dtype == tensor.dtype, name
        torch.testing.assert_close(got_state[name], tensor, rtol=0, atol=0, msg=name)


def test_restore_takes_the_port_trainers_params_pt(tmp_path):
    """A ``params_N/params.pt`` directory restores, and a parent of several
    takes the highest step."""
    eng = engine(dtype="float32")
    eng.restore(NPZ)
    state = {k: v.clone() for k, v in eng.model.state_dict().items()}
    for step, scale in ((7, 2.0), (12, 1.0), (9, 3.0)):
        (tmp_path / f"params_{step}").mkdir()
        torch.save({k: v * scale for k, v in state.items()}, tmp_path / f"params_{step}" / "params.pt")
    for path in (tmp_path, tmp_path / "params_12"):
        fresh = engine(dtype="float32")
        fresh.restore(path)
        for name, tensor in fresh.model.state_dict().items():
            torch.testing.assert_close(tensor, state[name], rtol=0, atol=0, msg=name)


def test_malformed_inputs_raise(tmp_path):
    eng = engine()
    with np.load(NPZ, allow_pickle=False) as data:
        arrays = {key: data[key] for key in data.files}
    index = arrays["__index__"]

    extra = dict(arrays, **{"params/decoder/extra/kernel": np.zeros((2, 2), np.float32)})
    extra["__index__"] = np.concatenate([index, [["params/decoder/extra/kernel", "float32"]]])
    with pytest.raises(KeyError, match="unknown"):
        eng.restore(write_npz(tmp_path / "extra.npz", extra))

    gone = "params/projector_up/kernel"
    missing = {k: v for k, v in arrays.items() if k != gone}
    missing["__index__"] = index[index[:, 0] != gone]
    with pytest.raises(KeyError, match="lacks"):
        eng.restore(write_npz(tmp_path / "missing.npz", missing))

    unlisted = dict(arrays, **{"params/stray": np.zeros(1, np.float32)})
    with pytest.raises(KeyError, match="does not list"):
        load_npz(write_npz(tmp_path / "unlisted.npz", unlisted))
    listed = dict(arrays, __index__=np.concatenate([index, [["params/ghost", "float32"]]]))
    with pytest.raises(KeyError, match="no array"):
        load_npz(write_npz(tmp_path / "listed.npz", listed))
    outside = dict(arrays, **{"opt_state/mu": np.zeros(1, np.float32)})
    outside["__index__"] = np.concatenate([index, [["opt_state/mu", "float32"]]])
    with pytest.raises(KeyError, match="cannot place"):
        load_npz(write_npz(tmp_path / "outside.npz", outside))
    with pytest.raises(KeyError, match="index"):
        load_npz(write_npz(tmp_path / "bare.npz", {"params/x": np.zeros(1, np.float32)}))
    shape = dict(arrays, **{gone: np.zeros((3, 3), np.float32)})
    with pytest.raises(ValueError, match="shape"):
        eng.restore(write_npz(tmp_path / "shape.npz", shape))

    with pytest.raises(FileNotFoundError):
        eng.restore(tmp_path / "absent.npz")
    (tmp_path / "params_3").mkdir()
    with pytest.raises(FileNotFoundError, match="params.pt"):
        eng.restore(tmp_path / "params_3")
    (tmp_path / "empty").mkdir()
    with pytest.raises(FileNotFoundError, match="no params_N"):
        eng.restore(tmp_path / "empty")
    hf = tmp_path / "hf"
    hf.mkdir()
    (hf / "model-00001-of-00002.safetensors").write_bytes(b"")
    with pytest.raises(ValueError, match="ported-tower"):  # an HF directory needs a QwenVisionConfig preset
        eng.restore(hf)


def test_restore_has_no_random_fallback(tmp_path):
    """A failed restore leaves the engine's weights as they were."""
    eng = engine(dtype="float32")
    eng.restore(NPZ)
    before = {k: v.clone() for k, v in eng.model.state_dict().items()}
    with pytest.raises(FileNotFoundError):
        eng.restore(tmp_path / "nothing.npz")
    for name, tensor in eng.model.state_dict().items():
        assert torch.equal(tensor, before[name]), name
