"""Serving over a mesh of CPU ranks (gloo) against the JAX package (CPU).

One module-scoped fixture starts each world once and runs every check in
it: a 4-rank ``{"data": 2, "model": 2}`` world, a 2-rank ``{"model": 2}``
world and a 2-rank ``{"data": 2}`` world. The JAX engine runs as its own
tests run it, on the same mesh shapes of the 8 CPU devices of
``tests/conftest.py``. Everything is greedy and float32 on the micro
geometry of JAX's ``tests/test_engine.py``, so tokens must be equal:

- ``InferenceEngine.generate`` on 3 clips (the data axis pads to 4) with
  float and int8 weights, and on an untied-head, ``qkv_bias`` decoder (the
  vocab all-gather and the bias shards), against JAX's engine: JAX's
  weights reach the ranks through ``restore`` of a converted checkpoint,
  and on ``model: 2`` also through a ``params`` function each rank calls;
- a session round (``return_session``, ``continue_session``) against JAX's;
- ``ContinuousBatcher`` with two data groups, device refill and the
  host-driven loop, against JAX's batcher on the same mesh;
- a ``model`` axis that does not divide the heads (the plan of heads of
  ``parallel/sharding.py``): the tiny preset's geometry (1 q and 1 kv head)
  and 6 q over 3 kv heads on ``model: 2``, then, on a ``model: 4`` mesh
  built on the running 4-rank world, 8 q and 6 q heads over 2 kv heads.

On the ``data: 2`` world, against the 1-rank port on the same seeded
weights: the int8 KV scales (the MAX over both groups, within float32
rounding) and tokens; a speculative engine (a replicated draft); a second
mesh (``model: 2``) built on the running world; then a worker that raises
makes rank 0 raise, at once when rank 0 waits on no collective
(``MeshWorkerError`` with the worker's traceback), within the group
timeout (10 s) when it does.

The analyzer and ``python -m video_transformer_tpu_torch`` on a mesh are in
``tests/test_torch_mesh_entry.py``.
"""

import dataclasses
import functools
import tempfile
import time
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

from video_transformer_tpu.models.config import DecoderConfig as JDecoder
from video_transformer_tpu.models.config import EncoderConfig as JEncoder
from video_transformer_tpu.models.config import VLMConfig as JVLM
from video_transformer_tpu.models.config import get_preset as j_get_preset
from video_transformer_tpu.ops.constrained import DfaBuilder as JDfaBuilder
from video_transformer_tpu.parallel.engine import InferenceEngine as JEngine
from video_transformer_tpu.parallel.mesh import build_mesh as j_build_mesh
from video_transformer_tpu.parallel.serving import ContinuousBatcher as JBatcher
from video_transformer_tpu.parallel.serving import Request as JRequest
from video_transformer_tpu_torch.models.config import DecoderConfig, EncoderConfig, VLMConfig, get_preset
from video_transformer_tpu_torch.ops.constrained import DfaBuilder
from video_transformer_tpu_torch.parallel.engine import InferenceEngine
from video_transformer_tpu_torch.parallel.mesh import MeshWorkerError, build_mesh
from video_transformer_tpu_torch.parallel.serving import ContinuousBatcher, Request
from video_transformer_tpu_torch.models.vlm import VideoLM
from video_transformer_tpu_torch.weights import flatten_tree, from_jax_params, save_npz

MAX_NEW = 40
PROMPTS = ["a", "bb", "ccc"]
DP2TP2 = {"data": 2, "model": 2}
TP2 = {"data": 1, "model": 2}
TP4 = {"data": 1, "model": 4}
# Decoders whose heads the model axis does not divide: (mesh, preset or
# micro, decoder fields). The tiny preset's geometry runs at float32, as the
# micro one does, so that greedy tokens are exact.
UNEVEN = {
    "tiny_tp2": (TP2, "tiny", {}),
    "6q3kv_tp2": (TP2, "micro", {"num_heads": 6, "num_kv_heads": 3}),
    "8q2kv_tp4": (TP4, "micro", {"num_heads": 8, "num_kv_heads": 2}),
    "6q2kv_tp4": (TP4, "micro", {"num_heads": 6, "num_kv_heads": 2}),
}


def micro(cls_vlm, cls_enc, cls_dec, **decoder):
    """JAX ``tests/test_engine.py::micro_config``'s geometry; ``decoder``
    overrides fields of its decoder."""
    decoder = {"vocab_size": 512, "hidden_dim": 64, "num_layers": 2, "num_heads": 2, "num_kv_heads": 2,
               "head_dim": 32, "mlp_dim": 128, "max_seq_len": 1024, **decoder}
    return cls_vlm(
        name="micro",
        encoder=cls_enc(hidden_dim=64, num_layers=1, num_heads=2, head_dim=32, mlp_dim=128, image_size=32,
                        patch_size=16, tubelet_t=2, num_frames=4),
        decoder=cls_dec(**decoder),
        dtype="float32",
    )


def dfa(builder):
    return builder().literal('{"title": ').free_string(1, 8).literal(', "tags": ').string_list(1, 6).literal(
        "}").finish()


def frames(n: int = 3, seed: int = 0) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 255, (n, 4, 32, 32, 3), dtype=np.uint8)


def requests(cls, n: int = 7, seed: int = 0):
    rng = np.random.default_rng(seed)
    return [cls(i, rng.integers(0, 255, (4, 32, 32, 3), dtype=np.uint8), f"analyze {i}") for i in range(n)]


def tiny(get):
    return dataclasses.replace(get("tiny"), dtype="float32")


def j_engine(shape, quantize=None, config=None, **decoder):
    n = shape["data"] * shape["model"]
    config = config or micro(JVLM, JEncoder, JDecoder, **decoder)
    return JEngine(config, mesh=j_build_mesh(shape, devices=jax.devices()[:n]),
                   dfa=dfa(JDfaBuilder), max_new_tokens=MAX_NEW, temperature=0.0, quantize=quantize, seed=0,
                   compilation_cache_dir=None)


def port_engine(mesh, jax_engine=None, **kwargs):
    """The port's engine on ``mesh``; with ``jax_engine``, restored from the
    JAX engine's float weights written as a converted checkpoint (on a mesh
    every rank reads it and keeps its shard)."""
    decoder = kwargs.pop("decoder", {})
    cfg = kwargs.pop("config", None) or micro(VLMConfig, EncoderConfig, DecoderConfig, **decoder)
    kwargs = {"max_new_tokens": MAX_NEW, "temperature": 0.0, **kwargs}
    engine = InferenceEngine(cfg, dfa=dfa(DfaBuilder), device="cpu", mesh=mesh, **kwargs)
    if jax_engine is not None:
        with tempfile.TemporaryDirectory(prefix="vtx_tp_") as tmp:
            engine.restore(save_npz(Path(tmp) / "weights.npz", jax_leaves(jax_engine)))
    return engine


def jax_leaves(jax_engine) -> dict[str, np.ndarray]:
    """The JAX engine's served (float) weights as converted-checkpoint leaves."""
    return {key.replace(".", "/"): np.asarray(leaf) for key, leaf in flatten_tree(jax_engine.params)}


def jax_model(leaves: dict[str, np.ndarray], cfg) -> VideoLM:
    """A ``params`` function's body: the model of the JAX engine's weights."""
    tree: dict = {}
    for key, leaf in leaves.items():
        *parts, last = key.split("/")
        node = tree
        for part in parts:
            node = node.setdefault(part, {})
        node[last] = leaf
    return from_jax_params(tree, cfg, device="cpu")


def run_batcher(engine, cls_batcher, cls_request, refill: bool) -> dict:
    batcher = cls_batcher(engine, slots=4, prompt_len=16, chunk_steps=8, device_refill=refill)
    for request in requests(cls_request):
        batcher.submit(request)
    return {c.request_id: (list(c.token_ids), bool(c.complete)) for c in batcher.run()}


def generate(engine, **kwargs):
    return engine.generate(frames(), PROMPTS, return_status=True, return_tokens=True, **kwargs)


def _raise_on_workers():
    if dist.get_rank() != 0:
        raise RuntimeError("worker failed on purpose")
    return "rank 0 fine"


def _collective_after_worker_fails():
    if dist.get_rank() != 0:
        raise RuntimeError("worker failed before the collective")
    dist.all_reduce(torch.ones(1))


def _jax_checks(shape: dict, full: bool) -> tuple[dict, dict]:
    """JAX's tokens on ``shape`` (with ``full``: int8 weights and both
    batchers too; the uneven cases of ``UNEVEN`` on it and on TP4), and its
    engines."""
    engines = {"float": j_engine(shape)}
    if full:
        engines["int8"] = j_engine(shape, quantize="int8")
        engines["untied"] = j_engine(shape, qkv_bias=True, tied_embeddings=False)
    for case, (case_shape, kind, decoder) in UNEVEN.items():
        if (case_shape == TP4) == full:
            config = tiny(j_get_preset) if kind == "tiny" else None
            engines[case] = j_engine(case_shape, config=config, **decoder)
    out = {name: generate(engine) for name, engine in engines.items()}
    if full:
        out["batcher"] = {r: run_batcher(engines["float"], JBatcher, JRequest, r) for r in (True, False)}
    *_, ids, session = engines["float"].generate(frames(), PROMPTS, return_status=True, return_tokens=True,
                                                 session_rounds=2, return_session=True)
    out["session"] = (ids, engines["float"].continue_session(session))
    return out, engines


def _world_checks(shape: dict, full: bool) -> dict:
    """The port's engine, session (and with ``full`` the batcher) on a
    world of ``shape``, on JAX's weights; JAX's results beside them."""
    out: dict = {}
    out["jax"], engines = _jax_checks(shape, full)
    mesh = build_mesh(shape, devices=["cpu"] * (shape["data"] * shape["model"]), timeout_s=120)
    try:
        out["backend"], out["size"] = mesh.backend, mesh.size
        engine = port_engine(mesh, engines["float"])
        out["float"] = generate(engine)
        *_, ids, session = engine.generate(frames(), PROMPTS, return_status=True, return_tokens=True,
                                           session_rounds=2, return_session=True)
        out["session"] = (ids, engine.continue_session(session))
        if full:
            out["untied"] = generate(port_engine(mesh, engines["untied"], decoder={"qkv_bias": True,
                                                                                    "tied_embeddings": False}))
            # JAX's int8 engine quantizes the float engine's draw (the same seed).
            out["int8"] = generate(port_engine(mesh, engines["float"], quantize="int8"))
            out["batcher"] = {r: run_batcher(engine, ContinuousBatcher, Request, r) for r in (True, False)}
            # A model: 4 mesh on the running world: new groups over the same ranks.
            mesh = build_mesh(TP4, timeout_s=120)
        for case, (case_shape, kind, decoder) in UNEVEN.items():
            if case_shape == mesh.shape:
                geometry = {"config": tiny(get_preset)} if kind == "tiny" else {"decoder": decoder}
                out[case] = generate(port_engine(mesh, engines[case], **geometry))
        if not full:
            cfg = micro(VLMConfig, EncoderConfig, DecoderConfig)
            builder = functools.partial(jax_model, jax_leaves(engines["float"]), cfg)
            out["builder"] = generate(port_engine(mesh, params=builder))
            out["jax"]["builder"] = out["jax"]["float"]
    finally:
        mesh.close()
    return out


def _spec_pair(mesh) -> tuple:
    """A plain and a speculative engine's tokens (seeded random weights, a
    one-layer random draft, ``max_forced_run=0``)."""
    plain = port_engine(mesh, max_forced_run=0, max_new_tokens=200)
    spec = port_engine(mesh, max_forced_run=0, max_new_tokens=200)
    spec.attach_draft(micro(VLMConfig, EncoderConfig, DecoderConfig, num_layers=1), spec_tokens=4)
    return generate(plain), generate(spec)


def _data_checks() -> dict:
    """A ``data: 2`` world: the int8 KV scales, a speculative engine, then
    the failing worker (the group timeout is 10 s)."""
    out: dict = {}
    mesh = build_mesh({"data": 2, "model": 1}, devices=["cpu"] * 2, timeout_s=10)
    try:
        # Seeded random weights: every rank draws the 1-rank engine's.
        kv = port_engine(mesh, quantize="int8", kv_quant="int8")
        *_, session = kv.generate(frames(), PROMPTS, session_rounds=1, return_session=True)
        out["kv_scales"] = [t.clone() for t in session.cache["k_scale"] + session.cache["v_scale"]]
        out["kv_tokens"] = generate(kv)
        out["spec"] = _spec_pair(mesh)
        # A second mesh on the running world: new groups over the same ranks.
        mesh = build_mesh(TP2, timeout_s=10)
        out["regrouped"] = (mesh.shape, mesh.size, generate(port_engine(mesh)))
        out["group0"] = port_engine(None, quantize="int8", kv_quant="int8")
        with pytest.raises(MeshWorkerError, match="worker failed on purpose") as caught:
            mesh.run_all(_raise_on_workers)
        out["no_collective"] = "rank 1" in str(caught.value)
        start = time.perf_counter()
        with pytest.raises(Exception) as caught:
            mesh.run_all(_collective_after_worker_fails)
        out["collective_s"] = time.perf_counter() - start
        out["collective_error"] = type(caught.value).__name__
    finally:
        mesh.close()
    out["one_rank"] = port_engine(None, quantize="int8", kv_quant="int8")
    return out


@pytest.fixture(scope="module")
def worlds():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return {"dp2tp2": _world_checks(DP2TP2, full=True), "tp2": _world_checks(TP2, full=False),
                "dp2": _data_checks()}
    finally:
        torch.set_num_threads(threads)
        assert not dist.is_initialized()


@pytest.mark.parametrize("world,weights", [
    ("dp2tp2", "float"), ("dp2tp2", "int8"), ("dp2tp2", "untied"), ("tp2", "float"), ("tp2", "builder"),
])
def test_engine_tokens_equal_jax_on_the_same_mesh(worlds, world, weights):
    got, want = worlds[world][weights], worlds[world]["jax"][weights]
    assert got[2] == want[2] and got[1] == want[1] and got[0] == want[0]
    assert worlds[world]["backend"] == "gloo" and worlds[world]["size"] == {"dp2tp2": 4, "tp2": 2}[world]


@pytest.mark.parametrize("world", ["dp2tp2", "tp2"])
def test_session_round_equals_jax(worlds, world):
    assert worlds[world]["session"] == worlds[world]["jax"]["session"]


@pytest.mark.parametrize("refill", [True, False], ids=["device_refill", "host_driven"])
def test_batcher_data_groups_equal_jax(worlds, refill):
    got, want = worlds["dp2tp2"]["batcher"][refill], worlds["dp2tp2"]["jax"]["batcher"][refill]
    assert sorted(got) == list(range(7))
    assert got == want


def _scales(engine, rows: int):
    *_, session = engine.generate(frames()[:rows], PROMPTS[:rows], session_rounds=1, return_session=True)
    return session.cache["k_scale"] + session.cache["v_scale"]


def test_int8_kv_scales_on_two_data_groups_equal_one_rank(worlds):
    """Each layer's scales are the MAX over both data groups' rows, so they
    are the 1-rank port's over all three rows, not group 0's own two rows'.
    Equal within float32 rounding (rtol 1e-6): a group's projections run
    at another batch width, which moves a product by an ulp; the tokens
    are equal."""
    one = worlds["dp2"]["one_rank"]
    whole, group0 = _scales(one, 3), _scales(worlds["dp2"]["group0"], 2)
    got = worlds["dp2"]["kv_scales"]
    assert len(got) == len(whole) == len(group0)
    for part, full in zip(got, whole):
        torch.testing.assert_close(part, full, rtol=1e-6, atol=0)
    assert any(not torch.allclose(part, own, rtol=1e-3, atol=0) for part, own in zip(got, group0))
    assert worlds["dp2"]["kv_tokens"] == generate(one)


def test_speculative_engine_on_the_mesh_equals_one_rank(worlds):
    """The draft is replicated on the ranks: the mesh's plain and
    speculative tokens are the 1-rank engine's, and rows that complete
    agree between the two loops (at the token cap a speculative block may
    stop short, on one rank too)."""
    plain, spec = worlds["dp2"]["spec"]
    assert (plain, spec) == _spec_pair(None)
    done = [i for i, (a, b) in enumerate(zip(plain[1], spec[1])) if a and b]
    assert done and all(plain[2][i] == spec[2][i] for i in done)


def test_a_second_mesh_regroups_the_running_world(worlds):
    shape, size, tokens = worlds["dp2"]["regrouped"]
    assert shape == TP2 and size == 2
    assert tokens == generate(port_engine(None))


@pytest.mark.parametrize("case", list(UNEVEN))
def test_model_axis_above_the_kv_heads_is_refused(worlds, case):
    """A model axis that does not divide the heads gives JAX's greedy
    tokens on the same mesh shape (the plan of heads: a rank with no q
    heads, replicated kv heads, or an MHA layout)."""
    world = "dp2tp2" if UNEVEN[case][0] == TP4 else "tp2"
    got, want = worlds[world][case], worlds[world]["jax"][case]
    assert got[2] == want[2] and got[1] == want[1] and got[0] == want[0]
    assert any(len(ids) > 3 for ids in got[2])


def test_a_failing_worker_fails_rank_0(worlds):
    failure = worlds["dp2"]
    assert failure["no_collective"]
    assert failure["collective_s"] < 30, failure
    assert failure["collective_error"] != "MeshWorkerError"
