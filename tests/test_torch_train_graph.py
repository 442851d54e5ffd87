"""The training step as one body on a fixed carry, and its graph route (CPU).

On one card ``Trainer.step`` replays a CUDA graph of the whole step (the
loss, ``torch.autograd.grad``, the global norm, the clip and the AdamW
update, ``parallel/graphs.py``); on the CPU the same body runs eagerly on
the same static carry. Here, on the tiny preset in float32:

- the body, over 4 steps, against the JAX package's ``Trainer.step`` on one
  module-scoped JAX run a case: the learning rate crosses the warm-up (0,
  then the peak, then the cosine), the clip engages on some steps and not
  on others (``max_grad_norm`` 2.4 against norms of 2.1-2.6), with
  ``accum_steps`` 1 and 2 and remat off and on (JAX's run has remat off:
  remat recomputes the same ops, and the tolerances are
  ``test_trainer_matches_jax_trainer``'s: loss rtol 1e-5, grad norm rtol
  1e-4, accuracy within one token, every parameter within 0.1 x lr);
- both bodies ("accumulate", "accumulate and apply") with every host read
  of a tensor refused;
- the graph route's control flow with a stand-in for ``torch.cuda.CUDAGraph``
  (nothing here can capture one) that records the aten ops a capture runs,
  with their Python scalars, puts back every tensor that existed before the
  capture, and replays that record: over steps whose learning rate changes
  it equals the eager route bit for bit (every metric, parameter, moment
  and count), while a learning rate read on the host and passed as a
  Python number does not; the launch counters move at each replay;
- the routes ("eager" on the CPU and on a gloo mesh of two CPU ranks, whose
  step keeps its parity with one rank), the step key, what drops it, and a
  restored checkpoint that a replay takes.
"""

import contextlib

import jax
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten, tree_map

from tests.test_torch_train import batch, configs, to_np
from video_transformer_tpu.parallel.mesh import build_mesh as j_build_mesh
from video_transformer_tpu.train.trainer import TrainConfig as JTrainConfig
from video_transformer_tpu.train.trainer import Trainer as JTrainer
from video_transformer_tpu_torch.models.config import get_preset
from video_transformer_tpu_torch.ops import flash_bwd as flash_bwd_module
from video_transformer_tpu_torch.ops.attention import flash_attention
from video_transformer_tpu_torch.parallel.mesh import build_mesh, build_pipe_mesh
from video_transformer_tpu_torch.train import trainer as trainer_module
from video_transformer_tpu_torch.train.data import synthetic_batch
from video_transformer_tpu_torch.train.trainer import STEP_KEYS, TrainConfig, Trainer
from video_transformer_tpu_torch.weights import from_jax_params

torch.set_num_threads(2)

STEPS = 4
LR = 1e-3
TC = dict(learning_rate=LR, warmup_steps=1, total_steps=6, max_grad_norm=2.4)


@pytest.fixture(scope="module")
def jax_runs():
    """One JAX run a value of ``accum_steps``: its initial parameters, each
    step's metrics, and its parameters after ``STEPS`` steps."""
    j_cfg, _ = configs()
    runs = {}
    for accum in (1, 2):
        mesh = j_build_mesh({"data": 1, "model": 1}, devices=jax.devices()[:1])
        trainer = JTrainer(j_cfg, mesh, JTrainConfig(**TC, accum_steps=accum), seed=0)
        start = to_np(trainer.params)
        metrics = [trainer.step(*batch(10 + step)) for step in range(STEPS)]
        runs[accum] = (start, metrics, to_np(trainer.params["params"]))
    return runs


def port_trainer(start, accum: int, remat: bool = False) -> Trainer:
    _, cfg = configs()
    return Trainer(cfg, TrainConfig(**TC, accum_steps=accum, remat=remat), device="cpu",
                   model=from_jax_params(start, cfg, device="cpu"))


@pytest.mark.parametrize("accum,remat", [(1, False), (1, True), (2, False), (2, True)])
def test_step_body_matches_jax_trainer(jax_runs, accum, remat):
    """The body on its static carry, step for step, against JAX's
    ``Trainer.step`` (the tolerances of the module docstring); the norms
    straddle the clip."""
    start, want_metrics, want_params = jax_runs[accum]
    ours = port_trainer(start, accum, remat)
    norms = []
    for step in range(STEPS):
        got, want = ours.step(*batch(10 + step)), want_metrics[step]
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5, err_msg=f"step {step}")
        np.testing.assert_allclose(got["grad_norm"], want["grad_norm"], rtol=1e-4, err_msg=f"step {step}")
        assert got["tokens"] == want["tokens"]
        assert abs(got["accuracy"] - want["accuracy"]) <= 1.0 / want["tokens"] + 1e-7
        norms.append(got["grad_norm"])
    assert ours.stats.step_route == "eager" and len(ours._steps) == 1
    assert int(ours.optimizer.count) == STEPS // accum and ours.optimizer.mini_step == 0
    if accum == 1:
        assert min(norms) < TC["max_grad_norm"] < max(norms)  # the clip engages on some steps only
    state = ours.model.state_dict()
    for name, leaf in jax.tree_util.tree_leaves_with_path(want_params):
        key = ".".join(str(getattr(p, "key", p)) for p in name)
        np.testing.assert_allclose(state[key].numpy(), leaf, atol=0.1 * LR, rtol=0, err_msg=key)


class Refused(AssertionError):
    pass


def refuse_host_reads(monkeypatch) -> None:
    def refuse(*args, **kwargs):
        raise Refused("the training step's body read the device")

    for name in ("__bool__", "item", "tolist", "cpu", "numpy", "__int__", "__float__"):
        monkeypatch.setattr(torch.Tensor, name, refuse)


@pytest.mark.parametrize("accum,remat", [(1, False), (2, True)])
def test_the_body_reads_nothing_on_the_host(monkeypatch, accum, remat):
    """Every body a configuration has (with accumulation "accumulate" and
    "accumulate and apply"), run with every host read of a tensor refused,
    and the update it made."""
    _, cfg = configs()
    trainer = Trainer(cfg, TrainConfig(**TC, accum_steps=accum, remat=remat), device="cpu", seed=0)
    entry = trainer._step_entry(*batch(10))
    weight = trainer.model.decoder.layer_0.attn.q.kernel.detach().clone()
    with monkeypatch.context() as patched:
        refuse_host_reads(patched)
        with pytest.raises(Refused):
            bool(entry.metrics[0])
        for _ in range(2):  # the first update has learning rate 0
            for apply in [False] * (accum - 1) + [True]:
                trainer._step_body(entry, apply)
    assert int(trainer.optimizer.count) == 2 and int(trainer.optimizer.mini) == 0
    assert torch.isfinite(entry.metrics).all() and entry.metrics[2] > 0
    assert not torch.equal(weight, trainer.model.decoder.layer_0.attn.q.kernel)


# -- a stand-in for torch.cuda.CUDAGraph ------------------------------------------


class Tape(TorchDispatchMode):
    """Records every aten op that runs under it (the op, its arguments with
    their Python scalars, its outputs) and keeps a copy of each storage that
    existed before the recording, taken before the recording's first write
    to it."""

    def __init__(self):
        super().__init__()
        self.ops = []
        self.fresh: set[int] = set()  # storages that the recorded ops allocated
        self.saved: dict[int, tuple] = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        schema = func._schema
        for i, arg in enumerate(schema.arguments):
            if arg.alias_info is not None and arg.alias_info.is_write:
                value = args[i] if i < len(args) else kwargs.get(arg.name)
                for t in tree_flatten(value)[0]:
                    self._save(t)
        out = func(*args, **kwargs)
        self.ops.append((func, args, kwargs, out))
        outs = (out,) if len(schema.returns) == 1 else out or ()
        for ret, value in zip(schema.returns, outs):
            if ret.alias_info is None:
                for t in tree_flatten(value)[0]:
                    if isinstance(t, torch.Tensor) and t.numel():
                        self.fresh.add(t.untyped_storage().data_ptr())
        return out

    def _save(self, t) -> None:
        if not isinstance(t, torch.Tensor) or not t.numel():
            return
        storage = t.untyped_storage()
        key = storage.data_ptr()
        if key not in self.fresh and key not in self.saved:
            self.saved[key] = (storage, storage.clone())


class TapeGraph:
    """``torch.cuda.CUDAGraph`` on the CPU: a capture records the ops of the
    captured code and puts back what existed before it (a capture runs
    nothing); a replay runs the record, the ops that the capture ran with
    their Python scalars, on the same tensors."""

    replays = 0

    def __init__(self):
        self.tape = None

    def register_generator_state(self, generator):
        raise AssertionError("a training step draws no random numbers")

    @contextlib.contextmanager
    def capture(self):
        self.tape = Tape()
        with self.tape:
            yield
        for storage, copy in self.tape.saved.values():
            storage.copy_(copy)

    def replay(self) -> None:
        TapeGraph.replays += 1
        env: dict[int, torch.Tensor] = {}

        def sub(x):
            return env.get(id(x), x) if isinstance(x, torch.Tensor) else x

        with torch.no_grad():
            for func, args, kwargs, out in self.tape.ops:
                new = func(*tree_map(sub, args), **tree_map(sub, kwargs))
                for was, now in zip(tree_flatten(out)[0], tree_flatten(new)[0]):
                    if isinstance(was, torch.Tensor):
                        env[id(was)] = now


class Pool:
    pool = stream = None

    def warm(self, fn):
        fn()


@pytest.fixture
def deterministic():
    """The CPU's ``index_put_`` with accumulation (the embedding's backward)
    sums duplicate rows in an order that depends on its threads, so that
    two eager steps may differ in the embedding's gradient; deterministic
    algorithms fix the order on both routes."""
    torch.use_deterministic_algorithms(True)
    yield
    torch.use_deterministic_algorithms(False)


def graph_route(monkeypatch, trainer: Trainer) -> None:
    """Take the graph route on the CPU (``TapeGraph``, ``Pool``)."""
    monkeypatch.setattr(torch.cuda, "CUDAGraph", TapeGraph)
    monkeypatch.setattr(torch.cuda, "graph", lambda graph, **kwargs: graph.capture())
    monkeypatch.setattr(trainer, "_step_route", lambda: "graph")
    trainer._graph_pool = Pool()


def counted_references(monkeypatch) -> None:
    """On CPU tensors the K7 wrappers run their plain versions and count
    nothing: count each call as a launch."""
    for name, kernel in (("flash_fwd_lse", "flash_fwd_lse"), ("flash_bwd_dq", "flash_bwd_dq"),
                         ("flash_bwd_dkv", "flash_bwd_dkv")):
        plain = getattr(flash_bwd_module, f"{name}_reference")

        def counted(*args, _plain=plain, _kernel=getattr(flash_bwd_module, kernel), **kwargs):
            _kernel.launches += 1
            return _plain(*args, **kwargs)

        monkeypatch.setattr(flash_bwd_module, f"{name}_reference", counted)


def counters() -> list[int]:
    return [flash_bwd_module.flash_fwd_lse.launches, flash_bwd_module.flash_bwd_dq.launches,
            flash_bwd_module.flash_bwd_dkv.launches, flash_attention.reference_backwards]


def state_of(trainer: Trainer) -> list[torch.Tensor]:
    opt = trainer.optimizer
    return [*opt.params, *opt.mu, *opt.nu, *opt.acc, opt.count, opt.mini]


def run_steps(trainer: Trainer, steps: range) -> list[dict]:
    return [trainer.step(*batch(10 + step)) for step in steps]


@pytest.mark.parametrize("accum,remat", [(1, False), (2, True)])
def test_stand_in_graph_route_equals_the_eager_route(deterministic, monkeypatch, accum, remat):
    """From the same weights over 6 steps whose learning rate changes, the
    graph route (a body's first step warmed up eagerly, then captured; the
    rest replays of the capture's record) equals the eager route bit for
    bit; the K7 counts and the recompute backwards move by their launches a
    step at every step, replays included."""
    _, cfg = configs()
    counted_references(monkeypatch)
    eager = Trainer(cfg, TrainConfig(**TC, accum_steps=accum, remat=remat), device="cpu", seed=1)
    graphed = Trainer(cfg, TrainConfig(**TC, accum_steps=accum, remat=remat), device="cpu", seed=1)
    graph_route(monkeypatch, graphed)
    steps = range(6)
    want = run_steps(eager, steps)
    before = counters()
    got = run_steps(graphed, steps)
    layers = cfg.decoder.num_layers * (2 if remat else 1)  # remat runs each decoder forward twice
    assert [a - b for a, b in zip(counters(), before)] == [layers * 6, cfg.decoder.num_layers * 6,
                                                           cfg.decoder.num_layers * 6, cfg.encoder.num_layers * 6]
    assert got == want
    assert all(torch.equal(a, b) for a, b in zip(state_of(graphed), state_of(eager)))
    bodies = 1 if accum == 1 else 2
    stats = graphed.stats
    assert (stats.step_route, stats.graphs_captured, stats.replays) == ("graph", bodies, 6 - bodies)


def test_stand_in_catches_a_baked_scalar(deterministic, monkeypatch):
    """The stand-in has teeth: a learning rate read on the host and handed
    to the update as a Python number replays its capture-time value, and
    the graph route then parts from the eager route."""
    _, cfg = configs()
    run = trainer_module.AdamW.run

    def baked(self, grads, norm, apply):
        schedule = self.schedule
        lr = float(schedule(self.count))  # a host read, then a Python number
        self.schedule = lambda count: torch.tensor(lr)
        try:
            run(self, grads, norm, apply)
        finally:
            self.schedule = schedule

    monkeypatch.setattr(trainer_module.AdamW, "run", baked)
    eager = Trainer(cfg, TrainConfig(**TC), device="cpu", seed=1)
    graphed = Trainer(cfg, TrainConfig(**TC), device="cpu", seed=1)
    graph_route(monkeypatch, graphed)
    run_steps(eager, range(4))
    run_steps(graphed, range(4))
    assert not all(torch.equal(a, b) for a, b in zip(graphed.optimizer.params, eager.optimizer.params))


def test_a_replay_after_restore_takes_the_restored_weights(deterministic, monkeypatch, tmp_path):
    """``restore_checkpoint`` copies into the parameters' own tensors: the
    key's graph stays, and its next replay trains the restored weights, as
    the eager route does from the same state."""
    _, cfg = configs()
    eager = Trainer(cfg, TrainConfig(**TC), device="cpu", seed=2)
    graphed = Trainer(cfg, TrainConfig(**TC), device="cpu", seed=2)
    graph_route(monkeypatch, graphed)
    saved = eager.save_checkpoint(tmp_path)  # params_0
    run_steps(eager, range(3))
    run_steps(graphed, range(3))
    graph = next(iter(graphed._steps.values())).graphs[True]
    for trainer in (eager, graphed):
        trainer.restore_checkpoint(saved)
    assert next(iter(graphed._steps.values())).graphs[True] is graph
    assert run_steps(graphed, range(3, 5)) == run_steps(eager, range(3, 5))
    assert all(torch.equal(a, b) for a, b in zip(state_of(graphed), state_of(eager)))
    assert graphed.stats.replays == 4 and graphed.step_count == 2


def test_routes_on_the_cpu_and_on_a_mesh():
    """"eager" on the CPU, also where ``_eager_step`` asks for it, and on a
    gloo mesh of two CPU ranks, ``(data, model)`` and pipe alike, each of
    which runs the body on its key's carry as one device does and whose
    step equals the 1-rank trainer's (``tests/test_torch_train.py``'s
    check: token count exact, loss and grad norm within rtol 1e-3). On NCCL
    both meshes take "graph" (``tests/test_torch_mesh_graph.py::
    test_route_rule``; the pipe's step ``tests/test_torch_pipe_graph.py``)."""
    tiny = get_preset("tiny")
    tc = TrainConfig(pp_microbatches=2)
    data = synthetic_batch(np.random.default_rng(0), tiny, 2, 224)
    one = Trainer(tiny, tc, device="cpu")
    assert one._step_route() == "eager"
    want = one.step(*data)
    assert one.stats.step_route == "eager"
    one._eager_step = True
    assert one._step_route() == "eager"
    got = {}
    mesh = build_mesh({"data": 1, "model": 2}, devices=["cpu"] * 2, timeout_s=120)
    try:
        for name in ("model", "pipe"):
            if name == "pipe":
                mesh = build_pipe_mesh(2, timeout_s=120)  # the running world, new groups
            trainer = Trainer(tiny, tc, device="cpu", mesh=mesh)
            got[name] = trainer.step(*data)
            assert (trainer.stats.step_route, len(trainer._steps), mesh.trains_on_graphs) == ("eager", 1, False), name
    finally:
        mesh.close()
    for name, metrics in got.items():
        assert metrics["tokens"] == want["tokens"], name
        np.testing.assert_allclose([metrics["loss"], metrics["grad_norm"]], [want["loss"], want["grad_norm"]],
                                   rtol=1e-3, err_msg=name)


def test_step_key_and_what_drops_it(tmp_path):
    """A key is the batch's shapes and dtypes and ``accum_steps``: the same
    batch shape reuses its entry (its buffers take each batch), another
    text length or token dtype takes a new one, and the least recently used
    key past ``STEP_KEYS`` is dropped. A checkpoint restore keeps them."""
    _, cfg = configs()
    trainer = Trainer(cfg, TrainConfig(**TC), device="cpu", seed=0)
    patches, tokens, prompt_lens = batch(10)
    first = trainer._step_entry(patches, tokens, prompt_lens)
    assert trainer._step_entry(*batch(11)) is first
    np.testing.assert_array_equal(first.tokens.numpy(), batch(11)[1])
    key = next(iter(trainer._steps))
    assert key == (((2, 32, cfg.encoder.patch_dim), torch.float32), ((2, 224), torch.int32), ((2,), torch.int32), 1)
    assert trainer._step_entry(patches, tokens.astype(np.int64), prompt_lens) is not first
    for width in range(STEP_KEYS - 1):
        trainer._step_entry(patches, tokens[:, : 96 + 32 * width], prompt_lens)
    assert len(trainer._steps) == STEP_KEYS and key not in trainer._steps
    accum = Trainer(cfg, TrainConfig(**TC, accum_steps=2), device="cpu", seed=0)
    accum._step_entry(patches, tokens, prompt_lens)
    assert next(iter(accum._steps))[-1] == 2 and len(accum.optimizer.acc) == len(accum.optimizer.params)
    entries = list(trainer._steps.values())
    trainer.restore_checkpoint(trainer.save_checkpoint(tmp_path))
    assert list(trainer._steps.values()) == entries


def test_default_prompt_lens_and_host_count():
    """Without ``prompt_lens`` the step masks ``TrainConfig.prompt_len``;
    the host's micro-step count picks the body, the device's counts follow."""
    _, cfg = configs()
    trainer = Trainer(cfg, TrainConfig(**TC, accum_steps=3, prompt_len=16), device="cpu", seed=0)
    patches, tokens, _ = batch(10)
    applied = []
    for _ in range(4):
        applied.append(trainer.optimizer.applies)
        trainer.step(patches, tokens)
    assert applied == [False, False, True, False]
    assert next(iter(trainer._steps.values())).prompt_lens.tolist() == [16, 16]
    assert (int(trainer.optimizer.count), int(trainer.optimizer.mini), trainer.optimizer.mini_step) == (1, 1, 1)
