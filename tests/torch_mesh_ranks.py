"""The ranks' side of the CPU mesh tests (``tests/test_torch_*``): functions
that every rank of a gloo world runs through ``Mesh.run_all``, and the
weights they build. A spawned rank imports this module to unpickle them, so
it imports torch, numpy and the port, never JAX.
"""

import contextlib

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten, tree_map

from video_transformer_tpu_torch.models.config import DecoderConfig
from video_transformer_tpu_torch.models.lm import Decoder
from video_transformer_tpu_torch.parallel.pipeline_parallel import pipeline_decoder_apply, shard_stages, stage_range


def decoder_config(layers: int) -> DecoderConfig:
    """JAX ``tests/test_pipeline_parallel.py``'s micro decoder."""
    return DecoderConfig(vocab_size=256, hidden_dim=64, num_layers=layers, num_heads=2, num_kv_heads=1, head_dim=32,
                         mlp_dim=128, max_seq_len=64)


def port_decoder(leaves: dict, layers: int) -> Decoder:
    decoder = Decoder(decoder_config(layers))
    decoder.load_state_dict({k: torch.from_numpy(v.copy()) for k, v in leaves.items()})
    return decoder


def pipe_stage_run(mesh, leaves, layers, tokens, n_micro, schedule, remat, cut) -> dict:
    """One case on this rank: logits, this stage's gradients and the
    replicated leaves' (``cut``: the decoder cut to its stage first)."""
    decoder = port_decoder(leaves, layers)
    if cut:
        shard_stages(decoder, mesh)
    logits = pipeline_decoder_apply(decoder, torch.from_numpy(tokens), mesh, n_micro, remat=remat, schedule=schedule)
    named = {f"layer_{i}.{n}": p for i in stage_range(layers, mesh)
             for n, p in getattr(decoder, f"layer_{i}").named_parameters()}
    named.update({"embed.embedding": decoder.embed.embedding, "final_norm.weight": decoder.final_norm.weight})
    before = mesh.collectives
    grads = torch.autograd.grad(logits.square().mean(), list(named.values()))
    return {"logits": logits.detach().numpy(), "grads": {n: g.numpy() for n, g in zip(named, grads)},
            "backward_collectives": mesh.collectives - before, "layers": list(stage_range(layers, mesh))}


def trainer_leaves(trainer) -> dict:
    """This rank's parameters, the axis that splits each (None: whole), its
    plan's kv heads and the leaves whose kv heads have several holders."""
    named = [(n, p) for n, p in trainer.model.named_parameters() if p.requires_grad]
    kv_heads = trainer._plan().kv_heads if trainer.mesh.model > 1 else ()
    return {"rank": trainer.mesh.rank, "model_index": trainer.mesh.model_index,
            "leaves": {n: p.detach().clone() for n, p in named},
            "split": {n: axis for (n, _), axis in zip(named, trainer._split)},
            "kv_heads": kv_heads, "kv_leaves": [named[i][0] for i in trainer._kv],
            "head_dim": trainer.config.decoder.head_dim}


def cp_run(mesh, q, k, v, causal: bool, grad: bool) -> dict:
    """``ring_attention`` on this rank (and with ``grad``, the gradients of
    ``mean(out ** 2)`` with respect to q, k and v)."""
    from video_transformer_tpu_torch.parallel.context_parallel import ring_attention

    q, k, v = ((t if isinstance(t, torch.Tensor) else torch.from_numpy(np.array(t))).requires_grad_(grad)
               for t in (q, k, v))
    out = ring_attention(q, k, v, mesh, causal=causal)
    result = {"out": out.detach().float().numpy(), "dtype": str(out.dtype)}
    if grad:
        result["grads"] = [g.numpy() for g in torch.autograd.grad(out.float().square().mean(), (q, k, v))]
    return result


def ep_run(mesh, params: dict, x, resident: bool) -> dict:
    """``moe_swiglu`` on this rank, its output, aux loss and the gradients
    of ``mean(out ** 2) + 0.01 * aux`` (``resident``: this rank holds only
    its experts' weights)."""
    from video_transformer_tpu_torch.parallel.expert_parallel import EXPERT_AXIS, moe_swiglu
    from video_transformer_tpu_torch.weights import from_jax_moe_params

    tensors = from_jax_moe_params(params, device="cpu")
    if resident:
        per = tensors["router"].shape[1] // mesh.axis_size(EXPERT_AXIS)
        lo = mesh.axis_index(EXPERT_AXIS) * per
        tensors.update({n: tensors[n].detach()[lo:lo + per].clone().requires_grad_() for n in ("gate", "up", "down")})
    out, aux = moe_swiglu(tensors, torch.from_numpy(np.array(x)), mesh)
    grads = torch.autograd.grad(out.square().mean() + 0.01 * aux, list(tensors.values()))
    return {"out": out.detach().numpy(), "aux": aux.item(), "grads": {n: g.numpy() for n, g in zip(tensors, grads)},
            "collectives": mesh.collectives}


def stage_layers(trainer) -> list[int]:
    """The layers of this rank's pipeline stage."""
    return list(trainer.model.decoder.stage_layers)


# -- the graph route on gloo CPU ranks (tests/test_torch_mesh_graph.py) ----------
#
# Nothing here can capture a CUDA graph, and gloo's collectives run on the
# host. ``graph_stand_in`` makes a rank take the graph route all the same:
# ``Mesh.capturable`` says yes, and ``TapeGraph`` stands in for
# ``torch.cuda.CUDAGraph``: a capture records the aten and c10d ops of the
# captured steps (running them, then putting back every storage that
# existed before, so that the capture leaves the state as it found it), and
# a replay runs the record again on the same tensors, with the Python
# scalars the capture saw. ``StepGraph`` and the callers' control flow are
# the port's own.


class Tape(TorchDispatchMode):
    """Records every op that runs under it (the op, its arguments with their
    Python scalars, its outputs) and keeps a copy of each storage that
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
    """``torch.cuda.CUDAGraph`` on gloo CPU ranks (see above). A replayed
    collective (a c10d op) runs again on this rank's group, so every rank of
    a group must replay its graphs in the same order, as on the cards; its
    work is waited on before the next op reads its result."""

    def __init__(self):
        self.tape = None

    def register_generator_state(self, generator):
        raise AssertionError("these runs are greedy: no step draws")

    def reset(self) -> None:
        self.tape = None

    @contextlib.contextmanager
    def capture(self):
        self.tape = Tape()
        with self.tape:
            yield
        for storage, copy in self.tape.saved.values():
            storage.copy_(copy)

    def replay(self) -> None:
        env: dict[int, torch.Tensor] = {}

        def sub(x):
            return env.get(id(x), x) if isinstance(x, torch.Tensor) else x

        with torch.no_grad():
            for func, args, kwargs, out in self.tape.ops:
                new = func(*tree_map(sub, args), **tree_map(sub, kwargs))
                for item in tree_flatten(new)[0]:
                    if isinstance(item, torch.ScriptObject):  # a collective's work
                        item.wait()
                for was, now in zip(tree_flatten(out)[0], tree_flatten(new)[0]):
                    if isinstance(was, torch.Tensor):
                        env[id(was)] = now


class Pool:
    """``GraphPool`` on the CPU: no pool, no side stream."""

    pool = stream = None

    def warm(self, fn):
        fn()


_SAVED: dict = {}
STAND_IN_CHUNK, STAND_IN_SPEC_CHUNK = 5, 2


def _counted(plain, wrapper):
    def counted(*args, **kwargs):
        wrapper.launches += 1
        return plain(*args, **kwargs)
    return counted


def graph_stand_in(on: bool) -> None:
    """On this rank: take the graph route on a gloo CPU mesh (``TapeGraph``,
    ``Mesh.capturable`` true) in chunks of 5 steps (2 speculative cycles),
    so that a short call warms up, captures and replays, and count a call of a kernel's plain version
    on a CPU tensor as a launch of its wrapper (K1, K3's decode attention,
    K7a-c and K1's recompute backward count where they run); ``False`` puts
    back what ``True`` replaced."""
    from video_transformer_tpu_torch.ops import attention as attention_module
    from video_transformer_tpu_torch.ops import decode_attention as decode_module
    from video_transformer_tpu_torch.ops import flash_bwd as flash_bwd_module
    from video_transformer_tpu_torch.parallel import engine as engine_module
    from video_transformer_tpu_torch.parallel.mesh import Mesh

    if not on:
        for (owner, name), value in _SAVED.items():
            setattr(owner, name, value)
        _SAVED.clear()
        return
    replaced = {(Mesh, "capturable"): property(lambda self: True), (torch.cuda, "CUDAGraph"): TapeGraph,
                (torch.cuda, "graph"): lambda graph, **kwargs: graph.capture(),
                (engine_module, "DECODE_CHUNK"): STAND_IN_CHUNK, (engine_module, "SPEC_CHUNK"): STAND_IN_SPEC_CHUNK,
                (decode_module, "_scaled_reference"): _counted(decode_module._scaled_reference,
                                                               decode_module.decode_attention),
                (attention_module, "_forward"): _counted(attention_module._forward, attention_module.flash_attention)}
    for name in ("flash_fwd_lse", "flash_bwd_dq", "flash_bwd_dkv"):
        replaced[(flash_bwd_module, f"{name}_reference")] = _counted(getattr(flash_bwd_module, f"{name}_reference"),
                                                                     getattr(flash_bwd_module, name))
    for (owner, name), value in replaced.items():
        _SAVED[(owner, name)] = owner.__dict__[name] if isinstance(owner, type) else getattr(owner, name)
        setattr(owner, name, value)


def take_graph_route(obj) -> None:
    """An engine's or a trainer's graphs on the CPU: ``Pool`` for its pool."""
    obj._graph_pool = Pool()


def launch_counts() -> dict:
    from video_transformer_tpu_torch.ops.attention import flash_attention
    from video_transformer_tpu_torch.ops.decode_attention import decode_attention
    from video_transformer_tpu_torch.ops.flash_bwd import flash_bwd_dkv, flash_bwd_dq, flash_fwd_lse

    return {"flash_attention": flash_attention.launches, "decode_attention": decode_attention.launches,
            "flash_fwd_lse": flash_fwd_lse.launches,
            "flash_bwd_dq": flash_bwd_dq.launches, "flash_bwd_dkv": flash_bwd_dkv.launches,
            "reference_backwards": flash_attention.reference_backwards}


def rank_counts(mesh) -> dict:
    """This rank's collectives and launch counts."""
    return dict(launch_counts(), collectives=mesh.collectives, rank=mesh.rank)


def step_costs(engine) -> dict:
    """What one decode step (a speculative cycle) of this rank moves: one
    more step, eager, on the carry of the engine's last graph key (past the
    loop's end: frozen, its collectives and kernels all the same)."""
    carry = engine._graphs[next(reversed(engine._graphs))].carry
    before = rank_counts(engine.mesh)
    with torch.no_grad():
        (engine._spec_step if carry.draft_cache is not None else engine._decode_step)(carry)
    after = rank_counts(engine.mesh)
    return {k: after[k] - before[k] for k in after if k != "rank"}


class HostRead(AssertionError):
    pass


def body_reads_nothing(trainer, patches, tokens, prompt_lens) -> dict:
    """Every body of this rank's trainer (with accumulation "accumulate"
    then "accumulate and apply"), run twice with every host read of a
    tensor refused; the metrics the last wrote."""
    entry = trainer._step_entry(patches, tokens, prompt_lens)
    accum = trainer.train_config.accum_steps

    def refuse(*args, **kwargs):
        raise HostRead("the training step's body read the device")

    names = ("__bool__", "item", "tolist", "__float__", "__int__", "numpy")
    saved = {name: getattr(torch.Tensor, name) for name in names}
    try:
        for name in names:
            setattr(torch.Tensor, name, refuse)
        refused = False
        try:
            bool(entry.metrics[0])
        except HostRead:
            refused = True
        for _ in range(2):
            for apply in [False] * (accum - 1) + [True]:
                trainer._step_body(entry, apply)
    finally:
        for name, method in saved.items():
            setattr(torch.Tensor, name, method)
    return {"refused": refused, "metrics": entry.metrics.tolist(), "count": int(trainer.optimizer.count)}
