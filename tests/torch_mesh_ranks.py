"""The ranks' side of the CPU mesh tests (``tests/test_torch_*``): functions
that every rank of a gloo world runs through ``Mesh.run_all``, and the
weights they build. A spawned rank imports this module to unpickle them, so
it imports torch, numpy and the port, never JAX.
"""

import numpy as np
import torch

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
