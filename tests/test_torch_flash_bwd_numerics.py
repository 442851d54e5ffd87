"""Why the flash backward (K7b, K7c) splits dS and P into two bf16 parts, on the CPU.

The kernels (``csrc/flash_bwd.cu``) multiply on the tensor cores in bf16
with f32 accumulation. ``split_backward`` repeats their arithmetic in torch:
S and dP in f32 from bf16 operands, P = exp2(S scale log2e - LSE log2e) and
dS = P (dP - D) scale, then K7b's dQ += dS_hi K + dS_lo K over 64-key tiles
of each 128-row q tile up to the diagonal, and K7c's dV += P_hi^T dO +
P_lo^T dO and dK += dS_hi^T Q + dS_lo^T Q over 64-query tiles of each
128-key tile from the diagonal on, with x_hi = bf16(x), x_lo = bf16(x -
x_hi). It is held against the port's plain K7b and K7c
(``flash_bwd_dq_reference``, ``flash_bwd_dkv_reference``: f32 dS and P) and
the JAX package's Pallas ``flash_bwd`` in interpret mode, on the same
bf16-valued inputs (made with numpy from a seed), at the limits the card
holds K7b and K7c to: ``chip_smoke.BF16_TOL`` for dQ after its bf16
rounding, ``F32_TOL`` for the f32 dK and dV.

- With the split, dQ stays within half its limit before the rounding and
  within the limit after it (the rounding alone moves a value by up to one
  bf16 step); dK and dV stay within theirs.
- With bf16 dS and P alone, as a plain bf16 tensor-core backward would
  multiply them, dQ, dK and dV each miss their limit.
"""

import math

import numpy as np
import pytest
import torch

from chip_smoke import BF16_TOL, F32_TOL, closeness
from video_transformer_tpu.ops.flash_bwd import flash_bwd as j_flash_bwd
from video_transformer_tpu.ops.flash_bwd import flash_fwd_lse as j_flash_fwd_lse
from video_transformer_tpu_torch.ops.flash_bwd import (
    flash_bwd_dkv_reference,
    flash_bwd_dq_reference,
    flash_fwd_lse_reference,
)

torch.set_num_threads(2)

BLOCK_ROWS = 128  # the tile a block keeps: K7b's queries, K7c's keys (flash_bwd::kRows)
BLOCK_STEP = 64  # the streamed tile: K7b's keys, K7c's queries (flash_bwd::kStep)
LOG2E = math.log2(math.e)
# (q heads, kv heads, S, causal): GQA groups 1, 4 and 7.
SHAPES = [(4, 4, 128, True), (4, 4, 128, False), (8, 2, 256, True), (8, 2, 256, False),
          (7, 1, 384, True), (7, 1, 384, False)]
IDS = [f"hq{hq}-hkv{hkv}-s{s}-{'causal' if c else 'full'}" for hq, hkv, s, c in SHAPES]


def split_backward(q, k, v, dout, lse, dsum, causal: bool, split: bool = True):
    """The kernels' arithmetic in f32: (dQ before its bf16 rounding, dK and
    dV per-q-head partials [B, Hq, S, D]). ``split=False`` multiplies bf16 dS
    and P alone."""
    b, hq, s, d = q.shape
    hkv = k.shape[1]
    group = (b, hkv, hq // hkv, s)
    qg, dog = q.float().reshape(*group, d), dout.float().reshape(*group, d)
    kf, vf = k.float()[:, :, None], v.float()[:, :, None]
    lse_log2, dd = lse.float().reshape(group) * LOG2E, dsum.float().reshape(group)
    scale = 1.0 / math.sqrt(d)

    def parts(x: torch.Tensor) -> list[torch.Tensor]:
        hi = x.to(torch.bfloat16).float()
        return [hi, (x - hi).to(torch.bfloat16).float()] if split else [hi]

    def grad_scores(q0: int, q1: int, k0: int, k1: int) -> tuple[torch.Tensor, torch.Tensor]:
        """(P, dS) for queries q0:q1 against keys k0:k1."""
        x = qg[..., q0:q1, :] @ kf[..., k0:k1, :].transpose(-1, -2) * (scale * LOG2E) - lse_log2[..., q0:q1, None]
        if causal:
            x = x.masked_fill(torch.arange(k0, k1)[None, :] > torch.arange(q0, q1)[:, None], -math.inf)
        p = torch.exp2(x)
        dp = dog[..., q0:q1, :] @ vf[..., k0:k1, :].transpose(-1, -2)
        return p, p * (dp - dd[..., q0:q1, None]) * scale

    dq = torch.zeros_like(qg)
    for q0 in range(0, s, BLOCK_ROWS):  # K7b: a block per q tile, keys up to the diagonal
        q1 = q0 + BLOCK_ROWS
        for k0 in range(0, q1 if causal else s, BLOCK_STEP):
            _, ds = grad_scores(q0, q1, k0, k0 + BLOCK_STEP)
            for part in parts(ds):
                dq[..., q0:q1, :] += part @ kf[..., k0:k0 + BLOCK_STEP, :]
    dk, dv = torch.zeros_like(qg), torch.zeros_like(qg)
    for k0 in range(0, s, BLOCK_ROWS):  # K7c: a block per key tile, queries from the diagonal
        k1 = k0 + BLOCK_ROWS
        for q0 in range(k0 if causal else 0, s, BLOCK_STEP):
            q1 = q0 + BLOCK_STEP
            p, ds = grad_scores(q0, q1, k0, k1)
            for part in parts(p):
                dv[..., k0:k1, :] += part.transpose(-1, -2) @ dog[..., q0:q1, :]
            for part in parts(ds):
                dk[..., k0:k1, :] += part.transpose(-1, -2) @ qg[..., q0:q1, :]
    return tuple(t.reshape(b, hq, s, d) for t in (dq, dk, dv))


def inputs(hq: int, hkv: int, s: int, seed: int = 0) -> list[torch.Tensor]:
    """q, k, v, dO: bf16 values held in f32, so that every reference returns f32."""
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal((1, h, s, 128)).astype(np.float32)).bfloat16().float()
            for h in (hq, hkv, hkv, hq)]


def held(got: tuple, want: tuple) -> dict:
    """Ratios to the card's limits: dQ before and after bf16 rounding, dK, dV."""
    (dq, dk, dv), (want_dq, want_dk, want_dv) = got, want
    return {"dq": closeness(dq, want_dq, *BF16_TOL)["ratio"],
            "dq_rounded": closeness(dq.bfloat16(), want_dq.bfloat16(), *BF16_TOL)["ratio"],
            "dk": closeness(dk, want_dk, *F32_TOL)["ratio"],
            "dv": closeness(dv, want_dv, *F32_TOL)["ratio"]}


def plain_case(hq: int, hkv: int, s: int, causal: bool, seed: int):
    """Inputs with K7a's plain LSE and D, and the plain K7b and K7c."""
    q, k, v, dout = inputs(hq, hkv, s, seed)
    out, lse = flash_fwd_lse_reference(q, k, v, causal)
    args = (q, k, v, dout, lse, (dout * out).sum(-1))
    return args, (flash_bwd_dq_reference(*args, causal), *flash_bwd_dkv_reference(*args, causal))


@pytest.mark.parametrize("hq,hkv,s,causal", SHAPES, ids=IDS)
def test_split_ds_and_p_fit_the_limits_against_the_plain_version(hq, hkv, s, causal):
    args, want = plain_case(hq, hkv, s, causal, seed=0)
    got = held(split_backward(*args, causal), want)
    assert got["dq"] <= 0.5 and all(got[n] <= 1 for n in ("dq_rounded", "dk", "dv")), got


@pytest.mark.parametrize("hq,hkv,s,causal", SHAPES, ids=IDS)
def test_split_ds_and_p_fit_the_limits_against_pallas_interpret(hq, hkv, s, causal):
    """Against the Pallas kernels, which sum dK and dV over the GQA group."""
    q, k, v, dout = inputs(hq, hkv, s, seed=1)
    arrays = [t.numpy() for t in (q, k, v, dout)]
    out, lse = j_flash_fwd_lse(*arrays[:3], causal=causal, interpret=True)
    want = [torch.from_numpy(np.array(t)) for t in j_flash_bwd(*arrays[:3], out, lse, arrays[3], causal=causal,
                                                                  interpret=True)]
    out, lse = torch.from_numpy(np.array(out)), torch.from_numpy(np.array(lse)[..., 0])
    dq, dk, dv = split_backward(q, k, v, dout, lse, (dout * out).sum(-1), causal)
    dk, dv = (t.reshape(1, hkv, hq // hkv, s, 128).sum(2) for t in (dk, dv))
    got = held((dq, dk, dv), want)
    assert got["dq"] <= 0.5 and all(got[n] <= 1 for n in ("dq_rounded", "dk", "dv")), got


@pytest.mark.parametrize("hq,hkv,s,causal", SHAPES, ids=IDS)
def test_bf16_ds_and_p_alone_miss_the_limits(hq, hkv, s, causal):
    args, want = plain_case(hq, hkv, s, causal, seed=2)
    got = held(split_backward(*args, causal, split=False), want)
    assert all(got[n] > 1 for n in ("dq_rounded", "dk", "dv")), got
