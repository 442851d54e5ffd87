"""Why the flash forward (K1, K7a) splits P into two bf16 parts, on the CPU.

The kernel (``csrc/flash_fwd.cuh``) multiplies on the tensor cores in bf16
with f32 accumulation. ``split_forward`` repeats its arithmetic in torch:
128-key tiles, an online softmax in exp2 with the scale folded in, and
O += P_hi V + P_lo V with P_hi = bf16(P), P_lo = bf16(P - P_hi). It is held
against the port's plain K7a (``flash_fwd_lse_reference``, f32 P) and the JAX
package's Pallas ``_fwd_lse_kernel`` in interpret mode, on the same
bf16-valued inputs (made with numpy from a seed), at the limits the card
holds K1 and K7a to (``chip_smoke.BF16_TOL``, ``LSE_TOL``):

- before O's final bf16 rounding, the split stays within half the
  element-wise limit (it reads 0.006-0.014 of it);
- rounded to bf16 on both sides, as the card compares, within the limit.
  The rounding alone moves a value by up to one bf16 step, up to ~0.78 of
  the limit, whatever P's precision;
- with bf16 P alone (what FlashAttention and SDPA use), O misses the limit
  (3.5-6.1x here), because P's rounding error does not shrink where |O|
  does.
"""

import math

import numpy as np
import pytest
import torch

from chip_smoke import BF16_TOL, LSE_TOL, closeness
from video_transformer_tpu.ops.flash_bwd import flash_fwd_lse as j_flash_fwd_lse
from video_transformer_tpu_torch.ops.flash_bwd import flash_fwd_lse_reference

torch.set_num_threads(2)

BLOCK_KEYS = 128  # the kernel's key tile (flash_fwd::kBN)
# (q heads, kv heads, S, causal): GQA groups 1, 4 and 7.
SHAPES = [(4, 4, 128, True), (4, 4, 128, False), (8, 2, 256, True), (8, 2, 256, False),
          (7, 1, 384, True), (7, 1, 384, False)]
IDS = [f"hq{hq}-hkv{hkv}-s{s}-{'causal' if c else 'full'}" for hq, hkv, s, c in SHAPES]


def split_forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
                  split: bool = True) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernel's arithmetic in f32: (O before its bf16 rounding, LSE).
    ``split=False`` multiplies bf16 P alone."""
    b, hq, s_q, d = q.shape
    hkv, s_k = k.shape[1], k.shape[2]
    qg = q.float().reshape(b, hkv, hq // hkv, s_q, d)
    scale_log2 = math.log2(math.e) / math.sqrt(d)
    m = torch.full(qg.shape[:-1], -math.inf)
    l = torch.zeros_like(m)
    acc = torch.zeros_like(qg)
    q_pos = torch.arange(s_q)[:, None] + (s_k - s_q)
    for k0 in range(0, s_k, BLOCK_KEYS):
        k_tile, v_tile = k[:, :, k0:k0 + BLOCK_KEYS].float(), v[:, :, k0:k0 + BLOCK_KEYS].float()
        s = torch.einsum("bhgqd,bhkd->bhgqk", qg, k_tile)
        if causal:
            s = s.masked_fill(torch.arange(k0, k0 + k_tile.shape[2])[None, :] > q_pos, -math.inf)
        m_new = torch.maximum(m, s.amax(-1) * scale_log2)
        alpha = torch.where(m_new == -math.inf, 1.0, torch.exp2(m - m_new))
        p = torch.exp2(s * scale_log2 - torch.where(m_new == -math.inf, 0.0, m_new)[..., None])
        l = l * alpha + p.sum(-1)
        p_hi = p.to(torch.bfloat16).float()
        pv = torch.einsum("bhgqk,bhkd->bhgqd", p_hi, v_tile)
        if split:
            pv = pv + torch.einsum("bhgqk,bhkd->bhgqd", (p - p_hi).to(torch.bfloat16).float(), v_tile)
        acc = acc * alpha[..., None] + pv
        m = m_new
    out = (acc / l[..., None]).reshape(b, hq, s_q, d)
    return out, (m * math.log(2) + torch.log(l)).reshape(b, hq, s_q)


def inputs(hq: int, hkv: int, s: int, seed: int = 0) -> list[torch.Tensor]:
    """bf16 values held in f32, so that every reference returns f32 O."""
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal((1, h, s, 128)).astype(np.float32)).bfloat16().float()
            for h in (hq, hkv, hkv)]


def held(out: torch.Tensor, lse: torch.Tensor, want_out: torch.Tensor, want_lse: torch.Tensor) -> dict:
    """The ratios to the card's limits: O before and after bf16 rounding, LSE."""
    return {"ratio": closeness(out, want_out, *BF16_TOL)["ratio"],
            "rounded_ratio": closeness(out.bfloat16(), want_out.bfloat16(), *BF16_TOL)["ratio"],
            "lse_err": (lse - want_lse).abs().max().item()}


def assert_split_fits(got: dict) -> None:
    assert got["ratio"] <= 0.5, got
    assert got["rounded_ratio"] <= 1, got
    assert got["lse_err"] <= LSE_TOL, got


@pytest.mark.parametrize("hq,hkv,s,causal", SHAPES, ids=IDS)
def test_split_p_fits_the_limits_against_the_plain_version(hq, hkv, s, causal):
    q, k, v = inputs(hq, hkv, s)
    assert_split_fits(held(*split_forward(q, k, v, causal), *flash_fwd_lse_reference(q, k, v, causal)))


@pytest.mark.parametrize("hq,hkv,s,causal", SHAPES, ids=IDS)
def test_split_p_fits_the_limits_against_pallas_interpret(hq, hkv, s, causal):
    q, k, v = inputs(hq, hkv, s, seed=1)
    want_out, want_lse = j_flash_fwd_lse(*(t.numpy() for t in (q, k, v)), causal=causal, interpret=True)
    want = torch.from_numpy(np.array(want_out)), torch.from_numpy(np.array(want_lse)[..., 0])
    assert_split_fits(held(*split_forward(q, k, v, causal), *want))


@pytest.mark.parametrize("hq,hkv,s,causal", SHAPES, ids=IDS)
def test_bf16_p_alone_misses_the_limit(hq, hkv, s, causal):
    q, k, v = inputs(hq, hkv, s, seed=2)
    got = held(*split_forward(q, k, v, causal, split=False), *flash_fwd_lse_reference(q, k, v, causal))
    assert got["ratio"] > 1 and got["rounded_ratio"] > 1, got
