"""The port's flash-attention training path against the JAX package's, on the CPU.

The plain versions of K7a-c (``flash_fwd_lse_reference``,
``flash_bwd_reference``) are held against the JAX package's Pallas kernels
run in interpret mode (as tests/test_flash_bwd.py runs them) and against
``jax.vjp(mha_reference)``, on the same numpy inputs in float32. A causal
mask shifted by one position must fail the same comparisons. Autograd
through the port's ``flash_attention`` is held against ``jax.grad`` through
the JAX one on both dispatch routes (K7 for 128-aligned Sq == Sk, K1 plus
the reference backward otherwise).

Tolerances: everything is float32; the two sides differ in summation order
only, so outputs agree within 2e-5 and LSE and gradients within 2e-4 (the
bounds tests/test_flash_bwd.py holds the Pallas kernels to, rounded).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from video_transformer_tpu.ops.attention import flash_attention as j_flash_attention
from video_transformer_tpu.ops.attention import mha_reference as j_mha_reference
from video_transformer_tpu.ops.flash_bwd import flash_bwd as j_flash_bwd
from video_transformer_tpu.ops.flash_bwd import flash_fwd_lse as j_flash_fwd_lse
from video_transformer_tpu.ops.flash_bwd import supports_pallas_bwd
from video_transformer_tpu_torch.ops import flash_bwd as fb
from video_transformer_tpu_torch.ops.attention import flash_attention

torch.set_num_threads(2)

OUT_TOL = 2e-5
GRAD_TOL = 2e-4
NAMES = ("out", "lse", "dq", "dk", "dv")


def inputs(seed: int, s: int = 256, hq: int = 2, hkv: int = 1, d: int = 128, b: int = 1):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, hq, s, d)).astype(np.float32)
    k = rng.standard_normal((b, hkv, s, d)).astype(np.float32)
    v = rng.standard_normal((b, hkv, s, d)).astype(np.float32)
    g = rng.standard_normal((b, hq, s, d)).astype(np.float32)
    return q, k, v, g


def jax_pallas(q, k, v, g, causal):
    """The JAX package's K7a-c in interpret mode: O, LSE [B,Hq,S], dq, dk, dv."""
    out, lse = j_flash_fwd_lse(q, k, v, causal=causal, interpret=True)
    grads = j_flash_bwd(q, k, v, out, lse, jnp.asarray(g), causal=causal, interpret=True)
    return dict(zip(NAMES, map(np.asarray, (out, lse[..., 0], *grads))))


def jax_vjp(q, k, v, g, causal):
    out, vjp = jax.vjp(lambda *a: j_mha_reference(*a, causal=causal), q, k, v)
    return dict(zip(("out", "dq", "dk", "dv"), map(np.asarray, (out, *vjp(jnp.asarray(g))))))


def port_plain(q, k, v, g, causal):
    q, k, v, g = map(torch.from_numpy, (q, k, v, g))
    out, lse = fb.flash_fwd_lse_reference(q, k, v, causal)
    grads = fb.flash_bwd_reference(q, k, v, out, lse, g, causal)
    return {n: t.numpy() for n, t in zip(NAMES, (out, lse, *grads))}


def max_errors(got: dict, want: dict) -> dict:
    return {n: float(np.abs(got[n] - want[n]).max()) for n in want}


def tol(name: str) -> float:
    return OUT_TOL if name == "out" else GRAD_TOL


@pytest.fixture(scope="module", params=[True, False], ids=["causal", "full"])
def case(request):
    causal = request.param
    args = inputs(0)
    return causal, args, jax_pallas(*args, causal), jax_vjp(*args, causal)


def test_plain_versions_match_pallas_interpret(case):
    causal, args, pallas, _ = case
    errors = max_errors(port_plain(*args, causal), pallas)
    assert all(errors[n] <= tol(n) for n in NAMES), errors


def test_plain_versions_match_jax_vjp_of_mha_reference(case):
    causal, args, _, vjp = case
    errors = max_errors(port_plain(*args, causal), vjp)
    assert all(errors[n] <= tol(n) for n in vjp), errors


@pytest.mark.parametrize("shift", [1, -1])
def test_shifted_causal_mask_fails_the_comparison(monkeypatch, shift):
    """A causal mask off by one position (each query sees one key more, or
    one less) fails every comparison above by far more than its tolerance."""
    args = inputs(0)
    pallas, vjp = jax_pallas(*args, True), jax_vjp(*args, True)
    original = fb._logits

    def shifted(q, k, causal):
        logits = original(q, k, causal=False)
        pos = torch.arange(q.shape[2])
        return logits.masked_fill(pos[None, :] > pos[:, None] + shift, fb._NEG_INF)

    monkeypatch.setattr(fb, "_logits", shifted)
    got = port_plain(*args, True)
    for want in (pallas, vjp):
        errors = max_errors(got, want)
        assert all(errors[n] > 10 * tol(n) for n in want), errors


@pytest.mark.parametrize(
    "s_q,s_k,route",
    [(256, 256, "k7"), (128, 128, "k7"), (200, 200, "reference"), (32, 32, "reference"), (64, 192, "reference")],
)
@pytest.mark.parametrize("causal", [True, False])
def test_autograd_matches_jax_grad(s_q, s_k, route, causal):
    """Both dispatch routes of the differentiable flash_attention give
    jax.grad's gradients; only the second counts a reference backward."""
    q, _, _, g = inputs(1, s=s_q, hq=4, hkv=2, b=2)
    _, k, v, _ = inputs(2, s=s_k, hq=4, hkv=2, b=2)
    assert fb.supports_flash_bwd(s_q, s_k) == (route == "k7")

    def loss(q_, k_, v_):
        return jnp.sum(j_flash_attention(q_, k_, v_, causal=causal) * g)

    want = jax.grad(loss, argnums=(0, 1, 2))(q, k, v)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    before = flash_attention.reference_backwards
    out = flash_attention(tq, tk, tv, causal=causal)
    got = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(g))
    assert flash_attention.reference_backwards - before == (route == "reference")
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(j_mha_reference(q, k, v, causal)), atol=OUT_TOL)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=GRAD_TOL, rtol=GRAD_TOL, err_msg=name)


def test_no_grad_takes_the_serving_path():
    q, k, v, _ = (torch.from_numpy(a).requires_grad_() for a in inputs(3))
    before = flash_attention.reference_backwards
    with torch.no_grad():
        out = flash_attention(q, k, v, causal=True)
    assert out.grad_fn is None and flash_attention.reference_backwards == before


@pytest.mark.parametrize("s_q,s_k", [(s_q, s_k) for s_q in (64, 128, 200, 256, 384, 3072) for s_k in (128, 256, 3072)])
def test_supports_flash_bwd_is_the_jax_rule(s_q, s_k):
    assert fb.supports_flash_bwd(s_q, s_k) == supports_pallas_bwd(s_q, s_k)


def test_gqa_partials_sum_over_the_group():
    """flash_bwd sums K7c's per-q-head f32 partials over each GQA group and
    casts them to k's dtype; dq keeps q's dtype (exact: same arithmetic)."""
    q, k, v, g = (torch.from_numpy(a).bfloat16() for a in inputs(4, hq=4, hkv=2, b=2))
    out, lse = fb.flash_fwd_lse(q, k, v, True)
    assert out.dtype == torch.bfloat16 and lse.dtype == torch.float32 and lse.shape == (2, 4, 256)
    dsum = (g.float() * out.float()).sum(-1)
    dk_part, dv_part = fb.flash_bwd_dkv(q, k, v, g, lse, dsum, True)
    assert dk_part.shape == q.shape and dk_part.dtype == torch.float32
    dq, dk, dv = fb.flash_bwd(q, k, v, out, lse, g, True)
    assert dq.dtype == dk.dtype == dv.dtype == torch.bfloat16 and dk.shape == k.shape
    assert torch.equal(dq, fb.flash_bwd_dq(q, k, v, g, lse, dsum, True))
    assert torch.equal(dk, dk_part.reshape(2, 2, 2, 256, 128).sum(2).bfloat16())
    assert torch.equal(dv, dv_part.reshape(2, 2, 2, 256, 128).sum(2).bfloat16())
