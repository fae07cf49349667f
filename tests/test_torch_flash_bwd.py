"""The port's differentiable flash attention (dlrover_tpu_torch
ops/flash_attention.py) against the JAX package, on the same numpy
inputs. On CPU tensors the port's autograd Function runs `_fwd_plain`
and `_bwd_plain` (the backward kernels' function in plain PyTorch); it
is held to the VJP of the JAX `flash_attention`, whose custom VJP runs
the Pallas backward kernels in interpret mode on the CPU (as
tests/test_flash_attention.py runs them), and, at ragged lengths the
JAX kernels do not take, to autograd through the port's
`reference_attention`.

Tolerances: f32 atol = rtol = 5e-4, the JAX flash tests' own (both
sides are f32 throughout; the order of the sums differs). bf16: 2^-6 of
the largest |gradient| of each tensor. Both sides round P and dS to
bf16 before the products and the gradients once at the end, but JAX
rounds dK/dV once per q head before autodiff sums the GQA group (in
bf16), while the port sums the group in f32 and rounds once; and an
element of P or dS near a rounding boundary may round the other way on
the two sides (one bf16 ulp, 2^-8 relative)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dlrover_tpu.ops import flash_attention as jfa
from dlrover_tpu_torch.ops import _build
from dlrover_tpu_torch.ops import attention as tattn
from dlrover_tpu_torch.ops import flash_attention as tfa

F32_TOL = 5e-4
BF16_REL = 2 ** -6


def _inputs(seed, s, h, kv, d, b=1):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, s, h, d)).astype(np.float32)
    k = rng.standard_normal((b, s, kv, d)).astype(np.float32)
    v = rng.standard_normal((b, s, kv, d)).astype(np.float32)
    g = rng.standard_normal((b, s, h, d)).astype(np.float32)
    return q, k, v, g


def _port_grads(fn, q, k, v, g, dtype):
    ts = [torch.from_numpy(x).to(dtype).requires_grad_() for x in (q, k, v)]
    out = fn(*ts)
    out.backward(torch.from_numpy(g).to(dtype))
    return out.detach(), [t.grad for t in ts]


def _jax_grads(q, k, v, g, causal, dtype):
    out, vjp = jax.vjp(
        lambda q, k, v: jfa.flash_attention(q, k, v, causal=causal),
        *(jnp.asarray(x, dtype) for x in (q, k, v)),
    )
    return out, vjp(jnp.asarray(g, dtype))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x.astype(jnp.float32))


@pytest.mark.parametrize(
    "s,kv,causal",
    [(128, 4, True), (128, 2, False), (256, 2, True), (256, 4, False)],
    ids=["s128-mha-causal", "s128-gqa", "s256-gqa-causal", "s256-mha"],
)
def test_f32_grads_match_jax_flash(s, kv, causal):
    q, k, v, g = _inputs(0, s, 4, kv, 64)
    out, grads = _port_grads(
        lambda *t: tfa.flash_attention(*t, causal=causal), q, k, v, g,
        torch.float32)
    j_out, j_grads = _jax_grads(q, k, v, g, causal, jnp.float32)
    np.testing.assert_allclose(_np(out), _np(j_out), atol=F32_TOL,
                               rtol=F32_TOL)
    for name, got, want in zip("qkv", grads, j_grads):
        np.testing.assert_allclose(_np(got), _np(want), atol=F32_TOL,
                                   rtol=F32_TOL, err_msg=f"d{name}")


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_f32_grads_match_jax_flash_at_head_dim_256(causal):
    """head_dim 256, which the forward and (split into two 128-column
    halves of the outputs) the mma.sync backward kernels take: q/k/v
    [1, 128, 4, 256]; the JAX kernels run in interpret mode."""
    q, k, v, g = _inputs(4, 128, 4, 4, 256)
    out, grads = _port_grads(
        lambda *t: tfa.flash_attention(*t, causal=causal), q, k, v, g,
        torch.float32)
    j_out, j_grads = _jax_grads(q, k, v, g, causal, jnp.float32)
    np.testing.assert_allclose(_np(out), _np(j_out), atol=F32_TOL,
                               rtol=F32_TOL)
    for name, got, want in zip("qkv", grads, j_grads):
        np.testing.assert_allclose(_np(got), _np(want), atol=F32_TOL,
                                   rtol=F32_TOL, err_msg=f"d{name}")


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_bf16_grads_match_jax_flash(causal):
    q, k, v, g = _inputs(1, 128, 4, 2, 64)
    _, grads = _port_grads(
        lambda *t: tfa.flash_attention(*t, causal=causal), q, k, v, g,
        torch.bfloat16)
    _, j_grads = _jax_grads(q, k, v, g, causal, jnp.bfloat16)
    for name, got, want in zip("qkv", grads, j_grads):
        assert got.dtype == torch.bfloat16
        got, want = _np(got), _np(want)
        err = np.abs(got - want).max()
        assert err <= BF16_REL * np.abs(want).max(), (name, err)


@pytest.mark.parametrize("s", [77, 200])
@pytest.mark.parametrize("kv", [4, 2], ids=["mha", "gqa"])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_ragged_grads_match_reference_autograd(s, kv, causal):
    q, k, v, g = _inputs(2, s, 4, kv, 64)
    out, grads = _port_grads(
        lambda *t: tfa.flash_attention(*t, causal=causal), q, k, v, g,
        torch.float32)
    r_out, r_grads = _port_grads(
        lambda *t: tattn.reference_attention(*t, causal=causal), q, k, v,
        g, torch.float32)
    np.testing.assert_allclose(out.numpy(), r_out.numpy(), atol=F32_TOL,
                               rtol=F32_TOL)
    for name, got, want in zip("qkv", grads, r_grads):
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=F32_TOL,
                                   rtol=F32_TOL, err_msg=f"d{name}")


def test_backward_runs_the_kernels_plain_version(monkeypatch):
    """The gradient comes from `_bwd` (the Function's backward), not
    from autograd through `_fwd_plain`: the plain backward runs once
    per backward pass, with the forward's saved o and lse."""
    calls = []
    real = tfa._bwd_plain

    def spy(q, k, v, o, lse, do, causal, scale):
        calls.append((tuple(o.shape), tuple(lse.shape), causal, scale))
        return real(q, k, v, o, lse, do, causal, scale)

    monkeypatch.setattr(tfa, "_bwd_plain", spy)
    q, k, v, g = _inputs(3, 40, 4, 2, 32)
    _port_grads(lambda *t: tfa.flash_attention(*t, causal=True), q, k, v,
                g, torch.float32)
    assert calls == [((1, 40, 4, 32), (1, 4, 40), True, 32 ** -0.5)]


def test_flash_attention_still_refuses_cross_length_causal():
    q = torch.zeros((1, 8, 4, 32))
    k = torch.zeros((1, 16, 2, 32))
    with pytest.raises(ValueError, match="equal q/k"):
        tfa.flash_attention(q, k, k, causal=True)


@pytest.mark.parametrize(
    "b,s,h,kv,d",
    [(2, 2048, 32, 8, 128), (1, 2048, 32, 8, 128), (1, 512, 32, 8, 128),
     (1, 77, 32, 8, 128), (2, 200, 8, 4, 64), (2, 1, 8, 1, 64)],
)
def test_bwd_variant_wgmma_for_train_shapes(b, s, h, kv, d):
    """The Llama-3-8B train shapes (32 q / 8 KV heads of 128, causal;
    B=2, S=2048 in `train`) and head_dim 64 take the wgmma backward
    kernels, causal or not."""
    for causal in (True, False):
        assert tfa._bwd_variant(b, s, s, h, kv, d, causal) == "wgmma"


@pytest.mark.parametrize(
    "s_q,s_k,d",
    [(48, 48, 40), (128, 128, 136), (128, 128, 256), (77, 77, 32),
     (1, 300, 128)],
)
def test_bwd_variant_mma_for_other_shapes(s_q, s_k, d):
    """Other head_dims (up to 256) and q_len != k_len stay on the
    mma.sync backward kernels."""
    for causal in (True, False):
        assert tfa._bwd_variant(2, s_q, s_k, 8, 2, d, causal) == "mma"


@pytest.mark.parametrize("d", [64, 136, 256])
def test_cpu_backward_touches_no_backward_counter(d):
    """The plain backward on CPU tensors counts no launch of either
    backward kernel or variant, whichever `_bwd_variant` would pick on
    the card."""
    q, k, v, g = _inputs(5, 24, 4, 2, d)
    _build.reset_launch_counts()
    _port_grads(lambda *t: tfa.flash_attention(*t, causal=True), q, k, v,
                g, torch.float32)
    counts = _build.launch_counts()
    assert all(counts[n] == 0 for n in _build.LAUNCHES["flash_bwd"])
