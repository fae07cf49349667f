"""The port's fused cross entropy (dlrover_tpu_torch/ops/fused_ce.py)
against the JAX `fused_cross_entropy` on the same numpy inputs (made
from a seed): the loss sum, the weight, dx and dhead, and
`llama.loss_fn(fused_ce=True)` against JAX's and against the port's own
unfused loss.

Tolerances, each relative to the largest |value| of the tensor compared:
- f32 inputs: 1e-5 for the loss and 2e-5 for dx and dhead (the same f32
  arithmetic, sums in another order).
- bf16 inputs: 1e-5 for the loss (both sides multiply the same bf16
  values into f32); 2^-7 for dx, which both sides round to bf16 (an
  element near a rounding boundary may round the other way); 2^-7 for
  dhead, whose dlogits the port rounds to bf16 (2^-9 relative) before
  the product where JAX keeps them in f32, and which both sides round to
  bf16 on return.
- loss_fn (tiny Llama, f32 compute): 1e-4 for the loss and the
  gradients, as tests/test_torch_train.py holds the unfused loss.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dlrover_tpu.models import llama as jllama
from dlrover_tpu.ops import fused_ce as jfce
from dlrover_tpu_torch.models import llama as tllama
from dlrover_tpu_torch.ops import fused_ce as tfce

F32_LOSS, F32_GRAD = 1e-5, 2e-5
BF16_LOSS, BF16_GRAD = 1e-5, 2 ** -7
MODEL_REL = 1e-4
# the cotangent of the loss sum: a mean over the weight, times a factor
# that is not 1 so the scaling by g is exercised
G_SCALE = 0.37


def _close(got, want, rel, what):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= rel * scale, f"{what}: max err {err} > {rel} x {scale}"


def _inputs(seed, b, s, d, v, masked):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((b, s, d)) * 2).astype(np.float32)
    head = (rng.standard_normal((d, v)) * 0.3).astype(np.float32)
    targets = rng.integers(0, v, size=(b, s)).astype(np.int32)
    mask = ((rng.random((b, s)) > 0.3).astype(np.float32)
            if masked else None)
    return x, head, targets, mask


def _jax(x, head, targets, mask, nc, dtype):
    jdt = {"f32": jnp.float32, "bf16": jnp.bfloat16}[dtype]
    jm = None if mask is None else jnp.asarray(mask)

    def f(x, h):
        ls, w = jfce.fused_cross_entropy(x, h, jnp.asarray(targets), jm, nc)
        return ls * (G_SCALE / jnp.maximum(w, 1.0)), (ls, w)

    (_, (ls, w)), (dx, dh) = jax.value_and_grad(
        f, argnums=(0, 1), has_aux=True)(
        jnp.asarray(x).astype(jdt), jnp.asarray(head).astype(jdt))
    return ls, w, dx, dh


def _port(x, head, targets, mask, nc, dtype):
    tdt = {"f32": torch.float32, "bf16": torch.bfloat16}[dtype]
    tx = torch.from_numpy(x).to(tdt).requires_grad_(True)
    th = torch.from_numpy(head).to(tdt).requires_grad_(True)
    tm = None if mask is None else torch.from_numpy(mask)
    ls, w = tfce.fused_cross_entropy(tx, th, torch.from_numpy(targets), tm,
                                     nc)
    assert ls.dtype == w.dtype == torch.float32 and not w.requires_grad
    (ls * (G_SCALE / w.clamp_min(1.0))).backward()
    assert tx.grad.dtype == th.grad.dtype == tdt
    return ls, w, tx.grad, th.grad


def _np(t):
    return t.detach().float().numpy()


@pytest.mark.parametrize("s", [1, 33, 64, 97, 257, 2047])
@pytest.mark.parametrize("nc", [0, 4])
def test_layout_matches_jax(s, nc):
    assert tfce._chunk_count(s) == jfce._chunk_count(s)
    assert tfce._layout(s, nc) == jfce._layout(s, nc)
    spans = tfce._spans(s, nc)
    assert spans[0][0] == 0 and spans[-1][1] == s
    assert all(a[1] == b[0] for a, b in zip(spans, spans[1:]))
    assert tfce._layout(2047, 0) == (7, 292, 3)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("s,nc", [(64, 4), (33, 4), (97, 0), (515, 0)],
                         ids=["4x16", "4x8+1", "auto-1x97", "auto-2x257+1"])
def test_matches_jax_loss_dx_dhead(s, nc, masked, dtype):
    """Masked and unmasked, lengths that the chunks divide and lengths
    with a tail (JAX `_layout`: 33 with 4 chunks is 4 x 8 + 1; 515 auto
    is 2 x 257 + 1)."""
    x, head, targets, mask = _inputs(s * 7 + nc, 2, s, 16, 53, masked)
    j_ls, j_w, j_dx, j_dh = _jax(x, head, targets, mask, nc, dtype)
    t_ls, t_w, t_dx, t_dh = _port(x, head, targets, mask, nc, dtype)
    loss_rel, grad_rel = ((F32_LOSS, F32_GRAD) if dtype == "f32"
                          else (BF16_LOSS, BF16_GRAD))
    assert float(t_w) == float(j_w)
    _close(_np(t_ls), j_ls, loss_rel, "loss sum")
    _close(_np(t_dx), j_dx, grad_rel, "dx")
    _close(_np(t_dh), j_dh, grad_rel, "dhead")


@pytest.mark.parametrize("b,s,nc", [(2, 2047, 0), (1, 2047, 6)],
                         ids=["auto-7x292+3", "6x341+1"])
def test_next_token_lengths_with_a_tail(b, s, nc):
    """The train path's S - 1 = 2047 (7 x 292 + 3, the auto layout) and
    6 chunks of it (6 x 341 + 1), masked."""
    x, head, targets, mask = _inputs(s, b, s, 8, 31, True)
    assert tfce._layout(s, nc)[2] > 0
    j_ls, j_w, j_dx, j_dh = _jax(x, head, targets, mask, nc, "f32")
    t_ls, t_w, t_dx, t_dh = _port(x, head, targets, mask, nc, "f32")
    assert float(t_w) == float(j_w)
    _close(_np(t_ls), j_ls, F32_LOSS, "loss sum")
    _close(_np(t_dx), j_dx, F32_GRAD, "dx")
    _close(_np(t_dh), j_dh, F32_GRAD, "dhead")


def test_no_gradient_for_targets_mask_or_weight():
    x, head, targets, mask = _inputs(3, 2, 40, 8, 17, True)
    tm = torch.from_numpy(mask).requires_grad_(True)
    tx = torch.from_numpy(x).requires_grad_(True)
    th = torch.from_numpy(head).requires_grad_(True)
    ls, w = tfce.fused_cross_entropy(tx, th, torch.from_numpy(targets), tm)
    ls.backward()
    assert tm.grad is None and not w.requires_grad
    with pytest.raises(ValueError, match="head is"):
        tfce.fused_cross_entropy(tx, th.bfloat16(), torch.from_numpy(targets))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_tied_head_gets_its_gradient_through_the_embedding(dtype):
    """head = embed^T (a transposed view): dhead reaches the embedding,
    as JAX's gradient through `embed.T` does."""
    rng = np.random.default_rng(11)
    v, d, b, s = 29, 8, 2, 45
    emb = (rng.standard_normal((v, d)) * 0.5).astype(np.float32)
    x, _, targets, mask = _inputs(12, b, s, d, v, True)
    jdt = {"f32": jnp.float32, "bf16": jnp.bfloat16}[dtype]
    tdt = {"f32": torch.float32, "bf16": torch.bfloat16}[dtype]

    def jf(e):
        ls, w = jfce.fused_cross_entropy(
            jnp.asarray(x).astype(jdt), e.astype(jdt).T,
            jnp.asarray(targets), jnp.asarray(mask))
        return ls / jnp.maximum(w, 1.0)

    j_loss, j_demb = jax.value_and_grad(jf)(jnp.asarray(emb))
    te = torch.from_numpy(emb).requires_grad_(True)
    ls, w = tfce.fused_cross_entropy(
        torch.from_numpy(x).to(tdt), te.to(tdt).T, torch.from_numpy(targets),
        torch.from_numpy(mask))
    (ls / w.clamp_min(1.0)).backward()
    rel = F32_GRAD if dtype == "f32" else BF16_GRAD
    _close(_np(ls / w.clamp_min(1.0)), j_loss, F32_LOSS, "loss")
    _close(_np(te.grad), j_demb, rel, "d embed")
    assert float(te.grad.abs().sum()) > 0


def _tiny(tied, fused, dtype=torch.float32):
    return tllama.LlamaConfig.tiny(dtype=dtype, fused_ce=fused,
                                   tie_embeddings=tied)


def _leaves(tree, prefix=""):
    out = {}
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            out.update(_leaves(tree[k], prefix + k + "/"))
        else:
            out[prefix + k] = tree[k]
    return out


@pytest.mark.parametrize("tied", [False, True], ids=["untied", "tied"])
@pytest.mark.parametrize("masked", [False, True])
def test_loss_fn_fused_matches_jax_and_the_unfused_loss(tied, masked):
    """loss_fn(fused_ce=True) on a tiny Llama (f32 compute, S - 1 = 32)
    against the JAX fused loss_fn on the same params and tokens, and
    against the port's unfused loss_fn."""
    jcfg = jllama.LlamaConfig.tiny(dtype=jnp.float32, fused_ce=True,
                                   tie_embeddings=tied)
    tree = jax.tree_util.tree_map(
        np.asarray, jllama.init_params(jcfg, jax.random.PRNGKey(3)))
    rng = np.random.default_rng(5)
    batch = {"tokens": rng.integers(0, 256, size=(2, 33)).astype(np.int32)}
    if masked:
        m = (rng.random((2, 33)) < 0.7).astype(np.float32)
        m[0, :10] = 0.0
        batch["loss_mask"] = m
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (j_loss, j_m), j_grads = jax.value_and_grad(
        lambda p: jllama.loss_fn(jcfg, p, jb), has_aux=True)(
        jax.tree_util.tree_map(jnp.asarray, tree))
    tb = {k: torch.from_numpy(v).long() if k == "tokens"
          else torch.from_numpy(v) for k, v in batch.items()}
    results = {}
    for fused in (True, False):
        params = tllama.params_from_numpy(_tiny(tied, fused), tree,
                                          device="cpu", dtype=torch.float32)
        for p in _leaves(params).values():
            p.requires_grad_(True)
        loss, m = tllama.loss_fn(_tiny(tied, fused), params, tb)
        loss.backward()
        results[fused] = (loss, m, {k: p.grad for k, p in
                                    _leaves(params).items()})
    loss, m, grads = results[True]
    assert float(m["loss_weight"]) == float(j_m["loss_weight"])
    _close(_np(loss), j_loss, MODEL_REL, "loss vs JAX")
    j_leaves = _leaves(j_grads)
    assert sorted(grads) == sorted(j_leaves)
    for name, g in grads.items():
        _close(_np(g), j_leaves[name], MODEL_REL, f"d{name} vs JAX")
    u_loss, u_m, u_grads = results[False]
    assert float(u_m["loss_weight"]) == float(m["loss_weight"])
    _close(_np(loss), _np(u_loss), MODEL_REL, "loss vs unfused")
    for name, g in grads.items():
        _close(_np(g), _np(u_grads[name]), MODEL_REL, f"d{name} vs unfused")


def test_loss_fn_fused_bf16_matches_the_unfused_loss():
    """bf16 compute: the fused loss and the unfused one on the same
    params, within the bf16 model tolerances of test_torch_train.py
    (2^-5 for the loss, 2^-4 for the gradients: the unfused path rounds
    the logits to bf16 before its f32 softmax, the fused one keeps them
    f32)."""
    cfg = _tiny(False, True, torch.bfloat16)
    params = tllama.init_params(cfg, torch.Generator().manual_seed(0),
                                device="cpu", dtype=torch.float32)
    tokens = torch.from_numpy(
        np.random.default_rng(9).integers(0, 256, size=(2, 65))).long()
    out = {}
    for fused in (True, False):
        p = {k: ({kk: vv.detach().clone().requires_grad_(True)
                  for kk, vv in v.items()}) for k, v in params.items()}
        loss, _ = tllama.loss_fn(dataclasses.replace(cfg, fused_ce=fused), p,
                                 {"tokens": tokens})
        loss.backward()
        out[fused] = (loss, {k: t.grad for k, t in _leaves(p).items()})
    _close(_np(out[True][0]), _np(out[False][0]), 2 ** -5, "loss")
    for name, g in out[True][1].items():
        _close(_np(g), _np(out[False][1][name]), 2 ** -4, f"d{name}")
