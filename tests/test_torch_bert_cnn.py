"""The port's BERT encoder (dlrover_tpu_torch/models/bert.py) and CNN
classifier (models/cnn.py) against the JAX package on the same params
(carried across with `params_from_numpy`) and numpy-seeded inputs, in
f32: hidden states, pooled outputs, logits and losses atol 1e-4,
gradients rtol 1e-4 / atol 1e-5.

BERT: an unpadded batch (attention_mask None; the flash kernels
non-causal on the card, their plain versions here) and a padded one
(the mask rides segment_ids through the reference attention), with and
without segments. CNN: an odd image size, so XLA's SAME padding at
stride 2 is asymmetric (the extra row and column at the bottom and
right).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dlrover_tpu.models import bert as jbert
from dlrover_tpu.models import cnn as jcnn
from dlrover_tpu_torch.models import bert as tbert
from dlrover_tpu_torch.models import cnn as tcnn
from dlrover_tpu_torch.parallel.accelerate import Strategy, accelerate

ATOL = 1e-4
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-5


def _jnp(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _leaves(tree, prefix=""):
    out = {}
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            out.update(_leaves(tree[k], prefix + k + "/"))
        else:
            out[prefix + k] = tree[k]
    return out


@pytest.fixture(scope="module")
def bert_model():
    jcfg = jbert.BertConfig.tiny(dtype=jnp.float32)
    tree = jax.tree_util.tree_map(
        np.asarray, jbert.init_params(jcfg, jax.random.PRNGKey(0)))
    # non-zero biases and segment rows, so every term is exercised
    rng = np.random.default_rng(9)
    tree = jax.tree_util.tree_map(
        lambda a: a + 0.02 * rng.standard_normal(a.shape).astype(a.dtype),
        tree)
    tcfg = tbert.BertConfig.tiny(dtype=torch.float32)
    return jcfg, tree, tcfg


def _bert_batch(seed, padded, segments):
    rng = np.random.default_rng(seed)
    b, s = 3, 16
    batch = {"tokens": rng.integers(0, 256, size=(b, s)).astype(np.int32),
             "labels": rng.integers(0, 256, size=(b, s)).astype(np.int32),
             "mlm_mask": (rng.random((b, s)) < 0.3).astype(np.float32)}
    if padded:
        mask = np.ones((b, s), np.int32)
        mask[1, 11:] = 0
        mask[2, 5:] = 0
        batch["attention_mask"] = mask
    if segments:
        batch["segments"] = (np.arange(s)[None] >= 7).astype(
            np.int32).repeat(b, 0)
    return batch


def test_bert_layout_presets_and_num_params(bert_model):
    jcfg, tree, tcfg = bert_model
    for name in ("base", "large", "tiny"):
        jc, tc = getattr(jbert.BertConfig, name)(), getattr(
            tbert.BertConfig, name)()
        for f in ("vocab_size", "dim", "n_layers", "n_heads", "mlp_dim",
                  "max_seq_len", "n_segments", "norm_eps", "attn_impl"):
            assert getattr(tc, f) == getattr(jc, f), (name, f)
        assert tbert.num_params(tc) == jbert.num_params(jc)
    params = tbert.params_from_numpy(tcfg, tree, device="cpu")
    flat = _leaves(tree)
    assert sorted(_leaves(params)) == sorted(flat)
    init = tbert.init_params(tcfg, torch.Generator().manual_seed(0),
                             device="cpu")
    assert {k: tuple(v.shape) for k, v in _leaves(init).items()} == {
        k: v.shape for k, v in flat.items()}


@pytest.mark.parametrize("padded,segments", [(False, False), (True, True),
                                             (False, True)],
                         ids=["unpadded", "padded-segments", "segments"])
def test_bert_apply_pool_and_mlm_loss_match_jax(bert_model, padded,
                                                segments):
    jcfg, tree, tcfg = bert_model
    batch = _bert_batch(1, padded, segments)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    j_hidden = jbert.apply(jcfg, _jnp(tree), jb["tokens"],
                           attention_mask=jb.get("attention_mask"),
                           segments=jb.get("segments"))
    (j_loss, j_m), j_grads = jax.value_and_grad(
        lambda p: jbert.mlm_loss_fn(jcfg, p, jb), has_aux=True)(_jnp(tree))

    params = tbert.params_from_numpy(tcfg, tree, device="cpu")
    for p in _leaves(params).values():
        p.requires_grad_(True)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    hidden = tbert.apply(tcfg, params, tb["tokens"].long(),
                         attention_mask=tb.get("attention_mask"),
                         segments=(tb["segments"].long()
                                   if segments else None))
    np.testing.assert_allclose(hidden.detach().numpy(),
                               np.asarray(j_hidden), atol=ATOL)
    np.testing.assert_allclose(
        tbert.pool(tcfg, params, hidden).detach().numpy(),
        np.asarray(jbert.pool(jcfg, _jnp(tree), j_hidden)), atol=ATOL)
    np.testing.assert_allclose(
        tbert.mlm_logits(tcfg, params, hidden).detach().numpy(),
        np.asarray(jbert.mlm_logits(jcfg, _jnp(tree), j_hidden)),
        atol=ATOL)
    loss, m = tbert.mlm_loss_fn(tcfg, params, tb)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(j_loss), atol=ATOL)
    assert set(m) == set(j_m) == {"loss", "masked_tokens"}
    assert m["masked_tokens"].item() == float(j_m["masked_tokens"])
    jg = _leaves(j_grads)
    for name, p in _leaves(params).items():
        # the pooler is not on the MLM loss: JAX's gradient is zero
        grad = torch.zeros_like(p) if p.grad is None else p.grad
        np.testing.assert_allclose(grad.numpy(), np.asarray(jg[name]),
                                   rtol=GRAD_RTOL, atol=GRAD_ATOL,
                                   err_msg=name)


def test_bert_padding_hides_the_pad_keys(bert_model):
    """A real token's hidden state does not depend on what the pad
    positions hold."""
    _, tree, tcfg = bert_model
    params = tbert.params_from_numpy(tcfg, tree, device="cpu")
    batch = _bert_batch(2, True, False)
    toks = torch.from_numpy(batch["tokens"]).long()
    mask = torch.from_numpy(batch["attention_mask"])
    other = toks.clone()
    other[mask == 0] = 7
    a = tbert.apply(tcfg, params, toks, attention_mask=mask)
    b = tbert.apply(tcfg, params, other, attention_mask=mask)
    real = mask.bool()
    torch.testing.assert_close(a[real], b[real], rtol=0, atol=1e-6)


@pytest.fixture(scope="module")
def cnn_model():
    jcfg = jcnn.CnnConfig.tiny(dtype=jnp.float32, image_size=9,
                               in_channels=3)
    tree = jax.tree_util.tree_map(
        np.asarray, jcnn.init_params(jcfg, jax.random.PRNGKey(0)))
    rng = np.random.default_rng(8)
    tree = {k: v + 0.05 * rng.standard_normal(v.shape).astype(v.dtype)
            for k, v in tree.items()}
    tcfg = tcnn.CnnConfig.tiny(dtype=torch.float32, image_size=9,
                               in_channels=3)
    return jcfg, tree, tcfg


@pytest.mark.parametrize("size", [9, 8], ids=["odd-9", "even-8"])
def test_cnn_apply_loss_and_grads_match_jax(cnn_model, size):
    jcfg, tree, tcfg = cnn_model
    rng = np.random.default_rng(size)
    batch = {"images": rng.standard_normal((4, size, size, 3)).astype(
        np.float32), "labels": rng.integers(0, 10, size=4).astype(np.int32)}
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    j_logits = jcnn.apply(jcfg, _jnp(tree), jb["images"])
    (j_loss, j_m), j_grads = jax.value_and_grad(
        lambda p: jcnn.loss_fn(jcfg, p, jb), has_aux=True)(_jnp(tree))

    params = tcnn.params_from_numpy(tcfg, tree, device="cpu")
    for p in params.values():
        p.requires_grad_(True)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    logits = tcnn.apply(tcfg, params, tb["images"])
    np.testing.assert_allclose(logits.detach().numpy(),
                               np.asarray(j_logits), atol=ATOL)
    loss, m = tcnn.loss_fn(tcfg, params, tb)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(j_loss), atol=ATOL)
    assert m["accuracy"].item() == float(j_m["accuracy"])
    for name, p in params.items():
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(j_grads[name]),
                                   rtol=GRAD_RTOL, atol=GRAD_ATOL,
                                   err_msg=name)


def test_cnn_same_padding_and_presets():
    # XLA SAME at stride 2: 9 -> 5 outputs, 2 padding cells, one each
    # side; 8 -> 4 outputs, 1 padding cell, after
    assert tcnn._same_pad(9, 3, 2) == (1, 1)
    assert tcnn._same_pad(8, 3, 2) == (0, 1)
    assert tcnn._same_pad(28, 3, 1) == (1, 1)
    for name in ("mnist", "tiny"):
        jc, tc = getattr(jcnn.CnnConfig, name)(), getattr(
            tcnn.CnnConfig, name)()
        assert tcnn.num_params(tc) == jcnn.num_params(jc)
        assert tc.channels == jc.channels and tc.image_size == jc.image_size


def test_bert_and_cnn_train_through_accelerate(bert_model, cnn_model):
    """A few AdamW steps of each family through the port's accelerate()
    on the CPU: the loss falls (BERT's `masked_tokens` weighs nothing,
    as in JAX)."""
    _, tree, tcfg = bert_model
    batch = {k: torch.from_numpy(v) for k, v in _bert_batch(
        3, False, False).items()}
    batch["tokens"] = batch["tokens"].long()
    for init, loss_fn, b in (
        (lambda g: tbert.params_from_numpy(tcfg, tree, device="cpu"),
         lambda p, bb: tbert.mlm_loss_fn(tcfg, p, bb), batch),
        (lambda g: tcnn.params_from_numpy(cnn_model[2], cnn_model[1],
                                          device="cpu"),
         lambda p, bb: tcnn.loss_fn(cnn_model[2], p, bb),
         {"images": torch.randn(8, 9, 9, 3,
                                generator=torch.Generator().manual_seed(0)),
          "labels": torch.arange(8) % 10}),
    ):
        acc = accelerate(init, loss_fn,
                         lambda ps: torch.optim.AdamW(ps, lr=1e-2),
                         Strategy(device="cpu"))
        state = acc.init(torch.Generator().manual_seed(0))
        losses = [float(acc.train_step(state, b)[1]["loss"])
                  for _ in range(6)]
        assert losses[-1] < losses[0], losses
