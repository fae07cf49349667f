"""PyTorch port's attention (dlrover_tpu_torch/ops/attention.py and the
flash forward's plain version) against the JAX package on the same
inputs: `reference_attention` against JAX `reference_attention`, and
the flash plain version against JAX `flash_attention` run in Pallas
interpret mode on the CPU (as tests/test_flash_attention.py runs it).

f32 throughout, atol 1e-5: both sides compute the same f32 softmax;
the only differences are summation order (one-pass here, online in
the JAX kernel), which stay near 1e-7 at these sizes."""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dlrover_tpu.ops import attention as jattn
from dlrover_tpu.ops import flash_attention as jfa
from dlrover_tpu_torch.ops import _build
from dlrover_tpu_torch.ops import attention as tattn
from dlrover_tpu_torch.ops import flash_attention as tfa
from dlrover_tpu_torch.ops import paged_attention as tpa

ATOL = 1e-5


def _qkv(seed, b, s_q, s_k, h, kv, d):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, s_q, h, d)).astype(np.float32)
    k = rng.standard_normal((b, s_k, kv, d)).astype(np.float32)
    v = rng.standard_normal((b, s_k, kv, d)).astype(np.float32)
    return q, k, v


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


@pytest.mark.parametrize(
    "b,s_q,s_k,h,kv,d,causal",
    [
        (2, 16, 16, 4, 4, 32, True),     # MHA causal
        (2, 16, 16, 8, 2, 32, True),     # GQA 4:1
        (1, 8, 24, 4, 2, 16, True),      # q_len < k_len: bottom-right
        (2, 1, 20, 4, 1, 32, True),      # single decode query
        (1, 12, 12, 4, 2, 32, False),    # non-causal
    ],
)
def test_reference_attention_matches_jax(b, s_q, s_k, h, kv, d, causal):
    q, k, v = _qkv(0, b, s_q, s_k, h, kv, d)
    want = jattn.reference_attention(*_j(q, k, v), causal=causal)
    got = tattn.reference_attention(*_t(q, k, v), causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_reference_attention_segment_ids_matches_jax():
    q, k, v = _qkv(1, 2, 16, 16, 4, 2, 32)
    seg = np.repeat(np.array([[0, 1, 2, 3], [0, 0, 1, 1]]), 4, axis=1)
    seg = seg.astype(np.int32)
    want = jattn.reference_attention(
        *_j(q, k, v), causal=True, segment_ids=jnp.asarray(seg)
    )
    got = tattn.reference_attention(
        *_t(q, k, v), causal=True, segment_ids=torch.from_numpy(seg)
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


@pytest.mark.parametrize(
    "b,s,h,kv,d,causal",
    [
        (1, 128, 4, 4, 32, True),
        (1, 128, 4, 2, 32, True),    # GQA in the kernel, not repeated
        (2, 128, 2, 1, 64, False),
    ],
)
def test_flash_plain_matches_jax_kernel(b, s, h, kv, d, causal):
    q, k, v = _qkv(2, b, s, s, h, kv, d)
    want = jfa.flash_attention(*_j(q, k, v), causal=causal)
    got = tfa.flash_attention(*_t(q, k, v), causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_flash_plain_lse_matches_jax_kernel():
    """LSE [B, H, S] against the JAX kernel's 8-lane padded LSE."""
    b, s, h, d = 1, 128, 2, 32
    q, k, v = _qkv(3, b, s, s, h, h, d)
    scale = d ** -0.5
    qt, kt, vt = (jnp.asarray(a).transpose(0, 2, 1, 3) for a in (q, k, v))
    _, lse_j = jfa._fwd(qt, kt, vt, True, scale, 128, 128)
    o, lse = tfa._fwd(*_t(q, k, v), True, scale)
    assert lse.shape == (b, h, s) and lse.dtype == torch.float32
    np.testing.assert_allclose(
        lse.numpy(), np.asarray(lse_j)[..., 0], atol=ATOL
    )


def test_flash_single_query_matches_jax_kernel():
    """q_len == 1 runs unmasked (the decode shape)."""
    q, k, v = _qkv(4, 2, 1, 128, 4, 2, 32)
    want = jfa.flash_attention(*_j(q, k, v), causal=True)
    got = tfa.flash_attention(*_t(q, k, v), causal=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_flash_plain_ragged_length_matches_reference():
    """The CUDA kernel takes any length (the JAX kernel needs a >=128
    block dividing it); its plain version equals the reference at a
    prompt-bucket length no such block divides."""
    q, k, v = _qkv(5, 1, 48, 48, 4, 2, 32)
    want = jattn.reference_attention(*_j(q, k, v), causal=True)
    got = tfa.flash_attention(*_t(q, k, v), causal=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_dispatch():
    q, k, v = _t(*_qkv(6, 1, 16, 16, 4, 2, 32))
    ref = tattn.reference_attention(q, k, v)
    # auto on CPU tensors is the reference, bit for bit
    assert torch.equal(tattn.dot_product_attention(q, k, v), ref)
    flash = tattn.dot_product_attention(q, k, v, impl="flash")
    torch.testing.assert_close(flash, ref, atol=ATOL, rtol=0)
    with pytest.raises(ValueError, match="segment_ids"):
        tattn.dot_product_attention(
            q, k, v, impl="flash",
            segment_ids=torch.zeros((1, 16), dtype=torch.int32),
        )
    with pytest.raises(ValueError, match="unknown"):
        tattn.dot_product_attention(q, k, v, impl="nope")
    with pytest.raises(ValueError, match="causal"):
        tfa.flash_attention(q[:, :8], k, v, causal=True)


def _shape(*dims):
    """A stand-in for an array: the JAX gate reads only `.shape`."""
    return types.SimpleNamespace(shape=dims)


@pytest.mark.parametrize("d", [*range(8, 257, 8), 12, 36, 100])
def test_auto_choice_matches_jax_gate(d):
    """impl="auto"'s choice on the card (`takes_flash`) is the JAX
    dispatcher's `fa.supports(...)` shape for shape over the port's
    range: head_dim up to 256, lengths the JAX kernels tile (multiples
    of 128) and the single query, GQA groups whole or not, with and
    without segment_ids. On CPU tensors "auto" is always the
    reference."""
    lengths = [(128, 128), (256, 256), (1, 128), (1, 256), (128, 256),
               (256, 128), (128, 1)]
    heads = [(4, 2), (8, 8), (6, 4), (4, 1)]
    for s_q, s_k in lengths:
        for h, kv in heads:
            for seg in (None, np.zeros((1, s_q), np.int32)):
                qs, ks = (1, s_q, h, d), (1, s_k, kv, d)
                want = jfa.supports(_shape(*qs), _shape(*ks), seg)
                got = tattn.takes_flash(qs, ks, seg, "cuda")
                assert got == want, (qs, ks, seg is not None)
                assert not tattn.takes_flash(qs, ks, seg, "cpu")
                assert not tattn.takes_flash(qs, ks, seg,
                                             torch.device("cpu"))


def test_auto_choice_differs_from_jax_only_where_documented():
    """Outside that range the port's choice differs from the JAX gate
    in two known ways: its kernels take any length (they mask the
    ragged tile; JAX needs a block of >= 128 dividing S), and it sends
    head_dim 264-512 to the reference (JAX's kernels take them; queued
    in ROADMAP)."""
    for s in (48, 77, 200):
        qs, ks = (1, s, 4, 64), (1, s, 2, 64)
        assert tattn.takes_flash(qs, ks, None, "cuda")
        assert not jfa.supports(_shape(*qs), _shape(*ks))
    for d in (264, 384, 512):
        qs, ks = (1, 128, 4, d), (1, 128, 2, d)
        assert not tattn.takes_flash(qs, ks, None, "cuda")
        assert jfa.supports(_shape(*qs), _shape(*ks))


def test_supports_gate():
    def sup(d, s_q=16, s_k=16, h=4, kv=2):
        return tfa.supports(
            torch.empty((1, s_q, h, d)), torch.empty((1, s_k, kv, d))
        )

    assert sup(32) and sup(128) and sup(256) and sup(40)
    assert not sup(16) and not sup(264) and not sup(36)
    assert sup(64, s_q=1, s_k=77)
    assert not sup(64, s_q=8, s_k=16)
    assert not sup(64, h=6, kv=4)
    assert not tfa.supports(
        torch.empty((1, 16, 4, 32)), torch.empty((1, 16, 2, 32)),
        segment_ids=torch.zeros((1, 16)),
    )


def test_cpu_tensors_never_touch_launch_counter():
    _build.reset_launch_counts()
    q, k, v = _t(*_qkv(7, 1, 16, 16, 4, 2, 32))
    tfa.flash_attention(q, k, v)
    tattn.dot_product_attention(q, k, v, impl="flash")
    rng = np.random.default_rng(0)
    pages = {
        n: torch.from_numpy(
            rng.standard_normal((5, 8, 2, 32)).astype(np.float32)
        )
        for n in ("k", "v")
    }
    q1 = torch.from_numpy(rng.standard_normal((2, 4, 32)).astype(np.float32))
    table = torch.tensor([[1, 2], [3, 4]], dtype=torch.int32)
    lengths = torch.tensor([9, 16], dtype=torch.int32)
    tpa.paged_attention(q1, pages, table, lengths, impl="kernel")
    counts = _build.launch_counts()
    assert counts["flash_fwd"] == 0 and counts["paged_attention"] == 0
    assert set(counts.values()) == {0}


@pytest.mark.parametrize(
    "b,s,h,kv,d",
    [(1, 77, 32, 8, 128), (1, 512, 32, 8, 128), (1, 2048, 32, 8, 128),
     (2, 2048, 32, 8, 128), (1, 300, 8, 2, 64), (2, 1, 4, 4, 64)],
)
def test_fwd_variant_wgmma_for_prefill_and_train_shapes(b, s, h, kv, d):
    """The Llama-3-8B serve-prefill and train shapes (32 q / 8 KV heads
    of 128, causal) and head_dim 64 take the wgmma forward, causal or
    not."""
    for causal in (True, False):
        assert tfa._fwd_variant(b, s, s, h, kv, d, causal) == "wgmma"


@pytest.mark.parametrize(
    "s_q,s_k,d,causal",
    [(48, 48, 40, True), (130, 130, 256, True), (77, 77, 32, False),
     (1, 300, 128, False), (1, 77, 64, False)],
)
def test_fwd_variant_mma_for_other_shapes(s_q, s_k, d, causal):
    """Other head_dims and the single-query decode shape stay on the
    mma.sync forward."""
    assert tfa._fwd_variant(2, s_q, s_k, 8, 2, d, causal) == "mma"


@pytest.mark.parametrize("d", [40, 64, 128, 256])
def test_cpu_forward_touches_neither_flash_counter(d):
    """The plain forward on CPU tensors counts no launch of either
    variant, whichever `_fwd_variant` would pick on the card."""
    _build.reset_launch_counts()
    q, k, v = _t(*_qkv(8, 1, 20, 20, 4, 2, d))
    o, lse = tfa._fwd(q, k, v, True, d ** -0.5)
    tfa.flash_attention(q[:, :1], k, v)
    counts = _build.launch_counts()
    assert counts["flash_fwd"] == 0 and counts["flash_fwd_wgmma"] == 0
    assert o.shape == q.shape and lse.shape == (1, 4, 20)
