"""The port's two sharded kernel sites (dlrover_tpu_torch/ops:
`flash_attention.sharded_flash_attention`, `paged_attention.
_sharded_kernel` / `paged_attention(..., mesh=)`) against the JAX
package's shard_mapped ones (`sharded_flash_attention`,
`_sharded_kernel`), the JAX side run as tests/test_kernel_shard_map.py
runs it: DLROVER_TPU_FORCE_KERNELS=1 (the Pallas kernels in interpret
mode) on `serving_mesh(2, n_kv_heads=2)` over the conftest's forced
host devices. The port's slice is a `ServingMesh` of two CPU shards;
on CPU tensors each shard runs the kernel's plain version.

- Port sharded == port unsharded, byte for byte: flash in f32, paged
  with bf16 and int8 pools (bf16 queries): attention is per head, and
  each shard computes its heads as the unsharded call does. An f32
  paged pool is held at 1e-6: the CPU's batched product over (row, KV
  head) pairs sums a row in another order when that batch halves
  (7e-7 measured), which bf16 outputs do not show.
- Port against JAX: f32 atol 1e-5 (flash, paged f32 pool), int8 pool
  1e-4 — the tolerances tests/test_torch_attention.py and
  tests/test_torch_paged_attention.py hold the unsharded sites to.
- The auto dispatch at tp=2 and the per-shard gates (`supports(...,
  tp=)`) against JAX's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dlrover_tpu.ops import attention as jattn
from dlrover_tpu.ops import flash_attention as jfa
from dlrover_tpu.ops import paged_attention as jpa
from dlrover_tpu.parallel.mesh import serving_mesh as jserving_mesh
from dlrover_tpu_torch.ops import attention as tattn
from dlrover_tpu_torch.ops import flash_attention as tfa
from dlrover_tpu_torch.ops import paged_attention as tpa
from dlrover_tpu_torch.parallel.mesh import (
    SERVING_TP_AXIS,
    ServingMesh,
    serving_head_specs,
    serving_mesh,
)

ATOL = 1e-5
ATOL_INT8 = 1e-4
CPU = torch.device("cpu")


@pytest.fixture
def forced(monkeypatch):
    monkeypatch.setenv("DLROVER_TPU_FORCE_KERNELS", "1")


@pytest.fixture(scope="module")
def jmesh():
    if len(jax.devices()) < 2:
        pytest.skip("the JAX side needs >= 2 (forced host) devices")
    return jserving_mesh(2, n_kv_heads=2)


@pytest.fixture(scope="module")
def tmesh():
    return serving_mesh(2, devices=[CPU, CPU], n_kv_heads=2)


def _flash_qkv(seed=0, b=2, s=128, h=4, kv=2, d=64):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, s, h, d)).astype(np.float32),
            rng.standard_normal((b, s, kv, d)).astype(np.float32),
            rng.standard_normal((b, s, kv, d)).astype(np.float32))


def _paged_case(seed=0, b=2, h=4, kv=2, d=64, n_pages=9, ps=16, p=4,
                quant=False):
    rng = np.random.default_rng(seed)
    if quant:
        pool = {
            "k": rng.integers(-127, 127, (n_pages, ps, kv, d)).astype(np.int8),
            "v": rng.integers(-127, 127, (n_pages, ps, kv, d)).astype(np.int8),
            "k_scale": (rng.random((n_pages, ps, kv, 1)) * 0.02).astype(
                np.float32),
            "v_scale": (rng.random((n_pages, ps, kv, 1)) * 0.02).astype(
                np.float32),
        }
    else:
        pool = {
            "k": rng.standard_normal((n_pages, ps, kv, d)).astype(np.float32),
            "v": rng.standard_normal((n_pages, ps, kv, d)).astype(np.float32),
        }
    table = rng.integers(1, n_pages, (b, p)).astype(np.int32)
    lengths = rng.integers(1, p * ps, size=b).astype(np.int32)
    q = rng.standard_normal((b, h, d)).astype(np.float32)
    return q, pool, table, lengths


def _tpool(pool):
    return {n: torch.from_numpy(a).to(torch.bfloat16) if n.endswith("_scale")
            else torch.from_numpy(a) for n, a in pool.items()}


def _jpool(pool):
    return {n: jnp.asarray(a).astype(jnp.bfloat16) if n.endswith("_scale")
            else jnp.asarray(a) for n, a in pool.items()}


def _cat(parts, dim):
    return torch.cat(list(parts), dim).numpy()


# ---------------------------------------------------------------------------
# flash: kernel 1 per head shard


class TestShardedFlash:
    @pytest.mark.parametrize("causal", [True, False])
    def test_sharded_equals_unsharded_bytes(self, tmesh, causal):
        q, k, v = (torch.from_numpy(a) for a in _flash_qkv(seed=1))
        whole = tfa.flash_attention(q, k, v, causal=causal)
        parts = tfa.sharded_flash_attention(q, k, v, tmesh, causal=causal)
        assert len(parts) == 2
        assert parts[0].shape == (2, 128, 2, 64)
        np.testing.assert_array_equal(_cat(parts, 2), whole.numpy())

    def test_per_shard_lists_in_lists_out(self, tmesh):
        q, k, v = (torch.from_numpy(a) for a in _flash_qkv(seed=4))
        split = [tmesh.split(x, 2) for x in (q, k, v)]
        parts = tfa.sharded_flash_attention(*split, tmesh)
        np.testing.assert_array_equal(
            _cat(parts, 2), tfa.flash_attention(q, k, v).numpy())

    def test_matches_jax_sharded(self, forced, jmesh, tmesh):
        q, k, v = _flash_qkv(seed=2)
        want = jfa.sharded_flash_attention(
            *(jnp.asarray(a) for a in (q, k, v)), jmesh, causal=True)
        got = tfa.sharded_flash_attention(
            *(torch.from_numpy(a) for a in (q, k, v)), tmesh, causal=True)
        np.testing.assert_allclose(_cat(got, 2), np.asarray(want), atol=ATOL)

    def test_dpa_auto_tp2_matches_jax(self, forced, jmesh, tmesh):
        """JAX's forced auto takes its shard_mapped kernel; the port's
        auto on CPU tensors runs the reference per shard. Same
        function, global tensors in and out on both sides."""
        q, k, v = _flash_qkv(seed=3)
        want = jattn.dot_product_attention(
            *(jnp.asarray(a) for a in (q, k, v)), causal=True, impl="auto",
            tp=2, mesh=jmesh)
        got = tattn.dot_product_attention(
            *(torch.from_numpy(a) for a in (q, k, v)), causal=True,
            impl="auto", tp=2, mesh=tmesh)
        assert torch.is_tensor(got) and got.shape == (2, 128, 4, 64)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
        # per-shard lists in: per-shard list out, the same values
        parts = tattn.dot_product_attention(
            *[tmesh.split(torch.from_numpy(a), 2) for a in (q, k, v)],
            causal=True, tp=2, mesh=tmesh)
        np.testing.assert_array_equal(_cat(parts, 2), got.numpy())

    def test_dpa_flash_impl_routes_the_sharded_site(self, tmesh,
                                                    monkeypatch):
        q, k, v = (torch.from_numpy(a) for a in _flash_qkv(seed=5))
        routed = []
        real = tfa.sharded_flash_attention
        monkeypatch.setattr(tfa, "sharded_flash_attention",
                            lambda *a, **kw: routed.append(1) or real(*a, **kw))
        out = tattn.dot_product_attention(q, k, v, impl="flash", tp=2,
                                          mesh=tmesh)
        assert routed
        np.testing.assert_array_equal(
            out.numpy(), tfa.flash_attention(q, k, v).numpy())

    def test_tp_without_mesh_stays_reference(self, forced):
        """JAX's auto at tp > 1 without a mesh keeps the reference; so
        does the port's."""
        q, k, v = _flash_qkv(seed=6)
        want = jattn.dot_product_attention(
            *(jnp.asarray(a) for a in (q, k, v)), impl="auto", tp=2)
        got = tattn.dot_product_attention(
            *(torch.from_numpy(a) for a in (q, k, v)), impl="auto", tp=2)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


# ---------------------------------------------------------------------------
# paged: kernel 4 per head shard


def _bf16(q, pool):
    """bf16 queries, and a bf16 pool unless it is int8."""
    tpool = _tpool(pool)
    if tpool["k"].dtype == torch.float32:
        tpool = {n: t.to(torch.bfloat16) for n, t in tpool.items()}
    return torch.from_numpy(q).to(torch.bfloat16), tpool


class TestShardedPaged:
    @pytest.mark.parametrize("seed", [7, 17, 27])
    @pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
    def test_sharded_equals_unsharded_bytes(self, tmesh, quant, seed):
        q, pool, table, lengths = _paged_case(seed=seed, quant=quant)
        q, pool = _bf16(q, pool)
        args = (torch.from_numpy(table), torch.from_numpy(lengths))
        whole = tpa.paged_attention(q, pool, *args, impl="kernel")
        parts = tpa._sharded_kernel(q, pool, *args, 64 ** -0.5, tmesh)
        assert [p.shape for p in parts] == [(2, 2, 64)] * 2
        assert torch.equal(torch.cat(parts, 1), whole)
        for impl in ("kernel", "reference", "auto"):
            got = tpa.paged_attention(q, pool, *args, impl=impl, mesh=tmesh)
            assert torch.equal(got, whole), impl

    def test_f32_pool_sharded_close_to_unsharded(self, tmesh):
        q, pool, table, lengths = _paged_case(seed=7)
        args = (torch.from_numpy(table), torch.from_numpy(lengths))
        whole = tpa.paged_attention(torch.from_numpy(q), _tpool(pool), *args,
                                    impl="kernel")
        got = tpa.paged_attention(torch.from_numpy(q), _tpool(pool), *args,
                                  impl="kernel", mesh=tmesh)
        np.testing.assert_allclose(got.numpy(), whole.numpy(), atol=1e-6)

    @pytest.mark.parametrize("quant", [False, True], ids=["f32", "int8"])
    def test_matches_jax_sharded(self, forced, jmesh, tmesh, quant):
        q, pool, table, lengths = _paged_case(seed=8, quant=quant)
        want = jpa._sharded_kernel(
            jnp.asarray(q), _jpool(pool), jnp.asarray(table),
            jnp.asarray(lengths), 64 ** -0.5, jmesh)
        got = tpa._sharded_kernel(
            torch.from_numpy(q), _tpool(pool), torch.from_numpy(table),
            torch.from_numpy(lengths), 64 ** -0.5, tmesh)
        np.testing.assert_allclose(_cat(got, 1), np.asarray(want),
                                   atol=ATOL_INT8 if quant else ATOL)

    def test_auto_tp2_matches_jax(self, forced, jmesh, tmesh):
        q, pool, table, lengths = _paged_case(seed=9)
        want = jpa.paged_attention(
            jnp.asarray(q), _jpool(pool), jnp.asarray(table),
            jnp.asarray(lengths), impl="auto", mesh=jmesh)
        got = tpa.paged_attention(
            torch.from_numpy(q), _tpool(pool), torch.from_numpy(table),
            torch.from_numpy(lengths), impl="auto", mesh=tmesh)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


# ---------------------------------------------------------------------------
# gates and layouts


GATE_FLASH = [  # b, s_q, s_k, h, kv, d
    (2, 128, 128, 4, 2, 64), (2, 128, 128, 8, 4, 64),
    (1, 256, 256, 32, 8, 128), (2, 128, 128, 4, 2, 16),
    (2, 1, 128, 4, 2, 64), (2, 128, 128, 6, 3, 64),
]
GATE_PAGED = [  # b, h, kv, d, page_size
    (2, 4, 2, 64, 16), (2, 8, 4, 64, 8), (8, 32, 8, 128, 16),
    (2, 4, 2, 16, 16), (2, 4, 2, 64, 4), (2, 6, 3, 64, 16),
]


@pytest.mark.parametrize("tp", [1, 2, 4])
@pytest.mark.parametrize("case", GATE_FLASH)
def test_flash_gate_per_shard_equals_jax(case, tp):
    b, s_q, s_k, h, kv, d = case
    jq = jax.ShapeDtypeStruct((b, s_q, h, d), jnp.float32)
    jk = jax.ShapeDtypeStruct((b, s_k, kv, d), jnp.float32)
    want = jfa.supports(jq, jk, tp=tp)
    got = tfa.supports_shapes((b, s_q, h, d), (b, s_k, kv, d), tp=tp)
    assert got == want
    assert tattn.takes_flash((b, s_q, h, d), (b, s_k, kv, d), None, "cuda",
                             tp) == want
    assert not tattn.takes_flash((b, s_q, h, d), (b, s_k, kv, d), None,
                                 "cpu", tp)
    assert tfa.per_shard_heads(h, kv, tp) == jfa.per_shard_heads(h, kv, tp)


@pytest.mark.parametrize("tp", [1, 2, 4])
@pytest.mark.parametrize("case", GATE_PAGED)
def test_paged_gate_per_shard_equals_jax(case, tp, forced):
    b, h, kv, d, ps = case
    jq = jax.ShapeDtypeStruct((b, h, d), jnp.float32)
    jpages = {n: jax.ShapeDtypeStruct((9, ps, kv, d), jnp.float32)
              for n in ("k", "v")}
    table = np.zeros((b, 4), np.int32)
    want = jpa.supports(jq, jpages, table, tp=tp)
    assert jpa.use_kernel(jq, jpages, table, tp=tp) == want
    tq = torch.zeros((b, h, d))
    tpages = {n: torch.zeros((9, ps, kv, d)) for n in ("k", "v")}
    ttable = torch.zeros((b, 4), dtype=torch.int32)
    assert tpa.supports(tq, tpages, ttable, tp=tp) == want
    assert tpa.takes_kernel((b, h, d), (9, ps, kv, d), (b, 4), "cuda",
                            tp=tp) == want
    # CPU tensors always take the plain version, whatever the gate says
    assert not tpa.use_kernel(tq, tpages, ttable, tp=tp)


def test_head_specs_equal_jax(jmesh, tmesh):
    from dlrover_tpu.parallel.mesh import serving_head_specs as jspecs

    want = {k: tuple(v) for k, v in jspecs(jmesh).items()}
    got = {k: tuple(v) for k, v in serving_head_specs(tmesh).items()}
    assert got == want
    assert serving_head_specs(tmesh)["qkv"].split_dim() == 2
    assert serving_head_specs(tmesh)["q1"].split_dim() == 1
    assert serving_head_specs(tmesh)["pool"].split_dim() == 2
    assert serving_head_specs(tmesh)["replicated"].split_dim() is None
    assert tmesh.axis_names == (SERVING_TP_AXIS,)


def test_head_specs_need_a_tp_axis():
    class NoAxis:
        axis_names = ("data",)

    with pytest.raises(ValueError, match="'tp' axis"):
        serving_head_specs(NoAxis())


def test_mesh_moves_are_noops_on_one_device(tmesh):
    t = torch.arange(24.0).reshape(2, 3, 4)
    copies = tmesh.broadcast(t)
    assert copies[0] is t and copies[1] is t
    assert tmesh.colocated and tmesh.home == CPU
    parts = tmesh.split(t, 2)
    assert all(p.is_contiguous() for p in parts)
    assert torch.equal(tmesh.gather(parts, 2), t)
    with pytest.raises(ValueError, match="does not split"):
        ServingMesh([CPU] * 3).split(t, 2)
