"""PyTorch port's paged attention (dlrover_tpu_torch/ops/
paged_attention.py) against the JAX package's, on the same pools,
tables and lengths: the port's plain version (the dense-bank
formulation over gathered pages, which is also what `impl="kernel"`
runs for CPU tensors) against JAX `paged_attention` with
impl="kernel" (Pallas interpret mode on the CPU, as
tests/test_paged_attention.py runs it) and impl="reference".

Tolerances: f32 pools 1e-5 (same f32 math, other summation order);
int8 pools 1e-4 (the JAX kernel keeps P in f32 where the reference
casts it, and the dequantized values are ~127x larger quanta)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dlrover_tpu.ops import paged_attention as jpa
from dlrover_tpu_torch.ops import paged_attention as tpa


def _case(seed, b, h, kv, hd, page_size, n_pages, per_row, quant):
    """numpy pool / table / lengths. Tables mix live pages, dead pages
    past the length and trash (page 0) entries; lengths end mid-page."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, h, hd)).astype(np.float32)
    k = rng.standard_normal((n_pages, page_size, kv, hd)).astype(np.float32)
    v = rng.standard_normal((n_pages, page_size, kv, hd)).astype(np.float32)
    if quant:
        ks = np.abs(k).max(-1, keepdims=True) / 127.0
        vs = np.abs(v).max(-1, keepdims=True) / 127.0
        # scales as the bf16 values both sides will hold
        ks = np.array(jnp.asarray(ks).astype(jnp.bfloat16).astype(jnp.float32))
        vs = np.array(jnp.asarray(vs).astype(jnp.bfloat16).astype(jnp.float32))
        pool = {
            "k": np.clip(np.round(k / ks), -127, 127).astype(np.int8),
            "v": np.clip(np.round(v / vs), -127, 127).astype(np.int8),
            "k_scale": ks, "v_scale": vs,
        }
    else:
        pool = {"k": k, "v": v}
    table = np.zeros((b, per_row), np.int32)
    lengths = np.zeros(b, np.int32)
    for row in range(b):
        n_live = int(rng.integers(1, per_row + 1))
        table[row, :n_live] = rng.choice(
            np.arange(1, n_pages), size=n_live, replace=False
        )
        # dead tail: stale real pages on some rows, trash on others
        if row % 2:
            table[row, n_live:] = rng.integers(1, n_pages, per_row - n_live)
        lengths[row] = (n_live - 1) * page_size + int(
            rng.integers(1, page_size + 1)
        )
    return q, pool, table, lengths


def _jax(q, pool, table, lengths, impl):
    jpool = {
        n: jnp.asarray(a).astype(jnp.bfloat16) if n.endswith("_scale")
        else jnp.asarray(a)
        for n, a in pool.items()
    }
    out = jpa.paged_attention(
        jnp.asarray(q), jpool, jnp.asarray(table), jnp.asarray(lengths),
        impl=impl,
    )
    return np.asarray(out)


def _torch(q, pool, table, lengths, impl):
    tpool = {
        n: torch.from_numpy(a).to(torch.bfloat16) if n.endswith("_scale")
        else torch.from_numpy(a)
        for n, a in pool.items()
    }
    out = tpa.paged_attention(
        torch.from_numpy(q), tpool, torch.from_numpy(table),
        torch.from_numpy(lengths), impl=impl,
    )
    return out.numpy()


CASES = [
    # b, h, kv, hd, page_size, n_pages, per_row
    (3, 4, 2, 32, 16, 12, 4),   # GQA 2:1, page 16
    (4, 8, 2, 32, 8, 20, 5),    # GQA 4:1, page 8
    (2, 4, 4, 64, 8, 9, 3),     # MHA
]


@pytest.mark.parametrize("quant", [False, True], ids=["f32", "int8"])
@pytest.mark.parametrize("case", CASES, ids=["gqa2_p16", "gqa4_p8", "mha_p8"])
@pytest.mark.parametrize("jax_impl", ["kernel", "reference"])
def test_matches_jax(case, quant, jax_impl):
    q, pool, table, lengths = _case(11, *case, quant=quant)
    want = _jax(q, pool, table, lengths, jax_impl)
    atol = 1e-4 if quant else 1e-5
    for impl in ("reference", "kernel", "auto"):
        got = _torch(q, pool, table, lengths, impl)
        np.testing.assert_allclose(got, want, atol=atol, err_msg=impl)


def test_dead_pages_are_masked_whatever_they_hold():
    """Overwriting every cell at or past a row's length (including the
    trash page) changes nothing."""
    q, pool, table, lengths = _case(12, 3, 4, 2, 32, 8, 12, 4, quant=False)
    base = _torch(q, pool, table, lengths, "reference")
    poisoned = {n: a.copy() for n, a in pool.items()}
    ps = 8
    live = set()
    for row in range(len(lengths)):
        for cell in range(int(lengths[row])):
            live.add((int(table[row, cell // ps]), cell % ps))
    for page in range(pool["k"].shape[0]):
        for off in range(ps):
            if (page, off) not in live:
                poisoned["k"][page, off] = 1e4
                poisoned["v"][page, off] = -1e4
    got = _torch(q, poisoned, table, lengths, "reference")
    np.testing.assert_array_equal(got, base)


def test_gather_pages_layout():
    pool = {"k": torch.arange(4 * 2 * 1 * 3, dtype=torch.float32).reshape(4, 2, 1, 3)}
    table = torch.tensor([[2, 0], [1, 3]], dtype=torch.int32)
    view = tpa.gather_pages(pool, table)["k"]
    assert view.shape == (2, 4, 1, 3)
    assert torch.equal(view[1, 2], pool["k"][3, 0])
    assert torch.equal(view[0, 1], pool["k"][2, 1])


def test_supports_gate():
    pages = {"k": torch.empty((9, 16, 2, 64))}
    table = torch.zeros((3, 4), dtype=torch.int32)
    assert tpa.supports(torch.empty((3, 8, 64)), pages, table)
    assert not tpa.supports(torch.empty((3, 8, 16)), {"k": torch.empty((9, 16, 2, 16))}, table)
    assert not tpa.supports(torch.empty((3, 32, 64)), pages, table)  # n_rep 16
    assert not tpa.supports(torch.empty((3, 8, 64)), {"k": torch.empty((9, 4, 2, 64))}, table)
    assert not tpa.supports(torch.empty((2, 8, 64)), pages, table)
    assert not tpa.use_kernel(torch.empty((3, 8, 64)), pages, table)
    with pytest.raises(ValueError, match="unknown impl"):
        tpa.paged_attention(
            torch.empty((3, 8, 64)), pages, table,
            torch.ones(3, dtype=torch.int32), impl="nope",
        )


def _tma_shares(lengths, kv, n_table, grid):
    """The TMA-ring kernel's work split as csrc/paged_attention.cu
    computes it from `lengths` on the card: the units (row b, KV head g,
    page p) in order (pages of 16 cells, capped by the table), and each
    block's share [b * total // grid, (b + 1) * total // grid)."""
    units = []
    for b, n in enumerate(lengths):
        pages = -(-min(max(int(n), 0), n_table * 16) // 16)
        units += [(b, g, p) for g in range(kv) for p in range(pages)]
    total = len(units)
    starts = [i * total // grid for i in range(grid + 1)]
    return units, [(starts[i], starts[i + 1]) for i in range(grid)]


@pytest.mark.parametrize("sms", [132, 7])
@pytest.mark.parametrize(
    "lengths,kv,n_table",
    [([0, 1, 15, 16, 17, 48, 128, 77], 4, 8),     # the card test's batch
     ([1000, 50, 2048, 300, 0, 717, 1, 1024], 8, 128),
     ([5000, 3], 2, 4),                          # past the capacity
     ([0, 0, 0], 8, 16)],
)
def test_tma_shares_cover_every_live_page_once(lengths, kv, n_table, sms):
    """The TMA-ring kernel's work split, as it computes it on the device:
    every live page of every (row, KV head), and nothing past a row's
    length or the table's capacity, lies in exactly one block's share;
    the shares are contiguous, differ by at most one page, and the grid
    (fixed by capacity) is at most two blocks an SM."""
    grid = tpa.tma_grid(len(lengths), kv, n_table, sms)
    assert 1 <= grid <= 2 * sms and grid <= len(lengths) * kv * n_table
    units, shares = _tma_shares(lengths, kv, n_table, grid)
    want = [(b, g, p) for b, n in enumerate(lengths) for g in range(kv)
            for p in range(-(-min(n, n_table * 16) // 16))]
    assert units == want
    assert shares[0][0] == 0 and shares[-1][1] == len(units)
    assert all(a[1] == b[0] for a, b in zip(shares, shares[1:]))
    sizes = [e - s for s, e in shares]
    assert max(sizes) - min(sizes) <= 1
    covered = [u for s, e in shares for u in units[s:e]]
    assert covered == want


def test_engine_decode_shapes_take_the_tma_kernel():
    """The serving decode step (bf16 queries, pages of 16 cells) takes the
    TMA-ring kernel at Llama-3-8B's heads (32 q / 8 KV of 128), bf16 or
    int8 pool; f32 queries, head_dim 256 and other pages take the split
    kernel."""
    from dlrover_tpu_torch.models import llama as tllama

    cfg = tllama.LlamaConfig.llama3_8b()
    hd, kv = cfg.head_dim, cfg.n_kv_heads
    for quant in (False, True):
        assert tpa.kernel_variant(torch.bfloat16, 16, kv, hd, 8,
                                  quant) == "tma"
    assert tpa.kernel_variant(torch.bfloat16, 16, 2, 64, 2, False) == "tma"
    assert tpa.kernel_variant(torch.float32, 16, kv, hd, 8, False) == "split"
    assert tpa.kernel_variant(torch.bfloat16, 16, kv, 256, 8,
                              False) == "split"
    assert tpa.kernel_variant(torch.bfloat16, 8, kv, hd, 8, False) == "split"
    assert tpa.kernel_variant(torch.bfloat16, 16, 64, hd, 8, True) == "split"
    assert tpa.kernel_variant(torch.bfloat16, 16, kv, hd, 2048,
                              False) == "split"
