"""PyTorch port's int8 weight quantization (dlrover_tpu_torch/ops/
quantization.py) against the JAX package's, on the same numpy inputs.

On CPU tensors the port's wrappers run their kernels' plain versions,
so these tests hold those to the JAX package: `quantize_int8` to the
Pallas `_quant_kernel` (interpret mode on the CPU) byte for byte,
`quantized_matmul` to the JAX reference and to the interpret-mode
`_dqmm_kernel` within rtol 1e-5 plus an absolute 1e-5 of the largest
|output| (`_close`: f32 sums of hundreds of products taken in another
order by two libraries; the rounding error scales with the terms, so
an output that cancels to near 0 carries the error of the large
ones). The CUDA kernels are held to these plain versions on the card
(tests/test_torch_cuda.py, chip_smoke.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dlrover_tpu.ops import quantization as jq
from dlrover_tpu_torch.ops import _build
from dlrover_tpu_torch.ops import quantization as tq

RTOL = 1e-5


def _close(got, want):
    np.testing.assert_allclose(
        got, want, rtol=RTOL, atol=RTOL * float(np.abs(want).max())
    )


def _rows(rng, m, n, scale=1.0):
    return (rng.standard_normal((m, n)) * scale).astype(np.float32)


def _assert_quant_bytes_equal(x: np.ndarray, block: int):
    jqq, jss = jq.quantize_int8(jnp.asarray(x), block)
    tqq, tss = tq.quantize_int8(torch.from_numpy(x), block)
    assert tqq.dtype == torch.int8 and tss.dtype == torch.float32
    assert tqq.numpy().tobytes() == np.asarray(jqq).tobytes()
    assert tss.numpy().tobytes() == np.asarray(jss).tobytes()
    return tqq.numpy(), tss.numpy()


@pytest.mark.parametrize("block", [64, 128, 256])
@pytest.mark.parametrize("scale", [1e-3, 1.0, 37.5])
def test_quantize_bytes_equal_jax_random_rows(block, scale):
    rng = np.random.default_rng(block)
    _assert_quant_bytes_equal(_rows(rng, 19, 3 * block, scale), block)


@pytest.mark.parametrize("block", [64, 128, 256])
def test_quantize_bytes_equal_jax_edge_values(block):
    """An all-zero block (scale 1.0, q 0), values at exact half steps of
    the scale the kernel computes (round half to even decides them),
    and +-amax (q = +-127)."""
    rng = np.random.default_rng(7)
    x = _rows(rng, 6, 2 * block)
    x[0, :block] = 0.0
    # half steps: the kernel's scale is amax * f32(1/127); with amax =
    # 127 * 2^-3 that is exact, so (k + 0.5) * scale is exact too
    scale = np.float32(2.0 ** -3)
    k = (np.arange(block) % 200 - 100).astype(np.float32)
    x[1, :block] = (k + 0.5) * scale
    x[1, 0] = 127 * scale
    x[2, :block] = -x[1, :block]
    x[3, :block] = np.where(np.arange(block) % 2 == 0, 1.0, -1.0) * 4.25
    q, s = _assert_quant_bytes_equal(x, block)
    assert s[0, 0] == 1.0 and not q[0, :block].any()
    assert s[1, 0] == scale
    halves = np.rint(k + 0.5)                   # half to even
    np.testing.assert_array_equal(q[1, 1:block], halves[1:])
    assert q[1, 0] == 127 and q[2, 0] == -127
    assert set(np.unique(q[3, :block])) == {-127, 127}


def test_quantize_refuses_ragged_blocks():
    with pytest.raises(ValueError, match="n % block"):
        tq.quantize_int8(torch.zeros(4, 100), 64)
    with pytest.raises(ValueError, match="n % block"):
        tq.quantize_int8(torch.zeros(256), 64)


def test_weight_quant_block_equals_jax():
    assert tq.weight_quant_block(64) == 64
    assert tq.weight_quant_block(4096) == 256
    assert tq.weight_quant_block(48) == 16
    assert tq.weight_quant_block(6) == 0
    assert tq.weight_quant_block(7) == 0
    got = [tq.weight_quant_block(k) for k in range(1, 8193)]
    want = [jq.weight_quant_block(k) for k in range(1, 8193)]
    assert got == want
    assert tq.weight_quant_block(14336) == 256


def _qweight(rng, lead, o, k, block):
    """The same int8 weight in both packages, quantized by JAX."""
    w = _rows(rng, int(np.prod(lead, dtype=int)) * o, k)
    q, s = jq.quantize_int8(jnp.asarray(w), block)
    q = np.asarray(q).reshape(*lead, o, k)
    s = np.asarray(s).reshape(*lead, o, k // block)
    q, s = np.array(q), np.array(s)   # writable copies for torch
    return (
        jq.QuantizedWeight(jnp.asarray(q), jnp.asarray(s), block),
        tq.QuantizedWeight(torch.from_numpy(q), torch.from_numpy(s), block),
    )


def test_quantized_weight_shape_and_slicing():
    rng = np.random.default_rng(3)
    jw, tw = _qweight(rng, (3,), 48, 128, 64)
    assert tw.shape == jw.shape == (3, 128, 48)
    one = tw[1]
    assert isinstance(one, tq.QuantizedWeight) and one.block == 64
    assert one.shape == (128, 48)
    assert one.q8.data_ptr() == tw.q8[1].data_ptr()   # a view
    np.testing.assert_array_equal(one.s8.numpy(), np.asarray(jw.s8[1]))


def test_layer_slices_are_memoised():
    """An int index returns one object per layer, so the dqmm wrapper's
    one-time weight checks hold across decode steps; other indices
    slice anew."""
    rng = np.random.default_rng(5)
    _, tw = _qweight(rng, (3,), 16, 64, 64)
    assert tw[1] is tw[1] and tw[1] is not tw[2]
    assert tw[1]._checked_on is None
    assert tw[1:2] is not tw[1:2] and tw[1:2].shape == (1, 64, 16)


@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
def test_dq_weight_bytes_equal_jax(dtype):
    rng = np.random.default_rng(4)
    jw, tw = _qweight(rng, (2,), 40, 256, 128)
    jdt = jnp.float32 if dtype is np.float32 else jnp.bfloat16
    tdt = torch.float32 if dtype is np.float32 else torch.bfloat16
    want = np.asarray(
        jq._dq_weight(jw.q8[1], jw.s8[1], 128, jdt).astype(jnp.float32)
    )
    got = tq._dq_weight(tw.q8, tw.s8, 128, tdt)[1].float().numpy()
    assert got.tobytes() == want.tobytes()


@pytest.mark.parametrize("t", [1, 5, 8])
@pytest.mark.parametrize("block", [64, 256])
def test_quantized_matmul_matches_jax(t, block, monkeypatch):
    """The port's plain quantized_matmul against the JAX reference and
    the Pallas kernel in interpret mode, same q8 / s8 / x (f32)."""
    rng = np.random.default_rng(t * block)
    o, k = 96, 512
    jw, tw = _qweight(rng, (), o, k, block)
    x = _rows(rng, t, k)
    got = tq.quantized_matmul(torch.from_numpy(x), tw).numpy()
    assert got.shape == (t, o) and got.dtype == np.float32
    ref = np.asarray(jq.quantized_matmul_reference(jnp.asarray(x), jw))
    _close(got, ref)
    monkeypatch.setenv("DLROVER_TPU_FORCE_KERNELS", "1")
    assert jq.use_quant_matmul_kernel(tp=1)
    kern = np.asarray(jq.quantized_matmul_kernel(jnp.asarray(x), jw))
    _close(got, kern)


def test_quantized_matmul_leading_dims_and_matmul_any():
    rng = np.random.default_rng(9)
    jw, tw = _qweight(rng, (), 24, 128, 64)
    x = _rows(rng, 2 * 3 * 4, 128).reshape(2, 3, 4, 128)
    got = tq.matmul_any(torch.from_numpy(x), tw).numpy()
    want = np.asarray(jq.matmul_any(jnp.asarray(x), jw))
    assert got.shape == (2, 3, 4, 24)
    _close(got, want)
    # a dense weight takes `x @ w` exactly as before
    w = torch.from_numpy(_rows(rng, 128, 24))
    xt = torch.from_numpy(x)
    assert torch.equal(tq.matmul_any(xt, w), xt @ w)


def test_bf16_plain_version_rounds_once():
    """bf16 x: the dequantized weight is rounded to bf16, the products
    summed in f32, the output rounded once — the JAX reference's
    order on the same values."""
    rng = np.random.default_rng(11)
    jw, tw = _qweight(rng, (), 32, 256, 256)
    x = _rows(rng, 5, 256)
    xb = torch.from_numpy(x).bfloat16()
    got = tq.quantized_matmul(xb, tw)
    assert got.dtype == torch.bfloat16
    want = np.asarray(
        jq.quantized_matmul_reference(jnp.asarray(xb.float().numpy(),
                                                  jnp.bfloat16), jw)
        .astype(jnp.float32)
    )
    # one bf16 rounding of nearly equal f32 sums: one bf16 ulp of the
    # output, or of the largest output where the sum cancels
    np.testing.assert_allclose(got.float().numpy(), want, rtol=2 ** -7,
                               atol=2 ** -8 * float(np.abs(want).max()))


def test_cpu_tensors_never_count_a_launch():
    _build.reset_launch_counts()
    rng = np.random.default_rng(0)
    _, tw = _qweight(rng, (), 16, 64, 64)
    tq.quantize_int8(torch.zeros(4, 64), 64)
    tq.quantized_matmul(torch.zeros(3, 64), tw)
    assert _build.launch_counts()["quant_int8"] == 0
    assert _build.launch_counts()["dqmm"] == 0


@pytest.mark.parametrize(
    "t,k,o,block,ok",
    [(8, 4096, 1024, 256, True), (77, 14336, 4096, 256, True),
     (1, 64, 3, 64, True), (8, 96, 16, 32, True), (8, 128, 16, 8, True),
     (8, 192, 16, 128, False), (8, 100, 16, 64, False),
     (8, 64, 0, 64, False)],
)
def test_dqmm_gate(t, k, o, block, ok):
    """JAX's gate: every T, K and O of at least 1, any block dividing K
    (K % 64 != 0, blocks under 16 and f32 x take the general variant);
    `_dqmm_fast` names the weights the decode and prefill kernels take."""
    assert tq.dqmm_supports(t, k, o, block) is ok
    if ok:
        assert tq._dqmm_fast(k, block) == (k % 64 == 0 and block >= 16
                                           and block & (block - 1) == 0)


@pytest.mark.parametrize(
    "t,k,o",
    [(8, 4096, 1024), (8, 14336, 4096), (8, 4096, 128256),
     (1024, 4096, 1024), (77, 4096, 14336), (16, 64, 5),
     (256, 14336, 4096)],
)
def test_dqmm_plan_covers_k(t, k, o):
    """The plan picks the TMA-ring decode kernel for T <= 16 (at block
    256; its even shares are checked in
    `test_dqmm_decode_tma_shares_cover_every_stage_once`), the prefill
    kernel's 128-token tiles up to T = 128 and its 256-token tiles
    above. The mma.sync decode kernel's split over K (block 16, or
    asked for) covers every 64-wide chunk exactly once, keeps at least 4
    chunks a split where K allows and at most 16 (its shared-memory
    activation slab). The prefill kernel is persistent: at most one
    block an SM, and it splits K only where its tiles fill less than one
    wave, never into more than a wave."""
    variant, splits, per, grid = tq._dqmm_plan(t, k, o)
    chunks = k // 64
    assert variant == (3 if t <= 16 else 1 if t <= 128 else 2)
    if variant == 3:
        assert 1 <= grid <= 2 * 132
        for plan in (tq._dqmm_plan(t, k, o, 132, 16),
                     tq._dqmm_mma_plan(t, k, o)):
            variant, splits, per, grid = plan
            assert variant == 0
            assert (splits - 1) * per < chunks <= splits * per
            assert splits == 1 or per >= 4
            assert per <= 16
            assert grid == -(-o // 64) * splits
        return
    assert (splits - 1) * per < chunks <= splits * per
    assert splits == 1 or per >= 4
    bt = 128 if variant == 1 else 256
    tiles = -(-t // bt) * -(-o // 128)
    assert grid == min(tiles * splits, 132)
    assert splits == 1 or tiles * splits <= 132


def _engine_prefill_buckets():
    from dlrover_tpu_torch.serving.engine import _pad_bucket

    return sorted({_pad_bucket(n) for n in range(17, 2049)})


# the Llama-3-8B matmul weights as (K, O): wq / wo, wk / wv, w_gate /
# w_up, w_down, lm_head
_LLAMA3_8B_WEIGHTS = ((4096, 4096), (4096, 1024), (4096, 14336),
                      (14336, 4096), (4096, 128256))


def test_dqmm_plan_takes_every_engine_bucket():
    """Every prompt bucket the engine prefills (17 to 2048 tokens) plans
    onto the prefill kernel at every Llama-3-8B weight shape (block
    256), and every decode batch (T <= 16) onto the TMA-ring decode
    kernel; the prefill grid never exceeds the card's SMs and K splits
    only where the tiles leave SMs idle (wk / wv at T = 1024: 4 splits
    of 16 chunks)."""
    buckets = _engine_prefill_buckets()
    assert buckets == [32, 64, 128, 256, 512, 1024, 2048]
    for k, o in _LLAMA3_8B_WEIGHTS:
        for t in buckets:
            assert tq.dqmm_supports(t, k, o, 256)
            variant, splits, per, grid = tq._dqmm_plan(t, k, o)
            assert variant == (1 if t <= 128 else 2)
            assert 1 <= grid <= 132
            if t >= 1024 and o >= 4096:
                assert splits == 1
        for t in range(1, 17):
            assert tq._dqmm_plan(t, k, o)[0] == 3
    assert tq._dqmm_plan(1024, 4096, 1024)[:3] == (2, 4, 16)


@pytest.mark.parametrize("sms", [132, 114, 7])
@pytest.mark.parametrize(
    "k,o", list(_LLAMA3_8B_WEIGHTS) + [(64, 40), (192, 136), (128, 200),
                                       (4096, 64)],
)
def test_dqmm_decode_tma_shares_cover_every_stage_once(k, o, sms):
    """The TMA-ring decode kernel's plan, replayed as the kernel computes
    it: the shares of the (64-output tile, 256-value K range) stages
    cover every stage exactly once, in order, none empty, differing by
    at most one, at most two blocks an SM (where the tiles fill fewer,
    the tiles times the K splits that fit, at least two stages a piece);
    every 64-wide K chunk lies in one stage; and each tile cut by a
    share's edge has its pieces in distinct slots, at most `splits`."""
    variant, splits, per_block, grid = tq._dqmm_plan(8, k, o, sms)
    assert variant == 3
    assert 1 <= grid <= 2 * sms
    total, kst = tq._dec_tma_work(k, o)
    tiles = total // kst
    assert kst * 256 >= k > (kst - 1) * 256
    if tiles < 2 * sms:
        assert grid % tiles == 0
        assert grid == tiles or kst // (grid // tiles) >= 2
    starts = [tq._share_start(b, total, grid) for b in range(grid + 1)]
    assert starts[0] == 0 and starts[-1] == total
    sizes = [b - a for a, b in zip(starts, starts[1:])]
    assert min(sizes) >= 1 and max(sizes) <= per_block
    assert max(sizes) - min(sizes) <= 1
    for s in range(total):
        b = tq._share_block(s, total, grid)
        assert starts[b] <= s < starts[b + 1]
    slots = {}
    for tile in range(tiles):
        ts, te = tile * kst, (tile + 1) * kst
        blocks = range(tq._share_block(ts, total, grid),
                       tq._share_block(te - 1, total, grid) + 1)
        assert len(blocks) <= splits
        if len(blocks) == 1:
            continue
        for b in blocks:
            # the writer's slot and the summing block's read agree
            slot = 2 * b + (1 if ts > starts[b] else 0)
            assert slot not in slots, (tile, b)
            slots[slot] = tile
    assert tq._dqmm_plan(16, k, o, sms)[0] == 3
    assert tq._dqmm_plan(8, k, o, sms, 32)[0] == 0
