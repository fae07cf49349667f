"""F5: each auto dispatch of the port takes its CUDA kernel where the
JAX package takes its kernel, and its plain version where JAX serves
the input through its reference.

The decisions are checked here on the CPU, shape by shape, through the
form that takes a device type (`paged_attention.takes_kernel`), against
the JAX gates on the same shapes:
- paged attention: JAX `supports`. Where JAX refuses (pages under 8
  cells, head_dim past 512) both take the reference; where JAX takes
  its kernel the port takes its own, whose gate (`supports`) is JAX's:
  any whole GQA group, head_dim a multiple of 8 in [32, 512];
- the int8 matmul, quantize and dequantize: JAX takes its kernels for
  every shape, so the port's wrappers take theirs for every CUDA
  tensor, and the kernels take every block that divides the row, any
  K and f32 or bf16 activations (the matmul's general variant, the
  quantizer's warp-a-row and the dequantizer's value-a-thread paths).
At those shapes the plain versions (the wrappers' CPU route) are held
to JAX's outputs (bytes for the quantizer, bits for the dequantizer, a
tolerance for the matmul). A paged engine at one config F5 refused on
the card (GQA group 3, pages of 4 cells) gives the JAX engine's greedy
streams. The card side (the reference under auto outside the JAX gate,
raising kernels inside it) is in tests/test_torch_cuda.py."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dlrover_tpu.models import llama as jllama
from dlrover_tpu.ops import paged_attention as jpa
from dlrover_tpu.ops import quantization as jq
from dlrover_tpu.serving.engine import ContinuousBatcher as JaxBatcher
from dlrover_tpu_torch.models import llama as tllama
from dlrover_tpu_torch.ops import paged_attention as tpa
from dlrover_tpu_torch.ops import quantization as tq
from dlrover_tpu_torch.serving import engine as teng


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's engine runs many small ops: one intra-op thread keeps
    them fast beside the other test workers (restored afterwards)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# (H, KV, D, page size, JAX gate, port kernel's gate): the shapes F5
# named, page size 4, and shapes both take; the two gates are one
PAGED = [
    (32, 8, 128, 16, True, True),
    (8, 2, 64, 8, True, True),
    (16, 16, 256, 16, True, True),
    (12, 4, 64, 16, True, True),     # GQA group 3
    (28, 4, 128, 16, True, True),    # group 7
    (32, 32, 96, 16, True, True),    # head_dim 96
    (8, 2, 512, 16, True, True),     # head_dim 512
    (8, 2, 40, 16, True, True),      # head_dim 40
    (8, 2, 64, 4, False, False),     # pages of 4 cells
    (8, 2, 520, 16, False, False),   # head_dim past both gates
]


@pytest.mark.parametrize(
    "h,kv,d,ps,jax_gate,kernel_gate", PAGED,
    ids=[f"h{c[0]}-kv{c[1]}-d{c[2]}-ps{c[3]}" for c in PAGED],
)
def test_paged_choice_against_jax_gate(h, kv, d, ps, jax_gate, kernel_gate):
    b, n_pages, per_row = 2, 8, 4
    q = np.zeros((b, h, d), np.float32)
    pages = np.zeros((n_pages, ps, kv, d), np.float32)
    table = np.zeros((b, per_row), np.int32)
    got_jax = jpa.supports(jnp.asarray(q, jnp.bfloat16), {"k": pages}, table)
    assert got_jax == jax_gate
    shapes = ((b, h, d), (n_pages, ps, kv, d), (b, per_row))
    # auto on the card: the JAX choice, shape by shape
    assert tpa.takes_kernel(*shapes, "cuda") == got_jax
    assert tpa.takes_kernel(*shapes, torch.device("cuda", 0)) == got_jax
    # CPU tensors: always the reference
    assert not tpa.takes_kernel(*shapes, "cpu")
    tq_ = torch.zeros(shapes[0], dtype=torch.bfloat16)
    tpages = {"k": torch.zeros(shapes[1], dtype=torch.bfloat16)}
    ttable = torch.zeros(shapes[2], dtype=torch.int32)
    assert not tpa.use_kernel(tq_, tpages, ttable)
    # the kernels' own gate is JAX's
    assert tpa.supports(tq_, tpages, ttable) == kernel_gate == got_jax


@pytest.mark.parametrize("k", [24, 96, 160, 1000, 256, 4096])
def test_dqmm_choice_and_plain_output(k):
    """The block the engine quantizes a K at is JAX's; the port's kernels
    take every such weight (the decode and prefill kernels at K % 64 ==
    0 with block >= 16, the general variant the rest); the plain version
    matches the JAX dequant-matmul on the same int8 weight (the JAX
    reference on the CPU)."""
    block = tq.weight_quant_block(k)
    assert block == jq.weight_quant_block(k)
    assert tq.dqmm_supports(8, k, 48, block)
    assert tq._dqmm_fast(k, block) == (k % 64 == 0 and block >= 16)
    rng = np.random.default_rng(k)
    w = rng.standard_normal((48, k)).astype(np.float32)
    x = rng.standard_normal((5, k)).astype(np.float32)
    q8, s8 = jq.quantize_int8(jnp.asarray(w), block)
    want = np.asarray(jq.quantized_matmul(
        jnp.asarray(x), jq.QuantizedWeight(q8, s8, block)))
    qw = tq.QuantizedWeight(torch.from_numpy(np.array(q8)),
                            torch.from_numpy(np.array(s8)), block)
    got = tq.quantized_matmul(torch.from_numpy(x), qw).numpy()
    # the same f32 products, summed over K in another order
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("block", [8, 256, 512, 24, 6])
def test_quant_choice_and_bytes_at_block(block):
    """The kernels take every block that divides the row: the quantizer's
    lane kernel blocks 8..256 (powers of two) and its warp-a-row kernel
    the rest, `int8_adam(block=512)` among them; the dequantizer's
    4-values-a-thread kernel every power of two from 8 and its
    value-a-thread kernel the rest. The plain versions' bytes and bits
    are the JAX kernels' (interpret mode) at every block."""
    assert (block in tq._QUANT_BLOCKS) == (block <= 256 and block % 8 == 0
                                           and block & (block - 1) == 0)
    assert tq._dequant_fast(block) == (block in (8, 256, 512))
    rng = np.random.default_rng(block)
    n = 1024 if 1024 % block == 0 else 40 * block
    x = (rng.standard_normal((3, n)) * 3).astype(np.float32)
    jqv, jsv = jq.quantize_int8(jnp.asarray(x), block)
    q, s = tq.quantize_int8(torch.from_numpy(x), block)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jqv))
    np.testing.assert_array_equal(s.numpy(), np.asarray(jsv))
    want = np.asarray(jq.dequantize_int8(jqv, jsv))
    got = tq.dequantize_int8(q, s).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("quant", [False, True], ids=["f32", "int8"])
def test_refused_paged_engine_config_matches_jax(quant):
    """The engine config F5 refused on the card: GQA group 3 at head_dim
    64 (H=12, KV=4) and max_len 44, whose auto page size is 4. Its
    greedy streams equal the JAX engine's."""
    jcfg = dataclasses.replace(
        jllama.LlamaConfig.tiny(dim=768, n_heads=12, n_kv_heads=4),
        dtype=jnp.float32)
    jparams = jllama.init_params(jcfg, jax.random.PRNGKey(1))
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    tcfg = tllama.LlamaConfig.tiny(dim=768, n_heads=12, n_kv_heads=4,
                                   dtype=torch.float32)
    tparams = tllama.params_from_numpy(tcfg, tree, device="cpu")
    rng = np.random.default_rng(5)
    prompts = [rng.integers(1, 250, size=n).tolist() for n in (3, 17, 9, 30)]
    kw = dict(n_slots=2, max_len=44, max_new_tokens=6, chunk=4,
              kv_layout="paged", kv_quant=quant)
    want = [list(map(int, r))
            for r in JaxBatcher(jcfg, jparams, **kw).generate_all(prompts)]
    eng = teng.ContinuousBatcher(tcfg, tparams, device="cpu", **kw)
    assert eng.page_size == 4
    b, h, d = 2, tcfg.n_heads, tcfg.head_dim
    assert not tpa.takes_kernel((b, h, d),
                                (eng.n_pages, 4, tcfg.n_kv_heads, d),
                                (b, eng._pages_per_slot), "cuda")
    got = [list(map(int, r)) for r in eng.generate_all(prompts)]
    assert got == want
