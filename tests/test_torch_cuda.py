"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Every test here is marked `cuda` and skips where there is no
NVIDIA GPU (a CUDA kernel has no CPU mode). The file imports no JAX,
so it also runs on a machine without it:

    python -m pytest tests/test_torch_cuda.py --noconftest -m cuda -q

Tolerance 2e-2 abs on bf16 outputs of magnitude ~1: the output is bf16
(2^-8 relative), and P is rounded to bf16 at other points — the flash
forward at each key tile's running max (64 keys in the mma.sync
variant, 128 in the wgmma one), its plain version at the final max; the paged plain version before P V, the paged kernel never.
The int8 quantize and dequantize kernels must give their plain
versions' bytes; the dequant-matmul kernel is held to DQMM_TOL of the
largest |output|: both round the same bf16 weights and a bf16 output,
and differ only in the order of the f32 sums (and the output's one
rounding that follows).
The flash backward kernels are held to BWD_REL of the largest |grad|
of each of dq, dk, dv: both sides round P and dS to bf16 before the
products and the gradients once, but P comes from exp2 on the
special-function unit (2 ulp) in the kernels, so an element near a
bf16 rounding boundary may round the other way (2^-8 relative), and
the f32 sums run in another order. A training step with the kernels is
held to the same step with plain attention (`attn_impl="reference"`)
with the tolerances stated in that test. The fused cross entropy's
bf16 head products (f32 output) are held to an f32 product of the same
bf16 values within FUSED_CE_REL of the largest |value|: the same
products, f32 sums in another order, and dlogits rounded to bf16
before the backward's products on the fused side only (2^-9 relative).
The flash checkpoint's staging and restore on card tensors are held to
bit equality."""

import gc

import numpy as np
import pytest
import torch

from dlrover_tpu_torch.models import decode as tdec
from dlrover_tpu_torch.ops import _build
from dlrover_tpu_torch.ops import flash_attention as tfa
from dlrover_tpu_torch.ops import paged_attention as tpa
from dlrover_tpu_torch.ops import quantization as tq

TOL = 2e-2
DQMM_TOL = 2 ** -7
BWD_REL = 2 ** -6
FUSED_CE_REL = 2 ** -7

pytestmark = pytest.mark.cuda


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernel has no CPU mode)")
    return torch.Generator(device="cuda").manual_seed(0)


@pytest.mark.parametrize(
    "b,s,h,kv,d",
    [(1, 77, 32, 8, 128), (2, 200, 8, 4, 64), (1, 48, 4, 2, 40),
     (1, 130, 4, 4, 256)],
)
def test_flash_kernel_matches_plain(gen, b, s, h, kv, d):
    q = torch.randn((b, s, h, d), generator=gen, device="cuda").bfloat16()
    k = torch.randn((b, s, kv, d), generator=gen, device="cuda").bfloat16()
    v = torch.randn((b, s, kv, d), generator=gen, device="cuda").bfloat16()
    before = _build.launch_counts()
    for causal in (True, False):
        o, lse = tfa._fwd(q, k, v, causal, d ** -0.5)
        o_ref, lse_ref = tfa._fwd_plain(q, k, v, causal, d ** -0.5)
        torch.cuda.synchronize()
        assert (o.float() - o_ref.float()).abs().max().item() < TOL
        assert (lse - lse_ref).abs().max().item() < 1e-3
    after = _build.launch_counts()
    assert after["flash_fwd"] == before["flash_fwd"] + 2
    wgmma = 2 if d in (64, 128) else 0   # D = 40 and 256: mma.sync
    assert after["flash_fwd_wgmma"] == before["flash_fwd_wgmma"] + wgmma


def _flash_case(gen, b, s, h, kv, d):
    def rand(heads):
        return torch.randn((b, s, heads, d), generator=gen,
                           device="cuda").bfloat16()

    return rand(h), rand(kv), rand(kv)


def _check_wgmma(q, k, v, causal):
    """One forward through the wgmma variant, held to the plain version
    on O and LSE; the call bumps "flash_fwd_wgmma" (and "flash_fwd") by
    exactly one."""
    b, s, h, d = q.shape
    assert tfa._fwd_variant(b, s, s, h, k.shape[2], d, causal) == "wgmma"
    before = _build.launch_counts()
    o, lse = tfa._fwd(q, k, v, causal, d ** -0.5)
    after = _build.launch_counts()
    o_ref, lse_ref = tfa._fwd_plain(q, k, v, causal, d ** -0.5)
    torch.cuda.synchronize()
    assert after["flash_fwd_wgmma"] == before["flash_fwd_wgmma"] + 1
    assert after["flash_fwd"] == before["flash_fwd"] + 1
    err = (o.float() - o_ref.float()).abs().max().item()
    lse_err = (lse - lse_ref).abs().max().item()
    assert err < TOL and lse_err < 1e-3, (b, s, h, d, causal, err, lse_err)


@pytest.mark.parametrize("d", [64, 128])
def test_flash_wgmma_below_one_tile(gen, d):
    """Every length shorter than the wgmma variant's 128-row tile (TMA
    zero-fills the rows past S; the keys past S are masked), B=2, GQA
    4."""
    for s in range(1, 64):
        q, k, v = _flash_case(gen, 2, s, 8, 2, d)
        for causal in (True, False):
            _check_wgmma(q, k, v, causal)


@pytest.mark.parametrize("n_rep", [1, 4, 8])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("s", [77, 128, 200, 1000, 2048])
def test_flash_wgmma_matches_plain(gen, s, d, n_rep):
    """The wgmma variant at a ragged tile (77, 200, 1000), exact tiles
    (128, 2048) and across the 2-stage K/V ring, B=2, GQA ratios 1, 4
    and 8, causal and not."""
    q, k, v = _flash_case(gen, 2, s, 8, 8 // n_rep, d)
    for causal in (True, False):
        _check_wgmma(q, k, v, causal)


def test_flash_kernel_single_query(gen):
    q = torch.randn((2, 1, 8, 128), generator=gen, device="cuda").bfloat16()
    k = torch.randn((2, 300, 2, 128), generator=gen, device="cuda").bfloat16()
    v = torch.randn((2, 300, 2, 128), generator=gen, device="cuda").bfloat16()
    before = _build.launch_counts()
    o = tfa.flash_attention(q, k, v, causal=True)
    after = _build.launch_counts()
    o_ref = tfa._fwd_plain(q, k, v, False, 128 ** -0.5)[0]
    assert (o.float() - o_ref.float()).abs().max().item() < TOL
    # the single-query shape runs on the mma.sync variant
    assert after["flash_fwd"] == before["flash_fwd"] + 1
    assert after["flash_fwd_wgmma"] == before["flash_fwd_wgmma"]


def test_flash_kernel_refuses_what_it_cannot_take(gen):
    q = torch.randn((1, 16, 4, 64), generator=gen, device="cuda")
    with pytest.raises(ValueError, match="bfloat16"):
        tfa._fwd(q, q, q, True, 0.125)
    qb = q.bfloat16()
    with pytest.raises(ValueError, match="does not take"):
        tfa.flash_attention(qb[..., :16], qb[..., :16], qb[..., :16])


@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_paged_kernel_matches_plain(gen, quant, dtype):
    rng = np.random.default_rng(0)
    b, h, kv, hd, ps, n_pages, per_row = 4, 8, 2, 64, 16, 40, 6
    q = torch.randn((b, h, hd), generator=gen, device="cuda").to(dtype)
    k = torch.randn((n_pages, ps, kv, hd), generator=gen, device="cuda")
    v = torch.randn((n_pages, ps, kv, hd), generator=gen, device="cuda")
    if quant:
        kq, ks = tdec._kv_quantize(k)
        vq, vs = tdec._kv_quantize(v)
        pages = {"k": kq, "v": vq, "k_scale": ks.bfloat16(),
                 "v_scale": vs.bfloat16()}
    else:
        pages = {"k": k.to(dtype), "v": v.to(dtype)}
    table = np.zeros((b, per_row), np.int32)
    lengths = np.array([1, 17, 50, per_row * ps], np.int32)
    for row in range(b):
        n_live = -(-int(lengths[row]) // ps)
        table[row, :n_live] = rng.choice(
            np.arange(1, n_pages), size=n_live, replace=False
        )
    tab = torch.from_numpy(table).cuda()
    lens = torch.from_numpy(lengths).cuda()
    ker = tpa.paged_attention(q, pages, tab, lens, impl="kernel")
    ref = tpa.paged_attention(q, pages, tab, lens, impl="reference")
    torch.cuda.synchronize()
    tol = TOL if dtype == torch.bfloat16 else 1e-4
    assert (ker.float() - ref.float()).abs().max().item() < tol


def _paged_tma_case(gen, quant, poison=None):
    """B=8 rows at lengths 0, 1, 15, 16, 17, a page boundary (48), the
    full capacity (128) and 77, over a permuted table: n_rep 4, hd 128,
    page 16. `poison` fills every cell past a row's length (in its last
    live page, and the pages it does not use) with that value."""
    rng = np.random.default_rng(3)
    b, h, kv, hd, ps, per_row = 8, 16, 4, 128, 16, 8
    n_pages = b * per_row + 1
    lengths = np.array([0, 1, 15, 16, 17, 48, per_row * ps, 77], np.int32)
    perm = rng.permutation(np.arange(1, n_pages)).astype(np.int32)
    table = perm[: b * per_row].reshape(b, per_row).copy()
    k = torch.randn((n_pages, ps, kv, hd), generator=gen, device="cuda")
    v = torch.randn((n_pages, ps, kv, hd), generator=gen, device="cuda")
    if quant:
        kq, ks = tdec._kv_quantize(k)
        vq, vs = tdec._kv_quantize(v)
        pages = {"k": kq, "v": vq, "k_scale": ks.bfloat16(),
                 "v_scale": vs.bfloat16()}
    else:
        pages = {"k": k.bfloat16(), "v": v.bfloat16()}
    if poison is not None:
        dead = torch.ones((n_pages, ps), dtype=torch.bool)
        for row, n in enumerate(lengths):
            for cell in range(int(n)):
                dead[table[row, cell // ps], cell % ps] = False
        dead = dead.cuda()
        for name in pages:
            if pages[name].dtype == torch.bfloat16:
                pages[name][dead] = poison
    q = torch.randn((b, h, hd), generator=gen, device="cuda").bfloat16()
    return (q, pages, torch.from_numpy(table).cuda(),
            torch.from_numpy(lengths).cuda())


@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
def test_paged_tma_kernel_matches_plain(gen, quant):
    """The TMA-ring kernel, one launch, against the plain version; the
    row of length 0 is zeros."""
    q, pages, tab, lens = _paged_tma_case(gen, quant)
    before = _build.launch_counts()
    ker = tpa.paged_attention(q, pages, tab, lens, impl="kernel")
    after = _build.launch_counts()
    ref = tpa.paged_attention(q, pages, tab, lens, impl="reference")
    torch.cuda.synchronize()
    assert after["paged_attention"] == before["paged_attention"] + 1
    assert after["paged_attention_tma"] == before["paged_attention_tma"] + 1
    assert torch.isfinite(ker.float()).all()
    assert not ker[0].any()
    assert (ker[1:].float() - ref[1:].float()).abs().max().item() < TOL


@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
def test_paged_tma_kernel_is_deterministic_and_ignores_dead_cells(gen, quant):
    """Two runs give the same bits, and NaN in every cell past a row's
    length (the tail of its last live page included) changes nothing."""
    q, pages, tab, lens = _paged_tma_case(gen, quant)
    a = tpa.paged_attention(q, pages, tab, lens, impl="kernel")
    b = tpa.paged_attention(q, pages, tab, lens, impl="kernel")
    gen.manual_seed(0)
    qp, poisoned, _, _ = _paged_tma_case(gen, quant, poison=float("nan"))
    assert torch.equal(qp, q)
    c = tpa.paged_attention(q, poisoned, tab, lens, impl="kernel")
    torch.cuda.synchronize()
    assert torch.equal(a, b)
    assert torch.equal(a, c)


@pytest.mark.parametrize(
    "dtype,hd,ps", [(torch.float32, 128, 16), (torch.bfloat16, 256, 16),
                    (torch.bfloat16, 64, 8), (torch.bfloat16, 128, 32)],
)
def test_paged_split_kernel_keeps_the_other_shapes(gen, dtype, hd, ps):
    """f32 queries, head_dim 256 and pages of other than 16 cells take the
    split kernel (no `paged_attention_tma` count); it still matches the
    plain version there, and where asked for at the main path's shape."""
    rng = np.random.default_rng(5)
    b, h, kv, per_row = 3, 8, 2, 4
    n_pages = b * per_row + 1
    q = torch.randn((b, h, hd), generator=gen, device="cuda").to(dtype)
    k = torch.randn((n_pages, ps, kv, hd), generator=gen, device="cuda")
    v = torch.randn((n_pages, ps, kv, hd), generator=gen, device="cuda")
    pages = {"k": k.to(dtype), "v": v.to(dtype)}
    table = torch.from_numpy(rng.permutation(np.arange(1, n_pages))
                             .astype(np.int32).reshape(b, per_row)).cuda()
    lens = torch.tensor([1, per_row * ps - 3, per_row * ps],
                        dtype=torch.int32, device="cuda")
    before = _build.launch_counts()
    ker = tpa.paged_attention(q, pages, table, lens, impl="kernel")
    after = _build.launch_counts()
    ref = tpa.paged_attention(q, pages, table, lens, impl="reference")
    torch.cuda.synchronize()
    assert after["paged_attention"] == before["paged_attention"] + 1
    assert after["paged_attention_tma"] == before["paged_attention_tma"]
    tol = TOL if dtype == torch.bfloat16 else 1e-4
    assert (ker.float() - ref.float()).abs().max().item() < tol
    q, pages, tab, lens = _paged_tma_case(gen, False)
    before = _build.launch_counts()["paged_attention_tma"]
    old = tpa._kernel(q, pages, tab, lens, 128 ** -0.5, variant="split")
    ref = tpa._reference(q, pages, tab, lens, 128 ** -0.5)
    torch.cuda.synchronize()
    assert _build.launch_counts()["paged_attention_tma"] == before
    assert not old[0].any()           # length 0 (the plain version: NaN)
    assert (old[1:].float() - ref[1:].float()).abs().max().item() < TOL


@pytest.mark.parametrize("block", [64, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_quant_kernel_bytes_equal_plain(gen, block, dtype):
    x = (torch.randn((300, 4 * block), generator=gen, device="cuda")
         * 3.0).to(dtype)
    x[0, :block] = 0.0
    x[1, :block] = (torch.arange(block, device="cuda") % 200 - 100
                    + 0.5).to(dtype) * 0.125
    x[1, 0] = 127 * 0.125
    before = _build.launch_counts()["quant_int8"]
    q, s = tq.quantize_int8(x, block)
    q_ref, s_ref = tq._quantize_plain(x, block)
    torch.cuda.synchronize()
    assert _build.launch_counts()["quant_int8"] == before + 1
    assert torch.equal(q, q_ref) and torch.equal(s, s_ref)
    assert s[0, 0].item() == 1.0 and s[1, 0].item() == 0.125


def test_quant_kernel_empty_input_launches_nothing(gen):
    before = _build.launch_counts()["quant_int8"]
    q, s = tq.quantize_int8(torch.zeros((0, 256), device="cuda"), 256)
    assert q.shape == (0, 256) and s.shape == (0, 1)
    assert _build.launch_counts()["quant_int8"] == before


@pytest.mark.parametrize("out", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows", [1, 5, 1025])
@pytest.mark.parametrize("block", [8, 16, 32, 64, 128, 256])
def test_dequant_kernel_bits_equal_plain(gen, block, rows, out):
    """One f32 product a value, rounded once to the output type: the
    kernel's bits equal the plain version's, as one row block of rows
    quant blocks and as [rows, block]."""
    q = torch.randint(-127, 128, (rows, block), generator=gen,
                      device="cuda").to(torch.int8)
    s = torch.rand((rows, 1), generator=gen, device="cuda") * 10.0 ** (
        torch.randint(-6, 2, (rows, 1), generator=gen, device="cuda"))
    q[0] = 0
    s[0] = 1.0
    for qq, ss in ((q, s), (q.reshape(1, -1), s.reshape(1, -1))):
        before = _build.launch_counts()["dequant_int8"]
        x = tq.dequantize_int8(qq, ss, out)
        ref = tq._dequantize_plain(qq, ss, out)
        torch.cuda.synchronize()
        assert _build.launch_counts()["dequant_int8"] == before + 1
        assert x.dtype == out and x.shape == qq.shape
        bits = torch.int16 if out == torch.bfloat16 else torch.int32
        assert torch.equal(x.view(bits), ref.view(bits))


def test_dequant_kernel_refuses_what_it_cannot_take(gen):
    q = torch.zeros((2, 512), dtype=torch.int8, device="cuda")
    with pytest.raises(ValueError, match="takes"):
        tq.dequantize_int8(q, torch.ones((2, 3), device="cuda"))  # no block
    with pytest.raises(ValueError, match="takes"):
        tq.dequantize_int8(q, torch.ones((3, 2), device="cuda"))  # rows
    with pytest.raises(ValueError, match="writes"):
        tq.dequantize_int8(q, torch.ones((2, 2), device="cuda"),
                           torch.float16)
    with pytest.raises(ValueError, match="dtype"):
        tq.dequantize_int8(q, torch.ones((2, 2), device="cuda").bfloat16())
    with pytest.raises(ValueError, match="contiguous"):
        tq.dequantize_int8(q[:, ::2], torch.ones((2, 1), device="cuda"))
    with pytest.raises(ValueError, match="aligned"):
        tq.dequantize_int8(q.reshape(-1)[8:520].reshape(1, 512),
                           torch.ones((1, 2), device="cuda"))


def test_dequantize_any_on_the_card(gen):
    x = torch.randn((7, 13), generator=gen, device="cuda")
    q, s, shape, pad = tq.quantize_any(x, 64)
    assert (q.shape, s.shape, shape, pad) == ((1, 128), (1, 2), (7, 13), 37)
    y = tq.dequantize_any(q, s, shape, pad)
    want = tq.dequantize_any(q.cpu(), s.cpu(), shape, pad)
    assert torch.equal(y.cpu(), want)


def test_quantized_all_reduce_tree_over_one_nccl_rank(gen, monkeypatch):
    """The compressed all-reduce over a world of one rank on NCCL: one
    quantize and one dequantize launch a leaf, and the bytes of the
    plain versions (over one rank the sum is the dequantized payload);
    the reduce-scatter over one rank has no hop and returns its input.
    The suite's conftest forces the CPU for every process, so this
    test lifts that to join the world as a worker on the card does."""
    import torch.distributed as dist

    from dlrover_tpu_torch import runtime
    from dlrover_tpu_torch.common.messages import find_free_port

    monkeypatch.delenv("DLROVER_TPU_FORCE_CPU", raising=False)
    monkeypatch.delenv(runtime.DIST_BACKEND_ENV, raising=False)
    x = torch.randn((333, 77), generator=gen, device="cuda")
    runtime.join_world(f"127.0.0.1:{find_free_port()}", 1, 0)
    try:
        assert dist.get_backend() == "nccl"
        before = _build.launch_counts()
        out = tq.quantized_all_reduce_tree({"g": x}, block=256)["g"]
        torch.cuda.synchronize()
        after = _build.launch_counts()
        same = tq.quantized_reduce_scatter(x, block=256)
    finally:
        runtime.shutdown()
    assert after["quant_int8"] - before["quant_int8"] == 1
    assert after["dequant_int8"] - before["dequant_int8"] == 1
    want = tq.dequantize_any(*tq.quantize_any(x.cpu(), 256))
    assert out.shape == x.shape and torch.equal(out.cpu(), want)
    assert torch.equal(same, x)


def _int8_state(shapes, block, seed):
    """A nonzero Int8AdamState-like numpy state (count 5): quantized
    random moments in the [1, padded] layout."""
    rng = np.random.default_rng(seed)
    state = {k: [] for k in ("q_mu", "s_mu", "q_nu", "s_nu")}
    for shape in shapes:
        for m, x in (("mu", rng.standard_normal(shape) * 1e-3),
                     ("nu", np.abs(rng.standard_normal(shape)) * 1e-3)):
            q, s, _, _ = tq.quantize_any(
                torch.from_numpy(x.astype(np.float32)), block)
            state["q_" + m].append(q.numpy())
            state["s_" + m].append(s.numpy())
    state["count"] = 5
    return state


def test_int8_adam_step_on_the_card_matches_cpu(gen):
    """One Int8AdamW step (weight decay, nonzero state) on the card and
    on CPU copies: the int8 levels equal, or one apart in at most 0.1%
    of the entries, the scales within 1e-6 relative (torch's CPU f32
    sqrt is one ulp off the correctly rounded root that CUDA's gives for
    some 0.65% of inputs), the params within 2^-20 relative plus lr x
    2^-6; kernels 5 and 6 each launched twice a leaf."""
    from dlrover_tpu_torch.optim.low_precision import (
        int8_adam,
        int8_adam_state_from_numpy,
    )

    shapes = [(512, 256), (256,), (7, 13)]
    lr, block = 1e-3, 256
    rng = np.random.default_rng(1)
    ps = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    gs = [(rng.standard_normal(s) * 1e-2).astype(np.float32) for s in shapes]
    state = _int8_state(shapes, block, 2)
    opts, params = {}, {}
    for dev in ("cpu", "cuda"):
        params[dev] = [torch.tensor(p, device=dev) for p in ps]
        opts[dev] = int8_adam(lr, weight_decay=1e-2)(params[dev])
        int8_adam_state_from_numpy(opts[dev], state)
        for p, g in zip(params[dev], gs):
            p.grad = torch.tensor(g, device=dev)
    before = _build.launch_counts()
    opts["cuda"].step()
    torch.cuda.synchronize()
    after = _build.launch_counts()
    for name in ("dequant_int8", "quant_int8"):
        assert after[name] - before[name] == 2 * len(shapes)
    opts["cpu"].step()
    for pc, pg in zip(params["cpu"], params["cuda"]):
        got = pg.cpu()
        tol = 2.0 ** -20 * pc.abs() + lr * 2.0 ** -6
        assert ((got - pc).abs() <= tol).all()
        sc, sg = opts["cpu"].state[pc], opts["cuda"].state[pg]
        for m in ("mu", "nu"):
            diff = (sg["q_" + m].cpu().int() - sc["q_" + m].int()).abs()
            assert diff.max() <= 1 and (diff > 0).float().mean() <= 1e-3
            rel = ((sg["s_" + m].cpu() - sc["s_" + m]).abs()
                   / sc["s_" + m].abs())
            assert rel.max() <= 1e-6
    assert opts["cuda"].count == opts["cpu"].count == 6


def test_trainer_with_int8_adam_on_the_card(gen, tmp_path, monkeypatch):
    """Three Trainer steps of a small Llama with int8_adam: the falling
    loss, and the dequant and quant kernels each launched exactly twice
    a param leaf and step (both moments of every leaf, the zero state of
    step 1 included, as in JAX)."""
    _int8_adam_trainer(gen, tmp_path, monkeypatch, 256)


def test_trainer_with_int8_adam_block_512_on_the_card(gen, tmp_path,
                                                      monkeypatch):
    """The same with int8_adam(block=512), which JAX trains with: every
    quantize launch on the warp-a-row kernel, every dequantize on the
    power-of-two kernel."""
    counts = _int8_adam_trainer(gen, tmp_path, monkeypatch, 512)
    assert counts["quant_int8_any"] == counts["quant_int8"]
    assert counts["dequant_int8_any"] == 0


def _int8_adam_trainer(gen, tmp_path, monkeypatch, block):
    """Three Trainer steps with int8_adam at `block`, checked as the
    tests above say; returns the launch counts."""
    from dlrover_tpu_torch.models import llama as tllama
    from dlrover_tpu_torch.optim import int8_adam
    from dlrover_tpu_torch.trainer.elastic.trainer import ElasticTrainer
    from dlrover_tpu_torch.trainer.trainer import (
        Trainer,
        TrainerCallback,
        TrainingArguments,
    )

    monkeypatch.setenv("DLROVER_TPU_RUNTIME_METRICS_PATH",
                       str(tmp_path / "runtime.json"))
    monkeypatch.setenv("DLROVER_TPU_CHIP_METRICS_PATH",
                       str(tmp_path / "chip.json"))
    cfg = tllama.LlamaConfig.tiny(dim=256, n_heads=4, n_kv_heads=2,
                                  mlp_dim=512, vocab_size=512,
                                  attn_impl="auto", remat=True)
    et = ElasticTrainer(
        lambda g: tllama.init_params(cfg, g, dtype=torch.float32),
        lambda p, b: tllama.loss_fn(cfg, p, b),
        int8_adam(1e-3, weight_decay=1e-4, block=block),
        global_batch_size=4, max_per_replica_batch=2,
    )
    tokens = torch.randint(0, cfg.vocab_size, (4, 129), generator=gen,
                           device="cuda")
    losses = []

    class Record(TrainerCallback):
        def on_log(self, trainer, state, logs):
            losses.append(logs["loss"])

    state = et.init_state(gen)
    leaves = len(state["opt_state"].state)
    assert leaves == 12
    _build.reset_launch_counts()
    Trainer(et, TrainingArguments(max_steps=3, logging_steps=1,
                                  resume=False),
            train_data=[{"tokens": tokens}] * 3,
            callbacks=[Record()]).train(state)
    torch.cuda.synchronize()
    counts = _build.launch_counts()
    assert counts["dequant_int8"] == counts["quant_int8"] == 2 * leaves * 3
    assert counts["flash_fwd"] == 2 * cfg.n_layers * 2 * 3
    assert len(losses) == 3 and losses[-1] < losses[0]
    return counts


def test_trainer_fed_by_the_master_on_the_card(gen, tmp_path, monkeypatch):
    """The port's LocalJobMaster, its client and an ElasticDataset over
    IndexShardingClient feed two Trainer steps of a small Llama on the
    card: every sample read once, the dataset finished, the steps and
    the model's size at the master, and the flash kernels launched as
    the path calls them (forward twice a layer and microbatch under
    remat "full", each backward once), all on their wgmma variants."""
    from dlrover_tpu_torch.agent.master_client import MasterClient
    from dlrover_tpu_torch.master.master import LocalJobMaster
    from dlrover_tpu_torch.models import llama as tllama
    from dlrover_tpu_torch.trainer.elastic.data import ElasticDataset
    from dlrover_tpu_torch.trainer.elastic.trainer import ElasticTrainer
    from dlrover_tpu_torch.trainer.trainer import Trainer, TrainingArguments

    monkeypatch.setenv("DLROVER_TPU_RUNTIME_METRICS_PATH",
                       str(tmp_path / "runtime.json"))
    monkeypatch.setenv("DLROVER_TPU_CHIP_METRICS_PATH",
                       str(tmp_path / "chip.json"))
    cfg = tllama.LlamaConfig.tiny(dim=256, n_heads=2, n_kv_heads=1,
                                  mlp_dim=512, vocab_size=512,
                                  attn_impl="auto", remat=True)
    et = ElasticTrainer(
        lambda g: tllama.init_params(cfg, g, dtype=torch.float32),
        lambda p, b: tllama.loss_fn(cfg, p, b),
        lambda params: torch.optim.AdamW(params, lr=1e-3),
        global_batch_size=4, max_per_replica_batch=2,
    )
    rows = np.random.default_rng(0).integers(0, cfg.vocab_size,
                                             size=(8, 129))
    read = []

    def read_sample(i):
        read.append(i)
        return {"tokens": rows[i]}

    master = LocalJobMaster(num_nodes=1, poll_interval=0.05)
    master.start()
    client = MasterClient(master.addr, node_id=0)
    try:
        client.register_node(rank=0)
        ds = ElasticDataset("rows", len(rows), 4, read_sample,
                            master_client=client)
        state = et.init_state(gen)
        _build.reset_launch_counts()
        Trainer(et, TrainingArguments(max_steps=2, logging_steps=1,
                                      resume=False),
                train_data=ds.batches(4), master_client=client).train(state)
        torch.cuda.synchronize()
        counts = _build.launch_counts()
        assert sorted(read) == list(range(8))
        assert master.servicer.task_manager.get_dataset("rows").finished()
        assert master.servicer.speed_monitor.global_step == 2
        per = cfg.n_layers * et.grad_accum * 2
        assert counts["flash_fwd"] == counts["flash_fwd_wgmma"] == 2 * per
        for name in ("flash_bwd_dq", "flash_bwd_dkv"):
            assert counts[name] == counts[name + "_wgmma"] == per
    finally:
        client.close()
        master.stop()


@pytest.mark.parametrize(
    "t,k,o,block",
    [(1, 256, 40, 256), (8, 512, 200, 256), (8, 4096, 1024, 256),
     (77, 1024, 300, 128), (16, 128, 72, 64), (130, 512, 136, 16),
     (300, 256, 200, 64),
     # the prefill kernel's edges: one token past the decode kernel,
     # either side of its 128- / 256-token tiles, ragged output tiles,
     # one chunk of K and the MLP's 14336, the smallest block
     (17, 64, 136, 16), (64, 128, 200, 64), (65, 4096, 1000, 256),
     (128, 14336, 136, 256), (129, 128, 1000, 16), (256, 4096, 200, 64),
     (257, 64, 1000, 64), (1000, 4096, 1000, 16), (1024, 14336, 200, 256),
     (1024, 4096, 136, 64)],
)
def test_dqmm_kernel_matches_plain(gen, t, k, o, block):
    w = torch.randn((o, k), generator=gen, device="cuda")
    q8, s8 = tq.quantize_int8(w, block)
    qw = tq.QuantizedWeight(q8, s8, block)
    x = torch.randn((t, k), generator=gen, device="cuda").bfloat16()
    before = _build.launch_counts()["dqmm"]
    y = tq.quantized_matmul(x, qw)
    ref = tq.quantized_matmul_reference(x, qw)
    torch.cuda.synchronize()
    assert _build.launch_counts()["dqmm"] == before + 1
    assert y.shape == (t, o) and y.dtype == torch.bfloat16
    err = (y.float() - ref.float()).abs().max().item()
    assert err <= DQMM_TOL * ref.float().abs().max().item()


# the Llama-3-8B matmul weights as (K, O): wq / wo, wk / wv, w_gate /
# w_up, w_down, lm_head
LLAMA3_8B_WEIGHTS = ((4096, 4096), (4096, 1024), (4096, 14336),
                     (14336, 4096), (4096, 128256))


def _qweight(gen, o, k, block):
    """A random weight quantized at `block` (the plain quantizer for
    blocks the quantize kernel does not take)."""
    w = torch.randn((o, k), generator=gen, device="cuda") * k ** -0.5
    quant = tq.quantize_int8 if block <= 256 else tq._quantize_plain
    return tq.QuantizedWeight(*quant(w, block), block)


def _check_decode_tma(gen, qw, ts):
    for t in ts:
        x = torch.randn((t, qw.q8.shape[1]), generator=gen,
                        device="cuda").bfloat16()
        before = _build.launch_counts()
        y = tq.quantized_matmul(x, qw)
        after = _build.launch_counts()
        ref = tq.quantized_matmul_reference(x, qw)
        torch.cuda.synchronize()
        assert after["dqmm"] == before["dqmm"] + 1
        assert after["dqmm_decode_tma"] == before["dqmm_decode_tma"] + 1
        assert after["dqmm_ws"] == before["dqmm_ws"]
        assert y.shape == (t, qw.q8.shape[0]) and y.dtype == torch.bfloat16
        err = (y.float() - ref.float()).abs().max().item()
        assert err <= DQMM_TOL * ref.float().abs().max().item(), (t, err)


@pytest.mark.parametrize("k,o", LLAMA3_8B_WEIGHTS,
                         ids=["wq", "wk", "w_gate", "w_down", "lm_head"])
def test_dqmm_decode_tma_at_the_llama3_8b_shapes(gen, k, o):
    """The TMA-ring decode kernel, one launch a product, against the
    plain version at T = 1, 7, 8, 9 and 16 (block 256)."""
    _check_decode_tma(gen, _qweight(gen, o, k, 256), (1, 7, 8, 9, 16))


@pytest.mark.parametrize(
    "o,k,block", [(40, 64, 64), (72, 128, 128), (136, 64, 64),
                  (200, 128, 64), (200, 4096, 128), (1000, 192, 64),
                  (64, 4096, 512)],
)
def test_dqmm_decode_tma_ragged_shapes(gen, o, k, block):
    """Ragged outputs (a tile's rows past O), a K shorter than a stage or
    not a multiple of it, and blocks 64 to 512."""
    _check_decode_tma(gen, _qweight(gen, o, k, block), (1, 7, 8, 9, 16))


def test_dqmm_decode_tma_is_deterministic(gen):
    """Two runs give the same bits where K splits a tile over blocks
    (wk / wv: 8 blocks a tile; w_down: up to 5) and where it does not."""
    for k, o in ((4096, 1024), (14336, 4096), (64, 200)):
        qw = _qweight(gen, o, k, 64 if k == 64 else 256)
        x = torch.randn((8, k), generator=gen, device="cuda").bfloat16()
        a = tq.quantized_matmul(x, qw)
        b = tq.quantized_matmul(x, qw)
        torch.cuda.synchronize()
        assert torch.equal(a, b)


@pytest.mark.parametrize("block", [16, 32])
def test_dqmm_decode_mma_keeps_blocks_16_and_32(gen, block):
    """T <= 16 at blocks 16 and 32 (the quantizer gives them to no K that
    the kernel takes) stays on the mma.sync decode kernel, and that kernel
    still matches the plain version where asked for at block 256."""
    qw = _qweight(gen, 136, 512, block)
    x = torch.randn((8, 512), generator=gen, device="cuda").bfloat16()
    before = _build.launch_counts()
    y = tq.quantized_matmul(x, qw)
    after = _build.launch_counts()
    ref = tq.quantized_matmul_reference(x, qw)
    assert after["dqmm"] == before["dqmm"] + 1
    assert after["dqmm_decode_tma"] == before["dqmm_decode_tma"]
    assert (y.float() - ref.float()).abs().max().item() <= (
        DQMM_TOL * ref.float().abs().max().item())
    qw = _qweight(gen, 14336, 4096, 256)
    x = torch.randn((8, 4096), generator=gen, device="cuda").bfloat16()
    before = _build.launch_counts()["dqmm_decode_tma"]
    y = tq._dqmm_cuda(x, qw, decode="mma")
    ref = tq.quantized_matmul_reference(x, qw)
    torch.cuda.synchronize()
    assert _build.launch_counts()["dqmm_decode_tma"] == before
    assert (y.float() - ref.float()).abs().max().item() <= (
        DQMM_TOL * ref.float().abs().max().item())


def test_dqmm_ws_counts_prefill_launches_only(gen):
    """`dqmm_ws` counts one launch of the prefill kernel for every
    product with T > 16, and none for T <= 16 (the decode kernel);
    `dqmm` counts every launch."""
    w = torch.randn((200, 512), generator=gen, device="cuda")
    qw = tq.QuantizedWeight(*tq.quantize_int8(w, 64), 64)
    for t, ws in ((1, 0), (16, 0), (17, 1), (1024, 1)):
        x = torch.randn((t, 512), generator=gen, device="cuda").bfloat16()
        before = _build.launch_counts()
        tq.quantized_matmul(x, qw)
        after = _build.launch_counts()
        assert after["dqmm"] - before["dqmm"] == 1
        assert after["dqmm_ws"] - before["dqmm_ws"] == ws
    torch.cuda.synchronize()


def test_dqmm_prefill_on_a_layer_slice(gen):
    """T = 1024 against layer 3 of a stacked weight: the TMA maps start
    inside the allocation, not at its base."""
    layers, o, k, block = 4, 520, 4096, 256
    w = torch.randn((layers * o, k), generator=gen, device="cuda")
    q8, s8 = tq.quantize_int8(w, block)
    stack = tq.QuantizedWeight(q8.reshape(layers, o, k),
                               s8.reshape(layers, o, k // block), block)
    layer = stack[3]
    assert layer.q8.data_ptr() != stack.q8.data_ptr()
    x = torch.randn((1024, k), generator=gen, device="cuda").bfloat16()
    before = _build.launch_counts()["dqmm_ws"]
    y = tq.quantized_matmul(x, layer)
    ref = tq.quantized_matmul_reference(x, layer)
    torch.cuda.synchronize()
    assert _build.launch_counts()["dqmm_ws"] == before + 1
    err = (y.float() - ref.float()).abs().max().item()
    assert err <= DQMM_TOL * ref.float().abs().max().item()


def test_dqmm_kernel_refuses_what_it_cannot_take(gen):
    w = torch.randn((64, 96), generator=gen, device="cuda")
    q8, s8 = tq.quantize_int8(w, 32)
    x = torch.randn((4, 96), generator=gen, device="cuda").bfloat16()
    # scales of another block than the weight says
    with pytest.raises(ValueError, match="does not take"):
        tq.quantized_matmul(x, tq.QuantizedWeight(q8, s8[:, :1].contiguous(),
                                                  32))
    w = torch.randn((64, 128), generator=gen, device="cuda")
    q8, s8 = tq.quantize_int8(w, 64)
    with pytest.raises(ValueError, match="dtype"):
        tq.quantized_matmul(torch.zeros((4, 128), device="cuda").half(),
                            tq.QuantizedWeight(q8, s8, 64))


def test_dqmm_checks_a_layer_weight_once(gen):
    """The wrapper checks a weight on its first launch and marks it; a
    stacked weight hands out the same layer slice every time, so later
    launches skip the checks. A weight the kernel refuses still raises."""
    w = torch.randn((2, 96, 256), generator=gen, device="cuda")
    q8, s8 = tq.quantize_int8(w.reshape(-1, 256), 64)
    stack = tq.QuantizedWeight(q8.reshape(2, 96, 256),
                               s8.reshape(2, 96, 4), 64)
    x = torch.randn((3, 256), generator=gen, device="cuda").bfloat16()
    y = tq.quantized_matmul(x, stack[1])
    assert stack[1]._checked_on == x.get_device()
    ref = tq.quantized_matmul_reference(x, stack[1])
    assert (y.float() - ref.float()).abs().max().item() <= (
        DQMM_TOL * ref.float().abs().max().item())
    bad = tq.QuantizedWeight(stack.q8[0],
                             stack.s8[0, :, :2].contiguous(), 64)
    with pytest.raises(ValueError, match="does not take"):
        tq.quantized_matmul(x, bad)


def test_int8_engine_on_the_card(gen):
    """The int8 engine on the default device: both int8 kernels ran,
    every request finished, and the streams are valid tokens."""
    from dlrover_tpu_torch.models import llama as tllama
    from dlrover_tpu_torch.serving.engine import ContinuousBatcher

    cfg = tllama.LlamaConfig.tiny(dim=256, n_heads=4, n_kv_heads=2,
                                  mlp_dim=512, attn_impl="auto")
    params = tllama.init_params(cfg, gen)
    _build.reset_launch_counts()
    eng = ContinuousBatcher(cfg, params, n_slots=2, max_len=64,
                            max_new_tokens=6, weight_quant="int8",
                            kv_layout="paged")
    assert eng.weight_quant_path == "int8:kernel"
    assert _build.launch_counts()["quant_int8"] == 7 * cfg.n_layers + 1
    outs = eng.generate_all([[1, 2, 3], [5] * 20, [9, 8, 7, 6]])
    counts = _build.launch_counts()
    assert [len(o) for o in outs] == [6, 6, 6]
    assert all(0 <= int(t) < cfg.vocab_size for o in outs for t in o)
    per_forward = 7 * cfg.n_layers + 1
    assert counts["dqmm"] >= (eng.admissions + eng.decode_steps) * per_forward


def _rel_err(got, want):
    return ((got.float() - want.float()).abs().max()
            / want.float().abs().max()).item()


@pytest.mark.parametrize(
    "b,s_q,s_k,h,kv,d,causal",
    [(1, 77, 77, 32, 8, 128, True), (2, 200, 200, 8, 4, 64, True),
     (1, 48, 48, 4, 2, 40, False), (1, 130, 130, 4, 4, 128, False),
     (1, 256, 256, 8, 2, 64, True), (2, 1, 300, 8, 2, 128, False),
     (1, 2049, 2049, 4, 1, 128, True)],
)
def test_flash_bwd_kernels_match_plain(gen, b, s_q, s_k, h, kv, d, causal):
    def rand(*shape):
        return torch.randn(shape, generator=gen, device="cuda").bfloat16()

    q, k, v = rand(b, s_q, h, d), rand(b, s_k, kv, d), rand(b, s_k, kv, d)
    do = rand(b, s_q, h, d)
    scale = d ** -0.5
    o, lse = tfa._fwd(q, k, v, causal, scale)
    before = _build.launch_counts()
    got = tfa._bwd(q, k, v, o, lse, do, causal, scale)
    want = tfa._bwd_plain(q, k, v, o, lse, do, causal, scale)
    torch.cuda.synchronize()
    after = _build.launch_counts()
    assert after["flash_bwd_dq"] == before["flash_bwd_dq"] + 1
    assert after["flash_bwd_dkv"] == before["flash_bwd_dkv"] + 1
    for name, x, y in zip(("dq", "dk", "dv"), got, want):
        assert x.shape == y.shape and x.dtype == torch.bfloat16, name
        assert torch.isfinite(x).all(), name
        assert _rel_err(x, y) <= BWD_REL, (name, _rel_err(x, y))


def test_flash_attention_grads_through_the_kernels(gen):
    """`flash_attention` on CUDA tensors is differentiable through the
    forward and both backward kernels, and its gradients agree with
    autograd through plain attention on the same bf16 inputs."""
    from dlrover_tpu_torch.ops import attention as tattn

    def leaf(*shape):
        return torch.randn(shape, generator=gen, device="cuda").bfloat16(
        ).requires_grad_()

    q, k, v = leaf(1, 300, 8, 128), leaf(1, 300, 2, 128), leaf(1, 300, 2, 128)
    g = torch.randn((1, 300, 8, 128), generator=gen, device="cuda").bfloat16()
    _build.reset_launch_counts()
    grads = torch.autograd.grad(tfa.flash_attention(q, k, v), (q, k, v), g)
    counts = _build.launch_counts()
    assert (counts["flash_fwd"], counts["flash_fwd_wgmma"],
            counts["flash_bwd_dq"], counts["flash_bwd_dkv"]) == (1, 1, 1, 1)
    assert counts["flash_bwd_dq_wgmma"] == counts["flash_bwd_dkv_wgmma"] == 1
    ref = torch.autograd.grad(tattn.reference_attention(q, k, v), (q, k, v), g)
    for name, x, y in zip("qkv", grads, ref):
        # the reference rounds P to bf16 once, after the softmax, and
        # its dS not at all; 2^-5 of the largest |grad|
        assert _rel_err(x, y) <= 2 ** -5, (name, _rel_err(x, y))


def test_flash_bwd_refuses_what_it_cannot_take(gen):
    q = torch.randn((1, 16, 4, 64), generator=gen, device="cuda")
    lse = torch.zeros((1, 4, 16), device="cuda")
    with pytest.raises(ValueError, match="bfloat16"):
        tfa._bwd(q, q, q, q, lse, q, True, 0.125)
    # head_dim 520: above the kernels' (and JAX's) 512
    qb = torch.randn((1, 16, 4, 520), generator=gen, device="cuda").bfloat16()
    with pytest.raises(ValueError, match="do not take"):
        tfa._bwd(qb, qb, qb, qb, lse, qb, True, 520 ** -0.5)


def _check_bwd(gen, b, s_q, s_k, h, kv, d, causal, variant):
    """One backward through both kernels, on the variant `_bwd_variant`
    must pick, held to `_bwd_plain` within BWD_REL of the largest |grad|
    of each of dq, dk, dv (with a floor of 2^-10: at S=1 dq and dk
    vanish, dP == delta, and both sides hold only f32 rounding noise);
    the call bumps each kernel's counter by one, and its wgmma counter by
    one exactly when the variant is wgmma."""
    def rand(*shape):
        return torch.randn(shape, generator=gen, device="cuda").bfloat16()

    assert tfa._bwd_variant(b, s_q, s_k, h, kv, d, causal) == variant
    q, k, v = rand(b, s_q, h, d), rand(b, s_k, kv, d), rand(b, s_k, kv, d)
    do = rand(b, s_q, h, d)
    scale = d ** -0.5
    o, lse = tfa._fwd(q, k, v, causal, scale)
    before = _build.launch_counts()
    got = tfa._bwd(q, k, v, o, lse, do, causal, scale)
    after = _build.launch_counts()
    want = tfa._bwd_plain(q, k, v, o, lse, do, causal, scale)
    torch.cuda.synchronize()
    wg = int(variant == "wgmma")
    for name in ("flash_bwd_dq", "flash_bwd_dkv"):
        assert after[name] == before[name] + 1, name
        assert after[name + "_wgmma"] == before[name + "_wgmma"] + wg, name
    for name, x, y in zip(("dq", "dk", "dv"), got, want):
        assert x.shape == y.shape and x.dtype == torch.bfloat16, name
        assert torch.isfinite(x).all(), name
        err = (x.float() - y.float()).abs().max().item()
        tol = BWD_REL * max(y.float().abs().max().item(), 2 ** -10)
        assert err <= tol, (name, b, s_q, h, kv, d, causal, err, tol)


@pytest.mark.parametrize("d", [64, 128])
def test_flash_bwd_wgmma_below_one_tile(gen, d):
    """Every length below one 64-row (key) tile of the wgmma backward
    (TMA zero-fills the rows past S; keys past S are masked), B=2, GQA
    4, causal and not."""
    for s in range(1, 64):
        for causal in (True, False):
            _check_bwd(gen, 2, s, s, 8, 2, d, causal, "wgmma")


@pytest.mark.parametrize("n_rep", [1, 4, 8])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("s", [77, 128, 200, 2049])
def test_flash_bwd_wgmma_matches_plain(gen, s, d, n_rep):
    """The wgmma backward at ragged tiles (77, 200, 2049: one row past
    16 blocks of 128), an exact tile (128) and across both 2-stage
    rings, B=2, GQA ratios 1, 4 and 8, causal and not."""
    for causal in (True, False):
        _check_bwd(gen, 2, s, s, 8, 8 // n_rep, d, causal, "wgmma")


@pytest.mark.parametrize(
    "b,s_q,s_k,h,kv,d,causal",
    [(1, 48, 48, 4, 2, 40, True), (2, 77, 77, 8, 2, 40, False),
     (1, 200, 200, 4, 2, 256, True), (2, 130, 130, 4, 4, 256, False),
     (1, 128, 128, 4, 1, 136, True), (1, 65, 65, 4, 2, 192, False),
     (2, 1, 300, 8, 2, 256, False), (2, 1, 300, 8, 2, 64, False)],
)
def test_flash_bwd_mma_matches_plain(gen, b, s_q, s_k, h, kv, d, causal):
    """The mma.sync backward at the shapes the wgmma one refuses:
    head_dim 40, and 136 to 256 (two blocks of 128 output columns
    each, S and dP over the full head_dim), and the single query
    (q_len 1 against 300 keys)."""
    _check_bwd(gen, b, s_q, s_k, h, kv, d, causal, "mma")


@pytest.mark.parametrize("d", [264, 384, 512])
def test_flash_fwd_bwd_mma_at_head_dim_above_256(gen, d):
    """head_dim 264-512 (JAX's gate reaches 512): the forward on the
    mma.sync kernel with O's columns split over blocks of 256 and K/V
    single-buffered, the backward's dq and dk/dv kernels with 32-row
    streamed tiles; held to the plain versions (forward within TOL and
    LSE 1e-3, backward within BWD_REL), causal and not, B=1, S=1024 (and
    a ragged 200), H=8, KV=2."""
    for s, causal in ((1024, True), (200, False)):
        q, k, v = _flash_case(gen, 1, s, 8, 2, d)
        assert tfa.supports(q, k)
        before = _build.launch_counts()
        o, lse = tfa._fwd(q, k, v, causal, d ** -0.5)
        after = _build.launch_counts()
        o_ref, lse_ref = tfa._fwd_plain(q, k, v, causal, d ** -0.5)
        torch.cuda.synchronize()
        assert after["flash_fwd"] == before["flash_fwd"] + 1
        assert after["flash_fwd_wgmma"] == before["flash_fwd_wgmma"]
        assert (o.float() - o_ref.float()).abs().max().item() < TOL
        assert (lse - lse_ref).abs().max().item() < 1e-3
        _check_bwd(gen, 1, s, s, 8, 2, d, causal, "mma")


def test_flash_attention_trains_at_head_dim_256(gen):
    """`flash_attention` at head_dim 256 (q/k/v [1, 128, 4, 256], the
    shape of ROADMAP's fault F3): the backward runs through the
    mma.sync kernels and its gradients agree with autograd through
    plain attention (2^-5 of the largest |grad|, as below)."""
    from dlrover_tpu_torch.ops import attention as tattn

    def leaf(*shape):
        return torch.randn(shape, generator=gen, device="cuda").bfloat16(
        ).requires_grad_()

    q, k, v = leaf(1, 128, 4, 256), leaf(1, 128, 4, 256), leaf(1, 128, 4, 256)
    g = torch.randn((1, 128, 4, 256), generator=gen, device="cuda").bfloat16()
    _build.reset_launch_counts()
    grads = torch.autograd.grad(tfa.flash_attention(q, k, v), (q, k, v), g)
    counts = _build.launch_counts()
    assert (counts["flash_bwd_dq"], counts["flash_bwd_dkv"],
            counts["flash_bwd_dq_wgmma"], counts["flash_bwd_dkv_wgmma"]) == (
        1, 1, 0, 0)
    ref = torch.autograd.grad(tattn.reference_attention(q, k, v), (q, k, v), g)
    for name, x, y in zip("qkv", grads, ref):
        assert _rel_err(x, y) <= 2 ** -5, (name, _rel_err(x, y))


def test_auto_attention_takes_the_reference_where_flash_refuses(gen):
    """impl="auto" on CUDA tensors returns `reference_attention` (bit for
    bit, no kernel launched) for what the flash kernels refuse:
    segment_ids, q_len != k_len with q_len > 1, head_dim below 32 or
    above 512; impl="flash" raises for each."""
    from dlrover_tpu_torch.ops import attention as tattn

    def rand(*shape):
        return torch.randn(shape, generator=gen, device="cuda").bfloat16()

    seg = torch.tensor([[0] * 8 + [1] * 8], device="cuda")
    cases = [
        (rand(1, 16, 4, 64), rand(1, 16, 2, 64), seg),
        (rand(1, 8, 4, 64), rand(1, 16, 2, 64), None),
        (rand(1, 16, 4, 16), rand(1, 16, 2, 16), None),
        (rand(1, 16, 4, 520), rand(1, 16, 2, 520), None),
    ]
    for q, k, seg_ids in cases:
        _build.reset_launch_counts()
        got = tattn.dot_product_attention(q, k, k, segment_ids=seg_ids)
        want = tattn.reference_attention(q, k, k, segment_ids=seg_ids)
        torch.cuda.synchronize()
        assert torch.equal(got, want), (tuple(q.shape), tuple(k.shape))
        assert set(_build.launch_counts().values()) == {0}
        with pytest.raises(ValueError):
            tattn.dot_product_attention(q, k, k, segment_ids=seg_ids,
                                        impl="flash")
    # what the kernels take, "auto" sends to them
    q, k = rand(1, 16, 4, 64), rand(1, 16, 2, 64)
    _build.reset_launch_counts()
    tattn.dot_product_attention(q, k, k)
    assert _build.launch_counts()["flash_fwd"] == 1


def test_train_step_with_kernels_matches_reference_attention(gen):
    """A small Llama in bf16 compute from f32 params, with the flash
    kernels (attn_impl="auto" on the card, remat "full") against plain
    attention (`attn_impl="reference"`) on the same params and tokens:
    every gradient leaf within 5e-2 of its norm (L2 of the difference;
    the kernels round P and dS to bf16 where plain attention rounds P
    after the softmax and dP, carried through two layers' backward),
    and one AdamW step of `accelerate` launches each kernel as often as
    the path calls it, with loss within 1e-2 and grad_norm within 2e-2
    relative of the plain-attention step."""
    import dataclasses

    from dlrover_tpu_torch.models import llama as tllama
    from dlrover_tpu_torch.parallel.accelerate import accelerate
    from dlrover_tpu_torch.parallel.accelerate import param_leaves

    cfg = tllama.LlamaConfig.tiny(dim=256, n_heads=4, n_kv_heads=2,
                                  mlp_dim=512, vocab_size=512,
                                  attn_impl="auto", remat=True)
    init = tllama.init_params(cfg, gen, dtype=torch.float32)
    for p in param_leaves(init):
        p.requires_grad_(True)
    tokens = torch.randint(0, cfg.vocab_size, (2, 257), generator=gen,
                           device="cuda")
    grads, metrics, counts = {}, {}, {}
    for impl in ("auto", "reference"):
        c = dataclasses.replace(cfg, attn_impl=impl)
        loss, _ = tllama.loss_fn(c, init, {"tokens": tokens})
        grads[impl] = torch.autograd.grad(loss, param_leaves(init))
        acc = accelerate(
            lambda g: {k: ({kk: vv.detach().clone() for kk, vv in v.items()}
                           if isinstance(v, dict) else v.detach().clone())
                       for k, v in init.items()},
            lambda p, b, c=c: tllama.loss_fn(c, p, b),
            lambda ps: torch.optim.AdamW(ps, lr=1e-4, weight_decay=1e-4),
        )
        state = acc.init(gen)
        _build.reset_launch_counts()
        state, metrics[impl] = acc.train_step(state, {"tokens": tokens})
        torch.cuda.synchronize()
        counts[impl] = _build.launch_counts()
    for a, r in zip(grads["auto"], grads["reference"]):
        assert (a - r).norm().item() <= 5e-2 * r.norm().item()
    ck, cr = counts["auto"], counts["reference"]
    assert (ck["flash_fwd"], ck["flash_bwd_dq"], ck["flash_bwd_dkv"]) == (
        2 * cfg.n_layers, cfg.n_layers, cfg.n_layers)
    assert ck["flash_fwd_wgmma"] == ck["flash_fwd"]   # head_dim 64
    assert ck["flash_bwd_dq_wgmma"] == ck["flash_bwd_dq"]
    assert ck["flash_bwd_dkv_wgmma"] == ck["flash_bwd_dkv"]
    assert cr["flash_fwd"] == cr["flash_bwd_dq"] == 0
    mk, mr = metrics["auto"], metrics["reference"]
    assert abs(mk["loss"].item() - mr["loss"].item()) <= (
        1e-2 * mr["loss"].item())
    assert abs(mk["grad_norm"].item() - mr["grad_norm"].item()) <= (
        2e-2 * mr["grad_norm"].item())


def _plain_ce(x, head, targets, mask):
    """The materialized f32 loss sum of fused_cross_entropy's inputs."""
    logits = x.float() @ head.float()
    nll = torch.nn.functional.cross_entropy(
        logits.flatten(0, 1), targets.flatten().long(), reduction="none")
    return (nll * mask.flatten()).sum()


@pytest.mark.parametrize("tied", [False, True], ids=["head", "embed.T"])
def test_fused_ce_matches_the_plain_loss(gen, tied):
    """bf16 hidden states and head at the train path's S - 1 = 2047
    (7 chunks of 292 + a tail of 3), a 32000-class head, masked: the
    loss sum, dx and dhead against the materialized f32 loss."""
    from dlrover_tpu_torch.ops.fused_ce import fused_cross_entropy

    b, s, d, v = 2, 2047, 256, 32000
    x = torch.randn((b, s, d), generator=gen, device="cuda").bfloat16()
    w = (torch.randn((v, d) if tied else (d, v), generator=gen,
                     device="cuda") * 0.05).bfloat16()
    targets = torch.randint(0, v, (b, s), generator=gen, device="cuda")
    mask = (torch.rand((b, s), generator=gen, device="cuda") > 0.2).float()
    grads = {}
    for name in ("fused", "plain"):
        xi = x.clone().requires_grad_(True)
        wi = w.clone().requires_grad_(True)
        head = wi.T if tied else wi
        if name == "fused":
            loss, weight = fused_cross_entropy(xi, head, targets, mask)
            assert float(weight) == float(mask.sum())
        else:
            loss = _plain_ce(xi, head, targets, mask)
        (loss / mask.sum()).backward()
        grads[name] = (loss.detach(), xi.grad, wi.grad)
    for got, want, what in zip(grads["fused"], grads["plain"],
                               ("loss", "dx", "dhead")):
        err = (got.float() - want.float()).abs().max().item()
        assert err <= FUSED_CE_REL * want.float().abs().max().item(), what


def _ckpt_state(gen, steps=1):
    """A small AdamW train state on the card after `steps` steps."""
    from dlrover_tpu_torch.models import llama as tllama
    from dlrover_tpu_torch.parallel.accelerate import accelerate

    cfg = tllama.LlamaConfig.tiny(attn_impl="reference")
    acc = accelerate(
        lambda g: tllama.init_params(cfg, g, dtype=torch.float32),
        lambda p, b: tllama.loss_fn(cfg, p, b),
        lambda ps: torch.optim.AdamW(ps, lr=1e-3, weight_decay=1e-4),
    )
    state = acc.init(gen)
    tokens = torch.randint(0, cfg.vocab_size, (2, 33), generator=gen,
                           device="cuda")
    for _ in range(steps):
        state, _ = acc.train_step(state, {"tokens": tokens})
    return acc, state, tokens


def _host_leaves(state):
    from dlrover_tpu_torch.trainer.flash_checkpoint.engine import (
        flatten_state,
    )

    return {k: v.tobytes() for k, v in flatten_state(state)[0].items()}


def test_async_save_stages_the_pre_step_state(gen, tmp_path, monkeypatch):
    """save_to_memory_async returns after dispatching the on-device
    clone; an optimizer step issued at once rewrites params and moments
    in place, yet the staged bytes are the saved step's, bit for bit."""
    from dlrover_tpu_torch.trainer.flash_checkpoint import CheckpointEngine

    monkeypatch.setenv("DLROVER_TPU_SHM_DIR", str(tmp_path))
    acc, state, tokens = _ckpt_state(gen)
    torch.cuda.synchronize()
    saved = _host_leaves(state)
    eng = CheckpointEngine(str(tmp_path / "ck"),
                           job_name=f"cuda-ckpt-async-{id(tmp_path)}")
    try:
        eng.save_to_memory_async(1, state)
        state, _ = acc.train_step(state, {"tokens": tokens})
        eng.wait_for_staging()
        with eng.shm_handler.lock:
            meta, flat = eng.shm_handler.load_flat_state()
        assert meta.step == 1 and eng.last_staged_bytes == meta.total_bytes
        assert {k: v.tobytes() for k, v in flat.items()} == saved
        assert _host_leaves(state) != saved
    finally:
        eng.shm_handler.close(unlink=True)
        eng.close()


def test_restore_onto_card_tensors_keeps_the_optimizer_bound(
        gen, tmp_path, monkeypatch):
    """A restore into a fresh state on the card (memory, then disk)
    writes into its own tensors: every leaf bit-equal, the optimizer
    still holds those param objects, and the next step of both states
    gives the same loss and the same leaves."""
    from dlrover_tpu_torch.trainer.flash_checkpoint import CheckpointEngine

    monkeypatch.setenv("DLROVER_TPU_SHM_DIR", str(tmp_path))
    acc, state, tokens = _ckpt_state(gen, steps=2)
    eng = CheckpointEngine(str(tmp_path / "ck"),
                           job_name=f"cuda-ckpt-restore-{id(tmp_path)}")
    try:
        eng.save_to_storage(2, state)
        assert eng.wait_for_persist(2, timeout=60)
        torch.cuda.synchronize()
        want = _host_leaves(state)
        for source in ("memory", "disk"):
            acc2, fresh, _ = _ckpt_state(gen, steps=0)
            params = [p for g in fresh["opt_state"].param_groups
                      for p in g["params"]]
            ptrs = [p.data_ptr() for p in params]
            load = (eng.load_from_memory if source == "memory"
                    else eng.load_from_storage)
            step, restored = load(target=fresh)
            assert step == 2 and restored is fresh, source
            assert [p.data_ptr() for p in params] == ptrs
            assert all(p.is_cuda for p in params)
            assert set(fresh["opt_state"].state) == set(params)
            assert _host_leaves(fresh) == want, source
        a, ma = acc.train_step(state, {"tokens": tokens})
        b, mb = acc2.train_step(fresh, {"tokens": tokens})
        assert ma["loss"].item() == mb["loss"].item()
        assert _host_leaves(a) == _host_leaves(b)
    finally:
        eng.shm_handler.close(unlink=True)
        eng.close()


# -- F5: the auto dispatch follows the JAX gates -----------------------------
# (ROADMAP queue 3; the CPU decisions against the JAX gates are in
# tests/test_torch_dispatch_gates.py)

# inside JAX's paged gate but outside the kernel's instantiations: auto
# takes the kernel, as JAX does, and the kernel raises (ROADMAP queue 2)
F5_PAGED_KERNEL = [(12, 4, 64, 16), (28, 4, 128, 16), (32, 32, 96, 16),
                   (8, 2, 512, 16), (32, 32, 40, 16), (8, 2, 384, 16),
                   (32, 2, 64, 8)]
# outside JAX's gate (pages under 8 cells, head_dim past 512): the
# reference, as JAX serves them
F5_PAGED_REFERENCE = [(8, 2, 64, 4), (8, 2, 520, 16)]


def _f5_paged_inputs(gen, h, kv, d, ps, quant=False):
    b, n_pages, per_row = 2, 12, 4
    q = torch.randn((b, h, d), generator=gen, device="cuda").bfloat16()
    pages = {name: torch.randn((n_pages, ps, kv, d), generator=gen,
                               device="cuda").bfloat16()
             for name in ("k", "v")}
    if quant:
        kq, ks = tdec._kv_quantize(pages["k"].float())
        vq, vs = tdec._kv_quantize(pages["v"].float())
        pages = {"k": kq, "v": vq, "k_scale": ks.bfloat16(),
                 "v_scale": vs.bfloat16()}
    table = torch.arange(1, 1 + b * per_row, dtype=torch.int32,
                         device="cuda").reshape(b, per_row) % n_pages
    lens = torch.tensor([3, per_row * ps], dtype=torch.int32, device="cuda")
    return q, pages, table, lens


@pytest.mark.parametrize("h,kv,d,ps", F5_PAGED_REFERENCE,
                         ids=[f"h{h}-kv{kv}-d{d}-ps{ps}"
                              for h, kv, d, ps in F5_PAGED_REFERENCE])
def test_f5_paged_shapes_outside_the_jax_gate_take_the_reference(
        gen, h, kv, d, ps):
    """A paged decode JAX serves through its reference runs the
    reference under impl="auto" (no launch, the reference's own output)
    and still raises under impl="kernel"."""
    q, pages, table, lens = _f5_paged_inputs(gen, h, kv, d, ps)
    assert not tpa.use_kernel(q, pages, table)
    before = _build.launch_counts()["paged_attention"]
    got = tpa.paged_attention(q, pages, table, lens, impl="auto")
    ref = tpa.paged_attention(q, pages, table, lens, impl="reference")
    assert _build.launch_counts()["paged_attention"] == before
    assert torch.equal(got, ref)
    with pytest.raises(ValueError, match="does not take"):
        tpa.paged_attention(q, pages, table, lens, impl="kernel")


@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("h,kv,d,ps", F5_PAGED_KERNEL,
                         ids=[f"h{h}-kv{kv}-d{d}-ps{ps}"
                              for h, kv, d, ps in F5_PAGED_KERNEL])
def test_f5_paged_shapes_inside_the_jax_gate_take_the_kernel(
        gen, h, kv, d, ps, quant):
    """A paged decode JAX takes its kernel for takes the kernel under
    impl="auto" too (GQA groups 3, 7 and 16, head_dim 40, 96, 384 and
    512; bf16 and int8 pools): one launch of the split kernel, held to
    the reference within TOL."""
    q, pages, table, lens = _f5_paged_inputs(gen, h, kv, d, ps, quant)
    assert tpa.use_kernel(q, pages, table)
    assert tpa.supports(q, pages, table)
    assert tpa.kernel_variant(q.dtype, ps, kv, d, q.shape[0], quant,
                              table.shape[1], n_rep=h // kv) == "split"
    before = _build.launch_counts()
    got = tpa.paged_attention(q, pages, table, lens, impl="auto")
    after = _build.launch_counts()
    ref = tpa.paged_attention(q, pages, table, lens, impl="reference")
    torch.cuda.synchronize()
    assert after["paged_attention"] == before["paged_attention"] + 1
    assert after["paged_attention_tma"] == before["paged_attention_tma"]
    assert got.shape == ref.shape and torch.isfinite(got).all()
    err = (got.float() - ref.float()).abs().max().item()
    assert err < TOL, err


@pytest.mark.parametrize("k", [24, 96, 160, 1000])
def test_f5_dqmm_shapes_take_the_kernel(gen, k):
    """JAX takes its dequant-matmul kernel for every shape; so does the
    port: at a K whose `weight_quant_block` the decode and prefill
    kernels do not take (block 8 or 32, or K not a multiple of 64), and
    for f32 activations at any K, the general variant launches once
    (counted under "dqmm" and "dqmm_general") and agrees with the plain
    version: within DQMM_TOL of the largest |output| for bf16 x, 1e-5
    for f32 x (f32 FMA, only the order of the sums differs)."""
    block = tq.weight_quant_block(k)
    w = torch.randn((48, k), generator=gen, device="cuda")
    qw = tq.QuantizedWeight(*tq.quantize_int8(w, block), block)
    for dtype, tol in ((torch.bfloat16, DQMM_TOL), (torch.float32, 1e-5)):
        for t in (5, 77):
            x = torch.randn((t, k), generator=gen, device="cuda").to(dtype)
            before = _build.launch_counts()
            y = tq.quantized_matmul(x, qw)
            after = _build.launch_counts()
            ref = tq.quantized_matmul_reference(x, qw)
            torch.cuda.synchronize()
            assert after["dqmm"] == before["dqmm"] + 1
            assert after["dqmm_general"] == before["dqmm_general"] + 1
            assert y.dtype == dtype and y.shape == (t, 48)
            err = (y.float() - ref.float()).abs().max().item()
            assert err <= tol * ref.float().abs().max().item(), (dtype, t)


def test_f5_quant_block_512_takes_the_kernel(gen):
    """JAX quantizes and dequantizes at any block that divides the row
    with its kernels; so do the port's: block 512 (int8_adam(block=512))
    and blocks 24 and 6 each launch once and give the plain versions'
    bytes (quantize, f32 and bf16 input) and bits (dequantize, f32 and
    bf16 output)."""
    for block in (512, 24, 6):
        n = 1024 if 1024 % block == 0 else 40 * block
        x = torch.randn((3, n), generator=gen, device="cuda") * 3
        for xin in (x, x.bfloat16()):
            before = _build.launch_counts()
            q, s = tq.quantize_int8(xin, block)
            after = _build.launch_counts()
            rq, rs = tq.quantize_int8(xin.cpu(), block)
            assert after["quant_int8"] == before["quant_int8"] + 1
            assert after["quant_int8_any"] == before["quant_int8_any"] + 1
            assert torch.equal(q.cpu(), rq) and torch.equal(s.cpu(), rs)
        for out in (torch.float32, torch.bfloat16):
            before = _build.launch_counts()
            y = tq.dequantize_int8(q, s, out)
            after = _build.launch_counts()
            assert after["dequant_int8"] == before["dequant_int8"] + 1
            fast = block == 512
            assert after["dequant_int8_any"] == (
                before["dequant_int8_any"] + (0 if fast else 1))
            ref = tq.dequantize_int8(q.cpu(), s.cpu(), out)
            bits = torch.int16 if out == torch.bfloat16 else torch.int32
            assert torch.equal(y.cpu().view(bits), ref.view(bits))


def test_f5_engine_at_page_size_4_on_the_card(gen):
    """A paged engine whose auto page size is 4 (max_len 44) serves its
    decode steps through the reference, as the JAX engine does, where
    it raised before."""
    from dlrover_tpu_torch.models import llama as tllama
    from dlrover_tpu_torch.serving.engine import ContinuousBatcher

    cfg = tllama.LlamaConfig.tiny(dim=256, n_heads=4, n_kv_heads=2,
                                  mlp_dim=512, attn_impl="auto")
    params = tllama.init_params(cfg, gen)
    eng = ContinuousBatcher(cfg, params, n_slots=2, max_len=44,
                            max_new_tokens=5, kv_layout="paged")
    assert eng.page_size == 4
    before = _build.launch_counts()["paged_attention"]
    outs = eng.generate_all([[1, 2, 3], [5] * 20, [9, 8, 7, 6]])
    assert [len(o) for o in outs] == [5, 5, 5]
    assert _build.launch_counts()["paged_attention"] == before


def test_engine_pressure_prefix_and_chunks_on_the_card(gen):
    """A small paged engine on the card with a pool below the
    dense-equivalent, the prefix cache and prefill_chunk: every request
    finishes, preemption fired and resumed, the allocator is
    consistent, and the decode steps ran the paged kernel."""
    from dlrover_tpu_torch.models import llama as tllama
    from dlrover_tpu_torch.serving.engine import ContinuousBatcher

    cfg = tllama.LlamaConfig.tiny(dim=256, n_heads=4, n_kv_heads=2,
                                  mlp_dim=512, attn_impl="auto")
    params = tllama.init_params(cfg, gen)
    rng = np.random.default_rng(0)
    shared = rng.integers(1, 250, size=20).tolist()
    prompts = [shared + rng.integers(1, 250, size=int(n)).tolist()
               for n in (4, 18, 6, 11, 3, 25, 8)]
    for pc in (0, 4):
        _build.reset_launch_counts()
        eng = ContinuousBatcher(cfg, params, n_slots=3, max_len=64,
                                max_new_tokens=24, chunk=3,
                                kv_layout="paged", n_pages=6,
                                prefix_cache_rows=4, prefill_chunk=pc)
        outs = eng.generate_all(prompts)
        counts = _build.launch_counts()
        assert [len(o) for o in outs] == [min(len(p) + 24, 64) - len(p)
                                          for p in prompts]
        st = eng.paged_stats()
        assert st["swap_preemptions"] >= 1
        assert st["swap_resumes"] == st["swap_preemptions"]
        eng.allocator.check()
        assert counts["paged_attention"] >= eng.decode_steps * cfg.n_layers
        assert counts["paged_attention_tma"] == counts["paged_attention"]
        if pc:
            assert eng.prefill_stats()["prefill_chunks_total"] >= 1
            assert counts["flash_fwd"] == 0


def test_offload_names_keeps_the_tagged_activations_off_the_card(gen):
    """`apply_remat(loss, "offload_names", names)` over a small Llama's
    whole loss on the card (the policy `Strategy(remat=...)` applies):
    the loss and gradients of "full" (f32, the same products; the
    offloaded tensors come back bit for bit), and the memory the forward
    leaves on the card for the backward is "full"'s, while
    "save_names" with the same names leaves at least the tagged
    tensors' bytes more."""
    from dlrover_tpu_torch.models import llama as tllama
    from dlrover_tpu_torch.parallel import remat
    from dlrover_tpu_torch.parallel.accelerate import param_leaves

    cfg = tllama.LlamaConfig.tiny(dim=512, n_heads=8, n_kv_heads=4,
                                  mlp_dim=1536, max_seq_len=256,
                                  dtype=torch.float32)
    b, s = 4, 256
    params = tllama.init_params(cfg, gen, device="cuda",
                                dtype=torch.float32)
    leaves = param_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    tokens = torch.randint(0, cfg.vocab_size, (b, s + 1), generator=gen,
                           device="cuda")
    names = ("qkv_proj", "mlp_gate")
    # q, k, v and the gate product of each layer, f32
    tagged = 4 * b * s * cfg.n_layers * (
        (cfg.n_heads + 2 * cfg.n_kv_heads) * cfg.head_dim + cfg.mlp_dim)

    def run(policy):
        body = remat.apply_remat(lambda p, bt: tllama.loss_fn(cfg, p, bt),
                                 policy, names)
        # free earlier tests' cyclic garbage now, not inside the forward
        gc.collect()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        loss, _ = body(params, {"tokens": tokens})
        torch.cuda.synchronize()
        saved = torch.cuda.memory_allocated() - base
        grads = torch.autograd.grad(loss, leaves)
        torch.cuda.synchronize()
        return loss.detach(), grads, saved

    want_loss, want, saved_full = run("full")
    _, _, saved_names = run("save_names")
    loss, grads, saved_off = run("offload_names")
    torch.testing.assert_close(loss, want_loss, rtol=0, atol=0)
    for g, w in zip(grads, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    assert saved_off == saved_full, (saved_off, saved_full)
    assert saved_names - saved_off >= tagged, (saved_names, saved_off,
                                               tagged)


def _serving_model(gen):
    """A small Llama whose shapes every serving kernel takes (head_dim
    64, GQA 2), bf16, random weights on the card."""
    from dlrover_tpu_torch.models import llama as tllama

    cfg = tllama.LlamaConfig.tiny(dim=256, n_heads=4, n_kv_heads=2,
                                  mlp_dim=512, attn_impl="auto")
    return cfg, tllama.init_params(cfg, gen)


def test_paged_verify_matches_stepped_decode_on_the_card(gen):
    """One paged verify of K+1 = 5 tokens a row against the same tokens
    stepped one at a time through paged_decode_step (the paged kernel)
    from the same pool: the logits at every position within 5% of the
    largest logit (bf16 roundings: the verify attends through the
    gathered view with f32 scores, the step through the kernel), and
    no paged-kernel launch inside the verify."""
    cfg, params = _serving_model(gen)
    ps, per_slot, s = 16, 8, 5
    lens = (37, 70)
    table = torch.tensor([[1 + r * per_slot + i for i in range(per_slot)]
                          for r in range(len(lens))], dtype=torch.int32,
                         device="cuda")
    pool = tdec.init_page_pool(cfg, 1 + per_slot * len(lens), ps)
    prompts = []
    for r, n in enumerate(lens):
        p = torch.randint(1, cfg.vocab_size, (n,), generator=gen,
                          device="cuda")
        row = tdec.prefill_exact_row(cfg, params, p, per_slot * ps)
        tdec.paged_install_row(pool, row, table[r], 0, n)
        prompts.append(p)
    pos = torch.tensor([n - 1 for n in lens], device="cuda")
    tokens = torch.stack([
        torch.cat([p[-1:], torch.randint(1, cfg.vocab_size, (s - 1,),
                                         generator=gen, device="cuda")])
        for p in prompts])
    stepped = {n: a.clone() for n, a in pool.items()}
    before = _build.launch_counts()["paged_attention"]
    vl, _ = tdec.paged_verify_step(cfg, params, tokens, pool, table, pos)
    assert _build.launch_counts()["paged_attention"] == before
    for j in range(s):
        sl, _ = tdec.paged_decode_step(cfg, params, tokens[:, j], stepped,
                                       table, pos + j)
        torch.cuda.synchronize()
        err = (vl[:, j] - sl).abs().max().item()
        assert err <= 0.05 * sl.abs().max().item(), (j, err)
    assert (_build.launch_counts()["paged_attention"]
            == before + s * cfg.n_layers)


def test_dqmm_at_the_verify_shape(gen):
    """w_gate (K 4096, O 14336, block 256) at T = 8 slots x 5 verify
    positions = 40: one launch of the prefill kernel, within DQMM_TOL
    of its plain version."""
    k, o, t = 4096, 14336, 40
    w = torch.randn((o, k), generator=gen, device="cuda") * k ** -0.5
    qw = tq.QuantizedWeight(*tq.quantize_int8(w, 256), 256)
    x = torch.randn((t, k), generator=gen, device="cuda").bfloat16()
    before = _build.launch_counts()
    y = tq.quantized_matmul(x, qw)
    after = _build.launch_counts()
    ref = tq.quantized_matmul_reference(x, qw)
    torch.cuda.synchronize()
    assert after["dqmm"] == before["dqmm"] + 1
    assert after["dqmm_ws"] == before["dqmm_ws"] + 1
    err = (y.float() - ref.float()).abs().max().item()
    assert err <= DQMM_TOL * ref.float().abs().max().item()


@pytest.mark.parametrize(
    "kw", [{}, dict(temperature=0.8, top_k=20, seed=3),
           dict(weight_quant="int8")],
    ids=["greedy", "sampled", "int8"])
def test_depth_1_dispatch_never_waits_on_the_card(gen, kw):
    """At async_depth=1 building and enqueueing a chunk dispatch and a
    spec dispatch (uploads, steps or verify, acceptance, the fetch into
    the page-locked buffer) runs under
    torch.cuda.set_sync_debug_mode("error"): nothing in it synchronizes
    the stream. The harvests wait on their events outside it."""
    from dlrover_tpu_torch.serving.engine import ContinuousBatcher

    cfg, params = _serving_model(gen)
    eng = ContinuousBatcher(cfg, params, n_slots=2, max_len=60,
                            max_new_tokens=24, kv_layout="paged",
                            spec_draft_len=4, async_depth=1, **kw)
    pat = [5, 17, 99, 3]
    for p in (pat * 6, [7, 8, 9] * 5):
        eng.submit(p)
    eng.step()                      # admissions, dispatch 1 in flight
    eng._harvest()
    verifies = eng.verify_steps
    drafts = np.full((2, 4), 17, np.int32)
    dlens = np.full(2, 4, np.int32)
    for dispatch in (eng._dispatch_chunk,
                     lambda: eng._dispatch_spec(drafts, dlens)):
        torch.cuda.set_sync_debug_mode("error")
        try:
            dispatch()
        finally:
            torch.cuda.set_sync_debug_mode("default")
        assert eng._inflight is not None
        eng._harvest()
    assert eng.verify_steps == verifies + 1
    outs = eng.generate_all([])
    assert all(0 < len(o) <= 24 for o in outs)


def test_async_spec_engine_on_the_card(gen):
    """The paged engine with speculation on the card: streams and
    spec.stats() identical at both depths, drafts verified, every paged
    launch in a chunk step (none inside a verify), a flash forward per
    layer and admission."""
    from dlrover_tpu_torch.serving.engine import ContinuousBatcher

    cfg, params = _serving_model(gen)
    pat = [5, 17, 99, 3, 40, 41]
    prompts = [pat * 5, [7, 8, 9] * 9, pat[:4] * 3, list(range(1, 30))]
    runs = []
    for depth in (0, 1):
        _build.reset_launch_counts()
        eng = ContinuousBatcher(cfg, params, n_slots=2, max_len=60,
                                max_new_tokens=20, kv_layout="paged",
                                spec_draft_len=4, async_depth=depth)
        outs = [o.tolist() for o in eng.generate_all(prompts)]
        counts = _build.launch_counts()
        assert eng.verify_steps >= 1 and eng.spec.proposed > 0
        assert counts["paged_attention"] == eng.decode_steps * cfg.n_layers
        assert counts["flash_fwd"] == eng.admissions * cfg.n_layers
        runs.append((outs, eng.spec.stats()))
    assert runs[0] == runs[1]


def _random_adapters(cfg, n, max_rank=8, seed=7):
    """A registry of `n` random adapters (ranks alternating 4 and 8,
    alpha = 2 x rank) on wq/wk/wv/wo, numpy from a seed."""
    from dlrover_tpu_torch.serving.adapters import (
        AdapterRegistry,
        _target_dims,
    )

    rng = np.random.default_rng(seed)
    reg = AdapterRegistry(cfg, max_rank=max_rank)
    for i in range(n):
        r = 4 if i % 2 == 0 else 8
        layers = {}
        for t, (d_in, d_out) in _target_dims(cfg).items():
            layers[t + "_lora_a"] = (rng.standard_normal(
                (cfg.n_layers, d_in, r)) / np.sqrt(r)).astype(np.float32)
            layers[t + "_lora_b"] = (rng.standard_normal(
                (cfg.n_layers, r, d_out)) * 0.02).astype(np.float32)
        reg.register(f"ad{i}", {"layers": layers}, alpha=2.0 * r)
    return reg


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_slot_lora_delta_on_the_card_matches_cpu(gen, dtype):
    """The batched gather-matmul delta (`_slot_lora_delta`, two bmm) on
    card tensors against the same call on the same values on the CPU:
    within 2^-7 of the largest |delta| in bf16 (both round each product
    to bf16; f32 sums in another order) and 1e-5 in f32 (TF32 off);
    the zero slot gives an exact zero on both."""
    from dlrover_tpu_torch.models import llama as tllama

    torch.backends.cuda.matmul.allow_tf32 = False
    h = torch.randn((8, 1, 4096), generator=gen, device="cuda").to(dtype)
    a = torch.randn((5, 4096, 16), generator=gen, device="cuda") * 0.25
    b = torch.randn((5, 16, 4096), generator=gen, device="cuda") * 0.02
    a[0] = 0
    b[0] = 0
    idx = torch.tensor([1, 0, 2, 3, 4, 1, 0, 2], device="cuda")
    scale = torch.tensor([0.0, 2.0, 2.0, 1.0, 2.0], device="cuda")
    d = tllama._slot_lora_delta(h, a, b, idx, scale)
    ref = tllama._slot_lora_delta(h.cpu(), a.cpu(), b.cpu(), idx.cpu(),
                                  scale.cpu())
    torch.cuda.synchronize()
    assert d.dtype == dtype
    err = (d.cpu().float() - ref.float()).abs().max().item()
    tol = (2 ** -7 if dtype == torch.bfloat16 else 1e-5) * (
        ref.float().abs().max().item())
    assert err <= tol, (err, tol)
    assert not d[1].any() and not d[6].any()


@pytest.mark.parametrize("layout", ["paged", "dense"])
def test_adapter_engine_base_rows_equal_adapterless(gen, layout):
    """A bf16 adapter engine serving only adapter_id=None requests gives
    the adapterless engine's streams byte for byte (each row adds an
    exact zero from bank slot 0), the kernels launched as many times."""
    from dlrover_tpu_torch.serving.engine import ContinuousBatcher

    cfg, params = _serving_model(gen)
    reg = _random_adapters(cfg, 2)
    prompts = [list(range(3, 40)), [7, 8, 9] * 9, list(range(50, 62))]
    runs = []
    for registry in (None, reg):
        _build.reset_launch_counts()
        eng = ContinuousBatcher(cfg, params, n_slots=2, max_len=64,
                                max_new_tokens=16, kv_layout=layout,
                                adapter_registry=registry,
                                adapter_cache_slots=2)
        runs.append(([o.tolist() for o in eng.generate_all(prompts)],
                     _build.launch_counts()["flash_fwd"]))
    assert runs[0] == runs[1]


def test_adapter_upload_during_inflight_dispatch_never_waits(gen):
    """At async_depth=1, a submit that uploads an adapter into the bank
    while a dispatch is in flight, and the next chunk dispatch with the
    adapter operand, run under torch.cuda.set_sync_debug_mode("error"):
    the page-locked staging and the in-place slot write never
    synchronize the stream. The adapted stream equals a depth-0 run's."""
    from dlrover_tpu_torch.serving.engine import ContinuousBatcher

    cfg, params = _serving_model(gen)
    reg = _random_adapters(cfg, 2)
    prompts = [list(range(3, 40)), [7, 8, 9] * 9]
    outs = []
    for depth in (1, 0):
        eng = ContinuousBatcher(cfg, params, n_slots=2, max_len=64,
                                max_new_tokens=16, kv_layout="paged",
                                adapter_registry=reg, adapter_cache_slots=2,
                                async_depth=depth)
        eng.submit(prompts[0], adapter_id="ad0")
        eng.step()                  # admission, dispatch 1 in flight
        if depth == 1:
            assert eng._inflight is not None
            torch.cuda.set_sync_debug_mode("error")
            try:
                eng.submit(prompts[1], adapter_id="ad1")   # an upload
            finally:
                torch.cuda.set_sync_debug_mode("default")
            assert eng.adapter_stats()["uploads"] == 2.0
            eng._harvest()
            eng._admit(1, eng._queue.popleft())
            torch.cuda.set_sync_debug_mode("error")
            try:
                eng._dispatch_chunk()
            finally:
                torch.cuda.set_sync_debug_mode("default")
        else:
            eng.submit(prompts[1], adapter_id="ad1")
        outs.append([o.tolist() for o in eng.generate_all([])])
    assert outs[0] == outs[1]
    assert all(len(o) == 16 for o in outs[0])


def test_int8_live_refresh_requantizes_on_the_card(gen):
    """weight_quant="int8", a live refresh with two requests decoding:
    the commit re-quantizes every matmul weight on the card, 7 x 32 + 1
    = 225 quant_int8 launches at 32 layers (Llama-3-8B's count, at a
    narrow width), bumps the version and replays both requests; prompts
    submitted after the drain give a fresh int8 engine's streams on the
    new tree."""
    from dlrover_tpu_torch.models import llama as tllama
    from dlrover_tpu_torch.serving.engine import ContinuousBatcher

    cfg = tllama.LlamaConfig.tiny(dim=256, n_heads=4, n_kv_heads=2,
                                  mlp_dim=512, n_layers=32,
                                  attn_impl="auto")
    a = tllama.init_params(cfg, gen)
    b = tllama.init_params(cfg, gen)
    kw = dict(n_slots=2, max_len=64, max_new_tokens=12, chunk=2,
              kv_layout="paged", weight_quant="int8",
              weight_refresh_mode="live")
    prompts = [list(range(3, 30)), [7, 8, 9] * 6]
    eng = ContinuousBatcher(cfg, a, **kw)
    for p in prompts:
        eng.submit(p)
    eng.step()
    _build.reset_launch_counts()
    eng.update_params(b)
    torch.cuda.synchronize()
    assert _build.launch_counts()["quant_int8"] == 7 * 32 + 1
    assert eng.weight_version == 1
    assert eng.elastic_stats()["replayed_requests"] == 2.0
    assert all(len(o) == 12 for o in eng.generate_all([]))
    got = [o.tolist() for o in eng.generate_all(prompts)]
    fresh = ContinuousBatcher(cfg, b, **kw)
    assert got == [o.tolist() for o in fresh.generate_all(prompts)]


def _tier_engine(gen, **kw):
    """The small serving model in a paged engine (pages of 16, the TMA
    kernel's) with a host KV tier."""
    from dlrover_tpu_torch.serving.engine import ContinuousBatcher

    cfg, params = _serving_model(gen)
    base = dict(n_slots=3, max_len=64, max_new_tokens=20, chunk=2,
                kv_layout="paged", page_size=16, kv_tier_bytes=64 << 20)
    return cfg, params, ContinuousBatcher(cfg, params, **{**base, **kw})


def _run_pages(eng, slot, n):
    return {k: a[:, eng._slot_pages[slot][:n]].clone()
            for k, a in eng.page_pool.items()}


@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
def test_kv_tier_swap_round_trip_is_byte_exact_on_the_card(gen, quant):
    """A decoding slot swapped out to page-locked host memory and back:
    the host entry holds the run's bytes, and the pages the swap-in
    installs equal the pages before the swap-out, byte for byte."""
    _, _, eng = _tier_engine(gen, kv_quant=quant)
    rng = np.random.default_rng(0)
    for n in (20, 33, 9):
        eng.submit(rng.integers(1, 250, size=n).tolist())
    eng.step()
    eng.step()
    slot = eng._pick_preempt_slot()
    n = int(eng.pos[slot]) // eng.page_size + 1
    before = _run_pages(eng, slot, n)
    eng._preempt_slot(slot)
    eng.kv_tier.drain()
    (ent,) = eng.kv_tier._entries.values()
    assert ent.kind == "swap" and ent.n_pages == n
    for k, v in ent.data.items():
        assert v.device.type == "cpu" and v.is_pinned()
        assert torch.equal(v[:, :n].cuda(), before[k]), k
    after = {}
    swap_in = eng._tier_swap_in

    def watch(s, req, p):
        ok = swap_in(s, req, p)
        if ok:
            after.update(_run_pages(eng, s, n))
        return ok

    eng._tier_swap_in = watch
    eng.step()
    assert eng.kv_tier_stats()["swap_ins"] == 1
    for k in before:
        assert torch.equal(after[k], before[k]), k
    assert all(len(o) == 20 for o in eng.generate_all([]))
    eng.allocator.check()


def test_kv_tier_demotion_and_promotion_never_synchronize(gen):
    """At async_depth=1, the step that demotes a published prefix (an
    eviction at publish), the step that promotes it back, a swap-out of
    a decoding slot and the step that swaps it in all run under
    torch.cuda.set_sync_debug_mode("error"): the gathers, the side
    stream's copies into page-locked memory, the drain (event waits)
    and the non-blocking uploads never synchronize a stream or the
    device."""
    rng = np.random.default_rng(1)
    a, b, c = (rng.integers(1, 250, size=40).tolist() for _ in range(3))
    _, _, eng = _tier_engine(gen, n_slots=2, prefix_cache_rows=1,
                             max_new_tokens=6, async_depth=1)

    def no_sync(fn, *args):
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            return fn(*args)
        finally:
            torch.cuda.set_sync_debug_mode("default")

    eng.generate_all([a])                 # publishes a's prefix
    eng.submit(b)
    no_sync(eng.step)                     # b publishes: a's row demotes
    assert eng.kv_tier_stats()["demotions"] == 1
    eng.generate_all([])
    eng.submit(a)
    no_sync(eng.step)                     # a's prefix promotes back
    assert eng.kv_tier_stats()["promotions"] == 1
    assert eng.paged_stats()["pages_promoted"] > 0
    eng.generate_all([])
    eng.submit(c)
    eng.step()
    eng.step()
    eng._harvest()
    slot = next(s for s in range(eng.n_slots) if eng.slot_req[s] is not None)
    no_sync(eng._preempt_slot, slot)      # swap-out
    assert eng.kv_tier_stats()["swap_outs"] == 1
    no_sync(eng.step)                     # drain + swap-in
    assert eng.kv_tier_stats()["swap_ins"] == 1
    assert all(len(o) == 6 for o in eng.generate_all([]))


def test_host_handoff_pages_equal_the_source_pages(gen, monkeypatch):
    """A prefill engine's package over the host transport: page-locked
    host tensors equal to the source pages; the decode engine's adopted
    pages equal the package; the decode stream equals a colocated
    engine's on the same prompt."""
    from dlrover_tpu_torch.serving import handoff
    from dlrover_tpu_torch.serving.engine import ContinuousBatcher

    cfg, params = _serving_model(gen)
    kw = dict(n_slots=2, max_len=64, max_new_tokens=8, chunk=2,
              kv_layout="paged")
    pre = ContinuousBatcher(cfg, params, replica_role="prefill",
                            kv_checksums=1, **kw)
    dec = ContinuousBatcher(cfg, params, replica_role="decode",
                            kv_checksums=1, **kw)
    prompt = list(range(3, 40))
    idx = pre.submit(prompt)
    pre.step()
    assert [r.idx for r in pre.take_prefilled()] == [idx]
    pkg = handoff.export_run(pre, idx, transport="host")
    assert pkg.checksum
    src = pre._slot_pages[0][:pkg.n_ship]
    for name, arr in pre.page_pool.items():
        shipped = pkg.data[name]
        assert shipped.device.type == "cpu" and shipped.is_pinned()
        assert torch.equal(shipped[:, :pkg.n_ship].cuda(), arr[:, src]), name
    pre.retire(idx)
    installed = {}
    real = handoff.adopt_into_slot

    def adopt(engine, slot, p):
        real(engine, slot, p)
        installed.update(_run_pages(engine, slot, p.n_ship))

    monkeypatch.setattr(handoff, "adopt_into_slot", adopt)
    dec.submit_adopted(pkg)
    out = dec.generate_all([])
    for name in installed:
        assert torch.equal(installed[name],
                           pkg.data[name][:, :pkg.n_ship].cuda()), name
    assert dec.health_stats()["integrity_checks"] == 1
    colocated = ContinuousBatcher(cfg, params, **kw)
    assert [o.tolist() for o in out] == [
        o.tolist() for o in colocated.generate_all([prompt])]
    assert pre.allocator.used_pages == 0 and dec.allocator.used_pages == 0


def test_kv_checksum_of_a_card_tensor_equals_its_cpu_copy(gen):
    from dlrover_tpu_torch.serving.health import kv_checksum

    data = {
        "k": torch.randn((2, 16, 4, 64), generator=gen,
                         device="cuda").bfloat16(),
        "k_scale": torch.rand((2, 16, 4, 1), generator=gen,
                              device="cuda").bfloat16(),
        "v": torch.randint(-127, 128, (2, 16, 4, 64), generator=gen,
                           device="cuda", dtype=torch.int8),
    }
    assert kv_checksum(data) == kv_checksum(
        {k: v.cpu() for k, v in data.items()})


def test_stochastic_round_on_the_card(gen):
    """`stochastic_round_int8` on a card tensor draws from a CUDA
    generator: its scales equal the CPU function's on the same values
    byte for byte (they take no random bits), every q8 is the floor or
    the ceiling of x / scale, and one generator seed gives one result."""
    x = torch.randn((512, 1024), generator=gen, device="cuda").bfloat16()
    g = lambda: torch.Generator(device="cuda").manual_seed(11)  # noqa: E731
    q, s = tq.stochastic_round_int8(x, 256, g())
    q2, _ = tq.stochastic_round_int8(x, 256, g())
    _, s_cpu = tq.stochastic_round_int8(x.cpu(), 256,
                                        torch.Generator().manual_seed(0))
    assert q.is_cuda and torch.equal(q, q2)
    assert torch.equal(s.cpu(), s_cpu)
    xs = x.float() / s.repeat_interleave(256, dim=1)
    lo = torch.floor(xs)
    qf = q.float()
    assert bool(((qf == lo.clamp(-127, 127))
                 | (qf == (lo + 1).clamp(-127, 127))).all())


def test_int8_stochastic_engine_on_the_card(gen):
    """weight_quant="int8_stochastic" installs without the quantize
    kernel and serves every product on the dequant-matmul kernel, as
    "int8" does; the same seed installs the same bytes."""
    from dlrover_tpu_torch.serving.engine import ContinuousBatcher

    cfg, params = _serving_model(gen)
    kw = dict(n_slots=2, max_len=64, max_new_tokens=6, kv_layout="paged",
              weight_quant="int8_stochastic", seed=3)
    _build.reset_launch_counts()
    eng = ContinuousBatcher(cfg, params, **kw)
    assert eng.weight_quant_path == "int8_stochastic:kernel"
    assert _build.launch_counts()["quant_int8"] == 0
    outs = eng.generate_all([[1, 2, 3, 4, 5], [9, 8, 7]])
    counts = _build.launch_counts()
    assert [len(o) for o in outs] == [6, 6]
    per_forward = 7 * cfg.n_layers + (0 if cfg.tie_embeddings else 1)
    assert counts["dqmm"] == (eng.admissions + eng.decode_steps) * per_forward
    again = ContinuousBatcher(cfg, params, **kw)
    for name in ("wq", "w_gate"):
        assert torch.equal(eng.params["layers"][name].q8,
                           again.params["layers"][name].q8)


def test_scheduler_over_the_paged_engine_on_the_card(gen):
    """RequestScheduler over a paged engine on the card built with
    mesh_spec={"tp": 1}: kernel_path "kernel", a latency arrival preempts
    batch work, every request finishes with its budget, the paged
    launches all on the TMA-ring kernel; a sampled engine's journaled
    keys are CUDA generator states that submit() continues."""
    from dlrover_tpu_torch.serving import (
        ContinuousBatcher,
        RequestScheduler,
        RequestState,
    )

    cfg, params = _serving_model(gen)
    with pytest.raises((ValueError, NotImplementedError)):
        ContinuousBatcher(cfg, params, n_slots=2, max_len=64, mesh_spec=2)
    eng = ContinuousBatcher(cfg, params, n_slots=2, max_len=64,
                            max_new_tokens=12, chunk=4, kv_layout="paged",
                            mesh_spec={"tp": 1}, temperature=0.8, top_k=20)
    assert eng.kernel_path == "kernel" and eng.n_chips == 1
    _build.reset_launch_counts()
    s = RequestScheduler(eng)
    reqs = [s.submit([3, 4, 5, 6] * 3, tier="batch"),
            s.submit([7, 8, 9] * 4, tier="batch")]
    s.pump()
    keys = eng.live_request_keys()
    assert len(keys) == 2
    for key in keys.values():
        assert key.dtype == torch.uint8 and not key.is_cuda
    reqs.append(s.submit([1, 2, 3, 4, 5], tier="latency"))
    s.run_to_completion()
    counts = _build.launch_counts()
    assert [r.state for r in reqs] == [RequestState.DONE] * 3
    assert [len(r.tokens) for r in reqs] == [12, 12, 12]
    assert s.metrics.tier_preempted_total["batch"] >= 1
    assert counts["paged_attention"] > 0
    assert counts["paged_attention_tma"] == counts["paged_attention"]
    # a journaled state continues: the request's generator starts there
    state = torch.Generator(device="cuda").manual_seed(5).get_state()
    idx = eng.submit([1, 2, 3], prng_key=state)
    assert torch.equal(eng._make_gen(eng._requests[idx]).get_state(), state)
    eng.cancel(idx)


def _fleet_replica(R, S, cfg, params, tag, **kw):
    """One replica over the small serving model on the card, its
    scheduler on a frozen clock (dispatch order: prompt length, then
    arrival)."""
    from dlrover_tpu_torch.serving.engine import ContinuousBatcher

    base = dict(n_slots=2, max_len=64, max_new_tokens=10, chunk=2,
                kv_layout="paged")
    eng = ContinuousBatcher(cfg, params, **{**base, **kw})
    return R.InferenceReplica(tag, S.RequestScheduler(eng,
                                                      clock=lambda: 0.0))


def test_two_replicas_pumped_concurrently_equal_a_lone_engine(gen):
    """Two replicas on one card, each stepped by its own scheduler
    thread at once (both issue on the legacy default stream, so the
    kernels' shared counter buffer sees no overlap): each replica's
    greedy streams equal one lone scheduler's, fed the same prompts one
    replica's worth at a time."""
    from dlrover_tpu_torch.serving import replica as R
    from dlrover_tpu_torch.serving import scheduler as S

    cfg, params = _serving_model(gen)
    rng = np.random.default_rng(3)
    waves = [[rng.integers(1, cfg.vocab_size, size=int(n)).tolist()
              for n in rng.integers(5, 40, size=4)] for _ in range(2)]
    lone = _fleet_replica(R, S, cfg, params, "lone").scheduler
    want = []
    for wave in waves:
        reqs = [lone.submit(p) for p in wave]
        lone.run_to_completion()
        want.append([list(r.tokens) for r in reqs])
    pool = R.ReplicaPool(clock=lambda: 0.0)
    reps = [_fleet_replica(R, S, cfg, params, f"replica-{i}")
            for i in range(2)]
    for rep in reps:
        pool.add(rep)
    reqs = [[rep.scheduler.submit(p) for p in wave]
            for rep, wave in zip(reps, waves)]
    try:
        for rep in reps:
            rep.start()
        for wave in reqs:
            for req in wave:
                assert req.wait(timeout=300)
    finally:
        pool.stop()
    assert [[list(r.tokens) for r in wave] for wave in reqs] == want
    assert all(len(t) == 10 for wave in want for t in wave)


def test_gateway_stream_over_card_engines_equals_generate_all(gen):
    import http.client
    import json

    from dlrover_tpu_torch.serving import replica as R
    from dlrover_tpu_torch.serving import scheduler as S
    from dlrover_tpu_torch.serving.engine import ContinuousBatcher
    from dlrover_tpu_torch.serving.gateway import ServingGateway

    cfg, params = _serving_model(gen)
    prompt = list(range(5, 41))
    pool = R.ReplicaPool()
    for i in range(2):
        rep = _fleet_replica(R, S, cfg, params, f"replica-{i}")
        assert rep.scheduler.engine.kernel_path == "kernel"
        rep.start()
        pool.add(rep)
    gw = ServingGateway(pool)
    gw.start()
    try:
        conn = http.client.HTTPConnection("127.0.0.1", gw.port, timeout=300)
        conn.request("POST", "/v1/generate", json.dumps(
            {"tokens": prompt, "max_new": 10, "deadline_s": 600.0}))
        resp = conn.getresponse()
        assert resp.status == 200
        lines = [json.loads(ln) for ln in resp.read().decode().splitlines()]
        conn.close()
    finally:
        gw.stop()
        pool.stop()
    got = [t for d in lines for t in d.get("tokens", [])]
    assert lines[-1]["done"] and lines[-1]["state"] == "done"
    eng = ContinuousBatcher(cfg, params, n_slots=2, max_len=64,
                            max_new_tokens=10, chunk=2, kv_layout="paged")
    assert got == eng.generate_all([prompt])[0].tolist()


def test_coordinator_device_handoff_adopts_the_exported_pages(
        gen, monkeypatch):
    """A prefill and a decode replica in a ReplicaPool over the device
    transport: HandoffCoordinator places every package on the decode
    replica, whose installed pages are byte-equal to the exported ones;
    the decode engine launches no flash forward, the prefill engine no
    paged attention (per-thread launch counts around each step)."""
    from dlrover_tpu_torch.serving import handoff
    from dlrover_tpu_torch.serving import replica as R
    from dlrover_tpu_torch.serving import scheduler as S

    cfg, params = _serving_model(gen)
    pool = R.ReplicaPool(clock=lambda: 0.0)
    reps = {}
    for role in ("prefill", "decode"):
        rep = _fleet_replica(R, S, cfg, params, role, replica_role=role)
        rep.scheduler.handoff_transport = "device"
        pool.add(rep)
        reps[role] = rep
    assert reps["prefill"].scheduler.on_handoff == pool.handoff.on_prefill_done
    compared = []
    real = handoff.adopt_into_slot

    def adopt(engine, slot, pkg):
        real(engine, slot, pkg)
        run = engine._slot_pages[slot][:pkg.n_ship]
        compared.append(all(
            torch.equal(arr[:, run], pkg.data[name][:, :pkg.n_ship])
            for name, arr in engine.page_pool.items()))

    monkeypatch.setattr(handoff, "adopt_into_slot", adopt)
    launches = {}
    for role, rep in reps.items():
        eng, step = rep.scheduler.engine, rep.scheduler.engine.step
        counts = launches[role] = {"flash_fwd": 0, "paged_attention": 0}

        def counted(step=step, counts=counts):
            before = _build.thread_launch_counts()
            out = step()
            after = _build.thread_launch_counts()
            for k in counts:
                counts[k] += after[k] - before[k]
            return out

        eng.step = counted
    reqs = [pool.submit(list(range(3, 3 + n)), max_new=8) for n in (9, 30, 17)]
    for _ in range(500):
        if not any([r.scheduler.pump() for r in reps.values()]):
            break
    pool.stop()
    assert [r.state.value for r in reqs] == ["done"] * 3
    assert [len(r.tokens) for r in reqs] == [8] * 3
    assert compared == [True] * 3
    assert launches["decode"]["flash_fwd"] == 0
    assert launches["prefill"]["paged_attention"] == 0
    assert launches["prefill"]["flash_fwd"] > 0
    assert launches["decode"]["paged_attention"] > 0
    assert reps["decode"].scheduler.engine.allocator.pages_adopted > 0


def test_launcher_crash_and_resume_on_the_card(gen, tmp_path):
    """The port's launcher on the card: the tiny-Llama example dies at
    step 10 on its first attempt, the agent persists the staged step and
    restarts it, the second attempt resumes from the agent's shared
    memory and finishes; the launcher exits 0."""
    import os
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    (tmp_path / "shm").mkdir()
    env = {k: v for k, v in os.environ.items()
           if k != "DLROVER_TPU_FORCE_CPU"}
    env.update(PYTHONPATH=repo, DLROVER_TPU_SHM_DIR=str(tmp_path / "shm"),
               DLROVER_TPU_SOCK_DIR=str(tmp_path / "sock"))
    example = os.path.join(repo, "dlrover_tpu_torch", "examples",
                           "train_tiny_llama.py")
    r = subprocess.run(
        [sys.executable, "-m", "dlrover_tpu_torch.trainer.elastic_run",
         "--nnodes", "1", "--max-restarts", "2", "--job-name",
         f"cardjob{os.getpid()}", example, "--steps", "12",
         "--crash-at-step", "10", "--ckpt-dir", str(tmp_path / "ckpt")],
        env=env, cwd=str(tmp_path), capture_output=True, text=True,
        timeout=600)
    out = r.stdout + r.stderr
    assert r.returncode == 0, out[-3000:]
    assert "injected crash at step 10" in out
    assert "restore source: memory" in r.stdout, out[-3000:]
    assert "done: restart_count=1" in r.stdout


# ---- tensor-parallel serving: the sharded kernel sites ------------------


def _virtual_mesh(tp):
    from dlrover_tpu_torch.parallel.mesh import ServingMesh

    return ServingMesh([torch.device("cuda", torch.cuda.current_device())]
                       * tp)


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
def test_sharded_paged_kernel_equals_the_tp1_head_slices(gen, quant, tp):
    """Kernel 4 per head shard (`paged_attention(..., mesh=)`): each
    shard's launch takes the unsharded launch's work partition, so the
    shards' outputs are its head slices bit for bit; one launch a
    shard, all on the TMA-ring kernel."""
    q, pages, tab, lens = _paged_tma_case(gen, quant)
    whole = tpa.paged_attention(q, pages, tab, lens, impl="kernel")
    mesh = _virtual_mesh(tp)
    before = _build.launch_counts()
    parts = tpa.paged_attention(list(mesh.split(q, 1)),
                                [{n: p for n, p in zip(pages, ps)}
                                 for ps in zip(*(mesh.split(t, 2)
                                                 for t in pages.values()))],
                                tab, lens, impl="kernel", mesh=mesh)
    after = _build.launch_counts()
    torch.cuda.synchronize()
    assert after["paged_attention_tma"] == before["paged_attention_tma"] + tp
    assert torch.equal(torch.cat(parts, 1), whole)


@pytest.mark.parametrize("tp", [2, 4])
def test_sharded_flash_kernel_equals_the_tp1_head_slices(gen, tp):
    q = torch.randn((1, 300, 32, 128), generator=gen, device="cuda").bfloat16()
    k = torch.randn((1, 300, 8, 128), generator=gen, device="cuda").bfloat16()
    v = torch.randn((1, 300, 8, 128), generator=gen, device="cuda").bfloat16()
    whole = tfa.flash_attention(q, k, v, causal=True)
    before = _build.launch_counts()
    parts = tfa.sharded_flash_attention(q, k, v, _virtual_mesh(tp))
    after = _build.launch_counts()
    torch.cuda.synchronize()
    assert after["flash_fwd_wgmma"] == before["flash_fwd_wgmma"] + tp
    assert torch.equal(torch.cat(parts, 2), whole)


def test_tp2_paged_engine_on_the_card_equals_tp1(gen, monkeypatch):
    """A tp=2 engine on two virtual shards of the card: greedy streams
    equal the tp=1 engine's, the paged kernel launches twice a layer
    and step, the int8 weights stay off kernel 7."""
    from dlrover_tpu_torch import _device
    from dlrover_tpu_torch.models import llama
    from dlrover_tpu_torch.serving.engine import ContinuousBatcher

    monkeypatch.setenv(_device.FORCE_DEVICE_COUNT_ENV, "2")
    cfg = llama.LlamaConfig.tiny(dim=256, n_heads=4, n_kv_heads=2,
                                 attn_impl="auto", dtype=torch.bfloat16)
    params = llama.init_params(cfg, gen)
    rng = np.random.default_rng(1)
    prompts = [rng.integers(1, 250, size=n).tolist() for n in (20, 37, 9)]
    kw = dict(n_slots=2, max_len=64, max_new_tokens=8, chunk=4,
              kv_layout="paged", page_size=16)
    outs, paged = {}, {}
    for tp in (1, 2):
        eng = ContinuousBatcher(cfg, params, mesh_spec=tp, **kw)
        assert eng.kernel_path == "kernel"
        _build.reset_launch_counts()
        outs[tp] = [list(map(int, o)) for o in eng.generate_all(prompts)]
        paged[tp] = (_build.launch_counts()["paged_attention_tma"],
                     eng.decode_steps * cfg.n_layers)
    assert outs[2] == outs[1]
    assert paged[1][0] == paged[1][1] and paged[2][0] == 2 * paged[2][1]
    q8 = ContinuousBatcher(cfg, params, mesh_spec=2, weight_quant="int8",
                           **kw)
    assert q8.weight_quant_path == "int8:reference"
    _build.reset_launch_counts()
    q8.generate_all(prompts[:1])
    assert _build.launch_counts().get("dqmm", 0) == 0


def _lora_llama(gen):
    """A small Llama (head_dim 64: the wgmma kernels) with f32 params,
    bf16 compute, remat "full", and rank-8 adapters on wq/wk/wv/wo."""
    from dlrover_tpu_torch.models import llama as tllama
    from dlrover_tpu_torch.models import lora as tlora

    cfg = tllama.LlamaConfig.tiny(dim=256, n_heads=4, n_kv_heads=2,
                                  mlp_dim=512, vocab_size=512,
                                  attn_impl="auto", remat=True)
    base = tllama.init_params(cfg, gen, dtype=torch.float32)
    return tlora.inject(cfg, base, tlora.LoraConfig(rank=8, alpha=16.0),
                        gen)


def test_lora_train_steps_keep_the_base_on_the_card(gen):
    """Three `accelerate` steps of lora_optimizer(AdamW) on the card:
    every base leaf bit-equal, the adapters moved, moments for the
    adapter leaves only, each flash kernel launched as often as the
    path calls it (all wgmma), the loss finite and falling."""
    from dlrover_tpu_torch.models import llama as tllama
    from dlrover_tpu_torch.models import lora as tlora
    from dlrover_tpu_torch.parallel.accelerate import accelerate
    from dlrover_tpu_torch.trainer.flash_checkpoint.engine import (
        state_leaves,
    )

    cfg, params = _lora_llama(gen)
    base = {p: t.clone() for p, t in state_leaves(params).items()
            if not tlora.is_adapter_path(p)}
    b0 = params["layers"]["wq_lora_b"].clone()
    acc = accelerate(
        lambda g: params, lambda p, b: tllama.loss_fn(cfg, p, b),
        tlora.lora_optimizer(lambda ps: torch.optim.AdamW(
            ps, lr=1e-3, weight_decay=1e-4)))
    state = acc.init(gen)
    tokens = torch.randint(0, cfg.vocab_size, (2, 257), generator=gen,
                           device="cuda")
    _build.reset_launch_counts()
    losses = []
    for _ in range(3):
        state, m = acc.train_step(state, {"tokens": tokens})
        losses.append(m["loss"].item())
    counts = _build.launch_counts()
    after = state_leaves(state["params"])
    assert all(torch.equal(after[p], t) for p, t in base.items())
    assert not torch.equal(state["params"]["layers"]["wq_lora_b"], b0)
    assert len(state["opt_state"].state) == 8
    n = 3 * cfg.n_layers
    assert (counts["flash_fwd"], counts["flash_bwd_dq"],
            counts["flash_bwd_dkv"]) == (2 * n, n, n)
    for k in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
        assert counts[k + "_wgmma"] == counts[k]
    assert np.isfinite(losses).all() and losses[-1] < losses[0]


def test_ppo_step_over_a_lora_actor_on_the_card(gen):
    """Two `PpoTrainer.step`s through the continuous engine on the card
    over a small LoRA Llama actor (lora_optimizer(Adam)), the default
    ref and an embedding -> value critic: prompts kept, tokens in vocab,
    metrics finite, the base bit-equal to the ref's copy and the
    adapters moved, the second rollout on the updated params, and the
    flash kernels launched on the path (every admission's prefill, the
    logprob forwards, the update's forward, remat and backward)."""
    from dlrover_tpu_torch.models import llama as tllama
    from dlrover_tpu_torch.models import lora as tlora
    from dlrover_tpu_torch.rl import ModelEngine, PpoConfig, PpoTrainer
    from dlrover_tpu_torch.rl.model_engine import ModelSpec

    cfg, actor = _lora_llama(gen)
    critic = {"embed": torch.randn((cfg.vocab_size, 16), generator=gen,
                                   device="cuda") * 0.1,
              "v": torch.randn((16,), generator=gen, device="cuda") * 0.1}
    engine = ModelEngine(
        actor=ModelSpec(lambda p, t: tllama.apply(cfg, p, t), actor,
                        trainable=True, model_cfg=cfg),
        critic=ModelSpec(lambda p, t: p["embed"][t] @ p["v"], critic,
                         trainable=True),
        reward_fn=lambda t, n: (t == 3).sum(dim=1).float())
    trainer = PpoTrainer(
        engine, PpoConfig(max_len=48, minibatch_size=2, epochs=2,
                          rollout_engine="continuous"),
        actor_opt=tlora.lora_optimizer(
            lambda ps: torch.optim.Adam(ps, lr=1e-3)), device="cuda")
    lens = torch.tensor([5, 17, 9, 30], device="cuda")
    prompts = torch.randint(1, cfg.vocab_size, (4, 48), generator=gen,
                            device="cuda")
    _build.reset_launch_counts()
    exps = []
    make = trainer.make_experience
    trainer.make_experience = lambda *a: exps.append(make(*a)) or exps[-1]
    for seed in (0, 1):
        m = trainer.step(prompts, lens,
                         torch.Generator(device="cuda").manual_seed(seed))
        assert all(np.isfinite(v) for v in m.values())
    counts = _build.launch_counts()
    for e in exps:
        for b, n in enumerate(lens.tolist()):
            assert np.array_equal(e.tokens[b, :n],
                                  prompts[b, :n].cpu().numpy())
        assert 0 <= e.tokens.min() and e.tokens.max() < cfg.vocab_size
    ref = engine.ref.params["layers"]
    for k, v in actor["layers"].items():
        assert torch.equal(v, ref[k]) != tlora.is_adapter_path(k), k
    assert trainer._cb.weight_version == 1
    layers, n_mb = cfg.n_layers, 2 * 2 * 2
    assert counts["flash_fwd"] == layers * (8 + 2 * 2 + 2 * n_mb)
    assert counts["flash_bwd_dq"] == counts["flash_bwd_dkv"] == layers * n_mb
    for k in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
        assert counts[k + "_wgmma"] == counts[k]


# ---------------------------------------------------------------------------
# the model families' shapes: GPT-2 XL (25 heads of 64, KV group 1),
# BERT-large (16 heads of 64, non-causal), the GPT-2 XL int8 products
# (K = 1600 at block 64, not a multiple of the 256-value stage; O =
# 4800 and 1600, not multiples of 128)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("b,s,h,causal", [(1, 1024, 25, True),
                                          (2, 512, 16, False),
                                          (1, 77, 25, True)],
                         ids=["gpt2_xl", "bert_large", "gpt2_xl-ragged"])
def test_flash_fwd_bwd_at_the_family_shapes(gen, b, s, h, causal):
    """Forward and both backward kernels on their wgmma variants at
    head_dim 64, MHA (group 1)."""
    q, k, v = _flash_case(gen, b, s, h, h, 64)
    _check_wgmma(q, k, v, causal)
    _check_bwd(gen, b, s, s, h, h, 64, causal, "wgmma")


@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
def test_paged_tma_kernel_at_the_gpt2_xl_shape(gen, quant):
    """GPT-2 XL decode: 25 query heads over 25 KV heads (group 1) of 64,
    pages of 16, on the TMA-ring kernel."""
    rng = np.random.default_rng(5)
    b, h, hd, ps, per_row = 8, 25, 64, 16, 64
    n_pages = b * per_row + 1
    lengths = rng.integers(1, per_row * ps + 1, size=b).astype(np.int32)
    table = rng.permutation(np.arange(1, n_pages)).astype(np.int32)[
        : b * per_row].reshape(b, per_row).copy()
    k = torch.randn((n_pages, ps, h, hd), generator=gen, device="cuda")
    v = torch.randn((n_pages, ps, h, hd), generator=gen, device="cuda")
    if quant:
        kq, ks = tdec._kv_quantize(k)
        vq, vs = tdec._kv_quantize(v)
        pages = {"k": kq, "v": vq, "k_scale": ks.bfloat16(),
                 "v_scale": vs.bfloat16()}
    else:
        pages = {"k": k.bfloat16(), "v": v.bfloat16()}
    q = torch.randn((b, h, hd), generator=gen, device="cuda").bfloat16()
    tab, lens = torch.from_numpy(table).cuda(), torch.from_numpy(
        lengths).cuda()
    assert tpa.kernel_variant(q.dtype, ps, h, hd, b, quant,
                              n_table=per_row, n_rep=1) == "tma"
    before = _build.launch_counts()
    ker = tpa.paged_attention(q, pages, tab, lens, impl="kernel")
    after = _build.launch_counts()
    ref = tpa.paged_attention(q, pages, tab, lens, impl="reference")
    torch.cuda.synchronize()
    assert after["paged_attention_tma"] == before["paged_attention_tma"] + 1
    assert (ker.float() - ref.float()).abs().max().item() < TOL


# (K, O, block) of GPT-2 XL's quantized products: wqkv, wo, w_up (block
# 64 by `weight_quant_block(1600)`), w_down (block 256)
GPT2_XL_WEIGHTS = ((1600, 4800, 64), (1600, 1600, 64), (1600, 6400, 64),
                   (6400, 1600, 256))


@pytest.mark.parametrize("k,o,block", GPT2_XL_WEIGHTS,
                         ids=["wqkv", "wo", "w_up", "w_down"])
def test_dqmm_and_quantize_at_the_gpt2_xl_shapes(gen, k, o, block):
    """The install's quantize kernel bytes equal to the plain version's,
    and the dequant-matmul at T = 8 (the TMA-ring decode kernel) and T =
    1024 (the prefill kernel) within DQMM_TOL of the plain version."""
    assert tq.weight_quant_block(k) == block
    w = torch.randn((o, k), generator=gen, device="cuda") * k ** -0.5
    q8, s8 = tq.quantize_int8(w.bfloat16(), block)
    q_ref, s_ref = tq._quantize_plain(w.bfloat16(), block)
    torch.cuda.synchronize()
    assert torch.equal(q8, q_ref) and torch.equal(s8, s_ref)
    qw = tq.QuantizedWeight(q8, s8, block)
    _check_decode_tma(gen, qw, (8,))
    x = torch.randn((1024, k), generator=gen, device="cuda").bfloat16()
    before = _build.launch_counts()
    y = tq.quantized_matmul(x, qw)
    after = _build.launch_counts()
    ref = tq.quantized_matmul_reference(x, qw)
    torch.cuda.synchronize()
    assert after["dqmm_ws"] == before["dqmm_ws"] + 1
    err = (y.float() - ref.float()).abs().max().item()
    assert err <= DQMM_TOL * ref.float().abs().max().item()


def test_gpt_engine_on_the_card_takes_the_kernels(gen):
    """A small GPT (head_dim 64) through the paged int8 engine: every
    prefill on the wgmma flash forward, every decode on the TMA paged
    kernel, every product on kernel 7; first logits within 5% of the
    largest of plain attention on the same weights."""
    import dataclasses

    from dlrover_tpu_torch.models import decode as dec
    from dlrover_tpu_torch.models import gpt
    from dlrover_tpu_torch.serving.engine import ContinuousBatcher

    cfg = gpt.GptConfig(vocab_size=512, dim=256, n_layers=2, n_heads=4,
                        max_seq_len=256)
    params = gpt.init_params(cfg, gen)
    rng = np.random.default_rng(1)
    prompts = [rng.integers(1, 512, size=n).tolist() for n in (40, 90, 7)]
    _build.reset_launch_counts()
    eng = ContinuousBatcher(cfg, params, n_slots=2, max_len=256,
                            max_new_tokens=6, kv_layout="paged",
                            weight_quant="int8")
    outs = eng.generate_all(prompts)
    c = _build.launch_counts()
    assert [len(o) for o in outs] == [6, 6, 6]
    assert c["flash_fwd"] == c["flash_fwd_wgmma"] == eng.admissions * 2
    assert c["paged_attention"] == c["paged_attention_tma"] > 0
    assert c["dqmm"] == c["dqmm_ws"] + c["dqmm_decode_tma"] > 0
    tok = torch.tensor([prompts[1]], device="cuda")
    ref = dataclasses.replace(cfg, attn_impl="reference")
    got, _ = dec.prefill(cfg, params, tok,
                         dec.init_kv_cache(cfg, 1, 96))
    want, _ = dec.prefill(ref, params, tok, dec.init_kv_cache(cfg, 1, 96))
    err = (got - want).abs().max().item()
    assert err <= 0.05 * want.abs().max().item()


def test_bert_train_step_takes_the_non_causal_kernels(gen):
    """An unpadded BERT batch launches the non-causal flash forward and
    both backward kernels once a layer (wgmma); a padded batch launches
    none (the reference through segment_ids)."""
    from dlrover_tpu_torch.models import bert

    cfg = bert.BertConfig(vocab_size=512, dim=256, n_layers=2, n_heads=4,
                          mlp_dim=512, max_seq_len=128)
    params = bert.init_params(cfg, gen)
    for p in params["layers"].values():
        p.requires_grad_(True)
    toks = torch.randint(0, 512, (2, 128), generator=gen, device="cuda")
    batch = {"tokens": toks, "labels": toks,
             "mlm_mask": torch.ones((2, 128), device="cuda")}
    _build.reset_launch_counts()
    loss, _ = bert.mlm_loss_fn(cfg, params, batch)
    loss.backward()
    c = _build.launch_counts()
    for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
        assert c[name] == c[name + "_wgmma"] == 2, (name, c)
    _build.reset_launch_counts()
    mask = torch.ones((2, 128), dtype=torch.int32, device="cuda")
    mask[1, 100:] = 0
    loss, _ = bert.mlm_loss_fn(cfg, params, dict(batch, attention_mask=mask))
    loss.backward()
    assert _build.launch_counts()["flash_fwd"] == 0
    assert torch.isfinite(loss)


def test_flash_and_paged_take_the_views_of_a_fused_qkv(gen):
    """GPT-2's and BERT's q / k / v are chunks of one fused projection,
    strided views: `flash_attention` (forward and backward) and
    `paged_attention` take them, on the kernels, with the results of
    dense copies."""
    qkv = torch.randn((2, 128, 3 * 4 * 64), generator=gen,
                      device="cuda").bfloat16().requires_grad_()
    q, k, v = (t.reshape(2, 128, 4, 64) for t in qkv.chunk(3, dim=-1))
    assert not q.is_contiguous()
    before = _build.launch_counts()
    o = tfa.flash_attention(q, k, v, causal=False)
    o.float().sum().backward()
    after = _build.launch_counts()
    assert after["flash_fwd_wgmma"] == before["flash_fwd_wgmma"] + 1
    assert after["flash_bwd_dq_wgmma"] == before["flash_bwd_dq_wgmma"] + 1
    dense = [t.detach().contiguous().requires_grad_() for t in (q, k, v)]
    o2 = tfa.flash_attention(*dense, causal=False)
    o2.float().sum().backward()
    assert torch.equal(o, o2)
    want = torch.cat([t.grad.reshape(2, 128, -1) for t in dense], dim=-1)
    assert torch.equal(qkv.grad, want)
    pages = {"k": torch.randn((5, 16, 4, 64), generator=gen,
                              device="cuda").bfloat16(),
             "v": torch.randn((5, 16, 4, 64), generator=gen,
                              device="cuda").bfloat16()}
    table = torch.arange(1, 5, dtype=torch.int32, device="cuda")[None]
    table = table.expand(2, 4).contiguous()
    lens = torch.tensor([30, 64], dtype=torch.int32, device="cuda")
    q1 = q[:, 0].detach()
    assert not q1.is_contiguous()
    got = tpa.paged_attention(q1, pages, table, lens, impl="kernel")
    torch.cuda.synchronize()
    assert torch.equal(got, tpa.paged_attention(q1.contiguous(), pages,
                                                table, lens, impl="kernel"))
