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
    with pytest.raises(ValueError, match="blocks"):
        tq.dequantize_int8(q, torch.ones((2, 1), device="cuda"))   # 512
    with pytest.raises(ValueError, match="blocks"):
        tq.dequantize_int8(q, torch.ones((2, 128), device="cuda"))  # 4
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
        int8_adam(1e-3, weight_decay=1e-4),
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
    with pytest.raises(ValueError, match="does not take"):
        tq.quantized_matmul(x, tq.QuantizedWeight(q8, s8, 32))
    w = torch.randn((64, 128), generator=gen, device="cuda")
    q8, s8 = tq.quantize_int8(w, 64)
    with pytest.raises(ValueError, match="dtype"):
        tq.quantized_matmul(torch.zeros((4, 128), device="cuda"),
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
    # head_dim 264: above the kernels' 256 (the JAX kernels take up to
    # 512, queued)
    qb = torch.randn((1, 16, 4, 264), generator=gen, device="cuda").bfloat16()
    with pytest.raises(ValueError, match="do not take"):
        tfa._bwd(qb, qb, qb, qb, lse, qb, True, 264 ** -0.5)


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
    above 256; impl="flash" raises for each."""
    from dlrover_tpu_torch.ops import attention as tattn

    def rand(*shape):
        return torch.randn(shape, generator=gen, device="cuda").bfloat16()

    seg = torch.tensor([[0] * 8 + [1] * 8], device="cuda")
    cases = [
        (rand(1, 16, 4, 64), rand(1, 16, 2, 64), seg),
        (rand(1, 8, 4, 64), rand(1, 16, 2, 64), None),
        (rand(1, 16, 4, 16), rand(1, 16, 2, 16), None),
        (rand(1, 16, 4, 264), rand(1, 16, 2, 264), None),
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
