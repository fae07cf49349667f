"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Every test here is marked `cuda` and skips where there is no
NVIDIA GPU (a CUDA kernel has no CPU mode). The file imports no JAX,
so it also runs on a machine without it:

    python -m pytest tests/test_torch_cuda.py --noconftest -m cuda -q

Tolerance 2e-2 abs on bf16 outputs of magnitude ~1: the output is bf16
(2^-8 relative), and P is rounded to bf16 at other points — the flash
kernel at each 64-key tile's running max, its plain version at the
final max; the paged plain version before P V, the paged kernel never."""

import numpy as np
import pytest
import torch

from dlrover_tpu_torch.models import decode as tdec
from dlrover_tpu_torch.ops import _build
from dlrover_tpu_torch.ops import flash_attention as tfa
from dlrover_tpu_torch.ops import paged_attention as tpa

TOL = 2e-2

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
    before = _build.launch_counts()["flash_fwd"]
    for causal in (True, False):
        o, lse = tfa._fwd(q, k, v, causal, d ** -0.5)
        o_ref, lse_ref = tfa._fwd_plain(q, k, v, causal, d ** -0.5)
        torch.cuda.synchronize()
        assert (o.float() - o_ref.float()).abs().max().item() < TOL
        assert (lse - lse_ref).abs().max().item() < 1e-3
    assert _build.launch_counts()["flash_fwd"] == before + 2


def test_flash_kernel_single_query(gen):
    q = torch.randn((2, 1, 8, 128), generator=gen, device="cuda").bfloat16()
    k = torch.randn((2, 300, 2, 128), generator=gen, device="cuda").bfloat16()
    v = torch.randn((2, 300, 2, 128), generator=gen, device="cuda").bfloat16()
    o = tfa.flash_attention(q, k, v, causal=True)
    o_ref = tfa._fwd_plain(q, k, v, False, 128 ** -0.5)[0]
    assert (o.float() - o_ref.float()).abs().max().item() < TOL


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
