"""int8 block quantization: CUDA kernels for Hopper (csrc/quant_int8.cu,
csrc/dequant_int8.cu, csrc/dqmm.cu) and their plain PyTorch versions.

Counterpart of dlrover_tpu/ops/quantization.py: `quantize_int8` (the
`_quant_kernel`), `dequantize_int8` (the `_dequant_kernel`),
`quantize_any` / `dequantize_any` (any shape, flattened and
zero-padded to a block multiple: the int8 AdamW's moments),
`stochastic_round_int8` (plain PyTorch, as JAX's is plain XLA), and
for serving `QuantizedWeight`, `weight_quant_block`,
`_dq_weight`, `quantized_matmul_reference`, `quantized_matmul` (the
`_dqmm_kernel`) and `matmul_any`; and the compressed collectives
`quantized_reduce_scatter` and `quantized_all_reduce_tree` over a
`torch.distributed` process group, whose int8 wire payloads kernels 5
and 6 make and read. The JAX `block_m` argument is not taken: JAX
ignores it too.

Layout (as in the JAX package): a weight w [K, O] that activations
contract over K is stored OUTPUT-MAJOR as q8 int8 [O, K] plus s8 f32
[O, K/block], one symmetric scale per contiguous K-block of one output
row; stacked layers add leading dims.

Each wrapper runs its kernel for CUDA tensors and its plain version for
CPU tensors. The kernels take every shape the JAX kernels take: any
block that divides the row (quantize, dequantize, dqmm), any K and
bf16 or f32 activations (dqmm).
"""

import ctypes
import functools
from typing import Optional, Tuple

import torch.nn.functional as F

import torch

from dlrover_tpu_torch.ops import _build

INT8_MAX = 127.0
DEFAULT_BLOCK = 256
# XLA rewrites the JAX kernel's `amax / 127` (a division by a constant)
# into a product with the f32 reciprocal, so that is the scale's
# formula here and in the CUDA kernel: it gives the JAX kernel's bytes
_INV_INT8_MAX = float(torch.tensor(1.0) / INT8_MAX)

_QUANT = "quant_int8"
_DEQUANT = "dequant_int8"
_DQMM = "dqmm"
_DQMM_WS = "dqmm_ws"     # the prefill kernel's launches (T > 16)
_DQMM_DEC_TMA = "dqmm_decode_tma"   # the TMA-ring decode kernel's
_DQMM_GENERAL = "dqmm_general"      # the general variant's
# the quantize and dequantize kernels' launches at blocks outside their
# fast paths (each also counts under its kernel's name)
_QUANT_ANY = "quant_int8_any"
_DEQUANT_ANY = "dequant_int8_any"
# the C signatures of csrc/quant_int8.cu `quant_int8` and
# csrc/dequant_int8.cu `dequant_int8` (one and the same) and of
# csrc/dqmm.cu `dqmm_bf16` (pointers and the stream as void*)
_ROW_ARGTYPES = (ctypes.c_int,) + (ctypes.c_void_p,) * 3 + (
    ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p)
_DQMM_ARGTYPES = (ctypes.c_void_p,) * 6 + (ctypes.c_int,) * 8 + (
    ctypes.c_void_p,)
_DQMM_DEC_TMA_ARGTYPES = (ctypes.c_void_p,) * 6 + (ctypes.c_int,) * 5 + (
    ctypes.c_void_p,)
_DQMM_GENERAL_ARGTYPES = (ctypes.c_int,) + (ctypes.c_void_p,) * 4 + (
    ctypes.c_int,) * 4 + (ctypes.c_void_p,)
# csrc/quant_int8.cu's lane-per-8-values kernel: block/8 lanes a row, so
# any power-of-two block from 8 to 256 (other blocks: its warp-per-row
# kernel); csrc/dequant_int8.cu's 4-values-a-thread kernel takes any
# power of two from 8 on (other blocks: its value-per-thread kernel)
_QUANT_BLOCKS = (8, 16, 32, 64, 128, 256)
_DEQUANT_DTYPES = (torch.float32, torch.bfloat16)
# csrc/dqmm.cu walks K in 64-wide chunks and gives each lane 16
# consecutive values of a weight row, which must share one scale
_DQMM_CHUNK = 64
_DQMM_MIN_BLOCK = 16
# (tokens, outputs) per tile of each dqmm variant: 0 the mma.sync
# decode kernel (T <= 16, blocks 16 and 32), 1 and 2 the persistent
# prefill kernel with 128-token tiles (T <= 128) and 256-token tiles
# (T > 128: it halves the dequant work per product, and at the
# engine's buckets its tiles are full), 3 the TMA-ring decode kernel
# (T <= 16, blocks >= 64: every decode product of the engine, whose
# quantizer gives a K that is a multiple of 64 a block of 64 or more;
# not past ~2^40 weights, where its 32-bit share arithmetic would wrap)
_DQMM_TILES = ((16, 64), (128, 128), (256, 128), (16, 64))
_DQMM_WIDE_FROM = 129
_DQMM_DECODE, _DQMM_DECODE_TMA = 0, 3
# the mma.sync decode kernel splits K over blocks until the grid holds
# this many (8 an SM on 132), keeping 4 to 16 chunks a split (it stages
# a split's activations in shared memory); the prefill kernel splits K
# only where its tiles fill less than one wave of the card's SMs,
# keeping >= 4 chunks a split
_DQMM_TARGET_BLOCKS = 1056
_DQMM_MIN_CHUNKS_PER_SPLIT = 4
_DQMM_DECODE_MAX_CHUNKS = 16
# the TMA-ring decode kernel: stages of 256 K values of a 64-output tile,
# at most two blocks an SM, each an even share of the stages (at least
# two where K allows)
_DQMM_DEC_TMA_KS = 256
_DQMM_DEC_TMA_BLOCKS_PER_SM = 2
_DQMM_DEC_TMA_MIN_STAGES = 2
_DQMM_DEC_TMA_MIN_BLOCK = 64
_DQMM_DEC_TMA_SLOT = 1024     # f32 values of one partial tile


def _check_cuda(name: str, t: torch.Tensor, dtypes, device: int) -> None:
    """Raise unless `t` is a contiguous, 16-byte aligned tensor of one of
    `dtypes` on CUDA device index `device` (int compares only: this runs
    for every launch)."""
    if t.get_device() != device:
        raise ValueError(f"{name} must be on CUDA device {device}")
    if t.dtype not in dtypes:
        raise ValueError(f"{name}.dtype={t.dtype}, want one of {dtypes}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.data_ptr() % 16:
        raise ValueError(f"{name} must be 16-byte aligned")


# ---------------------------------------------------------------------------
# kernel 5: symmetric per-block int8 quantization
# ---------------------------------------------------------------------------


def _quantize_plain(
    x: torch.Tensor, block: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's function in plain PyTorch (the JAX `_quant_kernel`
    body): per block amax in f32, scale = amax * f32(1/127) (1.0 where
    amax is 0), q = clip(round_half_even(x / scale), -127, 127), the
    division an IEEE one."""
    m, n = x.shape
    xr = x.float().reshape(m * (n // block), block)
    amax = xr.abs().amax(dim=1)
    scale = torch.where(amax > 0, amax * _INV_INT8_MAX, 1.0)
    q = torch.clamp(torch.round(xr / scale[:, None]), -INT8_MAX, INT8_MAX)
    return q.to(torch.int8).reshape(m, n), scale.reshape(m, n // block)


def _quantize_cuda(x: torch.Tensor, block: int):
    dev = x.get_device()
    _check_cuda("x", x, (torch.float32, torch.bfloat16), dev)
    m, n = x.shape
    rows = m * (n // block)
    q = torch.empty((m, n), dtype=torch.int8, device=x.device)
    s = torch.empty((m, n // block), dtype=torch.float32, device=x.device)
    if rows == 0:
        # nothing to launch (the kernel returns at once), so no count
        return q, s
    fn = _build.function(_QUANT, "quant_int8", _ROW_ARGTYPES)
    err = fn(
        int(x.dtype == torch.bfloat16), x.data_ptr(), q.data_ptr(),
        s.data_ptr(), rows, block, _build.current_stream(dev),
    )
    _build.count_launch(_QUANT)
    if block not in _QUANT_BLOCKS:
        _build.count_launch(_QUANT_ANY)
    _build.check(err, _QUANT, f"x{tuple(x.shape)} block {block}")
    return q, s


def quantize_int8(
    x: torch.Tensor, block: int = DEFAULT_BLOCK
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-block int8 quantization along the last dim.

    x: [m, n] f32 or bf16 with n % block == 0 -> (q int8 [m, n],
    scales f32 [m, n/block]). The kernel for CUDA tensors, its plain
    version for CPU tensors; both give the JAX kernel's bytes."""
    if x.ndim != 2 or x.shape[1] % block:
        raise ValueError(
            f"quantize_int8 takes [m, n] with n % block == 0, got "
            f"{tuple(x.shape)} and block {block}"
        )
    if x.is_cuda:
        return _quantize_cuda(x, block)
    return _quantize_plain(x, block)


# ---------------------------------------------------------------------------
# kernel 6: per-block int8 dequantization
# ---------------------------------------------------------------------------


def _dequantize_plain(
    q: torch.Tensor, s: torch.Tensor, out_dtype=torch.float32
) -> torch.Tensor:
    """The kernel's function in plain PyTorch (the JAX `_dequant_kernel`
    body): each scale broadcast over its block, one f32 product per
    value, cast (round to nearest even) to `out_dtype`."""
    block = q.shape[1] // s.shape[1]
    return (q.float() * s.repeat_interleave(block, dim=1)).to(out_dtype)


def _dequant_fast(block: int) -> bool:
    """Whether csrc/dequant_int8.cu's 4-values-a-thread kernel takes
    `block` (a power of two, 8 or more: 4 consecutive values share a
    scale, found by a shift)."""
    return block >= 8 and block & (block - 1) == 0


def _dequantize_cuda(q: torch.Tensor, s: torch.Tensor, out_dtype):
    dev = q.get_device()
    _check_cuda("q", q, (torch.int8,), dev)
    _check_cuda("scales", s, (torch.float32,), dev)
    if out_dtype not in _DEQUANT_DTYPES:
        raise ValueError(
            f"dequant kernel writes {_DEQUANT_DTYPES}, got {out_dtype}"
        )
    m, n = q.shape
    block = n // s.shape[1]
    x = torch.empty((m, n), dtype=out_dtype, device=q.device)
    rows = m * s.shape[1]
    if rows == 0:
        return x
    fn = _build.function(_DEQUANT, "dequant_int8", _ROW_ARGTYPES)
    err = fn(
        int(out_dtype == torch.bfloat16), q.data_ptr(), s.data_ptr(),
        x.data_ptr(), rows, block, _build.current_stream(dev),
    )
    _build.count_launch(_DEQUANT)
    if not _dequant_fast(block):
        _build.count_launch(_DEQUANT_ANY)
    _build.check(err, _DEQUANT, f"q{tuple(q.shape)} block {block}")
    return x


def dequantize_int8(
    q: torch.Tensor, scales: torch.Tensor, out_dtype=torch.float32
) -> torch.Tensor:
    """Inverse of `quantize_int8`: q int8 [m, n] and scales f32
    [m, n/block] -> `out_dtype` [m, n], each value q * its block's
    scale taken in f32. The kernel for CUDA tensors (f32 or bf16 out,
    any block that divides n), its plain version for CPU tensors; both
    give the JAX kernel's bits."""
    if (q.ndim != 2 or scales.ndim != 2 or scales.shape[0] != q.shape[0]
            or scales.shape[1] == 0 or q.shape[1] % scales.shape[1]):
        raise ValueError(
            f"dequantize_int8 takes q [m, n] and scales [m, n/block], got "
            f"{tuple(q.shape)} and {tuple(scales.shape)}"
        )
    if q.is_cuda:
        return _dequantize_cuda(q, scales, out_dtype)
    return _dequantize_plain(q, scales, out_dtype)


def quantize_any(x: torch.Tensor, block: int = DEFAULT_BLOCK):
    """Quantize a tensor of any shape: flattened, zero-padded to a block
    multiple, quantized as one [1, padded] row -> (q, s, shape, pad)."""
    flat = x.reshape(-1)
    pad = (-flat.numel()) % block
    if pad:
        flat = F.pad(flat, (0, pad))
    q, s = quantize_int8(flat.reshape(1, -1), block)
    return q, s, tuple(x.shape), pad


def dequantize_any(q, s, shape, pad, out_dtype=torch.float32):
    """Inverse of `quantize_any`: the padding dropped, `shape` restored."""
    flat = dequantize_int8(q, s, out_dtype).reshape(-1)
    if pad:
        flat = flat[:-pad]
    return flat.reshape(shape)


def stochastic_round_int8(
    x: torch.Tensor, block: int = DEFAULT_BLOCK,
    generator: Optional[torch.Generator] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Unbiased int8 quantization (E[dequant] == x): floor plus a
    Bernoulli draw on the fractional part, the JAX package's
    `stochastic_round_int8`. x: [m, n] with n % block == 0 -> (q int8
    [m, n], scales f32 [m, n/block]).

    The scale is amax / 127 with a true division (1.0 where amax is 0),
    not the quantize kernel's amax * f32(1/127): JAX's function is
    plain XLA code, which divides here. The uniform draws come from
    `generator` (a torch.Generator on x's device; the default
    generator when None), so the bits are torch's, not jax.random's:
    the scales take no random bits and equal JAX's; the rounding
    agrees with it only in distribution. Plain PyTorch on either
    device: JAX runs no kernel here either."""
    if x.ndim != 2 or x.shape[1] % block:
        raise ValueError(
            f"stochastic_round_int8 takes [m, n] with n % block == 0, "
            f"got {tuple(x.shape)} and block {block}"
        )
    m, n = x.shape
    xf = x.float()
    amax = xf.abs().reshape(m, n // block, block).amax(dim=2)
    # a tensor divisor: on CUDA, PyTorch divides by a Python scalar as a
    # product with its reciprocal (the quantize kernel's formula)
    scale = torch.where(amax > 0, amax / torch.full_like(amax, INT8_MAX),
                        1.0)
    xs = xf / scale.repeat_interleave(block, dim=1)
    lo = torch.floor(xs)
    u = torch.rand((m, n), generator=generator, device=x.device,
                   dtype=torch.float32)
    q = torch.clamp(lo + (u < xs - lo).float(), -INT8_MAX, INT8_MAX)
    return q.to(torch.int8), scale


# ---------------------------------------------------------------------------
# the quantized weight
# ---------------------------------------------------------------------------


class QuantizedWeight:
    """Per-block int8 weight in output-major (transposed) layout.

    q8: int8 [..., O, K] (leading dims: stacked layers), blocks of size
    `block` along the last (contraction) dim; s8: f32 [..., O, K/block].
    Indexing the leading dim slices both (one layer of a stack). The
    fields are fixed once built: the dqmm wrapper checks q8, s8 and
    block once per weight (`_checked_on`), not at every launch."""

    __slots__ = ("q8", "s8", "block", "_slices", "_checked_on", "_s8q")

    def __init__(self, q8: torch.Tensor, s8: torch.Tensor, block: int):
        self.q8 = q8
        self.s8 = s8
        self.block = int(block)
        self._slices = {}
        # the CUDA device index this weight passed the kernel's checks on
        self._checked_on = None
        # the scales as the prefill kernel's TMA reads them (set by the
        # checks): s8 itself, or a copy with rows padded to 4 blocks
        self._s8q = None

    @property
    def shape(self):
        """Shape of the DENSE weight this stands in for ([..., K, O])."""
        *lead, o, k = self.q8.shape
        return tuple(lead) + (k, o)

    def __getitem__(self, idx) -> "QuantizedWeight":
        """A slice of both tensors. An int index (one layer) returns the
        same object every time, so a decode step, which slices every
        layer, launches on weights whose checks already passed."""
        if type(idx) is not int:
            return QuantizedWeight(self.q8[idx], self.s8[idx], self.block)
        w = self._slices.get(idx)
        if w is None:
            w = QuantizedWeight(self.q8[idx], self.s8[idx], self.block)
            self._slices[idx] = w
        return w

    def __repr__(self):
        return (f"QuantizedWeight(q8={tuple(self.q8.shape)}, "
                f"s8={tuple(self.s8.shape)}, block={self.block})")


def weight_quant_block(k: int, cap: int = DEFAULT_BLOCK) -> int:
    """Quant block for a contraction dim of size `k`: the largest
    power-of-two divisor of k, capped at `cap`; 0 when k has no even
    divisor >= 8 (such a weight stays dense)."""
    b = 1
    while b < cap and k % (b * 2) == 0:
        b *= 2
    return b if b >= 8 else 0


def _dq_weight(q8: torch.Tensor, s8: torch.Tensor, block: int, dtype):
    """Dequantize output-major q8 [..., O, K] to `dtype`: scales
    broadcast over their block, multiply in f32, cast (round to
    nearest even) — the JAX `_dq_weight`, and what the dqmm kernel
    feeds its tensor cores."""
    *lead, o, k = q8.shape
    q = q8.float().reshape(*lead, o, k // block, block)
    return (q * s8[..., None]).reshape(*lead, o, k).to(dtype)


# ---------------------------------------------------------------------------
# kernel 7: fused dequant-matmul
# ---------------------------------------------------------------------------


def quantized_matmul_reference(x: torch.Tensor, w: QuantizedWeight):
    """The kernel's function in plain PyTorch: x [T, K] . dequant(w)^T
    -> [T, O], dequantized to x's dtype, products summed in f32 (as
    the JAX `_dqmm_dot` asks with preferred_element_type=f32; bf16
    products are exact in f32), the output rounded once to x's dtype."""
    wt = _dq_weight(w.q8, w.s8, w.block, x.dtype)
    return (x.float() @ wt.float().t()).to(x.dtype)


def dqmm_supports(t: int, k: int, o: int, block: int) -> bool:
    """Whether the dqmm kernels take x [t, k] against a weight [o, k]
    quantized at `block`: JAX's gate, every T, K and O of at least 1
    and any block that divides K."""
    return t >= 1 and o >= 1 and k >= 1 and block >= 1 and k % block == 0


def _dqmm_fast(k: int, block: int) -> bool:
    """Whether the decode and prefill kernels take this weight (with bf16
    x): K a multiple of the 64-wide chunk, the block a power of two
    >= 16 (a lane's 16 values share one scale). Other weights, and f32
    x, take the general variant."""
    return (k % _DQMM_CHUNK == 0 and block >= _DQMM_MIN_BLOCK
            and block & (block - 1) == 0)


def _dec_tma_work(k: int, o: int) -> Tuple[int, int]:
    """(stages, stages a tile) of the TMA-ring decode kernel: its work
    sequence is (64-output tile, 256-value K range), K fastest."""
    kst = -(-k // _DQMM_DEC_TMA_KS)
    return -(-o // _DQMM_TILES[_DQMM_DECODE_TMA][1]) * kst, kst


def _share_start(b: int, total: int, grid: int) -> int:
    """First unit of block b's even share (csrc/hopper.cuh)."""
    return b * total // grid


def _share_block(s: int, total: int, grid: int) -> int:
    """The block whose even share holds unit s (csrc/hopper.cuh)."""
    return ((s + 1) * grid - 1) // total


@functools.lru_cache(maxsize=None)
def _dqmm_plan(t: int, k: int, o: int, sms: int = _build.H100_SMS,
               block: int = DEFAULT_BLOCK):
    """(variant, splits, chunks per split, grid) for x [t, k] . w [o, k]
    quantized at `block` on a card with `sms` SMs. T <= 16 takes the
    TMA-ring decode kernel (variant 3: splits = the most blocks that
    share one output tile, chunks per split = the most 256-value stages
    a block takes) where the block is 64 or more, else the mma.sync
    decode kernel (variant 0: grid = its tiles times its K splits). The
    prefill kernel (variants 1, 2) is persistent: one block an SM at
    most, walking its work units (tiles times splits)."""
    chunks = k // _DQMM_CHUNK
    total, kst = _dec_tma_work(k, o)
    # two blocks an SM; where the tiles alone fill fewer, the grid is the
    # tiles times the K splits that fit (so a tile's pieces are equal and
    # finish together), at least two stages a piece
    tiles, cap = total // kst, _DQMM_DEC_TMA_BLOCKS_PER_SM * sms
    grid = cap if tiles >= cap else tiles * max(
        1, min(cap // tiles, kst // _DQMM_DEC_TMA_MIN_STAGES))
    # (its shares are counted in 32 bits: total * (grid + 1) < 2^32)
    if (t <= _DQMM_TILES[0][0] and block >= _DQMM_DEC_TMA_MIN_BLOCK
            and total * (grid + 1) < 2 ** 32):
        splits = max(
            _share_block((tile + 1) * kst - 1, total, grid)
            - _share_block(tile * kst, total, grid) + 1
            for tile in range(tiles)
        )
        return _DQMM_DECODE_TMA, splits, -(-total // grid), grid
    if t <= _DQMM_TILES[0][0]:
        return _dqmm_mma_plan(t, k, o)
    variant = 1 if t < _DQMM_WIDE_FROM else 2
    bt, bo = _DQMM_TILES[variant]
    tiles = -(-t // bt) * -(-o // bo)
    splits = max(1, min(sms // tiles, chunks // _DQMM_MIN_CHUNKS_PER_SPLIT))
    per_split = -(-chunks // splits)
    splits = -(-chunks // per_split)
    return variant, splits, per_split, min(tiles * splits, sms)


def _dqmm_mma_plan(t: int, k: int, o: int):
    """The mma.sync decode kernel's plan (variant 0, T <= 16): its grid
    is its tiles times its K splits, and a split's partials are summed
    by a second kernel."""
    chunks = k // _DQMM_CHUNK
    bt, bo = _DQMM_TILES[_DQMM_DECODE]
    blocks = -(-t // bt) * -(-o // bo)
    want = -(-_DQMM_TARGET_BLOCKS // blocks)
    splits = max(1, min(want, chunks // _DQMM_MIN_CHUNKS_PER_SPLIT))
    splits = max(splits, -(-chunks // _DQMM_DECODE_MAX_CHUNKS))
    per_split = -(-chunks // splits)
    splits = -(-chunks // per_split)
    return _DQMM_DECODE, splits, per_split, blocks * splits


def _check_dqmm_weight(w: QuantizedWeight, dev: int) -> None:
    """The kernel's checks of a weight, made once per weight and device:
    q8 int8 [O, K] and s8 f32 [O, K/block], contiguous and aligned on
    device `dev`, with a block that divides K."""
    _check_cuda("q8", w.q8, (torch.int8,), dev)
    _check_cuda("s8", w.s8, (torch.float32,), dev)
    if w.q8.ndim != 2:
        raise ValueError(f"dqmm takes one layer's q8 [O, K], got {w!r}")
    o, k = w.q8.shape
    if w.s8.shape != (o, k // w.block) or not dqmm_supports(1, k, o, w.block):
        raise ValueError(f"dqmm kernel does not take {w!r}")
    # TMA reads the scales in rows of a 16-byte multiple: 4 blocks
    pad = -(k // w.block) % 4
    w._s8q = F.pad(w.s8, (0, pad)).contiguous() if pad else w.s8
    w._checked_on = dev


def _dqmm_general(x: torch.Tensor, w: QuantizedWeight) -> torch.Tensor:
    """The general variant on checked operands: any block dividing K,
    any K, bf16 or f32 x; counted under "dqmm" and "dqmm_general"."""
    t, k = x.shape
    o = w.q8.shape[0]
    dev = x.get_device()
    y = x.new_empty((t, o))
    fn = _build.function(_DQMM, "dqmm_general", _DQMM_GENERAL_ARGTYPES)
    err = fn(int(x.dtype == torch.float32), x.data_ptr(), w.q8.data_ptr(),
             w.s8.data_ptr(), y.data_ptr(), t, k, o, w.block,
             _build.current_stream(dev))
    _build.count_launch(_DQMM)
    _build.count_launch(_DQMM_GENERAL)
    _build.check(err, _DQMM, f"x{tuple(x.shape)} q8{tuple(w.q8.shape)} "
                 f"block {w.block}")
    return y


def _dqmm_cuda(x: torch.Tensor, w: QuantizedWeight,
               decode: str = "auto") -> torch.Tensor:
    """The kernel the plan picks (the general variant for f32 x and the
    weights `_dqmm_fast` refuses); decode="mma" asks for the mma.sync
    decode kernel where the plan picks the TMA-ring one (T <= 16), to
    time the two on the same inputs."""
    dev = x.get_device()
    _check_cuda("x", x, (torch.bfloat16, torch.float32), dev)
    if w._checked_on != dev:
        _check_dqmm_weight(w, dev)
    t, k = x.shape
    o, kw = w.q8.shape
    if kw != k or t < 1:
        raise ValueError(
            f"dqmm: x{tuple(x.shape)} does not match q8{tuple(w.q8.shape)}"
        )
    if decode not in ("auto", "mma"):
        raise ValueError(f"unknown decode kernel {decode!r}")
    if x.dtype == torch.float32 or not _dqmm_fast(k, w.block):
        return _dqmm_general(x, w)
    variant, splits, per_split, grid = _dqmm_plan(
        t, k, o, _build.sm_count(dev), w.block)
    if variant == _DQMM_DECODE_TMA and decode == "mma":
        variant, splits, per_split, grid = _dqmm_mma_plan(t, k, o)
    y = x.new_empty((t, o))
    if variant == _DQMM_DECODE_TMA:
        part = x.new_empty((2 * grid, _DQMM_DEC_TMA_SLOT),
                           dtype=torch.float32)
        counters = _build.zeroed_counters(
            dev, -(-o // _DQMM_TILES[_DQMM_DECODE_TMA][1]))
        fn = _build.function(_DQMM, "dqmm_decode_tma_bf16",
                             _DQMM_DEC_TMA_ARGTYPES)
        err = fn(
            x.data_ptr(), w.q8.data_ptr(), w._s8q.data_ptr(), y.data_ptr(),
            part.data_ptr(), counters.data_ptr(), t, k, o, w.block, grid,
            _build.current_stream(dev),
        )
        _build.count_launch(_DQMM)
        _build.count_launch(_DQMM_DEC_TMA)
        _build.check(err, _DQMM, f"x{tuple(x.shape)} q8{tuple(w.q8.shape)}")
        return y
    part = (
        x.new_empty((splits, t, o), dtype=torch.float32)
        if splits > 1 else None
    )
    fn = _build.function(_DQMM, "dqmm_bf16", _DQMM_ARGTYPES)
    err = fn(
        x.data_ptr(), w.q8.data_ptr(), w.s8.data_ptr(), w._s8q.data_ptr(),
        y.data_ptr(),
        part.data_ptr() if part is not None else None,
        t, k, o, w.block, variant, splits, per_split, grid,
        _build.current_stream(dev),
    )
    _build.count_launch(_DQMM)
    if variant:
        _build.count_launch(_DQMM_WS)
    _build.check(err, _DQMM, f"x{tuple(x.shape)} q8{tuple(w.q8.shape)}")
    return y


def use_quant_matmul_kernel(tp: int = 1) -> bool:
    """JAX's kernel-vs-reference gate for the fused dequant matmul
    (:268): tp > 1 stays on the reference (dequantize, then one
    product), where the weights are split over the output axis; JAX
    names a per-shard kernel a follow-up. At tp = 1 the device decides:
    the kernel for CUDA tensors, its plain version on the CPU."""
    return tp == 1


def quantized_matmul(x: torch.Tensor, w: QuantizedWeight,
                     tp: int = 1) -> torch.Tensor:
    """Dequant-fused ``x @ dense(w)`` for an output-major quantized
    weight; x may carry leading batch dims ([..., K] -> [..., O]). The
    kernel for CUDA tensors at tp = 1, the plain version for CPU
    tensors and at tp > 1 (`use_quant_matmul_kernel`)."""
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    if x2.is_cuda and use_quant_matmul_kernel(tp):
        y = _dqmm_cuda(x2.contiguous(), w)
    else:
        y = quantized_matmul_reference(x2, w)
    return y.reshape(*lead, y.shape[-1])


def matmul_any(x: torch.Tensor, w, tp: int = 1) -> torch.Tensor:
    """The models' one matmul dispatch: a dense weight takes ``x @ w``
    exactly as before (weight_quant="none" computes what it always
    did); a QuantizedWeight takes the fused dequant path (the reference
    at tp > 1, as JAX's gate says)."""
    if isinstance(w, QuantizedWeight):
        return quantized_matmul(x, w, tp=tp)
    return x @ w


# ---------------------------------------------------------------------------
# compressed collectives (the quant_reduce equivalent)
# ---------------------------------------------------------------------------
#
# JAX runs these inside shard_map over a mesh axis; here each rank of a
# torch.distributed process group calls them with its own contribution.
# The wire format is JAX's: the int8 payload and the f32 scales of
# `quantize_any` (kernel 5 on the card), dequantized by kernel 6.


def _group_or_world(group):
    import torch.distributed as dist

    if group is None:
        if not (dist.is_available() and dist.is_initialized()):
            raise RuntimeError(
                "the compressed collectives need a torch.distributed world "
                "(runtime.init() or init_process_group)")
        group = dist.group.WORLD
    return group


def _ring_reduce_scatter_q(x: torch.Tensor, group, block: int
                           ) -> torch.Tensor:
    """Ring reduce-scatter with the int8 wire format (JAX
    `_ring_reduce_scatter_q`): x [n_chunks * c, ...] is this rank's
    input; returns this rank's reduced chunk [c, ...]. Each of the n-1
    hops sends one quantized chunk to the next rank, which dequantizes
    it and adds its own share of that chunk."""
    import torch.distributed as dist

    from dlrover_tpu_torch.runtime import wire_tensor

    n = dist.get_world_size(group)
    rank = dist.get_rank(group)
    if x.shape[0] % n != 0:
        raise ValueError(
            f"ring reduce-scatter needs the local leading dim "
            f"({x.shape[0]}) divisible by axis size ({n}); pad the "
            "input (global leading dim must divide by n*n)"
        )
    chunks = x.shape[0] // n
    nxt = dist.get_global_rank(group, (rank + 1) % n)
    prv = dist.get_global_rank(group, (rank + n - 1) % n)

    def chunk_at(i):
        return x[i * chunks:(i + 1) * chunks]

    # travelling-accumulator ring: rank r starts the accumulator for
    # chunk (r-1); each hop the accumulator moves one rank forward and
    # picks up that rank's local share, so after n-1 hops rank r holds
    # the fully reduced chunk r
    acc = chunk_at((rank + n - 1) % n)
    for step in range(n - 1):
        q, s, shape, pad = quantize_any(acc, block)
        # under gloo a hop's payload travels through host copies
        q, s = wire_tensor(q, group, p2p=True), wire_tensor(s, group, p2p=True)
        rq, rs = torch.empty_like(q), torch.empty_like(s)
        for work in dist.batch_isend_irecv([
                dist.P2POp(dist.isend, q, nxt, group),
                dist.P2POp(dist.isend, s, nxt, group),
                dist.P2POp(dist.irecv, rq, prv, group),
                dist.P2POp(dist.irecv, rs, prv, group)]):
            work.wait()
        recv = dequantize_any(rq.to(x.device), rs.to(x.device), shape, pad)
        idx = (rank + n - 2 - step) % n
        acc = recv + chunk_at(idx)
    return acc


def quantized_reduce_scatter(
    x: torch.Tensor, group=None, block: int = DEFAULT_BLOCK
) -> torch.Tensor:
    """Reduce-scatter over `group` (default: the world) with int8
    payloads. Each rank passes its input [n*c, ...] (JAX's
    `P(axis)`-sharded input's local shard) and gets its summed chunk
    [c, ...], rank r chunk r."""
    return _ring_reduce_scatter_q(x, _group_or_world(group), block)


def quantized_all_reduce_tree(grads, group=None, block: int = DEFAULT_BLOCK):
    """Compressed gradient all-reduce over a pytree of this rank's
    contributions (JAX's leaf [n, ...] stacked over the mesh axis is
    each rank's own leaf here). Each rank quantizes its leaf once (its
    own scales), all-gathers the int8 payload and scales (1/4 the f32
    wire bytes), dequantizes every contribution in one call and sums
    them in f32. Returns the sum, the same on every rank. Every rank's
    leaf must have the same shape (JAX's stacked leaf of the axis
    size): ValueError otherwise, on every rank."""
    import torch.distributed as dist
    from torch.utils._pytree import tree_flatten, tree_unflatten

    group = _group_or_world(group)
    n = dist.get_world_size(group)
    leaves, spec = tree_flatten(grads)
    shapes = [None] * n
    dist.all_gather_object(shapes, [tuple(g.shape) for g in leaves],
                           group=group)
    for i, g in enumerate(leaves):
        if any(s[i] != tuple(g.shape) for s in shapes):
            raise ValueError(
                f"leaf {i}: the ranks' contributions have shapes "
                f"{[s[i] for s in shapes]}; each rank passes one of the "
                "same shape")

    def one(g):
        q, s, shape, pad = quantize_any(g, block)
        qg = [torch.empty_like(q) for _ in range(n)]
        sg = [torch.empty_like(s) for _ in range(n)]
        dist.all_gather(qg, q, group=group)
        dist.all_gather(sg, s, group=group)
        deq = dequantize_int8(torch.cat(qg), torch.cat(sg))
        total = torch.sum(deq, dim=0)
        if pad:
            total = total[:-pad]
        return total.reshape(shape)

    return tree_unflatten([one(g) for g in leaves], spec)
