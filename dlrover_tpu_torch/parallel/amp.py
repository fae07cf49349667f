"""Mixed precision: dtype policies and dynamic loss scaling — counterpart
of dlrover_tpu/parallel/amp.py.

The default keeps f32 params with bf16 compute and needs no loss
scaling (bf16's exponent range equals f32's); `LossScaleState` is kept
for f16 experiments and parity. `fp8_dot` is the JAX module's
delayed-scaling fp8 matmul: e4m3 operands scaled from amax histories in
the forward, the cotangent scaled to e5m2 from its own amax in the
backward. JAX leaves its fp8 products to XLA (`jnp.dot`, no Pallas
kernel); on the card they are `torch._scaled_mm` (fp8 tensor cores,
f32 out; its layout and multiple-of-16 rules apply, and a shape it
refuses raises), on the CPU the fp8 operands upcast to f32.
"""

from dataclasses import dataclass
from typing import Any, NamedTuple, Optional, Tuple

import torch
from torch.utils._pytree import tree_leaves, tree_map

from dlrover_tpu_torch._device import DeviceLike, resolve_device


@dataclass(frozen=True)
class Policy:
    """What dtype each tensor class lives in (haiku/flax mp convention)."""

    param_dtype: torch.dtype = torch.float32
    compute_dtype: torch.dtype = torch.bfloat16
    output_dtype: torch.dtype = torch.float32

    def cast_to_compute(self, tree):
        return _cast_floating(tree, self.compute_dtype)


def _cast_floating(tree, dtype: torch.dtype):
    """Every floating tensor of a nested dict/list/tuple cast to `dtype`
    (differentiably; a tensor already in `dtype` is returned as is)."""

    def cast(x: Any):
        if isinstance(x, torch.Tensor) and x.is_floating_point():
            return x.to(dtype)
        return x

    return tree_map(cast, tree)


def get_policy(name: str) -> Policy:
    """'bf16' (default compute policy), 'f32', 'half' (pure bf16)."""
    if name in ("bf16", "mixed", "amp"):
        return Policy()
    if name in ("f32", "full"):
        return Policy(torch.float32, torch.float32, torch.float32)
    if name in ("half", "pure_bf16"):
        return Policy(torch.bfloat16, torch.bfloat16, torch.bfloat16)
    raise ValueError(f"unknown precision policy: {name}")


class LossScaleState(NamedTuple):
    scale: torch.Tensor        # f32 scalar
    good_steps: torch.Tensor   # i32 scalar


def init_loss_scale(
    initial: float = 2.0 ** 15, device: DeviceLike = None
) -> LossScaleState:
    """The loss-scale state on `device` (None: the card, as every entry
    point of the port; the CPU only when the caller names it)."""
    device = resolve_device(device)
    return LossScaleState(
        scale=torch.tensor(initial, dtype=torch.float32, device=device),
        good_steps=torch.tensor(0, dtype=torch.int32, device=device),
    )


def scale_loss(loss: torch.Tensor, state: LossScaleState) -> torch.Tensor:
    return loss * state.scale.to(loss.dtype)


def unscale_grads(grads, state: LossScaleState):
    inv = 1.0 / state.scale.float()
    return tree_map(lambda g: (g.float() * inv).to(g.dtype), grads)


def all_finite(grads) -> torch.Tensor:
    finite: Optional[torch.Tensor] = None
    for g in tree_leaves(grads):
        ok = torch.isfinite(g).all()
        finite = ok if finite is None else finite & ok
    return torch.tensor(True) if finite is None else finite


def adjust_loss_scale(
    state: LossScaleState,
    grads_finite: torch.Tensor,
    growth_interval: int = 2000,
    growth_factor: float = 2.0,
    backoff_factor: float = 0.5,
    max_scale: float = 2.0 ** 24,
) -> LossScaleState:
    """torch.cuda.amp.GradScaler update rule, branchless."""
    finite = grads_finite.to(state.scale.device)
    grown = state.good_steps + 1 >= growth_interval
    new_scale = torch.where(
        finite,
        torch.where(
            grown,
            torch.clamp(state.scale * growth_factor, max=max_scale),
            state.scale,
        ),
        torch.clamp(state.scale * backoff_factor, min=1.0),
    )
    new_good = torch.where(
        finite & ~grown, state.good_steps + 1, torch.zeros_like(state.good_steps)
    )
    return LossScaleState(scale=new_scale, good_steps=new_good)


# ---------------------------------------------------------------------------
# fp8 delayed scaling
# ---------------------------------------------------------------------------

E4M3_MAX = 448.0
E5M2_MAX = 57344.0


class Fp8State(NamedTuple):
    """Per-matmul amax histories (delayed scaling): x, kernel, grad."""

    amax_x: torch.Tensor  # f32 [history_len]
    amax_w: torch.Tensor
    amax_g: torch.Tensor


def init_fp8_state(history_len: int = 16,
                   device: DeviceLike = None) -> Fp8State:
    """Zero histories on `device` (None: the card)."""
    z = torch.zeros((history_len,), dtype=torch.float32,
                    device=resolve_device(device))
    return Fp8State(amax_x=z, amax_w=z.clone(), amax_g=z.clone())


def _scale_from_history(amax_hist: torch.Tensor,
                        fp8_max: float) -> torch.Tensor:
    amax = amax_hist.max()
    # first steps: no history yet -> scale 1
    return torch.where(amax > 0, fp8_max / amax, torch.ones_like(amax))


def _roll_in(hist: torch.Tensor, amax: torch.Tensor) -> torch.Tensor:
    out = torch.roll(hist, 1)
    out[0] = amax
    return out


def _quant(x, scale, dtype, qmax):
    return (x.float() * scale).clamp(-qmax, qmax).to(dtype)


def _fp8_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b of fp8 operands, f32 out: `torch._scaled_mm` on the card
    (a row-major, b column-major, unit scales), the operands upcast to
    f32 on the CPU."""
    if not a.is_cuda:
        return a.float() @ b.float()
    one = torch.ones((), dtype=torch.float32, device=a.device)
    return torch._scaled_mm(a.contiguous(), b.t().contiguous().t(),
                            scale_a=one, scale_b=one,
                            out_dtype=torch.float32)


class _Fp8Dot(torch.autograd.Function):
    """JAX's `_fp8_dot` custom VJP: y = (qx qw) / (sx sw) with e4m3
    operands; the backward scales the observed cotangent to e5m2 just in
    time (`_fp8_dot_bwd`)."""

    @staticmethod
    def forward(ctx, x, w, sx, sw):
        qx = _quant(x, sx, torch.float8_e4m3fn, E4M3_MAX)
        qw = _quant(w, sw, torch.float8_e4m3fn, E4M3_MAX)
        ctx.save_for_backward(qx, qw, sx, sw)
        ctx.dtypes = (x.dtype, w.dtype)
        return _fp8_mm(qx, qw) / (sx * sw)

    @staticmethod
    def backward(ctx, g):
        qx, qw, sx, sw = ctx.saved_tensors
        gmax = g.abs().max().float()
        sg = torch.where(gmax > 0, E5M2_MAX / gmax, torch.ones_like(gmax))
        qg = _quant(g, sg, torch.float8_e5m2, E5M2_MAX)
        dx = _fp8_mm(qg, qw.t()) / (sg * sw)
        dw = _fp8_mm(qx.t(), qg) / (sx * sg)
        return dx.to(ctx.dtypes[0]), dw.to(ctx.dtypes[1]), None, None


def fp8_dot(x: torch.Tensor, w: torch.Tensor,
            state: Fp8State) -> Tuple[torch.Tensor, Fp8State]:
    """2-D matmul in fp8; returns the f32 result and the updated amax
    histories (JAX `fp8_dot`). The forward's operands use delayed scaling
    (the histories' max); the gradient path scales with the cotangent's
    own amax inside the backward, so `amax_g` only records |y|'s max."""
    sx = _scale_from_history(state.amax_x, E4M3_MAX)
    sw = _scale_from_history(state.amax_w, E4M3_MAX)
    y = _Fp8Dot.apply(x, w, sx, sw)
    with torch.no_grad():
        new_state = Fp8State(
            amax_x=_roll_in(state.amax_x, x.abs().max().float()),
            amax_w=_roll_in(state.amax_w, w.abs().max().float()),
            amax_g=_roll_in(state.amax_g, y.abs().max().float()),
        )
    return y, new_state
