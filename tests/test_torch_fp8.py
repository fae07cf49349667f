"""`fp8_dot` (parallel/amp.py) against the JAX package's on the same
numbers: the delayed-scaling forward (e4m3 operands scaled from the amax
histories), the just-in-time e5m2 cotangent in the backward, and the
histories step for step.

On the CPU both sides run the fp8 products as f32 products of the fp8
values (JAX's XLA `jnp.dot` with f32 accumulation; the port's plain
version upcasts), so they differ only in the order of the f32 sums.
With integer inputs of at most 8 in magnitude every product and sum of
the quantized values is exact in f32 (multiples of 8 below 2^24), so
the histories (whose `amax_g` is max |y|), y, dx and dw must be equal
bit for bit. With normal inputs, y, dx and dw are held within 2^-10 of
their largest |value|: the same fp8 values and f32 products, sums in
another order."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dlrover_tpu.parallel import amp as jamp
from dlrover_tpu_torch.parallel import amp

STEPS = 3
NORMAL_REL = 2 ** -10


def _run(x_np, w_np, g_np, history_len):
    """STEPS steps of both fp8_dots on the same x, w and cotangent g,
    each from its own carried state. Yields (jax (y, dx, dw, state),
    port (y, dx, dw, state)) per step."""
    jst = jamp.init_fp8_state(history_len)
    tst = amp.init_fp8_state(history_len, device="cpu")
    for _ in range(STEPS):
        def jloss(x, w):
            y, st = jamp.fp8_dot(x, w, jst)
            return jnp.sum(y * g_np), (y, st)

        (_, (jy, jst_new)), (jdx, jdw) = jax.value_and_grad(
            jloss, argnums=(0, 1), has_aux=True)(jnp.asarray(x_np),
                                                 jnp.asarray(w_np))
        tx = torch.tensor(x_np, requires_grad=True)
        tw = torch.tensor(w_np, requires_grad=True)
        ty, tst_new = amp.fp8_dot(tx, tw, tst)
        tdx, tdw = torch.autograd.grad(ty, (tx, tw), torch.tensor(g_np))
        yield ((np.asarray(jy), np.asarray(jdx), np.asarray(jdw), jst_new),
               (ty.detach().numpy(), tdx.numpy(), tdw.numpy(), tst_new))
        jst, tst = jst_new, tst_new


@pytest.mark.parametrize("history_len", [4, 16])
def test_fp8_histories_and_values_equal_jax_on_integers(history_len):
    rng = np.random.default_rng(0)
    x = rng.integers(-8, 9, (32, 64)).astype(np.float32)
    w = rng.integers(-8, 9, (64, 48)).astype(np.float32)
    g = rng.integers(-8, 9, (32, 48)).astype(np.float32)
    for step, (j, t) in enumerate(_run(x, w, g, history_len)):
        for name, a, b in zip(("y", "dx", "dw"), j[:3], t[:3]):
            assert a.dtype == b.dtype == np.float32, name
            np.testing.assert_array_equal(b, a, err_msg=f"{name} {step}")
        for name, a, b in zip(amp.Fp8State._fields, j[3], t[3]):
            assert b.dtype == torch.float32 and b.shape == (history_len,)
            np.testing.assert_array_equal(b.numpy(), np.asarray(a),
                                          err_msg=f"{name} {step}")


def test_fp8_values_within_tolerance_on_normals():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((64, 128)).astype(np.float32)
    w = (rng.standard_normal((128, 32)) * 0.05).astype(np.float32)
    g = rng.standard_normal((64, 32)).astype(np.float32)
    for step, (j, t) in enumerate(_run(x, w, g, 16)):
        for name, a, b in zip(("y", "dx", "dw"), j[:3], t[:3]):
            err = np.abs(a - b).max()
            assert err <= NORMAL_REL * np.abs(a).max(), (name, step, err)
        # the operand histories hold exact maxima
        for name in ("amax_x", "amax_w"):
            np.testing.assert_array_equal(getattr(t[3], name).numpy(),
                                          np.asarray(getattr(j[3], name)))
        np.testing.assert_allclose(t[3].amax_g.numpy(),
                                   np.asarray(j[3].amax_g), rtol=1e-6)
    # fp8 against the f32 product: within fp8's resolution
    ref = x @ w
    assert np.abs(t[0] - ref).max() <= 0.1 * np.abs(ref).max()


def test_fp8_scale_rules():
    """The scale is fp8_max / max(history), 1 for an empty history; the
    roll puts the newest amax first."""
    hist = torch.tensor([0.0, 0.0, 0.0])
    assert amp._scale_from_history(hist, amp.E4M3_MAX).item() == 1.0
    hist = amp._roll_in(hist, torch.tensor(2.0))
    hist = amp._roll_in(hist, torch.tensor(4.0))
    assert hist.tolist() == [4.0, 2.0, 0.0]
    assert amp._scale_from_history(hist, amp.E4M3_MAX).item() == 112.0
    j = jamp._roll_in(jamp._roll_in(jnp.zeros(3), 2.0), 4.0)
    assert np.asarray(j).tolist() == hist.tolist()
