"""The port's optimizer package (dlrover_tpu_torch/optim) and its int8
dequantize (dlrover_tpu_torch/ops/quantization.py `dequantize_int8`,
`quantize_any`, `dequantize_any`) against the JAX package, on the same
numpy-seeded inputs. On the CPU the port's wrappers run their kernels'
plain versions; the JAX kernels run in Pallas interpret mode, and the
JAX optimizers under `jax.jit`, as a training step runs them.

What is held exactly, and the rule where it is not:
- `dequantize_int8`, `quantize_any`, `dequantize_any`: bit-equal (one
  IEEE f32 product per value, one rounding to the output type).
- int8 moments (`q_mu`, `q_nu`): equal, or one level apart in at most
  0.1% of the entries; their scales within 1e-6 relative (8 f32 ulp).
  Two roundings differ. torch's CPU f32 `sqrt` is one ulp off the
  correctly rounded root for some 0.65% of inputs (XLA's CPU sqrt,
  numpy's and CUDA's `sqrtf` are correctly rounded), and under `jit`
  XLA fuses `b1 * m + (1 - b1) * g` so that it may round once where
  the port rounds twice. Either may move a block's largest |value|,
  and so its scale, by an ulp, and at a rounding tie an int8 by one
  level. Step 1 from the zero state has no fusible product of the old
  mu, so its mu bytes are equal; its nu goes through the sqrt.
- f32 moments (`Bf16AdamW`'s nu, `AGD`'s): within 1e-6 of the leaf's
  largest |value| (the fused rounding, where b1 * m and (1 - b1) * g
  nearly cancel); bf16 first moments equal, or one bf16 ulp apart in
  at most 0.1% of the entries.
- params: |port - JAX| <= 2^-20 |JAX| + lr * 2^-6 element by element:
  the update divides by the sqrt, and where an int8 level differs the
  update of that element moves by a fraction of a step.
- through `accelerate` the gradients themselves differ (within 1e-4 of
  each leaf's largest |gradient|, tests/test_torch_train.py): there
  each dequantized moment is held within one quantization level (its
  JAX scale) plus 1e-4 of the leaf's largest |moment| (|q| <= 127, so
  a scale moved by the gradients' error moves q * scale by at most
  that much), and each param leaf's distance from JAX's within 1e-2 of
  the distance JAX's has moved (L2 norms; the AdamW rule of
  tests/test_torch_train.py: Adam divides each gradient by its own
  magnitude, so an element whose gradient is near zero, where 1e-4 of
  the largest is no agreement, moves by up to lr either way).
- scalars (loss, grad norm) of an `accelerate` step: 1e-5 relative, as
  in tests/test_torch_train.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch.utils._pytree import tree_flatten_with_path

from dlrover_tpu.models import llama as jllama
from dlrover_tpu.ops import quantization as jq
from dlrover_tpu.optim import agd as jagd
from dlrover_tpu.optim import bf16_adam as jbf16_adam
from dlrover_tpu.optim import mup_learning_rates as j_mup_lrs
from dlrover_tpu.optim import mup_scale_init as j_mup_init
from dlrover_tpu.optim import sam_gradient as j_sam_gradient
from dlrover_tpu.optim import wsam as jwsam
from dlrover_tpu.optim.low_precision import int8_adam as jint8_adam
from dlrover_tpu.optim.mup import scale_updates_by_mup
from dlrover_tpu.parallel.accelerate import Strategy as JStrategy
from dlrover_tpu.parallel.accelerate import accelerate as jaccelerate
from dlrover_tpu.parallel.mesh import MeshSpec
from dlrover_tpu_torch.models import llama as tllama
from dlrover_tpu_torch.ops import _build
from dlrover_tpu_torch.ops import quantization as tq
from dlrover_tpu_torch.optim import (
    agd,
    bf16_adam,
    int8_adam,
    mup_learning_rates,
    mup_scale_init,
    sam_gradient,
    wsam,
)
from dlrover_tpu_torch.optim.low_precision import (
    Int8AdamW,
    int8_adam_state_from_numpy,
)
from dlrover_tpu_torch.optim.mup import mup_param_groups, path_str
from dlrover_tpu_torch.parallel.accelerate import Strategy, accelerate

Q_FLIP_SHARE = 1e-3
SCALE_REL = 1e-6
MOMENT_REL = 1e-6
PARAM_REL = 2.0 ** -20
PARAM_LR_FRAC = 2.0 ** -6
SCALAR_REL = 1e-5
GRAD_REL = 1e-4
ADAM_REL = 1e-2
# a tree with a leaf of several blocks, an odd-shaped one (91 values,
# padded to 128 at block 64) and a 1-D one; sorted names, the JAX
# flatten order, which the port's param lists follow here
SHAPES = {"odd": (7, 13), "v": (300,), "w": (32, 256)}
NAMES = sorted(SHAPES)
BLOCK = 64


# ---------------------------------------------------------------------------
# kernel 6 and the any-shape wrappers
# ---------------------------------------------------------------------------


def _int8_rows(rng, m, n, block):
    """Random int8 levels and scales, with one all-zero block at scale
    1.0 (what the quantizer writes for a zero block)."""
    q = rng.integers(-127, 128, size=(m, n)).astype(np.int8)
    s = (rng.random((m, n // block)) * 10.0 ** rng.uniform(
        -6, 1, size=(m, n // block))).astype(np.float32)
    q[0, :block] = 0
    s[0, 0] = 1.0
    return q, s


@pytest.mark.parametrize("out", ["f32", "bf16"])
@pytest.mark.parametrize("m,n,block",
                         [(1, 256, 256), (3, 512, 256), (9, 1024, 128)])
def test_dequantize_bits_equal_jax(m, n, block, out):
    jdt, tdt = {"f32": (jnp.float32, torch.float32),
                "bf16": (jnp.bfloat16, torch.bfloat16)}[out]
    q, s = _int8_rows(np.random.default_rng(m * n), m, n, block)
    want = jq.dequantize_int8(jnp.asarray(q), jnp.asarray(s), out_dtype=jdt)
    got = tq.dequantize_int8(torch.from_numpy(q), torch.from_numpy(s),
                             out_dtype=tdt)
    assert got.dtype == tdt and tuple(got.shape) == (m, n)
    assert got.view(torch.int16 if out == "bf16" else torch.int32).numpy(
    ).tobytes() == np.asarray(want).tobytes()


@pytest.mark.parametrize("shape,block", [((7, 13), 64), ((300,), 256),
                                         ((4, 64), 64), ((2, 3, 5), 8)])
def test_quantize_any_and_back_match_jax(shape, block):
    x = (np.random.default_rng(3).standard_normal(shape) * 0.1).astype(
        np.float32)
    jqq, jss, jshape, jpad = jq.quantize_any(jnp.asarray(x), block)
    tqq, tss, tshape, tpad = tq.quantize_any(torch.from_numpy(x), block)
    assert tshape == tuple(jshape) == shape and tpad == jpad
    assert tqq.numpy().tobytes() == np.asarray(jqq).tobytes()
    assert tss.numpy().tobytes() == np.asarray(jss).tobytes()
    want = jq.dequantize_any(jqq, jss, jshape, jpad)
    got = tq.dequantize_any(tqq, tss, tshape, tpad)
    assert tuple(got.shape) == shape
    assert got.numpy().tobytes() == np.asarray(want).tobytes()


def test_dequantize_refuses_bad_shapes():
    q = torch.zeros((2, 256), dtype=torch.int8)
    for s in (torch.ones(2, 3), torch.ones(3, 1), torch.ones(2, 0),
              torch.ones(512)):
        with pytest.raises(ValueError, match="dequantize_int8 takes"):
            tq.dequantize_int8(q, s)


# ---------------------------------------------------------------------------
# optimizer steps against the optax chains
# ---------------------------------------------------------------------------


def _tree(seed):
    rng = np.random.default_rng(seed)
    return {k: rng.standard_normal(s).astype(np.float32)
            for k, s in SHAPES.items()}


def _grads(seed, steps):
    """Per step and leaf, normal values at a scale of 1e-3 to 1."""
    rng = np.random.default_rng(seed)
    return [{k: (rng.standard_normal(s) * 10 ** rng.uniform(-3, 0)).astype(
        np.float32) for k, s in SHAPES.items()} for _ in range(steps)]


def _jax_stepper(opt):
    @jax.jit
    def step(g, state, p):
        updates, state = opt.update(g, state, p)
        return optax.apply_updates(p, updates), state

    return step


def _close_params(got, want, lr, what):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    tol = PARAM_REL * np.abs(want) + PARAM_LR_FRAC * lr
    bad = np.abs(got - want) > tol
    assert not bad.any(), (
        f"{what}: {int(bad.sum())} params off, max "
        f"{float(np.abs(got - want).max())}")


def _same_levels(got, want, what):
    """Equal, or one level (int8) / one ulp (bf16, as int16 bits) apart
    in at most Q_FLIP_SHARE of the entries."""
    got = np.asarray(got).astype(np.int32)
    want = np.asarray(want).astype(np.int32)
    diff = np.abs(got - want)
    assert diff.max(initial=0) <= 1, f"{what}: {int(diff.max())} levels"
    assert (diff > 0).mean() <= Q_FLIP_SHARE, (
        f"{what}: {int((diff > 0).sum())} of {diff.size} differ")


def _close_f32(got, want, what):
    """f32 moments: within MOMENT_REL of the leaf's largest |value|."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    err = np.abs(got - want).max(initial=0)
    assert err <= MOMENT_REL * np.abs(want).max(initial=0), (what, err)


def _close_rel(got, want, rel, what):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    err = np.abs(got - want) / np.maximum(np.abs(want), 1e-30)
    assert err.max(initial=0) <= rel, f"{what}: rel err {err.max()}"


def _check_int8_state(jstate, opt, tparams, step):
    s = jstate[0]
    assert int(s.count) == opt.count == step
    for p, k in zip(tparams, NAMES):
        st = opt.state[p]
        for m in ("mu", "nu"):
            jqv = np.asarray(getattr(s, "q_" + m)[k])
            assert st["q_" + m].shape == jqv.shape, (k, m)
            _same_levels(st["q_" + m].numpy(), jqv, f"step {step} {k} q_{m}")
            _close_rel(st["s_" + m].numpy(), getattr(s, "s_" + m)[k],
                       SCALE_REL, f"step {step} {k} s_{m}")


def _port_params(tree):
    return [torch.tensor(tree[k]) for k in NAMES]


def _run(jopt, topt_factory, tree, grads, lr, check, jstate=None,
         port_setup=None):
    """Step the JAX chain (jit) and the port's optimizer on the same
    params and grads, calling check(jstate, opt, params, step) after
    each step and comparing the params."""
    jp = {k: jnp.asarray(v) for k, v in tree.items()}
    jstate = jopt.init(jp) if jstate is None else jstate
    jstep = _jax_stepper(jopt)
    tparams = _port_params(tree)
    opt = topt_factory(tparams)
    if port_setup is not None:
        port_setup(opt)
    start = opt.count
    for i, g in enumerate(grads):
        jp, jstate = jstep({k: jnp.asarray(v) for k, v in g.items()},
                           jstate, jp)
        for p, k in zip(tparams, NAMES):
            p.grad = torch.from_numpy(g[k])
        opt.step()
        check(jstate, opt, tparams, start + i + 1)
        for p, k in zip(tparams, NAMES):
            _close_params(p.numpy(), jp[k], lr(i) if callable(lr) else lr,
                          f"step {start + i + 1} {k}")
    return jstate, opt


def _int8_case(case):
    """(JAX chain, port factory, lr) of one int8 test case."""
    lr, wd, jmask, tmask = 1e-2, 1e-4, None, None
    if case == "wd0":
        wd = 0.0
    elif case == "mask":
        wd = 0.1
        jmask = {"odd": True, "v": False, "w": True}
        tmask = lambda ps: [p.ndim == 2 for p in ps]  # noqa: E731
    elif case == "schedule":
        lr = optax.linear_schedule(1e-2, 1e-3, 5)
    jlr = lr
    tlr = (lambda c: float(jlr(c))) if callable(lr) else lr
    return (jint8_adam(jlr, weight_decay=wd, block=BLOCK, mask=jmask),
            int8_adam(tlr, weight_decay=wd, block=BLOCK, mask=tmask), tlr)


@pytest.mark.parametrize("case", ["wd0", "wd", "mask", "schedule"])
def test_int8_adam_steps_match_jax(case):
    jopt, factory, lr = _int8_case(case)
    _run(jopt, factory, _tree(0), _grads(1, 5), lr, _check_int8_state)


def test_int8_adam_first_step_bytes():
    """From the zero state the first step's mu is one correctly rounded
    op of g on both sides (b1 * 0 adds nothing, fused or not): its bytes
    equal JAX's. Its nu, stored as sqrt((1 - b2) * g^2), is where the
    CPU sqrt shows: JAX's bytes are those of numpy's correctly rounded
    sqrt, the port's those of torch's, and the two meet the rule."""
    jopt, factory, _ = _int8_case("wd")
    tree, (g,) = _tree(2), _grads(3, 1)
    jp = {k: jnp.asarray(v) for k, v in tree.items()}
    _, jstate = _jax_stepper(jopt)({k: jnp.asarray(v) for k, v in g.items()},
                                   jopt.init(jp), jp)
    tparams = _port_params(tree)
    opt = factory(tparams)
    for p, k in zip(tparams, NAMES):
        p.grad = torch.from_numpy(g[k])
    opt.step()
    for p, k in zip(tparams, NAMES):
        st = opt.state[p]
        for key in ("q_mu", "s_mu"):
            assert st[key].numpy().tobytes() == np.asarray(
                getattr(jstate[0], key)[k]).tobytes(), (k, key)
        root = np.sqrt(np.float32(1 - 0.999) * np.square(g[k]))
        for key, want in zip(("q_nu", "s_nu"), jq.quantize_any(
                jnp.asarray(root), BLOCK)[:2]):
            assert np.asarray(getattr(jstate[0], key)[k]).tobytes() == (
                np.asarray(want).tobytes()), (k, key)
    _check_int8_state(jstate, opt, tparams, 1)


def test_int8_adam_from_carried_state_matches_jax():
    """Three JAX steps, then its params and Int8AdamState carried across
    by int8_adam_state_from_numpy, then five more steps on both."""
    wd, lr = 1e-2, 1e-2
    jmask = {"odd": False, "v": True, "w": True}
    jopt = jint8_adam(lr, weight_decay=wd, block=BLOCK, mask=jmask)
    jp = {k: jnp.asarray(v) for k, v in _tree(4).items()}
    jstate = jopt.init(jp)
    jstep = _jax_stepper(jopt)
    for g in _grads(5, 3):
        jp, jstate = jstep({k: jnp.asarray(v) for k, v in g.items()},
                           jstate, jp)
    carried = {k: np.asarray(v) for k, v in jp.items()}
    st = jstate[0]
    leaves = {key: [np.asarray(getattr(st, key)[k]) for k in NAMES]
              for key in ("q_mu", "s_mu", "q_nu", "s_nu")}
    leaves["count"] = np.asarray(st.count)
    assert np.abs(leaves["q_mu"][2]).max() > 0    # a live state

    def load(opt):
        int8_adam_state_from_numpy(opt, leaves)
        assert opt.count == 3
        for i, p in enumerate(opt.param_groups[0]["params"]):
            for key in ("q_mu", "s_mu", "q_nu", "s_nu"):
                assert opt.state[p][key].numpy().tobytes() == (
                    leaves[key][i].tobytes())

    _run(jopt, int8_adam(lr, weight_decay=wd, block=BLOCK,
                         mask=[False, True, True]),
         carried, _grads(6, 5), lr, _check_int8_state, jstate=jstate,
         port_setup=load)


def test_int8_adam_state_from_numpy_refuses_other_shapes():
    opt = Int8AdamW(_port_params(_tree(0)), block=BLOCK)
    leaves = {key: [np.zeros(opt.state[p][key].shape, dtype=np.float32)
                    for p in opt.param_groups[0]["params"]]
              for key in ("q_mu", "s_mu", "q_nu", "s_nu")}
    leaves["count"] = 2
    bad = dict(leaves, q_nu=leaves["q_nu"][:2])
    with pytest.raises(ValueError, match="q_nu has 2 leaves"):
        int8_adam_state_from_numpy(opt, bad)
    bad = dict(leaves, s_mu=[np.zeros((1, 3))] * 3)
    with pytest.raises(ValueError, match="s_mu"):
        int8_adam_state_from_numpy(opt, bad)
    int8_adam_state_from_numpy(opt, leaves)
    assert opt.count == 2
    with pytest.raises(ValueError, match="mask has 1 entries"):
        int8_adam(mask=[True])(_port_params(_tree(0)))


def _check_bf16_state(jstate, opt, tparams, step):
    s = jstate[0]
    assert int(s.count) == opt.count == step
    for p, k in zip(tparams, NAMES):
        mu = opt.state[p]["mu"]
        assert mu.dtype == torch.bfloat16
        _same_levels(mu.view(torch.int16).numpy(),
                     np.asarray(s.mu[k]).view(np.int16), f"{k} mu")
        _close_f32(opt.state[p]["nu"].numpy(), s.nu[k], f"{k} nu")


@pytest.mark.parametrize("wd,masked", [(0.0, False), (0.1, True)])
def test_bf16_adam_steps_match_jax(wd, masked):
    jmask = {"odd": True, "v": False, "w": True} if masked else None
    tmask = [True, False, True] if masked else None
    _run(jbf16_adam(1e-2, weight_decay=wd, mask=jmask),
         bf16_adam(1e-2, weight_decay=wd, mask=tmask),
         _tree(7), _grads(8, 5), 1e-2, _check_bf16_state)


def _check_agd_state(jstate, opt, tparams, step):
    s = jstate[0]
    assert int(s.count) == opt.count == step
    for p, k in zip(tparams, NAMES):
        for m in ("mu", "nu", "prev_grad"):
            _close_f32(opt.state[p][m].numpy(), getattr(s, m)[k], f"{k} {m}")


@pytest.mark.parametrize("wd,masked", [(0.0, False), (0.1, True)])
def test_agd_steps_match_jax(wd, masked):
    jmask = {"odd": False, "v": True, "w": True} if masked else None
    tmask = [False, True, True] if masked else None
    _run(jagd(1e-2, delta=1e-3, weight_decay=wd, mask=jmask),
         agd(1e-2, delta=1e-3, weight_decay=wd, mask=tmask),
         _tree(9), _grads(10, 5), 1e-2, _check_agd_state)


def test_int8_adam_converges_on_quadratic():
    """The port of TestInt8Adam.test_converges_on_quadratic."""
    target = torch.linspace(-1.0, 1.0, 512).reshape(2, 256)
    w = torch.zeros((2, 256))
    opt = int8_adam(learning_rate=0.05)([w])
    for _ in range(150):
        wg = w.detach().requires_grad_(True)
        loss = torch.mean((wg - target) ** 2)
        (w.grad,) = torch.autograd.grad(loss, [wg])
        opt.step()
    assert loss.item() < 1e-2
    assert opt.state[w]["q_mu"].dtype == torch.int8
    assert sum(t.numel() * t.element_size()
               for t in opt.state[w].values()) == 2 * (512 + 4 * 2)


# ---------------------------------------------------------------------------
# through accelerate: the tiny Llama
# ---------------------------------------------------------------------------

LLAMA = dict(vocab_size=256, dim=128, n_layers=2, n_heads=4, n_kv_heads=2,
             mlp_dim=256)


def _names(params):
    flat, _ = tree_flatten_with_path(params)
    return [path_str(kp) for kp, _ in flat]


def _by_name(tree, name):
    for part in name.split("/"):
        tree = tree[part]
    return tree


def test_accelerate_int8_adam_steps_match_jax():
    """Three accelerate steps of the tiny Llama (f32) with
    int8_adam(1e-4, weight_decay=1e-4), against the JAX accelerate with
    the same optax chain: loss, grad norm, every param and both int8
    moments of every leaf. No kernel is launched on the CPU."""
    jcfg = jllama.LlamaConfig.tiny(**LLAMA, dtype=jnp.float32)
    tcfg = tllama.LlamaConfig.tiny(**LLAMA, dtype=torch.float32)
    tree = jax.tree_util.tree_map(
        np.asarray, jllama.init_params(jcfg, jax.random.PRNGKey(0)))
    lr = 1e-4
    j_acc = jaccelerate(
        init_params=lambda k: jllama.init_params(jcfg, k),
        loss_fn=lambda p, b, m: jllama.loss_fn(jcfg, p, b, mesh=m),
        rules=jllama.partition_rules(jcfg),
        optimizer=jint8_adam(lr, weight_decay=1e-4),
        strategy=JStrategy(mesh=MeshSpec.fit(1)),
        devices=jax.devices()[:1],
    )
    j_state = j_acc.init(jax.random.PRNGKey(0))
    t_acc = accelerate(
        init_params=lambda g: tllama.params_from_numpy(
            tcfg, tree, device="cpu", dtype=torch.float32),
        loss_fn=lambda p, b: tllama.loss_fn(tcfg, p, b),
        optimizer=int8_adam(lr, weight_decay=1e-4),
        strategy=Strategy(device="cpu"),
    )
    t_state = t_acc.init(torch.Generator().manual_seed(0))
    opt = t_state["opt_state"]
    names = _names(t_state["params"])
    assert len(names) == 12 and isinstance(opt, Int8AdamW)
    _build.reset_launch_counts()
    rng = np.random.default_rng(11)
    for step in range(1, 4):
        batch = {"tokens": rng.integers(0, 256, size=(2, 129)).astype(
            np.int32)}
        j_state, j_m = j_acc.train_step(j_state, j_acc.shard_batch(batch))
        t_state, t_m = t_acc.train_step(
            t_state, {"tokens": torch.from_numpy(batch["tokens"]).long()})
        for key in ("loss", "grad_norm"):
            _close_rel(t_m[key].item(), j_m[key], SCALAR_REL, key)
        j_params = jax.device_get(j_state["params"])
        j_opt = jax.device_get(j_state["opt_state"][0])
        assert int(j_opt.count) == opt.count == step
        leaves = [x for x in tree_flatten_with_path(t_state["params"])[0]]
        for name, (_, p) in zip(names, leaves):
            want = np.asarray(_by_name(j_params, name))
            moved = np.linalg.norm(want - _by_name(tree, name))
            err = np.linalg.norm(p.detach().numpy() - want)
            assert err <= ADAM_REL * moved, (step, name, err, moved)
            for m in ("mu", "nu"):
                got = tq.dequantize_int8(opt.state[p]["q_" + m],
                                         opt.state[p]["s_" + m]).numpy()
                jqm = np.array(_by_name(getattr(j_opt, "q_" + m), name))
                jsm = np.array(_by_name(getattr(j_opt, "s_" + m), name))
                want = tq.dequantize_int8(torch.from_numpy(jqm),
                                          torch.from_numpy(jsm)).numpy()
                level = np.repeat(jsm, got.shape[1] // jsm.shape[1], axis=1)
                tol = level + GRAD_REL * np.abs(want).max()
                worst = float((np.abs(got - want) / tol).max())
                assert worst <= 1.0, (step, name, m, worst)
    assert set(_build.launch_counts().values()) == {0}


# ---------------------------------------------------------------------------
# SAM / WSAM and muP
# ---------------------------------------------------------------------------


def _rosenbrock(lib):
    def loss(p):
        x, y = p["x"], p["y"]
        return lib.sum((1 - x) ** 2 + 100.0 * (y - x * x) ** 2)

    return loss


def _with_aux(loss_fn):
    def f(p, scale):
        v = loss_fn(p) * scale
        return v, {"twice": 2 * v}

    return f


def _sam_point(seed):
    rng = np.random.default_rng(seed)
    return {"x": rng.uniform(0.5, 1.5, 3).astype(np.float32),
            "y": rng.uniform(-0.5, 0.5, 3).astype(np.float32)}


@pytest.mark.parametrize("has_aux", [False, True])
def test_sam_gradient_matches_jax(has_aux):
    point = _sam_point(12)
    jl, tl = _rosenbrock(jnp), _rosenbrock(torch)
    args = (1.5,) if has_aux else ()
    if has_aux:
        jl, tl = _with_aux(jl), _with_aux(tl)
    jp = {k: jnp.asarray(v) for k, v in point.items()}
    tp = {k: torch.tensor(v) for k, v in point.items()}
    want = j_sam_gradient(jl, jp, *args, rho=0.1, has_aux=has_aux)
    got = sam_gradient(tl, tp, *args, rho=0.1, has_aux=has_aux)
    if has_aux:
        (want, j_aux), (got, t_aux) = want, got
        _close_rel(t_aux["twice"].item(), j_aux["twice"], 1e-6, "aux")
    for k in point:
        _close_rel(got[k].numpy(), want[k], 1e-5, k)
        assert torch.equal(tp[k], torch.tensor(point[k]))   # not moved


@pytest.mark.parametrize("has_aux", [False, True])
def test_wsam_matches_jax(has_aux):
    point = _sam_point(13)
    jl, tl = _rosenbrock(jnp), _rosenbrock(torch)
    args = (0.5,) if has_aux else ()
    if has_aux:
        jl, tl = _with_aux(jl), _with_aux(tl)
    jvalue, jg = jwsam(jl, rho=0.05, gamma=0.7, has_aux=has_aux)(
        {k: jnp.asarray(v) for k, v in point.items()}, *args)
    tvalue, tg = wsam(tl, rho=0.05, gamma=0.7, has_aux=has_aux)(
        {k: torch.tensor(v) for k, v in point.items()}, *args)
    if has_aux:
        (jvalue, j_aux), (tvalue, t_aux) = jvalue, tvalue
        _close_rel(t_aux["twice"].item(), j_aux["twice"], 1e-6, "aux")
    _close_rel(tvalue.item(), jvalue, 1e-6, "value")
    assert set(tg) == set(point)
    for k in point:
        _close_rel(tg[k].numpy(), jg[k], 1e-5, k)


def _tiny_trees():
    jcfg = jllama.LlamaConfig.tiny(**LLAMA, dtype=jnp.float32)
    tcfg = tllama.LlamaConfig.tiny(**LLAMA, dtype=torch.float32)
    tree = jax.tree_util.tree_map(
        np.asarray, jllama.init_params(jcfg, jax.random.PRNGKey(1)))
    return tree, tllama.params_from_numpy(tcfg, tree, device="cpu",
                                          dtype=torch.float32)


def test_mup_on_the_tiny_llama_tree_matches_jax():
    tree, params = _tiny_trees()
    names = _names(params)
    assert "layers/wq" in names and "lm_head/weight" in names
    j_lrs = j_mup_lrs(tree, 4.0)
    t_lrs = mup_learning_rates(params, 4.0)
    for name in names:
        assert _by_name(t_lrs, name) == _by_name(j_lrs, name), name
    assert _by_name(t_lrs, "layers/wq") == 0.25
    assert _by_name(t_lrs, "lm_head/weight") == 0.25
    assert _by_name(t_lrs, "embed/weight") == 1.0
    assert _by_name(t_lrs, "layers/attn_norm") == 1.0
    j_init = j_mup_init(tree, 4.0)
    t_init = mup_scale_init(params, 4.0)
    for name in names:
        assert _by_name(t_init, name).numpy().tobytes() == np.asarray(
            _by_name(j_init, name)).tobytes(), name


def test_mup_param_groups_match_scale_updates_by_mup():
    """AGD over mup_param_groups (lr x multiplier a group) against the
    JAX chain agd -> scale_updates_by_mup, two steps on the tiny Llama
    tree: the same update (the multipliers are powers of two, so lr x
    multiplier rounds as the scaled update does)."""
    tree, params = _tiny_trees()
    names = _names(params)
    lr, wd = 1e-2, 0.1
    lr_tree = j_mup_lrs(tree, 4.0)
    jopt = optax.chain(jagd(lr, weight_decay=wd),
                       scale_updates_by_mup(lr_tree))
    jp = jax.tree_util.tree_map(jnp.asarray, tree)
    jstate = jopt.init(jp)
    jstep = _jax_stepper(jopt)
    leaves = [p for _, p in tree_flatten_with_path(params)[0]]
    groups = mup_param_groups(leaves, mup_learning_rates(params, 4.0), lr)
    assert [g["lr"] for g in groups] == [
        lr * _by_name(lr_tree, n) for n in names]
    opt = agd(lr, weight_decay=wd)(groups)
    rng = np.random.default_rng(14)
    for _ in range(2):
        g = jax.tree_util.tree_map(
            lambda x: (rng.standard_normal(x.shape) * 0.01).astype(
                np.float32), tree)
        jp, jstate = jstep(jax.tree_util.tree_map(jnp.asarray, g), jstate, jp)
        for name, p in zip(names, leaves):
            p.grad = torch.from_numpy(_by_name(g, name))
        opt.step()
    for name, p in zip(names, leaves):
        _close_params(p.numpy(), _by_name(jp, name), lr, name)
    with pytest.raises(ValueError, match="multipliers"):
        mup_param_groups(leaves[:3], lr_tree, lr)
    sched = mup_param_groups(leaves, mup_learning_rates(params, 4.0),
                             lambda c: 1e-2 / (1 + c))
    wq = names.index("layers/wq")
    assert sched[wq]["lr"](1) == pytest.approx(0.25 * 5e-3)
