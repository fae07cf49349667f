"""The named remat policies (parallel/remat.py), the model's tags
(models/llama.py) and `Strategy(remat=...)` (parallel/accelerate.py)
against the JAX package on the same numbers, and what each policy makes
the backward re-run.

Params come from the JAX `init_params` (f32, carried across with
`params_from_numpy`), tokens from a numpy seed; tiny Llama (2 layers,
dim 64, f32 compute, reference attention). Tolerance, the rule of the
training parity runs: the loss within 1e-3 relative, each gradient
within 5e-2 of its norm (L2 of the difference). A policy changes what is
saved and recomputed, never a value: f32 on both sides, sums in another
order.

The re-run counts come from a TorchDispatchMode around the backward:
each tagged product (`dlrover_tpu::tagged_matmul`) it sees there is one
the recompute ran again; one a policy saved is returned from the
checkpoint's store without running."""

import collections

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from dlrover_tpu.models import llama as jllama
from dlrover_tpu.parallel import remat as jremat
from dlrover_tpu.parallel.accelerate import Strategy as JStrategy
from dlrover_tpu.parallel.accelerate import accelerate as jaccelerate
from dlrover_tpu.parallel.mesh import MeshSpec
from dlrover_tpu_torch.models import llama as tllama
from dlrover_tpu_torch.parallel import remat
from dlrover_tpu_torch.parallel.accelerate import Strategy, accelerate

LOSS_REL = 1e-3
GRAD_L2 = 5e-2
POLICIES = ("none", "full", "dots", "dots_no_batch", "proj", "proj_mlp",
            "save_names", "offload_names")
SAVE = ("qkv_proj", "mlp_gate")
SEQ = 16


def _cfgs(policy, remat_on=None):
    kw = dict(remat=policy != "none" if remat_on is None else remat_on,
              remat_policy=policy)
    return (jllama.LlamaConfig.tiny(dtype=jnp.float32, **kw),
            tllama.LlamaConfig.tiny(dtype=torch.float32, **kw))


def _tree(jcfg):
    return jax.tree_util.tree_map(
        np.asarray, jllama.init_params(jcfg, jax.random.PRNGKey(0)))


def _leaves(tree, prefix=""):
    out = {}
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            out.update(_leaves(tree[k], prefix + k + "/"))
        else:
            out[prefix + k] = tree[k]
    return out


def _port_params(tcfg, tree):
    params = tllama.params_from_numpy(tcfg, tree, device="cpu",
                                      dtype=torch.float32)
    for x in _leaves(params).values():
        x.requires_grad_(True)
    return params


def _tokens(seed=1, b=2):
    return np.random.default_rng(seed).integers(
        0, 256, size=(b, SEQ + 1)).astype(np.int32)


def _check_grads(got, want):
    assert sorted(got) == sorted(want)
    for name, g in got.items():
        w = np.asarray(want[name], np.float32)
        g = np.asarray(g, np.float32)
        err = np.linalg.norm(g - w)
        assert err <= GRAD_L2 * max(np.linalg.norm(w), 1e-30), (name, err)


class _Reruns(TorchDispatchMode):
    """The tagged products that run, by name (`op`: another tag op)."""

    def __init__(self, op=torch.ops.dlrover_tpu.tagged_matmul.default):
        super().__init__()
        self.op, self.names = op, collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func is self.op:
            self.names[args[-1]] += 1
        return func(*args, **(kwargs or {}))


def _port_loss_and_grads(tcfg, tree, tokens):
    params = _port_params(tcfg, tree)
    loss, _ = tllama.loss_fn(tcfg, params, {"tokens": torch.from_numpy(
        tokens).long()})
    leaves = _leaves(params)
    with _Reruns() as reruns:
        grads = torch.autograd.grad(loss, list(leaves.values()))
    return loss, dict(zip(leaves, grads)), reruns.names


@pytest.mark.parametrize("policy", POLICIES)
def test_policy_loss_and_grads_match_jax(policy):
    """`cfg.remat_policy` = `policy` on both sides (JAX's layer scan under
    `jax.checkpoint(policy=resolve_policy(...))`, the port's layers under
    `apply_remat`): the same loss and gradients as JAX."""
    jcfg, tcfg = _cfgs(policy)
    tree = _tree(jcfg)
    tokens = _tokens()
    (j_loss, _), j_grads = jax.jit(jax.value_and_grad(
        lambda p: jllama.loss_fn(jcfg, p, {"tokens": jnp.asarray(tokens)}),
        has_aux=True))(jax.tree_util.tree_map(jnp.asarray, tree))
    loss, grads, _ = _port_loss_and_grads(tcfg, tree, tokens)
    assert abs(loss.item() - float(j_loss)) <= LOSS_REL * abs(float(j_loss))
    _check_grads({k: v.numpy() for k, v in grads.items()},
                 _leaves(jax.tree_util.tree_map(np.asarray, j_grads)))


# the projections a policy's backward runs again, per layer
_ALL = {"qkv_proj": 3, "attn_proj": 1, "mlp_gate": 1, "mlp_up": 1,
        "mlp_down": 1}


@pytest.mark.parametrize("policy,rerun", [
    ("none", {}),
    ("proj", {"mlp_gate": 1, "mlp_up": 1}),
    ("proj_mlp", {}),
    ("dots", {}),
    ("dots_no_batch", {}),
    ("full", _ALL),
])
def test_policy_reruns_the_products_it_does_not_save(policy, rerun):
    """"proj" re-runs w_gate and w_up and none of the products whose names
    it saves; "proj_mlp", "dots" and "dots_no_batch" re-run no
    projection; "full" re-runs at least q/k/v, wo, w_gate and w_up (the
    recompute may stop before w_down, whose output nothing saves);
    "none" re-runs nothing. The gradients are the same under every
    policy."""
    jcfg, tcfg = _cfgs(policy)
    tree = _tree(jcfg)
    tokens = _tokens(2)
    _, grads, names = _port_loss_and_grads(tcfg, tree, tokens)
    layers = tcfg.n_layers
    if policy == "full":
        for name, n in rerun.items():
            if name != "mlp_down":
                assert names[name] == n * layers, (name, names)
        assert names["mlp_down"] in (0, layers)
    else:
        assert dict(names) == {k: n * layers for k, n in rerun.items()}
    _, base, _ = _port_loss_and_grads(_cfgs("none")[1], tree, tokens)
    for name, g in grads.items():
        torch.testing.assert_close(g, base[name], rtol=0, atol=0)


def test_remat_none_in_the_model_checkpoints_as_jax_does():
    """`cfg.remat=True` with `remat_policy="none"`: JAX's model wraps the
    layer in `jax.checkpoint(policy=None)`, which saves nothing, and the
    port's layer checkpoints as under "full": JAX's loss and gradients,
    and the backward re-runs q/k/v, wo, w_gate and w_up as "full" does."""
    jcfg, tcfg = _cfgs("none", remat_on=True)
    tree = _tree(jcfg)
    tokens = _tokens(6)
    (j_loss, _), j_grads = jax.jit(jax.value_and_grad(
        lambda p: jllama.loss_fn(jcfg, p, {"tokens": jnp.asarray(tokens)}),
        has_aux=True))(jax.tree_util.tree_map(jnp.asarray, tree))
    loss, grads, names = _port_loss_and_grads(tcfg, tree, tokens)
    assert abs(loss.item() - float(j_loss)) <= LOSS_REL * abs(float(j_loss))
    _check_grads({k: v.numpy() for k, v in grads.items()},
                 _leaves(jax.tree_util.tree_map(np.asarray, j_grads)))
    for name, n in _ALL.items():
        if name != "mlp_down":
            assert names[name] == n * tcfg.n_layers, (name, names)


@pytest.mark.parametrize("policy,names,tags", [
    ("none", (), 0), ("full", (), 0), ("proj", (), 0),
    ("save_names", SAVE, 0), ("save_names", ("attn_out",), 1),
    ("offload_names", ("attn_out",), 1)])
def test_checkpoint_name_tags_only_where_a_policy_reads_it(policy, names,
                                                           tags):
    """The `attn_out` tag (a copy) runs in the forward only inside a
    region whose policy reads that name, once a layer, and is never run
    again in the backward (its output saved or offloaded); the gradients
    are the unchecked layer's."""
    jcfg, tcfg = _cfgs("none")
    params = _port_params(tcfg, _tree(jcfg))
    rng = np.random.default_rng(7)
    x_np = rng.standard_normal((2, SEQ, tcfg.dim)).astype(np.float32)
    pos = torch.from_numpy(np.broadcast_to(np.arange(SEQ), (2, SEQ)).copy())
    lp = tllama.layer_params(params, 0)
    op = torch.ops.dlrover_tpu.checkpoint_name.default

    def grads(policy, names):
        x = torch.from_numpy(x_np).requires_grad_(True)
        with _Reruns(op) as fwd:
            out = remat.apply_remat(
                lambda p, xx: tllama._layer(tcfg, xx, p, pos), policy,
                names)(lp, x)
        with _Reruns(op) as bwd:
            g = torch.autograd.grad((out * out).sum(), [x, *lp.values()])
        return g, fwd.names, bwd.names

    got, fwd, bwd = grads(policy, names)
    assert dict(fwd) == ({"attn_out": tags} if tags else {})
    assert not bwd
    for g, w in zip(got, grads("none", ())[0]):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


def test_save_and_offload_names_keep_the_tagged_products():
    """`apply_remat(fn, "save_names" | "offload_names", SAVE)` on a layer:
    the tagged products it names are not run again in the backward (kept
    on the device, or in host memory and brought back), the others are;
    the gradients are those of the unchecked layer, and JAX's
    `apply_remat` under the same policy gives the same loss and
    gradients."""
    jcfg, tcfg = _cfgs("none")
    tree = _tree(jcfg)
    params = _port_params(tcfg, tree)
    rng = np.random.default_rng(3)
    x_np = rng.standard_normal((2, SEQ, tcfg.dim)).astype(np.float32)
    pos = np.broadcast_to(np.arange(SEQ), (2, SEQ))

    def port_layer(lp, x):
        return tllama._layer(tcfg, x, lp, torch.from_numpy(pos.copy()))

    def jax_layer(lp, x):
        return jllama._layer(jcfg, None, x, lp, jnp.asarray(pos))[0]

    lp = tllama.layer_params(params, 0)
    j_lp = jax.tree_util.tree_map(lambda a: jnp.asarray(a[0]),
                                  tree["layers"])
    want = {}
    for policy in ("none", "save_names", "offload_names"):
        x = torch.from_numpy(x_np).requires_grad_(True)
        out = remat.apply_remat(port_layer, policy, SAVE)(lp, x)
        loss = (out * out).sum()
        with _Reruns() as reruns:
            grads = torch.autograd.grad(loss, [x, *lp.values()])
        if policy == "none":
            want = grads
            assert not reruns.names
            continue
        # (the recompute may stop before w_down, whose output nothing
        # saves)
        assert reruns.names.pop("mlp_down", 0) in (0, 1)
        assert dict(reruns.names) == {"attn_proj": 1, "mlp_up": 1}, (
            reruns.names)
        for g, w in zip(grads, want):
            torch.testing.assert_close(g, w, rtol=0, atol=0)
        j_loss, j_grads = jax.value_and_grad(
            lambda p, xx: jnp.sum(jremat.apply_remat(
                jax_layer, policy, SAVE)(p, xx) ** 2), argnums=(0, 1))(
            j_lp, jnp.asarray(x_np))
        assert abs(loss.item() - float(j_loss)) <= LOSS_REL * abs(
            float(j_loss))
        _check_grads({"x": grads[0].numpy(),
                      **{k: g.numpy() for k, g in zip(lp, grads[1:])}},
                     {"x": np.asarray(j_grads[1]),
                      **{k: np.asarray(j_grads[0][k]) for k in lp}})


def test_resolve_policy_names():
    """Every name of JAX's `resolve_policy` resolves ("none" to no
    checkpoint), an unknown one raises, and JAX's offload memory kinds
    take their defaults only."""
    for name in POLICIES:
        jremat.resolve_policy(name, save_names=["act"])
        got = remat.resolve_policy(name, save_names=["act"])
        assert (got is None) == (name == "none")
    with pytest.raises(ValueError, match="unknown remat"):
        remat.resolve_policy("most")
    with pytest.raises(ValueError, match="pinned_host"):
        remat.resolve_policy("offload_names", ["act"], offload_dst="device")
    f = lambda x: x * 2                                        # noqa: E731
    assert remat.remat_every_n(f, 1, 2) is f
    wrapped = remat.remat_every_n(f, 2, 2)
    x = torch.tensor(3.0, requires_grad=True)
    assert wrapped is not f and wrapped(x).item() == 6.0


def test_tags_change_no_value_and_skip_serving():
    """The tagged products compute `x @ w` exactly; without autograd (a
    serving forward) they are the plain product, not the tagged op."""
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.standard_normal((2, 5, 8)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((8, 3)).astype(np.float32))
    with _Reruns() as seen:
        plain = remat.tagged_matmul(x, w, "qkv_proj")
    assert not seen.names and torch.equal(plain, x @ w)
    wg = w.clone().requires_grad_(True)
    with _Reruns() as seen:
        tagged = remat.tagged_matmul(x, wg, "qkv_proj")
    assert seen.names == {"qkv_proj": 1}
    assert torch.equal(tagged, x @ w)
    (dw,) = torch.autograd.grad(tagged.sum(), [wg])
    (want,) = torch.autograd.grad((x @ wg).sum(), [wg])
    torch.testing.assert_close(dw, want, rtol=0, atol=0)
    assert torch.equal(remat.checkpoint_name(x, "attn_out"), x)


@pytest.mark.parametrize("policy,names", [
    ("full", ()), ("proj", ()), ("save_names", SAVE),
    ("offload_names", SAVE)])
def test_strategy_remat_matches_jax(policy, names):
    """`Strategy(remat=policy, remat_save_names=names)` wraps the whole
    loss body in the policy on both sides (the model's own per-layer
    remat off): one SGD step at lr 1, so each param moves by minus its
    gradient; the loss, grad_norm and gradients as JAX's."""
    jcfg, tcfg = _cfgs("none")
    tree = _tree(jcfg)
    tokens = _tokens(5)
    j_acc = jaccelerate(
        init_params=lambda k: jax.tree_util.tree_map(jnp.asarray, tree),
        loss_fn=lambda p, b, m: jllama.loss_fn(jcfg, p, b, mesh=m),
        rules=jllama.partition_rules(jcfg), optimizer=optax.sgd(1.0),
        strategy=JStrategy(mesh=MeshSpec.fit(1), remat=policy,
                           remat_save_names=names),
        devices=jax.devices()[:1])
    j_state = j_acc.init(jax.random.PRNGKey(0))
    j_state, j_m = j_acc.train_step(
        j_state, j_acc.shard_batch({"tokens": tokens}, with_accum=False))
    t_acc = accelerate(
        lambda g: _port_params(tcfg, tree),
        lambda p, b: tllama.loss_fn(tcfg, p, b),
        lambda ps: torch.optim.SGD(ps, lr=1.0),
        Strategy(device="cpu", remat=policy, remat_save_names=names))
    state = t_acc.init(torch.Generator().manual_seed(0))
    state, m = t_acc.train_step(state, {"tokens": torch.from_numpy(
        tokens).long()})
    assert abs(float(m["loss"]) - float(j_m["loss"])) <= LOSS_REL * abs(
        float(j_m["loss"]))
    assert abs(float(m["grad_norm"]) - float(j_m["grad_norm"])) <= (
        LOSS_REL * float(j_m["grad_norm"]))
    start = _leaves(tree)
    j_params = _leaves(jax.tree_util.tree_map(np.asarray,
                                              j_state["params"]))
    t_params = {k: v.detach().numpy()
                for k, v in _leaves(state["params"]).items()}
    _check_grads({k: start[k] - t_params[k] for k in start},
                 {k: start[k] - j_params[k] for k in start})
