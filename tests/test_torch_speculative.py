"""The port's speculative decoding pieces against the JAX package on the
same seed-made inputs: the host drafter, controller and decoder bundle
(dlrover_tpu_torch/serving/speculative.py, a copy of the JAX module),
the acceptance rules and the verify forwards (models/decode.py).

Tolerances: host code and greedy acceptance compare EXACTLY (the same
integers). Verify logits atol 1e-4 and f32 cache / pool cells atol 1e-5
(tests/test_torch_decode.py's: two layers of f32 matmuls summed in
other orders); int8 cells and their scales must be equal. Sampled
acceptance cannot match JAX draw for draw (another RNG), so it is held
to the Monte-Carlo checks of the JAX package's own tests on the port's
function: each emitted marginal within 0.02 (0.03 for the conditioned
second position) of the target distribution, over 20000 / 40000 rows
(the standard error of a frequency there is at most 0.0035 / 0.0025,
and 0.005 after conditioning)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dlrover_tpu.models import decode as jdec
from dlrover_tpu.models import llama as jllama
from dlrover_tpu.serving import speculative as jspec
from dlrover_tpu_torch.models import decode as tdec
from dlrover_tpu_torch.models import llama as tllama
from dlrover_tpu_torch.serving import speculative as tspec

LOGIT_ATOL = 1e-4
CACHE_ATOL = 1e-5


@pytest.fixture(scope="module")
def model():
    jcfg = dataclasses.replace(jllama.LlamaConfig.tiny(), dtype=jnp.float32)
    jparams = jllama.init_params(jcfg, jax.random.PRNGKey(0))
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    tcfg = tllama.LlamaConfig.tiny(dtype=torch.float32)
    tparams = tllama.params_from_numpy(tcfg, tree, device="cpu")
    return jcfg, jparams, tcfg, tparams


def _sequence(rng, n, vocab, period):
    """Random tokens with a repeating stretch, so both the miss and the
    hit branches of the drafter run."""
    head = rng.integers(0, vocab, size=n // 2).tolist()
    pat = rng.integers(0, vocab, size=period).tolist()
    return head + (pat * n)[: n - n // 2]


# ---------------------------------------------------------------------------
# host half: the copy behaves as the JAX module does
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("ngram", [(1, 3), (2, 2), (1, 1), (2, 5)])
@pytest.mark.parametrize("seed", range(3))
def test_drafter_proposals_equal_jax(seed, ngram):
    rng = np.random.default_rng(seed)
    ng_min, ng_max = ngram
    j = jspec.NgramDrafter(2, ngram_max=ng_max, ngram_min=ng_min)
    t = tspec.NgramDrafter(2, ngram_max=ng_max, ngram_min=ng_min)
    seqs = [_sequence(rng, 60, 7, 3), _sequence(rng, 60, 40, 5)]
    for slot, seq in enumerate(seqs):
        j.begin(slot, seq[:4])
        t.begin(slot, seq[:4])
    for i in range(4, 60):
        for slot, seq in enumerate(seqs):
            j.extend(slot, [seq[i]])
            t.extend(slot, [seq[i]])
            for k in (0, 1, 3, 6):
                want = j.propose(slot, k)
                got = t.propose(slot, k)
                assert got.dtype == want.dtype
                assert got.tolist() == want.tolist(), (slot, i, k)


@pytest.mark.parametrize("probe", [1, 3, 32])
@pytest.mark.parametrize("threshold", [0.3, 0.5, 1.0])
def test_controller_trajectory_equals_jax(threshold, probe):
    rng = np.random.default_rng(int(threshold * 10) + probe)
    j = jspec.SpecController(3, 4, threshold=threshold, probe_interval=probe)
    t = tspec.SpecController(3, 4, threshold=threshold, probe_interval=probe)
    for step in range(200):
        slot = int(rng.integers(3))
        if step % 37 == 0:
            j.reset(slot)
            t.reset(slot)
        kj, kt = j.k_for(slot), t.k_for(slot)
        assert kj == kt
        acc = int(rng.integers(0, kj + 1)) if rng.random() < 0.6 else 0
        j.observe(slot, kj, acc)
        t.observe(slot, kt, acc)
        assert [j.current_k(s) for s in range(3)] == [
            t.current_k(s) for s in range(3)]
        assert dataclasses.asdict(j._slots[slot]) == dataclasses.asdict(
            t._slots[slot])


@pytest.mark.parametrize("seed", range(3))
def test_decoder_batches_and_stats_equal_jax(seed):
    rng = np.random.default_rng(seed)
    kw = dict(ngram_max=3, ngram_min=1, threshold=0.5, probe_interval=4)
    j = jspec.SpeculativeDecoder(4, 3, **kw)
    t = tspec.SpeculativeDecoder(4, 3, **kw)
    for slot in range(4):
        prompt = _sequence(rng, 12, 9, 2 + slot)
        j.begin_slot(slot, prompt)
        t.begin_slot(slot, prompt)
    for _ in range(40):
        done = rng.random(4) < 0.25
        jd, jl = j.draft_batch(done)
        td, tl = t.draft_batch(done)
        np.testing.assert_array_equal(td, jd)
        np.testing.assert_array_equal(tl, jl)
        assert td.dtype == jd.dtype and tl.dtype == jl.dtype
        for slot in np.flatnonzero(~done):
            acc = int(rng.integers(0, int(jl[slot]) + 1))
            emitted = acc + 1
            j.record(int(slot), int(jl[slot]), acc, emitted)
            t.record(int(slot), int(tl[slot]), acc, emitted)
            toks = rng.integers(0, 9, size=emitted).tolist()
            j.extend(int(slot), toks)
            t.extend(int(slot), toks)
        assert t.stats() == j.stats()
    assert t.proposed > 0


def test_host_validation_equals_jax():
    for make in (
        lambda m: m.NgramDrafter(1, ngram_max=2, ngram_min=3),
        lambda m: m.NgramDrafter(1, ngram_max=2, ngram_min=0),
        lambda m: m.SpecController(1, k_max=0),
        lambda m: m.SpecController(1, k_max=2, threshold=0.0),
        lambda m: m.SpecController(1, k_max=2, threshold=1.5),
        lambda m: m.SpecController(1, k_max=2, probe_interval=0),
    ):
        with pytest.raises(ValueError) as want:
            make(jspec)
        with pytest.raises(ValueError) as got:
            make(tspec)
        assert str(got.value) == str(want.value)


# ---------------------------------------------------------------------------
# greedy acceptance: exact
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", range(4))
def test_accept_greedy_equals_jax(seed):
    rng = np.random.default_rng(seed)
    b, k, v = 9, 4, 6
    # a small vocabulary and integer logits: ties in the argmax (both
    # sides take the first) and drafts that often match
    logits = rng.integers(0, 4, size=(b, k + 1, v)).astype(np.float32)
    tgt = logits.argmax(-1)
    drafts = np.where(rng.random((b, k)) < 0.7, tgt[:, :k],
                      rng.integers(0, v, size=(b, k))).astype(np.int32)
    dlen = rng.integers(0, k + 1, size=b).astype(np.int32)
    jm, je = jdec.spec_accept_greedy(
        jnp.asarray(logits), jnp.asarray(drafts), jnp.asarray(dlen))
    tm, te = tdec.spec_accept_greedy(
        torch.from_numpy(logits), torch.from_numpy(drafts),
        torch.from_numpy(dlen))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))


@pytest.mark.parametrize(
    "targets,drafts,dlen,m,extra",
    [([3, 1, 4, 2], [3, 1, 9], 3, 2, 4),    # diverges at j=2
     ([2, 5, 1], [2, 5], 2, 2, 1),          # all accepted: the bonus
     ([0, 0, 0], [0, 0], 1, 1, 0)],         # padding never counts
    ids=["divergence", "bonus", "padding"],
)
def test_accept_greedy_cases(targets, drafts, dlen, m, extra):
    logits = np.zeros((1, len(targets), 10), np.float32)
    for i, tok in enumerate(targets):
        logits[0, i, tok] = 9.0
    got_m, got_e = tdec.spec_accept_greedy(
        torch.from_numpy(logits), torch.tensor([drafts]),
        torch.tensor([dlen]))
    assert (int(got_m[0]), int(got_e[0])) == (m, extra)


# ---------------------------------------------------------------------------
# sampled acceptance: the distribution is the target's
# ---------------------------------------------------------------------------


def test_categorical_draws_equal_multinomial():
    """`categorical` is torch.multinomial's one-sample draw: the same
    tokens from the same generator state, zero mass never drawn."""
    for seed in range(20):
        p = torch.softmax(torch.randn(4, 300, generator=torch.Generator()
                                      .manual_seed(seed)) * 3, -1)
        p[:, 7] = 0.0
        g1 = torch.Generator().manual_seed(seed)
        g2 = torch.Generator().manual_seed(seed)
        want = torch.multinomial(p, 1, generator=g1)[:, 0]
        got = tdec.categorical(p, g2)
        assert torch.equal(got, want)
        assert torch.equal(g1.get_state(), g2.get_state())
        assert not (got == 7).any()


def test_sampled_first_token_marginal_matches_target():
    b, v = 20000, 8
    rng = np.random.default_rng(0)
    p = rng.dirichlet(np.ones(v))
    probs = np.broadcast_to(p.astype(np.float32), (b, 2, v)).copy()
    # drafts from a very DIFFERENT proposal distribution
    q = rng.dirichlet(np.ones(v) * 0.3)
    drafts = rng.choice(v, size=(b, 1), p=q).astype(np.int32)
    m, extra = tdec.spec_accept_sampled(
        torch.from_numpy(probs), torch.from_numpy(drafts),
        torch.ones(b, dtype=torch.int32), torch.Generator().manual_seed(7))
    m, extra = m.numpy(), extra.numpy()
    first = np.where(m >= 1, drafts[:, 0], extra)
    emp = np.bincount(first, minlength=v) / b
    assert np.abs(emp - p).max() < 0.02, (emp, p)


def test_sampled_multiposition_marginals_match_target():
    """K=3 with position-varying targets: the second position's
    marginal, conditioned on the first draft accepted, is the target
    too."""
    b, v, k = 40000, 6, 3
    rng = np.random.default_rng(1)
    p = rng.dirichlet(np.ones(v), size=k + 1).astype(np.float32)
    probs = np.broadcast_to(p, (b, k + 1, v)).copy()
    q = rng.dirichlet(np.ones(v) * 0.5, size=k)
    drafts = np.stack(
        [rng.choice(v, size=b, p=q[j]) for j in range(k)], axis=1
    ).astype(np.int32)
    m, extra = tdec.spec_accept_sampled(
        torch.from_numpy(probs), torch.from_numpy(drafts),
        torch.full((b,), k, dtype=torch.int32),
        torch.Generator().manual_seed(5))
    m, extra = m.numpy(), extra.numpy()
    first = np.where(m >= 1, drafts[:, 0], extra)
    emp = np.bincount(first, minlength=v) / b
    assert np.abs(emp - p[0]).max() < 0.02
    sel = m >= 1
    second = np.where(m[sel] >= 2, drafts[sel, 1], extra[sel])
    emp2 = np.bincount(second, minlength=v) / sel.sum()
    assert np.abs(emp2 - p[1]).max() < 0.03


@pytest.mark.parametrize("case", ["p_zero", "matching"])
def test_sampled_point_masses(case):
    b, v = 64, 4
    gen = torch.Generator().manual_seed(0)
    if case == "p_zero":
        # the target is a point mass on 1; the draft (3) has p = 0
        probs = torch.zeros(b, 2, v)
        probs[:, :, 1] = 1.0
        m, extra = tdec.spec_accept_sampled(
            probs, torch.full((b, 1), 3), torch.ones(b, dtype=torch.long),
            gen)
        assert int(m.max()) == 0 and bool((extra == 1).all())
    else:
        probs = torch.zeros(b, 3, v)
        probs[:, :, 2] = 1.0
        m, extra = tdec.spec_accept_sampled(
            probs, torch.full((b, 2), 2), torch.full((b,), 2), gen)
        assert bool((m == 2).all()) and bool((extra == 2).all())


def test_sampled_respects_draft_len_and_generator():
    """Padding past a row's draft_len is never accepted, and the draws
    depend only on the generator's state."""
    b, v, k = 256, 5, 3
    probs = torch.full((b, k + 1, v), 1.0 / v)
    probs[:, :, 0] = 0.9                      # drafts of 0 usually pass
    probs = probs / probs.sum(-1, keepdim=True)
    drafts = torch.zeros(b, k, dtype=torch.long)
    dlen = torch.arange(b) % (k + 1)
    out = [tdec.spec_accept_sampled(probs, drafts, dlen,
                                    torch.Generator().manual_seed(3))
           for _ in range(2)]
    assert bool((out[0][0] <= dlen).all())
    assert torch.equal(out[0][0], out[1][0])
    assert torch.equal(out[0][1], out[1][1])


# ---------------------------------------------------------------------------
# the verify forwards
# ---------------------------------------------------------------------------


def _cmp_cache(jc, tc, skip_pages=()):
    for name in jc:
        want = np.asarray(jnp.asarray(jc[name]).astype(jnp.float32))
        got = tc[name].float().numpy()
        if skip_pages:
            keep = [i for i in range(want.shape[1]) if i not in skip_pages]
            want, got = want[:, keep], got[:, keep]
        if name.endswith("_scale") or tc[name].dtype == torch.int8:
            np.testing.assert_array_equal(got, want, err_msg=name)
        else:
            np.testing.assert_allclose(got, want, atol=CACHE_ATOL,
                                       err_msg=name)


def _random_bank(rng, shape, quant):
    out = {}
    for n in ("k", "v"):
        if quant:
            out[n] = rng.integers(-127, 128, size=shape).astype(np.int8)
            s = rng.uniform(0.001, 0.05, size=shape[:-1] + (1,))
            out[n + "_scale"] = np.array(
                jnp.asarray(s, jnp.float32).astype(jnp.bfloat16)
                .astype(jnp.float32))
        else:
            out[n] = rng.standard_normal(shape).astype(np.float32)
    return out


def _both(bank):
    j = {n: jnp.asarray(a).astype(jnp.bfloat16) if n.endswith("_scale")
         else jnp.asarray(a) for n, a in bank.items()}
    t = {n: torch.from_numpy(a.copy()).to(torch.bfloat16)
         if n.endswith("_scale") else torch.from_numpy(a.copy())
         for n, a in bank.items()}
    return j, t


@pytest.mark.parametrize("quant", [False, True], ids=["f32", "int8"])
def test_verify_step_equals_jax(model, quant):
    """A random dense bank, rows at their own positions (one whose
    window reaches the bank's last cell): logits at every verify
    position and every cache cell."""
    jcfg, jparams, tcfg, tparams = model
    rng = np.random.default_rng(3)
    m, s = 36, 5
    bank = _random_bank(
        rng, (tcfg.n_layers, 3, m, tcfg.n_kv_heads, tcfg.head_dim), quant)
    jc, tc = _both(bank)
    tokens = rng.integers(1, 250, size=(3, s)).astype(np.int32)
    pos = np.array([7, 0, m - s], np.int32)
    jl, jc = jdec.verify_step(jcfg, jparams, jnp.asarray(tokens), jc,
                              jnp.asarray(pos))
    tl, tc = tdec.verify_step(tcfg, tparams, torch.from_numpy(tokens).long(),
                              tc, torch.from_numpy(pos).long())
    assert tl.shape == (3, s, tcfg.vocab_size)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=LOGIT_ATOL)
    _cmp_cache(jc, tc)


@pytest.mark.parametrize("quant", [False, True], ids=["f32", "int8"])
def test_paged_verify_step_equals_jax(model, quant):
    """A random pool and table (live pages, stale pages, a row parked on
    the trash page): the port's paged_verify_step against JAX's, and
    against the JAX engine's own paged verify off the TPU (gather the
    view, verify_step, scatter the K+1-cell window back), logits and
    pool cells."""
    jcfg, jparams, tcfg, tparams = model
    rng = np.random.default_rng(4)
    n_pages, ps, s = 12, 8, 5
    bank = _random_bank(
        rng, (tcfg.n_layers, n_pages, ps, tcfg.n_kv_heads, tcfg.head_dim),
        quant)
    table = np.array([[3, 7, 1, 0], [5, 2, 9, 0], [0, 0, 0, 0]], np.int32)
    pos = np.array([19, 6, 4], np.int32)
    tokens = rng.integers(1, 250, size=(3, s)).astype(np.int32)
    jp, tp = _both(bank)
    jl, jp = jdec.paged_verify_step(
        jcfg, jparams, jnp.asarray(tokens), jp, jnp.asarray(table),
        jnp.asarray(pos))
    tl, tp = tdec.paged_verify_step(
        tcfg, tparams, torch.from_numpy(tokens).long(), tp,
        torch.from_numpy(table), torch.from_numpy(pos).long())
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=LOGIT_ATOL)
    _cmp_cache(jp, tp)
    # the JAX engine's program on the CPU writes the same K+1 cells of
    # each live row; the parked row's window wraps around its one trash
    # page here, which the gathered view does not see (a done row: its
    # logits and the trash page are dead), so rows 0-1 and pages 1+
    jp2, _ = _both(bank)
    view = jdec.gather_pool_view(jp2, jnp.asarray(table))
    jl2, view = jdec.verify_step(jcfg, jparams, jnp.asarray(tokens), view,
                                 jnp.asarray(pos))
    jp2 = jdec.scatter_pool_window(jp2, view, jnp.asarray(table),
                                   jnp.asarray(pos), s)
    np.testing.assert_allclose(tl[:2].numpy(), np.asarray(jl2)[:2],
                               atol=LOGIT_ATOL)
    _cmp_cache(jp2, tp, skip_pages=(0,))


def test_verify_equals_stepped_decode(model):
    """logits[:, j] of one verify are the logits of the same tokens
    stepped one at a time through decode_step (the port on both
    sides), and the cache ends the same."""
    _, _, tcfg, tparams = model
    rng = np.random.default_rng(5)
    m, s = 32, 4
    bank = _random_bank(
        rng, (tcfg.n_layers, 2, m, tcfg.n_kv_heads, tcfg.head_dim), False)
    _, ca = _both(bank)
    _, cb = _both(bank)
    tokens = torch.from_numpy(rng.integers(1, 250, size=(2, s))).long()
    pos = torch.tensor([9, 20])
    vl, ca = tdec.verify_step(tcfg, tparams, tokens, ca, pos)
    for j in range(s):
        sl, cb = tdec.decode_step(tcfg, tparams, tokens[:, j], cb, pos + j)
        np.testing.assert_allclose(vl[:, j].numpy(), sl.numpy(),
                                   atol=LOGIT_ATOL)
    for name in ca:
        np.testing.assert_allclose(ca[name].numpy(), cb[name].numpy(),
                                   atol=CACHE_ATOL)
