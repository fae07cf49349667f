"""Prefill/decode phase split with KV handoff (dlrover_tpu_torch/
serving/handoff.py and the engine's replica roles) against the JAX
package, on the tiny f32 Llama.

Both packages are driven at the engine level, as a scheduler pair would
drive them: the "prefill" engine admits (its admission is the prefill)
and never decodes; each finished prefill is taken (`take_prefilled`),
packaged (`export_run`), retired, and installed on the "decode" engine
by `submit_adopted`. The decode engine is seeded differently on
purpose: sampled parity with the colocated run then shows that the
request's seed rides the package.

Covered: {dense, paged} x {greedy, sampled} x spec {0, 2} x {device,
host}. Greedy streams equal across topologies and equal the JAX
engine's; sampled streams (torch's draws) equal across topologies;
`pages_adopted` equals the JAX pair's; the decode engine never
prefills and both allocators end empty. Also the held-for-export path
of a prefill engine with interleaved chunked prefill, and the package
and adoption units."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dlrover_tpu.models import llama as jllama
from dlrover_tpu.serving import handoff as jhandoff
from dlrover_tpu.serving.engine import ContinuousBatcher as JaxBatcher
from dlrover_tpu_torch.models import llama as tllama
from dlrover_tpu_torch.serving import engine as teng
from dlrover_tpu_torch.serving import handoff as thandoff
from dlrover_tpu_torch.serving.health import KVIntegrityError


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's engine runs many small ops: one intra-op thread keeps
    them fast beside the other test workers (restored afterwards)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def model():
    jcfg = dataclasses.replace(jllama.LlamaConfig.tiny(), dtype=jnp.float32)
    jparams = jllama.init_params(jcfg, jax.random.PRNGKey(0))
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    tcfg = tllama.LlamaConfig.tiny(dtype=torch.float32)
    tparams = tllama.params_from_numpy(tcfg, tree, device="cpu")
    return jcfg, jparams, tcfg, tparams


ENGINE = dict(n_slots=3, max_len=64, max_new_tokens=8, chunk=2, pad_id=-1)
MAX_NEW = 6


def _prompts(lengths, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, 250, size=int(n)).tolist() for n in lengths]


def _maker(model, jax_side):
    if jax_side:
        return lambda **kw: JaxBatcher(model[0], model[1], **ENGINE, **kw)
    return lambda **kw: teng.ContinuousBatcher(model[2], model[3],
                                               device="cpu", **ENGINE, **kw)


def colocated(make, prompts, **kw):
    eng = make(seed=7, **kw)
    for p in prompts:
        eng.submit(p, max_new=MAX_NEW)
    return [[int(t) for t in o] for o in eng.generate_all([])], eng


def disaggregated(make, handoff, prompts, transport, **kw):
    """prefill -> take_prefilled -> export_run -> retire ->
    submit_adopted, one step of each engine per round. Returns the
    streams in submission order and both engines."""
    pre = make(replica_role="prefill", seed=7, **kw)
    dec = make(replica_role="decode", seed=99, **kw)
    order = {pre.submit(p, max_new=MAX_NEW): i for i, p in enumerate(prompts)}
    adopted = []
    for _ in range(10_000):
        if not (pre.has_work() or dec.has_work()):
            break
        pre.step()
        for req in pre.take_prefilled():
            pkg = handoff.export_run(pre, req.idx, transport=transport)
            pre.retire(req.idx)
            dec.submit_adopted(pkg)
            adopted.append(order[req.idx])
        dec.step()
    else:
        raise AssertionError("the pair did not drain")
    outs = [None] * len(prompts)
    for i, o in zip(adopted, dec.generate_all([])):
        outs[i] = [int(t) for t in o]
    return outs, pre, dec


CASES = [
    (layout, temp, spec, transport)
    for layout in ("dense", "paged")
    for temp in (0.0, 0.9)
    for spec in (0, 2)
    for transport in ("device", "host")
]


@pytest.mark.parametrize(
    "layout,temperature,spec,transport", CASES,
    ids=[f"{c[0]}-{'sampled' if c[1] else 'greedy'}-spec{c[2]}-{c[3]}"
         for c in CASES],
)
def test_parity_sweep(model, monkeypatch, layout, temperature, spec,
                      transport):
    prompts = _prompts((5, 12, 8, 17, 3), seed=len(layout) * 10 + spec)
    kw = dict(kv_layout=layout, temperature=temperature,
              spec_draft_len=spec)
    make = _maker(model, jax_side=False)
    coloc, _ = colocated(make, prompts, **kw)
    # count the prefills each engine runs (every prefill entry point
    # the engine calls)
    prefills = []
    for name in ("prefill_into_slot", "prefill_exact_row",
                 "prefill_suffix_row", "paged_prefill_chunk",
                 "prefill_chunk_into_slot"):
        real = getattr(teng, name)

        def counted(*a, _real=real, **k):
            prefills.append(1)
            return _real(*a, **k)

        monkeypatch.setattr(teng, name, counted)
    got, pre, dec = disaggregated(make, thandoff, prompts, transport, **kw)
    assert got == coloc
    assert len(prefills) == len(prompts)      # all on the prefill engine
    assert dec.admissions == len(prompts)
    if temperature == 0.0:
        want, _ = colocated(_maker(model, jax_side=True), prompts, **kw)
        assert got == want
    if layout == "paged":
        _, _, jdec = disaggregated(_maker(model, jax_side=True), jhandoff,
                                   prompts, transport, **kw)
        assert dec.allocator.pages_adopted > 0
        assert dec.allocator.pages_adopted == jdec.allocator.pages_adopted
        for eng in (pre, dec):
            eng.allocator.check()
            assert eng.allocator.used_pages == 0


def test_decode_engine_never_dispatches_a_prefill(model):
    """The phase split is real: the prefill engine never decodes (no
    dispatch at all), and every token comes from the decode engine."""
    prompts = _prompts((4, 9, 15), seed=3)
    make = _maker(model, jax_side=False)
    got, pre, dec = disaggregated(make, thandoff, prompts, "device",
                                  kv_layout="paged")
    assert pre.decode_steps == 0 and pre.step_stats()["dispatches"] == 0
    assert dec.decode_steps > 0
    assert dec.allocator.pages_adopted > 0
    assert pre.allocator.used_pages == 0 and dec.allocator.used_pages == 0
    assert got == colocated(make, prompts, kv_layout="paged")[0]


@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_chunked_prefill_engine_holds_slots_for_export(model, layout):
    """prefill_chunk > 0 on the prefill engine: chunked prefills advance
    through interleaved dispatches while finished ones are held frozen
    for export; the streams equal the colocated run's and the JAX
    pair's."""
    prompts = _prompts((21, 5, 30, 12), seed=9)
    kw = dict(kv_layout=layout, prefill_chunk=8)
    make = _maker(model, jax_side=False)
    got, pre, dec = disaggregated(make, thandoff, prompts, "host", **kw)
    jgot, jpre, _ = disaggregated(_maker(model, jax_side=True), jhandoff,
                                  prompts, "host", **kw)
    assert got == colocated(make, prompts, **kw)[0] == jgot
    assert pre.prefill_stats()["prefill_chunks_total"] > 0
    assert (pre.prefill_stats()["prefill_chunks_total"]
            == jpre.prefill_stats()["prefill_chunks_total"])
    assert not pre._export_hold.any() and pre.take_prefilled() == []


def test_package_round_trip_and_units(model):
    """export_run / check_compatible / adopt_into_slot units: the
    shipped pages equal the source pages and land unchanged on the
    adopting engine; a stamped package that no longer verifies raises
    KVIntegrityError and counts a quarantine; incompatible engines are
    refused."""
    make = _maker(model, jax_side=False)
    prompt = _prompts((13,), seed=1)[0]
    pre = make(replica_role="prefill", kv_layout="paged", kv_checksums=1)
    idx = pre.submit(prompt, max_new=MAX_NEW)
    pre.step()
    assert [r.idx for r in pre.take_prefilled()] == [idx]
    with pytest.raises(ValueError):
        thandoff.export_run(pre, idx, transport="pigeon")
    with pytest.raises(KeyError):
        thandoff.export_run(pre, idx + 1)
    pkg = thandoff.export_run(pre, idx, transport="host")
    assert pkg.checksum and pkg.n_cells == len(prompt)
    assert pkg.n_ship == (len(prompt) - 1) // pre.page_size + 1
    run = pre._slot_pages[0][:pkg.n_ship]
    for name, arr in pre.page_pool.items():
        assert torch.equal(pkg.data[name][:, :pkg.n_ship], arr[:, run])
    dec = make(replica_role="decode", kv_layout="paged")
    didx = dec.submit_adopted(pkg)
    dec.step()
    slot = next(s for s in range(dec.n_slots) if dec.slot_req[s] is not None)
    run = dec._slot_pages[slot][:pkg.n_ship]
    # the adopted prompt cells (all but the frontier the first step
    # rewrites) equal the shipped ones
    p = len(prompt)
    for name, arr in dec.page_pool.items():
        shipped = pkg.data[name][:, :pkg.n_ship].flatten(1, 2)[:, :p - 1]
        assert torch.equal(arr[:, run].flatten(1, 2)[:, :p - 1], shipped)
    assert dec.health_stats()["integrity_checks"] == 1
    dec.generate_all([])
    assert dec._requests == {} and didx not in dec._pending
    # a flipped byte in transit: the adopting ingress refuses it
    bad = dataclasses.replace(pkg, data=dict(pkg.data))
    bad.data["k"] = pkg.data["k"].clone()
    bad.data["k"].view(-1).view(torch.uint8)[5] ^= 0xFF
    with pytest.raises(KVIntegrityError):
        thandoff.adopt_into_slot(dec, 0, bad)
    assert dec.health_stats()["integrity_quarantines"] == 1
    dense = make(kv_layout="dense")
    with pytest.raises(ValueError, match="kv_layout"):
        thandoff.check_compatible(dense, pkg)
    other = make(kv_layout="paged", page_size=4)
    with pytest.raises(ValueError, match="page_size"):
        thandoff.check_compatible(other, pkg)
    pre.retire(idx)
    assert pre.allocator.used_pages == 0


def test_prefill_queue_follows_cancel_preempt_and_reset(model):
    """A cancelled, retired or reset request leaves the export queue;
    request_progress and live_request_keys name the live requests as
    the JAX engine's do."""
    make = _maker(model, jax_side=False)
    jmake = _maker(model, jax_side=True)
    prompts = _prompts((6, 9, 4), seed=2)
    seen = []
    for mk in (make, jmake):
        pre = mk(replica_role="prefill", kv_layout="paged")
        ids = [pre.submit(p, max_new=MAX_NEW) for p in prompts]
        pre.step()
        row = [sorted(pre.live_request_keys()),
               [pre.request_progress(i) for i in ids]]
        pre.cancel(ids[1])
        row.append([r.idx for r in pre.take_prefilled()])
        pre.submit(prompts[1])
        pre.step()
        pre.reset()
        row.append((pre.take_prefilled(), pre.has_work(),
                    pre.allocator.used_pages))
        seen.append(row)
    assert seen[0] == seen[1]
