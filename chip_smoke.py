"""Drive the PyTorch/CUDA port (dlrover_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line each (any failure exits non-zero before the last line):
  1. card: nvidia-smi name and power limit, torch and CUDA versions;
  2. build: both CUDA kernels compiled from dlrover_tpu_torch/csrc with
     nvcc for sm_90a (one nvcc per source, in parallel);
  3. kernels: each kernel against its plain PyTorch version at the
     serving path's Llama-3-8B head shapes, with error, tolerance,
     kernel / plain / library times and the bound;
  4. serve: ContinuousBatcher on Llama-3-8B at full width and depth
     (random weights from a seed), kv_layout="paged", greedy-serving 12
     requests; every request must finish, both kernels must have run
     on that path, the first-decode-step logits must match the plain
     attention path, and a reference-attention engine gives the greedy
     agreement.
Then one JSON line with every kernel's numbers, and last
{"ok": true, "device": {...}}.

Exits non-zero, printing no result, where CUDA is not available.
`python3 chip_smoke.py --profile` instead profiles one admission wave
and one decode chunk of the same engine (kernel times, device busy
share) and prints no result line.
"""

import dataclasses
import json
import subprocess
import sys
import time

import numpy as np
import torch

SEED = 0
PEAK_BF16_FLOPS = 989e12      # H100 SXM dense bf16 (NVIDIA data sheet)
PEAK_BYTES = 3.35e12          # H100 SXM HBM3
FLASH_TOL = 2e-2
PAGED_TOL = 2e-2
TOL_REASON = (
    "bf16 output (2^-8 relative) and P rounded to bf16 at other points "
    "than in the plain version"
)


def log(phase, **kw):
    print(f"[{phase}] " + json.dumps(kw, default=float), flush=True)


def time_ms(fn, iters, warmup=2):
    """Mean time of one eager call, by CUDA events over `iters` calls:
    device time, or the host's launch time where that is longer."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, calls=10, replays=10):
    """Mean device time of one call: `calls` calls captured in a CUDA
    graph, replayed `replays` times, so host launch overhead drops out."""
    fn()
    torch.cuda.synchronize()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (calls * replays)


def bound_ms(flops, nbytes):
    return 1e3 * max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES), (
        "operations" if flops / PEAK_BF16_FLOPS > nbytes / PEAK_BYTES
        else "bytes"
    )


def phase_card():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    log("card", nvidia_smi=smi, torch=torch.__version__,
        cuda=torch.version.cuda, python=sys.version.split()[0],
        device=torch.cuda.get_device_name(0),
        tf32_matmul=torch.backends.cuda.matmul.allow_tf32)
    return smi


def phase_build():
    from dlrover_tpu_torch.ops import _build

    t0 = time.perf_counter()
    report = _build.build()
    for name in _build.KERNELS:
        _build.load(name)
    ptxas = {
        name: [ln.strip() for ln in r["log"].splitlines()
               if "registers" in ln or "spill" in ln
               or "entry function" in ln]
        for name, r in report.items()
    }
    log("build", seconds=time.perf_counter() - t0,
        built=sorted(report), ptxas=ptxas)


def phase_flash(gen):
    from dlrover_tpu_torch.ops import flash_attention as fa

    F = torch.nn.functional
    b, h, kv, d = 1, 32, 8, 128
    scale = d ** -0.5
    rows = []
    for s in (77, 512, 2048):
        q = torch.randn((b, s, h, d), generator=gen, device="cuda").bfloat16()
        k = torch.randn((b, s, kv, d), generator=gen, device="cuda").bfloat16()
        v = torch.randn((b, s, kv, d), generator=gen, device="cuda").bfloat16()
        o, lse = fa._fwd(q, k, v, True, scale)
        o_ref, lse_ref = fa._fwd_plain(q, k, v, True, scale)
        torch.cuda.synchronize()
        err = (o.float() - o_ref.float()).abs().max().item()
        lse_err = (lse - lse_ref).abs().max().item()
        if not (err <= FLASH_TOL and lse_err <= 1e-3):
            raise AssertionError(
                f"flash kernel disagrees at S={s}: max_abs_err {err} "
                f"(tol {FLASH_TOL}), lse err {lse_err} (tol 1e-3)"
            )
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        flops = 2.0 * b * h * d * s * (s + 1)   # causal: QK^T and PV
        nbytes = 2 * (2 * b * s * h * d + 2 * b * s * kv * d) + 4 * b * h * s
        bms, by = bound_ms(flops, nbytes)
        row = dict(
            S=s, max_abs_err=err, lse_err=lse_err, tol=FLASH_TOL,
            tol_reason=TOL_REASON,
            ms=device_ms(lambda: fa._fwd(q, k, v, True, scale)),
            eager_ms=time_ms(lambda: fa._fwd(q, k, v, True, scale), 20),
            plain_ms=time_ms(lambda: fa._fwd_plain(q, k, v, True, scale), 5),
            library_ms=device_ms(
                lambda: F.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=True, enable_gqa=True
                )
            ),
            bound_ms=bms, bound_by=by,
        )
        log("kernel.flash_fwd", **row)
        rows.append(row)
    return rows


def _paged_case(gen, quant):
    from dlrover_tpu_torch.models import decode as dec

    b, h, kv, hd, ps, per_slot = 8, 32, 8, 128, 16, 128
    n_pages = b * per_slot + 1
    rng = np.random.default_rng(SEED)
    lengths = rng.integers(50, per_slot * ps + 1, size=b).astype(np.int32)
    perm = rng.permutation(np.arange(1, n_pages)).astype(np.int32)
    table = np.zeros((b, per_slot), np.int32)
    for row in range(b):
        n_live = -(-int(lengths[row]) // ps)
        table[row, :n_live] = perm[row * per_slot: row * per_slot + n_live]
    k = torch.randn((n_pages, ps, kv, hd), generator=gen, device="cuda")
    v = torch.randn((n_pages, ps, kv, hd), generator=gen, device="cuda")
    if quant:
        kq, ks = dec._kv_quantize(k)
        vq, vs = dec._kv_quantize(v)
        pages = {"k": kq, "v": vq, "k_scale": ks.bfloat16(),
                 "v_scale": vs.bfloat16()}
    else:
        pages = {"k": k.bfloat16(), "v": v.bfloat16()}
    del k, v
    q = torch.randn((b, h, hd), generator=gen, device="cuda").bfloat16()
    return (q, pages, torch.from_numpy(table).cuda(),
            torch.from_numpy(lengths).cuda(), lengths)


def phase_paged(gen):
    from dlrover_tpu_torch.ops import paged_attention as pa

    rows = []
    for quant in (False, True):
        q, pages, table, lens, lengths = _paged_case(gen, quant)
        b, h, hd = q.shape
        kv = pages["k"].shape[2]
        scale = hd ** -0.5
        ker = pa._kernel(q, pages, table, lens, scale)
        ref = pa._reference(q, pages, table, lens, scale)
        torch.cuda.synchronize()
        err = (ker.float() - ref.float()).abs().max().item()
        if not err <= PAGED_TOL:
            raise AssertionError(
                f"paged kernel disagrees (quant={quant}): max_abs_err "
                f"{err} (tol {PAGED_TOL})"
            )
        cells = int(lengths.sum())
        elem = 1 if quant else 2
        nbytes = (2 * cells * kv * hd * elem
                  + (2 * cells * kv * 2 if quant else 0)
                  + 2 * 2 * b * h * hd + table.numel() * 4 + b * 4)
        flops = 4.0 * cells * h * hd
        bms, by = bound_ms(flops, nbytes)
        row = dict(
            pool="int8" if quant else "bf16", B=b, live_cells=cells,
            max_abs_err=err, tol=PAGED_TOL, tol_reason=TOL_REASON,
            ms=device_ms(lambda: pa._kernel(q, pages, table, lens, scale)),
            eager_ms=time_ms(
                lambda: pa._kernel(q, pages, table, lens, scale), 50
            ),
            plain_ms=time_ms(
                lambda: pa._reference(q, pages, table, lens, scale), 5
            ),
            library_ms=None, bound_ms=bms, bound_by=by,
        )
        log("kernel.paged_attention", **row)
        rows.append(row)
        del pages
    return rows


def _prompts(cfg, n=12):
    rng = np.random.default_rng(SEED + 1)
    lengths = rng.integers(50, 1001, size=n)
    lengths[0] = 1000
    return [rng.integers(1, cfg.vocab_size, size=int(m)).tolist()
            for m in lengths]


def _serve(engine, prompts, max_new):
    """Submit everything, step to completion; per-request timings."""
    t0 = time.perf_counter()
    ids = [engine.submit(p, max_new=max_new) for p in prompts]
    first, last, count = {}, {}, {i: 0 for i in ids}
    while engine.has_work():
        events = engine.step()
        now = time.perf_counter()
        for idx, toks, _fin in events:
            if toks:
                first.setdefault(idx, now)
                last[idx] = now
                count[idx] += len(toks)
    wall = time.perf_counter() - t0
    outs = engine.generate_all([])
    return outs, dict(first=first, last=last, count=count, wall=wall,
                      t0=t0)


def phase_serve(params, cfg):
    from dlrover_tpu_torch.models import decode as dec
    from dlrover_tpu_torch.ops import _build
    from dlrover_tpu_torch.serving.engine import ContinuousBatcher

    max_new, n_slots, max_len = 32, 8, 2048
    prompts = _prompts(cfg)
    kw = dict(n_slots=n_slots, max_len=max_len, max_new_tokens=max_new,
              chunk=8, kv_layout="paged")
    # warm-up (cuBLAS handles, allocator), outside the counted run
    warm = ContinuousBatcher(cfg, params, **kw)
    warm.generate_all([prompts[1][:40]])
    del warm
    torch.cuda.synchronize()

    engine = ContinuousBatcher(cfg, params, **kw)
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()
    outs, tm = _serve(engine, prompts, max_new)
    torch.cuda.synchronize()
    launches = _build.launch_counts()
    lens = [len(o) for o in outs]
    if lens != [max_new] * len(prompts):
        raise AssertionError(f"token counts {lens}, want {max_new} each")
    toks = np.concatenate(outs)
    if toks.min() < 0 or toks.max() >= cfg.vocab_size:
        raise AssertionError("token id out of the vocabulary")
    want_flash = engine.admissions * cfg.n_layers
    want_paged = engine.decode_steps * cfg.n_layers
    if launches["flash_fwd"] < want_flash or launches["paged_attention"] < want_paged:
        raise AssertionError(
            f"kernels not on the path: launches {launches}, want "
            f">= {want_flash} flash and >= {want_paged} paged"
        )
    ttft = [tm["first"][i] - tm["t0"] for i in sorted(tm["first"])]
    tpot = [(tm["last"][i] - tm["first"][i]) / (tm["count"][i] - 1)
            for i in sorted(tm["first"]) if tm["count"][i] > 1]
    e2e = dict(
        requests=len(prompts), prompt_lens=[len(p) for p in prompts],
        max_new=max_new, n_slots=n_slots, admissions=engine.admissions,
        decode_steps=engine.decode_steps, launches=launches,
        wall_s=tm["wall"],
        ttft_ms_mean=1e3 * float(np.mean(ttft)),
        ttft_ms_p50=1e3 * float(np.median(ttft)),
        ttft_ms_max=1e3 * float(np.max(ttft)),
        tpot_ms_mean=1e3 * float(np.mean(tpot)),
        tokens_per_s=float(sum(lens)) / tm["wall"],
        peak_mem_gb=torch.cuda.max_memory_allocated() / 2**30,
    )
    del engine
    # the same traffic through plain attention (reference prefill and
    # gathered-view decode) on the same weights
    ref_cfg = dataclasses.replace(cfg, attn_impl="reference")
    ref_engine = ContinuousBatcher(ref_cfg, params, **kw)
    ref_outs, _ = _serve(ref_engine, prompts, max_new)
    del ref_engine
    same = sum(int(np.array_equal(a, b)) for a, b in zip(outs, ref_outs))
    agree = float(np.mean(np.concatenate(outs) == np.concatenate(ref_outs)))
    prefix = [int(np.argmax(np.append(a != b, True))) for a, b in
              zip(outs, ref_outs)]
    e2e.update(greedy_streams_identical=same,
               greedy_token_agreement=agree,
               greedy_common_prefix_mean=float(np.mean(prefix)))
    log("serve", **e2e)

    # first decode step after a 1000-token prefill: kernel path
    # (flash prefill + paged decode) vs plain attention, same weights
    p = prompts[0]
    bucket = 1024
    prompt = torch.zeros(bucket, dtype=torch.long, device="cuda")
    prompt[: len(p)] = torch.tensor(p, device="cuda")
    per_slot = max_len // 16
    table = torch.arange(1, per_slot + 1, dtype=torch.int32,
                         device="cuda")[None]
    logits = {}
    for name, c in (("kernel", cfg), ("reference", ref_cfg)):
        pool = dec.init_page_pool(c, per_slot + 1, 16)
        row = dec.prefill_exact_row(c, params, prompt, max_len)
        dec.paged_install_row(pool, row, table[0], 0, bucket)
        del row
        logits[name], _ = dec.paged_decode_step(
            c, params, torch.tensor([p[-1]], device="cuda"), pool, table,
            torch.tensor([len(p) - 1], device="cuda"),
        )
        del pool
    lk, lr = logits["kernel"], logits["reference"]
    if not (torch.isfinite(lk).all() and torch.isfinite(lr).all()):
        raise AssertionError("non-finite logits")
    err = (lk - lr).abs().max().item()
    ref_max = lr.abs().max().item()
    tol = 0.05 * ref_max
    log("serve.first_decode_logits", max_abs_err=err, ref_max_abs=ref_max,
        tol=tol, tol_reason="5% of the largest logit: bf16 roundings of "
        "the two attention paths carried through 32 layers",
        argmax_equal=bool(lk.argmax() == lr.argmax()))
    if not err <= tol:
        raise AssertionError(f"first-decode logits differ by {err} > {tol}")
    return e2e


def phase_profile(params, cfg):
    """`--profile`: where the time of one admission wave (8 prefills +
    one 8-step chunk) and of one pure decode chunk goes, by CUDA kernel
    (torch.profiler), and the device's busy share of the wall time,
    each followed by the profiler's full table."""
    from torch.profiler import ProfilerActivity, profile

    from dlrover_tpu_torch.serving.engine import ContinuousBatcher

    prompts = _prompts(cfg)[:8]
    kw = dict(n_slots=8, max_len=2048, max_new_tokens=32, chunk=8,
              kv_layout="paged")
    warm = ContinuousBatcher(cfg, params, **kw)
    warm.generate_all(prompts)
    del warm
    engine = ContinuousBatcher(cfg, params, **kw)
    for p in prompts:
        engine.submit(p)
    for label in ("admit_wave", "decode_chunk"):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            engine.step()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        # device-side events only (kernels, memcpy/memset): the aten
        # ops that launched them carry the same device time again
        rows = [e for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA
                and e.self_device_time_total > 0]
        dev_us = sum(e.self_device_time_total for e in rows)
        rows.sort(key=lambda e: -e.self_device_time_total)
        log(f"profile.{label}", wall_ms=1e3 * wall,
            device_ms=dev_us / 1e3,
            device_busy_share=dev_us / 1e6 / wall,
            top=[(e.key[:60], e.count, e.self_device_time_total / 1e3)
                 for e in rows[:12]])
        print(prof.key_averages().table(
            sort_by="self_device_time_total", row_limit=40), flush=True)


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    from dlrover_tpu_torch.models import llama

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = phase_card()
    phase_build()
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    if "--profile" in sys.argv[1:]:
        cfg = llama.LlamaConfig.llama3_8b()
        phase_profile(llama.init_params(cfg, gen), cfg)
        return 0
    flash_rows = phase_flash(gen)
    paged_rows = phase_paged(gen)

    cfg = llama.LlamaConfig.llama3_8b()
    t0 = time.perf_counter()
    params = llama.init_params(cfg, gen)
    torch.cuda.synchronize()
    log("model", config="llama3_8b", params=llama.num_params(cfg),
        dtype=str(cfg.dtype), init_s=time.perf_counter() - t0)
    e2e = phase_serve(params, cfg)

    main_flash = next(r for r in flash_rows if r["S"] == 512)
    main_paged = paged_rows[0]
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    kernels = [
        dict(name="flash_fwd", route="cuda",
             source="dlrover_tpu_torch/csrc/flash_fwd.cu",
             replaces="dlrover_tpu/ops/flash_attention.py:163",
             launches=e2e["launches"]["flash_fwd"],
             **{k: main_flash[k] for k in keys},
             shape="B=1 S=512 H=32 KV=8 D=128 bf16 causal",
             per_shape=flash_rows),
        dict(name="paged_attention", route="cuda",
             source="dlrover_tpu_torch/csrc/paged_attention.cu",
             replaces="dlrover_tpu/ops/paged_attention.py:160",
             launches=e2e["launches"]["paged_attention"],
             **{k: main_paged[k] for k in keys},
             shape="B=8 H=32 KV=8 D=128 page 16 bf16 pool",
             per_variant=paged_rows),
    ]
    print(json.dumps({"kernels": kernels}, default=float), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
