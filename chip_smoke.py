"""Drive the PyTorch/CUDA port (dlrover_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line each (any failure exits non-zero before the last line):
  1. card: nvidia-smi name and power limit, torch and CUDA versions;
  2. build: the six CUDA sources compiled from dlrover_tpu_torch/csrc
     with nvcc for sm_90a (one nvcc per source, in parallel), with
     ptxas's register, spill, warning and wgmma-serialization lines;
  3. kernels: each kernel against its plain PyTorch version at the
     Llama-3-8B shapes of the serving and training paths, with error,
     tolerance, kernel / plain / library times and the bound:
     flash_fwd and flash_bwd (the dq and dk/dv kernels; for each its
     wgmma variant, which every main path takes, with the mma.sync
     variant's time and error beside it) at B=1 with S = 77, 512 and
     2048 and at the train path's B=2, S=2048,
     paged_attention (bf16 and int8 pools; the TMA-ring kernel the
     serving shape takes and the split kernel it replaced, each timed
     cold over pool copies that overflow L2 and warm on one pool),
     quantize_int8 (one w_gate layer slab, and the
     embedding flattened as the int8 AdamW quantizes it; bytes equal
     to the plain version), dequantize_int8 (the training path's
     flattened leaves, bits equal to the plain version), one Int8AdamW
     step on the card against the same step on the CPU (opt.int8_adam),
     and dqmm (the five weight shapes at T = 8 and 77 and at the
     serving prompt buckets 128, 256, 512 and 1024, with the dense bf16
     matmul's time and the variant that ran beside it; at T = 8 the
     TMA-ring decode kernel, with the mma.sync decode kernel it replaced
     timed on the same inputs);
  4. serve: ContinuousBatcher on Llama-3-8B at full width and depth
     (random weights from a seed), kv_layout="paged", greedy-serving 12
     requests; every request must finish, both attention kernels must
     have run on that path (every flash forward on its wgmma variant,
     every paged launch on the TMA-ring kernel), the first-decode-step
     logits must match the
     plain attention path, and a reference-attention engine gives the
     greedy agreement;
  5. serve.int8: the same traffic through weight_quant="int8" on the
     same weights; every flash forward must have taken the wgmma
     variant, the quantize kernel must have run once per layer slice and the dequant-matmul kernel on every product of every
     forward (every prefill product on its persistent TMA + wgmma
     variant, `dqmm_ws`, every decode product on the TMA-ring decode
     kernel, `dqmm_decode_tma`, which launches no combine kernel; every
     paged launch on the TMA-ring kernel),
     one installed layer slice of every quantized weight (and
     the lm_head) must equal the plain quantizer's bytes, the weight
     bytes must be <= 0.55x the bf16 engine's, and
     the first-decode-step logits must match the same decode functions
     on a dense bf16 tree of exactly the dequantized weights;
  6. train: Trainer(ElasticTrainer(...)) over accelerate over
     llama.loss_fn on Llama-3-8B at full width, 4 layers (f32 params,
     bf16 compute, remat "full", AdamW), 8 steps of a global batch of
     4 x 2048 tokens in microbatches of 2; the losses must be finite and
     fall, the flash forward and both backward kernels (each on its
     wgmma variant) must have run exactly as often as the path calls
     them, and the first
     microbatch's loss and gradients must match the same model with
     plain attention;
  7. train.int8_adam: the same workload from the same params and
     tokens with int8_adam (int8 block-quantized moments) in place of
     AdamW; the losses must be finite and fall, step 1's loss must
     equal train's, the dequantize and quantize kernels must have run
     exactly twice a param leaf and step, the moments must take at most
     0.254x of AdamW's bytes and the peak memory must stay below
     train's.
Then one JSON line with every kernel's numbers, and last
{"ok": true, "device": {...}}.

Exits non-zero, printing no result, where CUDA is not available.
`python3 chip_smoke.py --profile [--int8]` instead profiles one
admission wave and one decode chunk of the same engine (kernel times,
device busy share; --int8 with weight_quant="int8"), and `--profile
--train [--int8-adam]` one step of the train phase (with int8_adam);
neither prints a result line. `python3 chip_smoke.py --dqmm
[--package-root DIR]` runs only the card, build and dqmm phases, with
the `dlrover_tpu_torch` found under DIR (another checkout, such as a
parent commit unpacked by `git archive`) where one is given: the A/B
of two versions of kernel 7 in one call; it prints no result line
either. `python3 chip_smoke.py --decode-kernels [--package-root DIR]`
runs the card, build and paged-attention phases and the dqmm rows at
T = 1, 8 and 16 of the five weight shapes: the A/B of the two decode
kernels (kernel 4 and kernel 7's decode variant) in one call, no result
line.
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
PEAK_F32_FLOPS = 67e12        # H100 SXM f32 outside the tensor cores
PEAK_BYTES = 3.35e12          # H100 SXM HBM3
L2_BYTES = 50 * 2**20
FLASH_TOL = 2e-2
PAGED_TOL = 2e-2
TOL_REASON = (
    "bf16 output (2^-8 relative) and P rounded to bf16 at other points "
    "than in the plain version"
)
DQMM_REL_TOL = 2 ** -7
DQMM_TOL_REASON = (
    "2^-7 of the largest |output|: the same bf16-rounded weights on both "
    "sides, f32 sums in another order, and a bf16 output (2^-8 relative)"
)
LOGITS_REL_TOL = 0.05
# the Llama-3-8B matmul weights as (K, O), with their names
DQMM_SHAPES = (
    ((4096, 4096), "wq, wo"), ((4096, 1024), "wk, wv"),
    ((4096, 14336), "w_gate, w_up"), ((14336, 4096), "w_down"),
    ((4096, 128256), "lm_head"),
)
# decode (8 slots), a ragged prefill, and the prompt buckets of the
# serving traffic (`_prompts`: 128 x1, 256 x1, 512 x3, 1024 x7)
DQMM_TOKENS = (8, 77, 128, 256, 512, 1024)
# `--decode-kernels`: one slot, the serving batch, the decode kernels' most
DECODE_TOKENS = (1, 8, 16)
BWD_REL_TOL = 2 ** -6
BWD_TOL_REASON = (
    "2^-6 of the largest |grad| of each of dq, dk, dv: both sides round P "
    "and dS to bf16 before the products and the gradients once, but the "
    "kernels' P comes from exp2 on the special-function unit (2 ulp), so "
    "an element near a rounding boundary may round the other way (2^-8 "
    "relative), and the f32 sums run in another order"
)
# (B, S) of the attention kernel phases: B=1 at three lengths (S=512
# is a serving prefill bucket) and the train path's microbatch, 2 x 2048
FLASH_CASES = ((1, 77), (1, 512), (1, 2048), (2, 2048))
TRAIN_LAYERS = 4
TRAIN_SEQ = 2048
TRAIN_GLOBAL_BATCH = 4
TRAIN_MICROBATCH = 2
TRAIN_STEPS = 8
TRAIN_SEED = SEED + 2         # params and tokens of both train phases
TRAIN_LR = 1e-4
TRAIN_WD = 1e-4
# the moment rule of opt.int8_adam (card against CPU): int8 levels
# equal or one apart in at most 0.1% of the entries, scales within
# 1e-6 relative, params within 2^-20 relative plus lr x 2^-6
Q_FLIP_SHARE = 1e-3
SCALE_REL = 1e-6
OPT_TOL_REASON = (
    "torch's CPU f32 sqrt is one ulp off the correctly rounded root "
    "(CUDA's) for some 0.65% of inputs: a block's largest sqrt(nu), so "
    "its scale, may move by an ulp, and at a rounding tie an int8 level "
    "by one; the update divides by that sqrt"
)
# the training path's leaves flattened as the int8 AdamW holds them
# ([1, padded], block 256): (name, values, output dtype)
DEQUANT_CASES = (
    ("embed / lm_head", 128256 * 4096, torch.float32),
    ("w_gate / w_up / w_down stack", 4 * 4096 * 14336, torch.float32),
    ("w_gate stack, bf16 out", 4 * 4096 * 14336, torch.bfloat16),
    ("wk / wv stack", 4 * 4096 * 1024, torch.float32),
    ("norm stack", 4 * 4096, torch.float32),
)
TRAIN_LOSS_REL_TOL = 1e-3
TRAIN_GRAD_REL_TOL = 5e-2
TRAIN_TOL_REASON = (
    "loss within 1e-3 relative, each gradient within 5e-2 of its norm "
    "(L2 of the difference): bf16 compute on both sides, but the flash "
    "kernels round P and dS to bf16 where plain attention rounds P after "
    "the softmax and dP, and those differences carry through the "
    "backward of 4 layers (the embedding's gradient collects all of them)"
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


def bound_ms(flops, nbytes, peak=PEAK_BF16_FLOPS):
    return 1e3 * max(flops / peak, nbytes / PEAK_BYTES), (
        "operations" if flops / peak > nbytes / PEAK_BYTES else "bytes"
    )


def cold_copies(make, nbytes):
    """Enough copies of an operand (`make()` builds one) that cycling
    through them reads 128 MB, over twice the 50 MB L2: each call then
    finds its operand in device memory, as a decode step does."""
    return [make() for _ in range(max(1, -(-(128 * 2**20) // nbytes)))]


def cycling(fn, operands):
    """`fn(next operand)` per call, round-robin; with device_ms's
    `calls=len(operands)` a graph replays each operand once."""
    state = {"i": 0}

    def call():
        op = operands[state["i"] % len(operands)]
        state["i"] += 1
        return fn(op)

    return call


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
               or "entry function" in ln or "warning" in ln
               or "Performance Loss" in ln]
        for name, r in report.items()
    }
    log("build", seconds=time.perf_counter() - t0,
        built=sorted(report), ptxas=ptxas)


def phase_flash(gen):
    """The forward (kernel 1) at the FLASH_CASES shapes (32 q heads, 8
    KV heads of 128, causal, bf16): every case takes the wgmma variant,
    held to `_fwd_plain` on O (FLASH_TOL) and LSE (1e-3) and timed as
    `ms`; the mma.sync variant runs on the same inputs, held to the
    same tolerances, and its time is `mma_ms`. library_ms is
    scaled_dot_product_attention (is_causal, enable_gqa), a yardstick
    the port never calls."""
    from dlrover_tpu_torch.ops import flash_attention as fa

    F = torch.nn.functional
    h, kv, d = 32, 8, 128
    scale = d ** -0.5
    rows = []
    for b, s in FLASH_CASES:
        variant = fa._fwd_variant(b, s, s, h, kv, d, True)
        if variant != "wgmma":
            raise AssertionError(f"B={b} S={s} takes the {variant} forward")
        q = torch.randn((b, s, h, d), generator=gen, device="cuda").bfloat16()
        k = torch.randn((b, s, kv, d), generator=gen, device="cuda").bfloat16()
        v = torch.randn((b, s, kv, d), generator=gen, device="cuda").bfloat16()
        o_ref, lse_ref = fa._fwd_plain(q, k, v, True, scale)
        errs = {}
        for name, run in (
                ("wgmma", lambda: fa._fwd(q, k, v, True, scale)),
                ("mma", lambda: fa._fwd_launch(q, k, v, True, scale, "mma"))):
            o, lse = run()
            torch.cuda.synchronize()
            errs[name] = ((o.float() - o_ref.float()).abs().max().item(),
                          (lse - lse_ref).abs().max().item())
            if not (errs[name][0] <= FLASH_TOL and errs[name][1] <= 1e-3):
                raise AssertionError(
                    f"flash {name} kernel disagrees at B={b} S={s}: "
                    f"max_abs_err {errs[name][0]} (tol {FLASH_TOL}), lse "
                    f"err {errs[name][1]} (tol 1e-3)"
                )
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        flops = 2.0 * b * h * d * s * (s + 1)   # causal: QK^T and PV
        nbytes = 2 * (2 * b * s * h * d + 2 * b * s * kv * d) + 4 * b * h * s
        bms, by = bound_ms(flops, nbytes)
        row = dict(
            B=b, S=s, variant=variant, max_abs_err=errs["wgmma"][0],
            lse_err=errs["wgmma"][1], mma_max_abs_err=errs["mma"][0],
            mma_lse_err=errs["mma"][1], tol=FLASH_TOL,
            tol_reason=TOL_REASON,
            ms=device_ms(lambda: fa._fwd(q, k, v, True, scale)),
            mma_ms=device_ms(
                lambda: fa._fwd_launch(q, k, v, True, scale, "mma")),
            eager_ms=time_ms(lambda: fa._fwd(q, k, v, True, scale), 20),
            plain_ms=time_ms(lambda: fa._fwd_plain(q, k, v, True, scale), 5),
            library_ms=device_ms(
                lambda: F.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=True, enable_gqa=True
                )
            ),
            bound_ms=bms, bound_by=by,
        )
        row["tflops"] = flops / row["ms"] / 1e9
        log("kernel.flash_fwd", **row)
        rows.append(row)
    return rows


def _check_paged_tma(phase, launches):
    """Every paged-attention launch of a serving run on the TMA-ring
    kernel (one launch a layer and decode step, no combine kernel)."""
    if launches["paged_attention_tma"] != launches["paged_attention"]:
        raise AssertionError(
            f"{phase}: {launches['paged_attention']} paged launches, "
            f"{launches['paged_attention_tma']} on the TMA-ring kernel"
        )


def _check_wgmma(phase, launches, names=("flash_fwd",)):
    """Every launch of the named flash kernels on a main path took the
    kernel's wgmma variant."""
    for name in names:
        if launches[f"{name}_wgmma"] != launches[name]:
            raise AssertionError(
                f"{phase}: {launches[f'{name}_wgmma']} of "
                f"{launches[name]} {name} launches on the wgmma variant"
            )


def phase_flash_bwd(gen):
    """Both backward kernels (kernels 2 and 3) against `_bwd_plain` at
    the training path's attention shapes (32 q heads, 8 KV heads of
    128, causal, bf16): B=1 at S = 77, 512 and 2048, and B=2, S=2048,
    the train phase's microbatch. Every case takes the wgmma variants;
    the mma.sync kernels run on the same inputs, held to the same
    tolerance. `ms` is the whole backward (delta, dq kernel, dkv
    kernel), its bound the five products the function needs (2.5x the
    forward's causal FLOPs; the two-kernel split computes seven) and
    the bytes of q, k, v, o, dO, dq, dk, dv, lse and delta; `dq_ms` /
    `dkv_ms` each kernel alone, beside the bound of what that kernel
    alone must do (three and four products); `mma_ms`, `mma_dq_ms`
    and `mma_dkv_ms` the same for the mma.sync kernels.
    library_ms: the backward of scaled_dot_product_attention(is_causal,
    enable_gqa) on the same inputs (a yardstick, not used by the port),
    CUDA-graph device time as `ms`: its forward and backward captured
    together, less its forward captured alone (library_fwd_bwd_ms and
    library_fwd_ms); library_eager_ms times the backward alone, eagerly."""
    from dlrover_tpu_torch.ops import flash_attention as fa

    F = torch.nn.functional
    h, kv, d = 32, 8, 128
    scale = d ** -0.5
    rows = []
    for b, s in FLASH_CASES:
        variant = fa._bwd_variant(b, s, s, h, kv, d, True)
        if variant != "wgmma":
            raise AssertionError(f"B={b} S={s} takes the {variant} backward")

        def rand(heads):
            return torch.randn((b, s, heads, d), generator=gen,
                               device="cuda").bfloat16()

        q, k, v, do = rand(h), rand(kv), rand(kv), rand(h)
        o, lse = fa._fwd(q, k, v, True, scale)
        delta = fa._delta(o, do)

        def mma_bwd():
            dlt = fa._delta(o, do)
            return (fa._bwd_dq_cuda(q, k, v, do, lse, dlt, True, scale,
                                    "mma"),
                    *fa._bwd_dkv_cuda(q, k, v, do, lse, dlt, True, scale,
                                      "mma"))

        want = fa._bwd_plain(q, k, v, o, lse, do, True, scale)
        errs, tols = {}, {}
        for prefix, run in (
                ("", lambda: fa._bwd(q, k, v, o, lse, do, True, scale)),
                ("mma_", mma_bwd)):
            got = run()
            torch.cuda.synchronize()
            for name, x, y in zip(("dq", "dk", "dv"), got, want):
                errs[prefix + name] = (x.float() - y.float()).abs().max(
                ).item()
                tols[prefix + name] = BWD_REL_TOL * y.float().abs().max(
                ).item()
                if not (torch.isfinite(x).all()
                        and errs[prefix + name] <= tols[prefix + name]):
                    raise AssertionError(
                        f"flash backward {prefix or 'wgmma_'}kernels "
                        f"disagree at B={b} S={s}: {name} max_abs_err "
                        f"{errs[prefix + name]} (tol {tols[prefix + name]})"
                    )
            del got
        del want
        fwd_flops = 2.0 * b * h * d * s * (s + 1)   # causal QK^T and PV
        qo_bytes = 2 * b * s * h * d                # one [B,S,H,D] bf16
        kv_bytes = 2 * b * s * kv * d
        row_bytes = 4 * b * h * s                   # lse or delta
        bms, by = bound_ms(2.5 * fwd_flops,
                           4 * qo_bytes + 4 * kv_bytes + 2 * row_bytes)
        dq_bms, dq_by = bound_ms(1.5 * fwd_flops, 3 * qo_bytes
                                 + 2 * kv_bytes + 2 * row_bytes)
        dkv_bms, dkv_by = bound_ms(2.0 * fwd_flops, 2 * qo_bytes
                                   + 4 * kv_bytes + 2 * row_bytes)
        lib_g = do.transpose(1, 2)

        def leaves():
            # fresh leaves each call: their grad nodes are made on the
            # stream that runs the call (a captured graph's own stream)
            return [x.transpose(1, 2).detach().requires_grad_()
                    for x in (q, k, v)]

        def lib_fwd(qkv=None):
            return F.scaled_dot_product_attention(
                *(qkv or leaves()), is_causal=True, enable_gqa=True)

        def lib_fwd_bwd():
            qkv = leaves()
            return torch.autograd.grad(lib_fwd(qkv), qkv, lib_g)

        lib_fwd_ms = device_ms(lib_fwd)
        lib_fwd_bwd_ms = device_ms(lib_fwd_bwd)
        qt, kt, vt = leaves()
        lib_out = lib_fwd((qt, kt, vt))
        row = dict(
            B=b, S=s, variant=variant,
            max_abs_err=max(errs[n] for n in ("dq", "dk", "dv")),
            mma_max_abs_err=max(errs[n] for n in ("mma_dq", "mma_dk",
                                                  "mma_dv")),
            errs=errs, tols=tols, tol_reason=BWD_TOL_REASON,
            ms=device_ms(lambda: fa._bwd(q, k, v, o, lse, do, True, scale)),
            eager_ms=time_ms(
                lambda: fa._bwd(q, k, v, o, lse, do, True, scale), 20),
            dq_ms=device_ms(lambda: fa._bwd_dq_cuda(
                q, k, v, do, lse, delta, True, scale, variant)),
            dkv_ms=device_ms(lambda: fa._bwd_dkv_cuda(
                q, k, v, do, lse, delta, True, scale, variant)),
            mma_ms=device_ms(mma_bwd),
            mma_dq_ms=device_ms(lambda: fa._bwd_dq_cuda(
                q, k, v, do, lse, delta, True, scale, "mma")),
            mma_dkv_ms=device_ms(lambda: fa._bwd_dkv_cuda(
                q, k, v, do, lse, delta, True, scale, "mma")),
            delta_ms=device_ms(lambda: fa._delta(o, do)),
            plain_ms=time_ms(
                lambda: fa._bwd_plain(q, k, v, o, lse, do, True, scale), 3),
            library_ms=lib_fwd_bwd_ms - lib_fwd_ms,
            library_fwd_bwd_ms=lib_fwd_bwd_ms, library_fwd_ms=lib_fwd_ms,
            library_eager_ms=time_ms(lambda: torch.autograd.grad(
                lib_out, (qt, kt, vt), lib_g, retain_graph=True), 20),
            bound_ms=bms, bound_by=by, dq_bound_ms=dq_bms, dq_bound_by=dq_by,
            dkv_bound_ms=dkv_bms, dkv_bound_by=dkv_by,
        )
        row["tflops"] = 3.5 * fwd_flops / row["ms"] / 1e9   # seven products
        log("kernel.flash_bwd", **row)
        rows.append(row)
        del q, k, v, do, o, lse, delta, qt, kt, vt, lib_out
        torch.cuda.empty_cache()
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


def _launched(before, after, name):
    return after.get(name, 0) - before.get(name, 0)


def phase_paged(gen):
    """Kernel 4 at the serving decode shape, bf16 and int8 pools: the
    kernel the shape takes (the TMA-ring one, `paged_attention_tma`)
    and the split kernel it replaced (`old_*`) against the plain version;
    `ms` / `old_ms` cycle through copies of the pool that read over 128
    MB, so each call finds its pages in device memory as a decode step
    does (the pool of a layer is not in L2), `warm_ms` / `old_warm_ms`
    repeat one pool. A package without the TMA-ring kernel (an older
    checkout, `--package-root`) runs its one kernel as `ms`."""
    from dlrover_tpu_torch.ops import _build
    from dlrover_tpu_torch.ops import paged_attention as pa

    has_tma = hasattr(pa, "kernel_variant")
    rows = []
    for quant in (False, True):
        q, pages, table, lens, lengths = _paged_case(gen, quant)
        b, h, hd = q.shape
        kv = pages["k"].shape[2]
        scale = hd ** -0.5
        cells = int(lengths.sum())
        elem = 1 if quant else 2
        live = (2 * cells * kv * hd * elem
                + (2 * cells * kv * 2 if quant else 0))
        pools = cold_copies(
            lambda: {n: t.clone() for n, t in pages.items()}, live)
        ref = pa._reference(q, pages, table, lens, scale)
        before = _build.launch_counts()
        ker = pa._kernel(q, pages, table, lens, scale)
        after = _build.launch_counts()
        again = pa._kernel(q, pages, table, lens, scale)
        torch.cuda.synchronize()
        tma = _launched(before, after, "paged_attention_tma")
        if _launched(before, after, "paged_attention") != 1 or tma != int(
                has_tma):
            raise AssertionError(
                f"paged kernel (quant={quant}): launches {before} -> "
                f"{after}, want one, on the TMA-ring kernel")
        err = (ker.float() - ref.float()).abs().max().item()
        if not (err <= PAGED_TOL and torch.equal(ker, again)):
            raise AssertionError(
                f"paged kernel disagrees (quant={quant}): max_abs_err "
                f"{err} (tol {PAGED_TOL}), rerun bit-equal "
                f"{torch.equal(ker, again)}"
            )
        nbytes = live + 2 * 2 * b * h * hd + table.numel() * 4 + b * 4
        flops = 4.0 * cells * h * hd
        bms, by = bound_ms(flops, nbytes)

        def run(pool, variant="auto"):
            if variant == "auto":
                return pa._kernel(q, pool, table, lens, scale)
            return pa._kernel(q, pool, table, lens, scale, variant=variant)

        row = dict(
            pool="int8" if quant else "bf16", B=b, live_cells=cells,
            variant="tma" if tma else "split", copies=len(pools),
            max_abs_err=err, tol=PAGED_TOL, tol_reason=TOL_REASON,
            ms=device_ms(cycling(run, pools), calls=len(pools)),
            warm_ms=device_ms(lambda: run(pages)),
            eager_ms=time_ms(lambda: run(pages), 50),
            plain_ms=time_ms(
                lambda: pa._reference(q, pages, table, lens, scale), 5
            ),
            library_ms=None, bound_ms=bms, bound_by=by,
        )
        if has_tma:
            old = run(pages, "split")
            torch.cuda.synchronize()
            row["old_max_abs_err"] = (old.float() - ref.float()).abs().max(
            ).item()
            if not row["old_max_abs_err"] <= PAGED_TOL:
                raise AssertionError(
                    f"split paged kernel disagrees (quant={quant}): "
                    f"{row['old_max_abs_err']}")
            row["old_ms"] = device_ms(
                cycling(lambda pool: run(pool, "split"), pools),
                calls=len(pools))
            row["old_warm_ms"] = device_ms(lambda: run(pages, "split"))
        log("kernel.paged_attention", **row)
        rows.append(row)
        del pages, pools
        torch.cuda.empty_cache()
    return rows


def phase_quant(gen):
    """Kernel 5 on one w_gate layer slab in the engine's output-major
    layout ([O, K] = [14336, 4096], block 256), from f32 and from bf16,
    and on the embedding's first moment as the int8 AdamW quantizes it
    (f32, flattened to [1, 128256 x 4096]): q8 and s8 must equal the
    plain version's byte for byte."""
    from dlrover_tpu_torch.ops import quantization as tq

    block = 256
    rows = []
    for (o, k), dtype in (((14336, 4096), torch.float32),
                          ((14336, 4096), torch.bfloat16),
                          ((1, 128256 * 4096), torch.float32)):
        x = (torch.randn((o, k), generator=gen, device="cuda")
             * (4096 ** -0.5)).to(dtype)
        q, sc = tq.quantize_int8(x, block)
        q_ref, s_ref = tq._quantize_plain(x, block)
        torch.cuda.synchronize()
        q_diff = int((q != q_ref).sum())
        s_diff = int((sc != s_ref).sum())
        if q_diff or s_diff:
            raise AssertionError(
                f"quant kernel bytes differ ({dtype}): {q_diff} q8 and "
                f"{s_diff} s8 values"
            )
        elem = x.element_size()
        n = o * k
        nbytes = n * elem + n + 4 * (n // block)
        bms, by = bound_ms(3.0 * n, nbytes, PEAK_F32_FLOPS)
        row = dict(
            input=str(dtype).replace("torch.", ""), shape=[o, k],
            block=block, q8_diff=q_diff, s8_diff=s_diff, max_abs_err=0.0,
            tol=0.0, tol_reason="bytes equal to the plain version",
            ms=device_ms(lambda: tq.quantize_int8(x, block)),
            eager_ms=time_ms(lambda: tq.quantize_int8(x, block), 20),
            plain_ms=time_ms(lambda: tq._quantize_plain(x, block), 5),
            library_ms=None, bound_ms=bms, bound_by=by,
        )
        log("kernel.quantize_int8", **row)
        rows.append(row)
        del x, q, sc, q_ref, s_ref
        torch.cuda.empty_cache()
    return rows


def phase_dequant(gen):
    """Kernel 6 at the training path's leaves, flattened to [1, padded]
    with block 256 as the int8 AdamW dequantizes its moments (the
    embedding / lm_head, a stack of 4 MLP layers in f32 and bf16 out,
    a wk / wv stack and a norm stack): the output's bits must equal the
    plain version's. `ms` is CUDA-graph device time; the norm stack,
    which fits in L2, cycles through copies that overflow it. The bound
    is the bytes: one int8 read and one output written a value, one
    scale a block."""
    from dlrover_tpu_torch.ops import quantization as tq

    block = 256
    rows = []
    for name, n, out in DEQUANT_CASES:
        blocks = n // block

        def make():
            q = torch.randint(-127, 128, (1, n), generator=gen,
                              device="cuda", dtype=torch.int8)
            s = torch.rand((1, blocks), generator=gen, device="cuda") * 1e-3
            return q, s

        q, s = make()
        x = tq.dequantize_int8(q, s, out)
        ref = tq._dequantize_plain(q, s, out)
        torch.cuda.synchronize()
        bits = torch.int16 if out == torch.bfloat16 else torch.int32
        diff = int((x.view(bits) != ref.view(bits)).sum())
        if diff:
            raise AssertionError(
                f"dequant kernel differs from the plain version at {name}: "
                f"{diff} of {n} values"
            )
        del x, ref
        nbytes = n * (1 + torch.empty((), dtype=out).element_size()) + (
            4 * blocks)
        operands = (cold_copies(make, nbytes) if nbytes < L2_BYTES
                    else [(q, s)])
        bms, by = bound_ms(float(n), nbytes, PEAK_F32_FLOPS)
        row = dict(
            case=name, values=n, rows=blocks, block=block,
            out=str(out).replace("torch.", ""), max_abs_err=0.0,
            bits_diff=diff, tol=0.0,
            tol_reason="bits equal to the plain version",
            ms=device_ms(cycling(lambda qs: tq.dequantize_int8(*qs, out),
                                 operands), calls=max(10, len(operands))),
            eager_ms=time_ms(lambda: tq.dequantize_int8(q, s, out), 20),
            plain_ms=time_ms(lambda: tq._dequantize_plain(q, s, out), 3),
            library_ms=None, bound_ms=bms, bound_by=by,
            cold_copies=len(operands),
        )
        log("kernel.dequantize_int8", **row)
        rows.append(row)
        del q, s, operands
        torch.cuda.empty_cache()
    return rows


def _moments_agree(st_a, st_b):
    """(levels apart at most, share of int8 entries that differ, largest
    relative scale difference) of two Int8AdamW states of one param."""
    flips, share, srel = 0, 0.0, 0.0
    for m in ("mu", "nu"):
        d = (st_a["q_" + m].cpu().int() - st_b["q_" + m].cpu().int()).abs()
        flips = max(flips, int(d.max()))
        share = max(share, float((d > 0).float().mean()))
        sa, sb = st_a["s_" + m].cpu(), st_b["s_" + m].cpu()
        srel = max(srel, float(((sa - sb).abs() / sb.abs()).max()))
    return flips, share, srel


def phase_opt_int8():
    """One Int8AdamW step (lr 1e-4, weight decay 1e-4, block 256) on the
    card against the same step on CPU copies: layer-0-sized leaves
    ([4096, 4096], [4096]) and a ragged [7, 13], from the same seeded
    params, grads and nonzero moments (quantized random moments at
    count 5, loaded by int8_adam_state_from_numpy into both). Kernels
    5 and 6 run inside the optimizer, twice a leaf each."""
    from dlrover_tpu_torch.ops import _build
    from dlrover_tpu_torch.ops import quantization as tq
    from dlrover_tpu_torch.optim.low_precision import (
        int8_adam,
        int8_adam_state_from_numpy,
    )

    shapes = [(4096, 4096), (4096,), (7, 13)]
    rng = np.random.default_rng(SEED + 3)
    params = [(rng.standard_normal(sh) * 0.02).astype(np.float32)
              for sh in shapes]
    grads = [(rng.standard_normal(sh) * 1e-3).astype(np.float32)
             for sh in shapes]
    state = {k: [] for k in ("q_mu", "s_mu", "q_nu", "s_nu")}
    for sh in shapes:
        for m, x in (("mu", rng.standard_normal(sh) * 1e-4),
                     ("nu", np.abs(rng.standard_normal(sh)) * 1e-4)):
            q, s, _, _ = tq.quantize_any(
                torch.from_numpy(x.astype(np.float32)), 256)
            state["q_" + m].append(q.numpy())
            state["s_" + m].append(s.numpy())
    state["count"] = 5
    opts, leaves = {}, {}
    for dev in ("cpu", "cuda"):
        leaves[dev] = [torch.tensor(p, device=dev) for p in params]
        opts[dev] = int8_adam(TRAIN_LR, weight_decay=TRAIN_WD)(leaves[dev])
        int8_adam_state_from_numpy(opts[dev], state)
        for p, g in zip(leaves[dev], grads):
            p.grad = torch.tensor(g, device=dev)
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    opts["cuda"].step()
    torch.cuda.synchronize()
    launches = _build.launch_counts()
    opts["cpu"].step()
    want = 2 * len(shapes)
    if launches["dequant_int8"] != want or launches["quant_int8"] != want:
        raise AssertionError(f"opt.int8_adam launches {launches}, want "
                             f"{want} dequant_int8 and quant_int8")
    flips, share, srel, perr = 0, 0.0, 0.0, 0.0
    for pc, pg in zip(leaves["cpu"], leaves["cuda"]):
        f, sh, sr = _moments_agree(opts["cuda"].state[pg],
                                   opts["cpu"].state[pc])
        flips, share, srel = max(flips, f), max(share, sh), max(srel, sr)
        d = (pg.cpu() - pc).abs()
        tol = 2.0 ** -20 * pc.abs() + TRAIN_LR * 2.0 ** -6
        perr = max(perr, float((d / tol).max()))
    log("opt.int8_adam", leaves=[list(sh) for sh in shapes],
        q_levels_apart=flips, q_differ_share=share, scale_rel_err=srel,
        param_err_over_tol=perr, launches={k: launches[k] for k in (
            "dequant_int8", "quant_int8")},
        rule=dict(q_flip_share=Q_FLIP_SHARE, scale_rel=SCALE_REL,
                  param="2^-20 |p| + lr x 2^-6"), tol_reason=OPT_TOL_REASON)
    if not (flips <= 1 and share <= Q_FLIP_SHARE and srel <= SCALE_REL
            and perr <= 1.0):
        raise AssertionError(
            f"opt.int8_adam: card and CPU steps differ (levels {flips}, "
            f"share {share}, scale rel {srel}, param err / tol {perr})"
        )


def phase_dqmm(gen, tokens=DQMM_TOKENS):
    """Kernel 7 at every Llama-3-8B weight shape (block 256) and T in
    `tokens` (8: decode; 77: ragged; the serving prompt buckets), against
    its plain version on the same inputs, with the variant that ran (the
    launch counters: `dqmm_decode_tma` counts the TMA-ring decode kernel,
    `dqmm_ws` the prefill kernel; a package without a counter ran its
    older kernel: "decode", "wgmma"). For T <= 16 the mma.sync decode
    kernel it replaced runs on the same inputs too (`old_*`). `ms`,
    `old_ms` and `dense_ms` cycle through enough weight copies to
    overflow L2, as a decode step streams every layer's weights."""
    from dlrover_tpu_torch.ops import _build
    from dlrover_tpu_torch.ops import quantization as tq

    has_tma = hasattr(tq, "_dqmm_mma_plan")
    block = 256
    rows = []
    for (k, o), names in DQMM_SHAPES:
        def make_q():
            w = torch.randn((o, k), generator=gen, device="cuda") * k ** -0.5
            return tq.QuantizedWeight(*tq.quantize_int8(w, block), block)

        qws = cold_copies(make_q, o * k)
        qw = qws[0]
        dense = tq._dq_weight(qw.q8, qw.s8, block, torch.bfloat16)
        denses = [dense] + [
            tq._dq_weight(c.q8, c.s8, block, torch.bfloat16)
            for c in qws[1:max(1, -(-(128 * 2**20) // (2 * o * k)))]
        ]
        for t in tokens:
            x = torch.randn((t, k), generator=gen, device="cuda").bfloat16()
            before = _build.launch_counts()
            y = tq.quantized_matmul(x, qw)
            after = _build.launch_counts()
            ref = tq.quantized_matmul_reference(x, qw)
            again = tq.quantized_matmul(x, qw)
            torch.cuda.synchronize()
            ws = _launched(before, after, "dqmm_ws")
            dec = _launched(before, after, "dqmm_decode_tma")
            if "dqmm_ws" in after:
                if (_launched(before, after, "dqmm") != 1
                        or ws != int(t > 16)
                        or dec != int(has_tma and t <= 16)):
                    raise AssertionError(
                        f"dqmm at T={t}: launches {before} -> {after}, "
                        f"want one, on the prefill kernel iff T > 16 and "
                        f"else on the TMA-ring decode kernel"
                    )
                variant = "ws" if ws else "decode_tma" if dec else "decode"
            else:
                variant = "wgmma" if t > 16 else "decode"
            if t <= 16 and not torch.equal(y, again):
                raise AssertionError(f"dqmm at T={t}: reruns differ")
            err = (y.float() - ref.float()).abs().max().item()
            ref_max = ref.float().abs().max().item()
            tol = DQMM_REL_TOL * ref_max
            if not (torch.isfinite(y).all() and err <= tol):
                raise AssertionError(
                    f"dqmm kernel disagrees at T={t} K={k} O={o}: "
                    f"max_abs_err {err} (tol {tol})"
                )
            nbytes = o * k + 4 * o * (k // block) + 2 * t * k + 2 * t * o
            bms, by = bound_ms(2.0 * t * k * o, nbytes)
            plan = tq._dqmm_plan(t, k, o)
            row = dict(
                T=t, K=k, O=o, weights=names, block=block, variant=variant,
                splits=plan[1], grid=plan[3] if len(plan) > 3 else None,
                max_abs_err=err, ref_max_abs=ref_max, tol=tol,
                tol_reason=DQMM_TOL_REASON,
                ms=device_ms(cycling(lambda w: tq.quantized_matmul(x, w),
                                     qws), calls=max(10, len(qws))),
                eager_ms=time_ms(lambda: tq.quantized_matmul(x, qw), 20),
                plain_ms=time_ms(
                    lambda: tq.quantized_matmul_reference(x, qw), 3),
                dense_ms=device_ms(cycling(lambda w: x @ w.t(), denses),
                                   calls=max(10, len(denses))),
                dense_eager_ms=time_ms(lambda: x @ dense.t(), 20),
                library_ms=None, bound_ms=bms, bound_by=by,
            )
            if has_tma and t <= 16:
                old = tq._dqmm_cuda(x, qw, decode="mma")
                torch.cuda.synchronize()
                row["old_max_abs_err"] = (old.float() - ref.float()).abs(
                ).max().item()
                if not row["old_max_abs_err"] <= tol:
                    raise AssertionError(
                        f"mma.sync dqmm decode kernel disagrees at T={t} "
                        f"K={k} O={o}: {row['old_max_abs_err']} (tol {tol})")
                row["old_ms"] = device_ms(
                    cycling(lambda w: tq._dqmm_cuda(x, w, decode="mma"),
                            qws), calls=max(10, len(qws)))
            log("kernel.dqmm", **row)
            rows.append(row)
            del x, y, ref, again
        del qws, qw, dense, denses
        torch.cuda.empty_cache()
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


def _timings(tm, lens):
    """TTFT / TPOT / throughput of one `_serve` run."""
    ttft = [tm["first"][i] - tm["t0"] for i in sorted(tm["first"])]
    tpot = [(tm["last"][i] - tm["first"][i]) / (tm["count"][i] - 1)
            for i in sorted(tm["first"]) if tm["count"][i] > 1]
    return dict(
        wall_s=tm["wall"],
        ttft_ms_mean=1e3 * float(np.mean(ttft)),
        ttft_ms_p50=1e3 * float(np.median(ttft)),
        ttft_ms_max=1e3 * float(np.max(ttft)),
        tpot_ms_mean=1e3 * float(np.mean(tpot)),
        tokens_per_s=float(sum(lens)) / tm["wall"],
        peak_mem_gb=torch.cuda.max_memory_allocated() / 2**30,
    )


def phase_serve(params, cfg):
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
    _check_wgmma("serve", launches)
    _check_paged_tma("serve", launches)
    e2e = dict(
        requests=len(prompts), prompt_lens=[len(p) for p in prompts],
        max_new=max_new, n_slots=n_slots, admissions=engine.admissions,
        decode_steps=engine.decode_steps, launches=launches,
        **_timings(tm, lens),
    )
    weight_bytes = engine.weight_bytes_device()
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
    log("serve", weight_bytes=weight_bytes, **e2e)

    # first decode step after a 1000-token prefill: kernel path
    # (flash prefill + paged decode) vs plain attention, same weights
    _check_first_decode(
        "serve.first_decode_logits",
        _first_decode_logits(cfg, params, prompts[0], max_len),
        _first_decode_logits(ref_cfg, params, prompts[0], max_len),
        "5% of the largest logit: bf16 roundings of the two attention "
        "paths carried through 32 layers",
    )
    e2e.update(outs=outs, weight_bytes=weight_bytes)
    return e2e


def _first_decode_logits(cfg, params, p, max_len):
    """Logits of the first decode step after prefilling prompt `p`
    (padded to its 1024 bucket) into a fresh exact row installed into
    a page pool: the engine's paged admission and decode, one slot."""
    from dlrover_tpu_torch.models import decode as dec

    bucket = 1024
    prompt = torch.zeros(bucket, dtype=torch.long, device="cuda")
    prompt[: len(p)] = torch.tensor(p, device="cuda")
    per_slot = max_len // 16
    table = torch.arange(1, per_slot + 1, dtype=torch.int32,
                         device="cuda")[None]
    pool = dec.init_page_pool(cfg, per_slot + 1, 16)
    row = dec.prefill_exact_row(cfg, params, prompt, max_len)
    dec.paged_install_row(pool, row, table[0], 0, bucket)
    del row
    logits, _ = dec.paged_decode_step(
        cfg, params, torch.tensor([p[-1]], device="cuda"), pool, table,
        torch.tensor([len(p) - 1], device="cuda"),
    )
    return logits


def _check_first_decode(phase, lk, lr, tol_reason):
    if not (torch.isfinite(lk).all() and torch.isfinite(lr).all()):
        raise AssertionError(f"{phase}: non-finite logits")
    err = (lk - lr).abs().max().item()
    ref_max = lr.abs().max().item()
    tol = LOGITS_REL_TOL * ref_max
    log(phase, max_abs_err=err, ref_max_abs=ref_max, tol=tol,
        tol_reason=tol_reason, argmax_equal=bool(lk.argmax() == lr.argmax()))
    if not err <= tol:
        raise AssertionError(f"{phase}: logits differ by {err} > {tol}")


def _dequantized_tree(params):
    """The served int8 tree with every QuantizedWeight replaced by the
    dense bf16 weight it stands for, `_dq_weight(q8, s8)` transposed to
    [.., K, O] (a view of the [.., O, K] values), one layer at a time."""
    from dlrover_tpu_torch.ops.quantization import QuantizedWeight, _dq_weight

    def dense(w):
        if not isinstance(w, QuantizedWeight):
            return w
        out = torch.empty(w.q8.shape, dtype=torch.bfloat16, device="cuda")
        flat_q = w.q8.reshape((-1,) + tuple(w.q8.shape[-2:]))
        flat_s = w.s8.reshape((-1,) + tuple(w.s8.shape[-2:]))
        flat_o = out.reshape(flat_q.shape)
        for i in range(flat_q.shape[0]):
            flat_o[i] = _dq_weight(flat_q[i], flat_s[i], w.block,
                                   torch.bfloat16)
        return out.transpose(-1, -2)

    return {
        group: ({k: dense(v) for k, v in node.items()}
                if isinstance(node, dict) else node)
        for group, node in params.items()
    }


def _check_install_bytes(params, qparams):
    """The last layer slice of every quantized leaf and the untied
    lm_head, as the int8 install stored them, against the plain
    quantizer on the same bf16 slice, byte for byte: every weight
    shape the install ran kernel 5 at."""
    from dlrover_tpu_torch.ops import quantization as tq

    leaves = [(name, params["layers"][name][-1], w[-1])
              for name, w in sorted(qparams["layers"].items())
              if isinstance(w, tq.QuantizedWeight)]
    head = qparams.get("lm_head", {}).get("weight")
    if isinstance(head, tq.QuantizedWeight):
        leaves.append(("lm_head", params["lm_head"]["weight"], head))
    shapes = {}
    for name, dense, qw in leaves:
        q_ref, s_ref = tq._quantize_plain(dense.t().contiguous(), qw.block)
        q_diff = int((qw.q8 != q_ref).sum())
        s_diff = int((qw.s8 != s_ref).sum())
        if q_diff or s_diff:
            raise AssertionError(
                f"installed {name} differs from the plain quantizer: "
                f"{q_diff} q8 and {s_diff} s8 values"
            )
        shapes[name] = list(qw.q8.shape)
        del q_ref, s_ref
    log("serve.int8.install_bytes", checked=shapes, q8_diff=0, s8_diff=0)


def phase_serve_int8(params, cfg, bf16):
    """The serve phase's traffic through weight_quant="int8": install
    (kernel 5 per layer slice) and serving (kernel 7 on every product)
    run with the launch counts set to 0 just before and read after."""
    from dlrover_tpu_torch.ops import _build
    from dlrover_tpu_torch.serving.engine import ContinuousBatcher

    max_new, n_slots, max_len = 32, 8, 2048
    prompts = _prompts(cfg)
    kw = dict(n_slots=n_slots, max_len=max_len, max_new_tokens=max_new,
              chunk=8, kv_layout="paged", weight_quant="int8")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    engine = ContinuousBatcher(cfg, params, **kw)
    torch.cuda.synchronize()
    install_s = time.perf_counter() - t0
    quant_launches = _build.launch_counts()["quant_int8"]
    outs, tm = _serve(engine, prompts, max_new)
    torch.cuda.synchronize()
    launches = _build.launch_counts()
    lens = [len(o) for o in outs]
    if lens != [max_new] * len(prompts):
        raise AssertionError(f"int8 token counts {lens}, want {max_new} each")
    toks = np.concatenate(outs)
    if toks.min() < 0 or toks.max() >= cfg.vocab_size:
        raise AssertionError("int8: token id out of the vocabulary")
    if engine.weight_quant_path != "int8:kernel":
        raise AssertionError(f"weight_quant_path {engine.weight_quant_path}")
    per_forward = 7 * cfg.n_layers + (0 if cfg.tie_embeddings else 1)
    forwards = engine.admissions + engine.decode_steps
    want = dict(
        dqmm=forwards * per_forward, quant_int8=per_forward,
        flash_fwd=engine.admissions * cfg.n_layers,
        paged_attention=engine.decode_steps * cfg.n_layers,
    )
    short = {k: (launches[k], v) for k, v in want.items() if launches[k] < v}
    # every prefill product (T = a prompt bucket > 16) on the prefill
    # kernel, every decode product (T = 8 slots) on the TMA-ring decode
    # kernel (one launch, no combine), none on the mma.sync one
    by_variant = dict(
        ws=launches["dqmm_ws"],
        decode_tma=launches["dqmm_decode_tma"],
        decode_mma=(launches["dqmm"] - launches["dqmm_ws"]
                    - launches["dqmm_decode_tma"]),
    )
    want_variant = dict(ws=engine.admissions * per_forward,
                        decode_tma=engine.decode_steps * per_forward,
                        decode_mma=0)
    if short or quant_launches < per_forward or by_variant != want_variant:
        raise AssertionError(
            f"int8 kernels not on the path: (launches, want) {short}, "
            f"quant launches at install {quant_launches}, dqmm launches "
            f"by variant {by_variant}, want {want_variant}"
        )
    _check_wgmma("serve.int8", launches)
    _check_paged_tma("serve.int8", launches)
    wbytes = engine.weight_bytes_device()
    if not wbytes <= 0.55 * bf16["weight_bytes"]:
        raise AssertionError(
            f"int8 weight bytes {wbytes} > 0.55 x bf16 "
            f"{bf16['weight_bytes']}"
        )
    same = sum(int(np.array_equal(a, b)) for a, b in zip(outs, bf16["outs"]))
    e2e = dict(
        requests=len(prompts), admissions=engine.admissions,
        decode_steps=engine.decode_steps, launches=launches,
        dqmm_launches_by_variant=by_variant,
        quant_launches_at_install=quant_launches, install_s=install_s,
        weight_quant_path=engine.weight_quant_path,
        weight_quant_stats=engine.weight_quant_stats(),
        weight_bytes=wbytes, bf16_weight_bytes=bf16["weight_bytes"],
        weight_bytes_ratio=wbytes / bf16["weight_bytes"],
        **_timings(tm, lens),
        bf16_greedy_streams_identical=same,
        bf16_greedy_token_agreement=float(
            np.mean(np.concatenate(outs) == np.concatenate(bf16["outs"]))),
    )
    log("serve.int8", **e2e)
    qparams = engine.params
    del engine
    torch.cuda.empty_cache()
    _check_install_bytes(params, qparams)
    torch.cuda.empty_cache()
    # the int8 engine's first decode step against the same decode
    # functions on a dense bf16 tree holding exactly the dequantized
    # weights: the W8A16 kernel held to the dense product end to end
    lq = _first_decode_logits(cfg, qparams, prompts[0], max_len)
    dense = _dequantized_tree(qparams)
    ld = _first_decode_logits(cfg, dense, prompts[0], max_len)
    del dense
    torch.cuda.empty_cache()
    _check_first_decode(
        "serve.int8.first_decode_logits", lq, ld,
        "5% of the largest logit: the same bf16 weights and attention "
        "kernels on both sides; the f32 sums of 225 products a forward "
        "in another order, each rounded to bf16, carried through 32 "
        "layers",
    )
    return e2e


def _layer0_grads(cfg, params, batch):
    """Loss and the gradients of layer 0's wq/wk/wv/wo/w_down and of
    the embedding, on one microbatch."""
    from dlrover_tpu_torch.models import llama

    names = ("wq", "wk", "wv", "wo", "w_down")
    leaves = [params["layers"][n] for n in names] + [params["embed"]["weight"]]
    loss, _ = llama.loss_fn(cfg, params, batch)
    grads = torch.autograd.grad(loss, leaves)
    grads = [g[0] for g in grads[:-1]] + [grads[-1]]
    return loss.detach(), dict(zip(names + ("embed",), grads))


def _adamw(params):
    """`optax.adamw(1e-4)` (torch's default weight decay is 1e-2)."""
    return torch.optim.AdamW(params, lr=TRAIN_LR, betas=(0.9, 0.999),
                             eps=1e-8, weight_decay=TRAIN_WD)


def _train_setup(optimizer):
    """The train phases' model, ElasticTrainer over `optimizer` (a
    factory), batch and the generator to draw the params from next:
    both phases draw the tokens and then the params from one fixed
    seed, so both start from the same point. The Trainer's step and
    card metrics files are pointed into smoke_out/ beside this
    script."""
    import os

    from dlrover_tpu_torch.models import llama
    from dlrover_tpu_torch.trainer.elastic.trainer import ElasticTrainer

    out = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "smoke_out")
    os.environ["DLROVER_TPU_RUNTIME_METRICS_PATH"] = os.path.join(
        out, "runtime_metrics.json")
    os.environ["DLROVER_TPU_CHIP_METRICS_PATH"] = os.path.join(
        out, "chip_metrics.json")
    cfg = llama.LlamaConfig.llama3_8b(n_layers=TRAIN_LAYERS)
    assert cfg.remat and cfg.remat_policy == "full"
    gen = torch.Generator(device="cuda").manual_seed(TRAIN_SEED)
    tokens = torch.randint(0, cfg.vocab_size,
                           (TRAIN_GLOBAL_BATCH, TRAIN_SEQ + 1),
                           generator=gen, device="cuda")
    et = ElasticTrainer(
        lambda g: llama.init_params(cfg, g, dtype=cfg.param_dtype),
        lambda p, b: llama.loss_fn(cfg, p, b),
        optimizer,
        global_batch_size=TRAIN_GLOBAL_BATCH,
        max_per_replica_batch=TRAIN_MICROBATCH,
    )
    return cfg, et, tokens, gen


def _timed_steps(opt):
    """Record the wall time of each `opt.step()`, synchronised before
    and after (the list it returns fills as the Trainer steps). Step
    hooks, not a wrapper bound to `opt`: a closure over the optimizer
    stored on it would be a reference cycle, and the optimizer (params
    and moments) would outlive its phase until a garbage collection."""
    times, start = [], []

    def pre(optimizer, args, kwargs):
        torch.cuda.synchronize()
        start.append(time.perf_counter())

    def post(optimizer, args, kwargs):
        torch.cuda.synchronize()
        times.append(time.perf_counter() - start[-1])

    opt.register_step_pre_hook(pre)
    opt.register_step_post_hook(post)
    return times


def _state_bytes(opt):
    """Bytes of the tensors an optimizer's state holds."""
    return sum(t.numel() * t.element_size() for st in opt.state.values()
               for t in st.values() if torch.is_tensor(t))


def _run_trainer(cfg, et, state, tokens, phase):
    """TRAIN_STEPS Trainer steps on the one batch, with the launch counts
    set to 0 just before and read just after: the flash kernels must
    have run exactly as often as the path calls them (every forward and
    backward launch on its wgmma variant) and the losses
    must be finite and fall. Returns the phase's numbers (and the
    Trainer's launch counts) without logging them."""
    from dlrover_tpu_torch.models import llama
    from dlrover_tpu_torch.ops import _build
    from dlrover_tpu_torch.trainer.trainer import (
        Trainer,
        TrainerCallback,
        TrainingArguments,
    )

    class Record(TrainerCallback):
        def __init__(self):
            self.ends, self.losses = [], []

        def on_step_end(self, trainer, state, metrics):
            self.ends.append(time.perf_counter())   # the step has synced

        def on_log(self, trainer, state, logs):
            self.losses.append(logs["loss"])

    rec = Record()
    opt_s = _timed_steps(state["opt_state"])
    trainer = Trainer(
        et, TrainingArguments(max_steps=TRAIN_STEPS, logging_steps=1,
                              save_steps=0, resume=False),
        train_data=[{"tokens": tokens}] * TRAIN_STEPS, callbacks=[rec],
    )
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    state = trainer.train(state)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _build.launch_counts()
    per_pass = cfg.n_layers * et.grad_accum * TRAIN_STEPS
    want = dict(flash_fwd=2 * per_pass, flash_bwd_dq=per_pass,
                flash_bwd_dkv=per_pass)
    if any(launches[k] != v for k, v in want.items()):
        raise AssertionError(f"{phase} launches {launches}, want {want}")
    _check_wgmma(phase, launches,
                 ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"))
    losses = rec.losses
    if not (len(losses) == TRAIN_STEPS and all(np.isfinite(losses))
            and losses[-1] < losses[0]):
        raise AssertionError(f"{phase} losses {losses}: not finite or not "
                             "falling")
    steps_s = np.diff([t0] + rec.ends)
    step_s = float(np.median(steps_s[1:]))
    tokens_per_step = TRAIN_GLOBAL_BATCH * TRAIN_SEQ
    flops_tok = llama.flops_per_token(cfg, TRAIN_SEQ, causal=True)
    return dict(
        steps=TRAIN_STEPS, global_batch=TRAIN_GLOBAL_BATCH,
        microbatch=TRAIN_MICROBATCH, seq=TRAIN_SEQ, grad_accum=et.grad_accum,
        losses=losses, step_s=steps_s.tolist(), median_step_s=step_s,
        first_step_s=float(steps_s[0]), wall_s=wall,
        tokens_per_s=tokens_per_step / step_s,
        flops_per_token=flops_tok,
        mfu=flops_tok * tokens_per_step / step_s / PEAK_BF16_FLOPS,
        peak_mem_gb=torch.cuda.max_memory_allocated() / 2**30,
        opt_state_bytes=_state_bytes(state["opt_state"]),
        opt_step_s=opt_s, median_opt_step_s=float(np.median(opt_s[1:])),
        launches=launches, last_logs=trainer.last_logs,
    )


def phase_train():
    """The training path on Llama-3-8B at full width, cut to 4 layers
    (the f32 params, gradients and two AdamW moments of all 32 layers
    would need 128 GB): Trainer over ElasticTrainer over accelerate over
    llama.loss_fn, random f32 params from the seed, bf16 compute, remat
    "full", AdamW(lr 1e-4, weight decay 1e-4), one batch of 4 x 2049
    tokens repeated for 8 steps (global batch 4, microbatches of 2).
    First, on one microbatch, the loss and layer-0 / embedding
    gradients through the kernels are held to plain attention on the
    same params; then the 8 steps run with the launch counts set to 0
    just before and read just after."""
    import dataclasses

    from dlrover_tpu_torch.models import llama

    cfg, et, tokens, gen = _train_setup(_adamw)
    t0 = time.perf_counter()
    state = et.init_state(gen)
    torch.cuda.synchronize()
    log("train.model", config="llama3_8b", n_layers=cfg.n_layers,
        params=llama.num_params(cfg), param_dtype=str(cfg.param_dtype),
        compute_dtype=str(cfg.dtype), remat=cfg.remat_policy,
        grad_accum=et.grad_accum, init_s=time.perf_counter() - t0)

    micro = {"tokens": tokens[:TRAIN_MICROBATCH]}
    loss_k, grads_k = _layer0_grads(cfg, state["params"], micro)
    ref_cfg = dataclasses.replace(cfg, attn_impl="reference")
    loss_r, grads_r = _layer0_grads(ref_cfg, state["params"], micro)
    loss_err = abs(loss_k.item() - loss_r.item())
    grad_errs = {n: ((grads_k[n] - grads_r[n]).norm()
                     / grads_r[n].norm()).item() for n in grads_r}
    log("train.vs_reference_attention", loss=loss_k.item(),
        ref_loss=loss_r.item(), loss_abs_err=loss_err,
        grad_rel_l2_err=grad_errs,
        grad_max_abs_err={n: (grads_k[n] - grads_r[n]).abs().max().item()
                          for n in grads_r},
        loss_rel_tol=TRAIN_LOSS_REL_TOL, grad_rel_tol=TRAIN_GRAD_REL_TOL,
        tol_reason=TRAIN_TOL_REASON)
    if not (loss_err <= TRAIN_LOSS_REL_TOL * abs(loss_r.item())
            and all(e <= TRAIN_GRAD_REL_TOL for e in grad_errs.values())):
        raise AssertionError(
            f"train: kernels vs plain attention: loss err {loss_err}, "
            f"gradient errors {grad_errs}"
        )
    del grads_k, grads_r
    torch.cuda.empty_cache()

    e2e = _run_trainer(cfg, et, state, tokens, "train")
    log("train", **e2e)
    del state, et
    torch.cuda.empty_cache()
    return e2e


def phase_train_int8(train):
    """The train phase's workload, shapes, params and tokens with
    int8_adam(1e-4, weight_decay=1e-4), block 256, in place of AdamW:
    the dequantize and quantize kernels run on both moments of each of
    the 12 param leaves at every step. Step 1's loss must equal train's
    (same params, same batch, before any update), the moments must
    take 2 x (N + 4N/256) bytes (<= 0.254x of AdamW's 8N) and the peak
    memory must stay below train's."""
    from dlrover_tpu_torch.models import llama
    from dlrover_tpu_torch.optim import int8_adam

    cfg, et, tokens, gen = _train_setup(
        int8_adam(TRAIN_LR, weight_decay=TRAIN_WD))
    state = et.init_state(gen)
    opt = state["opt_state"]
    n = llama.num_params(cfg)
    leaves = len(opt.state)
    state_bytes = _state_bytes(opt)
    if leaves != 12 or state_bytes != 2 * (n + 4 * n // 256) or not (
            state_bytes <= 0.254 * 8 * n):
        raise AssertionError(
            f"train.int8_adam: {leaves} leaves, moment bytes {state_bytes}, "
            f"want 12 and 2 x (N + 4N/256) = {2 * (n + 4 * n // 256)}"
        )
    e2e = _run_trainer(cfg, et, state, tokens, "train.int8_adam")
    launches = e2e["launches"]
    want = 2 * leaves * TRAIN_STEPS
    first, first_ref = e2e["losses"][0], train["losses"][0]
    checks = dict(
        launches=launches["dequant_int8"] == launches["quant_int8"] == want,
        step1_loss=abs(first - first_ref) <= 1e-5 * abs(first_ref),
        peak=e2e["peak_mem_gb"] < train["peak_mem_gb"],
    )
    e2e.update(
        moment_bytes=state_bytes, adamw_moment_bytes=8 * n,
        moment_bytes_ratio=state_bytes / (8 * n),
        adamw_opt_state_bytes=train["opt_state_bytes"],
        adamw_losses=train["losses"],
        adamw_median_step_s=train["median_step_s"],
        adamw_peak_mem_gb=train["peak_mem_gb"],
        adamw_median_opt_step_s=train["median_opt_step_s"],
        want_dequant_quant_launches=want, checks=checks,
    )
    log("train.int8_adam", **e2e)
    if not all(checks.values()):
        raise AssertionError(f"train.int8_adam: failed checks {checks}")
    del state, et, opt
    torch.cuda.empty_cache()
    return e2e


def phase_profile(params, cfg, weight_quant="none"):
    """`--profile`: where the time of one admission wave (8 prefills +
    one 8-step chunk) and of one pure decode chunk goes, by CUDA kernel
    (torch.profiler), and the device's busy share of the wall time,
    each followed by the profiler's full table."""
    from torch.profiler import ProfilerActivity, profile

    from dlrover_tpu_torch.serving.engine import ContinuousBatcher

    prompts = _prompts(cfg)[:8]
    kw = dict(n_slots=8, max_len=2048, max_new_tokens=32, chunk=8,
              kv_layout="paged", weight_quant=weight_quant)
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
        # ops that launched them carry the same device time again, and
        # so do ranges such as "Optimizer.step#AdamW.step"
        rows = [e for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA
                and e.self_device_time_total > 0
                and not getattr(e, "is_user_annotation", False)]
        dev_us = sum(e.self_device_time_total for e in rows)
        rows.sort(key=lambda e: -e.self_device_time_total)
        log(f"profile.{label}", weight_quant=weight_quant,
            wall_ms=1e3 * wall,
            device_ms=dev_us / 1e3,
            device_busy_share=dev_us / 1e6 / wall,
            top=[(e.key[:60], e.count, e.self_device_time_total / 1e3)
                 for e in rows[:12]])
        print(prof.key_averages().table(
            sort_by="self_device_time_total", row_limit=40), flush=True)


def phase_profile_train(int8):
    """`--profile --train [--int8-adam]`: where the device time of one
    training step of the train phase goes (after two warm-up steps), by
    CUDA kernel, and the device's busy share of the step's wall time;
    with AdamW, or with int8_adam as in train.int8_adam."""
    from torch.profiler import ProfilerActivity, profile

    from dlrover_tpu_torch.optim import int8_adam

    _, et, tokens, gen = _train_setup(
        int8_adam(TRAIN_LR, weight_decay=TRAIN_WD) if int8 else _adamw)
    state = et.init_state(gen)
    batch = {"tokens": tokens}
    for _ in range(2):
        state, _m = et.step(state, batch)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, _m = et.step(state, batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.self_device_time_total > 0
            and not getattr(e, "is_user_annotation", False)]
    dev_us = sum(e.self_device_time_total for e in rows)
    rows.sort(key=lambda e: -e.self_device_time_total)
    log("profile.train_step", optimizer="int8_adam" if int8 else "adamw",
        wall_ms=1e3 * wall, device_ms=dev_us / 1e3,
        device_busy_share=dev_us / 1e6 / wall,
        top=[(e.key[:60], e.count, e.self_device_time_total / 1e3)
             for e in rows[:20]])
    print(prof.key_averages().table(
        sort_by="self_device_time_total", row_limit=40), flush=True)


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    args = sys.argv[1:]
    if "--package-root" in args:
        # another checkout's package (an A/B of kernel 7 in one call)
        sys.path.insert(0, args[args.index("--package-root") + 1])
    from dlrover_tpu_torch.models import llama

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = phase_card()
    phase_build()
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    if "--dqmm" in args or "--decode-kernels" in args:
        import dlrover_tpu_torch

        log("package", path=dlrover_tpu_torch.__file__)
        if "--dqmm" in args:
            phase_dqmm(gen)
        else:
            phase_paged(gen)
            phase_dqmm(gen, DECODE_TOKENS)
        return 0
    if "--profile" in sys.argv[1:] and "--train" in sys.argv[1:]:
        phase_profile_train("--int8-adam" in sys.argv[1:])
        return 0
    if "--profile" in sys.argv[1:]:
        cfg = llama.LlamaConfig.llama3_8b()
        phase_profile(llama.init_params(cfg, gen), cfg,
                      "int8" if "--int8" in sys.argv[1:] else "none")
        return 0
    flash_rows = phase_flash(gen)
    bwd_rows = phase_flash_bwd(gen)
    paged_rows = phase_paged(gen)
    quant_rows = phase_quant(gen)
    dequant_rows = phase_dequant(gen)
    phase_opt_int8()
    dqmm_rows = phase_dqmm(gen)
    torch.cuda.empty_cache()

    cfg = llama.LlamaConfig.llama3_8b()
    t0 = time.perf_counter()
    params = llama.init_params(cfg, gen)
    torch.cuda.synchronize()
    log("model", config="llama3_8b", params=llama.num_params(cfg),
        dtype=str(cfg.dtype), init_s=time.perf_counter() - t0)
    e2e = phase_serve(params, cfg)
    e2e_int8 = phase_serve_int8(params, cfg, e2e)
    del params
    torch.cuda.empty_cache()
    train = phase_train()
    train_int8 = phase_train_int8(train)

    main_flash = next(r for r in flash_rows if (r["B"], r["S"]) == (1, 512))
    main_bwd = next(r for r in bwd_rows if (r["B"], r["S"]) == (2, 2048))
    flash_by_path = {"serve": e2e["launches"]["flash_fwd"],
                     "serve.int8": e2e_int8["launches"]["flash_fwd"],
                     "train": train["launches"]["flash_fwd"],
                     "train.int8_adam": train_int8["launches"]["flash_fwd"]}
    bwd_by_path = {name: {"train": train["launches"][name],
                          "train.int8_adam": train_int8["launches"][name]}
                   for name in ("flash_bwd_dq", "flash_bwd_dkv")}
    main_paged = paged_rows[0]
    main_quant = next(r for r in quant_rows if r["input"] == "bfloat16")
    quant_by_path = {"serve.int8": e2e_int8["launches"]["quant_int8"],
                     "train.int8_adam": train_int8["launches"]["quant_int8"]}
    main_dequant = dequant_rows[0]
    main_dqmm = next(r for r in dqmm_rows
                     if (r["T"], r["K"], r["O"]) == (8, 4096, 14336))
    main_ws = next(r for r in dqmm_rows
                   if (r["T"], r["K"], r["O"]) == (1024, 4096, 14336))
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    kernels = [
        dict(name="flash_fwd", route="cuda",
             source="dlrover_tpu_torch/csrc/flash_fwd.cu",
             replaces="dlrover_tpu/ops/flash_attention.py:163",
             launches=sum(flash_by_path.values()),
             launches_by_path=flash_by_path,
             variant="wgmma", mma_ms=main_flash["mma_ms"],
             **{k: main_flash[k] for k in keys},
             shape="B=1 S=512 H=32 KV=8 D=128 bf16 causal (the train "
                   "path's B=2 S=2048 in per_shape; mma_ms: the mma.sync "
                   "variant on the same inputs)",
             per_shape=flash_rows),
        dict(name="flash_bwd_dq", route="cuda",
             source="dlrover_tpu_torch/csrc/flash_bwd.cu",
             replaces="dlrover_tpu/ops/flash_attention.py:276",
             launches=sum(bwd_by_path["flash_bwd_dq"].values()),
             launches_by_path=bwd_by_path["flash_bwd_dq"],
             max_abs_err=main_bwd["errs"]["dq"], ms=main_bwd["dq_ms"],
             variant="wgmma", mma_ms=main_bwd["mma_dq_ms"],
             plain_ms=main_bwd["plain_ms"], bound_ms=main_bwd["dq_bound_ms"],
             bound_by=main_bwd["dq_bound_by"],
             library_ms=main_bwd["library_ms"],
             shape="B=2 S=2048 H=32 KV=8 D=128 bf16 causal, the train "
                   "path's microbatch (plain_ms and library_ms: the whole "
                   "backward; mma_ms: the mma.sync kernel on the same "
                   "inputs)",
             per_shape=bwd_rows),
        dict(name="flash_bwd_dkv", route="cuda",
             source="dlrover_tpu_torch/csrc/flash_bwd.cu",
             replaces="dlrover_tpu/ops/flash_attention.py:328",
             launches=sum(bwd_by_path["flash_bwd_dkv"].values()),
             launches_by_path=bwd_by_path["flash_bwd_dkv"],
             max_abs_err=max(main_bwd["errs"]["dk"], main_bwd["errs"]["dv"]),
             ms=main_bwd["dkv_ms"], variant="wgmma",
             mma_ms=main_bwd["mma_dkv_ms"], plain_ms=main_bwd["plain_ms"],
             bound_ms=main_bwd["dkv_bound_ms"],
             bound_by=main_bwd["dkv_bound_by"],
             library_ms=main_bwd["library_ms"],
             shape="B=2 S=2048 H=32 KV=8 D=128 bf16 causal, the train "
                   "path's microbatch (plain_ms and library_ms: the whole "
                   "backward; mma_ms: the mma.sync kernel on the same "
                   "inputs)"),
        dict(name="paged_attention", route="cuda",
             source="dlrover_tpu_torch/csrc/paged_attention.cu",
             replaces="dlrover_tpu/ops/paged_attention.py:160",
             launches=e2e["launches"]["paged_attention"],
             launches_by_path={
                 "serve": e2e["launches"]["paged_attention"],
                 "serve.int8": e2e_int8["launches"]["paged_attention"]},
             variant=main_paged["variant"], warm_ms=main_paged["warm_ms"],
             old_ms=main_paged["old_ms"],
             old_warm_ms=main_paged["old_warm_ms"],
             **{k: main_paged[k] for k in keys},
             shape="B=8 H=32 KV=8 D=128 page 16 bf16 pool, 5812 live "
                   "cells (ms: cold, the pool cycled through copies that "
                   "overflow L2; warm_ms: one pool; old_*: the split "
                   "kernel it replaced; the int8 pool in per_variant)",
             per_variant=paged_rows),
        dict(name="quantize_int8", route="cuda",
             source="dlrover_tpu_torch/csrc/quant_int8.cu",
             replaces="dlrover_tpu/ops/quantization.py:44",
             launches=sum(quant_by_path.values()),
             launches_by_path=quant_by_path,
             **{k: main_quant[k] for k in keys},
             shape="[14336, 4096] bf16 -> int8, block 256 (one w_gate "
                   "layer, output-major; the embedding's f32 moment as "
                   "[1, 525336576] in per_input)",
             per_input=quant_rows),
        dict(name="dequantize_int8", route="cuda",
             source="dlrover_tpu_torch/csrc/dequant_int8.cu",
             replaces="dlrover_tpu/ops/quantization.py:55",
             launches=train_int8["launches"]["dequant_int8"],
             launches_by_path={
                 "train.int8_adam": train_int8["launches"]["dequant_int8"]},
             **{k: main_dequant[k] for k in keys},
             shape="[1, 525336576] int8 -> f32, block 256 (the embedding's "
                   "moment as the int8 AdamW holds it)",
             per_shape=dequant_rows),
        dict(name="dqmm", route="cuda",
             source="dlrover_tpu_torch/csrc/dqmm.cu",
             replaces="dlrover_tpu/ops/quantization.py:306",
             launches=e2e_int8["launches"]["dqmm"],
             launches_by_variant=e2e_int8["dqmm_launches_by_variant"],
             **{k: main_dqmm[k] for k in keys},
             variant=main_dqmm["variant"], old_ms=main_dqmm["old_ms"],
             dense_ms=main_dqmm["dense_ms"],
             prefill_ms=main_ws["ms"], prefill_bound_ms=main_ws["bound_ms"],
             prefill_dense_ms=main_ws["dense_ms"],
             shape="T=8 K=4096 O=14336 (w_gate decode, the TMA-ring "
                   "decode kernel; old_ms: the mma.sync decode kernel it "
                   "replaced) bf16 x int8, block 256; prefill_*: the same "
                   "weight at T=1024 on the prefill kernel (dqmm_ws)",
             per_shape=dqmm_rows),
    ]
    print(json.dumps({"kernels": kernels}, default=float), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
