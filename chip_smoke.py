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
     and dqmm (the five weight shapes at T = 8, at a verify's 40, at 77
     and at the serving prompt buckets 128, 256, 512 and 1024, with the dense bf16
     matmul's time and the variant that ran beside it; at T = 8 the
     TMA-ring decode kernel, with the mma.sync decode kernel it replaced
     timed on the same inputs); kernel.sharded: the two sharded kernel
     sites at Llama-3-8B's heads on tp = 2 and 4 virtual shards of the
     card (DLROVER_TPU_TORCH_FORCE_DEVICE_COUNT set inside the phase
     only): sharded_flash_attention at B=1, S = 512 and 2048, and the
     sharded paged attention at serve's decode shape, bf16 and int8
     pools: each shard's output bit-equal to the tp=1 kernel's head
     slice, tp launches a call, the time beside tp=1's;
  4. serve: ContinuousBatcher on Llama-3-8B at full width and depth
     (random weights from a seed), kv_layout="paged", greedy-serving 12
     requests; every request must finish, both attention kernels must
     have run on that path (every flash forward on its wgmma variant,
     every paged launch on the TMA-ring kernel), the first-decode-step
     logits must match the
     plain attention path, and a reference-attention engine gives the
     greedy agreement;
  4a. serve.tp2: serve's traffic through mesh_spec=2 on two virtual
     shards of the card (wq/wk/wv split by head, the pool by KV head,
     attention per shard, wo / MLP / logits once): streams equal
     serve's byte for byte, kernel_path "kernel", paged TMA-ring and
     flash wgmma launches twice serve's; TTFT, TPOT, tokens/s, peak
     memory and weight bytes a shard beside serve's;
  4b. serve.tp2.resize: the same traffic on the first 4 layers at tp=2,
     shrunk to tp=1 after step 2 and grown back after step 3 (every
     live request replayed each time): streams equal a tp=2 run with
     the same replays and no resize; downtime_ms and replays of each
     direction, the agreement with the uninterrupted run;
  4c. serve.tp2.int8: the 4-layer traffic with weight_quant="int8" at
     tp=2: "int8:reference", no dqmm launch, streams equal tp=1 int8's
     on the plain product (agreement with tp=1 on the kernel
     reported);
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
  5a. serve.int8_stochastic: the same traffic and weights through
     weight_quant="int8_stochastic" (the install rounds each value up
     or down at random, plain PyTorch on the card): every request
     finishes, the dequant-matmul launches by variant equal serve.int8's
     and the quantize kernel launches 0 times; for the last layer slice
     of every quantized weight and the lm_head, the scales byte-equal to
     the CPU `stochastic_round_int8` on the same slice, every q8 the
     floor or the ceiling of w / scale, and the mean of dequant - w
     within 6 standard deviations of its binomial spread; install_s and
     the greedy agreement with serve.int8 (reported);
  6. serve.spec: the paged engine with spec_draft_len=4 and max_len 2044
     (a 2048-cell bank in pages of 16), bf16 weights, greedy-serving 12
     requests of 64-token segments tiled to 256-1024 tokens, max_new 64:
     every request finishes, verify dispatches ran, every flash forward
     on its wgmma variant, every paged launch on the TMA-ring kernel and
     in a chunk step (none inside a verify); TTFT, TPOT, tokens/s,
     spec.stats() and step_stats beside the same engine with
     spec_draft_len=0 (max_len 2048) on the same prompts, and the greedy
     agreement of the two (reported);
  7. serve.spec.verify: one verify of 8 rows at the serving shapes
     against the same tokens stepped one at a time through
     paged_decode_step: the logits at each of the K+1 positions within
     5% of the largest logit; the verify's device time beside its
     gathered views', the attention over them and one decode step's;
  8. serve.spec.int8: serve.spec's traffic with weight_quant="int8":
     every verify product on `dqmm_ws` (T = 40), every chunk-step
     product on the TMA-ring decode kernel, launches by variant;
  9. serve.async: the serve phase's traffic at async_depth=1: the
     streams byte-equal to serve's (depth 0); then depth 0, 0 and 1
     again in turns, each byte-equal to serve's, for TPOT and
     step_stats of both depths in one phase;
  10. serve.adapters: serve's engine with six random LoRA adapters on
     wq/wk/wv/wo (ranks 8 / 16, alpha 2r, the delta 5% of the base wq
     projection's RMS) registered, a bank of 4 slots + the zero slot:
     wave 1 serve's 12 prompts under ad0, ad1, None, ad2, ad3, None,
     wave 2 six of them under ad4, ad5, None; every request finishes,
     the kernels ran as in serve, 6 uploads and 2 evictions, wave 1's
     base rows equal serve's streams byte for byte, and the engine's
     first-decode logits of the first ad0 and ad1 requests are within 5%
     of the largest logit of the same prompt on lora.merge's tree; TTFT,
     TPOT and tokens/s beside serve's, the bank's bytes, one decode
     step's device time with and without the LoRA operand;
  11. serve.adapters.base: serve's traffic, all base requests, through
     an adapter engine: the streams equal serve's byte for byte;
  12. serve.adapters.int8: wave 1 with weight_quant="int8": the quantize
     kernel at install, every base product on the dequant-matmul kernel
     (prefill dqmm_ws, decode dqmm_decode_tma) with the delta after it,
     every request finishes, the ad0 first-decode logits within 5% of a
     dense tree of the dequantized weights with the same adapter (their
     distance to the bf16 adapter engine's reported beside the int8
     weights' own, without an adapter);
  13. serve.refresh: a live update_params to tree B (init seed 1) with 8
     slots decoding: every request finishes, 8 replays, version 1, the
     commit's wall time, and 4 prompts served after the drain equal a
     fresh engine's streams on B byte for byte; then "defer" (staged,
     version 0 to the drain, committed at the idle fence, a later request
     at version 1), "raise" (refused mid-drain) and a poisoned tree (one
     leaf's shape changed: raises, version 0 keeps serving, rolled back);
  14. serve.refresh.int8: the live case with int8 weights: 225 quantize
     launches at the commit, the streams after it equal a fresh int8
     engine's on B;
  15. serve.prefix_pressure: the paged engine with the prefix cache
     (4 rows, blocks of 256) on a pool of 129 pages (the least that
     backs one maximal request; the dense-equivalent is 1025), greedy-
     serving 16 requests of one shared 512-token system prompt plus
     50-400 user tokens: every request must finish, preemption must
     fire and every preempted request resume, the prefix cache must
     hit, the allocator must be consistent after the drain with only
     the published prefix runs' pages held, the flash forward must
     have run once a layer for each prefix miss (every cold admission,
     replays included; warm and full-hit admissions attend through
     the cached-attention path), every launch on its wgmma variant,
     every paged launch on the TMA-ring kernel; the engine's own
     first-decode logits of its first cold and first warm admission,
     and of a full-hit admission (the system prompt alone, after the
     timed run, with copy-on-write of the frontier page), must match
     the same prompt admitted cold; greedy agreement with the same prompts on the dense-equivalent
     pool with no knob is reported;
  16. serve.prefill_chunk: the same engine with prefill_chunk=256:
     every request finishes, interleaved chunks ran, no flash launch
     (chunked admissions prefill through the cached-attention path),
     the paged checks as above, and the first chunked admission's
     first-decode logits must match the same prompt admitted cold;
  17. serve.kv_tier: serve.prefix_pressure's engine and traffic with a
     4 GiB host-DRAM KV tier: every request finishes, victims swap out
     to page-locked host memory and every preempted request resumes, at
     least one published prefix demotes and one promotes back, the first
     swapped request's pages read back after its swap-in are
     torch.equal to the pages copied before its swap-out, the first
     decode after a swap-in and the first cold admission's within 5% of
     the largest logit of the same prompt prefilled cold, every flash
     forward on wgmma and every paged launch on the TMA-ring kernel;
     bytes each way, the D2H / H2D rates and times at a 600-token
     victim beside a re-prefill of one, the time completing demotion
     copies waited, the admission stall beside serve.prefix_pressure's,
     TTFT / TPOT / tokens/s and the greedy agreement with it (reported);
  18. serve.kv_tier.int8kv: the same with kv_quant=True: the int8 pages
     and their scales swap and promote, every paged launch on the TMA
     kernel's int8-pool variant;
  19. serve.handoff: two engines on the card sharing the weights,
     replica_role "prefill" and "decode"; serve's 12 requests go
     prefill -> take_prefilled -> export_run -> submit_adopted over the
     "device" transport, then over "host" with kv_checksums=1 and one
     package corrupted in transit (quarantined, the request replayed):
     every request finishes, the decode engine launches no flash
     forward and adopts pages, the prefill engine no paged attention,
     the shipped bytes equal the installed pages, the first decode after
     an adoption within 5% of the colocated path's; export / adopt ms
     per request, kv_checksum ms per MB, TTFT and TPOT;
  19a. serve.sched: RequestScheduler over the paged bf16 engine built
     with mesh_spec={"tp": 1} (kernel_path "kernel"): 24 single-turn
     requests from workload.generate_trace (seed 5, all three tiers,
     max_new 32, 600 s deadlines), a burst of 8 batch-tier ones filling
     the 8 slots, then 2 arrivals a pump: every request ends DONE, at
     least one tier preemption, every flash forward on wgmma and every
     paged launch on the TMA-ring kernel; per-tier TTFT and TPOT from
     ServingMetrics, and the greedy agreement with the same engine's
     generate_all on the same prompts (reported);
  19b. serve.fleet: the serving fleet behind its HTTP front door — two
     paged bf16 engines on the card sharing the weights (8 slots,
     max_len 2048, pages of 16, chunk 8, prefix cache of 4 rows at a
     512-token block), each under a RequestScheduler and an
     InferenceReplica, in a ReplicaPool over a KVStoreService, behind a
     ServingGateway on 127.0.0.1; the traffic is two tenants, each with
     its own 512-token system prompt plus 50-400 user tokens (seed 3),
     max_new 32, greedy, 16 streaming POST /v1/generate from 16 client
     threads. (a) colocated: each tenant's prefix warmed on its own
     replica, then the 16 requests: every stream done with 32 tokens,
     both replicas admitted routed work, affinity matches > 0, on each
     engine flash launches = prefix misses x 32 layers (warm admissions
     attend through the cached path) all wgmma and paged launches =
     decode steps x 32 all TMA; client TTFT p50/p95, TPOT p50,
     tokens/s, routing stats and the greedy agreement with a fresh
     engine's generate_all (reported); (b) failover: the same traffic
     with a crash plan on replica-0 a few steps in: every stream done,
     failovers >= 1, replica-0's breaker open; (c) phase split: roles
     prefill and decode over HandoffCoordinator and the device
     transport: every stream done and handed off, the decode engine
     launches no flash forward, the prefill engine no paged attention.
     Per-engine launches are each engine's own steps' (per-thread
     counts), and their sum equals the phase's global counts;
  20. train: Trainer(ElasticTrainer(...)) over accelerate over
     llama.loss_fn on Llama-3-8B at full width, 4 layers (f32 params,
     bf16 compute, remat "full", AdamW), 8 steps of a global batch of
     4 x 2048 tokens in microbatches of 2; the losses must be finite and
     fall, the flash forward and both backward kernels (each on its
     wgmma variant) must have run exactly as often as the path calls
     them, and the first
     microbatch's loss and gradients must match the same model with
     plain attention;
  21. train.ckpt: the train workload with fused_ce=True through flash
     checkpoint: fused against unfused loss and gradients on one
     microbatch (each loss's time and peak memory); the snapshot
     buffers and the page-locked shm segment prepared, then 8 Trainer
     steps saving to memory every 2 steps and to disk at the end
     (blocking, staging and persist seconds; the flash kernels' exact
     launch counts); then steps 9 and 10, and again from a fresh state
     (another seed) that Trainer(resume=True) restores from memory,
     bit-equal on every leaf, and from disk once the segment is
     unlinked, bit-equal again: the losses of steps 9 and 10 must equal
     the uninterrupted run's bit for bit. The segment and the
     checkpoint directory are removed whatever happens;
  21a. train.master: the train workload fed through the port's job
     master in this process (LocalJobMaster over the stdlib transport,
     MasterClient, an ElasticDataset over IndexShardingClient reading
     {"tokens": row} samples of a seeded token array, batches into
     Trainer(master_client=...)): 8 steps, every index read exactly
     once, the dataset finished, the master's speed monitor at step 8
     and its metric collector holding the state's parameter count,
     exact flash launch counts (all wgmma), falling losses; then 4 steps
     saving to memory (and to disk at the end, the saver reporting the
     committed step: get_ckpt_latest_step), the master stopped and a
     new one started on the same port, and a Trainer from another seed
     resumed from memory over the same dataset: the union of reads
     covers the epoch, only at-least-once repeats, step 5's loss
     against the uninterrupted run's; RPC round trips (p50 / p99),
     master start and restart seconds, median step against train's;
  21b. train.agent: the train workload through the port's launcher in
     a subprocess (`elastic_run.main` under an outside wrapper that
     records the master, the spawns and the persists): the agent
     supervises a worker that runs init(), the train setup and a
     Trainer with memory saves every 2 steps; attempt 0 dies at the top
     of step 5, the agent persists the last published step, reports the
     failure and respawns it, and attempt 1 resumes from the agent's
     shared memory and finishes: launcher exit 0, one failure, node
     SUCCEEDED, each attempt's exact flash launches (all wgmma), losses
     within 1e-3 of train's, the resume from memory at the last step
     published before the crash, no nvcc in the worker, no CUDA context
     in the launcher, the node check's isolated bench healthy, and a
     script exiting 5 under --max-restarts 1 making the launcher exit
     5; the time to recover in parts and each attempt's median step;
  21c. train.dp: data-parallel training through the same launcher in
     subprocesses. (a) One rank on NCCL (a world of one) with train's
     config: losses within 1e-3 of train's (bit equality reported),
     exact flash launches (all wgmma). (b) Two agents on this machine,
     gloo by DLROVER_TPU_TORCH_DIST_BACKEND (NCCL refuses two ranks on
     one card), the model cut to 1 layer, global batch 4 at 1 row a
     replica: both ranks bit-equal after the init broadcast and every
     step, losses within 1e-3 of a one-process run of the same model,
     exact flash launches on each rank; then rank 1 leaves and rank 0,
     in a world of one after on_world_change, keeps its params bit for
     bit, doubles its grad_accum and takes 2 more steps. (c) On those
     two ranks, the compressed collectives on a w_gate-sized f32
     gradient a rank: every int8 payload byte-equal to the plain
     quantize, every received payload's dequantize bit-equal to the
     plain dequantize, the sums within JAX's tolerances (0.02 tree,
     0.15 ring),
     kernels 5 and 6 once a leaf or hop; step and collective times;
  22. train.int8_adam: the same workload from the same params and
     tokens with int8_adam (int8 block-quantized moments) in place of
     AdamW; the losses must be finite and fall, step 1's loss must
     equal train's, the dequantize and quantize kernels must have run
     exactly twice a param leaf and step, the moments must take at most
     0.254x of AdamW's bytes and the peak memory must stay below
     train's;
  22a. train.lora: the same workload with lora.inject (rank 16, alpha
     32, wq/wk/wv/wo) after the same base and lora_optimizer(AdamW):
     exact flash launches (all wgmma), every base leaf bit-equal after
     the 8 steps, wq_lora_b moved, the loss fell, the train state's keys
     JAX's for that optimizer (moments for the adapters only), and the
     adapter-only checkpoint (save_to_storage, a fresh engine's load,
     load_adapters onto a base injected afresh) giving logits bit-equal
     to the trained params'; step time, peak and moment bytes beside
     train's;
  22b. rl.ppo: PpoTrainer(rollout_engine="continuous") over that LoRA
     actor (lora_optimizer(Adam 1e-4)), the default ref copy and JAX's
     test critic (embedding -> value) at width 4096: 8 prompts of
     32-192 tokens, max_len 256, temperature 1, minibatches of 4 over
     2 epochs, kl_coef 0.1, two steps (the second rollout through
     update_params): exact flash launches (all wgmma), prompts kept,
     tokens in vocab, metrics finite, the actor's base bit-equal to the
     ref's copy and its adapters moved, and the engine's own
     first-decode logits in step 2 within 5% of the largest logit of
     llama.apply on the actor after step 1; rollout seconds and
     tokens/s, admissions, update seconds a minibatch, peak, moment
     bytes, the PPO metrics; after the path, greedy rollouts through
     both engines (rows equal, reported) and a decode step on the f32
     tree and on a bf16 copy;
  23. train.remat: the train workload at 2 layers (4 steps each) under
     the model's remat policies "full", "proj", "proj_mlp" and "none"
     (the model's remat off), and with the model's remat off under
     Strategy(remat="full"): median step,
     tokens/s, MFU and peak memory of each; losses finite and falling,
     exact flash launch counts (all wgmma), peaks none >= proj_mlp >=
     proj >= full;
  24. matmul.fp8_dot: fp8_dot on a w_gate-shaped product (x [4096,
     4096], w [4096, 14336], bf16) forward and backward for 4 steps from
     a zero state: y, dx and dw against the same products on the fp8
     values upcast to f32, the amax histories, and its time beside the
     bf16 product's;
  25. the model families (also alone: `--families`): kernel.families
     (every kernel at the shapes the families give it against its plain
     version, with SDPA's time where there is one: flash forward and
     backward at head_dim 64 with 25 heads causal and 16 non-causal,
     paged at KV group 1 on bf16 and int8 pools, the GPT-2 XL int8
     install's quantize launches bytes-equal, the four GPT-2 XL dqmm
     products at T = 8 and 1024); serve.gpt2_xl (GPT-2 XL at 48 layers,
     12 greedy requests of 50-900 tokens, paged, max_len 1024: exact
     flash and paged launches, all wgmma / TMA, the first decode within
     5% of plain attention) and serve.gpt2_xl.int8 (weight bytes <=
     0.55x, every dqmm launch on `dqmm_ws` or `dqmm_decode_tma`, greedy
     agreement with bf16 reported); serve.moe (the MoE Llama at
     Mixtral-8x7B widths, 2 layers, max_len 2048; aux loss and dropped
     share a call kind); train.gpt2_xl (48 layers, 8 steps of 4 x 1025,
     MFU from 6N + 12LSD), train.moe (1 layer), train.bert_large
     (non-causal flash launches counted, then a padded batch with none)
     and train.cnn (no kernel): exact launches, falling losses.
Between the kernel phases and the serving ones, kernel.jax_gate_shapes
runs every shape the wider kernel variants cover under the dispatch a
user calls (flash at head_dim 384 and 512, forward and backward; paged
decode at GQA groups 3 and 7 and head_dim 40, 96 and 512, bf16 and int8
pools; the int8 matmul at the engine's blocks of K = 24, 96, 160 and
1000 and with f32 x at w_gate's shape; quantize and dequantize at block
512 on the embedding's moment): each launched once on the variant it
names, held to its plain version and timed beside it
(`--jax-gate-shapes` runs only the card, build and this phase).
Then the script's wall time, one JSON line with every kernel's numbers,
the card's name and power limit, and last {"ok": true, "device": {...}}.

Exits non-zero, printing no result, where CUDA is not available.
`python3 chip_smoke.py --profile [--int8]` instead profiles one
admission wave and one decode chunk of the same engine (kernel times,
device busy share; --int8 with weight_quant="int8"), and `--profile
--train [--int8-adam] [--fused-ce]` one step of the train phase (with
int8_adam; with the fused loss);
neither prints a result line. `python3 chip_smoke.py --dqmm
[--package-root DIR]` runs only the card, build and dqmm phases, with
the `dlrover_tpu_torch` found under DIR (another checkout, such as a
parent commit unpacked by `git archive`) where one is given: the A/B
of two versions of kernel 7 in one call; it prints no result line
either. `python3 chip_smoke.py --spec` runs the card, build and serve phases and
phases 6-9 (the speculative and async serving), no result line;
`python3 chip_smoke.py --adapters` the card, build and serve phases and
phases 10-14 (adapters and weight refresh), no result line;
`python3 chip_smoke.py --tier` the card, build, serve and
serve.prefix_pressure phases and phases 17-19 (KV tier and handoff), no
result line; `python3 chip_smoke.py --sched` the card, build, serve and
serve.int8 phases and phases 5a and 19a, no result line;
`python3 chip_smoke.py --master` the card, build, train and
train.master phases, no result line;
`python3 chip_smoke.py --agent` the card, build, train and
train.agent phases, no result line;
`python3 chip_smoke.py --dp` the card, build, train and train.dp
phases, no result line;
`python3 chip_smoke.py --rl` the card, build, train, train.lora and
rl.ppo phases, no result line;
`python3 chip_smoke.py --tp` the card, build, kernel.sharded, serve and
serve.tp2 phases (4a-4c), no result line;
`python3 chip_smoke.py --families` the card, build and phase 25, no
result line;
`python3 chip_smoke.py --fleet` the card, build and serve.fleet phases,
then part (a)'s traffic through one replica and through two with a 0.5
ms thread switch interval (reported only), no result line.
`python3 chip_smoke.py --decode-kernels [--package-root DIR]`
runs the card, build and paged-attention phases and the dqmm rows at
T = 1, 8 and 16 of the five weight shapes: the A/B of the two decode
kernels (kernel 4 and kernel 7's decode variant) in one call, no result
line.
"""

import contextlib
import dataclasses
import json
import os
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
# the pressure phases: 16 requests on a 512-token system prompt, and a
# pool of max_len / page + 1 pages, the least that backs one maximal
# request (a request holds pages for its own limit only, at most 60 of
# them here, so a pool of half the dense-equivalent 1025 never preempts)
PRESSURE_SYSTEM = 512
PRESSURE_REQUESTS = 16
PRESSURE_PAGES = 2048 // 16 + 1
# the KV tier phases: the pressure traffic with a 4 GiB host tier; the
# transfer rates at a 600-token victim (38 pages of 16, moved as the
# tier's 64-page bucket), each way TIER_TRANSFER_REPS times
TIER_BYTES = 4 << 30
TIER_VICTIM_TOKENS = 600
TIER_TRANSFER_REPS = 5
# serve.int8_stochastic: the install's rounding checks hold the mean of
# (dequant - w) within STOCH_Z standard deviations of its binomial
# spread; the CPU scales are computed STOCH_CPU_ROWS output rows at a time
STOCH_Z = 6.0
STOCH_CPU_ROWS = 16384
# serve.sched: 24 requests from the workload generator (seed 5), a burst
# of 8 batch-tier ones filling the 8 slots, then 2 arrivals a pump
SCHED_SEED = 5
SCHED_SLOTS = 8
SCHED_REQUESTS = 24
SCHED_MAX_NEW = 32
SCHED_ARRIVALS_PER_PUMP = 2
# serve.fleet: two tenants' 512-token system prompts plus 50-400 user
# tokens (seed 3), 16 streaming requests over HTTP from 16 client
# threads, max_new 32; replica-0 crashes FLEET_CRASH_AFTER engine steps
# into part (b)'s traffic
FLEET_SEED = 3
FLEET_SYSTEM = 512
FLEET_REQUESTS = 16
FLEET_MAX_NEW = 32
FLEET_CRASH_AFTER = 6
# the speculative phases: draft width K = 4 and max_len 2044, so the bank
# (max_len + K) is 2048 cells in pages of 16; 12 requests of 64 tokens
SPEC_K = 4
SPEC_MAX_LEN = 2048 - SPEC_K
SPEC_MAX_NEW = 64
SPEC_REQUESTS = 12
# the adapter phases: six LoRA adapters on wq/wk/wv/wo (numpy seed 7),
# ranks alternating 8 and 16 with alpha = 2 x rank, in a bank of 4 slots
# (+ the zero slot) at max_rank 16; B scaled so that ad0's wq delta on the
# first prompt is ADAPTER_DELTA_RMS of the base projection (RMS). Wave 1
# cycles ad0, ad1, None, ad2, ad3, None over serve's 12 prompts; wave 2
# serves 6 of them under ad4, ad5, None: two evictions
ADAPTER_IDS = tuple(f"ad{i}" for i in range(6))
ADAPTER_MAX_RANK = 16
ADAPTER_SLOTS = 4
ADAPTER_SEED = 7
ADAPTER_DELTA_RMS = 0.05
WAVE1_IDS = ("ad0", "ad1", None, "ad2", "ad3", None)
WAVE2_IDS = ("ad4", "ad5", None)
# serve.refresh: tree B is init_params from this seed (the same
# structure, shapes and dtypes as the served tree A, seed SEED)
REFRESH_SEED = 1
REFRESH_AFTER = 4   # prompts submitted after the commit
# the Llama-3-8B matmul weights as (K, O), with their names
DQMM_SHAPES = (
    ((4096, 4096), "wq, wo"), ((4096, 1024), "wk, wv"),
    ((4096, 14336), "w_gate, w_up"), ((14336, 4096), "w_down"),
    ((4096, 128256), "lm_head"),
)
# decode (8 slots), a verify (8 slots x K+1 = 5 positions), a ragged
# prefill, and the prompt buckets of the serving traffic (`_prompts`:
# 128 x1, 256 x1, 512 x3, 1024 x7)
DQMM_TOKENS = (8, 40, 77, 128, 256, 512, 1024)
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
# kernel.sharded / serve.tp2*: the head splits run as virtual shards
TP_DEGREES = (2, 4)
TP_FLASH_CASES = ((1, 512), (1, 2048))
TP_LAYERS = 4      # serve.tp2.resize and serve.tp2.int8
# serve.tp2.resize: shrink after step 2 (8 requests 16 tokens into their
# decode), grow after step 3 (their replays 8 tokens further on)
TP_RESIZE_AT = (2, 3)
TRAIN_LAYERS = 4
TRAIN_SEQ = 2048
TRAIN_GLOBAL_BATCH = 4
TRAIN_MICROBATCH = 2
TRAIN_STEPS = 8
TRAIN_SEED = SEED + 2         # params and tokens of both train phases
TRAIN_LR = 1e-4
TRAIN_WD = 1e-4
# train.lora / rl.ppo: adapters of rank 16 (alpha 32) on the attention
# projections; rl.ppo's traffic: RL_PROMPTS prompts of 32-192 tokens
# (numpy seed RL_SEED) in a 256-token buffer, minibatches of 4 over 2
# epochs, 2 PPO steps, +1 per generated RL_TARGET token
LORA_RANK = 16
LORA_ALPHA = 32.0
LORA_TARGETS = ("wq", "wk", "wv", "wo")
RL_PROMPTS = 8
RL_PROMPT_LENS = (32, 192)
RL_MAX_LEN = 256
RL_MINIBATCH = 4
RL_EPOCHS = 2
RL_KL = 0.1
RL_STEPS = 2
RL_TARGET = 3
RL_SEED = SEED + 4
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
# train.ckpt: memory saves every 2 of the 8 steps, then steps 9 and 10
# taken twice (on from step 8, and from the restored step 8), the
# restore target's params drawn from another seed
CKPT_SAVE_STEPS = 2
CKPT_MORE_STEPS = 2
CKPT_RESTORE_SEED = TRAIN_SEED + 1
FUSED_TOL_REASON = (
    "fused against unfused loss_fn on one microbatch: loss within 1e-3 "
    "relative, each gradient within 5e-2 of its norm (L2 of the "
    "difference): the unfused loss rounds the logits to bf16 before its "
    "f32 softmax where the fused one keeps them f32, both round dlogits "
    "to bf16 before the head's backward products, and the differences "
    "carry through the backward of 4 bf16 layers"
)
# the model families (`--families`): GPT-2 XL at full width and depth,
# served on FAM_REQUESTS greedy prompts of 50-900 tokens (numpy seed
# SEED + 1) at max_len 1024 through 8 slots, pages of 16, max_new 32, and
# trained 8 steps of 4 x 1025 tokens; the MoE Llama at Mixtral-8x7B's
# widths (written here: no preset in either package), served at 2 layers
# on prompts of 50-1000 tokens at max_len 2048 and trained at 1 layer;
# BERT-large MLM at B=8, S=512, 15% of the positions masked; the MNIST
# CNN on random images
FAM_REQUESTS = 12
FAM_SLOTS = 8
FAM_MAX_NEW = 32
FAM_SEED = SEED + 9
GPT_MAX_LEN = 1024
GPT_PROMPT_MAX = 900
MOE_MAX_LEN = 2048
MOE_PROMPT_MAX = 1000
# 2 serve layers, then train.remat at 2: the time cuts, taken in that
# order once a whole run from `git archive` passed 1100 s of its 1200
MOE_SERVE_LAYERS = 2
MOE_TRAIN_LAYERS = 1
MIXTRAL_8X7B = dict(vocab_size=32000, dim=4096, n_heads=32, n_kv_heads=8,
                    mlp_dim=14336, max_seq_len=32768, rope_theta=1e6,
                    n_experts=8, moe_top_k=2)
FAM_TRAIN_STEPS = 8
FAM_TRAIN_BATCH = 4
FAM_TRAIN_SEQ = 1024
BERT_BATCH = 8
BERT_SEQ = 512
BERT_MASK_FRAC = 0.15
BERT_MASK_ID = 103           # [MASK] in BERT's WordPiece vocabulary
CNN_BATCH = 128
CNN_LR = 1e-3
# GPT-2 XL's int8 products as (K, O): blocks 64 (K = 1600) and 256
GPT2_XL_DQMM = (((1600, 4800), "wqkv"), ((1600, 1600), "wo"),
                ((1600, 6400), "w_up"), ((6400, 1600), "w_down"))
TRAIN_TOL_REASON = (
    "loss within 1e-3 relative, each gradient within 5e-2 of its norm "
    "(L2 of the difference): bf16 compute on both sides, but the flash "
    "kernels round P and dS to bf16 where plain attention rounds P after "
    "the softmax and dP, and those differences carry through the "
    "backward of 4 layers (the embedding's gradient collects all of them)"
)


T_START = time.perf_counter()


def log(phase, **kw):
    """One result line; `at_s` is the script's wall time at the line (a
    phase's cost is the step from the line before it)."""
    kw["at_s"] = time.perf_counter() - T_START
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


def _paged_case(gen, quant, h=32, kv=8, hd=128, per_slot=128):
    from dlrover_tpu_torch.models import decode as dec

    b, ps = 8, 16
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


# kernel.jax_gate_shapes: shapes inside the JAX package's gates that the
# port's kernels take since the wider variants (flash head_dim 264-512,
# paged groups and head dims, the general dqmm, any quant block)
GATE_FLASH = ((1, 1024, 8, 2, 384), (1, 1024, 8, 2, 512))   # B S H KV D
# (H, KV, D, what has the shape): B=8 decode rows, pages of 16
GATE_PAGED = ((12, 4, 64, "GQA group 3"),
              (28, 4, 128, "GQA group 7 (Qwen2-7B)"),
              (32, 32, 40, "head_dim 40"),
              (32, 32, 96, "head_dim 96 (Phi-3-mini)"),
              (32, 32, 512, "head_dim 512"))
# (K, O, x dtype, T): the engine's block of K (`weight_quant_block`: 8 at
# 24 and 1000, 32 at 96 and 160), and f32 x at w_gate's shape
GATE_DQMM = tuple((k, 4096, torch.bfloat16, t)
                  for k in (24, 96, 160, 1000) for t in (8, 1024)) + (
    (4096, 14336, torch.float32, 8), (4096, 14336, torch.float32, 1024))
GATE_QUANT_BLOCK = 512       # int8_adam(block=512) on the embedding moment
GATE_QUANT_VALUES = 128256 * 4096


def _gate_flash(gen, b, s, h, kv, d):
    """Flash at head_dim `d` through `dot_product_attention(impl="auto")`
    and autograd: one forward and one dq and dk/dv launch, none on the
    wgmma variants, held to `_fwd_plain` / `_bwd_plain`."""
    from dlrover_tpu_torch.ops import _build
    from dlrover_tpu_torch.ops import attention as attn
    from dlrover_tpu_torch.ops import flash_attention as fa

    F = torch.nn.functional
    scale = d ** -0.5

    def rand(heads):
        return torch.randn((b, s, heads, d), generator=gen,
                           device="cuda").bfloat16()

    q, k, v, do = rand(h), rand(kv), rand(kv), rand(h)
    qa, ka, va = (x.detach().requires_grad_() for x in (q, k, v))
    before = _build.launch_counts()
    out = attn.dot_product_attention(qa, ka, va, causal=True, impl="auto")
    grads = torch.autograd.grad(out, (qa, ka, va), do)
    torch.cuda.synchronize()
    after = _build.launch_counts()
    launched = {n: _launched(before, after, n) for n in (
        "flash_fwd", "flash_fwd_wgmma", "flash_bwd_dq", "flash_bwd_dkv",
        "flash_bwd_dq_wgmma", "flash_bwd_dkv_wgmma")}
    if launched != {"flash_fwd": 1, "flash_fwd_wgmma": 0, "flash_bwd_dq": 1,
                    "flash_bwd_dkv": 1, "flash_bwd_dq_wgmma": 0,
                    "flash_bwd_dkv_wgmma": 0}:
        raise AssertionError(f"flash at D={d} under auto: {launched}")
    o, lse = fa._fwd(q, k, v, True, scale)
    o_ref, lse_ref = fa._fwd_plain(q, k, v, True, scale)
    want = fa._bwd_plain(q, k, v, o, lse, do, True, scale)
    err = (out.float() - o_ref.float()).abs().max().item()
    lse_err = (lse - lse_ref).abs().max().item()
    errs = {n: (x.float() - y.float()).abs().max().item()
            for n, x, y in zip(("dq", "dk", "dv"), grads, want)}
    tols = {n: BWD_REL_TOL * y.float().abs().max().item()
            for n, y in zip(("dq", "dk", "dv"), want)}
    if not (err <= FLASH_TOL and lse_err <= 1e-3
            and all(errs[n] <= tols[n] for n in errs)
            and all(torch.isfinite(x).all() for x in grads)):
        raise AssertionError(
            f"flash at D={d} disagrees: o {err} (tol {FLASH_TOL}), lse "
            f"{lse_err}, grads {errs} (tols {tols})")
    delta = fa._delta(o, do)
    fwd_flops = 2.0 * b * h * d * s * (s + 1)
    qo_bytes, kv_bytes, row_bytes = (2 * b * s * h * d, 2 * b * s * kv * d,
                                     4 * b * h * s)
    lib_g = do.transpose(1, 2)

    def leaves():
        return [x.transpose(1, 2).detach().requires_grad_()
                for x in (q, k, v)]

    def sdpa(qkv=None):
        return F.scaled_dot_product_attention(
            *(qkv or leaves()), is_causal=True, enable_gqa=True)

    def sdpa_fwd_bwd():
        qkv = leaves()
        return torch.autograd.grad(sdpa(qkv), qkv, lib_g)

    # library_ms of the backward rows: SDPA's whole backward, its forward
    # and backward less its forward, as phase_flash_bwd times it
    lib_fwd = device_ms(sdpa)
    lib_bwd = device_ms(sdpa_fwd_bwd) - lib_fwd
    rows = []
    for name, ms, plain, lib, flops, nbytes, e in (
            ("flash_fwd", device_ms(lambda: fa._fwd(q, k, v, True, scale)),
             time_ms(lambda: fa._fwd_plain(q, k, v, True, scale), 3),
             lib_fwd, fwd_flops, 2 * qo_bytes + 2 * kv_bytes + row_bytes,
             err),
            ("flash_bwd_dq", device_ms(lambda: fa._bwd_dq_cuda(
                q, k, v, do, lse, delta, True, scale, "mma")),
             time_ms(lambda: fa._bwd_plain(q, k, v, o, lse, do, True,
                                           scale), 3),
             lib_bwd, 1.5 * fwd_flops, 3 * qo_bytes + 2 * kv_bytes
             + 2 * row_bytes, errs["dq"]),
            ("flash_bwd_dkv", device_ms(lambda: fa._bwd_dkv_cuda(
                q, k, v, do, lse, delta, True, scale, "mma")),
             None, lib_bwd, 2.0 * fwd_flops, 2 * qo_bytes + 4 * kv_bytes
             + 2 * row_bytes, max(errs["dk"], errs["dv"]))):
        bms, by = bound_ms(flops, nbytes)
        rows.append(dict(
            kernel=name, shape=f"B={b} S={s} H={h} KV={kv} D={d} bf16 "
            "causal", variant="mma", launches=1, max_abs_err=e, ms=ms,
            plain_ms=plain, library_ms=lib, bound_ms=bms, bound_by=by))
    rows[1]["plain_ms_note"] = "the whole plain backward"
    for r in rows[1:]:
        r["library_ms_note"] = ("the whole backward of "
                                "scaled_dot_product_attention")
    return rows


def _gate_paged(gen, h, kv, d, quant):
    """Paged decode at B=8 rows of 50-2048 cells, pages of 16, through
    `paged_attention(impl="auto")`: one launch of the split kernel, held
    to the reference (PAGED_TOL)."""
    from dlrover_tpu_torch.models import decode as dec
    from dlrover_tpu_torch.ops import _build
    from dlrover_tpu_torch.ops import paged_attention as pa

    b, ps, per_slot = 8, 16, 128
    n_pages = b * per_slot + 1
    rng = np.random.default_rng(SEED + d)
    lengths = rng.integers(50, per_slot * ps + 1, size=b).astype(np.int32)
    perm = rng.permutation(np.arange(1, n_pages)).astype(np.int32)
    table = np.zeros((b, per_slot), np.int32)
    for row in range(b):
        n_live = -(-int(lengths[row]) // ps)
        table[row, :n_live] = perm[row * per_slot: row * per_slot + n_live]
    pages = {}
    for name in ("k", "v"):
        x = torch.randn((n_pages, ps, kv, d), generator=gen, device="cuda")
        if quant:
            pages[name], sc = dec._kv_quantize(x)
            pages[name + "_scale"] = sc.bfloat16()
        else:
            pages[name] = x.bfloat16()
        del x
    q = torch.randn((b, h, d), generator=gen, device="cuda").bfloat16()
    tab = torch.from_numpy(table).cuda()
    lens = torch.from_numpy(lengths).cuda()
    before = _build.launch_counts()
    got = pa.paged_attention(q, pages, tab, lens, impl="auto")
    torch.cuda.synchronize()
    after = _build.launch_counts()
    if (_launched(before, after, "paged_attention") != 1
            or _launched(before, after, "paged_attention_tma") != 0):
        raise AssertionError(f"paged H={h} KV={kv} D={d}: {before} -> "
                             f"{after}, want one split-kernel launch")
    ref = pa.paged_attention(q, pages, tab, lens, impl="reference")
    err = (got.float() - ref.float()).abs().max().item()
    if not (torch.isfinite(got).all() and err <= PAGED_TOL):
        raise AssertionError(f"paged H={h} KV={kv} D={d} quant={quant}: "
                             f"max_abs_err {err} (tol {PAGED_TOL})")
    cells = int(lengths.sum())
    elem = 1 if quant else 2
    nbytes = (2 * cells * kv * d * elem + (4 * cells * kv if quant else 0)
              + 2 * 2 * b * h * d + 4 * b * per_slot + 4 * b)
    bms, by = bound_ms(4.0 * cells * h * d, nbytes)
    scale = d ** -0.5
    return dict(
        kernel="paged_attention", variant="split", launches=1,
        shape=f"B=8 H={h} KV={kv} D={d} page 16, {cells} cells, "
        f"{'int8' if quant else 'bf16'} pool", max_abs_err=err,
        ms=device_ms(lambda: pa._kernel(q, pages, tab, lens, scale)),
        plain_ms=time_ms(lambda: pa._reference(q, pages, tab, lens, scale),
                         3),
        library_ms=None, bound_ms=bms, bound_by=by)


def _gate_dqmm(gen, k, o, dtype, t):
    """The int8 matmul at a weight or activation dtype only the general
    variant takes, through `quantized_matmul`: one launch counted under
    "dqmm_general", held to the plain version (DQMM_REL_TOL of the
    largest |output| for bf16 x, 1e-5 for f32 x: f32 FMA on both
    sides, sums in another order). dense_ms: the dense product in x's
    dtype on the dequantized weight (the table's yardstick)."""
    from dlrover_tpu_torch.ops import _build
    from dlrover_tpu_torch.ops import quantization as tq

    block = tq.weight_quant_block(k)
    w = torch.randn((o, k), generator=gen, device="cuda") * k ** -0.5
    qw = tq.QuantizedWeight(*tq.quantize_int8(w, block), block)
    del w
    x = torch.randn((t, k), generator=gen, device="cuda").to(dtype)
    before = _build.launch_counts()
    y = tq.quantized_matmul(x, qw)
    torch.cuda.synchronize()
    after = _build.launch_counts()
    if (_launched(before, after, "dqmm") != 1
            or _launched(before, after, "dqmm_general") != 1):
        raise AssertionError(f"dqmm K={k} O={o} T={t} {dtype}: {before} "
                             f"-> {after}, want one general launch")
    ref = tq.quantized_matmul_reference(x, qw)
    err = (y.float() - ref.float()).abs().max().item()
    rel = DQMM_REL_TOL if dtype == torch.bfloat16 else 1e-5
    tol = rel * ref.float().abs().max().item()
    if not (torch.isfinite(y).all() and err <= tol):
        raise AssertionError(f"dqmm K={k} O={o} T={t} {dtype}: max_abs_err "
                             f"{err} (tol {tol})")
    elem = x.element_size()
    nbytes = o * k + 4 * o * (k // block) + elem * (t * k + t * o)
    peak = PEAK_F32_FLOPS if dtype == torch.float32 else PEAK_BF16_FLOPS
    bms, by = bound_ms(2.0 * t * k * o, nbytes, peak)
    dense = tq._dq_weight(qw.q8, qw.s8, block, dtype)
    return dict(
        kernel="dqmm", variant="general", launches=1,
        shape=f"T={t} K={k} O={o} block {block} "
        f"{str(dtype).replace('torch.', '')} x", max_abs_err=err, tol=tol,
        ms=device_ms(lambda: tq.quantized_matmul(x, qw)),
        plain_ms=time_ms(lambda: tq.quantized_matmul_reference(x, qw), 3),
        library_ms=None, dense_ms=device_ms(lambda: x @ dense.t()),
        bound_ms=bms, bound_by=by)


def _gate_quant(gen):
    """Quantize and dequantize at block 512 on the int8 AdamW's embedding
    moment ([1, 128256 x 4096] f32): bytes and bits equal to the plain
    versions, one launch each (the quantizer's warp-a-row kernel,
    "quant_int8_any"; the dequantizer's 4-values-a-thread kernel, which
    takes every power of two from 8)."""
    from dlrover_tpu_torch.ops import _build
    from dlrover_tpu_torch.ops import quantization as tq

    block, n = GATE_QUANT_BLOCK, GATE_QUANT_VALUES
    x = torch.randn((1, n), generator=gen, device="cuda") * 1e-3
    before = _build.launch_counts()
    q, sc = tq.quantize_int8(x, block)
    y = tq.dequantize_int8(q, sc)
    torch.cuda.synchronize()
    after = _build.launch_counts()
    want = {"quant_int8": 1, "quant_int8_any": 1, "dequant_int8": 1,
            "dequant_int8_any": 0}
    got = {name: _launched(before, after, name) for name in want}
    if got != want:
        raise AssertionError(f"quant at block {block}: launches {got}")
    q_ref, s_ref = tq._quantize_plain(x, block)
    diffs = (int((q != q_ref).sum()), int((sc != s_ref).sum()))
    del q_ref, s_ref
    y_ref = tq._dequantize_plain(q, sc)
    y_diff = int((y.view(torch.int32) != y_ref.view(torch.int32)).sum())
    del y_ref
    if diffs != (0, 0) or y_diff:
        raise AssertionError(f"quant at block {block}: q8/s8 differ in "
                             f"{diffs}, dequantized bits in {y_diff}")
    rows = []
    for name, fn, plain, nbytes in (
            ("quantize_int8", lambda: tq.quantize_int8(x, block),
             lambda: tq._quantize_plain(x, block), 4 * n + n + 4 * n // block),
            ("dequantize_int8", lambda: tq.dequantize_int8(q, sc),
             lambda: tq._dequantize_plain(q, sc), n + 4 * n // block + 4 * n)):
        bms, by = bound_ms(3.0 * n, nbytes, PEAK_F32_FLOPS)
        rows.append(dict(
            kernel=name, launches=1, max_abs_err=0.0,
            variant="warp a row" if name == "quantize_int8" else "4 a thread",
            shape=f"[1, {n}] f32, block {block}", ms=device_ms(fn),
            plain_ms=time_ms(plain, 3), library_ms=None, bound_ms=bms,
            bound_by=by))
    del x, q, sc, y
    torch.cuda.empty_cache()
    return rows


def phase_jax_gate_shapes(gen):
    """kernel.jax_gate_shapes: every shape the wider kernel variants
    cover, under the dispatch a user calls (impl="auto"), launched once
    (the count and the variant named), held to its plain version and
    timed beside it, the library call where one computes the same
    function (SDPA for flash) and the bound."""
    rows = []
    for b, s, h, kv, d in GATE_FLASH:
        rows += _gate_flash(gen, b, s, h, kv, d)
        torch.cuda.empty_cache()
    for h, kv, d, what in GATE_PAGED:
        for quant in (False, True):
            row = _gate_paged(gen, h, kv, d, quant)
            row["what"] = what
            rows.append(row)
            torch.cuda.empty_cache()
    for k, o, dtype, t in GATE_DQMM:
        rows.append(_gate_dqmm(gen, k, o, dtype, t))
        torch.cuda.empty_cache()
    rows += _gate_quant(gen)
    for row in rows:
        log("kernel.jax_gate_shapes", **row)
    return rows


def _prompts(cfg, n=12):
    rng = np.random.default_rng(SEED + 1)
    lengths = rng.integers(50, 1001, size=n)
    lengths[0] = 1000
    return [rng.integers(1, cfg.vocab_size, size=int(m)).tolist()
            for m in lengths]


def _serve(engine, prompts, max_new, adapter_ids=None):
    """Submit everything (each request under its adapter id, where
    given), step to completion; per-request timings."""
    t0 = time.perf_counter()
    adapter_ids = adapter_ids or [None] * len(prompts)
    ids = [engine.submit(p, max_new=max_new, adapter_id=a)
           for p, a in zip(prompts, adapter_ids)]
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
        step_stats=engine.step_stats(), **_timings(tm, lens),
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


def _first_decode_logits(cfg, params, p, max_len, adapters=None):
    """Logits of the first decode step after prefilling prompt `p`
    (padded to its 1024 bucket) into a fresh exact row installed into
    a page pool: the engine's paged admission and decode, one slot
    (`adapters`: a one-row LoRA operand for both)."""
    from dlrover_tpu_torch.models import decode as dec

    bucket = 1024
    prompt = torch.zeros(bucket, dtype=torch.long, device="cuda")
    prompt[: len(p)] = torch.tensor(p, device="cuda")
    per_slot = max_len // 16
    table = torch.arange(1, per_slot + 1, dtype=torch.int32,
                         device="cuda")[None]
    pool = dec.init_page_pool(cfg, per_slot + 1, 16)
    row = dec.prefill_exact_row(cfg, params, prompt, max_len,
                                adapters=adapters)
    dec.paged_install_row(pool, row, table[0], 0, bucket)
    del row
    logits, _ = dec.paged_decode_step(
        cfg, params, torch.tensor([p[-1]], device="cuda"), pool, table,
        torch.tensor([len(p) - 1], device="cuda"), adapters=adapters,
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
    e2e["outs"] = outs
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


def _check_stochastic_install(params, qparams):
    """The last layer slice of every quantized leaf and the untied
    lm_head, as the int8_stochastic install stored them: the scales
    byte-equal to the port's CPU `stochastic_round_int8` on the same
    bf16 slice (the scales take no random bits; the lm_head in row
    blocks, each row's blocks whole), every q8 the floor or the ceiling
    of w / scale (clipped to +-127), and the mean of dequant - w, in
    units of the scale and absolute, within STOCH_Z standard deviations
    of 0: each value rounds up with probability f, its fractional part,
    so dequant - w = scale (up - f) has variance scale^2 f (1 - f), and
    the mean over the slice's M values sqrt(sum of those) / M."""
    from dlrover_tpu_torch.ops import quantization as tq

    leaves = [(name, params["layers"][name][-1], w[-1])
              for name, w in sorted(qparams["layers"].items())
              if isinstance(w, tq.QuantizedWeight)]
    head = qparams.get("lm_head", {}).get("weight")
    if isinstance(head, tq.QuantizedWeight):
        leaves.append(("lm_head", params["lm_head"]["weight"], head))
    rows = {}
    for name, dense, qw in leaves:
        wt = dense.t().contiguous()
        s_diff = 0
        for r0 in range(0, wt.shape[0], STOCH_CPU_ROWS):
            _, s_cpu = tq.stochastic_round_int8(
                wt[r0:r0 + STOCH_CPU_ROWS].cpu(), qw.block,
                torch.Generator().manual_seed(0))
            s_diff += int((qw.s8[r0:r0 + STOCH_CPU_ROWS].cpu()
                           != s_cpu).sum())
        srep = qw.s8.repeat_interleave(qw.block, dim=1)
        xs = wt.float() / srep
        lo = torch.floor(xs)
        q = qw.q8.float()
        off = int(((q != lo.clamp(-127, 127))
                   & (q != (lo + 1).clamp(-127, 127))).sum())
        f = xs - lo
        var = f * (1 - f)
        m = q.numel()
        dev = float((q - xs).double().mean())
        sd = float(var.double().sum().sqrt()) / m
        err = float((q * srep - wt.float()).double().mean())
        sd_abs = float((var * srep * srep).double().sum().sqrt()) / m
        rows[name] = dict(shape=list(qw.q8.shape), s8_diff=s_diff,
                          not_floor_or_ceil=off, mean_up_minus_f=dev,
                          bound=STOCH_Z * sd, mean_dequant_err=err,
                          bound_abs=STOCH_Z * sd_abs)
        del wt, srep, xs, lo, q, f, var
        if s_diff or off or abs(dev) > STOCH_Z * sd or abs(err) > (
                STOCH_Z * sd_abs):
            raise AssertionError(
                f"serve.int8_stochastic: installed {name} fails its "
                f"checks: {rows[name]}")
    log("serve.int8_stochastic.install", z=STOCH_Z, leaves=rows)


def phase_serve_int8_stochastic(params, cfg, int8):
    """serve.int8's traffic and weights through
    weight_quant="int8_stochastic": the install rounds on the card in
    plain PyTorch (no kernel; JAX's is XLA), serving runs the same
    dequant-matmul kernels as serve.int8, launch for launch, with the
    counts set to 0 just before the install and read after the drain."""
    from dlrover_tpu_torch.ops import _build
    from dlrover_tpu_torch.serving.engine import ContinuousBatcher

    max_new, n_slots, max_len = 32, 8, 2048
    prompts = _prompts(cfg)
    kw = dict(n_slots=n_slots, max_len=max_len, max_new_tokens=max_new,
              chunk=8, kv_layout="paged", weight_quant="int8_stochastic")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    engine = ContinuousBatcher(cfg, params, **kw)
    torch.cuda.synchronize()
    install_s = time.perf_counter() - t0
    outs, tm = _serve(engine, prompts, max_new)
    torch.cuda.synchronize()
    launches = _build.launch_counts()
    lens = [len(o) for o in outs]
    if lens != [max_new] * len(prompts):
        raise AssertionError(
            f"int8_stochastic token counts {lens}, want {max_new} each")
    toks = np.concatenate(outs)
    if toks.min() < 0 or toks.max() >= cfg.vocab_size:
        raise AssertionError("int8_stochastic: token id out of the vocabulary")
    if engine.weight_quant_path != "int8_stochastic:kernel":
        raise AssertionError(f"weight_quant_path {engine.weight_quant_path}")
    by_variant = dict(
        ws=launches["dqmm_ws"], decode_tma=launches["dqmm_decode_tma"],
        decode_mma=(launches["dqmm"] - launches["dqmm_ws"]
                    - launches["dqmm_decode_tma"]),
    )
    if (by_variant != int8["dqmm_launches_by_variant"]
            or launches["quant_int8"] != 0):
        raise AssertionError(
            f"int8_stochastic: dqmm launches by variant {by_variant}, "
            f"serve.int8's {int8['dqmm_launches_by_variant']}; quantize "
            f"launches {launches['quant_int8']}, want 0")
    _check_wgmma("serve.int8_stochastic", launches)
    _check_paged_tma("serve.int8_stochastic", launches)
    same = sum(int(np.array_equal(a, b)) for a, b in zip(outs, int8["outs"]))
    e2e = dict(
        requests=len(prompts), admissions=engine.admissions,
        decode_steps=engine.decode_steps, launches=launches,
        dqmm_launches_by_variant=by_variant, install_s=install_s,
        int8_install_s=int8["install_s"],
        weight_quant_path=engine.weight_quant_path,
        weight_quant_stats=engine.weight_quant_stats(),
        **_timings(tm, lens),
        int8_greedy_streams_identical=same,
        int8_greedy_token_agreement=float(
            np.mean(np.concatenate(outs) == np.concatenate(int8["outs"]))),
    )
    log("serve.int8_stochastic", **e2e)
    qparams = engine.params
    del engine
    torch.cuda.empty_cache()
    _check_stochastic_install(params, qparams)
    del qparams
    torch.cuda.empty_cache()
    return e2e


def _sched_traffic(cfg):
    """serve.sched's requests from the workload generator (seed
    SCHED_SEED, single-turn sessions, all three tiers): the first
    n_slots batch-tier events as one burst, then the next
    SCHED_REQUESTS - n_slots events of any tier, in arrival order."""
    from dlrover_tpu_torch.serving import workload

    trace = workload.generate_trace(workload.WorkloadConfig(
        seed=SCHED_SEED, horizon_s=600.0, base_rate=0.5, turns_lo=1,
        turns_hi=1, user_tokens_lo=32, user_tokens_hi=512,
        max_new_lo=SCHED_MAX_NEW, max_new_hi=SCHED_MAX_NEW,
        long_context_prob=0.1, long_context_tokens=1024,
        system_prompt_tokens=256, vocab=cfg.vocab_size - 1,
        max_prompt_tokens=1536, latency_frac=0.3, batch_frac=0.4,
        latency_deadline_s=600.0, standard_deadline_s=600.0,
        batch_deadline_s=600.0))
    book = workload.SessionBook(trace)
    burst = [e for e in trace.events if e.tier == "batch"][:SCHED_SLOTS]
    rest = [e for e in trace.events if e not in burst]
    rest = rest[:SCHED_REQUESTS - len(burst)]
    return [(e, book.prompt_for(e).tolist()) for e in burst + rest]


def phase_serve_sched(params, cfg):
    """serve.sched: RequestScheduler over the paged bf16 engine built
    with mesh_spec={"tp": 1}; a burst of batch-tier requests fills
    every slot, then the rest of the trace arrives a few requests a
    pump, so latency-tier arrivals preempt batch work. The launch
    counts are set to 0 just before the engine is built and read after
    the drain."""
    from dlrover_tpu_torch.ops import _build
    from dlrover_tpu_torch.serving import (
        TIERS,
        ContinuousBatcher,
        RequestScheduler,
        RequestState,
        ServingMetrics,
        SloConfig,
    )

    traffic = _sched_traffic(cfg)
    kw = dict(n_slots=SCHED_SLOTS, max_len=2048,
              max_new_tokens=SCHED_MAX_NEW, chunk=8, kv_layout="paged",
              mesh_spec={"tp": 1})
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    engine = ContinuousBatcher(cfg, params, **kw)
    if engine.kernel_path != "kernel" or engine.mesh_shape != {"tp": 1}:
        raise AssertionError(
            f"serve.sched: kernel_path {engine.kernel_path}, mesh_shape "
            f"{engine.mesh_shape}")
    metrics = ServingMetrics()
    sched = RequestScheduler(
        engine, SloConfig(max_queue_depth=64, max_new_tokens=SCHED_MAX_NEW,
                          default_deadline_s=600.0, tier_aging_s=600.0),
        metrics=metrics)
    t0 = time.perf_counter()
    reqs = []
    burst = [(e, p) for e, p in traffic if e.tier == "batch"][:SCHED_SLOTS]
    for e, p in burst:
        reqs.append(sched.submit(p, max_new=e.max_new,
                                 deadline_s=e.deadline_s, tier=e.tier))
    sched.pump()
    for i in range(len(burst), len(traffic), SCHED_ARRIVALS_PER_PUMP):
        for e, p in traffic[i:i + SCHED_ARRIVALS_PER_PUMP]:
            reqs.append(sched.submit(p, max_new=e.max_new,
                                     deadline_s=e.deadline_s, tier=e.tier))
        sched.pump()
    sched.run_to_completion()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _build.launch_counts()
    states = [r.state for r in reqs]
    preempted = dict(metrics.tier_preempted_total)
    if any(st is not RequestState.DONE for st in states):
        raise AssertionError(f"serve.sched: states {[s.value for s in states]}")
    if sum(preempted.values()) < 1:
        raise AssertionError("serve.sched: no tier preemption")
    lens = [len(r.tokens) for r in reqs]
    if lens != [e.max_new for e, _ in traffic]:
        raise AssertionError(f"serve.sched: token counts {lens}")
    want_paged = engine.decode_steps * cfg.n_layers
    if (launches["flash_fwd"] < engine.admissions * cfg.n_layers
            or launches["paged_attention"] < want_paged):
        raise AssertionError(f"serve.sched: kernels not on the path {launches}")
    _check_wgmma("serve.sched", launches)
    _check_paged_tma("serve.sched", launches)
    tiers = {}
    for t in TIERS:
        n = sum(1 for e, _ in traffic if e.tier == t)
        ttft = metrics.tier_ttft_quantiles(t)
        tpot = metrics._tier_tpot[t].quantiles()
        tiers[t] = dict(requests=n, ttft_ms_p50=ttft[0.5],
                        ttft_ms_p95=ttft[0.95], tpot_ms_p50=tpot[0.5],
                        tpot_ms_p95=tpot[0.95],
                        preempted=preempted.get(t, 0))
    got = [np.asarray(r.tokens) for r in reqs]
    admissions, decode_steps = engine.admissions, engine.decode_steps
    # the same engine, idle again, on the same prompts without the
    # scheduler: greedy agreement (reported; replays and other batches
    # round other ways in bf16)
    ref = engine.generate_all([p for _, p in traffic])
    same = sum(int(np.array_equal(a, b)) for a, b in zip(got, ref))
    e2e = dict(
        requests=len(reqs), burst=len(burst),
        prompt_lens=[len(p) for _, p in traffic],
        tiers_in_order=[e.tier for e, _ in traffic], wall_s=wall,
        admissions=admissions, decode_steps=decode_steps,
        launches=launches, kernel_path=engine.kernel_path,
        mesh_shape=engine.mesh_shape, n_chips=engine.n_chips,
        preempted=preempted, per_tier=tiers,
        tokens_per_s=float(sum(lens)) / wall,
        greedy_streams_identical=same,
        greedy_token_agreement=float(
            np.mean(np.concatenate(got) == np.concatenate(ref))),
    )
    log("serve.sched", **e2e)
    del engine, sched
    torch.cuda.empty_cache()
    return e2e


def _fleet_traffic(cfg):
    """serve.fleet's prompts: one warm-up per tenant, then 16 requests
    alternating tenants, each the tenant's system prompt plus 50-400
    user tokens."""
    rng = np.random.default_rng(FLEET_SEED)
    systems = [rng.integers(1, cfg.vocab_size, size=FLEET_SYSTEM).tolist()
               for _ in range(2)]

    def user():
        n = int(rng.integers(50, 401))
        return rng.integers(1, cfg.vocab_size, size=n).tolist()

    warm = [system + user() for system in systems]
    traffic = [systems[i % 2] + user() for i in range(FLEET_REQUESTS)]
    return warm, traffic


def _count_engine_launches(engine):
    """Wrap `engine.step` so the kernel launches of its own steps (the
    calling thread's counts around each step) add up in the returned
    Counter, whichever thread steps it."""
    from collections import Counter

    from dlrover_tpu_torch.ops import _build

    counts, step = Counter(), engine.step

    def counted():
        before = _build.thread_launch_counts()
        try:
            return step()
        finally:
            for k, v in _build.thread_launch_counts().items():
                counts[k] += v - before[k]

    engine.step = counted
    return counts


def _http_stream(port, prompt, max_new):
    """One streaming POST /v1/generate; the client's clock: TTFT to the
    first token line, TPOT over the rest."""
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
    t0 = time.perf_counter()
    try:
        conn.request("POST", "/v1/generate", json.dumps(
            {"tokens": prompt, "max_new": max_new, "deadline_s": 600.0}))
        resp = conn.getresponse()
        if resp.status != 200:
            raise AssertionError(f"serve.fleet: HTTP {resp.status} "
                                 f"{resp.read()[:200]!r}")
        tokens, first, last, trailer = [], None, None, None
        for line in iter(resp.readline, b""):
            d = json.loads(line)
            if "error" in d:
                raise AssertionError(f"serve.fleet: stream error {d}")
            if d.get("tokens"):
                now = time.perf_counter()
                first = now if first is None else first
                last = now
                tokens.extend(d["tokens"])
            if d.get("done"):
                trailer = d
    finally:
        conn.close()
    return dict(tokens=tokens, trailer=trailer, ttft_s=first - t0,
                tpot_s=(last - first) / max(1, len(tokens) - 1))


def _fleet_run(cfg, params, part, warm, traffic, roles, fi=None,
               crash_after=None):
    """One part of serve.fleet: two engines, their schedulers and
    replicas in a ReplicaPool behind a ServingGateway; warm-ups (when
    given) each submitted to its own replica's scheduler and drained,
    one health round, then `traffic` as concurrent streaming requests.
    Everything started here is stopped before it returns."""
    from concurrent.futures import ThreadPoolExecutor

    from dlrover_tpu_torch.master.kv_store import KVStoreService
    from dlrover_tpu_torch.serving import (
        ContinuousBatcher,
        InferenceReplica,
        ReplicaPool,
        RequestScheduler,
        ServingGateway,
        ServingMetrics,
        SloConfig,
    )

    kw = dict(n_slots=8, max_len=2048, max_new_tokens=FLEET_MAX_NEW, chunk=8,
              kv_layout="paged", page_size=16, prefix_cache_rows=4,
              prefix_block=FLEET_SYSTEM)
    metrics, kv = ServingMetrics(), KVStoreService()
    pool = ReplicaPool(kv=kv, metrics=metrics)
    reps, counts = [], []
    for i, role in enumerate(roles):
        tag = f"replica-{i}"
        eng = ContinuousBatcher(cfg, params, replica_role=role, chaos=fi,
                                chaos_tag=tag, **kw)
        if eng.kernel_path != "kernel":
            raise AssertionError(f"{part}: kernel_path {eng.kernel_path}")
        counts.append(_count_engine_launches(eng))
        sched = RequestScheduler(
            eng, SloConfig(max_queue_depth=64, max_new_tokens=FLEET_MAX_NEW,
                           default_deadline_s=600.0),
            metrics=metrics, handoff_transport="device")
        rep = InferenceReplica(tag, sched, chaos=fi, preflight_check=True)
        pool.add(rep)
        reps.append(rep)
    gw = ServingGateway(pool, metrics=metrics)
    try:
        for rep in reps:
            rep.start()
        gw.start()
        for rep, prompt in zip(reps, warm):
            req = rep.scheduler.submit(prompt, max_new=FLEET_MAX_NEW)
            if not req.wait(timeout=600) or req.state.value != "done":
                raise AssertionError(f"{part}: warm-up {req.state.value}")
        pool.check_replicas()
        warm_admissions = [r.scheduler.engine.admissions for r in reps]
        if crash_after is not None:
            eng0 = reps[0].scheduler.engine
            fi.crash_replica("replica-0", at_step=eng0._step_no + crash_after)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with ThreadPoolExecutor(max_workers=len(traffic)) as ex:
            streams = list(ex.map(
                lambda p: _http_stream(gw.port, p, FLEET_MAX_NEW), traffic))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        pool.check_replicas()
        registered = json.loads(kv.get(reps[-1].kv_key))
    finally:
        gw.stop()
        pool.stop()
    engines = [r.scheduler.engine for r in reps]
    ttft = [s["ttft_s"] * 1e3 for s in streams]
    tpot = [s["tpot_s"] * 1e3 for s in streams]
    n_tokens = sum(len(s["tokens"]) for s in streams)
    out = dict(
        roles=list(roles), requests=len(traffic),
        prompt_lens=[len(p) for p in traffic], max_new=FLEET_MAX_NEW,
        states=[s["trailer"]["state"] if s["trailer"] else None
                for s in streams],
        n_tokens=[len(s["tokens"]) for s in streams],
        admissions=[e.admissions for e in engines],
        routed_admissions=[e.admissions - w
                           for e, w in zip(engines, warm_admissions)],
        decode_steps=[e.decode_steps for e in engines],
        prefix=[e.prefix_cache.stats() for e in engines],
        launches=[dict(c) for c in counts], wall_s=wall,
        ttft_ms_p50=float(np.percentile(ttft, 50)),
        ttft_ms_p95=float(np.percentile(ttft, 95)),
        tpot_ms_p50=float(np.percentile(tpot, 50)),
        tokens_per_s=n_tokens / wall, routing=pool.routing_stats(),
        affinity_matched=metrics.affinity_matched,
        affinity_capped=metrics.affinity_capped,
        failovers=metrics.failovers_total,
        handoffs=dict(metrics.handoff_total),
        breakers={r.id: pool.breakers[r.id].state for r in reps},
        healthy=[r.healthy for r in reps],
        preflight_ok=[r.preflight_ok for r in reps],
        heartbeat_keys=sorted(registered))
    return out, [s["tokens"] for s in streams]


def _fleet_engine_checks(cfg, run, i, want_flash=True, want_paged=True):
    """Engine i's own launches: flash = prefix misses x layers, all
    wgmma; paged = decode steps x layers, all TMA (or none of either
    where the role runs none)."""
    c, layers = run["launches"][i], cfg.n_layers
    flash = run["prefix"][i]["misses"] * layers if want_flash else 0
    paged = run["decode_steps"][i] * layers if want_paged else 0
    return {
        f"engine {i}: flash_fwd == {flash}": c.get("flash_fwd", 0) == flash,
        f"engine {i}: flash all wgmma": (
            c.get("flash_fwd_wgmma", 0) == c.get("flash_fwd", 0)),
        f"engine {i}: paged == {paged}": c.get("paged_attention", 0) == paged,
        f"engine {i}: paged all TMA": (
            c.get("paged_attention_tma", 0) == c.get("paged_attention", 0)),
    }


def _fleet_summary(run):
    return {k: run[k] for k in (
        "wall_s", "ttft_ms_p50", "ttft_ms_p95", "tpot_ms_p50",
        "tokens_per_s", "admissions", "decode_steps", "affinity_matched")}


def phase_serve_fleet(params, cfg, probes=False):
    """serve.fleet (phase 19b): parts (a) colocated, (b) failover and (c)
    phase split of the fleet behind its HTTP gateway. The launch counts
    are set to 0 just before part (a) and read just after part (c); the
    greedy reference run comes after that read. With `probes` (the
    --fleet flag), part (a)'s traffic then runs twice more, reported
    only: through a pool of one replica, and through two replicas with
    the interpreter's thread switch interval at 0.5 ms instead of 5 ms
    (two pump threads share one interpreter lock)."""
    from collections import Counter

    from dlrover_tpu_torch.ops import _build
    from dlrover_tpu_torch.serving import ContinuousBatcher
    from dlrover_tpu_torch.serving.chaos import FaultInjector
    from dlrover_tpu_torch.serving.failover import OPEN

    warm, traffic = _fleet_traffic(cfg)
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    runs, checks = {}, {}
    a, outs = _fleet_run(cfg, params, "serve.fleet.colocated", warm,
                         traffic, ("colocated", "colocated"))
    runs["colocated"] = a
    checks.update({
        "(a) every stream done": a["states"] == ["done"] * FLEET_REQUESTS,
        "(a) 32 tokens each": a["n_tokens"] == [FLEET_MAX_NEW] * FLEET_REQUESTS,
        "(a) both replicas admitted routed work": min(
            a["routed_admissions"]) > 0,
        "(a) affinity matched": a["affinity_matched"] > 0,
        "(a) preflight passed": a["preflight_ok"] == [True, True],
    })
    for i in range(2):
        checks.update({f"(a) {k}": v for k, v in
                       _fleet_engine_checks(cfg, a, i).items()})
    fi = FaultInjector(seed=SEED)
    b, _ = _fleet_run(cfg, params, "serve.fleet.failover", warm, traffic,
                      ("colocated", "colocated"), fi=fi,
                      crash_after=FLEET_CRASH_AFTER)
    runs["failover"] = b
    checks.update({
        "(b) the crash fired": bool(fi.fired),
        "(b) every stream done": b["states"] == ["done"] * FLEET_REQUESTS,
        "(b) 32 tokens each": b["n_tokens"] == [FLEET_MAX_NEW] * FLEET_REQUESTS,
        "(b) failovers >= 1": b["failovers"] >= 1,
        "(b) replica-0's breaker open": b["breakers"]["replica-0"] == OPEN,
    })
    c, _ = _fleet_run(cfg, params, "serve.fleet.phase_split", [], traffic,
                      ("prefill", "decode"))
    runs["phase_split"] = c
    checks.update({
        "(c) every stream done": c["states"] == ["done"] * FLEET_REQUESTS,
        "(c) 32 tokens each": c["n_tokens"] == [FLEET_MAX_NEW] * FLEET_REQUESTS,
        "(c) every request handed off": (
            c["handoffs"].get("device") == FLEET_REQUESTS),
        "(c) decode admissions are the adoptions": (
            c["admissions"][1] == FLEET_REQUESTS),
    })
    checks.update({f"(c) {k}": v for k, v in
                   _fleet_engine_checks(cfg, c, 0, want_paged=False).items()})
    checks.update({f"(c) {k}": v for k, v in
                   _fleet_engine_checks(cfg, c, 1, want_flash=False).items()})
    torch.cuda.synchronize()
    launches = _build.launch_counts()
    per_engine = Counter()
    for run in runs.values():
        for cnt in run["launches"]:
            per_engine.update(cnt)
    checks["per-engine launches sum to the phase's"] = all(
        per_engine.get(k, 0) == v for k, v in launches.items())
    # the same prompts on one fresh engine (greedy agreement, reported:
    # batch composition and warm admissions change the bf16 GEMMs)
    ref = ContinuousBatcher(
        cfg, params, n_slots=8, max_len=2048, max_new_tokens=FLEET_MAX_NEW,
        chunk=8, kv_layout="paged", page_size=16, prefix_cache_rows=4,
        prefix_block=FLEET_SYSTEM).generate_all(traffic)
    got = [np.asarray(o) for o in outs]
    e2e = dict(
        launches=launches, checks=checks, **{
            part: {k: v for k, v in run.items()} for part, run in runs.items()},
        greedy_streams_identical=sum(
            int(np.array_equal(a_, b_)) for a_, b_ in zip(got, ref)),
        greedy_token_agreement=float(np.mean(
            np.concatenate(got) == np.concatenate(ref))))
    log("serve.fleet", **e2e)
    torch.cuda.empty_cache()
    _raise_failed("serve.fleet", checks)
    if probes:
        one, _ = _fleet_run(cfg, params, "serve.fleet.one_replica", warm,
                            traffic, ("colocated",))
        interval = sys.getswitchinterval()
        sys.setswitchinterval(5e-4)
        try:
            fast, _ = _fleet_run(cfg, params, "serve.fleet.switch_0.5ms",
                                 warm, traffic, ("colocated", "colocated"))
        finally:
            sys.setswitchinterval(interval)
        log("serve.fleet.probes", two_replicas=_fleet_summary(a),
            one_replica=_fleet_summary(one),
            two_replicas_switch_0_5ms=_fleet_summary(fast))
        torch.cuda.empty_cache()
    return e2e


def _spec_prompts(cfg, n=SPEC_REQUESTS):
    """The speculative phases' traffic: n greedy requests, each a
    64-token segment (seed SEED + 5) tiled to 256-1024 tokens, so the
    n-gram drafter proposes from the first step."""
    rng = np.random.default_rng(SEED + 5)
    out = []
    for m in rng.integers(256, 1025, size=n):
        seg = rng.integers(1, cfg.vocab_size, size=64).tolist()
        out.append((seg * 16)[: int(m)])
    return out


def _watch_dispatches(engine):
    """Record, for every dispatch of a run, the launch counts it added
    and its span on the card (CUDA events recorded before and after its
    enqueue; host launch gaps included): ("spec", deltas, span event
    pair) for a verify, ("chunk", deltas, events, steps) for a chunk.
    The engine's `_dispatch_spec` and `_dispatch_chunk` are wrapped on
    the instance; the cost is two counter snapshots and two events a
    dispatch."""
    from dlrover_tpu_torch.ops import _build

    seen = []
    spec, chunk = engine._dispatch_spec, engine._dispatch_chunk

    def watched(kind, run, *args, **kw):
        before, steps = _build.launch_counts(), engine.decode_steps
        start, end = (torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True))
        start.record()
        run(*args, **kw)
        end.record()
        after = _build.launch_counts()
        seen.append((kind, {k: after[k] - before[k] for k in after},
                     (start, end), engine.decode_steps - steps))

    engine._dispatch_spec = lambda *a, **kw: watched("spec", spec, *a, **kw)
    engine._dispatch_chunk = lambda *a, **kw: watched("chunk", chunk, *a,
                                                      **kw)
    return seen


def _dispatch_report(seen, per_forward=None):
    """Failed checks and span means of a `_watch_dispatches` record:
    no paged launch inside a verify; with `per_forward` (int8 weights)
    every verify product on `dqmm_ws` and every chunk-step product on
    the TMA-ring decode kernel."""
    failed = []
    spans = {"spec": [], "chunk": []}
    for kind, d, (start, end), steps in seen:
        ms = start.elapsed_time(end)
        spans[kind].append(ms / max(steps, 1) if kind == "chunk" else ms)
        if kind == "spec" and d["paged_attention"]:
            failed.append("a paged launch inside a verify")
        if per_forward is None:
            continue
        if kind == "spec":
            want = dict(dqmm=per_forward, dqmm_ws=per_forward,
                        dqmm_decode_tma=0)
        else:
            want = dict(dqmm=steps * per_forward, dqmm_ws=0,
                        dqmm_decode_tma=steps * per_forward)
        if any(d[k] != v for k, v in want.items()):
            failed.append(f"{kind} dispatch launched "
                          f"{ {k: d[k] for k in want} }, want {want}")
    return sorted(set(failed)), {
        "verify_span_ms_mean": float(np.mean(spans["spec"]))
        if spans["spec"] else None,
        "chunk_step_span_ms_mean": float(np.mean(spans["chunk"]))
        if spans["chunk"] else None,
    }


def phase_serve_spec(params, cfg, weight_quant="none"):
    """serve.spec (bf16 weights) or serve.spec.int8: the paged engine
    with spec_draft_len=4 and max_len 2044 (a 2048-cell bank in pages of
    16) greedy-serving the SPEC_REQUESTS prompts of `_spec_prompts`, the
    launch counts set to 0 just before the engine is built (the int8
    install counts) and read after the drain. bf16 also runs the same
    prompts through the same engine with spec_draft_len=0 (max_len 2048:
    at 2044 with no draft the auto page would be 4 cells, which the
    paged kernel refuses, as JAX's gate does), for its numbers and the
    greedy agreement (reported: a verify attends through the gathered
    view where a step takes the paged kernel)."""
    from dlrover_tpu_torch.ops import _build
    from dlrover_tpu_torch.serving.engine import ContinuousBatcher

    phase = "serve.spec" if weight_quant == "none" else "serve.spec.int8"
    prompts = _spec_prompts(cfg)
    kw = dict(n_slots=8, max_len=SPEC_MAX_LEN, max_new_tokens=SPEC_MAX_NEW,
              chunk=8, kv_layout="paged", spec_draft_len=SPEC_K,
              weight_quant=weight_quant)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()
    engine = ContinuousBatcher(cfg, params, **kw)
    seen = _watch_dispatches(engine)
    outs, tm = _serve(engine, prompts, SPEC_MAX_NEW)
    torch.cuda.synchronize()
    launches = _build.launch_counts()
    lens = [len(o) for o in outs]
    toks = np.concatenate(outs)
    per_forward = (None if weight_quant == "none" else
                   7 * cfg.n_layers + (0 if cfg.tie_embeddings else 1))
    failed, spans = _dispatch_report(seen, per_forward)
    checks = {
        "page_size == 16": engine.page_size == 16,
        "every request finished": lens == [SPEC_MAX_NEW] * len(prompts),
        "tokens in the vocabulary": bool(
            toks.min() >= 0 and toks.max() < cfg.vocab_size),
        "verify_steps >= 1": engine.verify_steps >= 1,
        "flash_fwd == admissions x layers": (
            launches["flash_fwd"] == engine.admissions * cfg.n_layers),
        "paged == decode_steps x layers": (
            launches["paged_attention"]
            == engine.decode_steps * cfg.n_layers),
    }
    checks.update({name: False for name in failed})
    by_variant = None
    if per_forward is not None:
        forwards = engine.admissions + engine.verify_steps
        by_variant = dict(
            ws=launches["dqmm_ws"], decode_tma=launches["dqmm_decode_tma"],
            decode_mma=(launches["dqmm"] - launches["dqmm_ws"]
                        - launches["dqmm_decode_tma"]))
        want_variant = dict(ws=forwards * per_forward,
                            decode_tma=engine.decode_steps * per_forward,
                            decode_mma=0)
        checks["dqmm launches by variant"] = by_variant == want_variant
        checks["quant_int8 >= one a layer slice"] = (
            launches["quant_int8"] >= per_forward)
    _check_wgmma(phase, launches)
    _check_paged_tma(phase, launches)
    e2e = dict(
        requests=len(prompts), prompt_lens=[len(p) for p in prompts],
        max_new=SPEC_MAX_NEW, max_len=SPEC_MAX_LEN, spec_draft_len=SPEC_K,
        weight_quant=weight_quant, admissions=engine.admissions,
        verify_steps=engine.verify_steps, decode_steps=engine.decode_steps,
        launches=launches, dqmm_launches_by_variant=by_variant,
        spec_stats=engine.spec.stats(), step_stats=engine.step_stats(),
        **spans, **_timings(tm, lens), checks=checks,
    )
    del engine
    torch.cuda.empty_cache()
    if weight_quant == "none":
        base = ContinuousBatcher(cfg, params, **dict(
            kw, spec_draft_len=0, max_len=SPEC_MAX_LEN + SPEC_K))
        base_outs, base_tm = _serve(base, prompts, SPEC_MAX_NEW)
        e2e["no_spec"] = dict(
            max_len=base.max_len, decode_steps=base.decode_steps,
            step_stats=base.step_stats(),
            **_timings(base_tm, [len(o) for o in base_outs]))
        e2e.update(
            greedy_streams_identical=sum(
                int(np.array_equal(a, b)) for a, b in zip(outs, base_outs)),
            greedy_token_agreement=float(np.mean(
                np.concatenate(outs) == np.concatenate(base_outs))))
        del base
        torch.cuda.empty_cache()
    log(phase, **e2e)
    bad = [name for name, ok in checks.items() if not ok]
    if bad:
        raise AssertionError(f"{phase}: failed {bad}")
    return e2e


def phase_verify(params, cfg):
    """serve.spec.verify: one paged verify of 8 rows at the serving
    shapes (each a spec prompt of 256-1024 tokens prefilled into a
    2048-cell page run; the carry token and the 4 tokens the tiled
    segment continues with) against the same tokens stepped one at a
    time through paged_decode_step from the same pool: the logits at
    each of the K+1 positions within LOGITS_REL_TOL of the largest
    logit, and no paged launch inside the verify. Then the device time
    (CUDA-graph replayed) of that verify, of its 32 layers' gathered
    views alone, of the attention over them alone, and of one paged
    decode step of the same rows."""
    from dlrover_tpu_torch.models import decode as dec
    from dlrover_tpu_torch.ops import _build
    from dlrover_tpu_torch.ops import paged_attention as pa
    from dlrover_tpu_torch.serving.engine import _pad_bucket

    b, s, ps = 8, SPEC_K + 1, 16
    per_slot = (SPEC_MAX_LEN + SPEC_K) // ps
    rows = _spec_prompts(cfg)[:b]
    table = (1 + torch.arange(b * per_slot, dtype=torch.int32,
                              device="cuda")).reshape(b, per_slot)
    pool = dec.init_page_pool(cfg, 1 + b * per_slot, ps)
    for r, p in enumerate(rows):
        bucket = min(_pad_bucket(len(p)), SPEC_MAX_LEN)
        toks = torch.zeros(bucket, dtype=torch.long, device="cuda")
        toks[: len(p)] = torch.tensor(p, device="cuda")
        row = dec.prefill_exact_row(cfg, params, toks, SPEC_MAX_LEN)
        dec.paged_install_row(pool, row, table[r], 0, bucket)
        del row
    pos = torch.tensor([len(p) - 1 for p in rows], device="cuda")
    # the tiled segment's period is 64: the token at m + j is m + j - 64's
    tokens = torch.tensor(
        [[p[-1]] + [p[len(p) - 64 + j] for j in range(SPEC_K)]
         for p in rows], device="cuda")
    stepped = {n: a.clone() for n, a in pool.items()}
    before = _build.launch_counts()
    vl, _ = dec.paged_verify_step(cfg, params, tokens, pool, table, pos)
    torch.cuda.synchronize()
    paged_in_verify = _launched(before, _build.launch_counts(),
                                "paged_attention")
    errs, tols = [], []
    for j in range(s):
        sl, _ = dec.paged_decode_step(cfg, params, tokens[:, j], stepped,
                                      table, pos + j)
        torch.cuda.synchronize()
        if not (torch.isfinite(vl[:, j]).all() and torch.isfinite(sl).all()):
            raise AssertionError(f"serve.spec.verify: non-finite logits {j}")
        errs.append((vl[:, j] - sl).abs().max().item())
        tols.append(LOGITS_REL_TOL * sl.abs().max().item())
    del stepped, vl, sl
    torch.cuda.empty_cache()
    layer0 = {n: a[0] for n, a in pool.items()}
    view = pa.gather_pages(layer0, table)
    q = torch.randn((b, s, cfg.n_heads, cfg.head_dim), device="cuda",
                    dtype=cfg.dtype)
    positions = pos[:, None] + torch.arange(s, device="cuda")[None]
    scale = cfg.head_dim ** -0.5

    def gathers():
        for _ in range(cfg.n_layers):
            pa.gather_pages(layer0, table)

    def attends():
        for _ in range(cfg.n_layers):
            dec._cached_attention(q, view, positions, scale)

    timing = dict(
        verify_ms=device_ms(lambda: dec.paged_verify_step(
            cfg, params, tokens, pool, table, pos), calls=3, replays=5),
        gathers_ms=device_ms(gathers, calls=3, replays=5),
        attention_over_views_ms=device_ms(attends, calls=3, replays=5),
        decode_step_ms=device_ms(lambda: dec.paged_decode_step(
            cfg, params, tokens[:, 0], pool, table, pos), calls=3,
            replays=5),
        view_bytes_per_layer=sum(v.numel() * v.element_size()
                                 for v in view.values()),
    )
    del pool, view, q
    torch.cuda.empty_cache()
    ok = paged_in_verify == 0 and all(e <= t for e, t in zip(errs, tols))
    log("serve.spec.verify", rows=b, positions=s,
        cells=[len(p) for p in rows], max_abs_err=errs, tol=tols,
        tol_reason="5% of the largest logit of each position: the verify "
        "attends through the gathered view with f32 scores, the stepped "
        "decode through the paged kernel; bf16 roundings carried through "
        "32 layers", paged_launches_in_verify=paged_in_verify, **timing)
    if not ok:
        raise AssertionError(
            f"serve.spec.verify: errors {errs} (tols {tols}), "
            f"{paged_in_verify} paged launches inside the verify")
    return timing


# ---- tensor-parallel serving: kernel.sharded, serve.tp2 and its resize
# and int8 phases ------------------------------------------------------


@contextlib.contextmanager
def _virtual_shards(n):
    """DLROVER_TPU_TORCH_FORCE_DEVICE_COUNT=n for one phase: the serving
    slice's n devices are n virtual shards of this one card, launched
    one after another on its stream. Restored after the phase."""
    from dlrover_tpu_torch import _device

    name = _device.FORCE_DEVICE_COUNT_ENV
    old = os.environ.get(name)
    os.environ[name] = str(n)
    try:
        yield
    finally:
        if old is None:
            os.environ.pop(name, None)
        else:
            os.environ[name] = old


def _virtual_mesh(tp, n_kv):
    from dlrover_tpu_torch._device import local_devices
    from dlrover_tpu_torch.parallel.mesh import serving_mesh

    with _virtual_shards(tp):
        mesh = serving_mesh(tp, devices=local_devices("cuda"),
                            n_kv_heads=n_kv)
    if not mesh.colocated:
        raise AssertionError(f"tp={tp}: shards not on the one card")
    return mesh


def phase_kernel_sharded(gen):
    """kernel.sharded: the two sharded kernel sites at Llama-3-8B's heads
    (32 q / 8 KV of 128) on tp = 2 and 4 virtual shards of the card.
    `sharded_flash_attention` (kernel 1 per shard) at B=1 S=512 and
    S=2048, and the sharded paged attention (`_sharded_kernel`, kernel
    4 per shard, each launch on the unsharded launch's work partition)
    at serve's decode shape, bf16 and int8 pools: every shard's output
    must be the tp=1 kernel's head slice bit for bit, tp launches a
    call (each on the wgmma / TMA-ring variant), the error against the
    plain version within the kernel's tolerance; each call's time
    beside tp=1's (paged cold over L2-overflowing pool copies and
    warm), the plain version's and the library's."""
    from dlrover_tpu_torch.ops import _build
    from dlrover_tpu_torch.ops import flash_attention as fa
    from dlrover_tpu_torch.ops import paged_attention as pa

    F = torch.nn.functional
    h, kv, d = 32, 8, 128
    scale = d ** -0.5
    flash_rows, paged_rows = [], []
    for tp in TP_DEGREES:
        mesh = _virtual_mesh(tp, kv)
        log("kernel.sharded.mesh", tp=tp, virtual_shards=True,
            devices=[str(x) for x in mesh.devices])
        for b, s in TP_FLASH_CASES:
            q = torch.randn((b, s, h, d), generator=gen,
                            device="cuda").bfloat16()
            k = torch.randn((b, s, kv, d), generator=gen,
                            device="cuda").bfloat16()
            v = torch.randn((b, s, kv, d), generator=gen,
                            device="cuda").bfloat16()
            whole, _ = fa._fwd(q, k, v, True, scale)
            qs, ks, vs = (mesh.split(x, 2) for x in (q, k, v))

            def sharded():
                return fa.sharded_flash_attention(qs, ks, vs, mesh, True,
                                                  scale)

            before = _build.launch_counts()
            parts = sharded()
            after = _build.launch_counts()
            torch.cuda.synchronize()
            got = torch.cat(parts, 2)
            o_ref, _ = fa._fwd_plain(q, k, v, True, scale)
            err = (got.float() - o_ref.float()).abs().max().item()
            launches = _launched(before, after, "flash_fwd_wgmma")
            checks = {
                "bit-equal to the tp=1 kernel": torch.equal(got, whole),
                "tp wgmma launches a call": (
                    launches == tp
                    and _launched(before, after, "flash_fwd") == tp),
                "within FLASH_TOL of the plain version": err <= FLASH_TOL,
            }
            flops = 2.0 * b * h * d * s * (s + 1)
            nbytes = (2 * (2 * b * s * h * d + 2 * b * s * kv * d)
                      + 4 * b * h * s)
            bms, by = bound_ms(flops, nbytes)
            qt, kt, vt = ([x.transpose(1, 2) for x in xs]
                          for xs in (qs, ks, vs))
            row = dict(
                tp=tp, B=b, S=s, launches=launches,
                bit_equal=checks["bit-equal to the tp=1 kernel"],
                max_abs_err=err, tol=FLASH_TOL,
                ms=device_ms(sharded),
                tp1_ms=device_ms(lambda: fa._fwd(q, k, v, True, scale)),
                plain_ms=time_ms(lambda: [
                    fa._fwd_plain(qi, ki, vi, True, scale)
                    for qi, ki, vi in zip(qs, ks, vs)], 3),
                library_ms=device_ms(lambda: [
                    F.scaled_dot_product_attention(
                        qi, ki, vi, is_causal=True, enable_gqa=True)
                    for qi, ki, vi in zip(qt, kt, vt)]),
                bound_ms=bms, bound_by=by)
            log("kernel.sharded.flash", **row)
            _raise_failed(f"kernel.sharded.flash tp={tp} S={s}", checks)
            flash_rows.append(row)
            del q, k, v, qs, ks, vs, qt, kt, vt, whole, parts, got
        for quant in (False, True):
            q, pages, table, lens, lengths = _paged_case(gen, quant)
            b = q.shape[0]
            whole = pa._kernel(q, pages, table, lens, scale)
            qs = mesh.split(q, 1)
            pools = mesh.split_pool(pages, 2)
            before = _build.launch_counts()
            parts = pa._sharded_kernel(qs, pools, table, lens, scale, mesh)
            after = _build.launch_counts()
            torch.cuda.synchronize()
            got = torch.cat(parts, 1)
            ref = pa._reference(q, pages, table, lens, scale)
            err = (got.float() - ref.float()).abs().max().item()
            launches = _launched(before, after, "paged_attention_tma")
            checks = {
                "bit-equal to the tp=1 kernel": torch.equal(got, whole),
                "tp TMA-ring launches a call": (
                    launches == tp
                    and _launched(before, after, "paged_attention") == tp),
                "within PAGED_TOL of the plain version": err <= PAGED_TOL,
            }
            cells = int(lengths.sum())
            elem = 1 if quant else 2
            live = (2 * cells * kv * d * elem
                    + (2 * cells * kv * 2 if quant else 0))
            nbytes = live + 2 * 2 * b * h * d + table.numel() * 4 + b * 4
            bms, by = bound_ms(4.0 * cells * h * d, nbytes)
            cold = cold_copies(
                lambda: mesh.split_pool({n: t.clone()
                                         for n, t in pages.items()}, 2),
                live)
            cold1 = cold_copies(
                lambda: {n: t.clone() for n, t in pages.items()}, live)
            row = dict(
                tp=tp, pool="int8" if quant else "bf16", B=b,
                live_cells=cells, launches=launches,
                bit_equal=checks["bit-equal to the tp=1 kernel"],
                max_abs_err=err, tol=PAGED_TOL,
                ms=device_ms(cycling(
                    lambda ps: pa._sharded_kernel(qs, ps, table, lens,
                                                  scale, mesh), cold),
                    calls=len(cold)),
                warm_ms=device_ms(lambda: pa._sharded_kernel(
                    qs, pools, table, lens, scale, mesh)),
                tp1_ms=device_ms(cycling(
                    lambda ps: pa._kernel(q, ps, table, lens, scale),
                    cold1), calls=len(cold1)),
                tp1_warm_ms=device_ms(
                    lambda: pa._kernel(q, pages, table, lens, scale)),
                plain_ms=time_ms(lambda: [
                    pa._reference(qi, pi, table, lens, scale)
                    for qi, pi in zip(qs, pools)], 3),
                library_ms=None, bound_ms=bms, bound_by=by)
            log("kernel.sharded.paged", **row)
            _raise_failed(f"kernel.sharded.paged tp={tp} "
                          f"{row['pool']}", checks)
            paged_rows.append(row)
            del q, pages, pools, cold, cold1, whole, parts, got
            torch.cuda.empty_cache()
    return flash_rows, paged_rows


def _first_layers(cfg, params, n):
    """The model cut to its first `n` layers: views of the stacked
    weights, no copy."""
    out = dict(params)
    out["layers"] = {k: v[:n] for k, v in params["layers"].items()}
    return dataclasses.replace(cfg, n_layers=n), out


def phase_serve_tp2(params, cfg, serve):
    """serve.tp2: serve's workload (Llama-3-8B, full width and depth,
    paged, 8 slots, max_len 2048, 12 greedy requests of 50-1000 tokens,
    max_new 32) through ContinuousBatcher(mesh_spec=2) on two virtual
    shards of the card: wq/wk/wv split on their head columns, the page
    pool on its KV heads, every attention per shard. The streams must
    equal serve's byte for byte, kernel_path "kernel", the paged
    TMA-ring and flash wgmma launches twice serve's (a launch a shard),
    all on those variants; TTFT, TPOT, tokens/s, peak memory and the
    weight bytes a shard beside serve's."""
    from dlrover_tpu_torch.ops import _build
    from dlrover_tpu_torch.serving.engine import ContinuousBatcher

    max_new = 32
    prompts = _prompts(cfg)
    kw = dict(n_slots=8, max_len=2048, max_new_tokens=max_new, chunk=8,
              kv_layout="paged", mesh_spec=2)
    with _virtual_shards(2):
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
    base = serve["launches"]
    checks = {
        "virtual shards of one card": engine.mesh.colocated,
        "kernel_path kernel": engine.kernel_path == "kernel",
        "every request finished": lens == [max_new] * len(prompts),
        "streams equal serve's": all(
            np.array_equal(a, b) for a, b in zip(outs, serve["outs"])),
        "paged_attention_tma 2x serve's": (
            launches["paged_attention_tma"]
            == 2 * base["paged_attention_tma"]),
        "flash_fwd_wgmma 2x serve's": (
            launches["flash_fwd_wgmma"] == 2 * base["flash_fwd_wgmma"]),
        "every paged launch TMA": (
            launches["paged_attention"] == launches["paged_attention_tma"]),
        "every flash launch wgmma": (
            launches["flash_fwd"] == launches["flash_fwd_wgmma"]),
        "same dispatches as serve": (
            engine.admissions == serve["admissions"]
            and engine.decode_steps == serve["decode_steps"]),
    }
    e2e = dict(
        requests=len(prompts), mesh_shape=engine.mesh_shape,
        n_chips=engine.n_chips, virtual_shards=True,
        kernel_path=engine.kernel_path, admissions=engine.admissions,
        decode_steps=engine.decode_steps, launches=launches,
        step_stats=engine.step_stats(),
        weight_bytes_per_shard=engine.weight_bytes_device(),
        **_timings(tm, lens))
    e2e["serve"] = {k: serve[k] for k in (
        "ttft_ms_mean", "ttft_ms_p50", "tpot_ms_mean", "tokens_per_s",
        "peak_mem_gb", "weight_bytes")}
    log("serve.tp2", checks=checks, **e2e)
    _raise_failed("serve.tp2", checks)
    del engine
    torch.cuda.empty_cache()
    e2e["outs"] = outs
    return e2e


def _preempt_all(engine):
    """What a resize does to live requests, without re-forming: abandon
    the in-flight dispatch, preempt every live slot for replay in
    reverse slot order."""
    engine.drain_inflight()
    for slot in range(engine.n_slots - 1, -1, -1):
        if engine.slot_req[slot] is not None and not engine.done[slot]:
            engine._preempt_slot(slot)


def _stepped(engine, prompts, max_new, at=(), event=None):
    """Submit, then step to the end, calling `event(i)` after the
    `at[i]`-th step; the streams in submission order."""
    ids = [engine.submit(p, max_new=max_new) for p in prompts]
    n = 0
    while engine.has_work():
        engine.step()
        n += 1
        if n in at:
            event(at.index(n))
    outs = [np.asarray(engine._requests[i].out, np.int64) for i in ids]
    engine.generate_all([])
    return outs


def phase_serve_tp2_resize(params, cfg):
    """serve.tp2.resize: serve's traffic on the first TP_LAYERS layers
    at tp=2 (two virtual shards); after step 2 (8 requests 16 tokens
    into their decode) the slice shrinks to tp=1, after step 3 (the
    replays 8 tokens on) it grows back to tp=2. Every resize preempts
    every live request for replay.
    The streams must equal those of a tp=2 run that preempts the same
    requests at the same steps without re-forming (the replays are the
    same; only the slice differs), and the slice must be tp 1 between
    the two; the agreement with the uninterrupted run is reported.
    downtime_ms and the replayed count of each direction, and the
    launches split by the slice they ran on (`launches_by_tp`: tp=2
    before the shrink and after the grow, the sharded sites; tp=1
    between, the unsharded ones)."""
    from dlrover_tpu_torch.serving.engine import ContinuousBatcher

    lcfg, lparams = _first_layers(cfg, params, TP_LAYERS)
    max_new = 32
    prompts = _prompts(cfg)
    kw = dict(n_slots=8, max_len=2048, max_new_tokens=max_new, chunk=8,
              kv_layout="paged", mesh_spec=2)
    from dlrover_tpu_torch.ops import _build

    reports = []
    with _virtual_shards(2):
        plain = _stepped(ContinuousBatcher(lcfg, lparams, **kw), prompts,
                         max_new)
        oracle_eng = ContinuousBatcher(lcfg, lparams, **kw)
        oracle = _stepped(oracle_eng, prompts, max_new, at=TP_RESIZE_AT,
                          event=lambda i: _preempt_all(oracle_eng))
        engine = ContinuousBatcher(lcfg, lparams, **kw)
        _build.reset_launch_counts()
        tps, marks = [], []

        def resize(i):
            marks.append(_build.launch_counts())
            reports.append(engine.resize([1, 2][i]))
            torch.cuda.synchronize()
            tps.append(engine.mesh_tp)

        got = _stepped(engine, prompts, max_new, at=TP_RESIZE_AT,
                       event=resize)
        torch.cuda.synchronize()
    launches = _build.launch_counts()
    at_tp1 = {k: marks[1][k] - marks[0][k] for k in launches}
    by_tp = {"2": {k: launches[k] - at_tp1[k] for k in launches},
             "1": at_tp1}
    same = [np.array_equal(a, b) for a, b in zip(got, oracle)]
    same_plain = [np.array_equal(a, b) for a, b in zip(got, plain)]
    prefix = [int(np.argmax(np.append(a != b, True)))
              for a, b in zip(got, plain)]
    checks = {
        "shrink then grow": [r.direction for r in reports]
        == ["shrink", "grow"] and tps == [1, 2],
        "replayed live requests": all(r.replayed > 0 for r in reports),
        "every request finished": [len(o) for o in got]
        == [max_new] * len(prompts),
        "streams equal the same replays without a resize": all(same),
    }
    row = dict(
        layers=TP_LAYERS, virtual_shards=True,
        resizes=[dict(direction=r.direction, old_tp=r.old_tp,
                      new_tp=r.new_tp, replayed=r.replayed,
                      downtime_ms=r.downtime_ms) for r in reports],
        elastic_stats=engine.elastic_stats(), launches=launches,
        launches_by_tp=by_tp, streams_equal_uninterrupted=sum(same_plain),
        common_prefix_with_uninterrupted=prefix, checks=checks)
    log("serve.tp2.resize", **row)
    _raise_failed("serve.tp2.resize", checks)
    del engine, oracle_eng
    torch.cuda.empty_cache()
    return row


def phase_serve_tp2_int8(params, cfg):
    """serve.tp2.int8: serve's traffic on the first TP_LAYERS layers with
    weight_quant="int8" at tp=2 (two virtual shards): the quantize
    kernel at install (before the split), weight_quant_path
    "int8:reference" and no dqmm launch (JAX's gate keeps tp > 1 on the
    dequantize-then-product reference), every flash and paged launch on
    its variant, and the greedy streams equal those of tp=1 int8 on the
    same plain product (the dqmm kernel's plain version); the agreement
    with tp=1 int8 on the kernel is reported."""
    from dlrover_tpu_torch.ops import _build
    from dlrover_tpu_torch.ops import quantization as Q
    from dlrover_tpu_torch.serving.engine import ContinuousBatcher

    lcfg, lparams = _first_layers(cfg, params, TP_LAYERS)
    max_new = 32
    prompts = _prompts(cfg)
    kw = dict(n_slots=8, max_len=2048, max_new_tokens=max_new, chunk=8,
              kv_layout="paged", weight_quant="int8")
    eng1 = ContinuousBatcher(lcfg, lparams, **kw)
    _build.reset_launch_counts()
    kernel_outs = _stepped(eng1, prompts, max_new)
    tp1_launches = _build.launch_counts()
    real_gate = Q.use_quant_matmul_kernel
    Q.use_quant_matmul_kernel = lambda tp=1: False
    try:
        ref_outs = _stepped(eng1, prompts, max_new)
    finally:
        Q.use_quant_matmul_kernel = real_gate
    del eng1
    with _virtual_shards(2):
        _build.reset_launch_counts()
        engine = ContinuousBatcher(lcfg, lparams, mesh_spec=2, **kw)
        install = _build.launch_counts()
        _build.reset_launch_counts()
        outs = _stepped(engine, prompts, max_new)
        torch.cuda.synchronize()
    launches = _build.launch_counts()
    same_ref = [np.array_equal(a, b) for a, b in zip(outs, ref_outs)]
    same_kernel = [np.array_equal(a, b) for a, b in zip(outs, kernel_outs)]
    checks = {
        "weight_quant_path int8:reference":
            engine.weight_quant_path == "int8:reference",
        "quantize kernel at install": install["quant_int8"] > 0,
        "no dqmm launch": launches.get("dqmm", 0) == 0,
        "tp=1 int8 on the kernel launched dqmm": tp1_launches["dqmm"] > 0,
        "every flash launch wgmma": (
            launches["flash_fwd"] == launches["flash_fwd_wgmma"]
            == 2 * engine.admissions * TP_LAYERS),
        "every paged launch TMA": (
            launches["paged_attention"] == launches["paged_attention_tma"]
            == 2 * engine.decode_steps * TP_LAYERS),
        "streams equal tp=1 int8 on the plain product": all(same_ref),
    }
    row = dict(
        layers=TP_LAYERS, virtual_shards=True,
        weight_quant_path=engine.weight_quant_path,
        install_launches={k: v for k, v in install.items() if v},
        launches=launches, streams_equal_tp1_int8_kernel=sum(same_kernel),
        weight_bytes_per_shard=engine.weight_bytes_device(), checks=checks)
    log("serve.tp2.int8", **row)
    _raise_failed("serve.tp2.int8", checks)
    row["launches"]["quant_int8"] = install["quant_int8"]
    del engine
    torch.cuda.empty_cache()
    return row


def phase_serve_async(params, cfg, sync):
    """serve.async: the serve phase's traffic and engine at
    async_depth=1, the launch counts set to 0 just before that run and
    read after: every request finishes, the kernels ran as in serve, and
    the streams equal serve's (depth 0) byte for byte: both depths run
    the same dispatches. Then depth 0, depth 0 and depth 1 again in
    turns (ABBA), for TPOT and step_stats of both depths in one phase;
    every run's streams must equal serve's too (a depth-0 run that
    differs from serve's would be a kernel that does not repeat
    itself)."""
    from dlrover_tpu_torch.ops import _build
    from dlrover_tpu_torch.serving.engine import ContinuousBatcher

    max_new = 32
    prompts = _prompts(cfg)
    kw = dict(n_slots=8, max_len=2048, max_new_tokens=max_new, chunk=8,
              kv_layout="paged")
    runs = []
    for depth in (1, 0, 0, 1):
        engine = ContinuousBatcher(cfg, params, async_depth=depth, **kw)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _build.reset_launch_counts()
        outs, tm = _serve(engine, prompts, max_new)
        torch.cuda.synchronize()
        runs.append(dict(
            depth=depth, launches=_build.launch_counts(),
            admissions=engine.admissions, decode_steps=engine.decode_steps,
            step_stats=engine.step_stats(), outs=outs,
            **_timings(tm, [len(o) for o in outs])))
        del engine
    torch.cuda.empty_cache()
    first = runs[0]
    launches = first["launches"]
    checks = {
        "every request finished": all(
            [len(o) for o in r["outs"]] == [max_new] * len(prompts)
            for r in runs),
        "flash_fwd == admissions x layers": (
            launches["flash_fwd"] == first["admissions"] * cfg.n_layers),
        "paged == decode_steps x layers": (
            launches["paged_attention"]
            == first["decode_steps"] * cfg.n_layers),
    }
    for i, r in enumerate(runs):
        checks[f"run {i} (depth {r['depth']}) streams equal serve's"] = all(
            np.array_equal(a, b) for a, b in zip(r["outs"], sync["outs"]))
    _check_wgmma("serve.async", launches)
    _check_paged_tma("serve.async", launches)
    keys = ("step_stats", "wall_s", "ttft_ms_mean", "tpot_ms_mean",
            "tokens_per_s")
    e2e = dict(
        requests=len(prompts), max_new=max_new, order="1 0 0 1",
        admissions=first["admissions"], decode_steps=first["decode_steps"],
        launches=launches, **{k: first[k] for k in keys},
        runs=[{k: r[k] for k in ("depth",) + keys} for r in runs],
        tpot_ms_mean_by_depth={d: float(np.mean(
            [r["tpot_ms_mean"] for r in runs if r["depth"] == d]))
            for d in (0, 1)},
        serve_step_stats=sync["step_stats"],
        serve_tpot_ms_mean=sync["tpot_ms_mean"],
        peak_mem_gb=first["peak_mem_gb"], checks=checks,
    )
    log("serve.async", **e2e)
    bad = [name for name, ok in checks.items() if not ok]
    if bad:
        raise AssertionError(f"serve.async: failed {bad}")
    return e2e


# -- multi-adapter LoRA serving and weight refresh ---------------------------


def _adapter_trees(cfg, params, prompt):
    """The six adapters (numpy, seed ADAPTER_SEED): A ~ N(0, 1/r),
    B ~ N(0, 1) times one scale chosen so that ad0's wq delta on the
    layer-0 input of `prompt` has ADAPTER_DELTA_RMS of the base wq
    projection's RMS. -> ({id: (layers, alpha)}, scale, {id: ratio})."""
    from dlrover_tpu_torch.models.llama import _rms_norm
    from dlrover_tpu_torch.serving.adapters import _target_dims

    rng = np.random.default_rng(ADAPTER_SEED)
    trees = {}
    for i, aid in enumerate(ADAPTER_IDS):
        r = 8 if i % 2 == 0 else 16
        layers = {}
        for t, (d_in, d_out) in _target_dims(cfg).items():
            layers[t + "_lora_a"] = rng.standard_normal(
                (cfg.n_layers, d_in, r), dtype=np.float32) / np.float32(
                    np.sqrt(r))
            layers[t + "_lora_b"] = rng.standard_normal(
                (cfg.n_layers, r, d_out), dtype=np.float32)
        trees[aid] = (layers, 2.0 * r)
    tok = torch.tensor(prompt, device="cuda")
    x = params["embed"]["weight"][tok].to(cfg.dtype)
    h = _rms_norm(x, params["layers"]["attn_norm"][0], cfg.norm_eps).float()
    base_rms = (h @ params["layers"]["wq"][0].float()).pow(2).mean().sqrt()

    def ratio(aid):
        layers, alpha = trees[aid]
        a = torch.from_numpy(layers["wq_lora_a"][0]).cuda()
        b = torch.from_numpy(layers["wq_lora_b"][0]).cuda()
        d = (alpha / a.shape[-1]) * (h @ a) @ b
        return float(d.pow(2).mean().sqrt() / base_rms)

    scale = ADAPTER_DELTA_RMS / ratio("ad0")
    for layers, _ in trees.values():
        for k in layers:
            if k.endswith("_lora_b"):
                layers[k] *= np.float32(scale)
    ratios = {aid: ratio(aid) for aid in ADAPTER_IDS}
    if not all(0.01 <= v <= 0.10 for v in ratios.values()):
        raise AssertionError(f"adapter delta / base RMS {ratios} outside "
                             "1-10%")
    return trees, scale, ratios


def _watch_adapter_first_decodes(engine, ids):
    """Record the engine's own first-decode logits (the step that
    samples a request's first token) of the first request admitted
    under each adapter id in `ids`: `_admit` and `_advance` wrapped on
    the instance. Returns {id: (prompt, logits [V])}."""
    seen, pending = {}, {}
    admit, advance = engine._admit, engine._advance

    def watch_admit(slot, req):
        admit(slot, req)
        aid = req.adapter_id
        if aid in ids and aid not in seen and aid not in (
                a for a, _ in pending.values()):
            pending[slot] = (aid, req)

    def watch_advance(logits, tok, pos, done, limit):
        for slot, (aid, req) in pending.items():
            if engine.slot_req[slot] is req:
                seen[aid] = (req.prompt.tolist(),
                             logits[slot].float().clone())
        pending.clear()
        return advance(logits, tok, pos, done, limit)

    engine._admit = watch_admit
    engine._advance = watch_advance
    return seen


def _decode_step_ms(cfg, params, bank):
    """Device time (CUDA-graph replayed) of one paged decode step of 8
    rows at serve's first 8 prompt lengths, without and with the LoRA
    operand (rows on bank slots 1, 2, 0, 3, 4, 0, 1, 2), in the order
    without, with, with, without."""
    from dlrover_tpu_torch.models import decode as dec
    from dlrover_tpu_torch.serving.engine import _lora_operand

    b, ps, per_slot = 8, 16, 2048 // 16
    table = (1 + torch.arange(b * per_slot, dtype=torch.int32,
                              device="cuda")).reshape(b, per_slot)
    pool = dec.init_page_pool(cfg, 1 + b * per_slot, ps)
    pos = torch.tensor([len(p) - 1 for p in _prompts(cfg)[:b]],
                       device="cuda")
    tok = torch.ones(b, dtype=torch.long, device="cuda")
    ad = _lora_operand(bank, torch.tensor([1, 2, 0, 3, 4, 0, 1, 2],
                                          device="cuda"))
    times = {"without": [], "with": []}
    for which in ("without", "with", "with", "without"):
        op = ad if which == "with" else None
        times[which].append(device_ms(lambda: dec.paged_decode_step(
            cfg, params, tok, pool, table, pos, adapters=op), calls=3,
            replays=5))
    del pool
    torch.cuda.empty_cache()
    return {f"decode_step_ms_{k}_adapters": v for k, v in times.items()}


def _wave_ids(ids, n):
    return [ids[i % len(ids)] for i in range(n)]


def _check_path(phase, engine, launches, cfg, weight_quant="none"):
    """The kernels of a serving run: a flash forward (wgmma) a layer and
    admission, a paged launch (TMA ring) a layer and decode step; int8:
    the dqmm kernel on every product, prefill ones on `dqmm_ws`, decode
    ones on `dqmm_decode_tma`. -> (checks, dqmm launches by variant)."""
    checks = {
        "flash_fwd == admissions x layers": (
            launches["flash_fwd"] == engine.admissions * cfg.n_layers),
        "paged == decode_steps x layers": (
            launches["paged_attention"]
            == engine.decode_steps * cfg.n_layers),
    }
    _check_wgmma(phase, launches)
    _check_paged_tma(phase, launches)
    by_variant = None
    if weight_quant != "none":
        per_forward = 7 * cfg.n_layers + (0 if cfg.tie_embeddings else 1)
        by_variant = dict(
            ws=launches["dqmm_ws"], decode_tma=launches["dqmm_decode_tma"],
            decode_mma=(launches["dqmm"] - launches["dqmm_ws"]
                        - launches["dqmm_decode_tma"]))
        checks["dqmm by variant"] = by_variant == dict(
            ws=engine.admissions * per_forward,
            decode_tma=engine.decode_steps * per_forward, decode_mma=0)
    return checks, by_variant


def _raise_failed(phase, checks):
    bad = [name for name, ok in checks.items() if not ok]
    if bad:
        raise AssertionError(f"{phase}: failed {bad}")


def phase_serve_adapters(params, cfg, serve):
    """serve.adapters: serve's engine with the six adapters registered
    and a bank of ADAPTER_SLOTS; wave 1 (serve's 12 prompts under
    WAVE1_IDS), then after it retires wave 2 (6 prompts under
    WAVE2_IDS, two evictions), the launch counts set to 0 just before
    the engine is built and read after wave 2. Every request finishes,
    the kernels ran as in serve, 6 uploads and 2 evictions, the base
    rows of wave 1 equal serve's streams byte for byte, and the engine's
    first-decode logits of the first ad0 and ad1 requests are within
    LOGITS_REL_TOL of the same prompt on `lora.merge`'s tree. Then one
    decode step's device time with and without adapters, and the bank's
    bytes. -> (e2e, registry, trees, the ad0 logits)."""
    from dlrover_tpu_torch.models import lora
    from dlrover_tpu_torch.ops import _build
    from dlrover_tpu_torch.serving.adapters import AdapterRegistry
    from dlrover_tpu_torch.serving.engine import ContinuousBatcher

    max_new = 32
    prompts = _prompts(cfg)
    trees, b_scale, ratios = _adapter_trees(cfg, params, prompts[0])
    reg = AdapterRegistry(cfg, max_rank=ADAPTER_MAX_RANK)
    for aid, (layers, alpha) in trees.items():
        reg.register(aid, {"layers": layers}, alpha=alpha)
    kw = dict(n_slots=8, max_len=2048, max_new_tokens=max_new, chunk=8,
              kv_layout="paged", adapter_registry=reg,
              adapter_cache_slots=ADAPTER_SLOTS)
    wave1 = _wave_ids(WAVE1_IDS, len(prompts))
    wave2 = _wave_ids(WAVE2_IDS, 6)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()
    engine = ContinuousBatcher(cfg, params, **kw)
    seen = _watch_adapter_first_decodes(engine, ("ad0", "ad1"))
    outs1, tm1 = _serve(engine, prompts, max_new, wave1)
    torch.cuda.synchronize()
    stats1 = engine.adapter_stats()
    outs2, tm2 = _serve(engine, prompts[:6], max_new, wave2)
    torch.cuda.synchronize()
    launches = _build.launch_counts()
    stats = engine.adapter_stats()
    lens = [len(o) for o in outs1 + outs2]
    toks = np.concatenate(outs1 + outs2)
    base = [i for i, a in enumerate(wave1) if a is None]
    adapted = [i for i, a in enumerate(wave1) if a is not None]
    checks, _ = _check_path("serve.adapters", engine, launches, cfg)
    checks.update({
        "every request finished": lens == [max_new] * len(lens),
        "tokens in the vocabulary": bool(
            toks.min() >= 0 and toks.max() < cfg.vocab_size),
        "uploads == 6": stats["uploads"] == 6.0,
        "evictions == 2": stats["evictions"] == 2.0,
        "no pin left after the drains": stats["pinned"] == 0.0,
        "wave-1 base rows equal serve's": all(
            np.array_equal(outs1[i], serve["outs"][i]) for i in base),
    })
    e2e = dict(
        requests=len(lens), wave1_ids=wave1, wave2_ids=wave2,
        admissions=engine.admissions, decode_steps=engine.decode_steps,
        launches=launches, adapter_stats_wave1=stats1, adapter_stats=stats,
        residency=engine.adapter_residency(),
        bank_bytes=engine._adapter_cache.bank_bytes(),
        bank_slots=ADAPTER_SLOTS + 1, b_scale=b_scale,
        delta_rms_ratio=ratios,
        adapted_streams_equal_serve=sum(
            int(np.array_equal(outs1[i], serve["outs"][i])) for i in adapted),
        wave1=_timings(tm1, [len(o) for o in outs1]),
        wave2=_timings(tm2, [len(o) for o in outs2]),
        serve_ttft_ms_mean=serve["ttft_ms_mean"],
        serve_tpot_ms_mean=serve["tpot_ms_mean"],
        serve_tokens_per_s=serve["tokens_per_s"],
        step_stats=engine.step_stats(), checks=checks,
    )
    bank = engine._adapter_cache.bank
    e2e.update(_decode_step_ms(cfg, params, bank))
    log("serve.adapters", **e2e)
    _raise_failed("serve.adapters", checks)
    del engine, bank
    torch.cuda.empty_cache()
    # the engine's first-decode logits of the first ad0 / ad1 request
    # against the same prompt's cold first decode on the merged tree
    for aid in ("ad0", "ad1"):
        if aid not in seen:
            raise AssertionError(f"serve.adapters: no {aid} admission seen")
        prompt, got = seen[aid]
        layers, alpha = trees[aid]
        sd = {"layers": {k: torch.from_numpy(v).cuda()
                         for k, v in layers.items()}}
        merged = lora.merge(dataclasses.replace(cfg, lora_alpha=alpha),
                            lora.load_adapters(params, sd))
        want = _first_decode_logits(cfg, merged, prompt, 2048)[0]
        del merged, sd
        torch.cuda.empty_cache()
        _check_first_decode(
            f"serve.adapters.{aid}_first_decode_logits", got, want,
            "5% of the largest logit: the engine adds the rank-r delta to "
            "each bf16 projection, the merged side rounds W + (alpha/r) "
            "A@B to bf16 once; bf16 roundings carried through 32 layers",
        )
    return e2e, reg, trees, seen["ad0"]


def phase_serve_adapters_base(params, cfg, serve, reg):
    """serve.adapters.base: serve's 12 prompts, all adapter_id=None,
    through an adapter engine: the streams equal serve's byte for byte
    (every row adds an exact zero from bank slot 0)."""
    from dlrover_tpu_torch.ops import _build
    from dlrover_tpu_torch.serving.engine import ContinuousBatcher

    max_new = 32
    prompts = _prompts(cfg)
    _build.reset_launch_counts()
    engine = ContinuousBatcher(
        cfg, params, n_slots=8, max_len=2048, max_new_tokens=max_new,
        chunk=8, kv_layout="paged", adapter_registry=reg,
        adapter_cache_slots=ADAPTER_SLOTS)
    outs, tm = _serve(engine, prompts, max_new)
    torch.cuda.synchronize()
    launches = _build.launch_counts()
    checks, _ = _check_path("serve.adapters.base", engine, launches, cfg)
    checks["streams equal serve's byte for byte"] = all(
        np.array_equal(a, b) for a, b in zip(outs, serve["outs"]))
    checks["no upload"] = engine.adapter_stats()["uploads"] == 0.0
    e2e = dict(requests=len(prompts), admissions=engine.admissions,
               decode_steps=engine.decode_steps, launches=launches,
               checks=checks, **_timings(tm, [len(o) for o in outs]))
    log("serve.adapters.base", **e2e)
    _raise_failed("serve.adapters.base", checks)
    del engine
    torch.cuda.empty_cache()
    return e2e


def phase_serve_adapters_int8(params, cfg, reg, bf16_ad0):
    """serve.adapters.int8: wave 1 at weight_quant="int8" (the counts set
    to 0 before the install): the install runs the quantize kernel once
    a layer slice, every base product runs the dequant-matmul kernel
    (prefill on dqmm_ws, decode on dqmm_decode_tma) with the delta added
    after it, every request finishes, and the engine's first-decode
    logits of the ad0 request are within LOGITS_REL_TOL of the same
    decode functions on a dense bf16 tree of exactly the dequantized
    weights with the same adapter (serve.int8's oracle). Their distance
    to the bf16 adapter engine's is reported beside the same distance
    without an adapter (the int8 weights' own noise): not asserted."""
    from dlrover_tpu_torch.ops import _build
    from dlrover_tpu_torch.serving.engine import (
        ContinuousBatcher,
        _lora_operand,
    )

    max_new = 32
    prompts = _prompts(cfg)
    per_forward = 7 * cfg.n_layers + (0 if cfg.tie_embeddings else 1)
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    engine = ContinuousBatcher(
        cfg, params, n_slots=8, max_len=2048, max_new_tokens=max_new,
        chunk=8, kv_layout="paged", weight_quant="int8",
        adapter_registry=reg, adapter_cache_slots=ADAPTER_SLOTS)
    torch.cuda.synchronize()
    install = _build.launch_counts()["quant_int8"]
    seen = _watch_adapter_first_decodes(engine, ("ad0",))
    outs, tm = _serve(engine, prompts, max_new,
                      _wave_ids(WAVE1_IDS, len(prompts)))
    torch.cuda.synchronize()
    launches = _build.launch_counts()
    checks, by_variant = _check_path("serve.adapters.int8", engine,
                                     launches, cfg, "int8")
    checks.update({
        "every request finished": [len(o) for o in outs] == [max_new] * len(
            prompts),
        "quant_int8 at install == 225": install == per_forward,
        "weight_quant_path int8:kernel": (
            engine.weight_quant_path == "int8:kernel"),
    })
    e2e = dict(requests=len(prompts), admissions=engine.admissions,
               decode_steps=engine.decode_steps, launches=launches,
               dqmm_launches_by_variant=by_variant,
               quant_launches_at_install=install,
               adapter_stats=engine.adapter_stats(), checks=checks,
               **_timings(tm, [len(o) for o in outs]))
    qparams = engine.params
    ad = _lora_operand(engine._adapter_cache.bank, torch.tensor(
        [engine._adapter_cache.slot_of("ad0")], device="cuda"))
    del engine
    torch.cuda.empty_cache()
    prompt, got = seen["ad0"]
    if prompt != bf16_ad0[0]:
        raise AssertionError("serve.adapters.int8: another ad0 prompt")
    dense = _dequantized_tree(qparams)
    want = _first_decode_logits(cfg, dense, prompt, 2048, adapters=ad)[0]
    del dense
    torch.cuda.empty_cache()
    # the int8 weights' own distance from bf16, without an adapter
    base_q = _first_decode_logits(cfg, qparams, prompt, 2048)[0]
    base_b = _first_decode_logits(cfg, params, prompt, 2048)[0]
    e2e.update(
        ad0_vs_bf16_adapter_engine=(got - bf16_ad0[1]).abs().max().item(),
        base_int8_vs_bf16=(base_q - base_b).abs().max().item(),
        bf16_max_abs_logit=bf16_ad0[1].abs().max().item())
    log("serve.adapters.int8", **e2e)
    _raise_failed("serve.adapters.int8", checks)
    del qparams, ad, base_q, base_b
    torch.cuda.empty_cache()
    _check_first_decode(
        "serve.adapters.int8.ad0_first_decode_logits", got, want,
        "5% of the largest logit (serve.int8.first_decode_logits'): the "
        "same dequantized bf16 weights and the same bf16 delta on both "
        "sides; the f32 sums of 225 products a forward in another order, "
        "each rounded to bf16, carried through 32 layers",
    )
    return e2e


def _drain(engine):
    while engine.has_work():
        engine.step()


def phase_serve_refresh(params, cfg, tree_b, weight_quant="none"):
    """serve.refresh (bf16) or serve.refresh.int8: a live refresh with
    replay. serve's 12 prompts are submitted and stepped once; then
    update_params(B) commits at once (its wall time reported; int8: the
    quantize kernel once a layer slice of B), every live slot replays;
    every request finishes, the replays equal the live slots at the
    refresh, weight_version is 1, and REFRESH_AFTER prompts submitted
    after the drain give a fresh engine's streams on B byte for byte.
    The launch counts are set to 0 before the engine is built and read
    before the fresh engine runs. bf16 also runs the defer, raise and
    poisoned cases on small drains."""
    from dlrover_tpu_torch.ops import _build
    from dlrover_tpu_torch.serving.engine import ContinuousBatcher

    phase = "serve.refresh" + ("" if weight_quant == "none" else ".int8")
    max_new = 32
    prompts = _prompts(cfg)
    after = prompts[-REFRESH_AFTER:]
    per_forward = 7 * cfg.n_layers + (0 if cfg.tie_embeddings else 1)
    kw = dict(n_slots=8, max_len=2048, max_new_tokens=max_new, chunk=8,
              kv_layout="paged", weight_quant=weight_quant)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()
    engine = ContinuousBatcher(cfg, params, weight_refresh_mode="live", **kw)
    for p in prompts:
        engine.submit(p, max_new=max_new)
    engine.step()
    live = sum(1 for s in range(engine.n_slots)
               if engine.slot_req[s] is not None and not engine.done[s])
    torch.cuda.synchronize()
    before = _build.launch_counts()["quant_int8"]
    t0 = time.perf_counter()
    engine.update_params(tree_b)
    torch.cuda.synchronize()
    commit_s = time.perf_counter() - t0
    commit_quant = _build.launch_counts()["quant_int8"] - before
    _drain(engine)
    versions = [sorted(engine._requests[i].versions)
                for i in range(len(prompts))]
    outs = engine.generate_all([])
    outs_after = engine.generate_all(after)
    torch.cuda.synchronize()
    launches = _build.launch_counts()
    stats = engine.elastic_stats()
    checks, by_variant = _check_path(phase, engine, launches, cfg,
                                     weight_quant)
    del engine
    torch.cuda.empty_cache()
    fresh = ContinuousBatcher(cfg, tree_b, **kw)
    fresh_outs = fresh.generate_all(after)
    del fresh
    torch.cuda.empty_cache()
    checks.update({
        "every request finished": [len(o) for o in outs + outs_after]
        == [max_new] * (len(prompts) + len(after)),
        "replays == live slots at the refresh": (
            stats["replayed_requests"] == float(live) and live > 0),
        "weight_version == 1": stats["weight_version"] == 1.0,
        "one commit": stats["refresh_committed"] == 1.0,
        "streams after the commit equal a fresh engine's on B": all(
            np.array_equal(a, b) for a, b in zip(outs_after, fresh_outs)),
        "quantize launches at the commit": commit_quant == (
            0 if weight_quant == "none" else per_forward),
    })
    e2e = dict(requests=len(prompts) + len(after), live_at_refresh=live,
               commit_s=commit_s, commit_quant_launches=commit_quant,
               versions=versions, elastic_stats=stats, launches=launches,
               dqmm_launches_by_variant=by_variant,
               peak_mem_gb=torch.cuda.max_memory_allocated() / 2**30,
               checks=checks)
    if weight_quant == "none":
        e2e.update(_refresh_fences(cfg, params, tree_b, kw, prompts))
        checks.update(e2e.pop("fence_checks"))
    log(phase, **e2e)
    _raise_failed(phase, checks)
    return e2e


def _refresh_fences(cfg, params, tree_b, kw, prompts):
    """serve.refresh's other modes, each on 4 requests: defer (staged,
    the requests keep version 0, the commit lands at the idle fence and
    a later request has version 1), raise (RuntimeError mid-drain) and a
    poisoned tree (one leaf's shape changed: raises, version 0 keeps
    serving, rolled_back 1)."""
    from dlrover_tpu_torch.serving.engine import ContinuousBatcher

    checks = {}
    eng = ContinuousBatcher(cfg, params, weight_refresh_mode="defer", **kw)
    idx = [eng.submit(p) for p in prompts[:4]]
    eng.step()
    eng.update_params(tree_b)
    checks["defer: staged at version 0"] = eng.weight_version == 0
    _drain(eng)
    checks["defer: the drained requests ran at version 0"] = all(
        eng._requests[i].versions == {0} for i in idx)
    eng.step()   # the idle fence
    checks["defer: committed at the idle fence"] = eng.weight_version == 1
    later = eng.submit(prompts[4])
    _drain(eng)
    checks["defer: a later request ran at version 1"] = (
        eng._requests[later].versions == {1})
    defer_stats = eng.elastic_stats()
    del eng
    eng = ContinuousBatcher(cfg, params, weight_refresh_mode="raise", **kw)
    eng.submit(prompts[0])
    eng.step()
    try:
        eng.update_params(tree_b)
        checks["raise: refused mid-drain"] = False
    except RuntimeError:
        checks["raise: refused mid-drain"] = True
    del eng
    bad = dict(tree_b)
    bad["final_norm"] = {"scale": torch.ones(cfg.dim + 1, device="cuda",
                                             dtype=cfg.dtype)}
    eng = ContinuousBatcher(cfg, params, weight_refresh_mode="live", **kw)
    eng.submit(prompts[0])
    eng.step()
    try:
        eng.update_params(bad)
        checks["poisoned: raised"] = False
    except ValueError:
        checks["poisoned: raised"] = True
    checks["poisoned: version 0 serving, rolled back 1"] = (
        eng.weight_version == 0
        and eng.elastic_stats()["refresh_rolled_back"] == 1.0
        and eng.params is params)
    out = eng.generate_all([])
    checks["poisoned: the request finished"] = len(out[0]) == kw[
        "max_new_tokens"]
    del eng
    torch.cuda.empty_cache()
    return dict(defer_elastic_stats=defer_stats, fence_checks=checks)


def phase_adapters_and_refresh(params, cfg, serve):
    """The adapter and refresh phases in order; tree B lives only for
    the two refresh phases. -> {path: e2e}."""
    runs = {}
    runs["serve.adapters"], reg, _, ad0 = phase_serve_adapters(params, cfg,
                                                               serve)
    runs["serve.adapters.base"] = phase_serve_adapters_base(params, cfg,
                                                            serve, reg)
    runs["serve.adapters.int8"] = phase_serve_adapters_int8(params, cfg, reg,
                                                            ad0)
    del reg
    from dlrover_tpu_torch.models import llama

    tree_b = llama.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(REFRESH_SEED))
    runs["serve.refresh"] = phase_serve_refresh(params, cfg, tree_b)
    runs["serve.refresh.int8"] = phase_serve_refresh(params, cfg, tree_b,
                                                     "int8")
    del tree_b
    torch.cuda.empty_cache()
    return runs


def _pressure_prompts(cfg):
    """The pressure phases' traffic: 16 requests, one shared 512-token
    system prompt followed by 50-400 user tokens each (seed SEED + 3)."""
    rng = np.random.default_rng(SEED + 3)
    system = rng.integers(1, cfg.vocab_size, size=PRESSURE_SYSTEM).tolist()
    return [system + rng.integers(1, cfg.vocab_size, size=int(n)).tolist()
            for n in rng.integers(50, 401, size=PRESSURE_REQUESTS)]


def _pressure_reference(params, cfg, prompts):
    """The same prompts through the engine with no knob on the
    dense-equivalent pool: the greedy streams the two phases agree
    with (reported, not asserted: their warm and chunked prefills
    attend through the cached-attention path where a cold prefill uses
    flash, so bf16 rounding differs)."""
    from dlrover_tpu_torch.serving.engine import ContinuousBatcher

    engine = ContinuousBatcher(
        cfg, params, n_slots=8, max_len=2048, max_new_tokens=32, chunk=8,
        kv_layout="paged")
    outs, _ = _serve(engine, prompts, 32)
    del engine
    torch.cuda.empty_cache()
    return outs


def _published_pages(engine):
    return len({p for run in engine._row_pages.values() for p in run})


def phase_serve_pressure(params, cfg, prompts, ref_outs, prefill_chunk):
    """serve.prefix_pressure (prefill_chunk=0) or serve.prefill_chunk
    (prefill_chunk=256): the paged engine with the prefix cache on a
    pool of PRESSURE_PAGES pages (preemption fires), the launch counts
    set to 0 just before the run and read just after. The engine's own
    first-decode logits are held to a cold prefill of the same prompt:
    its first cold and first warm admission and, after the timed run, a
    full-hit admission (the system prompt alone) on the same engine; or
    its first chunked admission."""
    from dlrover_tpu_torch.ops import _build
    from dlrover_tpu_torch.serving.engine import ContinuousBatcher

    phase = "serve.prefill_chunk" if prefill_chunk else "serve.prefix_pressure"
    max_new = 32
    engine = ContinuousBatcher(
        cfg, params, n_slots=8, max_len=2048, max_new_tokens=max_new,
        chunk=8, kv_layout="paged", page_size=16, n_pages=PRESSURE_PAGES,
        swap_headroom=1, prefix_cache_rows=4, prefix_block=256,
        prefill_chunk=prefill_chunk)
    seen = _watch_first_decodes(engine)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()
    outs, tm = _serve(engine, prompts, max_new)
    torch.cuda.synchronize()
    launches = _build.launch_counts()
    lens = [len(o) for o in outs]
    if lens != [max_new] * len(prompts):
        raise AssertionError(f"{phase}: token counts {lens}, want {max_new}")
    toks = np.concatenate(outs)
    if toks.min() < 0 or toks.max() >= cfg.vocab_size:
        raise AssertionError(f"{phase}: token id out of the vocabulary")
    paged = engine.paged_stats()
    prefix = engine.prefix_cache.stats()
    prefill = engine.prefill_stats()
    engine.allocator.check()
    published = _published_pages(engine)
    # every admission, replays of preempted requests included, records
    # one hit or one miss; only a miss runs a cold prefill (flash, one
    # launch a layer): warm, full-hit and chunked admissions attend
    # through the cached-attention path
    want_flash = 0 if prefill_chunk else prefix["misses"] * cfg.n_layers
    checks = {
        "flash_fwd == want": launches["flash_fwd"] == want_flash,
        "paged >= decode_steps x layers": (
            launches["paged_attention"] >= engine.decode_steps * cfg.n_layers),
        "free == capacity - published": (
            engine.allocator.free_pages
            == engine.allocator.capacity - published),
        "swap_resumes == swap_preemptions": (
            paged["swap_resumes"] == paged["swap_preemptions"]),
    }
    if prefill_chunk:
        checks["prefill_chunks_total >= 1"] = prefill["prefill_chunks_total"] >= 1
    else:
        checks["swap_preemptions >= 1"] = paged["swap_preemptions"] >= 1
        checks["prefix hits >= 1"] = prefix["hits"] >= 1
    _check_wgmma(phase, launches)
    _check_paged_tma(phase, launches)
    same = sum(int(np.array_equal(a, b)) for a, b in zip(outs, ref_outs))
    e2e = dict(
        requests=len(prompts), prompt_lens=[len(p) for p in prompts],
        max_new=max_new, n_pages=PRESSURE_PAGES, prefill_chunk=prefill_chunk,
        admissions=engine.admissions, decode_steps=engine.decode_steps,
        launches=launches, want_flash=want_flash, paged_stats=paged,
        prefix_stats=prefix, prefill_stats=prefill,
        admission_stall_ms=prefill["admission_stall_ms"],
        published_pages=published, checks=checks,
        **_timings(tm, lens),
        greedy_streams_identical=same,
        greedy_token_agreement=float(
            np.mean(np.concatenate(outs) == np.concatenate(ref_outs))),
    )
    log(phase, **e2e)
    e2e["outs"] = outs
    if prefill_chunk:
        kinds = ["chunked"]
    else:
        # every surviving prefix row starts with the system prompt; its
        # last page is shared with the published run, so the full hit
        # copies it before the first decode step rewrites cell 511
        _serve(engine, [prompts[0][:PRESSURE_SYSTEM]], 2)
        cow = engine.paged_stats()["cow_copies"] - paged["cow_copies"]
        log(phase + ".full_hit", cow_copies=cow)
        checks["full hit copied its frontier page"] = cow >= 1
        kinds = ["cold", "warm", "full_hit"]
    del engine
    torch.cuda.empty_cache()
    _check_engine_first_decodes(phase, params, cfg, seen, kinds)
    failed = [name for name, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"{phase}: failed {failed}")
    return e2e


def _paged_first_decode(cfg, params, row, p, max_len):
    """Logits of the first decode step of prompt `p` whose K/V `row` (an
    exact cache row) holds: its cells installed into a page pool, one
    paged decode step at position len(p) - 1."""
    from dlrover_tpu_torch.models import decode as dec

    per_slot = max_len // 16
    table = torch.arange(1, per_slot + 1, dtype=torch.int32,
                         device="cuda")[None]
    pool = dec.init_page_pool(cfg, per_slot + 1, 16)
    dec.paged_install_row(pool, row, table[0], 0, max_len)
    logits, _ = dec.paged_decode_step(
        cfg, params, torch.tensor([p[-1]], device="cuda"), pool, table,
        torch.tensor([len(p) - 1], device="cuda"),
    )
    return logits


def _watch_first_decodes(engine):
    """Record, during a run, the engine's own first-decode logits (the
    step that samples a request's first token) for the first admission
    of each kind: "warm" (a prefix hit with a suffix prefill), "full_hit"
    (the whole prompt cached: copy-on-write of the frontier page, no
    prefill), "cold" and "chunked" (prefilled by interleaved chunks);
    without a prefix cache every admission is cold.
    The engine's `_admit`, `_flip_to_decode` and `_advance` are wrapped
    on the instance; the cost is one host check a step and one logits
    row copied for each kind. Returns {kind: (prompt, logits [V])}."""
    pc = engine.prefix_cache
    seen, pending = {}, {}
    admit, flip, advance = (engine._admit, engine._flip_to_decode,
                            engine._advance)

    def watch_admit(slot, req):
        before = pc.stats() if pc is not None else None
        admit(slot, req)
        if engine._prefilling[slot]:
            return  # a chunked admission: its first decode follows the flip
        if pc is None:   # no prefix cache: every admission is cold
            watch(slot, "cold")
            return
        after = pc.stats()
        reused = after["tokens_reused"] - before["tokens_reused"]
        if after["hits"] == before["hits"]:
            kind = "cold"
        else:
            kind = "full_hit" if reused >= len(req.prompt) else "warm"
        watch(slot, kind)

    def watch_flip(slot):
        flip(slot)
        watch(slot, "chunked")

    def watch(slot, kind):
        if kind not in seen and kind not in {k for k, _ in pending.values()}:
            pending[slot] = (kind, engine.slot_req[slot])

    def watch_advance(logits, tok, pos, done, limit):
        # a slot preempted before its first step (a later admission of
        # the same step reclaimed its pages) is dropped; its kind waits
        # for the next admission
        for slot, (kind, req) in pending.items():
            if engine.slot_req[slot] is req:
                seen[kind] = (req.prompt.tolist(),
                              logits[slot].float().clone())
        pending.clear()
        return advance(logits, tok, pos, done, limit)

    engine._admit = watch_admit
    engine._flip_to_decode = watch_flip
    engine._advance = watch_advance
    return seen


def _check_engine_first_decodes(phase, params, cfg, seen, want_kinds,
                                max_len=2048):
    """Each watched kind's first-decode logits from the engine against
    the same prompt admitted cold (one flash prefill of its bucket into
    a fresh pool, one paged decode step) within LOGITS_REL_TOL of the
    largest logit."""
    from dlrover_tpu_torch.models import decode as dec
    from dlrover_tpu_torch.serving.engine import _pad_bucket

    missing = [kind for kind in want_kinds if kind not in seen]
    if missing:
        raise AssertionError(f"{phase}: no {missing} admission was watched")
    for kind in want_kinds:
        prompt, got = seen[kind]
        bucket = min(_pad_bucket(len(prompt)), max_len)
        toks = torch.zeros(bucket, dtype=torch.long, device="cuda")
        toks[: len(prompt)] = torch.tensor(prompt, device="cuda")
        cold = dec.prefill_exact_row(cfg, params, toks, max_len)
        want = _paged_first_decode(cfg, params, cold, prompt, max_len)[0]
        del cold
        _check_first_decode(
            f"{phase}.{kind}_first_decode_logits", got, want,
            "5% of the largest logit: the engine's cells come from the "
            "cached-attention path (suffix and chunked prefills, f32 "
            "scores over the bf16 cache) or from an earlier request's "
            "flash prefill (shared pages) where the cold side runs one "
            "flash prefill of this prompt; bf16 roundings carried "
            "through the layers",
        )
    torch.cuda.empty_cache()


def _watch_swaps(engine, seen):
    """Wrap the engine's swap-out, swap-in and `_advance` on the
    instance. The first swapped request's pages are copied (on the card)
    just before its swap-out and just after its swap-in, for a byte
    comparison after the run, and the first decode step after any
    swap-in records its logits in `seen` as kind "swap_in" (the dict of
    `_watch_first_decodes`). Returns the page record."""
    swap_out, swap_in, advance = (engine._tier_swap_out_slot,
                                  engine._tier_swap_in, engine._advance)
    record, pending = {}, {}

    def pages(slot, n):
        run = engine._slot_pages[slot][:n]
        return {k: a[:, run].clone() for k, a in engine.page_pool.items()}

    def watch_out(slot, tokens):
        first = "req" not in record
        if first:
            n = (len(tokens) - 1) // engine.page_size + 1
            before = pages(slot, n)
            outs = engine.kv_tier.swap_outs
        swap_out(slot, tokens)
        if first and engine.kv_tier.swap_outs > outs:
            record.update(req=engine.slot_req[slot], n=n, before=before)

    def watch_in(slot, req, p):
        ok = swap_in(slot, req, p)
        if ok and record.get("req") is req and "after" not in record:
            record["after"] = pages(slot, record["n"])
        if ok and "swap_in" not in seen:
            pending[slot] = req
        return ok

    def watch_advance(logits, tok, pos, done, limit):
        for slot, req in pending.items():
            if engine.slot_req[slot] is req:
                seen["swap_in"] = (req.prompt.tolist(),
                                   logits[slot].float().clone())
        pending.clear()
        return advance(logits, tok, pos, done, limit)

    engine._tier_swap_out_slot = watch_out
    engine._tier_swap_in = watch_in
    engine._advance = watch_advance
    return record


def _tier_transfers(engine, cfg, params):
    """The tier's transfer functions at a TIER_VICTIM_TOKENS victim's
    size on the engine's pool (pages 1..n, read and written back with
    their own bytes): demotion (gather + copy into page-locked memory on
    the side stream, completed) and swap-in (non-blocking upload +
    scatter) wall times with the card synchronized around each, the
    first call apart (it allocates the page-locked blocks), and one cold
    re-prefill of a prompt of the same length (flash prefill of its
    1024 bucket + install into the pages), the replay a swap replaces."""
    from dlrover_tpu_torch.models import decode as dec
    from dlrover_tpu_torch.serving import kv_tier as kvt

    n = -(-TIER_VICTIM_TOKENS // engine.page_size)
    ids = list(range(1, n + 1))
    d2h, h2d = [], []
    for _ in range(TIER_TRANSFER_REPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        staged = kvt.snapshot_pages(engine.page_pool, ids)
        data = {k: kvt._fetch(v) for k, v in staged.items()}
        d2h.append((time.perf_counter() - t0) * 1e3)
        moved = sum(v.nbytes for v in data.values())
        ent = kvt.TierEntry(kind="swap", digest="", tokens=(), depth=0,
                            data=data, nbytes=moved, n_pages=n,
                            page_size=engine.page_size)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        kvt.upload_pages(engine.page_pool, ent, ids)
        torch.cuda.synchronize()
        h2d.append((time.perf_counter() - t0) * 1e3)
        del staged, data, ent
    victim = sum(a[:, :n].nbytes for a in engine.page_pool.values())
    rng = np.random.default_rng(SEED + 4)
    toks = np.zeros(1024, np.int64)
    toks[:TIER_VICTIM_TOKENS] = rng.integers(1, cfg.vocab_size,
                                             size=TIER_VICTIM_TOKENS)
    toks = torch.from_numpy(toks).to(engine.device)
    table = engine._table_row(ids)
    replay = []
    for _ in range(3):
        saved = {k: a[:, :n + 1].clone() for k, a in engine.page_pool.items()}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        row = dec.prefill_exact_row(cfg, params, toks, 2048)
        dec.paged_install_row(engine.page_pool, row, table, 0,
                              TIER_VICTIM_TOKENS)
        torch.cuda.synchronize()
        replay.append((time.perf_counter() - t0) * 1e3)
        del row
        for k, a in engine.page_pool.items():
            a[:, :n + 1] = saved[k]
    steady_d2h = float(np.median(d2h[1:]))
    steady_h2d = float(np.median(h2d[1:]))
    return dict(
        victim_tokens=TIER_VICTIM_TOKENS, victim_pages=n,
        victim_mb=victim / 1e6, moved_pages=kvt._bucket(n),
        moved_mb=moved / 1e6, d2h_first_ms=d2h[0], d2h_ms=steady_d2h,
        h2d_first_ms=h2d[0], h2d_ms=steady_h2d,
        d2h_gb_s=moved / steady_d2h / 1e6, h2d_gb_s=moved / steady_h2d / 1e6,
        replay_prefill_ms=float(np.median(replay)),
    )


def phase_serve_kv_tier(params, cfg, prompts, pressure, kv_quant=False):
    """serve.kv_tier (bf16 pages) or serve.kv_tier.int8kv (kv_quant):
    serve.prefix_pressure's engine and traffic with a host-DRAM KV tier
    of TIER_BYTES, the launch counts set to 0 just before the run and
    read just after. Checks: every request finishes; victims swapped out
    and every preempted request resumed; at least one prefix demotion
    and one prefix promotion; the first swapped request's pages read
    back after its swap-in are torch.equal to the pages copied before
    its swap-out; the first decode after a swap-in, and the engine's
    first cold admission's, within 5% of the largest logit of the same
    prompt prefilled cold on a pool that never preempts; every flash
    forward on the wgmma variant, every paged launch on the TMA-ring
    kernel (.int8kv: on its int8-pool variant). Reports the bytes each
    way, the transfer rates at a 600-token victim, the time completing
    the demotion copies waited, the admission stall beside
    serve.prefix_pressure's, TTFT / TPOT / tokens/s and the greedy
    agreement with serve.prefix_pressure's streams."""
    from dlrover_tpu_torch.ops import _build
    from dlrover_tpu_torch.serving.engine import ContinuousBatcher

    phase = "serve.kv_tier" + (".int8kv" if kv_quant else "")
    max_new = 32
    engine = ContinuousBatcher(
        cfg, params, n_slots=8, max_len=2048, max_new_tokens=max_new,
        chunk=8, kv_layout="paged", page_size=16, n_pages=PRESSURE_PAGES,
        swap_headroom=1, prefix_cache_rows=4, prefix_block=256,
        kv_quant=kv_quant, kv_tier_bytes=TIER_BYTES)
    seen = _watch_first_decodes(engine)
    record = _watch_swaps(engine, seen)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()
    outs, tm = _serve(engine, prompts, max_new)
    torch.cuda.synchronize()
    launches = _build.launch_counts()
    lens = [len(o) for o in outs]
    if lens != [max_new] * len(prompts):
        raise AssertionError(f"{phase}: token counts {lens}, want {max_new}")
    toks = np.concatenate(outs)
    if toks.min() < 0 or toks.max() >= cfg.vocab_size:
        raise AssertionError(f"{phase}: token id out of the vocabulary")
    tier = engine.kv_tier_stats()
    transfer = engine.kv_tier.transfer_stats()
    paged = engine.paged_stats()
    prefix = engine.prefix_cache.stats()
    prefill = engine.prefill_stats()
    engine.allocator.check()
    round_trip = ("after" in record and all(
        torch.equal(record["before"][k], record["after"][k])
        for k in record["before"]))
    want_flash = prefix["misses"] * cfg.n_layers
    checks = {
        "flash_fwd == misses x layers": launches["flash_fwd"] == want_flash,
        "paged >= decode_steps x layers": (
            launches["paged_attention"] >= engine.decode_steps * cfg.n_layers),
        "swap_outs > 0": tier["swap_outs"] > 0,
        "swap_resumes == swap_preemptions": (
            paged["swap_resumes"] == paged["swap_preemptions"]),
        "prefix demotions >= 1": tier["demotions"] - tier["swap_outs"] >= 1,
        "prefix promotions >= 1": tier["promotions"] - tier["swap_ins"] >= 1,
        "pages_promoted > 0": paged["pages_promoted"] > 0,
        "swapped pages round-trip equal": round_trip,
    }
    if kv_quant:
        checks["every paged launch on the int8-pool TMA variant"] = (
            launches["paged_attention_tma_int8"]
            == launches["paged_attention"])
    _check_wgmma(phase, launches)
    _check_paged_tma(phase, launches)
    rates = _tier_transfers(engine, cfg, params)
    ref = pressure["outs"]
    e2e = dict(
        requests=len(prompts), max_new=max_new, n_pages=PRESSURE_PAGES,
        kv_quant=kv_quant, tier_bytes=TIER_BYTES,
        admissions=engine.admissions, decode_steps=engine.decode_steps,
        launches=launches, want_flash=want_flash, kv_tier_stats=tier,
        transfer_stats=transfer, paged_stats=paged, prefix_stats=prefix,
        admission_stall_ms=prefill["admission_stall_ms"],
        pressure_admission_stall_ms=pressure["admission_stall_ms"],
        swap_round_trip_mb=(sum(v.nbytes for v in record["before"].values())
                            / 1e6 if "before" in record else 0.0),
        transfers=rates, checks=checks, **_timings(tm, lens),
        greedy_streams_identical=sum(
            int(np.array_equal(a, b)) for a, b in zip(outs, ref)),
        greedy_token_agreement=float(
            np.mean(np.concatenate(outs) == np.concatenate(ref))),
    )
    log(phase, **e2e)
    del engine, record
    torch.cuda.empty_cache()
    _check_engine_first_decodes(phase, params, cfg, seen,
                                ["cold", "swap_in"])
    _raise_failed(phase, checks)
    return e2e


def _watch_adoptions(dec, handoff, record):
    """Wrap serving/handoff.adopt_into_slot (the engine looks it up at
    each adoption) for the run: each adoption timed with the card
    synchronized around it; the first one's installed pages compared
    with the shipped cells, and the decode engine's first decode step
    after it recorded. Returns the restore function."""
    real, advance = handoff.adopt_into_slot, dec._advance
    pending = {}

    def adopt(engine, slot, pkg):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        real(engine, slot, pkg)
        torch.cuda.synchronize()
        record["adopt_ms"].append((time.perf_counter() - t0) * 1e3)
        if "pages_equal" not in record:
            run = engine._slot_pages[slot][:pkg.n_ship]
            record["pages_equal"] = all(
                torch.equal(arr[:, run],
                            pkg.data[name][:, :pkg.n_ship].to(arr.device))
                for name, arr in engine.page_pool.items())
            pending[slot] = pkg.prompt.tolist()

    def watch_advance(logits, tok, pos, done, limit):
        for slot, prompt in pending.items():
            record["first_decode"] = (prompt, logits[slot].float().clone())
        pending.clear()
        return advance(logits, tok, pos, done, limit)

    handoff.adopt_into_slot = adopt
    dec._advance = watch_advance

    def restore():
        handoff.adopt_into_slot = real

    return restore


def _handoff_run(params, cfg, prompts, max_new, transport):
    """One prefill + decode pair on the card over `transport`: the
    prefill engine admits (and never decodes), each finished prefill is
    exported, retired and adopted by the decode engine. Host transport:
    kv_checksums=1 and a corrupt_kv plan flips a byte of the first
    package; the loop's ingress check (the coordinator's) quarantines
    it and the request replays on the prefill engine."""
    from collections import Counter

    from dlrover_tpu_torch.ops import _build
    from dlrover_tpu_torch.serving import handoff
    from dlrover_tpu_torch.serving.chaos import FaultInjector
    from dlrover_tpu_torch.serving.engine import ContinuousBatcher
    from dlrover_tpu_torch.serving.health import kv_checksum, verify_checksum

    host = transport == "host"
    fi = FaultInjector(seed=SEED)
    if host:
        fi.corrupt_kv("prefill", where="handoff", at_step=0)
    kw = dict(n_slots=8, max_len=2048, max_new_tokens=max_new, chunk=8,
              kv_layout="paged", kv_checksums=int(host), chaos=fi)
    pre = ContinuousBatcher(cfg, params, replica_role="prefill",
                            chaos_tag="prefill", **kw)
    dec = ContinuousBatcher(cfg, params, replica_role="decode",
                            chaos_tag="decode", **kw)
    record = {"adopt_ms": []}
    restore = _watch_adoptions(dec, handoff, record)
    pre_l, dec_l = Counter(), Counter()

    def stepped(engine, into):
        before = _build.launch_counts()
        events = engine.step()
        for k, v in _build.launch_counts().items():
            into[k] += v - before[k]
        return events

    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        owner = {pre.submit(p, max_new=max_new): i
                 for i, p in enumerate(prompts)}
        dec_owner, export_ms, shipped = {}, [], 0
        quarantined, last_pkg = 0, None
        first, last = {}, {}
        count = {i: 0 for i in range(len(prompts))}
        while pre.has_work() or dec.has_work():
            stepped(pre, pre_l)
            for req in pre.take_prefilled():
                t1 = time.perf_counter()
                pkg = handoff.export_run(pre, req.idx, transport=transport)
                torch.cuda.synchronize()
                export_ms.append((time.perf_counter() - t1) * 1e3)
                pre.retire(req.idx)
                who = owner.pop(req.idx)
                if pkg.checksum and not verify_checksum(pkg.data,
                                                        pkg.checksum):
                    quarantined += 1
                    owner[pre.submit(pkg.prompt, max_new=pkg.max_new,
                                     prng_key=pkg.prng_key)] = who
                    continue
                dec_owner[dec.submit_adopted(pkg)] = who
                shipped += pkg.nbytes
                last_pkg = pkg
            events = stepped(dec, dec_l)
            now = time.perf_counter()
            for idx, toks, _fin in events:
                if toks:
                    who = dec_owner[idx]
                    first.setdefault(who, now)
                    last[who] = now
                    count[who] += len(toks)
        wall = time.perf_counter() - t0
    finally:
        restore()
    done = dec.generate_all([])
    outs = [None] * len(prompts)
    for idx, o in zip(sorted(dec_owner), done):
        outs[dec_owner[idx]] = o
    checksum_ms_per_mb = None
    if host:
        mb = last_pkg.nbytes / 1e6
        reps = []
        for _ in range(3):
            t1 = time.perf_counter()
            kv_checksum(last_pkg.data)
            reps.append((time.perf_counter() - t1) * 1e3)
        checksum_ms_per_mb = float(np.median(reps)) / mb
    lens = [len(o) for o in outs]
    tm = dict(first=first, last=last, count=count, wall=wall, t0=t0)
    health = dec.health_stats()
    checks = {
        "decode engine: no flash launch": dec_l["flash_fwd"] == 0,
        "decode engine: paged launches": dec_l["paged_attention"] > 0,
        "decode engine: paged all TMA": (
            dec_l["paged_attention_tma"] == dec_l["paged_attention"]),
        "prefill engine: no paged launch": pre_l["paged_attention"] == 0,
        "prefill engine: flash == admissions x layers": (
            pre_l["flash_fwd"] == pre.admissions * cfg.n_layers),
        "prefill engine: flash all wgmma": (
            pre_l["flash_fwd_wgmma"] == pre_l["flash_fwd"]),
        "pages_adopted > 0": dec.allocator.pages_adopted > 0,
        "shipped pages equal installed": record.get("pages_equal") is True,
        "allocators empty": (pre.allocator.used_pages == 0
                             and dec.allocator.used_pages == 0),
        "every request finished": lens == [max_new] * len(prompts),
    }
    if host:
        checks["one package quarantined"] = quarantined == 1 and any(
            f[0] == "corrupt" for f in fi.fired)
        checks["decode ingress verified every package"] = (
            health.get("integrity_checks") == len(prompts)
            and health.get("integrity_quarantines") == 0)
    e2e = dict(
        transport=transport, requests=len(prompts), max_new=max_new,
        prefill_admissions=pre.admissions, decode_admissions=dec.admissions,
        decode_steps=dec.decode_steps, quarantined=quarantined,
        replays=quarantined, pages_adopted=dec.allocator.pages_adopted,
        shipped_mb=shipped / 1e6, export_ms_mean=float(np.mean(export_ms)),
        export_ms_max=float(np.max(export_ms)),
        adopt_ms_mean=float(np.mean(record["adopt_ms"])),
        adopt_ms_max=float(np.max(record["adopt_ms"])),
        kv_checksum_ms_per_mb=checksum_ms_per_mb,
        prefill_launches=dict(pre_l), decode_launches=dict(dec_l),
        launches={k: pre_l[k] + dec_l[k] for k in _build.launch_counts()},
        decode_health=health, checks=checks, **_timings(tm, lens),
    )
    first_decode = record.get("first_decode")
    del pre, dec, record
    torch.cuda.empty_cache()
    return e2e, outs, first_decode


def phase_serve_handoff(params, cfg, serve):
    """serve.handoff: two engines on one card sharing the served
    weights, replica_role "prefill" and "decode"; serve's 12 requests go
    prefill -> take_prefilled -> export_run -> submit_adopted, once over
    the "device" transport and once over "host" with kv_checksums=1 and
    one package corrupted in transit (quarantined, replayed). Each run
    checks (`_handoff_run`) the phase split from the launch counts of
    each engine's own steps, the adoption, the shipped bytes against the
    installed pages, and the first decode after an adoption within 5% of
    the largest logit of the colocated engine's path (a cold flash
    prefill of the same prompt and one paged decode step). Reports
    export and adopt ms per request, kv_checksum ms per MB, TTFT, TPOT
    and the greedy agreement with serve's streams."""
    max_new, prompts = 32, _prompts(cfg)
    runs = {}
    for transport in ("device", "host"):
        phase = f"serve.handoff.{transport}"
        torch.cuda.reset_peak_memory_stats()
        e2e, outs, first_decode = _handoff_run(params, cfg, prompts,
                                               max_new, transport)
        e2e.update(
            greedy_streams_identical=sum(
                int(np.array_equal(a, b)) for a, b in zip(outs, serve["outs"])),
            greedy_token_agreement=float(np.mean(
                np.concatenate(outs) == np.concatenate(serve["outs"]))))
        log(phase, **e2e)
        if first_decode is None:
            raise AssertionError(f"{phase}: no adoption was watched")
        prompt, got = first_decode
        _check_first_decode(
            f"{phase}.first_decode_logits", got,
            _first_decode_logits(cfg, params, prompt, 2048)[0],
            "5% of the largest logit: the adopted cells come from the "
            "prefill engine's flash prefill of the prompt's bucket, the "
            "colocated side prefills its 1024 bucket; bf16 roundings "
            "carried through 32 layers")
        _raise_failed(phase, e2e["checks"])
        runs[phase] = e2e
    return runs


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


def _smoke_out():
    import os

    return os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "smoke_out")


def _train_setup(optimizer, fused_ce=False, n_layers=TRAIN_LAYERS,
                 microbatch=TRAIN_MICROBATCH, lora_cfg=None):
    """The train phases' model, ElasticTrainer over `optimizer` (a
    factory), batch and the generator to draw the params from next:
    every phase draws the tokens and then the params from one fixed
    seed, so all start from the same point (train.dp's two-rank run
    cuts the depth to `n_layers` and the largest replica batch to
    `microbatch`; with a `lora_cfg` the adapters are injected after the
    base is drawn, from the same generator, so the base is train's).
    The ElasticTrainer trains over the world this process joined, if
    any. The Trainer's step and card metrics files are pointed into
    smoke_out/ beside this script."""
    import os

    from dlrover_tpu_torch.models import llama, lora
    from dlrover_tpu_torch.trainer.elastic.trainer import ElasticTrainer

    out = _smoke_out()
    os.environ["DLROVER_TPU_RUNTIME_METRICS_PATH"] = os.path.join(
        out, "runtime_metrics.json")
    os.environ["DLROVER_TPU_CHIP_METRICS_PATH"] = os.path.join(
        out, "chip_metrics.json")
    cfg = llama.LlamaConfig.llama3_8b(n_layers=n_layers, fused_ce=fused_ce)
    assert cfg.remat and cfg.remat_policy == "full"
    gen = torch.Generator(device="cuda").manual_seed(TRAIN_SEED)
    tokens = torch.randint(0, cfg.vocab_size,
                           (TRAIN_GLOBAL_BATCH, TRAIN_SEQ + 1),
                           generator=gen, device="cuda")

    def init(g):
        params = llama.init_params(cfg, g, dtype=cfg.param_dtype)
        if lora_cfg is not None:
            params = lora.inject(cfg, params, lora_cfg, g)[1]
        return params

    if lora_cfg is not None:
        cfg = dataclasses.replace(cfg, lora_alpha=lora_cfg.alpha)
    et = ElasticTrainer(
        init,
        lambda p, b: llama.loss_fn(cfg, p, b),
        optimizer,
        global_batch_size=TRAIN_GLOBAL_BATCH,
        max_per_replica_batch=microbatch,
    )
    return cfg, et, tokens, gen


def _timed_steps(opt):
    """Record the wall time of each `opt.step()`, synchronised before
    and after on the training stream (the list it returns fills as the
    Trainer steps). Step hooks, not a wrapper bound to `opt`: a closure
    over the optimizer stored on it would be a reference cycle, and the
    optimizer (params and moments) would outlive its phase until a
    garbage collection."""
    times, start = [], []

    def pre(optimizer, args, kwargs):
        torch.cuda.current_stream().synchronize()
        start.append(time.perf_counter())

    def post(optimizer, args, kwargs):
        torch.cuda.current_stream().synchronize()
        times.append(time.perf_counter() - start[-1])

    opt.register_step_pre_hook(pre)
    opt.register_step_post_hook(post)
    return times


def _state_bytes(opt):
    """Bytes of the tensors an optimizer's state holds."""
    return sum(t.numel() * t.element_size() for st in opt.state.values()
               for t in st.values() if torch.is_tensor(t))


def _run_trainer(cfg, et, state, tokens, phase, checkpointer=None,
                 output_dir=None):
    """TRAIN_STEPS Trainer steps on the one batch, with the launch counts
    set to 0 just before and read just after: the flash kernels must
    have run exactly as often as the path calls them (every forward and
    backward launch on its wgmma variant) and the losses
    must be finite and fall. With a `checkpointer` the Trainer saves
    to memory every CKPT_SAVE_STEPS steps and to disk at the end.
    Returns the phase's numbers (and the Trainer's launch counts)
    without logging them."""
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
    if checkpointer is None:
        args = TrainingArguments(max_steps=TRAIN_STEPS, logging_steps=1,
                                 save_steps=0, resume=False)
    else:
        args = TrainingArguments(
            output_dir=output_dir, max_steps=TRAIN_STEPS, logging_steps=1,
            save_steps=CKPT_SAVE_STEPS, save_storage="memory",
            resume=False)
    trainer = Trainer(
        et, args, train_data=[{"tokens": tokens}] * TRAIN_STEPS,
        callbacks=[rec], checkpointer=checkpointer,
    )
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    state = trainer.train(state)
    torch.cuda.current_stream().synchronize()   # not a staging's stream
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


def _lora_config():
    from dlrover_tpu_torch.models import lora

    return lora.LoraConfig(rank=LORA_RANK, alpha=LORA_ALPHA,
                           targets=LORA_TARGETS)


def _adapter_count(cfg):
    """Adapter params of `_lora_config()` on `cfg`: r x (in + out) per
    target and layer."""
    widths = {"wq": (cfg.dim, cfg.n_heads * cfg.head_dim),
              "wk": (cfg.dim, cfg.n_kv_heads * cfg.head_dim),
              "wv": (cfg.dim, cfg.n_kv_heads * cfg.head_dim),
              "wo": (cfg.n_heads * cfg.head_dim, cfg.dim)}
    return cfg.n_layers * LORA_RANK * sum(sum(widths[t])
                                          for t in LORA_TARGETS)


def _lora_state_keys(state):
    """The keys JAX's `flatten_state` gives a train state of this tree
    under `lora_optimizer(optax.adamw(...))`: the params, the step, and
    the inner transform's count and moments of the adapter leaves only
    (tests/test_torch_lora_train.py holds the port's keys to JAX's)."""
    from dlrover_tpu_torch.models import lora
    from dlrover_tpu_torch.trainer.flash_checkpoint.engine import (
        state_leaves,
    )

    pre = "opt_state/inner_states/lora/inner_state/0/"
    params = state_leaves(state["params"])
    return ({"params/" + p for p in params} | {"step", pre + "count"}
            | {f"{pre}{m}/{p}" for m in ("mu", "nu") for p in params
               if lora.is_adapter_path(p)})


def phase_train_lora(train):
    """`train` with LoRA: the same model, base params, tokens and steps,
    with `lora.inject(rank 16, alpha 32, wq/wk/wv/wo)` after the base is
    drawn and `lora_optimizer(AdamW(lr 1e-4, weight decay 1e-4))`: the
    8 Trainer steps with the launch counts set to 0 just before and read
    just after (exact flash counts, all wgmma). Checks: every base leaf
    bit-equal after the steps, wq_lora_b moved, the loss fell, the train
    state's keys are JAX's for this optimizer (no moment for a frozen
    leaf), and the adapter-only checkpoint (`save_to_storage` of
    `adapter_state_dict`, a fresh engine's `load`, `load_adapters` onto
    the base injected afresh from another seed) gives logits on one
    microbatch bit-equal to the trained params'. The checkpoint
    directory and segments are removed in a `finally`."""
    import os
    import shutil

    from dlrover_tpu_torch.agent.ckpt_saver import shm_segment_paths
    from dlrover_tpu_torch.models import llama, lora
    from dlrover_tpu_torch.trainer.flash_checkpoint import CheckpointEngine
    from dlrover_tpu_torch.trainer.flash_checkpoint.engine import (
        state_leaves,
    )

    lc = _lora_config()
    cfg, et, tokens, gen = _train_setup(lora.lora_optimizer(_adamw),
                                        lora_cfg=lc)
    state = et.init_state(gen)
    params = state["params"]
    b0 = params["layers"]["wq_lora_b"].detach().clone()
    opt = state["opt_state"]
    e2e = _run_trainer(cfg, et, state, tokens, "train.lora")
    # the base drawn again from the seed (a copy held through the steps
    # would count in their peak)
    _, _, _, gen = _train_setup(_adamw)
    base = state_leaves(llama.init_params(cfg, gen, dtype=cfg.param_dtype))
    leaves = state_leaves(params)
    n_adapter = _adapter_count(cfg)
    checks = dict(
        base_bit_equal=all(torch.equal(leaves[p], t)
                           for p, t in base.items()),
        wq_lora_b_moved=not torch.equal(params["layers"]["wq_lora_b"], b0),
        loss_fell=e2e["losses"][-1] < e2e["losses"][0],
        jax_state_keys=set(state_leaves(state)) == _lora_state_keys(state),
        adapter_count=sum(t.numel() for p, t in leaves.items()
                          if lora.is_adapter_path(p)) == n_adapter,
        moments_adapters_only=len(opt.state) == 2 * len(LORA_TARGETS),
    )
    del base, b0, leaves

    # the adapter-only checkpoint through the flash checkpoint engine
    root = os.path.join(_smoke_out(), f"lora-{os.getpid()}")
    jobs = [f"chip-smoke-lora-{os.getpid()}-{i}" for i in range(2)]
    rt = {}
    try:
        eng = CheckpointEngine(root, job_name=jobs[0])
        try:
            t0 = time.perf_counter()
            eng.save_to_storage(TRAIN_STEPS, lora.adapter_state_dict(params))
            checks["adapters_persisted"] = eng.wait_for_persist(
                TRAIN_STEPS, timeout=120)
            rt["save_s"] = time.perf_counter() - t0
            rt["staged_bytes"] = eng.last_staged_bytes
        finally:
            eng.close()
        eng = CheckpointEngine(root, job_name=jobs[1])
        try:
            t0 = time.perf_counter()
            step, restored = eng.load(device="cuda")
            rt["load_s"] = time.perf_counter() - t0
            rt["source"] = eng.last_load_source
        finally:
            eng.close()
        checks["adapters_restored_step"] = step == TRAIN_STEPS
        frozen = {k: v for k, v in params.items() if k != "layers"}
        frozen["layers"] = {k: v for k, v in params["layers"].items()
                            if not lora.is_adapter_path(k)}
        fresh = lora.inject(cfg, frozen, lc, torch.Generator(
            device="cuda").manual_seed(TRAIN_SEED + 7))[1]
        reloaded = lora.load_adapters(fresh, restored)
        micro = tokens[:TRAIN_MICROBATCH]
        with torch.no_grad():
            want = llama.apply(cfg, params, micro)
            got = llama.apply(cfg, reloaded, micro)
            checks["adapter_roundtrip_logits_bit_equal"] = torch.equal(
                got, want)
            rt["logits_max_abs_diff"] = (got - want).abs().max().item()
        del want, got, fresh, reloaded, restored
    finally:
        for job in jobs:
            for path in shm_segment_paths(job):
                if os.path.exists(path):
                    os.unlink(path)
        shutil.rmtree(root, ignore_errors=True)
    moment_bytes = _state_bytes(opt)
    e2e.update(
        lora=dict(rank=lc.rank, alpha=lc.alpha, targets=list(lc.targets)),
        adapter_params=n_adapter, moment_bytes=moment_bytes,
        adamw_moment_bytes=train["opt_state_bytes"],
        moment_bytes_ratio=moment_bytes / train["opt_state_bytes"],
        adamw_median_step_s=train["median_step_s"],
        step_ratio=e2e["median_step_s"] / train["median_step_s"],
        adamw_peak_mem_gb=train["peak_mem_gb"],
        adapter_checkpoint=rt, checks=checks)
    log("train.lora", **e2e)
    if not all(checks.values()):
        raise AssertionError(f"train.lora: failed checks {checks}")
    del state, et, opt, params
    torch.cuda.empty_cache()
    return e2e


def _rl_prompts(cfg):
    """RL_PROMPTS prompts of 32-192 random tokens (numpy seed RL_SEED)
    in a [B, RL_MAX_LEN] buffer, and their lengths."""
    rng = np.random.default_rng(RL_SEED)
    lens = rng.integers(RL_PROMPT_LENS[0], RL_PROMPT_LENS[1] + 1,
                        size=RL_PROMPTS)
    prompts = np.zeros((RL_PROMPTS, RL_MAX_LEN), np.int64)
    for b, n in enumerate(lens):
        prompts[b, :n] = rng.integers(0, cfg.vocab_size, size=n)
    return (torch.from_numpy(prompts).cuda(),
            torch.from_numpy(lens.astype(np.int64)).cuda())


def phase_rl_ppo(train):
    """PPO over a LoRA actor, rolled out through the continuous batcher
    (`PpoTrainer(rollout_engine="continuous")`): the actor is `train`'s
    model and base params (f32 storage, bf16 compute, remat "full")
    with `train.lora`'s adapters and `lora_optimizer(Adam 1e-4)`; the
    ref is the default detached copy; the critic is JAX's test critic
    (embedding -> value, tests/test_rl_ppo.py) at width 4096 and vocab
    128256, its value head drawn from the seed (JAX's zeros would leave
    every advantage 0 on the first rollout: no target token drawn, no
    KL yet); the reward +1 per generated RL_TARGET. RL_PROMPTS prompts of
    32-192 tokens, max_len 256, temperature 1, minibatch 4, 2 epochs,
    kl_coef 0.1, two `step`s (the second rollout goes through
    `update_params`), with the launch counts set to 0 just before and
    read just after. Checks: the rows keep their prompts, tokens in
    vocab, every metric finite, the actor's base bit-equal to the ref's
    copy and its adapters moved, exact flash launches all on wgmma, and
    (deciding) the engine's own first-decode logits of step 2's first
    request within 5% of the largest logit of `llama.apply` on the
    actor's params after step 1. After the path: greedy rollouts of the
    same prompts through the continuous engine and the lockstep cached
    sampler (rows equal, reported: bf16 on two paths may flip a near
    tie), and one decode step timed on the actor's f32 tree and on a
    bf16 copy."""
    from dlrover_tpu_torch.models import decode as dec
    from dlrover_tpu_torch.models import llama, lora
    from dlrover_tpu_torch.ops import _build
    from dlrover_tpu_torch.rl import ModelEngine, PpoConfig, PpoTrainer
    from dlrover_tpu_torch.rl.generate import sample_tokens_cached
    from dlrover_tpu_torch.rl.model_engine import ModelSpec
    from torch.utils._pytree import tree_map

    lc = _lora_config()
    cfg = llama.LlamaConfig.llama3_8b(n_layers=TRAIN_LAYERS,
                                      lora_alpha=lc.alpha)
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(TRAIN_SEED)
    # the train phases draw their tokens first: the same base follows
    torch.randint(0, cfg.vocab_size, (TRAIN_GLOBAL_BATCH, TRAIN_SEQ + 1),
                  generator=gen, device="cuda")
    actor = lora.inject(cfg, llama.init_params(cfg, gen,
                                               dtype=cfg.param_dtype),
                        lc, gen)[1]
    critic = {"embed": torch.randn((cfg.vocab_size, cfg.dim), generator=gen,
                                   device="cuda") * 0.1,
              "v": torch.randn((cfg.dim,), generator=gen,
                               device="cuda") * 0.1}

    def reward(tokens, prompt_lens):
        pos = torch.arange(tokens.shape[1], device=tokens.device)[None, :]
        return ((tokens == RL_TARGET)
                & (pos >= prompt_lens[:, None])).sum(dim=1).float()

    engine = ModelEngine(
        actor=ModelSpec(lambda p, t: llama.apply(cfg, p, t), actor,
                        trainable=True, model_cfg=cfg),
        critic=ModelSpec(lambda p, t: p["embed"][t] @ p["v"], critic,
                         trainable=True),
        reward_fn=reward)
    ppo_cfg = PpoConfig(max_len=RL_MAX_LEN, temperature=1.0,
                        minibatch_size=RL_MINIBATCH, epochs=RL_EPOCHS,
                        kl_coef=RL_KL, rollout_engine="continuous")
    trainer = PpoTrainer(
        engine, ppo_cfg, actor_opt=lora.lora_optimizer(
            lambda ps: torch.optim.Adam(ps, lr=1e-4, betas=(0.9, 0.999),
                                        eps=1e-8)),
        device="cuda")
    prompts, lens = _rl_prompts(cfg)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0

    # host-clock instruments around the trainer's own methods
    rec = {"rollout_s": [], "experience_s": [], "update_s": [], "exps": [],
           "engine": [], "ratio_mean": []}
    rollout, make_exp, update = (trainer._continuous_rollout,
                                 trainer.make_experience, trainer._update_fn)

    def timed(fn, key):
        def run(*a, **kw):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            rec[key].append(time.perf_counter() - t)
            return out
        return run

    def timed_rollout(*a, **kw):
        out = timed(rollout, "rollout_s")(*a, **kw)
        cb = trainer._cb
        rec["engine"].append(dict(
            admissions=cb.admissions, decode_steps=cb.decode_steps,
            weight_version=cb.weight_version,
            prefill=cb.prefill_stats(), step_stats=cb.step_stats()))
        return out

    def recorded_update(batch):
        m = timed(update, "update_s")(batch)
        rec["ratio_mean"].append(float(m["ratio_mean"]))
        return m

    def recorded_experience(*a, **kw):
        exp = timed(make_exp, "experience_s")(*a, **kw)
        rec["exps"].append(exp)
        return exp

    trainer._continuous_rollout = timed_rollout
    trainer.make_experience = recorded_experience
    trainer._update_fn = recorded_update

    adapter_keys = [k for k in actor["layers"] if lora.is_adapter_path(k)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    metrics = [trainer.step(prompts, lens, torch.Generator(
        device="cuda").manual_seed(RL_SEED))]
    after1 = {k: actor["layers"][k].detach().clone() for k in adapter_keys}
    seen = _watch_first_decodes(trainer._cb)
    metrics.append(trainer.step(prompts, lens, torch.Generator(
        device="cuda").manual_seed(RL_SEED + 1)))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _build.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30

    exps = rec["exps"]
    n_mb = RL_EPOCHS * (RL_PROMPTS // RL_MINIBATCH)
    admissions = rec["engine"][-1]["admissions"]
    layers = cfg.n_layers
    want = dict(
        flash_fwd=layers * (admissions + RL_STEPS * (2 + 2 * n_mb)),
        flash_bwd_dq=layers * RL_STEPS * n_mb,
        flash_bwd_dkv=layers * RL_STEPS * n_mb)
    p_np, l_np = prompts.cpu().numpy(), lens.cpu().numpy()
    generated = [int(e.mask.sum()) for e in exps]
    ref = engine.ref.params
    frozen = [k for k in actor["layers"] if not lora.is_adapter_path(k)]
    prompt_kept = all(np.array_equal(e.tokens[b, :n], p_np[b, :n])
                      for e in exps for b, n in enumerate(l_np))

    # the deciding check: the engine served the actor updated by step 1
    first_prompt, lk = seen["cold"]
    with torch.no_grad():
        p1 = lora.load_adapters(actor, {"layers": after1})
        tok = torch.tensor([first_prompt], device="cuda")
        lr = llama.apply(cfg, p1, tok)[0, -1]
        l0 = llama.apply(cfg, ref, tok)[0, -1]
    served = dict(
        prompt_len=len(first_prompt),
        max_abs_err=(lk - lr).abs().max().item(),
        ref_max_abs=lr.abs().max().item(),
        tol=LOGITS_REL_TOL * lr.abs().max().item(),
        argmax_equal=bool(lk.argmax() == lr.argmax()),
        vs_initial_actor_max_abs=(lk - l0).abs().max().item(),
        tol_reason="bf16 compute on both sides; the engine's decode "
                   "step recomputes the last prompt token over its "
                   "cache where apply runs the whole prompt through "
                   "flash")
    del p1, lr, l0
    checks = dict(
        launches_exact=all(launches[k] == v for k, v in want.items()),
        wgmma=all(launches[f"{k}_wgmma"] == launches[k] for k in want),
        rows_keep_prompts=prompt_kept,
        tokens_in_vocab=all(0 <= e.tokens.min() and e.tokens.max()
                            < cfg.vocab_size for e in exps),
        metrics_finite=all(np.isfinite(v) for m in metrics
                           for v in m.values()),
        base_bit_equal_to_ref=all(torch.equal(actor["layers"][k],
                                              ref["layers"][k])
                                  for k in frozen)
        and all(torch.equal(actor[k][n], ref[k][n])
                for k in ("embed", "final_norm", "lm_head")
                for n in actor[k]),
        adapters_moved=all(not torch.equal(actor["layers"][k],
                                           ref["layers"][k])
                           for k in adapter_keys),
        second_rollout_updated_params=rec["engine"][-1][
            "weight_version"] == 1,
        engine_serves_updated_actor=served["max_abs_err"] <= served["tol"],
    )
    rollout_tok_s = [g / s for g, s in zip(generated, rec["rollout_s"])]
    out = dict(
        config="llama3_8b", n_layers=layers, lora=dict(
            rank=lc.rank, alpha=lc.alpha, targets=list(lc.targets)),
        prompts=RL_PROMPTS, prompt_lens=l_np.tolist(), max_len=RL_MAX_LEN,
        temperature=ppo_cfg.temperature, minibatch=RL_MINIBATCH,
        epochs=RL_EPOCHS, kl_coef=RL_KL, steps=RL_STEPS, setup_s=setup_s,
        wall_s=wall, rollout_s=rec["rollout_s"],
        generated_tokens=generated, rollout_tokens_per_s=rollout_tok_s,
        experience_s=rec["experience_s"], update_s_per_minibatch=rec[
            "update_s"], median_update_s=float(np.median(rec["update_s"])),
        ratio_mean_per_minibatch=rec["ratio_mean"],
        engine=rec["engine"], peak_mem_gb=peak,
        actor_moment_bytes=_state_bytes(trainer.actor_opt_state),
        critic_moment_bytes=_state_bytes(trainer.critic_opt_state),
        adapter_params=_adapter_count(cfg), metrics=metrics,
        target_tokens=[int(((e.tokens[:, 1:] == RL_TARGET)
                            & (e.mask > 0)).sum()) for e in exps],
        launches=launches, want_launches=want, first_decode=served)
    del seen, lk

    # after the path: greedy rollouts through both engines, and the cost
    # of serving the f32 tree (every decode step casts it to bf16)
    trainer._cb = None
    torch.cuda.empty_cache()
    trainer.cfg = dataclasses.replace(ppo_cfg, temperature=0.0)
    t0 = time.perf_counter()
    with torch.no_grad():
        cont = rollout(cfg, prompts, lens, torch.Generator(
            device="cuda").manual_seed(0))
        t1 = time.perf_counter()
        lock, _ = sample_tokens_cached(cfg, actor, prompts, lens,
                                       RL_MAX_LEN, greedy=True)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        cache = dec.init_kv_cache(cfg, RL_PROMPTS, RL_MAX_LEN,
                                  device="cuda")
        tok = prompts[:, 0]
        pos = lens - 1
        bf16 = tree_map(lambda t: t.to(cfg.dtype), actor)
        step_ms = {"host_clock": {}, "device": {}}
        for name, tree in (("f32_tree", actor), ("bf16_tree", bf16),
                           ("bf16_tree_again", bf16),
                           ("f32_tree_again", actor)):
            def one(tree=tree):
                dec.decode_step(cfg, tree, tok, cache, pos)
            step_ms["host_clock"][name] = time_ms(one, iters=10)
            step_ms["device"][name] = device_ms(one, calls=3, replays=5)
        del bf16, cache
    trainer._cb = None
    # generated tokens each row's two greedy rollouts share before their
    # first difference
    same = (cont == lock).cpu().numpy()
    shared = [int(np.argmin(np.append(same[b, n:], False)))
              for b, n in enumerate(l_np)]
    out.update(
        greedy=dict(rows_equal=int(same.all(axis=1).sum()),
                    rows=RL_PROMPTS, shared_prefix_tokens=shared,
                    generated_per_row=[RL_MAX_LEN - int(n) for n in l_np],
                    continuous_s=t1 - t0, lockstep_cached_s=t2 - t1),
        decode_step_ms=step_ms, checks=checks)
    log("rl.ppo", **out)
    if not all(checks.values()):
        raise AssertionError(f"rl.ppo: failed checks {checks}")
    del trainer, engine, actor, critic, ref, exps
    torch.cuda.empty_cache()
    return out


def _fused_vs_unfused(cfg, params, micro):
    """train.ckpt (1): on one microbatch, the loss and the gradients of
    the lm_head, the final norm and layer 0 of loss_fn with fused_ce
    against the unfused loss_fn on the same params, each variant's
    whole forward + backward peak memory; then the loss alone (the
    final hidden states to the loss and back): forward + backward ms
    and peak memory above what was allocated before it."""
    import torch.nn.functional as F

    from dlrover_tpu_torch.models import llama
    from dlrover_tpu_torch.ops.fused_ce import fused_cross_entropy

    layer_keys = sorted(params["layers"])
    names = ["lm_head", "final_norm"] + [f"layers/{k}[0]" for k in layer_keys]
    leaves = ([params["lm_head"]["weight"], params["final_norm"]["scale"]]
              + [params["layers"][k] for k in layer_keys])
    res = {}
    for fused in (True, False):
        c = dataclasses.replace(cfg, fused_ce=fused)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        loss, _ = llama.loss_fn(c, params, micro)
        grads = torch.autograd.grad(loss, leaves)
        torch.cuda.synchronize()
        peak = (torch.cuda.max_memory_allocated() - base) / 2**30
        res[fused] = (loss.detach(), [g if i < 2 else g[0].clone()
                                      for i, g in enumerate(grads)], peak)
        del grads, loss
    loss_f, grads_f, peak_f = res[True]
    loss_u, grads_u, peak_u = res[False]
    loss_err = abs(loss_f.item() - loss_u.item())
    grad_errs = {n: ((a - b).norm() / b.norm()).item()
                 for n, a, b in zip(names, grads_f, grads_u)}
    del res, grads_f, grads_u

    with torch.no_grad():
        hidden = llama.apply(cfg, params, micro["tokens"][:, :-1],
                             return_hidden=True)
        head = params["lm_head"]["weight"].to(cfg.dtype)
    targets = micro["tokens"][:, 1:]

    def fused():
        x = hidden.detach().requires_grad_(True)
        h = head.detach().requires_grad_(True)
        ls, w = fused_cross_entropy(x, h, targets)
        (ls / w).backward()

    def unfused():   # loss_fn's unfused branch
        x = hidden.detach().requires_grad_(True)
        h = head.detach().requires_grad_(True)
        logits = (x @ h).float()
        F.cross_entropy(logits.flatten(0, 1), targets.flatten().long(),
                        reduction="none").mean().backward()

    loss_only = {}
    for name, fn in (("fused", fused), ("unfused", unfused)):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        fn()
        torch.cuda.synchronize()
        loss_only[name] = dict(
            peak_gb=(torch.cuda.max_memory_allocated() - base) / 2**30,
            fwd_bwd_ms=time_ms(fn, 5))
    out = dict(loss=loss_f.item(), unfused_loss=loss_u.item(),
               loss_abs_err=loss_err, grad_rel_l2_err=grad_errs,
               loss_rel_tol=TRAIN_LOSS_REL_TOL,
               grad_rel_tol=TRAIN_GRAD_REL_TOL, tol_reason=FUSED_TOL_REASON,
               model_fwd_bwd_peak_gb={"fused": peak_f, "unfused": peak_u},
               loss_only=loss_only,
               loss_only_shape=f"x {list(hidden.shape)} bf16, head "
                               f"{list(head.shape)} bf16")
    log("train.ckpt.fused_vs_unfused", **out)
    if not (loss_err <= TRAIN_LOSS_REL_TOL * abs(loss_u.item())
            and all(e <= TRAIN_GRAD_REL_TOL for e in grad_errs.values())):
        raise AssertionError(
            f"train.ckpt: fused vs unfused loss err {loss_err}, gradient "
            f"errors {grad_errs}")
    return out


def _bit_mismatch(state, ref):
    """Paths of the train state's leaves whose bytes differ from `ref`'s
    (a dict of the same paths), or that it lacks or adds."""
    from dlrover_tpu_torch.trainer.flash_checkpoint.engine import (
        state_leaves,
    )

    leaves = state_leaves(state)
    bad = sorted(set(leaves) ^ set(ref))
    for path, t in leaves.items():
        r = ref.get(path)
        if r is None:
            continue
        a, b = t.reshape(-1).view(torch.uint8), r.reshape(-1).view(torch.uint8)
        if a.device != b.device:
            b = b.to(a.device)
        if not torch.equal(a, b):
            bad.append(path)
    return bad


def phase_train_ckpt(train):
    """The train phase's model, params, tokens and AdamW with
    fused_ce=True, through flash checkpointing. (1) fused against
    unfused loss on one microbatch; (2) the snapshot buffers and the
    page-locked segment prepared, then a Trainer for 8 steps that
    saves to memory (async) every 2 steps and to disk at the end, with
    the launch counts set to 0 just before and read just after, then 2
    more steps without saving; (3) the state freed, a fresh
    ElasticTrainer from another seed under Trainer(resume=True)
    restores step 8 from memory, bit-equal on every leaf, then from
    disk once the segment is unlinked, bit-equal again; (4) steps 9 and
    10 from the restored state, whose losses must equal the
    uninterrupted run's bit for bit (the path is deterministic: cuBLAS
    on one stream, the split flash backward, no atomics in the loss).
    This script plays the agent: the IPC server and the saver live
    beside the Trainers, as the agent's do, so the staged step outlives
    the first Trainer. The segment and the checkpoint directory are
    removed at the end, whatever happens."""
    import gc
    import os
    import shutil

    from dlrover_tpu_torch.agent.ckpt_saver import (
        AsyncCheckpointSaver,
        shm_segment_paths,
    )
    from dlrover_tpu_torch.common.multi_process import (
        LocalSocketServer,
        shm_dir,
    )
    from dlrover_tpu_torch.trainer.flash_checkpoint import (
        Checkpointer,
        StorageType,
    )
    from dlrover_tpu_torch.trainer.flash_checkpoint.engine import (
        state_leaves,
    )
    from dlrover_tpu_torch.trainer.trainer import (
        Trainer,
        TrainerCallback,
        TrainingArguments,
    )

    class TimedCheckpointer(Checkpointer):
        """Each save's blocking seconds and, once the next save (or the
        end) has waited for it, its staging seconds."""

        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.saves = []

        def save_checkpoint(self, step, state, storage_type=StorageType.DISK):
            t = time.perf_counter()
            blocked = super().save_checkpoint(step, state, storage_type)
            if self.saves:
                self.saves[-1]["staging_s"] = self.engine.last_staging_s
            self.saves.append(dict(step=step, storage=storage_type,
                                   blocked_s=blocked, t=t))
            return blocked

    job = f"chip-smoke-{os.getpid()}"
    root = os.path.join(_smoke_out(), f"ckpt-{os.getpid()}")
    shm = shm_dir()
    seg_paths = shm_segment_paths(job)   # every slot of the segment
    shm_du = shutil.disk_usage(shm)
    os.environ["DLROVER_TPU_JOB_NAME"] = job
    server = LocalSocketServer(job)
    server.start()
    saver = AsyncCheckpointSaver(job_name=job)
    saver.start()
    checkpointers = []
    try:
        cfg, et, tokens, gen = _train_setup(_adamw, fused_ce=True)
        state = et.init_state(gen)
        fused = _fused_vs_unfused(
            cfg, state["params"], {"tokens": tokens[:TRAIN_MICROBATCH]})
        gc.collect()
        torch.cuda.empty_cache()

        # (2) train and save
        ck = TimedCheckpointer(os.path.join(root, "checkpoints"),
                               job_name=job)
        checkpointers.append(ck)
        # the snapshot buffers and the page-locked segment, before the
        # steps (the Trainer does the same; timed here on its own)
        prepare_s = ck.prepare(state)
        e2e = _run_trainer(cfg, et, state, tokens, "train.ckpt",
                           checkpointer=ck, output_dir=root)
        ck.engine.wait_for_staging()
        ck.saves[-1]["staging_s"] = ck.engine.last_staging_s
        if not ck.wait_latest_checkpoint(TRAIN_STEPS, timeout=900):
            raise AssertionError("train.ckpt: step 8 never persisted")
        persist_s = time.perf_counter() - ck.saves[-1]["t"]
        saves = [{k: v for k, v in sv.items() if k != "t"}
                 for sv in ck.saves]
        staged_bytes = ck.engine.last_staged_bytes
        pinned = ck.engine.pinned
        ck.close()   # frees the snapshot buffers, unpins the segment
        ref = {p: t.detach().clone() for p, t in state_leaves(state).items()}
        on_losses, more_s = [], []
        for _ in range(CKPT_MORE_STEPS):
            t0 = time.perf_counter()
            state, m = et.step(state, {"tokens": tokens})
            on_losses.append(m["loss"].item())
            more_s.append(time.perf_counter() - t0)
        del state, et, m
        gc.collect()
        torch.cuda.empty_cache()

        # (3) restore into a fresh trainer, (4) continue
        _, et2, _, _ = _train_setup(_adamw, fused_ce=True)
        state2 = et2.init_state(
            torch.Generator(device="cuda").manual_seed(CKPT_RESTORE_SEED))
        if not _bit_mismatch(state2, ref):
            raise AssertionError("train.ckpt: the fresh state equals step 8")

        class Resume(TrainerCallback):
            def __init__(self):
                self.ends, self.losses, self.out = [], [], {}

            def on_train_begin(self, trainer, st):
                torch.cuda.synchronize()
                out = self.out
                out["memory_restore_s"] = time.perf_counter() - t_resume
                out["memory_step"] = trainer.global_step
                out["memory_mismatch"] = _bit_mismatch(st, ref)
                for path in seg_paths:
                    if os.path.exists(path):
                        os.unlink(path)
                out["segment_unlinked"] = not any(
                    os.path.exists(path) for path in seg_paths)
                with torch.no_grad():   # the disk restore must rewrite all
                    for t in state_leaves(st).values():
                        t.fill_(-1)
                t0 = time.perf_counter()
                step, _ = trainer.checkpointer.load_checkpoint(target=st)
                torch.cuda.synchronize()
                out["disk_restore_s"] = time.perf_counter() - t0
                out["disk_step"] = step
                out["disk_mismatch"] = _bit_mismatch(st, ref)
                ref.clear()
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats()
                self.t0 = time.perf_counter()

            def on_step_end(self, trainer, st, metrics):
                self.ends.append(time.perf_counter())

            def on_log(self, trainer, st, logs):
                self.losses.append(logs["loss"])

        rec = Resume()
        n = TRAIN_STEPS + CKPT_MORE_STEPS
        trainer2 = Trainer(
            et2, TrainingArguments(output_dir=root, max_steps=n,
                                   logging_steps=1, save_steps=0,
                                   resume=True),
            train_data=[{"tokens": tokens}] * n, callbacks=[rec])
        checkpointers.append(trainer2.checkpointer)
        t_resume = time.perf_counter()
        trainer2.train(state2)
        torch.cuda.synchronize()
        resumed_peak = torch.cuda.max_memory_allocated() / 2**30
        resumed_s = np.diff([rec.t0] + rec.ends).tolist()
        trainer2.checkpointer.close()
        del state2, et2, trainer2
        gc.collect()
        torch.cuda.empty_cache()

        fused_steps = more_s + resumed_s
        checks = dict(
            memory_restore=rec.out["memory_step"] == TRAIN_STEPS
            and not rec.out["memory_mismatch"],
            disk_restore=rec.out["disk_step"] == TRAIN_STEPS
            and not rec.out["disk_mismatch"]
            and rec.out["segment_unlinked"],
            continuation=rec.losses == on_losses,
            steps=len(rec.losses) == CKPT_MORE_STEPS,
        )
        e2e.update(
            fused_vs_unfused=fused, prepare_s=prepare_s, saves=saves,
            blocking_s_per_save=[sv["blocked_s"] for sv in saves],
            staging_s=[sv.get("staging_s") for sv in saves],
            persist_s=persist_s, staged_bytes=staged_bytes,
            staged_gb=staged_bytes / 2**30, pinned=pinned,
            shm_dir=shm, shm_capacity_bytes=shm_du.total,
            shm_free_bytes=shm_du.free, depth_cut="none",
            checkpoint_dir=root, restore=rec.out,
            uninterrupted_losses_9_10=on_losses,
            resumed_losses_9_10=rec.losses,
            continuation_bit_equal=rec.losses == on_losses,
            fused_no_save_step_s=fused_steps,
            fused_median_no_save_step_s=float(np.median(fused_steps)),
            fused_resumed_peak_mem_gb=resumed_peak,
            unfused_median_step_s=train["median_step_s"],
            unfused_peak_mem_gb=train["peak_mem_gb"],
            checks=checks,
        )
        log("train.ckpt", **e2e)
        if not all(checks.values()):
            raise AssertionError(f"train.ckpt: failed checks {checks}")
        return e2e
    finally:
        for c in checkpointers:
            c.close()
        saver.stop()
        saver.join(timeout=60)
        saver.shm_handler.close()
        server.stop()
        for path in seg_paths:
            if os.path.exists(path):
                os.unlink(path)
        shutil.rmtree(root, ignore_errors=True)
        os.environ.pop("DLROVER_TPU_JOB_NAME", None)
        gc.collect()
        torch.cuda.empty_cache()


# train.master: the data-driven loop through the port's job master
MASTER_SEED = TRAIN_SEED + 3      # the dataset's tokens
MASTER_VOCAB = 512                # distinct token ids the samples draw
MASTER_SHARD = TRAIN_GLOBAL_BATCH  # samples a shard: one step's batch
MASTER_RESUME_AT = 4              # the interrupted run stops after it
MASTER_RPC_CALLS = 1000           # timed calls of each verb


def _master_rows(cfg):
    """The epoch: TRAIN_STEPS x TRAIN_GLOBAL_BATCH samples of
    TRAIN_SEQ + 1 tokens, drawn on the host from MASTER_VOCAB token ids
    of the vocabulary (numpy, seeded), so that every batch shares what
    there is to learn and the loss falls from batch to batch."""
    rng = np.random.default_rng(MASTER_SEED)
    ids = rng.choice(cfg.vocab_size, MASTER_VOCAB, replace=False)
    n = TRAIN_STEPS * TRAIN_GLOBAL_BATCH
    return ids[rng.integers(0, MASTER_VOCAB, size=(n, TRAIN_SEQ + 1))]


def _rpc_figures(client, master):
    """Round trips of get_task and report_global_step over the stdlib
    transport against a master of their own (p50 / p99 ms)."""
    client.report_dataset_params("rpc", MASTER_RPC_CALLS, 1)
    out = {}
    for verb, call in (
            ("get_task", lambda i: client.get_task("rpc")),
            ("report_global_step",
             lambda i: client.report_global_step(i + 1, 1.0))):
        ms = []
        for i in range(MASTER_RPC_CALLS):
            t0 = time.perf_counter()
            call(i)
            ms.append((time.perf_counter() - t0) * 1e3)
        out[verb] = dict(calls=len(ms), p50_ms=float(np.percentile(ms, 50)),
                         p99_ms=float(np.percentile(ms, 99)),
                         max_ms=max(ms))
    if master.servicer.speed_monitor.global_step != MASTER_RPC_CALLS:
        raise AssertionError("train.master: the timed step reports did not "
                             "all reach the master")
    return out


def phase_train_master(train, smi):
    """The data-driven training loop in one process, through the port's
    control plane: a LocalJobMaster (stdlib transport), a MasterClient
    that registers node 0, an ElasticDataset over IndexShardingClient
    reading {"tokens": row} samples of a seeded token array (shards of
    one batch, in index order), its
    `batches(TRAIN_GLOBAL_BATCH)` feeding Trainer(master_client=...)
    over the train phase's model, params and AdamW.
    (1) uninterrupted: TRAIN_STEPS steps; every index read exactly
    once, the dataset finished, the master's speed monitor at step
    TRAIN_STEPS, its metric collector holding the state's parameter
    count; launch counts by the train formula, all wgmma; losses
    finite and falling. (2) interrupted: the same for
    MASTER_RESUME_AT steps, saving to memory (the Trainer's save at its
    end goes to disk too; the saver, which this script runs as an agent
    would, reports the committed step to the master:
    get_ckpt_latest_step); then the Trainer and the master stop, a new
    master starts on the same port, the client sees the session change
    and registers again, and a Trainer from another seed resumes from
    the memory checkpoint over the same dataset object: its client
    finds the dataset unknown, registers it again and restores its
    cached shard checkpoint (IndexShardingClient acks inside
    fetch_index and pulls none, as in JAX, so the master re-issues the
    epoch), and the Trainer skips the MASTER_RESUME_AT consumed batches
    by count (JAX's rule for a stream without load_state_dict): the
    union of reads covers the epoch, the repeats are the shards acked
    before the interruption, and step MASTER_RESUME_AT + 1's loss
    matches the uninterrupted run's. (3) host figures: RPC round trips,
    master start and restart seconds, the median step against the
    train phase's."""
    import gc
    import os
    import shutil

    from torch.utils._pytree import tree_leaves

    from dlrover_tpu_torch.agent.ckpt_saver import (
        AsyncCheckpointSaver,
        shm_segment_paths,
    )
    from dlrover_tpu_torch.agent.master_client import MasterClient
    from dlrover_tpu_torch.common.messages import find_free_port
    from dlrover_tpu_torch.common.multi_process import LocalSocketServer
    from dlrover_tpu_torch.master.master import LocalJobMaster
    from dlrover_tpu_torch.models import llama
    from dlrover_tpu_torch.ops import _build
    from dlrover_tpu_torch.trainer.elastic.data import ElasticDataset
    from dlrover_tpu_torch.trainer.flash_checkpoint import Checkpointer
    from dlrover_tpu_torch.trainer.trainer import (
        Trainer,
        TrainerCallback,
        TrainingArguments,
    )

    class Record(TrainerCallback):
        def __init__(self):
            self.t0, self.ends, self.losses = None, [], []

        def on_train_begin(self, trainer, state):
            torch.cuda.synchronize()
            self.t0 = time.perf_counter()

        def on_step_end(self, trainer, state, metrics):
            self.ends.append(time.perf_counter())   # the step has synced

        def on_log(self, trainer, state, logs):
            self.losses.append(logs["loss"])

    def check_launches(what, launches, steps, grad_accum):
        per_pass = TRAIN_LAYERS * grad_accum * steps
        want = dict(flash_fwd=2 * per_pass, flash_bwd_dq=per_pass,
                    flash_bwd_dkv=per_pass)
        if any(launches[k] != v for k, v in want.items()):
            raise AssertionError(f"{what} launches {launches}, want {want}")
        _check_wgmma(what, launches,
                     ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"))

    def wait_for(pred, timeout=60.0):
        deadline = time.monotonic() + timeout
        while not pred() and time.monotonic() < deadline:
            time.sleep(0.02)
        return pred()

    job = f"chip-smoke-master-{os.getpid()}"
    root = os.path.join(_smoke_out(), f"master-{os.getpid()}")
    ckpt_dir = os.path.join(root, "checkpoints")
    seg_paths = shm_segment_paths(job)
    os.environ["DLROVER_TPU_JOB_NAME"] = job
    port = find_free_port()
    masters, closers = [], []
    server = LocalSocketServer(job)
    server.start()
    saver = client = None

    def start_master(p=port):
        t0 = time.perf_counter()
        m = LocalJobMaster(port=p, num_nodes=1, poll_interval=0.5)
        m.start()
        masters.append(m)
        return m, time.perf_counter() - t0

    try:
        m0, start_s = start_master()
        client = MasterClient(m0.addr, node_id=0, max_retries=3)
        client.register_node(rank=0)
        saver = AsyncCheckpointSaver(job_name=job, master_client=client)
        saver.start()
        rows = _master_rows(
            llama.LlamaConfig.llama3_8b(n_layers=TRAIN_LAYERS))
        n = len(rows)

        def dataset(name, reads):
            def read_sample(i):
                reads.append(i)
                return {"tokens": rows[i]}

            return ElasticDataset(name, n, MASTER_SHARD, read_sample,
                                  master_client=client)

        # (1) the uninterrupted run
        cfg, et, _, gen = _train_setup(_adamw)
        state = et.init_state(gen)
        state_params = sum(t.numel() for t in tree_leaves(state["params"]))
        reads_u, rec_u = [], Record()
        ds_u = dataset("train-u", reads_u)
        trainer = Trainer(
            et, TrainingArguments(max_steps=TRAIN_STEPS, logging_steps=1,
                                  save_steps=0, resume=False),
            train_data=ds_u.batches(TRAIN_GLOBAL_BATCH), callbacks=[rec_u],
            master_client=client)
        torch.cuda.synchronize()
        _build.reset_launch_counts()
        state = trainer.train(state)
        torch.cuda.synchronize()
        launches_u = _build.launch_counts()
        check_launches("train.master", launches_u, TRAIN_STEPS,
                       et.grad_accum)
        grad_accum = et.grad_accum
        collector = m0.servicer.metric_collector
        wait_for(lambda: collector._model is not None, 30)
        model = collector._model
        steps_u = np.diff([rec_u.t0] + rec_u.ends)
        del state, et, trainer
        gc.collect()
        torch.cuda.empty_cache()
        uninterrupted = dict(
            losses=rec_u.losses, reads=reads_u,
            finished=m0.servicer.task_manager.get_dataset(
                "train-u").finished(),
            master_global_step=m0.servicer.speed_monitor.global_step,
            model_info=dataclasses.asdict(model) if model else None,
            state_params=state_params, step_s=steps_u.tolist(),
            median_step_s=float(np.median(steps_u[1:])))
        m0.stop()

        # (2) the interrupted run: MASTER_RESUME_AT steps on a new master
        m1, _ = start_master()
        client.register_node(rank=0)
        cfg, et, _, gen = _train_setup(_adamw)
        state = et.init_state(gen)
        ck = Checkpointer(ckpt_dir, job_name=job)
        closers.append(ck)
        reads_r, rec_r1 = [], Record()
        ds_r = dataset("train-r", reads_r)
        trainer = Trainer(
            et, TrainingArguments(output_dir=root, max_steps=MASTER_RESUME_AT,
                                  logging_steps=1,
                                  save_steps=MASTER_RESUME_AT,
                                  save_storage="memory", resume=False),
            train_data=ds_r.batches(TRAIN_GLOBAL_BATCH), callbacks=[rec_r1],
            checkpointer=ck, master_client=client)
        torch.cuda.synchronize()
        _build.reset_launch_counts()
        state = trainer.train(state)
        torch.cuda.synchronize()
        launches_r1 = _build.launch_counts()
        check_launches("train.master.resume (before)", launches_r1,
                       MASTER_RESUME_AT, et.grad_accum)
        t_persist = time.perf_counter()
        if not ck.wait_latest_checkpoint(MASTER_RESUME_AT, timeout=900):
            raise AssertionError("train.master: the disk save never "
                                 "committed")
        persist_wait_s = time.perf_counter() - t_persist
        wait_for(lambda: client.get_ckpt_latest_step(ckpt_dir)
                 == MASTER_RESUME_AT, 30)
        latest_step = client.get_ckpt_latest_step(ckpt_dir)
        reads_before = list(reads_r)
        cached = ds_r.client._cached_checkpoint
        master_view = json.loads(ds_r.client.shard_checkpoint())
        ck.close()
        del state, et, trainer
        gc.collect()
        torch.cuda.empty_cache()
        # the interruption: the master goes; a new one on the same port
        session = client.report_heart_beat().master_session
        t0 = time.perf_counter()
        m1.stop()
        m2, _ = start_master()
        new_session = client.report_heart_beat().master_session
        restart_s = time.perf_counter() - t0
        if new_session == session:
            raise AssertionError("train.master: no session change")
        client.register_node(rank=0)
        cfg, et, _, _ = _train_setup(_adamw)
        state = et.init_state(
            torch.Generator(device="cuda").manual_seed(CKPT_RESTORE_SEED))
        rec_r2 = Record()
        trainer = Trainer(
            et, TrainingArguments(output_dir=root, max_steps=TRAIN_STEPS,
                                  logging_steps=1, save_steps=0,
                                  resume=True),
            train_data=ds_r.batches(TRAIN_GLOBAL_BATCH), callbacks=[rec_r2],
            master_client=client)
        closers.append(trainer.checkpointer)
        torch.cuda.synchronize()
        _build.reset_launch_counts()
        t_resume = time.perf_counter()
        state = trainer.train(state)
        torch.cuda.synchronize()
        resume_s = time.perf_counter() - t_resume
        launches_r2 = _build.launch_counts()
        check_launches("train.master.resume (after)", launches_r2,
                       TRAIN_STEPS - MASTER_RESUME_AT, et.grad_accum)
        trainer.checkpointer.close()
        resumed_step = trainer.global_step
        del state, et, trainer
        gc.collect()
        torch.cuda.empty_cache()
        reads_after = reads_r[len(reads_before):]
        repeats = sorted(set(reads_before) & set(reads_after))
        k = MASTER_RESUME_AT * TRAIN_GLOBAL_BATCH
        first_resumed = rec_r2.losses[0] if rec_r2.losses else float("nan")
        want_loss = rec_u.losses[MASTER_RESUME_AT]
        node2 = m2.servicer.node_manager.get_node("worker", 0)

        # (3) host figures on a master of their own
        m_rpc, _ = start_master(find_free_port())
        rpc_client = MasterClient(m_rpc.addr, node_id=0, max_retries=1)
        try:
            rpc = _rpc_figures(rpc_client, m_rpc)
        finally:
            rpc_client.close()
            m_rpc.stop()

        losses_u = uninterrupted["losses"]
        checks = dict(
            launches=True,   # check_launches raised otherwise
            losses_fall=(len(losses_u) == TRAIN_STEPS
                         and bool(np.all(np.isfinite(losses_u)))
                         and losses_u[-1] < losses_u[0]),
            every_index_once=sorted(reads_u) == list(range(n)),
            dataset_finished=uninterrupted["finished"],
            speed_monitor_step=(uninterrupted["master_global_step"]
                                == TRAIN_STEPS),
            model_info_params=(model is not None
                               and model.num_params == state_params
                               == llama.num_params(cfg)),
            ckpt_latest_step=latest_step == MASTER_RESUME_AT,
            reads_before=sorted(reads_before) == sorted(reads_u[:k]),
            union_covers_epoch=sorted(set(reads_before) | set(reads_after))
            == list(range(n)),
            repeats_at_least_once=set(repeats) <= set(reads_before),
            resumed_steps=(resumed_step == TRAIN_STEPS
                           and len(rec_r2.losses)
                           == TRAIN_STEPS - MASTER_RESUME_AT),
            same_order=reads_before + reads_after[k:] == reads_u,
            resumed_loss=abs(first_resumed - want_loss)
            <= TRAIN_LOSS_REL_TOL * abs(want_loss),
            restarted_master=(m2.servicer.task_manager.get_dataset(
                "train-r") is not None
                and m2.servicer.task_manager.get_dataset("train-r").finished()
                and m2.servicer.speed_monitor.global_step == TRAIN_STEPS
                and node2 is not None),
        )
        out = dict(
            nvidia_smi=smi, steps=TRAIN_STEPS, resume_at=MASTER_RESUME_AT,
            samples=n, shard=MASTER_SHARD, vocab_ids=MASTER_VOCAB,
            grad_accum=grad_accum,
            uninterrupted={k_: v for k_, v in uninterrupted.items()
                           if k_ != "reads"},
            reads_uninterrupted=reads_u,
            reads_before_interruption=reads_before,
            reads_after_restart=reads_after, repeats=repeats,
            client_cached_shard_checkpoint=cached,
            master_shard_checkpoint_at_interruption=master_view,
            resumed_losses=rec_r2.losses,
            uninterrupted_loss_at_resume=want_loss,
            resumed_loss_abs_err=abs(first_resumed - want_loss),
            loss_rel_tol=TRAIN_LOSS_REL_TOL,
            ckpt_latest_step=latest_step, persist_wait_s=persist_wait_s,
            resume_s=resume_s,
            launches=launches_u,
            launches_resume={k_: launches_r1[k_] + launches_r2[k_]
                             for k_ in launches_r1},
            host=dict(rpc=rpc, master_start_s=start_s,
                      master_restart_s=restart_s,
                      median_step_s=uninterrupted["median_step_s"],
                      train_median_step_s=train["median_step_s"],
                      step_ratio=uninterrupted["median_step_s"]
                      / train["median_step_s"]),
            checks=checks,
        )
        log("train.master", **out)
        if not all(checks.values()):
            raise AssertionError(
                f"train.master: failed checks "
                f"{[c for c, ok in checks.items() if not ok]}")
        return out
    finally:
        for c in closers:
            c.close()
        if saver is not None:
            saver.stop()
            saver.join(timeout=60)
            saver.shm_handler.close()
        server.stop()
        for m in masters:
            m.stop()
        if client is not None:
            client.close()
        for path in seg_paths:
            if os.path.exists(path):
                os.unlink(path)
        shutil.rmtree(root, ignore_errors=True)
        os.environ.pop("DLROVER_TPU_JOB_NAME", None)
        gc.collect()
        torch.cuda.empty_cache()


# train.agent: the train workload supervised by the port's agent
AGENT_CRASH_STEP = 5              # attempt 0 dies at the top of this step
AGENT_FAIL_CODE = 5               # the always-failing script's exit code
AGENT_TIMEOUT_S = 900             # the launcher's wall-time limit

# The worker the phase's launcher supervises: chip_smoke's train setup
# (imported from the repository root, which the agent puts on
# PYTHONPATH) under Trainer(master_client=..., checkpointer=...), with
# memory saves every CKPT_SAVE_STEPS steps. It writes one JSON line an
# event to events.jsonl (os.write: a line written before the crash is
# on disk when os._exit ends the process).
AGENT_WORKER = '''\
import json, os, sys, time
T_START = time.time()
OUT = os.environ["AGENT_SMOKE_OUT"]
ATTEMPT = int(os.environ["DLROVER_TPU_RESTART_COUNT"])
FD = os.open(os.path.join(OUT, "events.jsonl"),
             os.O_WRONLY | os.O_APPEND | os.O_CREAT, 0o644)


def event(name, **kw):
    line = dict(event=name, attempt=ATTEMPT, t=time.time(), **kw)
    os.write(FD, (json.dumps(line, default=float) + "\\n").encode())


event("start", t_start=T_START)
import torch

import dlrover_tpu_torch
from dlrover_tpu_torch.ops import _build

event("imported")
ctx = dlrover_tpu_torch.init()
event("init", watch=ctx.watch is not None, node_num=ctx.node_num,
      build_dir=str(_build.build_dir()))
prebuilt = {n: _build.library_path(n).exists()
            for n in ("flash_fwd", "flash_bwd")}
t0 = time.time()
for name in prebuilt:
    _build.load(name)
event("libraries", prebuilt=prebuilt, seconds=time.time() - t0)

import chip_smoke as cs
from dlrover_tpu_torch.agent.master_client import MasterClient
from dlrover_tpu_torch.trainer.flash_checkpoint import Checkpointer
from dlrover_tpu_torch.trainer.trainer import (
    Trainer,
    TrainerCallback,
    TrainingArguments,
)

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
t0 = time.time()
cfg, et, tokens, gen = cs._train_setup(cs._adamw)
state = et.init_state(gen)
torch.cuda.synchronize()
event("model", grad_accum=et.grad_accum, n_layers=cfg.n_layers,
      seconds=time.time() - t0)


class TimedCheckpointer(Checkpointer):
    def load_checkpoint(self, target=None, device=None):
        t0 = time.time()
        step, st = super().load_checkpoint(target, device)
        torch.cuda.synchronize()
        event("restore", step=step, source=self.engine.last_load_source,
              seconds=time.time() - t0)
        return step, st

    def prepare(self, st):
        seconds = super().prepare(st)
        event("prepare", seconds=seconds, pinned=self.engine.pinned)
        return seconds


ck = TimedCheckpointer(os.path.join(OUT, "checkpoints"), max_to_keep=1)
handler = ck.engine.shm_handler
publish = handler.publish


def logged_publish(step, *a, **kw):
    publish(step, *a, **kw)
    event("published", step=step, slot=handler._slot)


handler.publish = logged_publish


class Record(TrainerCallback):
    def on_train_begin(self, trainer, st):
        torch.cuda.synchronize()
        event("train_begin", step=trainer.global_step)

    def on_step_end(self, trainer, st, metrics):   # the step has synced
        event("step_end", step=trainer.global_step)

    def on_log(self, trainer, st, logs):
        event("loss", step=logs["step"], loss=logs["loss"])


crash_step = int(os.environ["AGENT_SMOKE_CRASH_STEP"])
step_fn = et.step


def step(st, batch):
    if ATTEMPT == 0 and trainer.global_step + 1 == crash_step:
        event("crash", step=crash_step, launches=_build.launch_counts())
        os._exit(17)
    return step_fn(st, batch)


et.step = step
trainer = Trainer(
    et, TrainingArguments(output_dir=OUT, max_steps=cs.TRAIN_STEPS,
                          logging_steps=1, save_steps=cs.CKPT_SAVE_STEPS,
                          save_storage="memory", resume=True),
    train_data=[{"tokens": tokens}] * cs.TRAIN_STEPS, callbacks=[Record()],
    checkpointer=ck, master_client=MasterClient.singleton())
torch.cuda.synchronize()
torch.cuda.reset_peak_memory_stats()
_build.reset_launch_counts()
state = trainer.train(state)
torch.cuda.current_stream().synchronize()
event("trained", step=trainer.global_step, launches=_build.launch_counts(),
      peak_mem_gb=torch.cuda.max_memory_allocated() / 2**30)
# the Trainer's last save went to disk: wait for the agent's commit,
# so the teardown's persist finds it done (as train.ckpt waits)
t0 = time.time()
ok = ck.wait_latest_checkpoint(cs.TRAIN_STEPS, timeout=900)
event("committed", ok=ok, seconds=time.time() - t0)
ck.close()
event("exit")
'''

# The launcher as a user starts it (`elastic_run.main` on the given
# arguments), instrumented from outside: the master it starts, the
# agent's worker spawns and checkpoint persists, each with its host
# time; at the end whether this process made a CUDA context. Its last
# stdout line is "AGENT_REPORT <json>".
AGENT_LAUNCHER = '''\
import dataclasses, json, os, sys, time

from dlrover_tpu_torch.agent import ckpt_saver, training
from dlrover_tpu_torch.trainer import elastic_run

EVENTS, MASTERS = [], []
resolve = elastic_run._resolve_master


def _resolve(*a, **kw):
    addr, master = resolve(*a, **kw)
    MASTERS.append(master)
    return addr, master


persist = ckpt_saver.AsyncCheckpointSaver.save_shm_to_storage


def _persist(self, *a, **kw):
    t0, before = time.time(), self.last_persisted_step
    try:
        return persist(self, *a, **kw)
    finally:
        EVENTS.append(dict(event="persist", t0=t0, t1=time.time(),
                           before=before, after=self.last_persisted_step))


start = training.ElasticTrainingAgent._start_worker


def _start(self):
    out = start(self)
    EVENTS.append(dict(event="spawn", t=time.time(),
                       restart_count=self.restart_count))
    return out


elastic_run._resolve_master = _resolve
ckpt_saver.AsyncCheckpointSaver.save_shm_to_storage = _persist
training.ElasticTrainingAgent._start_worker = _start
t0 = time.time()
rc = elastic_run.main(sys.argv[1:])
wall = time.time() - t0
torch_imported = "torch" in sys.modules
fds = []
for fd in os.listdir("/proc/self/fd"):
    try:
        fds.append(os.readlink(f"/proc/self/fd/{fd}"))
    except OSError:
        pass
import torch

master = MASTERS[0] if MASTERS else None
node = master.servicer.node_manager.get_node("worker", 0) if master else None
report = dict(
    rc=rc, wall_s=wall, events=EVENTS, torch_imported=torch_imported,
    cuda_initialized=torch.cuda.is_initialized(),
    nvidia_fds=[f for f in fds if f.startswith("/dev/nvidia")],
    failures=[{k: v for k, v in dataclasses.asdict(r).items()
               if k != "timestamp"}
              for r in master.servicer.error_monitor.recent()]
    if master else None,
    node_status=node.status if node else None,
    exit_reason=node.exit_reason if node else None)
print("AGENT_REPORT " + json.dumps(report, default=str), flush=True)
sys.exit(rc)
'''


def _agent_launch(root, args, env):
    """The launcher wrapper on `args`: (CompletedProcess, its report)."""
    import os

    r = subprocess.run([sys.executable, os.path.join(root, "launch.py"),
                        *args], env=env, cwd=root, capture_output=True,
                       text=True, timeout=AGENT_TIMEOUT_S)
    rep = next((json.loads(ln.split(" ", 1)[1])
                for ln in reversed(r.stdout.splitlines())
                if ln.startswith("AGENT_REPORT ")), None)
    if rep is None:
        raise AssertionError(
            f"train.agent: the launcher printed no report (rc "
            f"{r.returncode}): {r.stdout[-3000:]} {r.stderr[-6000:]}")
    return r, rep


def _tail(path, n=4000):
    try:
        with open(path, errors="replace") as f:
            return f.read()[-n:]
    except OSError:
        return ""


def phase_train_agent(train, smi):
    """The train workload through the launcher a user runs, `python -m
    dlrover_tpu_torch.trainer.elastic_run --nnodes 1 --max-restarts 2
    --log-dir <out>/agent_logs <worker>`, in a subprocess of this
    script: node 0 finds no master and starts the port's
    DistributedJobMaster, the agent rendezvouses and spawns the worker,
    which runs `dlrover_tpu_torch.init()` (the membership watch), builds
    the train phase's setup (same seed, model, tokens and AdamW) and
    drives Trainer(master_client=MasterClient.singleton()) for
    TRAIN_STEPS steps with memory saves every CKPT_SAVE_STEPS. Attempt 0
    dies with os._exit(17) at the top of step AGENT_CRASH_STEP, right
    after a save dispatched its staging; the agent persists the last
    published step to disk, reports the failure and respawns the
    worker, which restores memory-first from the agent's segment and
    finishes. Checks: the launcher exits 0 after two attempts
    (RESTART_COUNT 0 and 1), one failure at the master, node SUCCEEDED;
    each attempt's flash launches by the train formula for the steps it
    ran, all wgmma; every loss within TRAIN_LOSS_REL_TOL of train's at
    the same step (bit equality reported), falling; the resume from
    memory at the last step published before the crash; the kernel
    libraries found built (no nvcc in the worker); the launcher made no
    CUDA context; the node check's isolated bench healthy on the card;
    a script exiting AGENT_FAIL_CODE under --max-restarts 1 makes the
    launcher exit with that code and the node FAILED with fatal_error.
    Reported: the time to recover in parts, on one host clock, and the
    median step of each attempt against train's. The segment and the
    output directory are removed at the end, whatever happens."""
    import os
    import shutil

    from dlrover_tpu_torch.agent.ckpt_saver import shm_segment_paths
    from dlrover_tpu_torch.agent.node_check import run_bench_isolated

    repo = os.path.dirname(os.path.abspath(__file__))
    root = os.path.join(_smoke_out(), f"agent-{os.getpid()}")
    job = f"chip-smoke-agent-{os.getpid()}"
    os.makedirs(root, exist_ok=True)
    for name, text in (("worker.py", AGENT_WORKER),
                       ("launch.py", AGENT_LAUNCHER),
                       ("fail.py", f"import sys\nsys.exit({AGENT_FAIL_CODE})\n")):
        with open(os.path.join(root, name), "w") as f:
            f.write(text)
    env = {k: v for k, v in os.environ.items()
           if k not in ("DLROVER_TPU_FORCE_CPU", "DLROVER_TPU_JOB_NAME")}
    pp = env.get("PYTHONPATH", "")
    env.update(
        PYTHONPATH=repo + (os.pathsep + pp if pp else ""),
        AGENT_SMOKE_OUT=root, AGENT_SMOKE_CRASH_STEP=str(AGENT_CRASH_STEP),
        DLROVER_TPU_RUNTIME_METRICS_PATH=os.path.join(
            root, "runtime_metrics.json"),
        DLROVER_TPU_CHIP_METRICS_PATH=os.path.join(root, "chip_metrics.json"))
    logs = os.path.join(root, "agent_logs")
    try:
        t0 = time.perf_counter()
        healthy, bench_s = run_bench_isolated()
        node_check = dict(healthy=healthy, bench_s=bench_s,
                          wall_s=time.perf_counter() - t0)

        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r, rep = _agent_launch(root, [
            "--nnodes", "1", "--max-restarts", "2", "--job-name", job,
            "--log-dir", logs, os.path.join(root, "worker.py")], env)
        wall = time.perf_counter() - t0
        with open(os.path.join(root, "events.jsonl")) as f:
            events = [json.loads(line) for line in f]

        def of(attempt, name):
            return [e for e in events
                    if e["attempt"] == attempt and e["event"] == name]

        def one(attempt, name):
            found = of(attempt, name)
            if not found:
                raise AssertionError(
                    f"train.agent: attempt {attempt} logged no {name!r}: "
                    f"{events[-5:]}\nlauncher: {r.stderr[-3000:]}\n"
                    f"worker: {_tail(os.path.join(logs, f'worker_0_r{attempt}.log'))}")
            return found[0]

        attempts = sorted({e["attempt"] for e in events})
        crash = one(0, "crash")
        published = [e["step"] for e in of(0, "published")
                     if e["t"] < crash["t"]]
        restore = one(1, "restore")
        trained = one(1, "trained")
        spawns = [e for e in rep["events"] if e["event"] == "spawn"]
        persists = [e for e in rep["events"] if e["event"] == "persist"]
        crash_persist = next(
            (e for e in persists if e["t0"] >= crash["t"]), None)
        if crash_persist is None or len(spawns) != 2:
            raise AssertionError(
                f"train.agent: persists {persists}, spawns {spawns} "
                f"(rc {r.returncode})\nlauncher: {r.stderr[-3000:]}")
        ran = {0: AGENT_CRASH_STEP - 1, 1: TRAIN_STEPS - restore["step"]}
        launches = {0: crash["launches"], 1: trained["launches"]}
        grad_accum = one(0, "model")["grad_accum"]
        for a in (0, 1):
            per_pass = TRAIN_LAYERS * grad_accum * ran[a]
            want = dict(flash_fwd=2 * per_pass, flash_bwd_dq=per_pass,
                        flash_bwd_dkv=per_pass)
            if any(launches[a][k] != v for k, v in want.items()):
                raise AssertionError(f"train.agent attempt {a} launches "
                                     f"{launches[a]}, want {want}")
            _check_wgmma(f"train.agent attempt {a}", launches[a],
                         ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"))
        losses = {a: {e["step"]: e["loss"] for e in of(a, "loss")}
                  for a in (0, 1)}
        ref = train["losses"]
        loss_err = {f"{a}:{s}": abs(v - ref[s - 1]) / abs(ref[s - 1])
                    for a in (0, 1) for s, v in losses[a].items()}
        every = [losses[0][s] for s in sorted(losses[0])] + [
            losses[1][s] for s in sorted(losses[1])]
        first_after = min(e["t"] for e in of(1, "step_end"))
        begin1 = one(1, "train_begin")

        def median_step(a):
            ends = [e["t"] for e in of(a, "step_end")]
            return float(np.median(np.diff(ends))) if len(ends) > 2 else None

        recover = dict(
            crash_to_agent_s=crash_persist["t0"] - crash["t"],
            crash_path_persist_s=crash_persist["t1"] - crash_persist["t0"],
            persist_to_spawn_s=spawns[1]["t"] - crash_persist["t1"],
            spawn_to_init_s=one(1, "init")["t"] - spawns[1]["t"],
            spawn_to_imports_s=one(1, "imported")["t"] - spawns[1]["t"],
            libraries_loaded_s=one(1, "libraries")["seconds"],
            model_build_s=one(1, "model")["seconds"],
            memory_restore_s=restore["seconds"],
            prepare_s=one(1, "prepare")["seconds"],
            first_step_after_restore_s=first_after - begin1["t"],
            total_s=first_after - crash["t"],
        )
        steps = dict(attempt0_median_step_s=median_step(0),
                     attempt1_median_step_s=median_step(1),
                     train_median_step_s=train["median_step_s"])
        steps["ratio"] = [None if v is None else v / train["median_step_s"]
                          for v in (steps["attempt0_median_step_s"],
                                    steps["attempt1_median_step_s"])]

        r2, rep2 = _agent_launch(root, [
            "--nnodes", "1", "--max-restarts", "1", "--job-name",
            job + "-fail",
            os.path.join(root, "fail.py")], env)

        checks = dict(
            launcher_rc=rep["rc"] == r.returncode == 0,
            attempts=attempts == [0, 1]
            and [e["restart_count"] for e in spawns] == [0, 1],
            one_failure=len(rep["failures"]) == 1
            and rep["failures"][0]["error_data"] == "worker exit code 17",
            node_succeeded=rep["node_status"] == "succeeded",
            launches=True,   # raised above otherwise
            losses_within_tol=all(e <= TRAIN_LOSS_REL_TOL
                                  for e in loss_err.values())
            and len(losses[0]) == ran[0] and len(losses[1]) == ran[1],
            losses_fall=bool(np.all(np.isfinite(every)))
            and every[-1] < every[0],
            resume_from_memory=restore["source"] == "memory",
            resume_at_last_published=bool(published)
            and restore["step"] == published[-1],
            crash_path_persisted=crash_persist["after"] == restore["step"],
            libraries_prebuilt=all(one(1, "libraries")["prebuilt"].values()),
            watch_started=one(1, "init")["watch"],
            committed=one(1, "committed")["ok"],
            launcher_no_cuda=not rep["cuda_initialized"]
            and not rep["nvidia_fds"],
            node_check_healthy=healthy,
            failure_propagates=r2.returncode == rep2["rc"] == AGENT_FAIL_CODE
            and rep2["node_status"] == "failed"
            and rep2["exit_reason"] == "fatal_error",
        )
        out = dict(
            nvidia_smi=smi, crash_step=AGENT_CRASH_STEP,
            published_before_crash=published, resumed_step=restore["step"],
            restore_source=restore["source"], steps_run=ran,
            launches_by_attempt=launches,
            launches={k: launches[0][k] + launches[1][k]
                      for k in launches[0]},
            losses={str(a): losses[a] for a in (0, 1)},
            train_losses=ref, loss_rel_err=loss_err,
            loss_rel_tol=TRAIN_LOSS_REL_TOL,
            bit_equal_to_train=all(e == 0.0 for e in loss_err.values()),
            time_to_recover=recover, step_time=steps,
            prepare_s=[e["seconds"] for e in events
                       if e["event"] == "prepare"],
            disk_commit_wait_s=one(1, "committed")["seconds"],
            persists=persists, launcher_wall_s=rep["wall_s"],
            phase_launcher_s=wall, peak_mem_gb=trained["peak_mem_gb"],
            launcher=dict(torch_imported=rep["torch_imported"],
                          cuda_initialized=rep["cuda_initialized"],
                          nvidia_fds=rep["nvidia_fds"]),
            node_check=node_check,
            failure_run=dict(rc=r2.returncode, node_status=rep2["node_status"],
                             exit_reason=rep2["exit_reason"],
                             failures=len(rep2["failures"]),
                             wall_s=rep2["wall_s"]),
            checks=checks,
        )
        log("train.agent", **out)
        if not all(checks.values()):
            raise AssertionError(
                f"train.agent: failed checks "
                f"{[c for c, ok in checks.items() if not ok]}\n"
                f"launcher: {r.stderr[-3000:]}")
        return out
    finally:
        for j in (job, job + "-fail"):
            for path in shm_segment_paths(j):
                if os.path.exists(path):
                    os.unlink(path)
        shutil.rmtree(root, ignore_errors=True)


DP_LAYERS = 1                     # (b): 1.27 B params, ~24 GB a rank
DP_MICROBATCH = 1                 # (b): accum 2 of one row a rank
DP_STEPS = 4                      # (b): steps in the world of two
DP_MORE_STEPS = 2                 # (b): steps after the world change
DP_COLL_SEED = TRAIN_SEED + 7     # (c): rank r's gradient from seed + r
DP_COLL_SHAPE = (14336, 4096)     # (c): one w_gate, f32
DP_COLL_BLOCK = 256
DP_COLL_REPS = 3
DP_TREE_REL_TOL = 0.02            # tests/test_compute_path.py:189-206
DP_RING_REL_TOL = 0.15
DP_TIMEOUT_S = 600                # each launcher's wall-time limit

# The worker each agent of train.dp supervises. Mode "a": one rank on
# NCCL, the train phase's config through chip_smoke's _run_trainer.
# Mode "b": rank 0 or 1 of a gloo world on the one card (the agents'
# env sets DLROVER_TPU_TORCH_DIST_BACKEND=gloo): the 1-layer model for
# DP_STEPS steps, then (c) the compressed collectives, then rank 1
# leaves and rank 0 goes on alone in a world of one after
# on_world_change. One JSON line an event to events_<mode>_<rank>.jsonl.
DP_WORKER = '''\
import json, os, sys, time
OUT = os.environ["DP_SMOKE_OUT"]
MODE = os.environ["DP_SMOKE_MODE"]
import torch
import torch.distributed as dist
from torch.utils._pytree import tree_leaves

import dlrover_tpu_torch
from dlrover_tpu_torch import runtime
from dlrover_tpu_torch.common.messages import find_free_port
from dlrover_tpu_torch.ops import _build
from dlrover_tpu_torch.ops import quantization as Q

ctx = dlrover_tpu_torch.init()
if MODE == "a":
    # one node: init() joins no world; a world of one rank on NCCL
    runtime.join_world(os.environ["DLROVER_TPU_COORDINATOR_ADDR"], 1, 0)
RANK, WORLD = dist.get_rank(), dist.get_world_size()
FD = os.open(os.path.join(OUT, f"events_{MODE}_{RANK}.jsonl"),
             os.O_WRONLY | os.O_APPEND | os.O_CREAT, 0o644)


def event(name, **kw):
    line = dict(event=name, rank=RANK, t=time.time(), **kw)
    os.write(FD, (json.dumps(line, default=float) + "\\n").encode())


event("init", world=WORLD, backend=dist.get_backend(),
      device=str(runtime.device()),
      prebuilt={n: _build.library_path(n).exists()
                for n in ("flash_fwd", "flash_bwd", "quant_int8",
                          "dequant_int8")})
import chip_smoke as cs

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def checksums(state):
    """Per param leaf: the sum of its 32-bit words (int64) and of its
    values (f64), on the host."""
    out = []
    for t in tree_leaves(state["params"]):
        t = t.detach()
        out.append([float(t.view(torch.int32).sum(dtype=torch.int64)),
                    float(t.double().sum())])
    return torch.tensor(out, dtype=torch.float64)


def same_on_both(cs_t):
    got = [torch.empty_like(cs_t) for _ in range(WORLD)]
    dist.all_gather(got, cs_t)
    return all(torch.equal(g, got[0]) for g in got)


def steps(et, state, tokens, n, tag):
    losses, times, equal = [], [], []
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    for _ in range(n):
        t0 = time.perf_counter()
        state, m = et.step(state, {"tokens": tokens})
        losses.append(float(m["loss"]))
        torch.cuda.current_stream().synchronize()
        times.append(time.perf_counter() - t0)
        if WORLD > 1:
            equal.append(same_on_both(checksums(state)))
    event(tag, losses=losses, step_s=times, bit_equal=equal,
          launches=_build.launch_counts(), grad_accum=et.grad_accum,
          peak_mem_gb=torch.cuda.max_memory_allocated() / 2**30)
    return state


if MODE == "a":
    cfg, et, tokens, gen = cs._train_setup(cs._adamw)
    state = et.init_state(gen)
    e2e = cs._run_trainer(cfg, et, state, tokens, "train.dp.a")
    event("trained", **{k: v for k, v in e2e.items() if k != "last_logs"})
    dlrover_tpu_torch.shutdown()
    sys.exit(0)

cfg, et, tokens, gen = cs._train_setup(cs._adamw, n_layers=cs.DP_LAYERS,
                                       microbatch=cs.DP_MICROBATCH)
torch.cuda.reset_peak_memory_stats()
state = et.init_state(gen)
event("model", grad_accum=et.grad_accum, replicas=et.plan["num_replicas"],
      init_equal=same_on_both(checksums(state)))
state = steps(et, state, tokens, cs.DP_STEPS, "world2")

# (c): the compressed collectives on this rank's gradient-sized tensor
def contribution(rank):
    g = torch.Generator(device="cuda").manual_seed(cs.DP_COLL_SEED + rank)
    return torch.randn(cs.DP_COLL_SHAPE, generator=g, device="cuda")

grad = contribution(RANK)
sent, received = [], []
quantize_any, dequantize_int8 = Q.quantize_any, Q.dequantize_int8


def recording(x, block=Q.DEFAULT_BLOCK):
    out = quantize_any(x, block)
    sent.append((x.clone(), out[0].clone(), out[1].clone()))
    return out


def recording_dequantize(q, s, out_dtype=torch.float32):
    out = dequantize_int8(q, s, out_dtype)
    received.append((q.clone(), s.clone(), out_dtype, out.clone()))
    return out


coll = {}
for name, fn in (("tree", lambda: Q.quantized_all_reduce_tree(
                     {"w": grad}, block=cs.DP_COLL_BLOCK)["w"]),
                 ("ring", lambda: Q.quantized_reduce_scatter(
                     grad, block=cs.DP_COLL_BLOCK))):
    Q.quantize_any, Q.dequantize_int8 = recording, recording_dequantize
    torch.cuda.synchronize()
    dist.barrier()
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    result = fn()
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = _build.launch_counts()
    Q.quantize_any, Q.dequantize_int8 = quantize_any, dequantize_int8
    times = []
    for _ in range(cs.DP_COLL_REPS):
        dist.barrier()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    wire = sent[:]
    sent.clear()
    # each payload against the plain quantize of the tensor it was made
    # of, on the same inputs (the plain version launches no kernel)
    payload_equal = []
    for x, q, s in wire:
        flat = x.reshape(1, -1)
        pad = (-flat.numel()) % cs.DP_COLL_BLOCK
        flat = torch.nn.functional.pad(flat, (0, pad))
        pq, ps = Q._quantize_plain(flat, cs.DP_COLL_BLOCK)
        payload_equal.append(torch.equal(pq, q) and torch.equal(ps, s))
    # each received payload's kernel 6 output against the plain
    # dequantize of the same payload: both give the JAX kernel's bits
    dequant_equal = [torch.equal(Q._dequantize_plain(q, s, dt), out)
                     for q, s, dt, out in received]
    dequant_shapes = [list(q.shape) for q, _, _, _ in received]
    received.clear()
    total = contribution(0) + contribution(1)
    if name == "ring":
        c = total.shape[0] // WORLD
        total = total[RANK * c:(RANK + 1) * c]
    rel = float((result - total).abs().max() / total.abs().max())
    coll[name] = dict(rel_err=rel, payload_equal=payload_equal,
                      dequant_equal=dequant_equal,
                      dequant_shapes=dequant_shapes,
                      hops=len(wire), launches=launches, first_s=first_s,
                      times_s=times, median_s=sorted(times)[len(times) // 2],
                      payload_bytes=sum(q.numel() + s.numel() * 4
                                        for _, q, s in wire))
    del result, total
event("collectives", **coll)
del grad

# the world changes: rank 1 leaves, rank 0 goes on alone
before = checksums(state)
dist.barrier()
dlrover_tpu_torch.shutdown()
if RANK == 1:
    event("left")
    sys.exit(0)
accum = et.grad_accum
runtime.join_world(f"127.0.0.1:{find_free_port()}", 1, 0)
WORLD = dist.get_world_size()
t0 = time.perf_counter()
state = et.on_world_change(state)
event("world_change", world=WORLD, backend=dist.get_backend(),
      grad_accum_before=accum, grad_accum=et.grad_accum,
      replicas=et.plan["num_replicas"],
      params_equal=bool(torch.equal(before, checksums(state))),
      seconds=time.perf_counter() - t0)
state = steps(et, state, tokens, cs.DP_MORE_STEPS, "world1")
dlrover_tpu_torch.shutdown()
'''


def _dp_launch(root, args, mode, extra_env=None):
    """The port's launcher on `args` in a subprocess, train.dp's worker
    under it in `mode`."""
    import os

    repo = os.path.dirname(os.path.abspath(__file__))
    env = {k: v for k, v in os.environ.items()
           if k not in ("DLROVER_TPU_FORCE_CPU", "DLROVER_TPU_JOB_NAME",
                        "DLROVER_TPU_TORCH_DIST_BACKEND")}
    pp = env.get("PYTHONPATH", "")
    env.update(PYTHONPATH=repo + (os.pathsep + pp if pp else ""),
               DP_SMOKE_OUT=root, DP_SMOKE_MODE=mode,
               DLROVER_TPU_RUNTIME_METRICS_PATH=os.path.join(
                   root, f"runtime_metrics_{mode}.json"),
               DLROVER_TPU_CHIP_METRICS_PATH=os.path.join(
                   root, f"chip_metrics_{mode}.json"),
               **(extra_env or {}))
    return subprocess.Popen(
        [sys.executable, "-m", "dlrover_tpu_torch.trainer.elastic_run",
         *args, os.path.join(root, "worker.py")], env=env, cwd=root,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def _dp_wait(procs, root, what):
    """Wait for the launchers (killing them past DP_TIMEOUT_S); raise
    with their output and their workers' logs unless all exit 0."""
    import glob
    import os

    out = []
    try:
        for p in procs:
            text = p.communicate(timeout=DP_TIMEOUT_S)[0]
            out.append((p.returncode, text[-3000:]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if any(rc != 0 for rc, _ in out):
        workers = {os.path.relpath(f, root): _tail(f, 3000) for f in
                   sorted(glob.glob(os.path.join(root, "logs_*", "*.log")))}
        raise AssertionError(f"train.dp {what}: launchers {out}\n"
                             f"workers {workers}")


def _dp_events(root, mode, rank):
    import os

    path = os.path.join(root, f"events_{mode}_{rank}.jsonl")
    with open(path) as f:
        found = {}
        for line in f:
            e = json.loads(line)
            found[e["event"]] = e
    return found


def _dp_reference(n_steps):
    """The (b) model, params and tokens in this process, with no world:
    one replica, accum TRAIN_GLOBAL_BATCH of one row; the losses of
    `n_steps` steps."""
    cfg, et, tokens, gen = _train_setup(_adamw, n_layers=DP_LAYERS,
                                        microbatch=DP_MICROBATCH)
    state = et.init_state(gen)
    losses = []
    for _ in range(n_steps):
        state, m = et.step(state, {"tokens": tokens})
        losses.append(float(m["loss"]))
    grad_accum = et.grad_accum
    del state, et
    torch.cuda.empty_cache()
    return losses, grad_accum


def phase_train_dp(train, smi):
    """Data-parallel training through the launcher a user runs (`python
    -m dlrover_tpu_torch.trainer.elastic_run`, in subprocesses), every
    rank on kernels 1-3, and the compressed collectives on kernels 5
    and 6 over a real world of two ranks.

    (a) `--nnodes 1`: the worker joins a world of one rank on NCCL and
    runs the train phase's config (Llama-3-8B widths, 4 layers, global
    batch 4 in microbatches of 2, 8 steps, the same seed) through
    Trainer over ElasticTrainer over accelerate's reduced step. Checks:
    every loss within TRAIN_LOSS_REL_TOL of train's (bit equality
    reported: an all-reduce over one rank is a copy, and the weighted
    sums are the one-process step's), flash launches by the train
    formula, all wgmma, backend nccl.

    (b) Two agents on this machine (`--nnodes 2`, node 0 hosting the
    master at --master-addr's port), DLROVER_TPU_TORCH_DIST_BACKEND=gloo
    (NCCL refuses two ranks on one card): the 1-layer model (1.27 B
    params, ~24 GB a rank), global batch 4 at most 1 row a replica,
    so each rank runs accum 2 of one row, DP_STEPS steps. Checks: both
    ranks' params bit-equal after the init broadcast and each step (a
    checksum all-gather), every loss within TRAIN_LOSS_REL_TOL of a
    one-process run of the same model on the same global batch, flash
    launches by the formula on each rank. Then rank 1 leaves, rank 0
    joins a world of one and calls on_world_change: params bit-equal
    across it, grad_accum doubled, DP_MORE_STEPS more steps with
    finite, falling losses within the tolerance of the one-process
    run's at those steps. The gloo all-reduce of ~5 GB a step goes
    through the host: the step time is reported, it measures nothing
    of the card.

    (c) On the same two ranks, before the change: each rank's f32
    gradient the size of w_gate from a seed per rank through
    quantized_all_reduce_tree and quantized_reduce_scatter (block
    256). Checks: every int8 payload and its scales byte-equal to the
    plain quantize of the tensor it was made of, kernel 6's output on
    every received payload ([2, L] in the tree, [1, L/2] in the ring's
    hop) bit-equal to the plain dequantize of it, the sums within JAX's
    tolerances of the f32 sum (0.02 tree, 0.15 ring, of the largest
    |value|), kernels 5 and 6 launched once a leaf (tree) and once a
    hop (ring) on each rank. Times reported.

    Launches are counted in the workers, set to 0 just before each
    driven path and read just after."""
    import os
    import shutil

    from dlrover_tpu_torch.agent.ckpt_saver import shm_segment_paths
    from dlrover_tpu_torch.common.messages import find_free_port

    t_phase = time.perf_counter()
    root = os.path.join(_smoke_out(), f"dp-{os.getpid()}")
    jobs = [f"chip-smoke-dp-{os.getpid()}-{x}" for x in ("a", "b0", "b1")]
    os.makedirs(root, exist_ok=True)
    with open(os.path.join(root, "worker.py"), "w") as f:
        f.write(DP_WORKER)
    try:
        # (a)
        t0 = time.perf_counter()
        _dp_wait([_dp_launch(root, [
            "--nnodes", "1", "--max-restarts", "0", "--job-name", jobs[0],
            "--log-dir", os.path.join(root, "logs_a")], "a")], root, "(a)")
        a_wall = time.perf_counter() - t0
        ea = _dp_events(root, "a", 0)
        a = ea["trained"]
        ref = train["losses"]
        a_err = [abs(x - y) / abs(y) for x, y in zip(a["losses"], ref)]

        # the one-process run (b) is held to
        t0 = time.perf_counter()
        ref_b, ref_accum = _dp_reference(DP_STEPS + DP_MORE_STEPS)
        ref_s = time.perf_counter() - t0

        # (b) and (c)
        port = find_free_port()
        t0 = time.perf_counter()
        procs = [_dp_launch(root, [
            "--nnodes", "2", "--node-id", str(n), "--max-restarts", "0",
            "--master-addr", f"127.0.0.1:{port}", "--job-name", jobs[1 + n],
            "--log-dir", os.path.join(root, f"logs_b{n}")], "b",
            {"DLROVER_TPU_TORCH_DIST_BACKEND": "gloo"}) for n in (0, 1)]
        _dp_wait(procs, root, "(b)")
        b_wall = time.perf_counter() - t0
        eb = [_dp_events(root, "b", r) for r in (0, 1)]
        per_pass = DP_LAYERS * eb[0]["world2"]["grad_accum"] * DP_STEPS
        want2 = dict(flash_fwd=2 * per_pass, flash_bwd_dq=per_pass,
                     flash_bwd_dkv=per_pass)
        wc = eb[0]["world_change"]
        per_pass1 = DP_LAYERS * wc["grad_accum"] * DP_MORE_STEPS
        want1 = dict(flash_fwd=2 * per_pass1, flash_bwd_dq=per_pass1,
                     flash_bwd_dkv=per_pass1)
        b_losses = [e["world2"]["losses"] for e in eb]
        after = eb[0]["world1"]["losses"]
        b_err = [abs(x - y) / abs(y) for x, y in
                 zip(b_losses[0] + after, ref_b)]
        coll = [e["collectives"] for e in eb]

        def flash_ok(launches, want):
            return (all(launches[k] == v for k, v in want.items())
                    and all(launches[f"{k}_wgmma"] == launches[k]
                            for k in want))

        checks = dict(
            a_losses_within_tol=len(a["losses"]) == TRAIN_STEPS
            and all(e <= TRAIN_LOSS_REL_TOL for e in a_err),
            a_backend_nccl=ea["init"]["backend"] == "nccl"
            and ea["init"]["world"] == 1,
            a_launches=flash_ok(a["launches"], dict(
                flash_fwd=2 * TRAIN_LAYERS * a["grad_accum"] * TRAIN_STEPS,
                flash_bwd_dq=TRAIN_LAYERS * a["grad_accum"] * TRAIN_STEPS,
                flash_bwd_dkv=TRAIN_LAYERS * a["grad_accum"] * TRAIN_STEPS)),
            b_backend_gloo=all(e["init"]["backend"] == "gloo"
                               and e["init"]["world"] == 2 for e in eb),
            b_accum_2_of_one_row=all(e["model"]["grad_accum"] == 2
                                     and e["model"]["replicas"] == 2
                                     for e in eb),
            b_init_bit_equal=all(e["model"]["init_equal"] for e in eb),
            b_bit_equal_every_step=all(
                e["world2"]["bit_equal"] == [True] * DP_STEPS for e in eb),
            b_ranks_same_losses=b_losses[0] == b_losses[1],
            b_losses_within_tol=all(e <= TRAIN_LOSS_REL_TOL
                                    for e in b_err[:DP_STEPS]),
            b_launches=all(flash_ok(e["world2"]["launches"], want2)
                           for e in eb),
            change_params_bit_equal=wc["params_equal"],
            change_accum_doubled=wc["grad_accum"]
            == 2 * wc["grad_accum_before"] and wc["world"] == 1,
            change_losses=len(after) == DP_MORE_STEPS
            and bool(np.all(np.isfinite(after))) and after[-1] < after[0]
            and all(e <= TRAIN_LOSS_REL_TOL for e in b_err[DP_STEPS:]),
            change_launches=flash_ok(eb[0]["world1"]["launches"], want1),
            rank1_left="left" in eb[1],
            c_payloads_byte_equal=all(
                all(c[k]["payload_equal"]) and c[k]["hops"] == 1
                for c in coll for k in ("tree", "ring")),
            c_dequant_bit_equal=all(
                c[k]["dequant_equal"] == [True]
                and c[k]["dequant_shapes"][0][0] == rows
                for c in coll for k, rows in (("tree", 2), ("ring", 1))),
            c_tree_within_tol=all(c["tree"]["rel_err"] < DP_TREE_REL_TOL
                                  for c in coll),
            c_ring_within_tol=all(c["ring"]["rel_err"] < DP_RING_REL_TOL
                                  for c in coll),
            c_launches=all(c[k]["launches"]["quant_int8"] == 1
                           and c[k]["launches"]["dequant_int8"] == 1
                           for c in coll for k in ("tree", "ring")),
            libraries_prebuilt=all(
                all(e["init"]["prebuilt"].values()) for e in [ea] + eb),
        )
        out = dict(
            nvidia_smi=smi,
            a=dict(losses=a["losses"], train_losses=ref,
                   loss_rel_err=a_err, bit_equal_to_train=a["losses"] == ref,
                   median_step_s=a["median_step_s"],
                   train_median_step_s=train["median_step_s"],
                   peak_mem_gb=a["peak_mem_gb"], launches=a["launches"],
                   grad_accum=a["grad_accum"], backend=ea["init"]["backend"],
                   launcher_wall_s=a_wall),
            b=dict(losses=b_losses, after_change=after, reference=ref_b,
                   reference_grad_accum=ref_accum, reference_s=ref_s,
                   loss_rel_err=b_err,
                   bit_equal_to_reference=b_losses[0] + after == ref_b,
                   step_s=[e["world2"]["step_s"] for e in eb],
                   step_s_after_change=eb[0]["world1"]["step_s"],
                   peak_mem_gb=[e["world2"]["peak_mem_gb"] for e in eb],
                   launches=[e["world2"]["launches"] for e in eb],
                   launches_after_change=eb[0]["world1"]["launches"],
                   world_change=wc, launchers_wall_s=b_wall),
            c=dict(shape=list(DP_COLL_SHAPE), block=DP_COLL_BLOCK,
                   ranks=coll),
            phase_s=time.perf_counter() - t_phase,
            checks=checks,
        )
        # every launch of the phase's driven paths, kernel by kernel
        out["launches"] = {
            k: a["launches"].get(k, 0)
            + sum(e["world2"]["launches"].get(k, 0) for e in eb)
            + eb[0]["world1"]["launches"].get(k, 0)
            + sum(c[p]["launches"].get(k, 0) for c in coll
                  for p in ("tree", "ring"))
            for k in a["launches"]}
        log("train.dp", **out)
        if not all(checks.values()):
            raise AssertionError(
                f"train.dp: failed checks "
                f"{[c for c, ok in checks.items() if not ok]}")
        return out
    finally:
        for j in jobs:
            for path in shm_segment_paths(j):
                if os.path.exists(path):
                    os.unlink(path)
        shutil.rmtree(root, ignore_errors=True)


# train.remat: (cfg.remat_policy, Strategy.remat) of each run; policy
# "none" runs with cfg.remat off, no checkpoint at all (under cfg.remat
# the model checkpoints "none" as "full", as JAX's does)
REMAT_RUNS = (("full", "none"), ("proj", "none"), ("proj_mlp", "none"),
              ("none", "none"), (None, "full"))
REMAT_STEPS = 4
# the policies are compared at one depth: 2 layers, the second time cut
# (TRAIN_LAYERS = 4 before)
REMAT_LAYERS = 2


def _remat_run(policy, strategy_remat):
    """REMAT_STEPS steps of the train phase's model, batch and AdamW
    through `accelerate` with the model's per-layer policy `policy`
    (None or "none": the model's remat off) and
    `Strategy(remat=strategy_remat)` over the whole loss; the launch
    counts set to 0 just before and read just after (flash forward
    twice a pass where anything recomputes the layer's attention, every
    launch on its wgmma variant), the
    losses finite and falling. Before the steps, one microbatch's loss
    body (the same policies) gives `saved_gb`, the memory its forward
    leaves for the backward, and `fwd_bwd_peak_gb`, its forward and
    backward's peak above what was allocated before. Returns the run's
    numbers."""
    from dlrover_tpu_torch.models import llama
    from dlrover_tpu_torch.ops import _build
    from dlrover_tpu_torch.parallel import remat
    from dlrover_tpu_torch.parallel.accelerate import (
        Strategy,
        accelerate,
        param_leaves,
    )

    layer_remat = policy not in (None, "none")
    cfg = llama.LlamaConfig.llama3_8b(
        n_layers=REMAT_LAYERS, remat=layer_remat,
        remat_policy=policy if layer_remat else "full")
    gen = torch.Generator(device="cuda").manual_seed(TRAIN_SEED)
    tokens = torch.randint(0, cfg.vocab_size,
                           (TRAIN_GLOBAL_BATCH, TRAIN_SEQ + 1),
                           generator=gen, device="cuda")
    accum = TRAIN_GLOBAL_BATCH // TRAIN_MICROBATCH
    acc = accelerate(
        lambda g: llama.init_params(cfg, g, dtype=cfg.param_dtype),
        lambda p, b: llama.loss_fn(cfg, p, b), _adamw,
        Strategy(grad_accum=accum, remat=strategy_remat))
    state = acc.init(gen)
    body = remat.apply_remat(lambda p, b: llama.loss_fn(cfg, p, b),
                             strategy_remat)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    loss, _ = body(state["params"], {"tokens": tokens[:TRAIN_MICROBATCH]})
    saved = torch.cuda.memory_allocated() - base
    grads = torch.autograd.grad(loss, param_leaves(state["params"]))
    torch.cuda.synchronize()
    fwd_bwd_peak = torch.cuda.max_memory_allocated() - base
    del loss, grads
    batch = {"tokens": tokens.reshape(accum, TRAIN_MICROBATCH, -1)}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()
    losses, steps_s = [], []
    for _ in range(REMAT_STEPS):
        t0 = time.perf_counter()
        state, m = acc.train_step(state, batch)
        losses.append(m["loss"].item())    # synchronises
        steps_s.append(time.perf_counter() - t0)
    launches = _build.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    name = (f"policy={policy}" if policy is not None
            else f"Strategy(remat={strategy_remat!r})")
    per_pass = cfg.n_layers * accum * REMAT_STEPS
    fwd = 1 if policy in ("none",) and strategy_remat == "none" else 2
    want = dict(flash_fwd=fwd * per_pass, flash_bwd_dq=per_pass,
                flash_bwd_dkv=per_pass)
    if any(launches[k] != v for k, v in want.items()):
        raise AssertionError(f"train.remat {name}: launches {launches}, "
                             f"want {want}")
    _check_wgmma(f"train.remat {name}", launches,
                 ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"))
    if not (all(np.isfinite(losses)) and losses[-1] < losses[0]):
        raise AssertionError(f"train.remat {name}: losses {losses}")
    step_s = float(np.median(steps_s[1:]))
    tokens_per_step = TRAIN_GLOBAL_BATCH * TRAIN_SEQ
    flops_tok = llama.flops_per_token(cfg, TRAIN_SEQ, causal=True)
    out = dict(run=name, policy=policy, strategy_remat=strategy_remat,
               losses=losses, step_s=steps_s, median_step_s=step_s,
               tokens_per_s=tokens_per_step / step_s,
               mfu=flops_tok * tokens_per_step / step_s / PEAK_BF16_FLOPS,
               peak_mem_gb=peak, saved_gb=saved / 2**30,
               fwd_bwd_peak_gb=fwd_bwd_peak / 2**30,
               launches={k: launches[k] for k in want})
    del state, acc, batch, tokens
    torch.cuda.empty_cache()
    return out


def phase_train_remat():
    """train.remat: the train phase's model at REMAT_LAYERS layers
    (Llama-3-8B at full width, f32 params, bf16 compute, 2 microbatches
    of 2 x 2048, AdamW) under the model's remat policies "full", "proj",
    "proj_mlp" and "none", and once with the model's remat off under
    `Strategy(remat="full")` (the whole loss recomputed), REMAT_STEPS
    steps each: median step, tokens/s, MFU (remat not credited), peak
    memory, and one microbatch's saved activations and forward + backward
    peak; peaks must order none >= proj_mlp >= proj >= full, and the
    saved activations strictly so (the step's peak may fall in the
    optimizer step, where the policies hold the same tensors)."""
    runs = [_remat_run(p, s) for p, s in REMAT_RUNS]
    for r in runs:
        log("train.remat", **r)
    for key, strict in (("peak_mem_gb", False), ("saved_gb", True)):
        v = [next(r[key] for r in runs if r["policy"] == p)
             for p in ("none", "proj_mlp", "proj", "full")]
        if not all(a > b if strict else a >= b for a, b in zip(v, v[1:])):
            raise AssertionError(f"train.remat: {key} of none, proj_mlp, "
                                 f"proj, full {v} out of order")
    return runs


FP8_SHAPE = (4096, 4096, 14336)    # x [M, K], w [K, N]: w_gate's
FP8_STEPS = 4
FP8_REL_TOL = 2 ** -7
FP8_TOL_REASON = (
    "2^-7 of the largest |value| of y, dx and dw: the same fp8 operands "
    "and scales on both sides, whose products are exact in f32, but the "
    "fp8 tensor cores keep fewer bits than f32 in the sums they hand to "
    "f32 (on an H100, dx, summed over 14336 products, came 2^-8.3 of "
    "its largest |value| from the f32 product of the upcast operands)")


def _fp8_plain(x, w, sx, sw, g):
    """fp8_dot's forward and backward with every product on the fp8
    values upcast to f32 (the CPU route, here on the card)."""
    from dlrover_tpu_torch.parallel import amp

    qx = amp._quant(x, sx, torch.float8_e4m3fn, amp.E4M3_MAX).float()
    qw = amp._quant(w, sw, torch.float8_e4m3fn, amp.E4M3_MAX).float()
    y = (qx @ qw) / (sx * sw)
    gmax = g.abs().max().float()
    sg = torch.where(gmax > 0, amp.E5M2_MAX / gmax, torch.ones_like(gmax))
    qg = amp._quant(g, sg, torch.float8_e5m2, amp.E5M2_MAX).float()
    return y, (qg @ qw.t()) / (sg * sw), (qx.t() @ qg) / (sx * sg)


def phase_fp8_dot(gen):
    """matmul.fp8_dot: one w_gate-shaped product (x [4096, 4096] and w
    [4096, 14336], bf16) forward and backward through `fp8_dot` for
    FP8_STEPS steps from a zero state: each step's y, dx and dw against
    the plain version on the same scales (FP8_REL_TOL), the histories
    after each step, and the time of a forward and a forward + backward
    beside the bf16 product's."""
    from dlrover_tpu_torch.parallel import amp

    m, k, n = FP8_SHAPE
    x = torch.randn((m, k), generator=gen, device="cuda").bfloat16()
    w = (torch.randn((k, n), generator=gen, device="cuda")
         * k ** -0.5).bfloat16()
    g = torch.randn((m, n), generator=gen, device="cuda")
    state = amp.init_fp8_state()
    steps = []
    for step in range(FP8_STEPS):
        sx = amp._scale_from_history(state.amax_x, amp.E4M3_MAX)
        sw = amp._scale_from_history(state.amax_w, amp.E4M3_MAX)
        xl, wl = x.detach().requires_grad_(), w.detach().requires_grad_()
        y, state = amp.fp8_dot(xl, wl, state)
        dx, dw = torch.autograd.grad(y, (xl, wl), g)
        want = _fp8_plain(x, w, sx, sw, g)
        errs, rel = {}, {}
        for name, a, b in zip(("y", "dx", "dw"), (y, dx, dw), want):
            err = (a.float() - b).abs().max().item()
            tol = FP8_REL_TOL * b.abs().max().item()
            errs[name], rel[name] = err, err / b.abs().max().item()
            if not (torch.isfinite(a).all() and err <= tol):
                raise AssertionError(f"fp8_dot step {step}: {name} err "
                                     f"{err} (tol {tol})")
        steps.append(dict(step=step, sx=sx.item(), sw=sw.item(), errs=errs,
                          rel_errs=rel,
                          amax_x=state.amax_x[:FP8_STEPS].tolist(),
                          amax_w=state.amax_w[:FP8_STEPS].tolist(),
                          amax_g=state.amax_g[:FP8_STEPS].tolist()))
        del y, dx, dw, want
    xl, wl = x.detach().requires_grad_(), w.detach().requires_grad_()

    def fp8_fwd():
        return amp.fp8_dot(x, w, state)

    def fp8_fwd_bwd():
        y, _ = amp.fp8_dot(xl, wl, state)
        return torch.autograd.grad(y, (xl, wl), g)

    gb = g.bfloat16()

    def bf16_fwd_bwd():
        return torch.autograd.grad(xl @ wl, (xl, wl), gb)

    out = dict(
        shape=dict(x=[m, k], w=[k, n]), dtype="bfloat16", steps=steps,
        tol=FP8_REL_TOL, tol_reason=FP8_TOL_REASON,
        fwd_ms=time_ms(fp8_fwd, 10), fwd_bwd_ms=time_ms(fp8_fwd_bwd, 10),
        bf16_fwd_ms=time_ms(lambda: x @ w, 10),
        bf16_fwd_bwd_ms=time_ms(bf16_fwd_bwd, 10),
        bound_fwd_ms=bound_ms(2.0 * m * k * n,
                              2 * (m * k + k * n) + 4 * m * n,
                              2 * PEAK_BF16_FLOPS)[0],
    )
    log("matmul.fp8_dot", **out)
    del x, w, g, gb, xl, wl
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# the model families (`--families`, and last in the plain run)
# ---------------------------------------------------------------------------


def _fam_prompts(vocab, hi):
    """FAM_REQUESTS prompts of 50-`hi` tokens (numpy seed SEED + 1), the
    first at `hi`."""
    rng = np.random.default_rng(SEED + 1)
    lengths = rng.integers(50, hi + 1, size=FAM_REQUESTS)
    lengths[0] = hi
    return [rng.integers(1, vocab, size=int(m)).tolist() for m in lengths]


def _fam_flash_row(gen, shape, b, s, h, causal):
    """Kernel 1 at a family's shape (head_dim 64, MHA) against
    `_fwd_plain`: one launch, on the wgmma variant."""
    from dlrover_tpu_torch.ops import _build
    from dlrover_tpu_torch.ops import flash_attention as fa

    F = torch.nn.functional
    d = 64
    scale = d ** -0.5
    variant = fa._fwd_variant(b, s, s, h, h, d, causal)
    q, k, v = (torch.randn((b, s, h, d), generator=gen,
                           device="cuda").bfloat16() for _ in range(3))
    before = _build.launch_counts()
    o, lse = fa._fwd(q, k, v, causal, scale)
    after = _build.launch_counts()
    o_ref, lse_ref = fa._fwd_plain(q, k, v, causal, scale)
    torch.cuda.synchronize()
    err = (o.float() - o_ref.float()).abs().max().item()
    lse_err = (lse - lse_ref).abs().max().item()
    if not (variant == "wgmma"
            and _launched(before, after, "flash_fwd_wgmma") == 1
            and err <= FLASH_TOL and lse_err <= 1e-3):
        raise AssertionError(
            f"flash_fwd at {shape}: variant {variant}, max_abs_err {err} "
            f"(tol {FLASH_TOL}), lse err {lse_err}")
    pairs = s * (s + 1) / 2 if causal else s * s
    flops = 4.0 * b * h * d * pairs
    bms, by = bound_ms(flops, 2 * 4 * b * s * h * d + 4 * b * h * s)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    row = dict(
        kernel="flash_fwd", shape=shape, B=b, S=s, H=h, KV=h, D=d,
        causal=causal, variant=variant, max_abs_err=err, lse_err=lse_err,
        tol=FLASH_TOL, tol_reason=TOL_REASON,
        ms=device_ms(lambda: fa._fwd(q, k, v, causal, scale)),
        plain_ms=time_ms(lambda: fa._fwd_plain(q, k, v, causal, scale), 3),
        library_ms=device_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=causal)),
        bound_ms=bms, bound_by=by)
    log("kernel.families", **row)
    return row


def _fam_flash_bwd_row(gen, shape, b, s, h, causal):
    """Kernels 2 and 3 at a family's training shape against
    `_bwd_plain`: one launch each, on the wgmma variants. `ms` is the
    whole backward, `library_ms` SDPA's backward (its forward and
    backward captured together, less its forward)."""
    from dlrover_tpu_torch.ops import _build
    from dlrover_tpu_torch.ops import flash_attention as fa

    F = torch.nn.functional
    d = 64
    scale = d ** -0.5
    variant = fa._bwd_variant(b, s, s, h, h, d, causal)
    q, k, v, do = (torch.randn((b, s, h, d), generator=gen,
                               device="cuda").bfloat16() for _ in range(4))
    o, lse = fa._fwd(q, k, v, causal, scale)
    delta = fa._delta(o, do)
    before = _build.launch_counts()
    got = fa._bwd(q, k, v, o, lse, do, causal, scale)
    after = _build.launch_counts()
    want = fa._bwd_plain(q, k, v, o, lse, do, causal, scale)
    torch.cuda.synchronize()
    errs, tols = {}, {}
    for name, x, y in zip(("dq", "dk", "dv"), got, want):
        errs[name] = (x.float() - y.float()).abs().max().item()
        tols[name] = BWD_REL_TOL * y.float().abs().max().item()
    if not (variant == "wgmma"
            and _launched(before, after, "flash_bwd_dq_wgmma") == 1
            and _launched(before, after, "flash_bwd_dkv_wgmma") == 1
            and all(errs[n] <= tols[n] for n in errs)):
        raise AssertionError(
            f"flash backward at {shape}: variant {variant}, errs {errs}, "
            f"tols {tols}")
    del got, want
    pairs = s * (s + 1) / 2 if causal else s * s
    fwd_flops = 4.0 * b * h * d * pairs
    qo = 2 * b * s * h * d
    rows_b = 4 * b * h * s
    bms, by = bound_ms(2.5 * fwd_flops, 8 * qo + 2 * rows_b)
    dq_bms, dq_by = bound_ms(1.5 * fwd_flops, 5 * qo + 2 * rows_b)
    dkv_bms, dkv_by = bound_ms(2.0 * fwd_flops, 6 * qo + 2 * rows_b)
    lib_g = do.transpose(1, 2)

    def leaves():
        return [x.transpose(1, 2).detach().requires_grad_()
                for x in (q, k, v)]

    def lib_fwd(qkv=None):
        return F.scaled_dot_product_attention(*(qkv or leaves()),
                                              is_causal=causal)

    def lib_fwd_bwd():
        qkv = leaves()
        return torch.autograd.grad(lib_fwd(qkv), qkv, lib_g)

    lib_fwd_ms = device_ms(lib_fwd)
    lib_fwd_bwd_ms = device_ms(lib_fwd_bwd)
    row = dict(
        kernel="flash_bwd", shape=shape, B=b, S=s, H=h, KV=h, D=d,
        causal=causal, variant=variant, max_abs_err=max(errs.values()),
        errs=errs, tols=tols, tol_reason=BWD_TOL_REASON,
        ms=device_ms(lambda: fa._bwd(q, k, v, o, lse, do, causal, scale)),
        dq_ms=device_ms(lambda: fa._bwd_dq_cuda(
            q, k, v, do, lse, delta, causal, scale, variant)),
        dkv_ms=device_ms(lambda: fa._bwd_dkv_cuda(
            q, k, v, do, lse, delta, causal, scale, variant)),
        plain_ms=time_ms(
            lambda: fa._bwd_plain(q, k, v, o, lse, do, causal, scale), 3),
        library_ms=lib_fwd_bwd_ms - lib_fwd_ms,
        library_fwd_bwd_ms=lib_fwd_bwd_ms, library_fwd_ms=lib_fwd_ms,
        bound_ms=bms, bound_by=by, dq_bound_ms=dq_bms, dq_bound_by=dq_by,
        dkv_bound_ms=dkv_bms, dkv_bound_by=dkv_by)
    log("kernel.families", **row)
    del q, k, v, do, o, lse, delta
    torch.cuda.empty_cache()
    return row


def _fam_paged_row(gen, quant):
    """Kernel 4 at GPT-2 XL's decode shape (8 rows, 25 heads over 25 KV
    heads of 64, pages of 16, rows of up to 1024 cells), bf16 or int8
    pool: one launch on the TMA-ring kernel; `ms` cold (pool copies
    that overflow L2), `warm_ms` one pool."""
    from dlrover_tpu_torch.ops import _build
    from dlrover_tpu_torch.ops import paged_attention as pa

    q, pages, table, lens, lengths = _paged_case(
        gen, quant, h=25, kv=25, hd=64, per_slot=GPT_MAX_LEN // 16)
    b, h, hd = q.shape
    scale = hd ** -0.5
    cells = int(lengths.sum())
    live = 2 * cells * h * hd * (1 if quant else 2) + (
        2 * cells * h * 2 if quant else 0)
    ref = pa._reference(q, pages, table, lens, scale)
    before = _build.launch_counts()
    ker = pa._kernel(q, pages, table, lens, scale)
    after = _build.launch_counts()
    torch.cuda.synchronize()
    err = (ker.float() - ref.float()).abs().max().item()
    if not (_launched(before, after, "paged_attention_tma") == 1
            and err <= PAGED_TOL):
        raise AssertionError(
            f"paged kernel at gpt2_xl (quant={quant}): launches {before} "
            f"-> {after}, max_abs_err {err} (tol {PAGED_TOL})")
    pools = cold_copies(lambda: {n: t.clone() for n, t in pages.items()},
                        live)
    bms, by = bound_ms(4.0 * cells * h * hd,
                       live + 2 * 2 * b * h * hd + table.numel() * 4 + 4 * b)

    def run(pool):
        return pa._kernel(q, pool, table, lens, scale)

    row = dict(
        kernel="paged_attention", shape="gpt2_xl decode",
        pool="int8" if quant else "bf16", B=b, H=h, KV=h, D=hd, page=16,
        live_cells=cells, variant="tma", max_abs_err=err, tol=PAGED_TOL,
        tol_reason=TOL_REASON,
        ms=device_ms(cycling(run, pools), calls=len(pools)),
        warm_ms=device_ms(lambda: run(pages)),
        plain_ms=time_ms(lambda: pa._reference(q, pages, table, lens,
                                               scale), 5),
        library_ms=None, bound_ms=bms, bound_by=by)
    log("kernel.families", **row)
    del pages, pools
    torch.cuda.empty_cache()
    return row


def _fam_dqmm_rows(gen):
    """The GPT-2 XL int8 install's kernel-5 launches (bytes equal to the
    plain quantizer) and kernel 7 at its four products, T = 8 (decode,
    the TMA-ring kernel) and 1024 (a prefill bucket, the prefill
    kernel), K = 1600 at block 64 not a multiple of the 256-value stage,
    O = 4800 and 1600 not multiples of 128."""
    from dlrover_tpu_torch.ops import _build
    from dlrover_tpu_torch.ops import quantization as tq

    rows = []
    for (k, o), names in GPT2_XL_DQMM:
        block = tq.weight_quant_block(k)
        w = (torch.randn((o, k), generator=gen, device="cuda")
             * k ** -0.5).bfloat16()
        q8, s8 = tq.quantize_int8(w, block)
        q_ref, s_ref = tq._quantize_plain(w, block)
        torch.cuda.synchronize()
        if not (torch.equal(q8, q_ref) and torch.equal(s8, s_ref)):
            raise AssertionError(f"quant kernel bytes differ at {names}")
        n = o * k
        bms, by = bound_ms(3.0 * n, 2 * n + n + 4 * (n // block),
                           PEAK_F32_FLOPS)
        row = dict(kernel="quantize_int8", shape=f"gpt2_xl {names}",
                   input="bfloat16", O=o, K=k, block=block, max_abs_err=0.0,
                   tol=0.0, tol_reason="bytes equal to the plain version",
                   ms=device_ms(lambda: tq.quantize_int8(w, block)),
                   plain_ms=time_ms(lambda: tq._quantize_plain(w, block), 5),
                   library_ms=None, bound_ms=bms, bound_by=by)
        log("kernel.families", **row)
        rows.append(row)
        qws = cold_copies(
            lambda: tq.QuantizedWeight(*tq.quantize_int8(w, block), block),
            n)
        qw = qws[0]
        dense = tq._dq_weight(qw.q8, qw.s8, block, torch.bfloat16)
        for t, want_var in ((8, "dqmm_decode_tma"), (1024, "dqmm_ws")):
            x = torch.randn((t, k), generator=gen, device="cuda").bfloat16()
            before = _build.launch_counts()
            y = tq.quantized_matmul(x, qw)
            after = _build.launch_counts()
            ref = tq.quantized_matmul_reference(x, qw)
            torch.cuda.synchronize()
            err = (y.float() - ref.float()).abs().max().item()
            tol = DQMM_REL_TOL * ref.float().abs().max().item()
            if not (_launched(before, after, want_var) == 1
                    and torch.isfinite(y).all() and err <= tol):
                raise AssertionError(
                    f"dqmm at gpt2_xl {names} T={t}: launches {before} -> "
                    f"{after}, max_abs_err {err} (tol {tol})")
            bms, by = bound_ms(2.0 * t * k * o, n + 4 * o * (k // block)
                               + 2 * t * k + 2 * t * o)
            row = dict(
                kernel="dqmm", shape=f"gpt2_xl {names}", T=t, K=k, O=o,
                block=block, variant=want_var.replace("dqmm_", ""),
                max_abs_err=err, tol=tol, tol_reason=DQMM_TOL_REASON,
                ms=device_ms(cycling(lambda qq: tq.quantized_matmul(x, qq),
                                     qws), calls=max(10, len(qws))),
                plain_ms=time_ms(
                    lambda: tq.quantized_matmul_reference(x, qw), 3),
                dense_ms=device_ms(lambda: x @ dense.t()),
                library_ms=None, bound_ms=bms, bound_by=by)
            log("kernel.families", **row)
            rows.append(row)
        del w, qws, qw, dense
        torch.cuda.empty_cache()
    return rows


def phase_kernel_families(gen):
    """Every kernel at the shapes the family paths give it, before the
    engine and trainer phases use them."""
    rows = [
        _fam_flash_row(gen, "gpt2_xl prefill", 1, GPT_MAX_LEN, 25, True),
        _fam_flash_row(gen, "gpt2_xl train", FAM_TRAIN_BATCH,
                       FAM_TRAIN_SEQ, 25, True),
        _fam_flash_row(gen, "bert_large train", BERT_BATCH, BERT_SEQ, 16,
                       False),
        _fam_flash_bwd_row(gen, "gpt2_xl train", FAM_TRAIN_BATCH,
                           FAM_TRAIN_SEQ, 25, True),
        _fam_flash_bwd_row(gen, "bert_large train", BERT_BATCH, BERT_SEQ,
                           16, False),
        _fam_paged_row(gen, False),
        _fam_paged_row(gen, True),
    ]
    return rows + _fam_dqmm_rows(gen)


@contextlib.contextmanager
def _moe_recorder(rec):
    """Record (S, moe_aux_loss, moe_dropped_frac) of every `moe_mlp`
    call (models/llama.py looks the function up at each call)."""
    from dlrover_tpu_torch.models import moe

    orig = moe.moe_mlp

    def recording(cfg, params, x, compute_dtype=torch.bfloat16):
        y, m = orig(cfg, params, x, compute_dtype)
        rec.append((x.shape[1], m["moe_aux_loss"].detach(),
                    m["moe_dropped_frac"].detach()))
        return y, m

    moe.moe_mlp = recording
    try:
        yield rec
    finally:
        moe.moe_mlp = orig


@contextlib.contextmanager
def _moe_routing(picks, replay=False):
    """Pin one pass's MoE routing to another's. Without replay, append
    each gating call's expert picks (`moe._top_k_masks`) to `picks` in
    call order; with replay, route the i-th call by picks[i] in place of
    its own, and yield the calls, the tokens, the tokens whose own picks
    differ and the largest top-k margin (gap between consecutive sorted
    gates) among those."""
    from dlrover_tpu_torch.models import moe

    orig = moe._top_k_masks
    stats = {"calls": 0, "tokens": 0, "tokens_rerouted": 0,
             "rerouted_max_margin": 0.0}

    def pick(gates, k):
        own = orig(gates, k)
        if not replay:
            picks.append(own)
            return own
        forced = picks[stats["calls"]]
        stats["calls"] += 1
        differ = torch.zeros(gates.shape[:-1], dtype=torch.bool,
                             device=gates.device)
        for o, f in zip(own, forced):
            differ |= (o != f).any(dim=-1)
        top = torch.sort(gates, dim=-1, descending=True).values[..., :k + 1]
        margin = (top[..., :-1] - top[..., 1:]).min(dim=-1).values
        stats["tokens"] += differ.numel()
        n = int(differ.sum())
        stats["tokens_rerouted"] += n
        if n:
            stats["rerouted_max_margin"] = max(
                stats["rerouted_max_margin"], float(margin[differ].max()))
        return forced

    moe._top_k_masks = pick
    try:
        yield stats
    finally:
        moe._top_k_masks = orig


def _moe_summary(rec):
    """Mean aux loss and dropped share of the recorded calls, split into
    calls over one position (decode) and over more (prefill, training)."""
    out = {}
    for kind, keep in (("multi", lambda s: s > 1), ("single",
                                                     lambda s: s == 1)):
        sel = [(a, d) for s, a, d in rec if keep(s)]
        if sel:
            out[f"{kind}_position_calls"] = len(sel)
            out[f"{kind}_moe_aux_loss_mean"] = float(
                torch.stack([a for a, _ in sel]).float().mean())
            out[f"{kind}_moe_dropped_frac_mean"] = float(
                torch.stack([d for _, d in sel]).float().mean())
    return out


def _fam_serve(phase, cfg, params, prompts, max_len, weight_quant="none",
               moe_rec=None):
    """`prompts` greedy through the paged engine (8 slots, pages of 16,
    chunk 8), launch counts set to 0 just before the engine is built and
    read after the last step: every prefill on the wgmma flash forward,
    every decode on the TMA paged kernel, and with int8 weights every
    product on kernel 7 (prefill products on the prefill kernel, decode
    ones on the TMA-ring decode kernel) after one kernel-5 launch a
    layer slice of each quantized weight."""
    from dlrover_tpu_torch.ops import _build
    from dlrover_tpu_torch.ops.quantization import QuantizedWeight
    from dlrover_tpu_torch.serving.engine import ContinuousBatcher

    kw = dict(n_slots=FAM_SLOTS, max_len=max_len, max_new_tokens=FAM_MAX_NEW,
              chunk=8, kv_layout="paged", page_size=16,
              weight_quant=weight_quant)
    warm = ContinuousBatcher(cfg, params, **kw)
    warm.generate_all([prompts[1][:40]])
    del warm
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    engine = ContinuousBatcher(cfg, params, **kw)
    torch.cuda.synchronize()
    install_s = time.perf_counter() - t0
    quant_launches = _build.launch_counts()["quant_int8"]
    ctx = (_moe_recorder(moe_rec) if moe_rec is not None
           else contextlib.nullcontext())
    with ctx:
        outs, tm = _serve(engine, prompts, FAM_MAX_NEW)
    torch.cuda.synchronize()
    launches = _build.launch_counts()
    lens = [len(o) for o in outs]
    toks = np.concatenate(outs)
    if lens != [FAM_MAX_NEW] * len(prompts) or toks.min() < 0 or \
            toks.max() >= cfg.vocab_size:
        raise AssertionError(f"{phase}: token counts {lens}, ids in "
                             f"[{toks.min()}, {toks.max()}]")
    L = cfg.n_layers
    want = dict(flash_fwd=engine.admissions * L,
                paged_attention=engine.decode_steps * L)
    if any(launches[k] != v for k, v in want.items()):
        raise AssertionError(f"{phase}: launches {launches}, want {want}")
    _check_wgmma(phase, launches)
    _check_paged_tma(phase, launches)
    e2e = dict(requests=len(prompts),
               prompt_lens=[len(p) for p in prompts], max_new=FAM_MAX_NEW,
               n_slots=FAM_SLOTS, max_len=max_len,
               admissions=engine.admissions,
               decode_steps=engine.decode_steps, launches=launches,
               install_s=install_s,
               weight_bytes=engine.weight_bytes_device(),
               step_stats=engine.step_stats(), **_timings(tm, lens))
    if weight_quant != "none":
        per_forward = sum(isinstance(w, QuantizedWeight)
                          for w in engine.params["layers"].values()) * L
        by_variant = dict(
            ws=launches["dqmm_ws"], decode_tma=launches["dqmm_decode_tma"],
            other=(launches["dqmm"] - launches["dqmm_ws"]
                   - launches["dqmm_decode_tma"]))
        want_variant = dict(ws=engine.admissions * per_forward,
                            decode_tma=engine.decode_steps * per_forward,
                            other=0)
        if (by_variant != want_variant or quant_launches != per_forward
                or engine.weight_quant_path != "int8:kernel"):
            raise AssertionError(
                f"{phase}: dqmm launches by variant {by_variant}, want "
                f"{want_variant}; quant launches at install "
                f"{quant_launches}, want {per_forward}; path "
                f"{engine.weight_quant_path}")
        e2e.update(dqmm_launches_by_variant=by_variant,
                   quant_launches_at_install=quant_launches,
                   weight_quant_path=engine.weight_quant_path,
                   weight_quant_stats=engine.weight_quant_stats())
    del engine
    torch.cuda.empty_cache()
    e2e["outs"] = outs
    return e2e


def _log_e2e(phase, e2e):
    log(phase, **{k: v for k, v in e2e.items() if k != "outs"})


def phase_serve_gpt2_xl(gen):
    """GPT-2 XL at full width and depth (48 layers, random bf16 weights
    from the generator) through the paged engine, then with
    weight_quant="int8" on the same weights."""
    from dlrover_tpu_torch.models import gpt

    cfg = gpt.GptConfig.gpt2_xl()
    t0 = time.perf_counter()
    params = gpt.init_params(cfg, gen)
    torch.cuda.synchronize()
    log("model.gpt2_xl", params=gpt.num_params(cfg), n_layers=cfg.n_layers,
        heads=cfg.n_heads, head_dim=cfg.head_dim, vocab=cfg.vocab_size,
        dtype=str(cfg.dtype), init_s=time.perf_counter() - t0)
    prompts = _fam_prompts(cfg.vocab_size, GPT_PROMPT_MAX)
    bf16 = _fam_serve("serve.gpt2_xl", cfg, params, prompts, GPT_MAX_LEN)
    _log_e2e("serve.gpt2_xl", bf16)
    ref_cfg = dataclasses.replace(cfg, attn_impl="reference")
    _check_first_decode(
        "serve.gpt2_xl.first_decode_logits",
        _first_decode_logits(cfg, params, prompts[0], GPT_MAX_LEN),
        _first_decode_logits(ref_cfg, params, prompts[0], GPT_MAX_LEN),
        "5% of the largest logit: bf16 roundings of the two attention "
        "paths carried through 48 layers")
    int8 = _fam_serve("serve.gpt2_xl.int8", cfg, params, prompts,
                      GPT_MAX_LEN, weight_quant="int8")
    ratio = int8["weight_bytes"] / bf16["weight_bytes"]
    int8.update(
        bf16_weight_bytes=bf16["weight_bytes"], weight_bytes_ratio=ratio,
        bf16_greedy_streams_identical=sum(
            int(np.array_equal(a, b)) for a, b in zip(int8["outs"],
                                                      bf16["outs"])),
        bf16_greedy_token_agreement=float(np.mean(
            np.concatenate(int8["outs"]) == np.concatenate(bf16["outs"]))))
    _log_e2e("serve.gpt2_xl.int8", int8)
    if not ratio <= 0.55:
        raise AssertionError(f"serve.gpt2_xl.int8: weight bytes {ratio} of "
                             "bf16's, want <= 0.55")
    del params
    torch.cuda.empty_cache()
    return bf16, int8


def _mixtral(n_layers):
    from dlrover_tpu_torch.models import llama

    return llama.LlamaConfig(n_layers=n_layers, **MIXTRAL_8X7B)


def phase_serve_moe(gen):
    """The MoE Llama at Mixtral-8x7B's widths, cut to MOE_SERVE_LAYERS
    layers (random bf16 weights), through the paged engine at max_len
    2048 on prompts of 50-1000 tokens; the MoE layers' aux loss and
    dropped share recorded on every call."""
    from dlrover_tpu_torch.models import llama

    cfg = _mixtral(MOE_SERVE_LAYERS)
    t0 = time.perf_counter()
    params = llama.init_params(cfg, gen)
    torch.cuda.synchronize()
    log("model.moe", config="mixtral_8x7b widths", n_layers=cfg.n_layers,
        params=llama.num_params(cfg), n_experts=cfg.n_experts,
        top_k=cfg.moe_top_k, dtype=str(cfg.dtype),
        init_s=time.perf_counter() - t0)
    prompts = _fam_prompts(cfg.vocab_size, MOE_PROMPT_MAX)
    rec = []
    e2e = _fam_serve("serve.moe", cfg, params, prompts, MOE_MAX_LEN,
                     moe_rec=rec)
    e2e.update(moe=_moe_summary(rec))
    _log_e2e("serve.moe", e2e)
    # the plain pass routes by the kernel pass's expert picks: top-k is
    # discontinuous, and a near-tie that a bf16 rounding moves reroutes
    # a token and, through the capacity's slot order, drops others
    ref_cfg = dataclasses.replace(cfg, attn_impl="reference")
    picks = []
    with _moe_routing(picks):
        lk = _first_decode_logits(cfg, params, prompts[0], MOE_MAX_LEN)
    with _moe_routing(picks, replay=True) as routing:
        lr = _first_decode_logits(ref_cfg, params, prompts[0], MOE_MAX_LEN)
    if routing["calls"] != len(picks):
        raise AssertionError(f"serve.moe: the plain pass made "
                             f"{routing['calls']} gating calls, the "
                             f"kernel pass {len(picks)}")
    unpinned = _first_decode_logits(ref_cfg, params, prompts[0], MOE_MAX_LEN)
    log("serve.moe.routing", **routing,
        unpinned_max_abs_err=(lk - unpinned).abs().max().item())
    _check_first_decode(
        "serve.moe.first_decode_logits", lk, lr,
        f"5% of the largest logit: bf16 roundings of the two attention "
        f"paths carried through {MOE_SERVE_LAYERS} layers, the plain pass "
        f"routed by the kernel pass's expert picks")
    del params
    torch.cuda.empty_cache()
    return e2e


def _fam_train(phase, et, state, batches, want, flops_tok=None,
               moe_rec=None):
    """len(batches) Trainer steps, launch counts set to 0 just before
    and read just after: exactly `want` (every flash launch on its
    wgmma variant), finite and falling losses."""
    from dlrover_tpu_torch.ops import _build
    from dlrover_tpu_torch.trainer.trainer import (
        Trainer,
        TrainerCallback,
        TrainingArguments,
    )

    class Record(TrainerCallback):
        def __init__(self):
            self.ends, self.losses, self.aux = [], [], []

        def on_step_end(self, trainer, state, metrics):
            self.ends.append(time.perf_counter())
            if "moe_aux_loss" in metrics:
                self.aux.append(float(metrics["moe_aux_loss"]))

        def on_log(self, trainer, state, logs):
            self.losses.append(logs["loss"])

    rec = Record()
    trainer = Trainer(et, TrainingArguments(
        max_steps=len(batches), logging_steps=1, save_steps=0,
        resume=False), train_data=batches, callbacks=[rec])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()
    ctx = (_moe_recorder(moe_rec) if moe_rec is not None
           else contextlib.nullcontext())
    t0 = time.perf_counter()
    with ctx:
        state = trainer.train(state)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _build.launch_counts()
    if any(launches[k] != v for k, v in want.items()):
        raise AssertionError(f"{phase}: launches {launches}, want {want}")
    _check_wgmma(phase, launches, tuple(k for k, v in want.items()
                                        if k.startswith("flash") and v))
    losses = rec.losses
    if not (len(losses) == len(batches) and all(np.isfinite(losses))
            and losses[-1] < losses[0]):
        raise AssertionError(f"{phase}: losses {losses}, not finite or "
                             "not falling")
    steps_s = np.diff([t0] + rec.ends)
    step_s = float(np.median(steps_s[1:]))
    first = next(iter(batches[0].values()))
    tokens = int(np.prod(first.shape))
    out = dict(steps=len(batches), losses=losses, step_s=steps_s.tolist(),
               median_step_s=step_s, wall_s=wall,
               tokens_per_step=tokens, tokens_per_s=tokens / step_s,
               peak_mem_gb=torch.cuda.max_memory_allocated() / 2**30,
               launches=launches)
    if flops_tok is not None:
        out.update(flops_per_token=flops_tok,
                   mfu=flops_tok * tokens / step_s / PEAK_BF16_FLOPS,
                   mfu_formula="(6 N + 12 L S D) x tokens / step / 989 "
                               "TFLOP/s")
    if rec.aux:
        out["moe_aux_loss"] = rec.aux
    return out, state


def _fam_trainer(init, loss_fn, batch, lr=TRAIN_LR, wd=TRAIN_WD):
    from dlrover_tpu_torch.trainer.elastic.trainer import ElasticTrainer

    n = next(iter(batch.values())).shape[0]
    return ElasticTrainer(
        init, loss_fn,
        lambda ps: torch.optim.AdamW(ps, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                                     weight_decay=wd),
        global_batch_size=n, max_per_replica_batch=n)


def phase_train_gpt2_xl():
    """GPT-2 XL, all 48 layers: f32 params, bf16 compute, remat (a
    checkpoint a layer), AdamW(1e-4), 8 steps of 4 x 1025 tokens."""
    from dlrover_tpu_torch.models import gpt

    cfg = gpt.GptConfig.gpt2_xl()
    assert cfg.remat
    gen = torch.Generator(device="cuda").manual_seed(FAM_SEED)
    tokens = torch.randint(0, cfg.vocab_size,
                           (FAM_TRAIN_BATCH, FAM_TRAIN_SEQ + 1),
                           generator=gen, device="cuda")
    batch = {"tokens": tokens}
    et = _fam_trainer(lambda g: gpt.init_params(cfg, g,
                                                dtype=cfg.param_dtype),
                      lambda p, b: gpt.loss_fn(cfg, p, b), batch)
    state = et.init_state(gen)
    per = cfg.n_layers * FAM_TRAIN_STEPS
    out, state = _fam_train(
        "train.gpt2_xl", et, state, [batch] * FAM_TRAIN_STEPS,
        dict(flash_fwd=2 * per, flash_bwd_dq=per, flash_bwd_dkv=per),
        flops_tok=gpt.flops_per_token(cfg, FAM_TRAIN_SEQ))
    out.update(config="gpt2_xl", n_layers=cfg.n_layers,
               params=gpt.num_params(cfg), batch=FAM_TRAIN_BATCH,
               seq=FAM_TRAIN_SEQ, param_dtype=str(cfg.param_dtype),
               compute_dtype=str(cfg.dtype), remat="full a layer")
    log("train.gpt2_xl", **out)
    del state, et
    torch.cuda.empty_cache()
    return out


def phase_train_moe():
    """The MoE Llama at Mixtral-8x7B's widths, MOE_TRAIN_LAYERS layer:
    f32 params, bf16 compute, remat, AdamW(1e-4), 8 steps of 4 x 1025
    tokens; the aux loss rides the loss, its value and the dropped
    share are reported."""
    from dlrover_tpu_torch.models import llama

    cfg = _mixtral(MOE_TRAIN_LAYERS)
    gen = torch.Generator(device="cuda").manual_seed(FAM_SEED + 1)
    tokens = torch.randint(0, cfg.vocab_size,
                           (FAM_TRAIN_BATCH, FAM_TRAIN_SEQ + 1),
                           generator=gen, device="cuda")
    batch = {"tokens": tokens}
    et = _fam_trainer(lambda g: llama.init_params(cfg, g,
                                                  dtype=cfg.param_dtype),
                      lambda p, b: llama.loss_fn(cfg, p, b), batch)
    state = et.init_state(gen)
    per = cfg.n_layers * FAM_TRAIN_STEPS
    rec = []
    out, state = _fam_train(
        "train.moe", et, state, [batch] * FAM_TRAIN_STEPS,
        dict(flash_fwd=2 * per, flash_bwd_dq=per, flash_bwd_dkv=per),
        moe_rec=rec)
    out.update(config="mixtral_8x7b widths", n_layers=cfg.n_layers,
               params=llama.num_params(cfg), batch=FAM_TRAIN_BATCH,
               seq=FAM_TRAIN_SEQ, moe=_moe_summary(rec))
    if not all(np.isfinite(out.get("moe_aux_loss", [np.nan]))):
        raise AssertionError(f"train.moe: aux losses {out.get('moe_aux_loss')}")
    log("train.moe", **out)
    del state, et
    torch.cuda.empty_cache()
    return out


def phase_train_bert_large():
    """BERT-large MLM at S = 512, B = 8, 15% of the positions masked: 8
    unpadded steps (the non-causal flash forward and both backward
    kernels once a layer a step), then one step on a padded batch
    (padding rides segment_ids: the reference attention, no flash
    launch)."""
    from dlrover_tpu_torch.models import bert
    from dlrover_tpu_torch.ops import _build

    cfg = bert.BertConfig.large()
    gen = torch.Generator(device="cuda").manual_seed(FAM_SEED + 2)
    labels = torch.randint(1000, cfg.vocab_size, (BERT_BATCH, BERT_SEQ),
                           generator=gen, device="cuda")
    mask = (torch.rand((BERT_BATCH, BERT_SEQ), generator=gen,
                       device="cuda") < BERT_MASK_FRAC)
    batch = {"tokens": torch.where(mask, BERT_MASK_ID, labels),
             "labels": labels, "mlm_mask": mask.float()}
    et = _fam_trainer(lambda g: bert.init_params(cfg, g),
                      lambda p, b: bert.mlm_loss_fn(cfg, p, b), batch)
    state = et.init_state(gen)
    per = cfg.n_layers * FAM_TRAIN_STEPS
    out, state = _fam_train(
        "train.bert_large", et, state, [batch] * FAM_TRAIN_STEPS,
        dict(flash_fwd=per, flash_bwd_dq=per, flash_bwd_dkv=per),
        flops_tok=bert.flops_per_token(cfg, BERT_SEQ))
    pad = torch.ones((BERT_BATCH, BERT_SEQ), dtype=torch.int32,
                     device="cuda")
    pad[:, BERT_SEQ * 3 // 4:] = 0
    _build.reset_launch_counts()
    state, m = et.step(state, dict(batch, attention_mask=pad))
    torch.cuda.synchronize()
    padded = _build.launch_counts()
    if padded["flash_fwd"] or padded["flash_bwd_dq"] or not np.isfinite(
            float(m["loss"])):
        raise AssertionError(f"train.bert_large padded batch: launches "
                             f"{padded}, loss {float(m['loss'])}")
    out.update(config="bert_large", params=bert.num_params(cfg),
               batch=BERT_BATCH, seq=BERT_SEQ, mask_frac=BERT_MASK_FRAC,
               masked_tokens=int(mask.sum()),
               padded_batch=dict(loss=float(m["loss"]),
                                 flash_launches=padded["flash_fwd"]))
    log("train.bert_large", **out)
    del state, et
    torch.cuda.empty_cache()
    return out


def phase_train_cnn():
    """The MNIST CNN preset on random images (B = CNN_BATCH), 8 AdamW
    steps on one batch: the loss falls. No kernel of the port runs (the
    convolutions are cuDNN's, as JAX's are XLA's)."""
    from dlrover_tpu_torch.models import cnn

    cfg = cnn.CnnConfig.mnist()
    gen = torch.Generator(device="cuda").manual_seed(FAM_SEED + 3)
    batch = {"images": torch.randn((CNN_BATCH, cfg.image_size,
                                    cfg.image_size, cfg.in_channels),
                                   generator=gen, device="cuda"),
             "labels": torch.randint(0, cfg.n_classes, (CNN_BATCH,),
                                     generator=gen, device="cuda")}
    et = _fam_trainer(lambda g: cnn.init_params(cfg, g),
                      lambda p, b: cnn.loss_fn(cfg, p, b), batch,
                      lr=CNN_LR, wd=0.0)
    state = et.init_state(gen)
    out, state = _fam_train("train.cnn", et, state,
                            [batch] * FAM_TRAIN_STEPS, {})
    if any(out["launches"].values()):
        raise AssertionError(f"train.cnn launched {out['launches']}")
    out.update(config="mnist", params=cnn.num_params(cfg), batch=CNN_BATCH)
    log("train.cnn", **out)
    del state, et
    return out


def phase_families(gen):
    """The model families' phases, each path's launch counts set to 0
    just before it and read just after (the kernel phase first)."""
    torch.cuda.empty_cache()
    rows = phase_kernel_families(gen)
    gpt_serve, gpt_int8 = phase_serve_gpt2_xl(gen)
    moe_serve = phase_serve_moe(gen)
    return dict(
        rows=rows, serve={"serve.gpt2_xl": gpt_serve,
                          "serve.gpt2_xl.int8": gpt_int8,
                          "serve.moe": moe_serve},
        train={"train.gpt2_xl": phase_train_gpt2_xl(),
               "train.moe": phase_train_moe(),
               "train.bert_large": phase_train_bert_large(),
               "train.cnn": phase_train_cnn()})


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


def phase_profile_train(int8, fused_ce=False):
    """`--profile --train [--int8-adam] [--fused-ce]`: where the device
    time of one training step of the train phase goes (after two
    warm-up steps), by CUDA kernel, and the device's busy share of the
    step's wall time; with AdamW, or with int8_adam as in
    train.int8_adam; with the fused loss as in train.ckpt."""
    from torch.profiler import ProfilerActivity, profile

    from dlrover_tpu_torch.optim import int8_adam

    _, et, tokens, gen = _train_setup(
        int8_adam(TRAIN_LR, weight_decay=TRAIN_WD) if int8 else _adamw,
        fused_ce=fused_ce)
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
        fused_ce=fused_ce,
        wall_ms=1e3 * wall, device_ms=dev_us / 1e3,
        device_busy_share=dev_us / 1e6 / wall,
        top=[(e.key[:60], e.count, e.self_device_time_total / 1e3)
             for e in rows[:20]])
    print(prof.key_averages().table(
        sort_by="self_device_time_total", row_limit=40), flush=True)


def main():
    t_start = time.perf_counter()
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
    if "--jax-gate-shapes" in args:
        phase_jax_gate_shapes(gen)
        return 0
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
        phase_profile_train("--int8-adam" in sys.argv[1:],
                            "--fused-ce" in sys.argv[1:])
        return 0
    if "--profile" in sys.argv[1:]:
        cfg = llama.LlamaConfig.llama3_8b()
        phase_profile(llama.init_params(cfg, gen), cfg,
                      "int8" if "--int8" in sys.argv[1:] else "none")
        return 0
    if "--spec" in args:
        cfg = llama.LlamaConfig.llama3_8b()
        params = llama.init_params(cfg, gen)
        e2e = phase_serve(params, cfg)
        phase_serve_spec(params, cfg)
        phase_verify(params, cfg)
        phase_serve_spec(params, cfg, "int8")
        phase_serve_async(params, cfg, e2e)
        return 0
    if "--adapters" in args:
        cfg = llama.LlamaConfig.llama3_8b()
        params = llama.init_params(cfg, gen)
        e2e = phase_serve(params, cfg)
        phase_adapters_and_refresh(params, cfg, e2e)
        return 0
    if "--sched" in args:
        cfg = llama.LlamaConfig.llama3_8b()
        params = llama.init_params(cfg, gen)
        e2e = phase_serve(params, cfg)
        e2e_int8 = phase_serve_int8(params, cfg, e2e)
        phase_serve_int8_stochastic(params, cfg, e2e_int8)
        phase_serve_sched(params, cfg)
        log("total", wall_s=time.perf_counter() - t_start, nvidia_smi=smi)
        return 0
    if "--master" in args:
        phase_train_master(phase_train(), smi)
        log("total", wall_s=time.perf_counter() - t_start, nvidia_smi=smi)
        return 0
    if "--agent" in args:
        phase_train_agent(phase_train(), smi)
        log("total", wall_s=time.perf_counter() - t_start, nvidia_smi=smi)
        return 0
    if "--rl" in args:
        train = phase_train()
        phase_train_lora(train)
        phase_rl_ppo(train)
        log("total", wall_s=time.perf_counter() - t_start, nvidia_smi=smi)
        return 0
    if "--dp" in args:
        phase_train_dp(phase_train(), smi)
        log("total", wall_s=time.perf_counter() - t_start, nvidia_smi=smi)
        return 0
    if "--fleet" in args:
        cfg = llama.LlamaConfig.llama3_8b()
        params = llama.init_params(cfg, gen)
        phase_serve_fleet(params, cfg, probes=True)
        log("total", wall_s=time.perf_counter() - t_start, nvidia_smi=smi)
        return 0
    if "--tp" in args:
        phase_kernel_sharded(gen)
        cfg = llama.LlamaConfig.llama3_8b()
        params = llama.init_params(cfg, gen)
        e2e = phase_serve(params, cfg)
        phase_serve_tp2(params, cfg, e2e)
        phase_serve_tp2_resize(params, cfg)
        phase_serve_tp2_int8(params, cfg)
        log("total", wall_s=time.perf_counter() - t_start, nvidia_smi=smi)
        return 0
    if "--families" in args:
        phase_families(gen)
        log("total", wall_s=time.perf_counter() - t_start, nvidia_smi=smi)
        return 0
    if "--tier" in args:
        cfg = llama.LlamaConfig.llama3_8b()
        params = llama.init_params(cfg, gen)
        e2e = phase_serve(params, cfg)
        pressure_prompts = _pressure_prompts(cfg)
        pressure = phase_serve_pressure(
            params, cfg, pressure_prompts,
            _pressure_reference(params, cfg, pressure_prompts), 0)
        phase_serve_kv_tier(params, cfg, pressure_prompts, pressure)
        phase_serve_kv_tier(params, cfg, pressure_prompts, pressure,
                            kv_quant=True)
        phase_serve_handoff(params, cfg, e2e)
        log("total", wall_s=time.perf_counter() - t_start, nvidia_smi=smi)
        return 0
    flash_rows = phase_flash(gen)
    bwd_rows = phase_flash_bwd(gen)
    paged_rows = phase_paged(gen)
    sharded_flash_rows, sharded_paged_rows = phase_kernel_sharded(gen)
    quant_rows = phase_quant(gen)
    dequant_rows = phase_dequant(gen)
    phase_opt_int8()
    dqmm_rows = phase_dqmm(gen)
    torch.cuda.empty_cache()
    gate_rows = phase_jax_gate_shapes(gen)

    cfg = llama.LlamaConfig.llama3_8b()
    t0 = time.perf_counter()
    params = llama.init_params(cfg, gen)
    torch.cuda.synchronize()
    log("model", config="llama3_8b", params=llama.num_params(cfg),
        dtype=str(cfg.dtype), init_s=time.perf_counter() - t0)
    e2e = phase_serve(params, cfg)
    e2e_tp2 = phase_serve_tp2(params, cfg, e2e)
    tp2_resize = phase_serve_tp2_resize(params, cfg)
    tp2_int8 = phase_serve_tp2_int8(params, cfg)
    e2e_int8 = phase_serve_int8(params, cfg, e2e)
    e2e_stoch = phase_serve_int8_stochastic(params, cfg, e2e_int8)
    e2e_spec = phase_serve_spec(params, cfg)
    phase_verify(params, cfg)
    e2e_spec_int8 = phase_serve_spec(params, cfg, "int8")
    e2e_async = phase_serve_async(params, cfg, e2e)
    adapter_runs = phase_adapters_and_refresh(params, cfg, e2e)
    pressure_prompts = _pressure_prompts(cfg)
    pressure_ref = _pressure_reference(params, cfg, pressure_prompts)
    e2e_pressure = phase_serve_pressure(params, cfg, pressure_prompts,
                                        pressure_ref, 0)
    e2e_chunked = phase_serve_pressure(params, cfg, pressure_prompts,
                                       pressure_ref, 256)
    e2e_tier = phase_serve_kv_tier(params, cfg, pressure_prompts,
                                   e2e_pressure)
    e2e_tier_int8 = phase_serve_kv_tier(params, cfg, pressure_prompts,
                                        e2e_pressure, kv_quant=True)
    handoff_runs = phase_serve_handoff(params, cfg, e2e)
    e2e_sched = phase_serve_sched(params, cfg)
    e2e_fleet = phase_serve_fleet(params, cfg)
    del params
    torch.cuda.empty_cache()
    train = phase_train()
    ckpt = phase_train_ckpt(train)
    master_run = phase_train_master(train, smi)
    agent_run = phase_train_agent(train, smi)
    dp_run = phase_train_dp(train, smi)
    train_int8 = phase_train_int8(train)
    train_lora = phase_train_lora(train)
    rl_run = phase_rl_ppo(train)
    remat_runs = phase_train_remat()
    phase_fp8_dot(gen)
    fam = phase_families(gen)

    main_flash = next(r for r in flash_rows if (r["B"], r["S"]) == (1, 512))
    main_bwd = next(r for r in bwd_rows if (r["B"], r["S"]) == (2, 2048))
    tp_paths = {"serve.tp2": e2e_tp2, "serve.tp2.int8": tp2_int8}
    serve_paths = {"serve": e2e, **tp_paths,
                   "serve.tp2.resize": tp2_resize,
                   "serve.int8": e2e_int8,
                   "serve.int8_stochastic": e2e_stoch,
                   "serve.spec": e2e_spec, "serve.spec.int8": e2e_spec_int8,
                   "serve.async": e2e_async, **adapter_runs,
                   "serve.prefix_pressure": e2e_pressure,
                   "serve.prefill_chunk": e2e_chunked,
                   "serve.kv_tier": e2e_tier,
                   "serve.kv_tier.int8kv": e2e_tier_int8, **handoff_runs,
                   "serve.sched": e2e_sched, "serve.fleet": e2e_fleet}
    remat_paths = {f"train.remat {r['run']}": r for r in remat_runs}
    flash_by_path = {**{path: run["launches"]["flash_fwd"]
                        for path, run in serve_paths.items()},
                     "train": train["launches"]["flash_fwd"],
                     "train.ckpt": ckpt["launches"]["flash_fwd"],
                     "train.master": master_run["launches"]["flash_fwd"],
                     "train.master.resume":
                         master_run["launches_resume"]["flash_fwd"],
                     "train.agent": agent_run["launches"]["flash_fwd"],
                     "train.dp": dp_run["launches"]["flash_fwd"],
                     "train.int8_adam": train_int8["launches"]["flash_fwd"],
                     "train.lora": train_lora["launches"]["flash_fwd"],
                     "rl.ppo": rl_run["launches"]["flash_fwd"],
                     **{path: r["launches"]["flash_fwd"]
                        for path, r in remat_paths.items()}}
    bwd_by_path = {name: {"train": train["launches"][name],
                          "train.ckpt": ckpt["launches"][name],
                          "train.master": master_run["launches"][name],
                          "train.master.resume":
                              master_run["launches_resume"][name],
                          "train.agent": agent_run["launches"][name],
                          "train.dp": dp_run["launches"][name],
                          "train.int8_adam": train_int8["launches"][name],
                          "train.lora": train_lora["launches"][name],
                          "rl.ppo": rl_run["launches"][name],
                          **{path: r["launches"][name]
                             for path, r in remat_paths.items()}}
                   for name in ("flash_bwd_dq", "flash_bwd_dkv")}
    flash_by_path.update({path: run["launches"]["flash_fwd"] for path, run
                          in {**fam["serve"], **fam["train"]}.items()})
    for name in ("flash_bwd_dq", "flash_bwd_dkv"):
        bwd_by_path[name].update({path: run["launches"][name]
                                  for path, run in fam["train"].items()})
    serve_paths.update(fam["serve"])
    paged_by_path = {path: run["launches"]["paged_attention"]
                     for path, run in serve_paths.items()}
    main_paged = paged_rows[0]
    main_quant = next(r for r in quant_rows if r["input"] == "bfloat16")
    quant_by_path = {"serve.int8": e2e_int8["launches"]["quant_int8"],
                     "serve.tp2.int8": tp2_int8["launches"]["quant_int8"],
                     "serve.int8_stochastic": e2e_stoch["launches"][
                         "quant_int8"],
                     "serve.spec.int8": e2e_spec_int8["launches"][
                         "quant_int8"],
                     **{path: adapter_runs[path]["launches"]["quant_int8"]
                        for path in ("serve.adapters.int8",
                                     "serve.refresh.int8")},
                     "train.int8_adam": train_int8["launches"]["quant_int8"],
                     "train.dp": dp_run["launches"]["quant_int8"],
                     "serve.gpt2_xl.int8": fam["serve"]["serve.gpt2_xl.int8"][
                         "launches"]["quant_int8"]}
    dqmm_paths = {"serve.int8": e2e_int8,
                  "serve.int8_stochastic": e2e_stoch,
                  "serve.spec.int8": e2e_spec_int8,
                  "serve.adapters.int8": adapter_runs["serve.adapters.int8"],
                  "serve.refresh.int8": adapter_runs["serve.refresh.int8"],
                  "serve.gpt2_xl.int8": fam["serve"]["serve.gpt2_xl.int8"]}
    main_dequant = dequant_rows[0]
    main_dqmm = next(r for r in dqmm_rows
                     if (r["T"], r["K"], r["O"]) == (8, 4096, 14336))
    main_ws = next(r for r in dqmm_rows
                   if (r["T"], r["K"], r["O"]) == (1024, 4096, 14336))
    verify_dqmm = next(r for r in dqmm_rows
                       if (r["T"], r["K"], r["O"]) == (40, 4096, 14336))
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    main_sflash = next(r for r in sharded_flash_rows
                       if (r["tp"], r["S"]) == (2, 512))
    main_spaged = next(r for r in sharded_paged_rows
                       if (r["tp"], r["pool"]) == (2, "bf16"))
    tp_paths["serve.tp2.resize (its tp=2 steps)"] = dict(
        launches=tp2_resize["launches_by_tp"]["2"])
    sflash_by_path = {p: r["launches"]["flash_fwd"]
                      for p, r in tp_paths.items()}
    spaged_by_path = {p: r["launches"]["paged_attention"]
                      for p, r in tp_paths.items()}

    def gate(name):
        # kernel.jax_gate_shapes' rows of this kernel (launches there are
        # the comparison's, not a main path's)
        return [r for r in gate_rows if r["kernel"] == name]

    def family(name):
        # kernel.families' rows: the model families' shapes
        return [r for r in fam["rows"] if r["kernel"] == name]

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
             per_shape=flash_rows, jax_gate_shapes=gate("flash_fwd"),
             family_shapes=family("flash_fwd")),
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
             per_shape=bwd_rows, jax_gate_shapes=gate("flash_bwd_dq"),
             family_shapes=family("flash_bwd")),
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
                   "inputs)", jax_gate_shapes=gate("flash_bwd_dkv"),
             family_shapes=family("flash_bwd")),
        dict(name="paged_attention", route="cuda",
             source="dlrover_tpu_torch/csrc/paged_attention.cu",
             replaces="dlrover_tpu/ops/paged_attention.py:160",
             launches=sum(paged_by_path.values()),
             launches_by_path=paged_by_path,
             variant=main_paged["variant"], warm_ms=main_paged["warm_ms"],
             old_ms=main_paged["old_ms"],
             old_warm_ms=main_paged["old_warm_ms"],
             **{k: main_paged[k] for k in keys},
             shape="B=8 H=32 KV=8 D=128 page 16 bf16 pool, 5812 live "
                   "cells (ms: cold, the pool cycled through copies that "
                   "overflow L2; warm_ms: one pool; old_*: the split "
                   "kernel it replaced; the int8 pool in per_variant)",
             per_variant=paged_rows,
             int8_pool_launches_by_path={
                 path: run["launches"]["paged_attention_tma_int8"]
                 for path, run in serve_paths.items()
                 if run["launches"].get("paged_attention_tma_int8")},
             jax_gate_shapes=gate("paged_attention"),
             family_shapes=family("paged_attention")),
        dict(name="flash_fwd_sharded", route="cuda",
             source="dlrover_tpu_torch/csrc/flash_fwd.cu",
             replaces="dlrover_tpu/ops/flash_attention.py:567",
             launches=sum(sflash_by_path.values()),
             launches_by_path=sflash_by_path, variant="wgmma",
             tp1_ms=main_sflash["tp1_ms"],
             **{k: main_sflash[k] for k in keys},
             shape="tp=2 virtual shards of the card, B=1 S=512 H=32 KV=8 "
                   "D=128 bf16 causal, a launch a shard (tp1_ms: the "
                   "unsharded kernel; tp=4 and S=2048 in per_shape; "
                   "launches: serve.tp2, serve.tp2.int8 and the tp=2 "
                   "steps of serve.tp2.resize)",
             per_shape=sharded_flash_rows),
        dict(name="paged_attention_sharded", route="cuda",
             source="dlrover_tpu_torch/csrc/paged_attention.cu",
             replaces="dlrover_tpu/ops/paged_attention.py:287",
             launches=sum(spaged_by_path.values()),
             launches_by_path=spaged_by_path, variant="tma",
             warm_ms=main_spaged["warm_ms"], tp1_ms=main_spaged["tp1_ms"],
             tp1_warm_ms=main_spaged["tp1_warm_ms"],
             **{k: main_spaged[k] for k in keys},
             shape="tp=2 virtual shards of the card, B=8 H=32 KV=8 D=128 "
                   "page 16, bf16 pool, a TMA-ring launch a shard on the "
                   "unsharded launch's work partition (ms: cold, pool "
                   "copies overflowing L2; tp1_*: the unsharded kernel; "
                   "tp=4 and the int8 pool in per_variant; launches: "
                   "serve.tp2, serve.tp2.int8 and the tp=2 steps of "
                   "serve.tp2.resize)",
             per_variant=sharded_paged_rows),
        dict(name="quantize_int8", route="cuda",
             source="dlrover_tpu_torch/csrc/quant_int8.cu",
             replaces="dlrover_tpu/ops/quantization.py:44",
             launches=sum(quant_by_path.values()),
             launches_by_path=quant_by_path,
             **{k: main_quant[k] for k in keys},
             shape="[14336, 4096] bf16 -> int8, block 256 (one w_gate "
                   "layer, output-major; the embedding's f32 moment as "
                   "[1, 525336576] in per_input)",
             per_input=quant_rows, jax_gate_shapes=gate("quantize_int8"),
             family_shapes=family("quantize_int8")),
        dict(name="dequantize_int8", route="cuda",
             source="dlrover_tpu_torch/csrc/dequant_int8.cu",
             replaces="dlrover_tpu/ops/quantization.py:55",
             launches=train_int8["launches"]["dequant_int8"]
             + dp_run["launches"]["dequant_int8"],
             launches_by_path={
                 "train.int8_adam": train_int8["launches"]["dequant_int8"],
                 "train.dp": dp_run["launches"]["dequant_int8"]},
             **{k: main_dequant[k] for k in keys},
             shape="[1, 525336576] int8 -> f32, block 256 (the embedding's "
                   "moment as the int8 AdamW holds it)",
             per_shape=dequant_rows,
             jax_gate_shapes=gate("dequantize_int8")),
        dict(name="dqmm", route="cuda",
             source="dlrover_tpu_torch/csrc/dqmm.cu",
             replaces="dlrover_tpu/ops/quantization.py:306",
             launches=sum(r["launches"]["dqmm"] for r in dqmm_paths.values()),
             launches_by_path={path: r["launches"]["dqmm"]
                               for path, r in dqmm_paths.items()},
             launches_by_variant={
                 path: r["dqmm_launches_by_variant"]
                 for path, r in dqmm_paths.items()},
             **{k: main_dqmm[k] for k in keys},
             variant=main_dqmm["variant"], old_ms=main_dqmm["old_ms"],
             dense_ms=main_dqmm["dense_ms"],
             prefill_ms=main_ws["ms"], prefill_bound_ms=main_ws["bound_ms"],
             prefill_dense_ms=main_ws["dense_ms"],
             verify_ms=verify_dqmm["ms"],
             verify_plain_ms=verify_dqmm["plain_ms"],
             verify_dense_ms=verify_dqmm["dense_ms"],
             verify_bound_ms=verify_dqmm["bound_ms"],
             verify_bound_by=verify_dqmm["bound_by"],
             verify_max_abs_err=verify_dqmm["max_abs_err"],
             shape="T=8 K=4096 O=14336 (w_gate decode, the TMA-ring "
                   "decode kernel; old_ms: the mma.sync decode kernel it "
                   "replaced) bf16 x int8, block 256; prefill_*: the same "
                   "weight at T=1024 on the prefill kernel (dqmm_ws); "
                   "verify_*: at T=40, a verify of 8 slots x 5 positions "
                   "(dqmm_ws)",
             per_shape=dqmm_rows, jax_gate_shapes=gate("dqmm"),
             family_shapes=family("dqmm")),
    ]
    log("total", wall_s=time.perf_counter() - t_start, nvidia_smi=smi)
    print(json.dumps({"kernels": kernels}, default=float), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
