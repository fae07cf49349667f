"""PyTorch/CUDA port of dlrover_tpu, written for one NVIDIA H100.

The JAX package (`dlrover_tpu`) stays the reference; this package keeps
its module layout and names so each counterpart is easy to find, and
imports nothing from it. Plain tensor code is PyTorch; every Pallas
kernel on a ported path is a CUDA C++ kernel under `csrc/`, built with
`nvcc` at first use (`ops/_build.py`).

Ported so far: the paged serving path — `serving/engine.py`
(`ContinuousBatcher`) over `models/decode.py` and `models/llama.py`,
with the flash-attention forward (`ops/flash_attention.py`) and the
paged-attention decode kernel (`ops/paged_attention.py`), and its
int8 weight-quantized form (`weight_quant="int8"`: the quantize and
dequant-matmul kernels of `ops/quantization.py`), behind the scheduler,
the replica pool and the HTTP gateway of `serving/` (host code, with
the port's own `master/kv_store.py` and `brain/`); one-device training
(`trainer/`, `parallel/accelerate.py`, the flash-attention backward
kernels, the chunked cross entropy of `ops/fused_ce.py`, and flash
checkpoint: `trainer/flash_checkpoint/` over `agent/ckpt_saver.py`
and `common/`), fed by the job master in one process (`master/`, over
the stdlib transport of `common/comm.py`), its client
(`agent/master_client.py`) and the elastic data pipeline
(`trainer/elastic/data.py`); and the optimizer package `optim/` (`int8_adam`,
`bf16_adam`, `agd`, `wsam` / `sam_gradient`, muP), whose int8 AdamW
runs the quantize and the dequantize kernels (`ops/quantization.py`)
on its moments. Every Pallas kernel of the JAX package now has its
CUDA counterpart.
"""
