// Per-block int8 dequantization for Hopper (sm_90a).
//
// Replaces: dlrover_tpu/ops/quantization.py `_dequant_kernel`, launched by
// `dequantize_int8` (the Pallas TPU kernel: q reshaped to [rows, block],
// one quant block per row, 1024-row VMEM tiles; x = (f32(q) * scale)
// cast to the output type). The int8 AdamW dequantizes both moments of
// every param leaf with it at every step, as one [1, padded] row block.
//
// What bounds it on this card: bytes. Per value it reads 1 byte and
// writes 4 (f32) or 2 (bf16), plus one 4-byte scale per block, against
// 3.35 TB/s; one product and one rounding per value are far below the
// f32 rate.
//
// Design: no shared memory. A 256-thread block takes a tile of 4096
// values as four 1024-value slabs; in each slab a thread takes 4
// consecutive values: one 4-byte load of int8, the scale of their
// block (blocks are 8 values or more, so 4 consecutive values share
// one; the lanes of a quant block read the same address, which the
// load unit broadcasts), one 16-byte store of f32 (8 bytes of bf16).
// So every load and store instruction of a warp covers one contiguous
// span (128 bytes of int8, 512 of f32, 256 of bf16), and a thread
// issues its four loads before its first store. (16 consecutive values
// a thread instead, one 16-byte load and four 16-byte stores 64 bytes
// apart between neighbouring lanes, reaches only half an H100's memory
// rate with f32 output.) The largest leaf on the training path (the
// 128256 x 4096 embedding, 525 M values, 2.1 GB of f32 output) is
// 128 k blocks, so the 132 SMs stay full. Offsets are 64-bit
// throughout: that output is past 2^31 bytes.
//
// Blocks that are not a power of two of 8 or more (JAX's kernel takes
// any block that divides the row): `dequant_int8_any_kernel`, one value
// a thread, its scale found by a division. A power of two above 256
// (the int8 AdamW's `block=512`) keeps the kernel above: 4 consecutive
// values still share a scale.
//
// Bytes: the product is one IEEE f32 multiply (a lone product, which
// nvcc does not contract into anything), and bf16 output rounds it to
// nearest even with __float2bfloat16_rn, as torch's .to(bfloat16) does;
// so the output equals the plain version's bit for bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;
constexpr int SLABS = 4;              // 4-value chunks a thread
constexpr int64_t TILE = NT * 4 * SLABS;

__device__ inline void store4(float* x, const float* v) {
  *reinterpret_cast<float4*>(x) = make_float4(v[0], v[1], v[2], v[3]);
}

__device__ inline uint32_t bf16_pair(float lo, float hi) {
  return (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(lo)) |
         ((uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(hi)) << 16);
}

__device__ inline void store4(__nv_bfloat16* x, const float* v) {
  *reinterpret_cast<uint2*>(x) =
      make_uint2(bf16_pair(v[0], v[1]), bf16_pair(v[2], v[3]));
}

// values: a multiple of 4 (of the block, which is 8 or more)
template <typename T>
__global__ void __launch_bounds__(NT)
dequant_int8_kernel(const int8_t* __restrict__ q, const float* __restrict__ s,
                    T* __restrict__ x, int64_t values, int log2_block) {
  const int64_t tile = (int64_t)blockIdx.x * TILE;
  uint32_t w[SLABS] = {};
  float scale[SLABS] = {};
#pragma unroll
  for (int j = 0; j < SLABS; ++j) {
    const int64_t i = tile + (int64_t)(j * NT + threadIdx.x) * 4;
    if (i < values) {
      w[j] = __ldg(reinterpret_cast<const uint32_t*>(q + i));
      scale[j] = __ldg(s + (i >> log2_block));
    }
  }
#pragma unroll
  for (int j = 0; j < SLABS; ++j) {
    const int64_t i = tile + (int64_t)(j * NT + threadIdx.x) * 4;
    if (i >= values) break;
    float v[4];
#pragma unroll
    for (int k = 0; k < 4; ++k)
      v[k] = (float)(int8_t)((w[j] >> (8 * k)) & 0xffu) * scale[j];
    store4(x + i, v);
  }
}

__device__ inline void store1(float* x, float v) { *x = v; }
__device__ inline void store1(__nv_bfloat16* x, float v) {
  *x = __float2bfloat16_rn(v);
}

// any block: one value a thread
template <typename T>
__global__ void __launch_bounds__(NT)
dequant_int8_any_kernel(const int8_t* __restrict__ q,
                        const float* __restrict__ s, T* __restrict__ x,
                        int64_t values, int block) {
  const int64_t i = (int64_t)blockIdx.x * NT + threadIdx.x;
  if (i < values) store1(x + i, (float)q[i] * __ldg(s + i / block));
}

template <typename T>
int launch(const void* q, const void* s, void* x, long long rows, int block,
           cudaStream_t stream) {
  if (block < 1) return (int)cudaErrorInvalidValue;
  const long long values = rows * block;
  if (block < 8 || (block & (block - 1))) {
    dequant_int8_any_kernel<T><<<(unsigned)((values + NT - 1) / NT), NT, 0,
                                 stream>>>(
        (const int8_t*)q, (const float*)s, (T*)x, values, block);
    return (int)cudaGetLastError();
  }
  dequant_int8_kernel<T><<<(unsigned)((values + TILE - 1) / TILE), NT, 0,
                           stream>>>(
      (const int8_t*)q, (const float*)s, (T*)x, values,
      __builtin_ctz((unsigned)block));
  return (int)cudaGetLastError();
}

}  // namespace

// q: [rows, block] int8; s: [rows] f32; x: [rows, block] f32
// (out_bf16 = 0) or bf16 (1); all contiguous and 16-byte aligned;
// any block >= 1.
extern "C" int dequant_int8(int out_bf16, const void* q, const void* s,
                            void* x, long long rows, int block,
                            void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (rows <= 0) return 0;
  if (out_bf16) return launch<__nv_bfloat16>(q, s, x, rows, block, st);
  return launch<float>(q, s, x, rows, block, st);
}
