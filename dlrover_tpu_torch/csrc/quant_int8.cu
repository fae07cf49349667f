// Symmetric per-block int8 quantization for Hopper (sm_90a).
//
// Replaces: dlrover_tpu/ops/quantization.py `_quant_kernel`, launched by
// `quantize_int8` (the Pallas TPU kernel: x reshaped to [rows, block],
// one quant block per row, 1024-row VMEM tiles; per row amax, scale =
// amax / 127 or 1.0 where amax is 0, q = clip(round(x / scale), +-127)).
//
// What bounds it on this card: bytes. Per value it reads 4 (f32) or 2
// (bf16) bytes and writes 1, plus 4 bytes of scale per block, against
// 3.35 TB/s; the arithmetic (a max, a divide, a round) is far below
// the f32 rate. It runs once per quantized weight at engine install.
//
// Design: no VMEM tile. A quant row of `block` values (8 to 256, a
// power of two) is held by block/8 consecutive lanes, 8 values each
// (one 16-byte load for bf16, two for f32), so a warp covers 32/(block/8)
// rows and every load is coalesced. The row's max |x| reduces over its
// lanes with xor shuffles; each lane then writes its 8 int8 as one
// 8-byte store and the row's first lane writes the scale.
//
// Bytes: the output must equal the plain version's and the JAX
// kernel's. The JAX division by the constant 127 is compiled by XLA
// into a product with the f32 reciprocal, so the scale is amax *
// (1.0f / 127.0f) here too; x / scale is an IEEE division (the build
// has no --use_fast_math, so `/` is correctly rounded and denormals are
// kept), and rintf rounds half to even as jnp.round does. bf16 input
// widens to f32 exactly, so it gives the bytes of the same values in
// f32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;

__device__ inline void load8(const float* p, float* v) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

__device__ inline void load8(const __nv_bfloat16* p, float* v) {
  const uint4 raw = __ldg(reinterpret_cast<const uint4*>(p));
  const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    // a bf16 is the top half of its f32
    v[2 * i] = __uint_as_float(w[i] << 16);
    v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// G = block / 8 lanes per quant row
template <typename T, int G>
__global__ void __launch_bounds__(NT)
quant_int8_kernel(const T* __restrict__ x, int8_t* __restrict__ q,
                  float* __restrict__ s, int64_t rows) {
  constexpr int BLOCK = 8 * G;
  const int64_t tid = (int64_t)blockIdx.x * NT + threadIdx.x;
  const int64_t row = tid / G;
  const int col = (int)(tid % G) * 8;
  const bool valid = row < rows;
  float v[8];
  if (valid) {
    load8(x + row * BLOCK + col, v);
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i) v[i] = 0.f;
  }
  float amax = 0.f;
#pragma unroll
  for (int i = 0; i < 8; ++i) amax = fmaxf(amax, fabsf(v[i]));
  // every lane of the warp takes part; G divides 32, so a row's lanes
  // are one aligned group and the xor offsets stay inside it
#pragma unroll
  for (int off = G / 2; off >= 1; off /= 2)
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
  if (!valid) return;
  const float scale = amax > 0.f ? amax * (1.0f / 127.0f) : 1.0f;
  uint32_t packed[2] = {0u, 0u};
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    float r = rintf(v[i] / scale);
    r = fminf(fmaxf(r, -127.f), 127.f);
    const uint32_t b = (uint32_t)(uint8_t)(int8_t)(int)r;
    packed[i / 4] |= b << (8 * (i % 4));
  }
  *reinterpret_cast<uint2*>(q + row * BLOCK + col) =
      make_uint2(packed[0], packed[1]);
  if (col == 0) s[row] = scale;
}

// G = block / 8 lanes a row
template <typename T, int G>
int launch_rows(const void* x, void* q, void* s, long long rows,
                cudaStream_t stream) {
  const long long threads = rows * G;
  const dim3 grid((unsigned)((threads + NT - 1) / NT));
  quant_int8_kernel<T, G><<<grid, NT, 0, stream>>>(
      (const T*)x, (int8_t*)q, (float*)s, rows);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* x, void* q, void* s, long long rows, int block,
           cudaStream_t stream) {
  switch (block) {
    case 8: return launch_rows<T, 1>(x, q, s, rows, stream);
    case 16: return launch_rows<T, 2>(x, q, s, rows, stream);
    case 32: return launch_rows<T, 4>(x, q, s, rows, stream);
    case 64: return launch_rows<T, 8>(x, q, s, rows, stream);
    case 128: return launch_rows<T, 16>(x, q, s, rows, stream);
    case 256: return launch_rows<T, 32>(x, q, s, rows, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// x: [rows, block] f32 (is_bf16 = 0) or bf16 (1), contiguous and
// 16-byte aligned; q: [rows, block] int8; s: [rows] f32.
extern "C" int quant_int8(int is_bf16, const void* x, void* q, void* s,
                          long long rows, int block, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (rows <= 0) return 0;
  if (is_bf16) return launch<__nv_bfloat16>(x, q, s, rows, block, st);
  return launch<float>(x, q, s, rows, block, st);
}
