// Paged-attention decode for Hopper (sm_90a): one query per row
// attends over its pages of a global K/V page pool.
//
// Replaces: dlrover_tpu/ops/paged_attention.py `_paged_kernel`,
// launched by `_kernel` (the Pallas TPU kernel: grid (B, KV, P), the
// page table and lengths as scalar-prefetch operands so the pipeline
// streams physical pages, online softmax across the page axis, int8
// pages dequantized in the loop).
//
// What bounds it on this card: memory. Each decode step reads every
// live K/V cell once (plus one bf16 scale per cell for int8 pools) and
// does 4 FLOPs per cell element per query head, far below the ~295
// FLOPs/byte the H100 needs before compute matters. So the bound is
// live bytes / 3.35 TB/s, and the design is about keeping enough loads
// in flight across the whole card.
//
// Design: the TPU kernel walks the page axis in order on one core; here
// the cells of a row are split so that every SM streams:
//  * over blocks: grid (KV head, batch row, split); each block takes 128
//    consecutive cells of the row (splits past a row's length exit at
//    once, and a second small kernel merges the splits' partial softmax
//    states by log-sum-exp);
//  * over the 4 warps of a block: 32 cells each;
//  * over the 32 lanes of a warp, twice. For the scores, lane i takes
//    cell i whole: it looks up its page, streams its K row in 16-byte
//    loads and dots it with the n_rep query heads of the GQA group
//    (held in shared memory, f32) — no reduction across lanes. One warp
//    max and sum per query head then update the running softmax state
//    for all 32 cells at once. For P V, lane i owns head_dim columns
//    [i*EPL, (i+1)*EPL) of the f32 accumulator and the warp walks the
//    32 cells, reading each V row in one coalesced vector load.
// The group's query heads share every K/V byte loaded. Cells at or past
// lengths[b] are never read; int8 pages are dequantized on load with
// their bf16 per-cell scales (HBM traffic stays int8); a row with no
// live cell (l == 0) writes zeros.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int NWARPS = 4;
constexpr int NT = NWARPS * 32;
constexpr int CHUNK = 32;  // cells per warp step: one per lane

__device__ inline float to_f(float x) { return x; }
__device__ inline float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ inline float to_f(int8_t x) { return (float)x; }
template <typename T> __device__ inline T from_f(float x);
template <> __device__ inline float from_f<float>(float x) { return x; }
template <> __device__ inline __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// one lane's EPL consecutive elements as a single aligned vector load
template <typename PT, int EPL>
__device__ inline void load_vec(const PT* p, float* out) {
  constexpr int BYTES = EPL * (int)sizeof(PT);
  if constexpr (BYTES >= 16) {
    uint4 raw[BYTES / 16];
#pragma unroll
    for (int i = 0; i < BYTES / 16; ++i)
      raw[i] = reinterpret_cast<const uint4*>(p)[i];
    const PT* e = reinterpret_cast<const PT*>(raw);
#pragma unroll
    for (int j = 0; j < EPL; ++j) out[j] = to_f(e[j]);
  } else if constexpr (BYTES == 8) {
    uint2 raw = *reinterpret_cast<const uint2*>(p);
    const PT* e = reinterpret_cast<const PT*>(&raw);
#pragma unroll
    for (int j = 0; j < EPL; ++j) out[j] = to_f(e[j]);
  } else if constexpr (BYTES == 4) {
    uint32_t raw = *reinterpret_cast<const uint32_t*>(p);
    const PT* e = reinterpret_cast<const PT*>(&raw);
#pragma unroll
    for (int j = 0; j < EPL; ++j) out[j] = to_f(e[j]);
  } else {
    static_assert(BYTES == 2, "EPL * sizeof(PT) must be >= 2");
    uint16_t raw = *reinterpret_cast<const uint16_t*>(p);
    const PT* e = reinterpret_cast<const PT*>(&raw);
#pragma unroll
    for (int j = 0; j < EPL; ++j) out[j] = to_f(e[j]);
  }
}

__device__ inline float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

__device__ inline float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

// T: query/output type; PT: page element type (T, or int8 with scales)
template <typename T, typename PT, bool QUANT, int NREP, int HD>
__global__ void __launch_bounds__(NT)
paged_partial_kernel(const T* __restrict__ q, const PT* __restrict__ kp,
                     const PT* __restrict__ vp,
                     const __nv_bfloat16* __restrict__ ks,
                     const __nv_bfloat16* __restrict__ vs,
                     const int* __restrict__ table,
                     const int* __restrict__ lengths,
                     float* __restrict__ part_ml,   // [B, H, S, 2]
                     float* __restrict__ part_acc,  // [B, H, S, hd]
                     int n_table, int ps, int kvh, int splits,
                     int chunks_per_split, float scale) {
  constexpr int EPL = HD / 32;                  // P V: lane's columns
  constexpr int PER16 = 16 / (int)sizeof(PT);   // elements per 16 B
  extern __shared__ __align__(16) float smem[];
  float* sQ = smem;                             // [NREP, HD]
  float* sP = sQ + NREP * HD;                   // [NWARPS, NREP, 32]
  float* sM = sP + NWARPS * NREP * CHUNK;       // [NWARPS, NREP]
  float* sL = sM + NWARPS * NREP;               // [NWARPS, NREP]
  float* sAcc = sL + NWARPS * NREP;             // [NWARPS, NREP, HD]

  const int g = blockIdx.x;
  const int b = blockIdx.y;
  const int split = blockIdx.z;
  const int h = kvh * NREP;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int length = max(lengths[b], 0);
  const int n_chunks = (length + CHUNK - 1) / CHUNK;
  const int c_begin = split * chunks_per_split;
  const int c_end = min(n_chunks, c_begin + chunks_per_split);
  if (c_begin >= c_end) return;  // the combine reads only used splits

  for (int idx = threadIdx.x; idx < NREP * HD; idx += NT)
    sQ[idx] = to_f(q[((int64_t)b * h + g * NREP) * HD + idx]);
  __syncthreads();

  float m[NREP], l[NREP], acc[NREP][EPL];
#pragma unroll
  for (int r = 0; r < NREP; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
#pragma unroll
    for (int j = 0; j < EPL; ++j) acc[r][j] = 0.f;
  }
  float* pw = sP + warp * NREP * CHUNK;

  for (int t = c_begin + warp; t < c_end; t += NWARPS) {
    // scores: lane c takes cell cell0 + c and its whole K row
    const int cell0 = t * CHUNK;
    const int n_valid = min(CHUNK, length - cell0);
    const bool valid = lane < n_valid;
    int64_t cidx = 0;                           // [page, off, kv] index
    float sc[NREP];
#pragma unroll
    for (int r = 0; r < NREP; ++r) sc[r] = 0.f;
    if (valid) {
      const int cell = cell0 + lane;
      const int64_t page = table[(int64_t)b * n_table + cell / ps];
      cidx = (page * ps + cell % ps) * kvh + g;
      const PT* krow = kp + cidx * HD;
#pragma unroll
      for (int i = 0; i < HD; i += PER16) {
        float kf[PER16];
        load_vec<PT, PER16>(krow + i, kf);
#pragma unroll
        for (int r = 0; r < NREP; ++r) {
#pragma unroll
          for (int j = 0; j < PER16; j += 4) {
            const float4 qv =
                *reinterpret_cast<const float4*>(sQ + r * HD + i + j);
            sc[r] += qv.x * kf[j] + qv.y * kf[j + 1] + qv.z * kf[j + 2] +
                     qv.w * kf[j + 3];
          }
        }
      }
      const float ksc = QUANT ? __bfloat162float(ks[cidx]) : 1.f;
#pragma unroll
      for (int r = 0; r < NREP; ++r) sc[r] *= ksc * scale;
    }
    // one online-softmax update per query head for the whole chunk
    float alpha[NREP];
#pragma unroll
    for (int r = 0; r < NREP; ++r) {
      const float s = valid ? sc[r] : -INFINITY;
      const float m_new = fmaxf(m[r], warp_max(s));  // lane 0 is valid
      alpha[r] = expf(m[r] - m_new);
      const float p = valid ? expf(s - m_new) : 0.f;
      l[r] = alpha[r] * l[r] + warp_sum(p);
      m[r] = m_new;
      pw[r * CHUNK + lane] = p;
    }
    __syncwarp();
    // P V: lane owns head_dim columns [lane*EPL, +EPL); cell by cell
#pragma unroll
    for (int r = 0; r < NREP; ++r)
#pragma unroll
      for (int j = 0; j < EPL; ++j) acc[r][j] *= alpha[r];
#pragma unroll 4
    for (int c = 0; c < CHUNK; ++c) {
      if (c < n_valid) {
        const int64_t ci = __shfl_sync(0xffffffffu, cidx, c);
        float vf[EPL];
        load_vec<PT, EPL>(vp + ci * HD + lane * EPL, vf);
        const float vsc = QUANT ? __bfloat162float(vs[ci]) : 1.f;
#pragma unroll
        for (int r = 0; r < NREP; ++r) {
          const float p = pw[r * CHUNK + c] * vsc;
#pragma unroll
          for (int j = 0; j < EPL; ++j) acc[r][j] += p * vf[j];
        }
      }
    }
    __syncwarp();  // pw is rewritten by the next chunk
  }

  // merge the warps' partial states
#pragma unroll
  for (int r = 0; r < NREP; ++r) {
    if (lane == 0) {
      sM[warp * NREP + r] = m[r];
      sL[warp * NREP + r] = l[r];
    }
#pragma unroll
    for (int j = 0; j < EPL; ++j)
      sAcc[(warp * NREP + r) * HD + lane * EPL + j] = acc[r][j];
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < NREP * HD; idx += NT) {
    const int r = idx / HD, d = idx % HD;
    float mx = -INFINITY;
#pragma unroll
    for (int w = 0; w < NWARPS; ++w) mx = fmaxf(mx, sM[w * NREP + r]);
    float lsum = 0.f, a = 0.f;
    if (mx != -INFINITY) {
#pragma unroll
      for (int w = 0; w < NWARPS; ++w) {
        const float f = expf(sM[w * NREP + r] - mx);
        lsum += f * sL[w * NREP + r];
        a += f * sAcc[(w * NREP + r) * HD + d];
      }
    }
    const int64_t row = ((int64_t)b * h + g * NREP + r) * splits + split;
    part_acc[row * HD + d] = a;
    if (d == 0) {
      part_ml[row * 2] = mx;
      part_ml[row * 2 + 1] = lsum;
    }
  }
}

// log-sum-exp merge of the splits: one block per (b, query head)
template <typename T>
__global__ void paged_combine_kernel(const float* __restrict__ part_ml,
                                     const float* __restrict__ part_acc,
                                     const int* __restrict__ lengths,
                                     T* __restrict__ out, int h, int splits,
                                     int chunks_per_split, int hd) {
  const int64_t bh = blockIdx.x;
  const int length = max(lengths[bh / h], 0);
  const int n_chunks = (length + CHUNK - 1) / CHUNK;
  const int used = min(splits, (n_chunks + chunks_per_split - 1) /
                                   chunks_per_split);
  const float* ml = part_ml + bh * splits * 2;
  float mx = -INFINITY;
  for (int s = 0; s < used; ++s) mx = fmaxf(mx, ml[2 * s]);
  for (int d = threadIdx.x; d < hd; d += blockDim.x) {
    float lsum = 0.f, a = 0.f;
    if (mx != -INFINITY) {
      for (int s = 0; s < used; ++s) {
        const float f = expf(ml[2 * s] - mx);
        lsum += f * ml[2 * s + 1];
        a += f * part_acc[(bh * splits + s) * hd + d];
      }
    }
    const float l = (lsum == 0.f) ? 1.f : lsum;
    out[bh * hd + d] = from_f<T>(a / l);
  }
}

template <typename T, typename PT, bool QUANT, int NREP, int HD>
int launch_one(const void* q, const void* k, const void* v, const void* ks,
               const void* vs, const void* table, const void* lengths,
               void* out, float* part_ml, float* part_acc, int b,
               int n_table, int ps, int kvh, int splits,
               int chunks_per_split, float scale, cudaStream_t stream) {
  auto kern = paged_partial_kernel<T, PT, QUANT, NREP, HD>;
  const int smem = (int)sizeof(float) *
                   (NREP * HD + NWARPS * NREP * (CHUNK + 2 + HD));
  static bool configured = false;   // once, as for flash_fwd
  if (smem > 48 * 1024 && !configured) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  dim3 grid(kvh, b, splits);
  kern<<<grid, NT, smem, stream>>>(
      (const T*)q, (const PT*)k, (const PT*)v, (const __nv_bfloat16*)ks,
      (const __nv_bfloat16*)vs, (const int*)table, (const int*)lengths,
      part_ml, part_acc, n_table, ps, kvh, splits, chunks_per_split, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  paged_combine_kernel<T><<<b * kvh * NREP, 128, 0, stream>>>(
      part_ml, part_acc, (const int*)lengths, (T*)out, kvh * NREP, splits,
      chunks_per_split, HD);
  return (int)cudaGetLastError();
}

template <typename T, typename PT, bool QUANT, int NREP>
int by_epl(int epl, const void* q, const void* k, const void* v,
           const void* ks, const void* vs, const void* table,
           const void* lengths, void* out, float* ml, float* acc, int b,
           int n_table, int ps, int kvh, int splits, int cps, float scale,
           cudaStream_t st) {
  switch (epl) {
    case 2: return launch_one<T, PT, QUANT, NREP, 64>(
        q, k, v, ks, vs, table, lengths, out, ml, acc, b, n_table, ps, kvh,
        splits, cps, scale, st);
    case 4: return launch_one<T, PT, QUANT, NREP, 128>(
        q, k, v, ks, vs, table, lengths, out, ml, acc, b, n_table, ps, kvh,
        splits, cps, scale, st);
    case 8: return launch_one<T, PT, QUANT, NREP, 256>(
        q, k, v, ks, vs, table, lengths, out, ml, acc, b, n_table, ps, kvh,
        splits, cps, scale, st);
  }
  return (int)cudaErrorInvalidValue;
}

template <typename T, typename PT, bool QUANT>
int by_rep(int n_rep, int epl, const void* q, const void* k, const void* v,
           const void* ks, const void* vs, const void* table,
           const void* lengths, void* out, float* ml, float* acc, int b,
           int n_table, int ps, int kvh, int splits, int cps, float scale,
           cudaStream_t st) {
  switch (n_rep) {
    case 1: return by_epl<T, PT, QUANT, 1>(epl, q, k, v, ks, vs, table,
        lengths, out, ml, acc, b, n_table, ps, kvh, splits, cps, scale, st);
    case 2: return by_epl<T, PT, QUANT, 2>(epl, q, k, v, ks, vs, table,
        lengths, out, ml, acc, b, n_table, ps, kvh, splits, cps, scale, st);
    case 4: return by_epl<T, PT, QUANT, 4>(epl, q, k, v, ks, vs, table,
        lengths, out, ml, acc, b, n_table, ps, kvh, splits, cps, scale, st);
    case 8: return by_epl<T, PT, QUANT, 8>(epl, q, k, v, ks, vs, table,
        lengths, out, ml, acc, b, n_table, ps, kvh, splits, cps, scale, st);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32 q/out, 1 = bfloat16 q/out. quant: 0 = pages of the
// q dtype, 1 = int8 pages with bf16 per-cell scales (ks, vs).
// part_ml [B, H, splits, 2] and part_acc [B, H, splits, hd] are f32
// scratch the caller allocates; each split covers chunks_per_split
// chunks of 32 cells. n_rep in {1, 2, 4, 8}; hd in {64, 128, 256}.
extern "C" int paged_attention_launch(
    int dtype, int quant, const void* q, const void* k, const void* v,
    const void* ks, const void* vs, const void* table, const void* lengths,
    void* out, void* part_ml, void* part_acc, int b, int n_table, int ps,
    int kvh, int n_rep, int hd, int splits, int chunks_per_split,
    float scale, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (hd % 32 != 0 || ps < 1 || splits < 1)
    return (int)cudaErrorInvalidValue;
  const int epl = hd / 32;
  float* ml = (float*)part_ml;
  float* acc = (float*)part_acc;
  if (dtype == 0 && quant == 0)
    return by_rep<float, float, false>(n_rep, epl, q, k, v, ks, vs, table,
        lengths, out, ml, acc, b, n_table, ps, kvh, splits,
        chunks_per_split, scale, st);
  if (dtype == 0 && quant == 1)
    return by_rep<float, int8_t, true>(n_rep, epl, q, k, v, ks, vs, table,
        lengths, out, ml, acc, b, n_table, ps, kvh, splits,
        chunks_per_split, scale, st);
  if (dtype == 1 && quant == 0)
    return by_rep<__nv_bfloat16, __nv_bfloat16, false>(n_rep, epl, q, k, v,
        ks, vs, table, lengths, out, ml, acc, b, n_table, ps, kvh, splits,
        chunks_per_split, scale, st);
  if (dtype == 1 && quant == 1)
    return by_rep<__nv_bfloat16, int8_t, true>(n_rep, epl, q, k, v, ks, vs,
        table, lengths, out, ml, acc, b, n_table, ps, kvh, splits,
        chunks_per_split, scale, st);
  return (int)cudaErrorInvalidValue;
}
