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
// Two kernels, chosen by shape in ops/paged_attention.py
// `kernel_variant`.
//
// `paged_tma_kernel` (bf16 queries, pages of 16 cells, head_dim 64 or
// 128: every serving decode step), one launch. What held the split
// kernel below back: its grid followed the table's capacity (B x KV x
// 16 splits of 128 cells), so most blocks exited at once and each live
// warp had one 32-cell chunk; scores read lane per cell (a 256-byte K
// row a lane, lanes 2 KB apart); P V walked 32 cells one after another;
// a second launch merged the splits. The design:
//  - the work is the sequence of live (row, KV head, page) units,
//    counted from `lengths` on the card; a fixed grid (two blocks an
//    SM, or the table's capacity where smaller, so a later CUDA graph
//    can hold it) gives each block an even share (`share_start`), so
//    every block streams the same bytes and none is born only to exit;
//  - a loading warp looks its pages up in the table 32 at a time (a
//    lane each) and keeps 8 pages (int8: 4) in flight: K and V of one
//    KV head as TMA boxes [16 cells, 64 values] of the pool viewed as
//    [pages x 16, KV x head_dim] under the 128-byte swizzle (int8: one
//    box [16, head_dim], unswizzled), the page's int8 scales and, with a
//    row's first page, its queries by bulk copy, all on the stage's
//    mbarrier;
//  - four consumer warps take the share's pages in turn, each running
//    S^T = Q K^T (the GQA group's heads as the m16 rows, K by ldmatrix)
//    and O += P V (P straight from S^T's registers, V by
//    ldmatrix.trans) on mma.sync m16n8k16 with its own base-2 online
//    softmax; at a row's end their states meet in shared memory and
//    warp 0 merges them in warp order;
//    int8 pages are widened to exact bf16 integers in shared memory and
//    their scales applied to the scores and to P; cells past the length
//    score -inf and their V rows are zeroed (the last page is loaded
//    whole), so whatever they hold, NaN included, never reaches the
//    output;
//  - a row that a share holds whole is stored as bf16; a row cut by a
//    share's edge writes (acc, m, l) to its share's slot and lane 0 adds
//    one to the row's counter (a gpu-scope acq_rel fence around it); the
//    block that finds itself last at the end of its share merges the
//    pieces by log-sum-exp in block order, 8 a round trip with every
//    lane on its own values, and resets the counter: the same bits on
//    every run, no second launch. Rows of length 0 are written as zeros;
//  - a head shard of a tensor-parallel serving slice (KV heads
//    [g0, g0 + kvh) of `kv_all`, its own pool and queries) launches with
//    the whole slice's unit sequence and grid and takes only its heads'
//    units: every (row, head) run then falls to the blocks and warps,
//    and is merged in the order, that the unsharded launch gives it, so
//    the shard's output is its head slice of that launch, bit for bit.
//    The ring counts only the units a block takes; the warp of a page
//    follows its place in the whole share. kv_all = kvh, g0 = 0 is the
//    unsharded launch.
// Tried on the card and dropped (variants side by side in one call
// each; PERF.md has the rankings): 64-bit share arithmetic and a
// `__threadfence()` in every lane (the merges cost more than the
// stream), waiting on the counter's atomic mid-stream, a merge of two
// pieces a round trip on half the lanes, 8-stage rings at two blocks an
// SM with one consumer warp a block (int8 pages: slower; bf16: no
// faster), one consumer warp a block at four blocks an SM (its serial
// chain of products and softmax a page bound the kernel even with the
// pages in L2), grids of 8 or 16 blocks an SM (more pieces to merge),
// and int8 pages dequantized with I2F and a product a value (the one
// warp's conversion unit bound the kernel).
//
// `paged_partial_kernel` + `paged_combine_kernel` (f32 queries, other
// pages, head dims and GQA groups: every shape JAX's gate takes, head_dim
// a multiple of 8 in [32, 512] and any whole group): the TPU kernel walks
// the page axis in order on one core; here the cells of a row are split
// so that every SM streams:
//  * over blocks: grid (KV head x group slice, batch row, split); a
//    block holds NREP query heads of its KV head's group (1, 2, 4 or 8:
//    the group rounded up, the extra rows masked; a group above 8 walks
//    in slices of 8) and a head_dim padded to HD (64, 128, 256 or 512;
//    loads and stores past the head_dim masked); each block takes 128
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

#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

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

// one lane's EPL consecutive elements of a row of `hd` (a multiple of
// 8), in vector loads of up to 8 elements; those past hd read as 0
template <typename PT, int EPL>
__device__ inline void load_vec_masked(const PT* p, int col, int hd,
                                       float* out) {
  constexpr int SUB = EPL < 8 ? EPL : 8;
#pragma unroll
  for (int s = 0; s < EPL; s += SUB) {
    if (col + s < hd) {
      load_vec<PT, SUB>(p + s, out + s);
    } else {
#pragma unroll
      for (int j = 0; j < SUB; ++j) out[s + j] = 0.f;
    }
  }
}

// T: query/output type; PT: page element type (T, or int8 with scales);
// NREP query heads a block (n_rep of a group, in n_slices slices); HD
// the padded head_dim, hd the real one (a multiple of 8)
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
                     int n_table, int ps, int kvh, int n_rep, int n_slices,
                     int hd, int splits, int chunks_per_split, float scale) {
  constexpr int EPL = HD / 32;                  // P V: lane's columns
  // K row loads: 8 elements (8 bytes of int8, 16 of bf16), 4 of f32:
  // a row of a multiple of 8 elements keeps each load aligned
  constexpr int PERV = sizeof(PT) == 4 ? 4 : 8;
  extern __shared__ __align__(16) float smem[];
  float* sQ = smem;                             // [NREP, HD]
  float* sP = sQ + NREP * HD;                   // [NWARPS, NREP, 32]
  float* sM = sP + NWARPS * NREP * CHUNK;       // [NWARPS, NREP]
  float* sL = sM + NWARPS * NREP;               // [NWARPS, NREP]
  float* sAcc = sL + NWARPS * NREP;             // [NWARPS, NREP, HD]

  const int g = blockIdx.x / n_slices;          // KV head
  const int r0 = (blockIdx.x % n_slices) * NREP;  // first head of the slice
  const int nr = min(NREP, n_rep - r0);           // its live heads
  const int b = blockIdx.y;
  const int split = blockIdx.z;
  const int h = kvh * n_rep;
  const int64_t head0 = (int64_t)b * h + g * n_rep + r0;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int length = max(lengths[b], 0);
  const int n_chunks = (length + CHUNK - 1) / CHUNK;
  const int c_begin = split * chunks_per_split;
  const int c_end = min(n_chunks, c_begin + chunks_per_split);
  if (c_begin >= c_end) return;  // the combine reads only used splits

  for (int idx = threadIdx.x; idx < NREP * HD; idx += NT) {
    const int r = idx / HD, c = idx % HD;
    sQ[idx] = (r < nr && c < hd) ? to_f(q[(head0 + r) * hd + c]) : 0.f;
  }
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
      const PT* krow = kp + cidx * hd;
#pragma unroll
      for (int i = 0; i < HD; i += PERV) {
        if (i >= hd) break;
        float kf[PERV];
        load_vec<PT, PERV>(krow + i, kf);
#pragma unroll
        for (int r = 0; r < NREP; ++r) {
#pragma unroll
          for (int j = 0; j < PERV; j += 4) {
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
        load_vec_masked<PT, EPL>(vp + ci * hd + lane * EPL, lane * EPL, hd,
                                 vf);
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
    if (r >= nr || d >= hd) continue;   // padded heads and columns
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
    const int64_t row = (head0 + r) * splits + split;
    part_acc[row * hd + d] = a;
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
               int n_table, int ps, int kvh, int n_rep, int hd, int splits,
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
  const int n_slices = (n_rep + NREP - 1) / NREP;
  dim3 grid(kvh * n_slices, b, splits);
  kern<<<grid, NT, smem, stream>>>(
      (const T*)q, (const PT*)k, (const PT*)v, (const __nv_bfloat16*)ks,
      (const __nv_bfloat16*)vs, (const int*)table, (const int*)lengths,
      part_ml, part_acc, n_table, ps, kvh, n_rep, n_slices, hd, splits,
      chunks_per_split, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  paged_combine_kernel<T><<<b * kvh * n_rep, 128, 0, stream>>>(
      part_ml, part_acc, (const int*)lengths, (T*)out, kvh * n_rep, splits,
      chunks_per_split, hd);
  return (int)cudaGetLastError();
}

// the padded head_dim HD: 64, 128, 256 or 512, the least that holds hd
template <typename T, typename PT, bool QUANT, int NREP>
int by_hd(int hd, const void* q, const void* k, const void* v,
          const void* ks, const void* vs, const void* table,
          const void* lengths, void* out, float* ml, float* acc, int b,
          int n_table, int ps, int kvh, int n_rep, int splits, int cps,
          float scale, cudaStream_t st) {
  if (hd <= 64) return launch_one<T, PT, QUANT, NREP, 64>(
      q, k, v, ks, vs, table, lengths, out, ml, acc, b, n_table, ps, kvh,
      n_rep, hd, splits, cps, scale, st);
  if (hd <= 128) return launch_one<T, PT, QUANT, NREP, 128>(
      q, k, v, ks, vs, table, lengths, out, ml, acc, b, n_table, ps, kvh,
      n_rep, hd, splits, cps, scale, st);
  if (hd <= 256) return launch_one<T, PT, QUANT, NREP, 256>(
      q, k, v, ks, vs, table, lengths, out, ml, acc, b, n_table, ps, kvh,
      n_rep, hd, splits, cps, scale, st);
  return launch_one<T, PT, QUANT, NREP, 512>(
      q, k, v, ks, vs, table, lengths, out, ml, acc, b, n_table, ps, kvh,
      n_rep, hd, splits, cps, scale, st);
}

// NREP: the group rounded up to 1, 2, 4 or 8 (a larger group walks in
// slices of 8)
template <typename T, typename PT, bool QUANT>
int by_rep(int n_rep, int hd, const void* q, const void* k, const void* v,
           const void* ks, const void* vs, const void* table,
           const void* lengths, void* out, float* ml, float* acc, int b,
           int n_table, int ps, int kvh, int splits, int cps, float scale,
           cudaStream_t st) {
  if (n_rep == 1) return by_hd<T, PT, QUANT, 1>(hd, q, k, v, ks, vs, table,
      lengths, out, ml, acc, b, n_table, ps, kvh, n_rep, splits, cps, scale,
      st);
  if (n_rep == 2) return by_hd<T, PT, QUANT, 2>(hd, q, k, v, ks, vs, table,
      lengths, out, ml, acc, b, n_table, ps, kvh, n_rep, splits, cps, scale,
      st);
  if (n_rep <= 4) return by_hd<T, PT, QUANT, 4>(hd, q, k, v, ks, vs, table,
      lengths, out, ml, acc, b, n_table, ps, kvh, n_rep, splits, cps, scale,
      st);
  return by_hd<T, PT, QUANT, 8>(hd, q, k, v, ks, vs, table, lengths, out,
      ml, acc, b, n_table, ps, kvh, n_rep, splits, cps, scale, st);
}

// ---- the TMA-ring kernel: even shares of the live pages ---------------

constexpr int TP_PS = 16;       // cells a page (a 16-row box, one k16 step)
constexpr int TP_CW = 4;        // consumer warps, a page each in turn
constexpr int TP_NT = 32 * (TP_CW + 1);   // and the loading warp
constexpr int TP_MAX_B = 1024;  // rows whose page counts the block scans
constexpr int TP_MAX_KV = 32;   // KV heads of an int8 page's scale block

// stage layout: bf16 pools hold the K and V tiles as HD / 64 boxes of
// [16 cells, 64 values] under the 128-byte swizzle (2 KB each, at
// 1024-byte offsets); int8 pools hold the int8 tiles [16, HD], the
// page's K and V scales [16 cells, KV] and widen into two bf16 tiles of
// the consumer warp. Q (the row's NREP heads) rides with the first page
// of a row in the block's share. The consumer warps' online-softmax
// states meet in MRG at each row's end.
template <int NREP, int HD, bool QUANT>
struct TpShape {
  static constexpr int NS = QUANT ? 4 : 8;                // ring stages
  static constexpr int TILE = TP_PS * HD * 2;            // a bf16 tile
  static constexpr int QB = NREP * HD * 2 < 1024 ? 1024 : NREP * HD * 2;
  static constexpr int K_OFF = 0;
  static constexpr int V_OFF = QUANT ? TILE / 2 : TILE;
  static constexpr int KS_OFF = TILE;                    // int8 only
  static constexpr int VS_OFF = TILE + 1024;             // int8 only
  static constexpr int Q_OFF = QUANT ? TILE + 2048 : 2 * TILE;
  static constexpr int STAGE = Q_OFF + QB;
  static constexpr int DQ_OFF = NS * STAGE;         // int8: K, V bf16 a warp
  static constexpr int MRG_VALS = HD / 4 + 2;       // a lane's acc, m, l
  static constexpr int MRG_OFF = DQ_OFF + (QUANT ? 2 * TILE * TP_CW : 0);
  static constexpr int BAR_OFF = MRG_OFF + TP_CW * MRG_VALS * 32 * 4;
  static constexpr int CUM_OFF = BAR_OFF + 2 * NS * 8 + 16;
  static constexpr int SMEM = CUM_OFF + (2 * TP_MAX_B + 1) * 4 + 1024;
  static constexpr int SLOT = NREP * HD + 16;       // f32 a partial
};

// the row (b), KV head (g) and page (p) of work unit u: rows in order,
// each row's KV heads in order, each head's pages in order; cum[b] is
// the first unit of row b (KV * its live pages before it)
__device__ inline void tp_locate(int u, const int* cum, int n_b, int kvh,
                                 int* b, int* g, int* p, int* pages) {
  int lo = 0, hi = n_b - 1;
  while (lo < hi) {                           // the last b with cum <= u
    const int mid = (lo + hi + 1) / 2;
    if (cum[mid] <= u) lo = mid; else hi = mid - 1;
  }
  *b = lo;
  *pages = (cum[lo + 1] - cum[lo]) / kvh;
  const int off = u - cum[lo];
  *g = off / *pages;
  *p = off % *pages;
}

// byte offset of 16-byte group `ck` of cell `c` in a bf16 tile of
// [16, 64] boxes under the 128-byte swizzle
__device__ inline int tp_sw(int c, int ck) {
  return (ck >> 3) * (TP_PS * 128) + c * 128 + (((ck & 7) ^ (c & 7)) << 4);
}

// one int8 tile [16, HD] as a bf16 tile of the same (exact) integers, in
// the swizzled layout the bf16 pools' boxes have; the per-cell scales
// are applied to the scores (K) and to P (V) instead
template <int HD>
__device__ inline void tp_widen(const int8_t* q, unsigned char* out,
                                int lane) {
  for (int idx = lane; idx < TP_PS * HD / 8; idx += 32) {
    const int c = idx / (HD / 8);
    const int ck = idx % (HD / 8);
    const uint2 raw = *reinterpret_cast<const uint2*>(q + c * HD + ck * 8);
    const uint32_t lo = raw.x ^ 0x80808080u, hi = raw.y ^ 0x80808080u;
    *reinterpret_cast<uint4*>(out + tp_sw(c, ck)) = make_uint4(
        pack_bf16(q8_to_f32(lo, 0), q8_to_f32(lo, 1)),
        pack_bf16(q8_to_f32(lo, 2), q8_to_f32(lo, 3)),
        pack_bf16(q8_to_f32(hi, 0), q8_to_f32(hi, 1)),
        pack_bf16(q8_to_f32(hi, 2), q8_to_f32(hi, 3)));
  }
}

// One launch for a decode step's bf16 queries (the design is in the
// header). Warp TP_CW loads; warps 0..TP_CW-1 take the share's pages in
// turn, all pass every stage (the row's queries ride on its first), and
// at a row's end warp 0 merges their states and stores or hands on the
// row; slot 2b of the partials holds share b's first row when the share
// cuts it, slot 2b + 1 its last.
template <int NREP, int HD, bool QUANT>
__global__ void __launch_bounds__(TP_NT, 2)
paged_tma_kernel(const __grid_constant__ CUtensorMap tm_k,
                 const __grid_constant__ CUtensorMap tm_v,
                 const __nv_bfloat16* __restrict__ q,
                 const __nv_bfloat16* __restrict__ ks,
                 const __nv_bfloat16* __restrict__ vs,
                 const int* __restrict__ table,
                 const int* __restrict__ lengths,
                 __nv_bfloat16* __restrict__ out, float* __restrict__ part,
                 int* __restrict__ counters, int n_b, int n_table, int kvh,
                 int kv_all, int g0, float scale_log2) {
  using S = TpShape<NREP, HD, QUANT>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~(uintptr_t)1023);
  constexpr int NS = S::NS;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + S::BAR_OFF);
  uint64_t* empty = full + NS;
  int* cum = reinterpret_cast<int*>(smem + S::CUM_OFF);   // [n_b + 1]
  int* lenc = cum + TP_MAX_B + 1;                         // [n_b]
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int h = kvh * NREP;

  if (threadIdx.x == 0) {
    for (int st = 0; st < NS; ++st) {
      mbar_init(full + st, 1);
      mbar_init(empty + st, TP_CW);           // every consumer warp
    }
    mbar_fence_init();
  }
  if (warp == 0) {
    // live pages per row (capped by the table), scanned into cum
    int carry = 0;
    if (lane == 0) cum[0] = 0;
    for (int base = 0; base < n_b; base += 32) {
      const int i = base + lane;
      int len = 0;
      if (i < n_b) len = min(max(lengths[i], 0), n_table * TP_PS);
      int v = (len + TP_PS - 1) / TP_PS * kv_all;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int up = __shfl_up_sync(0xffffffffu, v, off);
        if (lane >= off) v += up;
      }
      if (i < n_b) {
        cum[i + 1] = carry + v;
        lenc[i] = len;
      }
      carry += __shfl_sync(0xffffffffu, v, 31);
    }
  }
  __syncthreads();

  const int grid = gridDim.x;
  const int total = cum[n_b];
  const int u0 = share_start(blockIdx.x, total, grid);
  const int u1 = share_start(blockIdx.x + 1, total, grid);

  if (warp == TP_CW) {
    int n = 0;                                // units taken so far
    for (int base = u0; base < u1; base += 32) {
      const int u = base + lane;
      int b = 0, g = 0, p = 0, pages = 1, pid = 0;
      if (u < u1) {
        tp_locate(u, cum, n_b, kv_all, &b, &g, &p, &pages);
        g -= g0;                              // the shard's own head
        if (g >= 0 && g < kvh) pid = table[(int64_t)b * n_table + p];
      }
      const bool first = u == u0 || p == 0;
      const int cnt = min(32, u1 - base);
      for (int j = 0; j < cnt; ++j) {
        const int bj = __shfl_sync(0xffffffffu, b, j);
        const int gj = __shfl_sync(0xffffffffu, g, j);
        const int pj = __shfl_sync(0xffffffffu, pid, j);
        const bool fj = __shfl_sync(0xffffffffu, (int)first, j);
        if (gj < 0 || gj >= kvh) continue;    // another shard's unit
        if (lane == 0) {
          const int st = n % NS;
          if (n >= NS) mbar_wait(empty + st, (n / NS - 1) & 1);
          unsigned char* sb = smem + st * S::STAGE;
          const uint32_t sc_bytes = TP_PS * kvh * 2;
          mbar_expect_tx(full + st,
                         (QUANT ? TP_PS * HD * 2 + 2 * sc_bytes
                                : 2 * S::TILE) +
                             (fj ? NREP * HD * 2 : 0));
          if (QUANT) {
            tma_load_2d(sb + S::K_OFF, &tm_k, full + st, gj * HD,
                        pj * TP_PS);
            tma_load_2d(sb + S::V_OFF, &tm_v, full + st, gj * HD,
                        pj * TP_PS);
            bulk_load(sb + S::KS_OFF, ks + (int64_t)pj * TP_PS * kvh,
                      sc_bytes, full + st);
            bulk_load(sb + S::VS_OFF, vs + (int64_t)pj * TP_PS * kvh,
                      sc_bytes, full + st);
          } else {
#pragma unroll
            for (int hf = 0; hf < HD / 64; ++hf) {
              tma_load_2d(sb + S::K_OFF + hf * TP_PS * 128, &tm_k,
                          full + st, gj * HD + 64 * hf, pj * TP_PS);
              tma_load_2d(sb + S::V_OFF + hf * TP_PS * 128, &tm_v,
                          full + st, gj * HD + 64 * hf, pj * TP_PS);
            }
          }
          if (fj)
            bulk_load(sb + S::Q_OFF,
                      q + ((int64_t)bj * h + gj * NREP) * HD,
                      NREP * HD * 2, full + st);
        }
        ++n;
        __syncwarp();
      }
    }
    return;
  }

  // ---- consumer warps: the products and the softmax; warp 0 also the
  // merges and the epilogues ----
  const int g8 = lane / 4;                    // query head of the group
  const int t = lane % 4;
  // rows of length 0: zeros, written by one block each
  for (int b = blockIdx.x; b < n_b && warp == 0; b += grid) {
    if (lenc[b] != 0) continue;
    for (int i = lane; i < h * HD / 8; i += 32)
      reinterpret_cast<uint4*>(out + (int64_t)b * h * HD)[i] =
          make_uint4(0u, 0u, 0u, 0u);
  }
  if (u0 >= u1) return;
  float* mrg = reinterpret_cast<float*>(smem + S::MRG_OFF);

  int b = 0, g = 0, p = 0, pages = 1;
  tp_locate(u0, cum, n_b, kv_all, &b, &g, &p, &pages);
  g -= g0;
  // the rows this share cuts (at most its first and its last): each
  // writes its piece as it ends and lane 0 adds one to its counter;
  // whether this block was the last to do so is read at the share's end,
  // so the warp never waits on the atomic's round trip mid-stream
  int cut0 = -1, cur0 = 0, cpg0 = 0, old0 = 0;
  int cut1 = -1, cur1 = 0, cpg1 = 0, old1 = 0;
  uint32_t qa[HD / 16][2];
  float acc[HD / 8][4];
  float m = -INFINITY, l = 0.f;
  int nr = 0;                                 // ring stages taken
  for (int u = u0; u < u1; ++u) {
    if (g < 0 || g >= kvh) {                  // another shard's unit
      if (p + 1 < pages) {
        ++p;
      } else if (u + 1 < u1) {
        tp_locate(u + 1, cum, n_b, kv_all, &b, &g, &p, &pages);
        g -= g0;
      }
      continue;
    }
    const int n = u - u0;                     // the page's warp
    const int st = nr % NS;
    unsigned char* sb = smem + st * S::STAGE;
    mbar_wait(full + st, (nr / NS) & 1);
    ++nr;
    if (u == u0 || p == 0) {
      const uint32_t* qs = reinterpret_cast<const uint32_t*>(sb + S::Q_OFF);
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        qa[kk][0] = g8 < NREP ? qs[g8 * HD / 2 + 8 * kk + t] : 0u;
        qa[kk][1] = g8 < NREP ? qs[g8 * HD / 2 + 8 * kk + 4 + t] : 0u;
      }
#pragma unroll
      for (int j = 0; j < HD / 8; ++j)
        acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
      m = -INFINITY;
      l = 0.f;
    }
    bool wrote = false;
    if (n % TP_CW == warp) {                  // this warp's page
    const int vc = min(TP_PS, lenc[b] - p * TP_PS);   // live cells, >= 1
    unsigned char* kt = sb + S::K_OFF;
    unsigned char* vt = sb + S::V_OFF;
    if (QUANT) {
      kt = smem + S::DQ_OFF + warp * 2 * S::TILE;
      vt = kt + S::TILE;
      tp_widen<HD>(reinterpret_cast<const int8_t*>(sb + S::K_OFF), kt, lane);
      tp_widen<HD>(reinterpret_cast<const int8_t*>(sb + S::V_OFF), vt, lane);
      __syncwarp();
    } else if (vc < TP_PS) {
      // V rows past the length: zeros (the whole 128-byte row of every
      // box, so the swizzle does not matter)
      for (int i = lane; i < (TP_PS - vc) * (HD / 8); i += 32) {
        const int c = vc + i / (HD / 8);
        const int ck = i % (HD / 8);
        *reinterpret_cast<uint4*>(vt + (ck >> 3) * (TP_PS * 128) + c * 128 +
                                  (ck & 7) * 16) = make_uint4(0u, 0u, 0u, 0u);
      }
      wrote = true;
      __syncwarp();
    }

    // S^T [heads, 16 cells] = Q K^T: two n8 tiles of cells, two chains
    float sc[2][2][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j)
        sc[i][j][0] = sc[i][j][1] = sc[i][j][2] = sc[i][j][3] = 0.f;
    {
      const int mi = lane >> 3;
      const int cell = (mi >> 1) * 8 + (lane & 7);
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        uint32_t r[4];
        ldmatrix_x4(r, kt + tp_sw(cell, 2 * kk + (mi & 1)));
        const uint32_t a[4] = {qa[kk][0], 0u, qa[kk][1], 0u};
        mma_bf16(sc[kk & 1][0], a, r);
        mma_bf16(sc[kk & 1][1], a, r + 2);
      }
    }
    // online softmax in base 2: lane (g8, t) holds head g8's cells
    // 2t, 2t + 1 (tile 0) and 8 + 2t, 9 + 2t (tile 1)
    // (int8 pages: the cell's K scale on the score, its V scale on P)
    const __nv_bfloat16* ksc =
        reinterpret_cast<const __nv_bfloat16*>(sb + S::KS_OFF) + g;
    const __nv_bfloat16* vsc =
        reinterpret_cast<const __nv_bfloat16*>(sb + S::VS_OFF) + g;
    float x[4];
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int cell = 8 * j + 2 * t + e;
        float v = (sc[0][j][e] + sc[1][j][e]) * scale_log2;
        if (QUANT) v *= __bfloat162float(ksc[cell * kvh]);
        x[2 * j + e] = cell < vc ? v : -INFINITY;
      }
    float mx = fmaxf(fmaxf(x[0], x[1]), fmaxf(x[2], x[3]));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m, mx);
    const float alpha = ex2(m - m_new);
    float pr[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) pr[e] = ex2(x[e] - m_new);
    l = l * alpha + ((pr[0] + pr[1]) + (pr[2] + pr[3]));
    m = m_new;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
      acc[j][0] *= alpha;
      acc[j][1] *= alpha;
    }
    // O [heads, HD] += P [heads, 16 cells] V [16 cells, HD]
    {
      float pv[4] = {pr[0], pr[1], pr[2], pr[3]};
      if (QUANT) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int cell = 8 * (e / 2) + 2 * t + e % 2;
          pv[e] = cell < vc ? pv[e] * __bfloat162float(vsc[cell * kvh]) : 0.f;
        }
      }
      const uint32_t a[4] = {pack_bf16(pv[0], pv[1]), 0u,
                             pack_bf16(pv[2], pv[3]), 0u};
      const int mi = lane >> 3;
      const int cell = (mi & 1) * 8 + (lane & 7);
#pragma unroll
      for (int j = 0; j < HD / 8; j += 2) {
        uint32_t r[4];
        ldmatrix_x4_trans(r, vt + tp_sw(cell, j + (mi >> 1)));
        mma_bf16(acc[j], a, r);
        mma_bf16(acc[j + 1], a, r + 2);
      }
    }
    }                                         // this warp's page
    if (wrote) fence_proxy_async();
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + st);

    if (p + 1 < pages && u + 1 < u1) {
      ++p;
      continue;
    }
    // the row ends here, or the share does: the warps' states meet, and
    // warp 0 merges them in warp order (a warp that had no page of the
    // row holds m = -inf, l = 0)
    float lt = l + __shfl_xor_sync(0xffffffffu, l, 1);
    lt += __shfl_xor_sync(0xffffffffu, lt, 2);
    {
      float* mine = mrg + warp * S::MRG_VALS * 32 + lane;
#pragma unroll
      for (int j = 0; j < HD / 8; ++j) {
        mine[(2 * j) * 32] = acc[j][0];
        mine[(2 * j + 1) * 32] = acc[j][1];
      }
      mine[(HD / 4) * 32] = m;
      mine[(HD / 4 + 1) * 32] = lt;
    }
    bar_sync_n(1, TP_CW * 32);
    if (warp == 0) {
      float mm = m;
#pragma unroll
      for (int w = 1; w < TP_CW; ++w)
        mm = fmaxf(mm, mrg[(w * S::MRG_VALS + HD / 4) * 32 + lane]);
      const float r0 = ex2(m - mm);
      lt *= r0;
#pragma unroll
      for (int j = 0; j < HD / 8; ++j) {
        acc[j][0] *= r0;
        acc[j][1] *= r0;
      }
#pragma unroll
      for (int w = 1; w < TP_CW; ++w) {
        const float* o = mrg + w * S::MRG_VALS * 32 + lane;
        const float r = ex2(o[(HD / 4) * 32] - mm);
        lt += r * o[(HD / 4 + 1) * 32];
#pragma unroll
        for (int j = 0; j < HD / 8; ++j) {
          acc[j][0] += r * o[(2 * j) * 32];
          acc[j][1] += r * o[(2 * j + 1) * 32];
        }
      }
      m = mm;
    }
    bar_sync_n(1, TP_CW * 32);                // the states may be rewritten
    if (warp != 0) {
      if (u + 1 < u1) {
        tp_locate(u + 1, cum, n_b, kv_all, &b, &g, &p, &pages);
        g -= g0;
      }
      continue;
    }
    const int row = b * kvh + g;
    const int ur = cum[b] + (g0 + g) * pages;          // the row's units
    const int ue = ur + pages;
    __nv_bfloat16* dst = out + ((int64_t)b * h + g * NREP + g8) * HD;
    if (ur >= u0 && ue <= u1) {
      if (g8 < NREP) {
        const float inv = 1.f / lt;
#pragma unroll
        for (int j = 0; j < HD / 8; ++j)
          *reinterpret_cast<__nv_bfloat162*>(dst + 8 * j + 2 * t) =
              __floats2bfloat162_rn(acc[j][0] * inv, acc[j][1] * inv);
      }
    } else {
      float* pc = part + (int64_t)(2 * blockIdx.x + (ur > u0 ? 1 : 0)) *
                             S::SLOT;
      if (g8 < NREP) {
#pragma unroll
        for (int j = 0; j < HD / 8; ++j)
          __stcg(reinterpret_cast<float2*>(pc + g8 * HD + 8 * j + 2 * t),
                 make_float2(acc[j][0], acc[j][1]));
        if (t == 0) {
          __stcg(pc + NREP * HD + g8, m);
          __stcg(pc + NREP * HD + 8 + g8, lt);
        }
      }
      __syncwarp();
      // (the atomic's result lands in old0 / old1 and is not read until
      // the share's end: no move of it stalls the warp here)
      if (lane == 0) fence_acq_rel_gpu();     // release the partial
      if (cut0 < 0) {
        if (lane == 0) old0 = atomicAdd(counters + row, 1);
        cut0 = row;
        cur0 = ur;
        cpg0 = pages;
      } else {
        if (lane == 0) old1 = atomicAdd(counters + row, 1);
        cut1 = row;
        cur1 = ur;
        cpg1 = pages;
      }
    }
    if (u + 1 < u1) {
      tp_locate(u + 1, cum, n_b, kv_all, &b, &g, &p, &pages);
      g -= g0;
    }
  }
  if (warp != 0 || cut0 < 0) return;

  // the cut rows this block finished last: the pieces merged by
  // log-sum-exp in block order
  int flags = 0;
  if (lane == 0) {
    if (old0 == share_count(cur0, cur0 + cpg0 - 1, total, grid) - 1)
      flags |= 1;
    if (cut1 >= 0 &&
        old1 == share_count(cur1, cur1 + cpg1 - 1, total, grid) - 1)
      flags |= 2;
    if (flags) fence_acq_rel_gpu();           // acquire the others' pieces
  }
  flags = __shfl_sync(0xffffffffu, flags, 0);
  __syncwarp();
  // lane l merges values [l * PER, (l + 1) * PER) of the [NREP, HD]
  // accumulator (head l * PER / HD): 4 pieces a round trip, each
  // rescaled to the running max in block order
  constexpr int PER = NREP * HD / 32;
  const int hq = lane * PER / HD;
  for (int i = 0; i < 2; ++i) {
    if (!(flags >> i & 1)) continue;
    const int row = i == 0 ? cut0 : cut1;
    const int ur = i == 0 ? cur0 : cur1;
    const int ue = ur + (i == 0 ? cpg0 : cpg1);
    const int bf = share_block(ur, total, grid);
    const int bl = share_block(ue - 1, total, grid);
    const bool mid = ur > (int)share_start(bf, total, grid);
    float mm = -INFINITY, ls = 0.f;
    float2 a[PER / 2];
#pragma unroll
    for (int j = 0; j < PER / 2; ++j) a[j] = make_float2(0.f, 0.f);
    for (int b0 = bf; b0 <= bl; b0 += 4) {
      float mi[4], li[4];
      float2 v[4][PER / 2];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int bb = b0 + k;
        const int sl = 2 * bb + (bb == bf && mid ? 1 : 0);
        const float* pi = part + (int64_t)sl * S::SLOT;
        const bool ok = bb <= bl && share_any(bb, total, grid);
        mi[k] = ok ? __ldcg(pi + NREP * HD + hq) : -INFINITY;
        li[k] = ok ? __ldcg(pi + NREP * HD + 8 + hq) : 0.f;
#pragma unroll
        for (int j = 0; j < PER / 2; ++j)
          v[k][j] = ok ? __ldcg(reinterpret_cast<const float2*>(
                             pi + lane * PER) + j)
                       : make_float2(0.f, 0.f);
      }
      float mb = mm;
#pragma unroll
      for (int k = 0; k < 4; ++k) mb = fmaxf(mb, mi[k]);
      const float r = ex2(mm - mb);             // 0 on the first batch
      ls *= r;
#pragma unroll
      for (int j = 0; j < PER / 2; ++j) {
        a[j].x *= r;
        a[j].y *= r;
      }
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if (b0 + k > bl) break;
        if (!share_any(b0 + k, total, grid)) continue;
        const float w = ex2(mi[k] - mb);
        ls += w * li[k];
#pragma unroll
        for (int j = 0; j < PER / 2; ++j) {
          a[j].x += w * v[k][j].x;
          a[j].y += w * v[k][j].y;
        }
      }
      mm = mb;
    }
    const int rb = row / kvh;
    const int rg = row % kvh;
    __nv_bfloat16* dst = out + ((int64_t)rb * h + rg * NREP) * HD + lane * PER;
    const float inv = 1.f / ls;
#pragma unroll
    for (int j = 0; j < PER / 2; ++j)
      reinterpret_cast<__nv_bfloat162*>(dst)[j] =
          __floats2bfloat162_rn(a[j].x * inv, a[j].y * inv);
    if (lane == 0) counters[row] = 0;   // for the next launch
  }
}

template <int NREP, int HD, bool QUANT>
int launch_tma(const void* q, const void* k, const void* v, const void* ks,
               const void* vs, const void* table, const void* lengths,
               void* out, void* part, void* counters, int b, int n_table,
               int n_pages, int kvh, int kv_all, int g0, float scale,
               int grid, cudaStream_t stream) {
  using S = TpShape<NREP, HD, QUANT>;
  CUtensorMap tm_k, tm_v;
  const CUtensorMapDataType type = QUANT ? CU_TENSOR_MAP_DATA_TYPE_UINT8
                                         : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  const int elem = QUANT ? 1 : 2;
  const int box_cols = QUANT ? HD : 64;
  const CUtensorMapSwizzle sw =
      QUANT ? CU_TENSOR_MAP_SWIZZLE_NONE : CU_TENSOR_MAP_SWIZZLE_128B;
  if (!make_map_2d(&tm_k, k, type, elem, n_pages * TP_PS, kvh * HD, TP_PS,
                   box_cols, sw) ||
      !make_map_2d(&tm_v, v, type, elem, n_pages * TP_PS, kvh * HD, TP_PS,
                   box_cols, sw))
    return (int)cudaErrorInvalidValue;
  auto kern = paged_tma_kernel<NREP, HD, QUANT>;
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, S::SMEM);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  kern<<<grid, TP_NT, S::SMEM, stream>>>(
      tm_k, tm_v, (const __nv_bfloat16*)q, (const __nv_bfloat16*)ks,
      (const __nv_bfloat16*)vs, (const int*)table, (const int*)lengths,
      (__nv_bfloat16*)out, (float*)part, (int*)counters, b, n_table, kvh,
      kv_all, g0, scale * 1.4426950408889634f);
  return (int)cudaGetLastError();
}

template <int NREP, bool QUANT>
int tma_by_hd(int hd, const void* q, const void* k, const void* v,
              const void* ks, const void* vs, const void* table,
              const void* lengths, void* out, void* part, void* counters,
              int b, int n_table, int n_pages, int kvh, int kv_all, int g0,
              float scale, int grid, cudaStream_t st) {
  if (hd == 64)
    return launch_tma<NREP, 64, QUANT>(q, k, v, ks, vs, table, lengths, out,
        part, counters, b, n_table, n_pages, kvh, kv_all, g0, scale, grid,
        st);
  if (hd == 128)
    return launch_tma<NREP, 128, QUANT>(q, k, v, ks, vs, table, lengths,
        out, part, counters, b, n_table, n_pages, kvh, kv_all, g0, scale, grid,
        st);
  return (int)cudaErrorInvalidValue;
}

template <bool QUANT>
int tma_by_rep(int n_rep, int hd, const void* q, const void* k,
               const void* v, const void* ks, const void* vs,
               const void* table, const void* lengths, void* out, void* part,
               void* counters, int b, int n_table, int n_pages, int kvh,
               int kv_all, int g0, float scale, int grid, cudaStream_t st) {
  switch (n_rep) {
    case 1: return tma_by_hd<1, QUANT>(hd, q, k, v, ks, vs, table, lengths,
        out, part, counters, b, n_table, n_pages, kvh, kv_all, g0, scale, grid,
        st);
    case 2: return tma_by_hd<2, QUANT>(hd, q, k, v, ks, vs, table, lengths,
        out, part, counters, b, n_table, n_pages, kvh, kv_all, g0, scale, grid,
        st);
    case 4: return tma_by_hd<4, QUANT>(hd, q, k, v, ks, vs, table, lengths,
        out, part, counters, b, n_table, n_pages, kvh, kv_all, g0, scale, grid,
        st);
    case 8: return tma_by_hd<8, QUANT>(hd, q, k, v, ks, vs, table, lengths,
        out, part, counters, b, n_table, n_pages, kvh, kv_all, g0, scale, grid,
        st);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// The TMA-ring kernel: bf16 q/out [B, H, hd]; quant 0: bf16 pages
// [n_pages, 16, KV, hd], 1: int8 pages with bf16 per-cell scales ks, vs
// [n_pages, 16, KV] (KV <= 32); table [B, n_table], lengths [B] int32
// (B <= 1024); n_rep in {1, 2, 4, 8}, hd in {64, 128}; `grid` blocks;
// part [2 * grid, n_rep * hd + 16] f32 scratch for the rows a share's
// edge cuts; counters [B * KV] int32, zero before the launch and zero
// again after it. A head shard passes its own q / out / pages (KV =
// kvh heads) with the slice's KV heads `kv_all` and its first head
// `g0`, and the unsharded launch's grid; kv_all = kvh, g0 = 0 else.
// Launches on one device must not overlap (one stream):
// they share the counters. One launch, no second kernel.
extern "C" int paged_attention_tma_launch(
    int quant, const void* q, const void* k, const void* v, const void* ks,
    const void* vs, const void* table, const void* lengths, void* out,
    void* part, void* counters, int b, int n_table, int n_pages, int kvh,
    int kv_all, int g0, int n_rep, int hd, float scale, int grid,
    void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (b < 1 || b > TP_MAX_B || n_table < 1 || n_pages < 1 || kvh < 1 ||
      grid < 1 || part == nullptr || counters == nullptr ||
      kv_all < kvh || g0 < 0 || g0 + kvh > kv_all ||
      (uint64_t)b * kv_all * n_table * (grid + 1) >= (1ull << 32) ||
      (quant && (kvh > TP_MAX_KV || ks == nullptr || vs == nullptr)))
    return (int)cudaErrorInvalidValue;
  if (quant)
    return tma_by_rep<true>(n_rep, hd, q, k, v, ks, vs, table, lengths, out,
        part, counters, b, n_table, n_pages, kvh, kv_all, g0, scale, grid,
        st);
  return tma_by_rep<false>(n_rep, hd, q, k, v, ks, vs, table, lengths, out,
      part, counters, b, n_table, n_pages, kvh, kv_all, g0, scale, grid,
      st);
}

// dtype: 0 = float32 q/out, 1 = bfloat16 q/out. quant: 0 = pages of the
// q dtype, 1 = int8 pages with bf16 per-cell scales (ks, vs).
// part_ml [B, H, splits, 2] and part_acc [B, H, splits, hd] are f32
// scratch the caller allocates; each split covers chunks_per_split
// chunks of 32 cells. Any n_rep >= 1; hd a multiple of 8 in [32, 512].
extern "C" int paged_attention_launch(
    int dtype, int quant, const void* q, const void* k, const void* v,
    const void* ks, const void* vs, const void* table, const void* lengths,
    void* out, void* part_ml, void* part_acc, int b, int n_table, int ps,
    int kvh, int n_rep, int hd, int splits, int chunks_per_split,
    float scale, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (hd % 8 != 0 || hd < 32 || hd > 512 || n_rep < 1 || ps < 1 ||
      splits < 1)
    return (int)cudaErrorInvalidValue;
  float* ml = (float*)part_ml;
  float* acc = (float*)part_acc;
  if (dtype == 0 && quant == 0)
    return by_rep<float, float, false>(n_rep, hd, q, k, v, ks, vs, table,
        lengths, out, ml, acc, b, n_table, ps, kvh, splits,
        chunks_per_split, scale, st);
  if (dtype == 0 && quant == 1)
    return by_rep<float, int8_t, true>(n_rep, hd, q, k, v, ks, vs, table,
        lengths, out, ml, acc, b, n_table, ps, kvh, splits,
        chunks_per_split, scale, st);
  if (dtype == 1 && quant == 0)
    return by_rep<__nv_bfloat16, __nv_bfloat16, false>(n_rep, hd, q, k, v,
        ks, vs, table, lengths, out, ml, acc, b, n_table, ps, kvh, splits,
        chunks_per_split, scale, st);
  if (dtype == 1 && quant == 1)
    return by_rep<__nv_bfloat16, int8_t, true>(n_rep, hd, q, k, v, ks, vs,
        table, lengths, out, ml, acc, b, n_table, ps, kvh, splits,
        chunks_per_split, scale, st);
  return (int)cudaErrorInvalidValue;
}
