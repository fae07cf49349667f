// Flash-attention backward for Hopper (sm_90a): dQ and dK/dV, bf16 in and
// out, f32 accumulation.
//
// Replaces: dlrover_tpu/ops/flash_attention.py `_bwd_dq_kernel` and
// `_bwd_dkv_kernel`, launched by `_bwd` (two Pallas TPU kernels over
// [B, H, S, D]: the dq grid walks the key blocks of one q block, the dkv
// grid the q blocks of one key block; each recomputes S and P from Q, K
// and the forward's LSE, so nothing of size S x S is ever stored).
//
// What bounds it on this card: at training lengths the products under
// the causal mask against 989 TFLOP/s of bf16 tensor cores. The function
// needs five (S, dP, dV, dK, dQ: 2.5x the forward's FLOPs); the
// two-kernel split computes seven, because each kernel recomputes S and
// dP for itself. Below a few hundred tokens the bytes of Q, K, V, O, dO
// and the three gradients against 3.35 TB/s, and the launches.
//
// Design: the same two-kernel split as the TPU, so no block ever writes
// what another block writes: no atomics, and results that do not depend
// on the order in which blocks run.
// - dq kernel: one block of 4 warps per (64-row q tile, q head, batch
//   row); each warp owns 16 q rows. Its Q and dO tiles stay in shared
//   memory while it walks the K/V tiles (64 keys each, double-buffered
//   with cp.async, up to the causal diagonal). Per tile it forms S = Q K^T
//   and dP = dO V^T on the tensor cores, P = exp(scale S - LSE), dS =
//   P (dP - delta) scale in the accumulators, and dQ += dS K, with dS's
//   accumulators repacked as bf16 A fragments and K's B fragments from
//   ldmatrix.trans. The longest causal walks (the last q tiles) are
//   launched first.
// - dkv kernel: one block of 4 warps per (64-key tile, KV head, batch
//   row); each warp owns 16 keys, whose K and V rows stay in shared
//   memory. GQA runs inside: the block walks every q head of its KV
//   group and every q tile from the causal diagonal on (Q, dO, LSE and
//   delta double-buffered), and sums dK and dV for the whole group in f32
//   registers before one rounding to bf16 (the TPU version rounds once
//   per q head and leaves the group sum to autodiff). Per 32 q rows:
//   S^T = K Q^T, P^T, dV += P^T dO, dP^T = V dO^T, dS^T, dK += dS^T Q.
// P is rounded to bf16 before the dV product and dS before the dQ and dK
// products, as the TPU kernels feed their MXU. Products run as mma.sync
// m16n8k16 (bf16 in, f32 accumulate). Keys past S_k and q rows past S_q
// contribute nothing; head_dim columns past D are zero-filled, so any
// length and any D multiple of 8 up to 128 runs. Not yet: wgmma, TMA,
// warp specialisation.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;       // q rows per tile
constexpr int BK = 64;       // keys per tile
constexpr int NWARPS = 4;
constexpr int NT = NWARPS * 32;
constexpr int DMAX = 128;    // largest head_dim held in registers
constexpr int NO = DMAX / 8; // 8-wide output column tiles
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         const uint32_t* b) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// 2^x on the special-function unit (2 ulp; ex2(-inf) = 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r,
                                                  const void* smem) {
  uint32_t addr = (uint32_t)__cvta_generic_to_shared(smem);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool valid) {
  uint32_t addr = (uint32_t)__cvta_generic_to_shared(smem);
  int src_size = valid ? 16 : 0;  // 0: zero-fill, nothing read
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(addr), "l"(gmem), "r"(src_size));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

// rows [r0, r0 + 64) of a [*, seq, heads, d] tensor at `head` into a
// shared tile (leading dim ldh), asynchronously; rows past `seq` and
// columns past d are zero-filled
__device__ __forceinline__ void load_tile_async(
    __nv_bfloat16* dst, const __nv_bfloat16* src, int r0, int seq,
    int heads, int head, int d, int dp, int ldh, int64_t batch_off) {
  const int vec = dp / 8;
  for (int idx = threadIdx.x; idx < 64 * vec; idx += NT) {
    const int r = idx / vec;
    const int c = (idx % vec) * 8;
    const int row = r0 + r;
    const bool valid = row < seq && c < d;
    const __nv_bfloat16* p =
        valid ? src + ((batch_off + row) * heads + head) * (int64_t)d + c
              : src;
    cp_async16(dst + r * ldh + c, p, valid);
  }
}

// c[j] = A B_j^T for NJ 8-row slices B_j, contracting over head_dim:
// A is 16 rows of a row-major shared tile (`a_rows`), B_j rows
// 8j .. 8j+7 of another (`b_rows`); both hold head_dim contiguous
__device__ __forceinline__ void rows_dot(float (*c)[4], int nj,
                                         const __nv_bfloat16* a_rows,
                                         const __nv_bfloat16* b_rows,
                                         int ldh, int dp, int g, int t) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
    if (j < nj) c[j][0] = c[j][1] = c[j][2] = c[j][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < DMAX / 16; ++kk) {
    if (kk < dp / 16) {
      uint32_t a[4];
      const __nv_bfloat16* pa = a_rows + kk * 16 + 2 * t;
      a[0] = *reinterpret_cast<const uint32_t*>(pa + g * ldh);
      a[1] = *reinterpret_cast<const uint32_t*>(pa + (g + 8) * ldh);
      a[2] = *reinterpret_cast<const uint32_t*>(pa + g * ldh + 8);
      a[3] = *reinterpret_cast<const uint32_t*>(pa + (g + 8) * ldh + 8);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (j < nj) {
          uint32_t b[2];
          const __nv_bfloat16* pb = b_rows + (j * 8 + g) * ldh + kk * 16 + 2 * t;
          b[0] = *reinterpret_cast<const uint32_t*>(pb);
          b[1] = *reinterpret_cast<const uint32_t*>(pb + 8);
          mma_bf16(c[j], a, b);
        }
      }
    }
  }
}

// acc += X M over `nk` 16-row steps: X is 16 rows x 16*nk columns held
// as f32 accumulators x[0 .. 2*nk) (rounded to bf16 here), M the rows
// `m_rows` .. + 16*nk of a row-major shared tile [row][head_dim], read
// as B fragments by ldmatrix.trans
__device__ __forceinline__ void acc_product(float (*acc)[4],
                                            float (*x)[4], int nk,
                                            const __nv_bfloat16* m_rows,
                                            int ldh, int dp, int lane) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    if (kk < nk) {
      uint32_t a[4];
      a[0] = pack_bf16(x[2 * kk][0], x[2 * kk][1]);
      a[1] = pack_bf16(x[2 * kk][2], x[2 * kk][3]);
      a[2] = pack_bf16(x[2 * kk + 1][0], x[2 * kk + 1][1]);
      a[3] = pack_bf16(x[2 * kk + 1][2], x[2 * kk + 1][3]);
      // lanes 0-7 / 8-15 address rows +0..7 / +8..15 of column tile n,
      // lanes 16-31 the same of column tile n+1; the next pair's
      // fragments load before this pair's products
      const __nv_bfloat16* mrow =
          m_rows + (kk * 16 + (lane % 8) + 8 * ((lane / 8) % 2)) * ldh +
          (lane / 16) * 8;
      uint32_t bf[2][4];
      ldmatrix_x4_trans(bf[0], mrow);
#pragma unroll
      for (int n = 0; n < NO; n += 2) {
        if (n < dp / 8) {
          const int cur = (n / 2) % 2;
          if (n + 2 < dp / 8) ldmatrix_x4_trans(bf[cur ^ 1], mrow + (n + 2) * 8);
          mma_bf16(acc[n], a, bf[cur]);
          mma_bf16(acc[n + 1], a, bf[cur] + 2);
        }
      }
    }
  }
}

// 16 rows of f32 accumulators (this lane: rows g and g+8 of the warp's
// 16, columns 8n + 2t, +1) to bf16 rows of a [*, seq, heads, d] tensor
__device__ __forceinline__ void store_rows(__nv_bfloat16* dst, float (*acc)[4],
                                           int row0, int seq, int heads,
                                           int head, int d, int64_t batch_off,
                                           int t) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + 8 * i;
    if (row >= seq) continue;
    __nv_bfloat16* p = dst + ((batch_off + row) * heads + head) * (int64_t)d;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      if (n * 8 < d)
        *reinterpret_cast<__nv_bfloat162*>(p + n * 8 + 2 * t) =
            __floats2bfloat162_rn(acc[n][2 * i], acc[n][2 * i + 1]);
    }
  }
}

__global__ void __launch_bounds__(NT)
flash_bwd_dq_kernel(const __nv_bfloat16* __restrict__ q,
                    const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v,
                    const __nv_bfloat16* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta,
                    __nv_bfloat16* __restrict__ dq, int sq, int sk, int h,
                    int kvh, int d, float scale, int causal) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int dp = (d + 15) / 16 * 16;
  const int ldh = dp + 8;           // bf16 elements; breaks bank conflicts
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* sO = sQ + BQ * ldh;   // dO
  __nv_bfloat16* sK[2] = {sO + BQ * ldh, sO + (BQ + BK) * ldh};
  __nv_bfloat16* sV[2] = {sO + (BQ + 2 * BK) * ldh,
                          sO + (BQ + 3 * BK) * ldh};

  const int n_qt = (sq + BQ - 1) / BQ;
  const int q0 = (n_qt - 1 - (int)blockIdx.x) * BQ;  // long walks first
  const int head = blockIdx.y;
  const int b = blockIdx.z;
  const int kv_head = head / (h / kvh);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int64_t qoff = (int64_t)b * sq;
  const int64_t koff = (int64_t)b * sk;

  load_tile_async(sQ, q, q0, sq, h, head, d, dp, ldh, qoff);
  load_tile_async(sO, dout, q0, sq, h, head, d, dp, ldh, qoff);
  int n_tiles = (sk + BK - 1) / BK;
  if (causal) {
    const int last_row = min(q0 + BQ, sq) - 1;
    n_tiles = min(n_tiles, last_row / BK + 1);
  }
  load_tile_async(sK[0], k, 0, sk, kvh, kv_head, d, dp, ldh, koff);
  load_tile_async(sV[0], v, 0, sk, kvh, kv_head, d, dp, ldh, koff);
  cp_async_commit();

  const int row0 = q0 + warp * 16 + g;   // this lane's rows: row0, row0+8
  float lse2[2], dl[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + 8 * i;
    const int64_t idx = ((int64_t)b * h + head) * sq + row;
    lse2[i] = row < sq ? lse[idx] * LOG2E : 0.f;
    dl[i] = row < sq ? delta[idx] : 0.f;
  }
  float acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  const float sl2 = scale * LOG2E;
  const __nv_bfloat16* qw = sQ + (warp * 16) * ldh;
  const __nv_bfloat16* ow = sO + (warp * 16) * ldh;

  for (int tile = 0; tile < n_tiles; ++tile) {
    const int st = tile & 1;
    if (tile + 1 < n_tiles) {
      const int nxt = (tile + 1) & 1;
      load_tile_async(sK[nxt], k, (tile + 1) * BK, sk, kvh, kv_head, d, dp,
                      ldh, koff);
      load_tile_async(sV[nxt], v, (tile + 1) * BK, sk, kvh, kv_head, d, dp,
                      ldh, koff);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int k0 = tile * BK;

    // P = exp(scale Q K^T - LSE), masked: element e of tile j is row
    // row0 + 8*(e/2), key k0 + 8j + 2t + (e%2)
    float s[8][4];
    rows_dot(s, 8, qw, sK[st], ldh, dp, g, t);
    const bool need_mask =
        k0 + BK > sk || (causal && k0 + BK - 1 > q0 + warp * 16);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float p = ex2(s[j][e] * sl2 - lse2[e / 2]);
        if (need_mask) {
          const int row = row0 + 8 * (e / 2);
          const int col = k0 + 8 * j + 2 * t + (e % 2);
          if (col >= sk || (causal && col > row)) p = 0.f;
        }
        s[j][e] = p;
      }
    }
    // dS = P (dO V^T - delta) scale, in place
    float dpv[8][4];
    rows_dot(dpv, 8, ow, sV[st], ldh, dp, g, t);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        s[j][e] = s[j][e] * (dpv[j][e] - dl[e / 2]) * scale;
    }
    // dQ += dS K
    acc_product(acc, s, 4, sK[st], ldh, dp, lane);
    __syncthreads();  // this stage is refilled two tiles from now
  }
  store_rows(dq, acc, row0, sq, h, head, d, qoff, t);
}

__global__ void __launch_bounds__(NT)
flash_bwd_dkv_kernel(const __nv_bfloat16* __restrict__ q,
                     const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v,
                     const __nv_bfloat16* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta,
                     __nv_bfloat16* __restrict__ dk,
                     __nv_bfloat16* __restrict__ dv, int sq, int sk, int h,
                     int kvh, int d, float scale, int causal) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int dp = (d + 15) / 16 * 16;
  const int ldh = dp + 8;
  __nv_bfloat16* sK = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* sV = sK + BK * ldh;
  __nv_bfloat16* sQ[2] = {sV + BK * ldh, sV + (BK + BQ) * ldh};
  __nv_bfloat16* sO[2] = {sV + (BK + 2 * BQ) * ldh,
                          sV + (BK + 3 * BQ) * ldh};   // dO
  float* sL = reinterpret_cast<float*>(sV + (BK + 4 * BQ) * ldh);  // [2][BQ]
  float* sD = sL + 2 * BQ;                                         // [2][BQ]

  const int k0 = blockIdx.x * BK;   // key tile 0 has the longest walk
  const int kv_head = blockIdx.y;
  const int b = blockIdx.z;
  const int n_rep = h / kvh;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int64_t qoff = (int64_t)b * sq;
  const int64_t koff = (int64_t)b * sk;

  // the walk: every q head of the group x every q tile from the causal
  // diagonal on, flattened so one double buffer spans it
  const int n_qt = (sq + BQ - 1) / BQ;
  const int first = causal ? min(k0 / BQ, n_qt) : 0;
  const int per_head = n_qt - first;
  const int n_iter = n_rep * per_head;

  auto load_stage = [&](int it, int st) {
    const int head = kv_head * n_rep + it / per_head;
    const int r0 = (first + it % per_head) * BQ;
    load_tile_async(sQ[st], q, r0, sq, h, head, d, dp, ldh, qoff);
    load_tile_async(sO[st], dout, r0, sq, h, head, d, dp, ldh, qoff);
    for (int i = threadIdx.x; i < BQ; i += NT) {
      const int row = r0 + i;
      const int64_t idx = ((int64_t)b * h + head) * sq + row;
      // a q row past sq gets LSE = +inf: its P is exp2(-inf) = 0
      sL[st * BQ + i] = row < sq ? lse[idx] * LOG2E : INFINITY;
      sD[st * BQ + i] = row < sq ? delta[idx] : 0.f;
    }
  };

  load_tile_async(sK, k, k0, sk, kvh, kv_head, d, dp, ldh, koff);
  load_tile_async(sV, v, k0, sk, kvh, kv_head, d, dp, ldh, koff);
  if (n_iter > 0) load_stage(0, 0);
  cp_async_commit();

  float dka[NO][4], dva[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n) {
    dka[n][0] = dka[n][1] = dka[n][2] = dka[n][3] = 0.f;
    dva[n][0] = dva[n][1] = dva[n][2] = dva[n][3] = 0.f;
  }
  const float sl2 = scale * LOG2E;
  const int kw0 = k0 + warp * 16;          // this warp's first key
  const __nv_bfloat16* kw = sK + (warp * 16) * ldh;
  const __nv_bfloat16* vw = sV + (warp * 16) * ldh;

  for (int it = 0; it < n_iter; ++it) {
    const int st = it & 1;
    if (it + 1 < n_iter) {
      load_stage(it + 1, st ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int qbase = (first + it % per_head) * BQ;
    const float* lt = sL + st * BQ;
    const float* dt = sD + st * BQ;

#pragma unroll
    for (int c = 0; c < BQ / 32; ++c) {
      const int qc0 = qbase + c * 32;
      // every q row of this chunk is before every key of this warp
      if (causal && qc0 + 31 < kw0) continue;
      const __nv_bfloat16* qrows = sQ[st] + (c * 32) * ldh;
      const __nv_bfloat16* orows = sO[st] + (c * 32) * ldh;
      // P^T = exp(scale K Q^T - LSE): element e of tile j is key
      // kw0 + g + 8*(e/2), q row qc0 + 8j + 2t + (e%2)
      float s[4][4];
      rows_dot(s, 4, kw, qrows, ldh, dp, g, t);
      const bool need_mask = causal && qc0 < kw0 + 15;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int lq = c * 32 + 8 * j + 2 * t + (e % 2);
          float p = ex2(s[j][e] * sl2 - lt[lq]);
          if (need_mask && qbase + lq < kw0 + g + 8 * (e / 2)) p = 0.f;
          s[j][e] = p;
        }
      }
      // dV += P^T dO
      acc_product(dva, s, 2, orows, ldh, dp, lane);
      // dS^T = P^T (V dO^T - delta) scale, in place; dK += dS^T Q
      float dpt[4][4];
      rows_dot(dpt, 4, vw, orows, ldh, dp, g, t);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int lq = c * 32 + 8 * j + 2 * t + (e % 2);
          s[j][e] = s[j][e] * (dpt[j][e] - dt[lq]) * scale;
        }
      }
      acc_product(dka, s, 2, qrows, ldh, dp, lane);
    }
    __syncthreads();  // this stage is refilled two steps from now
  }
  store_rows(dk, dka, kw0 + g, sk, kvh, kv_head, d, koff, t);
  store_rows(dv, dva, kw0 + g, sk, kvh, kv_head, d, koff, t);
}

// raise a kernel's dynamic shared-memory cap once per size (host work
// kept out of launches that may be graph-captured)
template <typename K>
int ensure_smem(K kernel, int bytes, int* configured) {
  if (bytes > *configured) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return (int)err;
    *configured = bytes;
  }
  return 0;
}

bool shapes_ok(int b, int sq, int sk, int h, int kvh, int d) {
  return b > 0 && sq > 0 && sk > 0 && kvh > 0 && h % kvh == 0 &&
         d % 8 == 0 && d >= 8 && d <= DMAX;
}

}  // namespace

extern "C" int flash_bwd_dq_bf16(const void* q, const void* k, const void* v,
                                 const void* dout, const void* lse,
                                 const void* delta, void* dq, int b, int sq,
                                 int sk, int h, int kvh, int d, float scale,
                                 int causal, void* stream) {
  if (!shapes_ok(b, sq, sk, h, kvh, d)) return (int)cudaErrorInvalidValue;
  const int dp = (d + 15) / 16 * 16;
  const int smem = (2 * BQ + 4 * BK) * (dp + 8) * (int)sizeof(__nv_bfloat16);
  static int configured = 0;
  int err = ensure_smem(flash_bwd_dq_kernel, smem, &configured);
  if (err) return err;
  dim3 grid((sq + BQ - 1) / BQ, h, b);
  flash_bwd_dq_kernel<<<grid, NT, smem, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
      (const __nv_bfloat16*)v, (const __nv_bfloat16*)dout, (const float*)lse,
      (const float*)delta, (__nv_bfloat16*)dq, sq, sk, h, kvh, d, scale,
      causal);
  return (int)cudaGetLastError();
}

extern "C" int flash_bwd_dkv_bf16(const void* q, const void* k,
                                  const void* v, const void* dout,
                                  const void* lse, const void* delta,
                                  void* dk, void* dv, int b, int sq, int sk,
                                  int h, int kvh, int d, float scale,
                                  int causal, void* stream) {
  if (!shapes_ok(b, sq, sk, h, kvh, d)) return (int)cudaErrorInvalidValue;
  const int dp = (d + 15) / 16 * 16;
  const int smem = (2 * BK + 4 * BQ) * (dp + 8) * (int)sizeof(__nv_bfloat16) +
                   4 * BQ * (int)sizeof(float);
  static int configured = 0;
  int err = ensure_smem(flash_bwd_dkv_kernel, smem, &configured);
  if (err) return err;
  dim3 grid((sk + BK - 1) / BK, kvh, b);
  flash_bwd_dkv_kernel<<<grid, NT, smem, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
      (const __nv_bfloat16*)v, (const __nv_bfloat16*)dout, (const float*)lse,
      (const float*)delta, (__nv_bfloat16*)dk, (__nv_bfloat16*)dv, sq, sk, h,
      kvh, d, scale, causal);
  return (int)cudaGetLastError();
}
