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
// The same two-kernel split as the TPU, so no block ever writes what
// another block writes: no atomics, and results that do not depend on
// the order in which blocks run. P = exp(scale S - LSE) is recomputed
// from Q, K and the forward's natural-log LSE, dS = P (dP - delta)
// scale; P is rounded to bf16 before the dV product and dS before the
// dQ and dK products, as the TPU kernels feed their MXU. A GQA group's
// dK/dV is summed in f32 inside the dkv block and rounded once (the TPU
// version rounds once per q head and leaves the group sum to autodiff).
// Two variants of each kernel, chosen by shape in ops/flash_attention.py
// `_bwd_variant`:
//
// flash_bwd_dq_wgmma_kernel / flash_bwd_dkv_wgmma_kernel
// (`flash_bwd_{dq,dkv}_wgmma_bf16`; head_dim 64 or 128, q_len == k_len,
// causal or not: the training shapes). Built from the forward's pieces
// (hopper.cuh): 3 warpgroups a block; warpgroup 0 the producer
// (`setmaxnreg` 24; one thread issues every tile as TMA boxes of 64
// columns of a 4-D tensor map over [B, S, heads, D], 128-byte swizzle,
// rows past S zero-filled, through a 2-stage ring of "full" (expect-tx)
// and "empty" mbarriers), warpgroups 1 and 2 consumers (240 registers).
// Each product's descriptors are built where it issues (`desc_at`), and
// LSE / delta are read from shared memory where they are used
// (`lds_f32`), so nothing else sits in registers beside accumulators in
// flight.
// - dq: a block owns 128 q rows (64 a consumer) of one (q head, batch
//   row), q tiles in reverse so the longest causal walks start first.
//   Q, dO stay resident; K and V stream through the ring in tiles of 64
//   keys up to the causal diagonal. Per tile a consumer forms S = Q K^T
//   and dP = dO V^T (m64n64k16, both operands K-major in shared memory,
//   two commit groups: P is formed while dP is in flight), P and dS on
//   the accumulators (a row in the 4 lanes of a quad; LSE and delta of
//   its two rows in registers), and dQ += dS K with dS repacked in
//   registers as the bf16 A operand and K's [keys][D] tile read MN-major
//   (the forward's P V form). Registers a consumer thread at D=128:
//   S 32, dP 32, dQ 64 f32.
// - dkv: a block owns 64 keys of one (KV head, batch row), key tile 0
//   (the longest causal walk) first. K, V stay resident; Q and dO stream
//   through the ring in tiles of 64 q rows, over every q head of the GQA
//   group and every q tile from the causal diagonal on; a second
//   producer warp stages each tile's LSE (times log2 e) and delta rows
//   and arrives on the same "full" barrier. The two consumers split the
//   work by role on the same keys: warpgroup 1 forms S^T = K Q^T, P^T
//   and dV += P^T dO, warpgroup 2 dP^T = V dO^T, dS^T = P^T (dP^T -
//   delta) scale and dK += dS^T Q; P^T passes in f32 through shared
//   memory (named barriers 1 and 2). Both issue the same instructions on
//   other descriptors (S^T / dP^T smem x smem; dV / dK with A from
//   registers and dO / Q read MN-major), so no wgmma sits on a divergent
//   path. Registers a consumer thread at D=128: S^T or dP^T 32, dV or dK
//   64 f32 (one consumer holding dK, dV, S^T and dP^T, 192, spilled and
//   serialized its wgmma: PERF.md, findings).
//
// flash_bwd_dq_kernel / flash_bwd_dkv_kernel (`flash_bwd_{dq,dkv}_bf16`;
// every other shape: head_dim any multiple of 8 up to 256, q_len !=
// k_len). mma.sync m16n8k16 (bf16 in, f32 accumulate), 4 warps a block,
// tiles double-buffered with cp.async.
// - dq kernel: one block per (64-row q tile, q head, batch row, 128-
//   column half of head_dim); each warp owns 16 q rows. Its Q and dO
//   tiles stay in shared memory while it walks the K/V tiles (64 keys
//   each, up to the causal diagonal). Per tile it forms S = Q K^T and
//   dP = dO V^T over the full head_dim, P and dS in the accumulators,
//   and dQ += dS K for its 128 columns, with dS's accumulators repacked
//   as bf16 A fragments and K's B fragments from ldmatrix.trans. The
//   longest causal walks (the last q tiles) are launched first.
// - dkv kernel: one block per (64-key tile, KV head, batch row, 128-
//   column half); each warp owns 16 keys, whose K and V rows stay in
//   shared memory. GQA runs inside: the block walks every q head of its
//   KV group and every q tile from the causal diagonal on (Q, dO, LSE
//   and delta double-buffered) and sums dK and dV for the whole group
//   in f32 registers before one rounding. Per 32 q rows: S^T = K Q^T,
//   P^T, dV += P^T dO, dP^T = V dO^T, dS^T, dK += dS^T Q.
// head_dim above 128 splits the outputs' columns over two blocks, each
// recomputing S and dP over the full head_dim from shared memory, so a
// block holds 128 output columns in registers whatever D is. Keys past
// S_k and q rows past S_q contribute nothing; head_dim columns past D
// are zero-filled.

#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int BQ = 64;       // q rows per tile
constexpr int BK = 64;       // keys per tile
constexpr int NWARPS = 4;
constexpr int NT = NWARPS * 32;
constexpr int OC = 128;      // output columns a block holds in registers
constexpr int NO = OC / 8;   // 8-wide output column tiles
constexpr float LOG2E = 1.4426950408889634f;

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

// c[j] = A B_j^T for NJ 8-row slices B_j, contracting over head_dim
// (dp <= DC): A is 16 rows of a row-major shared tile (`a_rows`), B_j
// rows 8j .. 8j+7 of another (`b_rows`); both hold head_dim contiguous
template <int DC>
__device__ __forceinline__ void rows_dot(float (*c)[4], int nj,
                                         const __nv_bfloat16* a_rows,
                                         const __nv_bfloat16* b_rows,
                                         int ldh, int dp, int g, int t) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
    if (j < nj) c[j][0] = c[j][1] = c[j][2] = c[j][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < DC / 16; ++kk) {
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
// from the block's first output column on (dpo <= 128 columns) as B
// fragments by ldmatrix.trans
__device__ __forceinline__ void acc_product(float (*acc)[4],
                                            float (*x)[4], int nk,
                                            const __nv_bfloat16* m_rows,
                                            int ldh, int dpo, int lane) {
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
        if (n < dpo / 8) {
          const int cur = (n / 2) % 2;
          if (n + 2 < dpo / 8) ldmatrix_x4_trans(bf[cur ^ 1], mrow + (n + 2) * 8);
          mma_bf16(acc[n], a, bf[cur]);
          mma_bf16(acc[n + 1], a, bf[cur] + 2);
        }
      }
    }
  }
}

// 16 rows of f32 accumulators (this lane: rows g and g+8 of the warp's
// 16, columns c0 + 8n + 2t, +1) to bf16 rows of a [*, seq, heads, d]
// tensor
__device__ __forceinline__ void store_rows(__nv_bfloat16* dst, float (*acc)[4],
                                           int row0, int seq, int heads,
                                           int head, int d, int c0,
                                           int64_t batch_off, int t) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + 8 * i;
    if (row >= seq) continue;
    __nv_bfloat16* p =
        dst + ((batch_off + row) * heads + head) * (int64_t)d + c0;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      if (c0 + n * 8 < d)
        *reinterpret_cast<__nv_bfloat162*>(p + n * 8 + 2 * t) =
            __floats2bfloat162_rn(acc[n][2 * i], acc[n][2 * i + 1]);
    }
  }
}

// DC: largest padded head_dim this instantiation contracts over (128 or
// 256); blockIdx.x = q tile (reversed) x column halves
template <int DC>
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

  const int nh = (dp + OC - 1) / OC;  // column halves
  const int c0 = (blockIdx.x % nh) * OC;
  const int dpo = min(dp - c0, OC);
  const int n_qt = (sq + BQ - 1) / BQ;
  const int q0 = (n_qt - 1 - (int)blockIdx.x / nh) * BQ;  // long walks first
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
    rows_dot<DC>(s, 8, qw, sK[st], ldh, dp, g, t);
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
    rows_dot<DC>(dpv, 8, ow, sV[st], ldh, dp, g, t);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        s[j][e] = s[j][e] * (dpv[j][e] - dl[e / 2]) * scale;
    }
    // dQ += dS K, this block's columns
    acc_product(acc, s, 4, sK[st] + c0, ldh, dpo, lane);
    __syncthreads();  // this stage is refilled two tiles from now
  }
  store_rows(dq, acc, row0, sq, h, head, d, c0, qoff, t);
}

// blockIdx.x = key tile x column halves
template <int DC>
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

  const int nh = (dp + OC - 1) / OC;
  const int c0 = (blockIdx.x % nh) * OC;
  const int dpo = min(dp - c0, OC);
  const int k0 = (blockIdx.x / nh) * BK;   // key tile 0 has the longest walk
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
      rows_dot<DC>(s, 4, kw, qrows, ldh, dp, g, t);
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
      // dV += P^T dO, this block's columns
      acc_product(dva, s, 2, orows + c0, ldh, dpo, lane);
      // dS^T = P^T (V dO^T - delta) scale, in place; dK += dS^T Q
      float dpt[4][4];
      rows_dot<DC>(dpt, 4, vw, orows, ldh, dp, g, t);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int lq = c * 32 + 8 * j + 2 * t + (e % 2);
          s[j][e] = s[j][e] * (dpt[j][e] - dt[lq]) * scale;
        }
      }
      acc_product(dka, s, 2, qrows + c0, ldh, dpo, lane);
    }
    __syncthreads();  // this stage is refilled two steps from now
  }
  store_rows(dk, dka, kw0 + g, sk, kvh, kv_head, d, c0, koff, t);
  store_rows(dv, dva, kw0 + g, sk, kvh, kv_head, d, c0, koff, t);
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
         d % 8 == 0 && d >= 8 && d <= 256;
}

template <int DC>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const void* lse, const void* delta, void* dq, int b, int sq,
              int sk, int h, int kvh, int d, float scale, int causal,
              cudaStream_t stream) {
  const int dp = (d + 15) / 16 * 16;
  const int smem = (2 * BQ + 4 * BK) * (dp + 8) * (int)sizeof(__nv_bfloat16);
  static int configured = 0;
  int err = ensure_smem(flash_bwd_dq_kernel<DC>, smem, &configured);
  if (err) return err;
  dim3 grid((sq + BQ - 1) / BQ * ((dp + OC - 1) / OC), h, b);
  flash_bwd_dq_kernel<DC><<<grid, NT, smem, stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
      (const __nv_bfloat16*)v, (const __nv_bfloat16*)dout, (const float*)lse,
      (const float*)delta, (__nv_bfloat16*)dq, sq, sk, h, kvh, d, scale,
      causal);
  return (int)cudaGetLastError();
}

template <int DC>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout,
               const void* lse, const void* delta, void* dk, void* dv, int b,
               int sq, int sk, int h, int kvh, int d, float scale, int causal,
               cudaStream_t stream) {
  const int dp = (d + 15) / 16 * 16;
  const int smem = (2 * BK + 4 * BQ) * (dp + 8) * (int)sizeof(__nv_bfloat16) +
                   4 * BQ * (int)sizeof(float);
  static int configured = 0;
  int err = ensure_smem(flash_bwd_dkv_kernel<DC>, smem, &configured);
  if (err) return err;
  dim3 grid((sk + BK - 1) / BK * ((dp + OC - 1) / OC), kvh, b);
  flash_bwd_dkv_kernel<DC><<<grid, NT, smem, stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
      (const __nv_bfloat16*)v, (const __nv_bfloat16*)dout, (const float*)lse,
      (const float*)delta, (__nv_bfloat16*)dk, (__nv_bfloat16*)dv, sq, sk, h,
      kvh, d, scale, causal);
  return (int)cudaGetLastError();
}

// ---- the Hopper-native variants: TMA, mbarrier ring, wgmma ------------

constexpr int W_NT = 384;            // producer + 2 consumer warpgroups
constexpr int W_STAGES = 2;
constexpr int DQ_BM = 128;           // dq: q rows a block, 64 a consumer
constexpr int DQ_BN = 64;            // dq: keys a K/V stage
constexpr int DKV_BN = 64;           // dkv: keys a block
constexpr int DKV_BM = 64;           // dkv: q rows a Q/dO stage

// D = 64 or 128: NH = D / 64 halves of 64 columns in every tile
template <int D>
__global__ void __launch_bounds__(W_NT, 1)
flash_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                          const __grid_constant__ CUtensorMap tm_k,
                          const __grid_constant__ CUtensorMap tm_v,
                          const __grid_constant__ CUtensorMap tm_do,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta,
                          __nv_bfloat16* __restrict__ dq, int s, int h,
                          int kvh, float scale, int causal) {
  constexpr int NH = D / 64;
  constexpr int QHALF = DQ_BM * 128;          // bytes of 128 rows x 64 cols
  constexpr int KHALF = DQ_BN * 128;          // bytes of 64 rows x 64 cols
  constexpr int QTILE = NH * QHALF;
  constexpr int KTILE = NH * KHALF;
  extern __shared__ unsigned char smem_raw[];
  // TMA's 128-byte swizzle and the descriptors need 1024-byte atoms
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~(uintptr_t)1023);
  unsigned char* sq = smem;                   // Q, dO, then K0 V0 K1 V1
  unsigned char* sdo = sq + QTILE;
  unsigned char* skv = sdo + QTILE;
  uint64_t* bars = reinterpret_cast<uint64_t*>(skv + 2 * KTILE * W_STAGES);
  uint64_t* full_qo = bars;
  uint64_t* full_k = bars + 1;
  uint64_t* full_v = bars + 1 + W_STAGES;
  uint64_t* empty = bars + 1 + 2 * W_STAGES;

  const int q0 = ((int)gridDim.z - 1 - (int)blockIdx.z) * DQ_BM;
  const int head = blockIdx.x;
  const int b = blockIdx.y;
  const int kv_head = head / (h / kvh);
  int n_tiles = (s + DQ_BN - 1) / DQ_BN;
  if (causal) n_tiles = min(n_tiles, (min(q0 + DQ_BM, s) - 1) / DQ_BN + 1);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    mbar_init(full_qo, 1);
    for (int st = 0; st < W_STAGES; ++st) {
      mbar_init(full_k + st, 1);
      mbar_init(full_v + st, 1);
      mbar_init(empty + st, 8);               // the 8 consumer warps
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp < 4) {
    // ---- producer warpgroup: one thread issues every TMA load ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 0) {
      mbar_expect_tx(full_qo, 2 * QTILE);
      for (int hf = 0; hf < NH; ++hf) {
        tma_load_4d(sq + hf * QHALF, &tm_q, full_qo, 64 * hf, head, q0, b);
        tma_load_4d(sdo + hf * QHALF, &tm_do, full_qo, 64 * hf, head, q0, b);
      }
      for (int t = 0; t < n_tiles; ++t) {
        const int st = t % W_STAGES;
        // stage st was last read by tile t - 2: its release is the
        // (t / 2 - 1)-th completion of empty[st]
        if (t >= W_STAGES) mbar_wait(empty + st, (t / W_STAGES - 1) & 1);
        unsigned char* sk = skv + 2 * KTILE * st;
        unsigned char* sv = sk + KTILE;
        mbar_expect_tx(full_k + st, KTILE);
        for (int hf = 0; hf < NH; ++hf)
          tma_load_4d(sk + hf * KHALF, &tm_k, full_k + st, 64 * hf, kv_head,
                      t * DQ_BN, b);
        mbar_expect_tx(full_v + st, KTILE);
        for (int hf = 0; hf < NH; ++hf)
          tma_load_4d(sv + hf * KHALF, &tm_v, full_v + st, 64 * hf, kv_head,
                      t * DQ_BN, b);
      }
    }
  } else {
    // ---- consumer warpgroups: 64 q rows each ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int wgc = warp / 4 - 1;             // 0 or 1
    const int wq = warp % 4;                  // 16-row slice of the 64
    const int g = lane / 4;
    const int tq = lane % 4;
    const int wrow = q0 + 64 * wgc + 16 * wq; // this warp's first row
    const int row0 = wrow + g;                // this lane's: row0, +8
    // descriptor bases: this warpgroup's 64 rows of Q and dO
    const uint32_t qa = sw128_lo(sq + 64 * wgc * 128, 16);
    const uint32_t oa = sw128_lo(sdo + 64 * wgc * 128, 16);
    const float sl2 = scale * LOG2E;
    float lse2[2], dl[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 8 * r;
      const int64_t idx = ((int64_t)b * h + head) * s + row;
      lse2[r] = row < s ? lse[idx] * LOG2E : 0.f;
      dl[r] = row < s ? delta[idx] : 0.f;
    }

    // accumulator i of an m64nN wgmma: n8 block j = i / 4, element
    // e = i % 4 at row row0 + 8 * (e / 2), column 8j + 2tq + e % 2
    float acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;

    mbar_wait(full_qo, 0);
    for (int t = 0; t < n_tiles; ++t) {
      const int st = t % W_STAGES;
      const int ph = (t / W_STAGES) & 1;
      const uint32_t ka = sw128_lo(skv + 2 * KTILE * st, 16);
      const uint32_t va = sw128_lo(skv + 2 * KTILE * st + KTILE, 16);
      const uint32_t kt = sw128_lo(skv + 2 * KTILE * st, KHALF);
      const int k0 = t * DQ_BN;

      // S = Q K^T and dP = dO V^T: 64 rows x 64 keys, D / 16 k-steps,
      // two commit groups: P is formed while dP is still in flight
      float sc[32], dpv[32];
      uint32_t da[16];
      mbar_wait(full_k + st, ph);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks) {
        const int off = (ks / 4) * QHALF + 32 * (ks % 4);
        const int koff = (ks / 4) * KHALF + 32 * (ks % 4);
        wgmma_ss_n64(sc, desc_at(qa, off), desc_at(ka, koff), ks > 0);
      }
      wgmma_commit();
      mbar_wait(full_v + st, ph);
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks) {
        const int off = (ks / 4) * QHALF + 32 * (ks % 4);
        const int koff = (ks / 4) * KHALF + 32 * (ks % 4);
        wgmma_ss_n64(dpv, desc_at(oa, off), desc_at(va, koff), ks > 0);
      }
      wgmma_commit();
      wgmma_wait<1>();
#pragma unroll
      for (int i = 0; i < 32; ++i) reg_fence(sc[i]);
      // P = exp2(S scale log2 e - LSE log2 e), masked, in place. Only
      // the ragged last tile and tiles crossing this warp's causal
      // diagonal need the mask. The last tile of a block lies past the
      // diagonal of all of warpgroup 0's rows and is computed all the
      // same: skipping it would put its wgmma on a warpgroup-dependent
      // branch, which ptxas serializes (C7518)
      const bool need_mask =
          k0 + DQ_BN > s || (causal && k0 + DQ_BN - 1 > wrow);
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int r = (i % 4) / 2;
        float p = ex2(sc[i] * sl2 - lse2[r]);
        if (need_mask) {
          const int row = row0 + 8 * r;
          const int col = k0 + 8 * (i / 4) + 2 * tq + i % 2;
          if (col >= s || (causal && col > row)) p = 0.f;
        }
        sc[i] = p;
      }
      // dS = P (dP - delta) scale, rounded to bf16 as the A operand of
      // dS K: k-step kk covers keys 16kk..16kk+15, n8 blocks 2kk, 2kk+1
      wgmma_wait<0>();
#pragma unroll
      for (int i = 0; i < 32; ++i) reg_fence(dpv[i]);
#pragma unroll
      for (int i = 0; i < 32; i += 2) {
        const int r = (i % 4) / 2;
        da[i / 2] = pack_bf16(sc[i] * (dpv[i] - dl[r]) * scale,
                              sc[i + 1] * (dpv[i + 1] - dl[r]) * scale);
      }

      // dQ += dS K: K's [keys][D] tile as an MN-major B operand
#pragma unroll
      for (int i = 0; i < D / 2; ++i) reg_fence(acc[i]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DQ_BN / 16; ++kk) {
        const uint64_t dk = desc_at(kt, kk * 16 * 128);
        if constexpr (D == 128)
          wgmma_rs_n128(acc, da + 4 * kk, dk);
        else
          wgmma_rs_n64(acc, da + 4 * kk, dk);
      }
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int i = 0; i < D / 2; ++i) reg_fence(acc[i]);
      if (lane == 0) mbar_arrive(empty + st);
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 8 * r;
      if (row >= s) continue;
      __nv_bfloat16* dst = dq + (((int64_t)b * s + row) * h + head) * D;
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<__nv_bfloat162*>(dst + 8 * j + 2 * tq) =
            __floats2bfloat162_rn(acc[4 * j + 2 * r], acc[4 * j + 2 * r + 1]);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(W_NT, 1)
flash_bwd_dkv_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                           const __grid_constant__ CUtensorMap tm_k,
                           const __grid_constant__ CUtensorMap tm_v,
                           const __grid_constant__ CUtensorMap tm_do,
                           const float* __restrict__ lse,
                           const float* __restrict__ delta,
                           __nv_bfloat16* __restrict__ dk,
                           __nv_bfloat16* __restrict__ dv, int s, int h,
                           int kvh, float scale, int causal) {
  constexpr int NH = D / 64;
  constexpr int KHALF = DKV_BN * 128;         // bytes of 64 rows x 64 cols
  constexpr int QHALF = DKV_BM * 128;
  constexpr int KTILE = NH * KHALF;
  constexpr int QTILE = NH * QHALF;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~(uintptr_t)1023);
  unsigned char* sk = smem;                   // K, V, then Q0 dO0 Q1 dO1
  unsigned char* sv = sk + KTILE;
  unsigned char* sqo = sv + KTILE;
  // P^T in f32 as the P consumer wrote it ([32][128 threads], 16 KB),
  // then a stage's LSE rows (times log2 e) and delta rows
  float* sp = reinterpret_cast<float*>(sqo + 2 * QTILE * W_STAGES);
  float* sl = sp + 32 * 128;
  float* sd = sl + W_STAGES * DKV_BM;
  uint64_t* bars = reinterpret_cast<uint64_t*>(sd + W_STAGES * DKV_BM);
  uint64_t* full_kv = bars;
  uint64_t* full = bars + 1;
  uint64_t* empty = bars + 1 + W_STAGES;

  const int k0 = blockIdx.z * DKV_BN;        // key tile 0: the longest walk
  const int kv_head = blockIdx.x;
  const int b = blockIdx.y;
  const int n_rep = h / kvh;
  // the walk: every q head of the group x every q tile from the causal
  // diagonal on, flattened so one ring spans it
  const int n_qt = (s + DKV_BM - 1) / DKV_BM;
  const int first = causal ? min(k0 / DKV_BM, n_qt) : 0;
  const int per_head = n_qt - first;
  const int n_iter = n_rep * per_head;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    mbar_init(full_kv, 1);
    for (int st = 0; st < W_STAGES; ++st) {
      mbar_init(full + st, 1 + 32);           // the TMA thread + warp 1
      mbar_init(empty + st, 8);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp < 4) {
    // ---- producer warpgroup: thread 0 issues the TMA loads, warp 1
    // stages LSE and delta ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 0) {
      mbar_expect_tx(full_kv, 2 * KTILE);
      for (int hf = 0; hf < NH; ++hf) {
        tma_load_4d(sk + hf * KHALF, &tm_k, full_kv, 64 * hf, kv_head, k0, b);
        tma_load_4d(sv + hf * KHALF, &tm_v, full_kv, 64 * hf, kv_head, k0, b);
      }
      for (int it = 0; it < n_iter; ++it) {
        const int st = it % W_STAGES;
        if (it >= W_STAGES) mbar_wait(empty + st, (it / W_STAGES - 1) & 1);
        const int head = kv_head * n_rep + it / per_head;
        const int r0 = (first + it % per_head) * DKV_BM;
        unsigned char* qs = sqo + 2 * QTILE * st;
        mbar_expect_tx(full + st, 2 * QTILE);
        for (int hf = 0; hf < NH; ++hf) {
          tma_load_4d(qs + hf * QHALF, &tm_q, full + st, 64 * hf, head, r0, b);
          tma_load_4d(qs + QTILE + hf * QHALF, &tm_do, full + st, 64 * hf,
                      head, r0, b);
        }
      }
    } else if (warp == 1) {
      for (int it = 0; it < n_iter; ++it) {
        const int st = it % W_STAGES;
        if (it >= W_STAGES) mbar_wait(empty + st, (it / W_STAGES - 1) & 1);
        const int head = kv_head * n_rep + it / per_head;
        const int r0 = (first + it % per_head) * DKV_BM;
        for (int i = lane; i < DKV_BM; i += 32) {
          const int row = r0 + i;
          const int64_t idx = ((int64_t)b * h + head) * s + row;
          // a q row past s gets LSE = +inf: its P is exp2(-inf) = 0
          sl[st * DKV_BM + i] = row < s ? lse[idx] * LOG2E : INFINITY;
          sd[st * DKV_BM + i] = row < s ? delta[idx] : 0.f;
        }
        mbar_arrive(full + st);
      }
    }
  } else {
    // ---- consumer warpgroups, both on the block's 64 keys: warpgroup
    // 1 (pc) forms P^T and dV, warpgroup 2 dS^T and dK ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int wgc = warp / 4 - 1;
    const bool pc = wgc == 0;
    const int wq = warp % 4;
    const int g = lane / 4;
    const int tq = lane % 4;
    const int tid = threadIdx.x % 128;
    const int wkey = k0 + 16 * wq;            // this warp's first key
    const int key0 = wkey + g;                // this lane's: key0, +8
    // the first product's A operand: K (for S^T) or V (for dP^T)
    const uint32_t xa = sw128_lo(pc ? sk : sv, 16);
    const float sl2 = scale * LOG2E;

    // accumulator i: key key0 + 8 * ((i % 4) / 2), column 8 (i / 4) +
    // 2tq + i % 2 (a q row of the tile for S^T, dP^T; a head_dim
    // column for dV, dK)
    float acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;

    mbar_wait(full_kv, 0);
    for (int it = 0; it < n_iter; ++it) {
      const int st = it % W_STAGES;
      const int ph = (it / W_STAGES) & 1;
      const unsigned char* qs = sqo + 2 * QTILE * st;
      // the products' B operands: Q^T or dO^T for S^T / dP^T, then dO
      // or Q (MN-major) for dV / dK
      const uint32_t xb = sw128_lo(pc ? qs : qs + QTILE, 16);
      const uint32_t yb = sw128_lo(pc ? qs + QTILE : qs, QHALF);
      const float* lt = sl + st * DKV_BM;
      const float* dt = sd + st * DKV_BM;
      const int q0 = (first + it % per_head) * DKV_BM;

      // S^T = K Q^T (pc) or dP^T = V dO^T: 64 keys x 64 q rows; one
      // instruction stream for both warpgroups, so no wgmma issues on a
      // divergent path
      float x[32];
      uint32_t ya[16];
      mbar_wait(full + st, ph);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks) {
        const int koff = (ks / 4) * KHALF + 32 * (ks % 4);
        const int qoff = (ks / 4) * QHALF + 32 * (ks % 4);
        wgmma_ss_n64(x, desc_at(xa, koff), desc_at(xb, qoff), ks > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int i = 0; i < 32; ++i) reg_fence(x[i]);
      if (pc) {
        // P^T, masked; kept in f32 for the dS consumer, rounded to bf16
        // as the A operand of P^T dO (k-step kk: q rows 16kk..16kk+15).
        // Only tiles crossing this warp's causal diagonal need the
        // mask. LSE is read from shared memory where it is used
        const bool need_mask = causal && q0 < wkey + 15;
#pragma unroll
        for (int i = 0; i < 32; i += 2) {
          const int key = key0 + 8 * ((i % 4) / 2);
          const int lq = 8 * (i / 4) + 2 * tq;
          float p0 = ex2(x[i] * sl2 - lds_f32(lt + lq));
          float p1 = ex2(x[i + 1] * sl2 - lds_f32(lt + lq + 1));
          if (need_mask) {
            if (q0 + lq < key) p0 = 0.f;
            if (q0 + lq + 1 < key) p1 = 0.f;
          }
          x[i] = p0;
          x[i + 1] = p1;
          ya[i / 2] = pack_bf16(p0, p1);
        }
        // the last P^T has been read (the dS consumer arrives on 2)
        if (it > 0) bar_sync(2);
#pragma unroll
        for (int i = 0; i < 32; i += 4)
          *reinterpret_cast<float4*>(sp + (i * 128 + 4 * tid)) =
              make_float4(x[i], x[i + 1], x[i + 2], x[i + 3]);
        bar_arrive(1);                        // P^T is in shared memory
      } else {
        // dS^T = P^T (dP^T - delta) scale, rounded to bf16 as the A
        // operand of dS^T Q
        bar_sync(1);
#pragma unroll
        for (int i = 0; i < 32; i += 4) {
          const float4 p = *reinterpret_cast<const float4*>(sp + (i * 128 + 4 * tid));
          const int lq = 8 * (i / 4) + 2 * tq;
          const float d0 = lds_f32(dt + lq), d1 = lds_f32(dt + lq + 1);
          ya[i / 2] = pack_bf16(p.x * (x[i] - d0) * scale,
                                p.y * (x[i + 1] - d1) * scale);
          ya[i / 2 + 1] = pack_bf16(p.z * (x[i + 2] - d0) * scale,
                                    p.w * (x[i + 3] - d1) * scale);
        }
        bar_arrive(2);                        // P^T may be overwritten
      }

      // dV += P^T dO (pc) or dK += dS^T Q, A from registers, dO / Q
      // through the transposed-B descriptor
#pragma unroll
      for (int i = 0; i < D / 2; ++i) reg_fence(acc[i]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DKV_BM / 16; ++kk) {
        const uint64_t dd = desc_at(yb, kk * 16 * 128);
        if constexpr (D == 128)
          wgmma_rs_n128(acc, ya + 4 * kk, dd);
        else
          wgmma_rs_n64(acc, ya + 4 * kk, dd);
      }
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int i = 0; i < D / 2; ++i) reg_fence(acc[i]);
      if (lane == 0) mbar_arrive(empty + st);
    }

    __nv_bfloat16* out = pc ? dv : dk;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int key = key0 + 8 * r;
      if (key >= s) continue;
      __nv_bfloat16* dst = out + (((int64_t)b * s + key) * kvh + kv_head) * D;
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<__nv_bfloat162*>(dst + 8 * j + 2 * tq) =
            __floats2bfloat162_rn(acc[4 * j + 2 * r], acc[4 * j + 2 * r + 1]);
    }
  }
}

// the tensor maps of q and dO (boxes of `q_rows` rows) and k and v
// (boxes of `k_rows`), encoded on the host for each launch (a few
// microseconds) and passed by value, so a captured CUDA graph holds its
// own copies
struct Maps {
  CUtensorMap q, k, v, dout;
};

bool make_maps(Maps* m, const void* q, const void* k, const void* v,
               const void* dout, int b, int s, int h, int kvh, int d,
               int q_rows, int k_rows) {
  return make_map(&m->q, q, b, s, h, d, q_rows) &&
         make_map(&m->dout, dout, b, s, h, d, q_rows) &&
         make_map(&m->k, k, b, s, kvh, d, k_rows) &&
         make_map(&m->v, v, b, s, kvh, d, k_rows);
}

template <int D>
int launch_dq_wgmma(const void* q, const void* k, const void* v,
                    const void* dout, const void* lse, const void* delta,
                    void* dq, int b, int s, int h, int kvh, float scale,
                    int causal, cudaStream_t stream) {
  Maps m;
  if (!make_maps(&m, q, k, v, dout, b, s, h, kvh, D, DQ_BM, DQ_BN))
    return (int)cudaErrorInvalidValue;
  constexpr int smem = (D / 64) * 128 * (2 * DQ_BM + 2 * W_STAGES * DQ_BN) +
                       8 * (1 + 3 * W_STAGES) + 1024;
  static int configured = 0;
  int err = ensure_smem(flash_bwd_dq_wgmma_kernel<D>, smem, &configured);
  if (err) return err;
  const dim3 grid(h, b, (s + DQ_BM - 1) / DQ_BM);
  flash_bwd_dq_wgmma_kernel<D><<<grid, W_NT, smem, stream>>>(
      m.q, m.k, m.v, m.dout, (const float*)lse, (const float*)delta,
      (__nv_bfloat16*)dq, s, h, kvh, scale, causal);
  return (int)cudaGetLastError();
}

template <int D>
int launch_dkv_wgmma(const void* q, const void* k, const void* v,
                     const void* dout, const void* lse, const void* delta,
                     void* dk, void* dv, int b, int s, int h, int kvh,
                     float scale, int causal, cudaStream_t stream) {
  Maps m;
  if (!make_maps(&m, q, k, v, dout, b, s, h, kvh, D, DKV_BM, DKV_BN))
    return (int)cudaErrorInvalidValue;
  constexpr int smem =
      (D / 64) * 128 * (2 * DKV_BN + 2 * W_STAGES * DKV_BM) +
      (32 * 128 + 2 * W_STAGES * DKV_BM) * (int)sizeof(float) +
      8 * (1 + 2 * W_STAGES) + 1024;
  static int configured = 0;
  int err = ensure_smem(flash_bwd_dkv_wgmma_kernel<D>, smem, &configured);
  if (err) return err;
  const dim3 grid(kvh, b, (s + DKV_BN - 1) / DKV_BN);
  flash_bwd_dkv_wgmma_kernel<D><<<grid, W_NT, smem, stream>>>(
      m.q, m.k, m.v, m.dout, (const float*)lse, (const float*)delta,
      (__nv_bfloat16*)dk, (__nv_bfloat16*)dv, s, h, kvh, scale, causal);
  return (int)cudaGetLastError();
}

bool wgmma_shapes_ok(int b, int sq, int sk, int h, int kvh, int d) {
  return b > 0 && sq > 0 && sq == sk && kvh > 0 && h % kvh == 0 &&
         (d == 64 || d == 128);
}

}  // namespace

extern "C" int flash_bwd_dq_bf16(const void* q, const void* k, const void* v,
                                 const void* dout, const void* lse,
                                 const void* delta, void* dq, int b, int sq,
                                 int sk, int h, int kvh, int d, float scale,
                                 int causal, void* stream) {
  if (!shapes_ok(b, sq, sk, h, kvh, d)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (d <= 128)
    return launch_dq<128>(q, k, v, dout, lse, delta, dq, b, sq, sk, h, kvh,
                          d, scale, causal, st);
  return launch_dq<256>(q, k, v, dout, lse, delta, dq, b, sq, sk, h, kvh, d,
                        scale, causal, st);
}

extern "C" int flash_bwd_dkv_bf16(const void* q, const void* k,
                                  const void* v, const void* dout,
                                  const void* lse, const void* delta,
                                  void* dk, void* dv, int b, int sq, int sk,
                                  int h, int kvh, int d, float scale,
                                  int causal, void* stream) {
  if (!shapes_ok(b, sq, sk, h, kvh, d)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (d <= 128)
    return launch_dkv<128>(q, k, v, dout, lse, delta, dk, dv, b, sq, sk, h,
                           kvh, d, scale, causal, st);
  return launch_dkv<256>(q, k, v, dout, lse, delta, dk, dv, b, sq, sk, h,
                         kvh, d, scale, causal, st);
}

// The Hopper-native variants: head_dim 64 or 128 and q_len == k_len; the
// same arguments as the mma.sync entries above.
extern "C" int flash_bwd_dq_wgmma_bf16(const void* q, const void* k,
                                       const void* v, const void* dout,
                                       const void* lse, const void* delta,
                                       void* dq, int b, int sq, int sk,
                                       int h, int kvh, int d, float scale,
                                       int causal, void* stream) {
  if (!wgmma_shapes_ok(b, sq, sk, h, kvh, d))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (d == 64)
    return launch_dq_wgmma<64>(q, k, v, dout, lse, delta, dq, b, sq, h, kvh,
                               scale, causal, st);
  return launch_dq_wgmma<128>(q, k, v, dout, lse, delta, dq, b, sq, h, kvh,
                              scale, causal, st);
}

extern "C" int flash_bwd_dkv_wgmma_bf16(const void* q, const void* k,
                                        const void* v, const void* dout,
                                        const void* lse, const void* delta,
                                        void* dk, void* dv, int b, int sq,
                                        int sk, int h, int kvh, int d,
                                        float scale, int causal,
                                        void* stream) {
  if (!wgmma_shapes_ok(b, sq, sk, h, kvh, d))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (d == 64)
    return launch_dkv_wgmma<64>(q, k, v, dout, lse, delta, dk, dv, b, sq, h,
                                kvh, scale, causal, st);
  return launch_dkv_wgmma<128>(q, k, v, dout, lse, delta, dk, dv, b, sq, h,
                               kvh, scale, causal, st);
}
