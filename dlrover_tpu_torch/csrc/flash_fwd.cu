// Flash-attention forward for Hopper (sm_90a), bf16 in and out.
//
// Replaces: dlrover_tpu/ops/flash_attention.py `_fwd_kernel`, launched
// by `_fwd` (the Pallas TPU kernel: grid (b, h, q-block, k-block) over
// [B, H, S, D], online softmax in VMEM scratch, O and an 8-lane LSE).
//
// What bounds it on this card: at prefill lengths the two products
// (2 * B * H * S^2 * D FLOPs under the causal mask) against 989 TFLOP/s
// of bf16 tensor cores; below a few hundred tokens the bytes of Q, K,
// V and O against 3.35 TB/s, and the launch.
//
// Two variants, chosen by shape in ops/flash_attention.py
// `_fwd_variant`:
//
// flash_fwd_wgmma_kernel (`flash_fwd_wgmma_bf16`; head_dim 64 or 128,
// q_len == k_len, causal or not: the prefill and training shapes). One
// block of 3 warpgroups per (128-row q tile, q head, batch row), q
// tiles walked in reverse so the longest causal walks start first.
// Warpgroup 0 is the producer: after `setmaxnreg` it keeps 24
// registers and one thread issues every load as a TMA box of a 4-D
// tensor map over [B, S, heads, D] (64 columns x 1 head x 128 rows,
// 128-byte swizzle, rows past S zero-filled by the hardware): Q once,
// then K and V through a ring of 2 stages of 128 keys, each stage with
// a "full" mbarrier for K and one for V (expect-tx bytes) and an
// "empty" one that each consumer warp arrives on. Warpgroups 1 and 2
// are consumers with 240 registers, 64 q rows each: S = Q K^T is 8
// (D=128) wgmma m64n128k16 with both operands K-major in shared
// memory; the online softmax runs on the accumulators in base 2 (a
// row lives in the 4 lanes of a quad, as in the mma.sync layout); P is
// rounded to bf16 and repacked in registers as the A operand of
// O += P V (wgmma register-A form, whose fragment layout is the
// accumulator's), with V's [keys][D] tile read as an MN-major B
// operand (transposed-B bit; 8-key atoms at the stride byte offset,
// 64-column halves at the leading byte offset). The two consumers take
// turns issuing their products (ping-pong on two named barriers), so
// one's softmax runs under the other's wgmma. O / l is rounded once
// and stored from registers. Not kept (PERF.md, findings): softmax
// overlapped with the next Q K^T inside a warpgroup (ptxas serializes
// the wgmma at D=128 for want of registers) and persistent blocks.
//
// flash_fwd_kernel (`flash_fwd_bf16`; every other shape: head_dim any
// multiple of 8 up to 512, the single-query decode shape). One block
// of 4 warps per (64-row q tile, q head, batch row, 256-column slice
// of O); each warp owns 16 q rows. Up to head_dim 256 a block owns all
// of O's columns; above it (JAX's gate reaches 512) 64 rows x 512 f32
// of O do not fit four warps' registers, so two blocks split O's
// columns, each recomputing S over the full head_dim, and K/V are
// single-buffered (Q, K and a 256-column V slice: 163 KB of shared
// memory at head_dim 512, opted in past 48 KB). The TPU kernel carries its running max, sum and accumulator
// across sequential grid steps in VMEM scratch; here they live in
// registers for the whole walk over the K/V tiles (64 keys each, up to
// the causal diagonal of the q tile). Both products run on the tensor
// cores as mma.sync m16n8k16 (bf16 in, f32 accumulate), whose
// documented fragment layout lets the softmax work on the accumulators
// in place: each lane holds 2 rows x 2 columns of every 16x8 tile, a
// row's max and sum reduce over the 4 lanes of a quad, the rescale of
// O by exp(m_old - m_new) is a per-row register multiply, and S's
// accumulators repack straight into the A operand of P V (P rounded to
// bf16, as the TPU kernel feeds its MXU). K/V tiles are
// double-buffered in shared memory with cp.async, so the next tile's
// loads overlap this tile's math; V's B fragments come from
// ldmatrix.trans. Keys past S_k, q rows past S_q and head_dim columns
// past D are masked or zero-filled.
//
// Both read KV head h / n_rep (GQA; nothing is repeated in memory) and
// write LSE = m + log(l) (natural log) for the backward.

#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int BM = 64;       // q rows per block (16 per warp)
constexpr int BN = 64;       // keys per tile
constexpr int NWARPS = 4;
constexpr int NT = NWARPS * 32;

// columns [c0, c0 + dp) of rows [r0, r0 + BN) of a [*, seq, heads, d]
// tensor at `head` into a shared tile (leading dim ldh),
// asynchronously; rows past `seq` and columns past d are zero-filled
__device__ inline void load_tile_async(__nv_bfloat16* dst,
                                       const __nv_bfloat16* src, int r0,
                                       int seq, int heads, int head, int d,
                                       int dp, int ldh, int64_t batch_off,
                                       int c0 = 0) {
  const int vec = dp / 8;
  for (int idx = threadIdx.x; idx < BN * vec; idx += NT) {
    const int r = idx / vec;
    const int c = (idx % vec) * 8;
    const int row = r0 + r;
    const bool valid = row < seq && c0 + c < d;
    const __nv_bfloat16* p =
        valid ? src + ((batch_off + row) * heads + head) * (int64_t)d + c0 + c
              : src;
    cp_async16(dst + r * ldh + c, p, valid);
  }
}

// DMAX: largest padded head_dim this instantiation contracts over; OC:
// the most output columns a block holds in registers (O's columns are
// split over blockIdx.y % ceil(dp / OC)); STAGES: K/V buffers (2:
// the next tile loads during this one's math; 1: loaded after it)
template <int DMAX, int OC, int STAGES>
__global__ void __launch_bounds__(NT)
flash_fwd_kernel(const __nv_bfloat16* __restrict__ q,
                 const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v,
                 __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                 int sq, int sk, int h, int kvh, int d, float scale,
                 int causal) {
  constexpr int NT_O = OC / 8;      // 8-wide output column tiles
  extern __shared__ __align__(128) unsigned char smem[];
  const int dp = (d + 15) / 16 * 16;
  const int ldh = dp + 8;           // bf16 elements; breaks bank conflicts
  const int n_split = (dp + OC - 1) / OC;
  const int c0 = (blockIdx.y % n_split) * OC;   // this block's O columns
  const int dpv = min(dp - c0, OC);
  const int ldv = dpv + 8;
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* sK[2] = {sQ + BM * ldh, sQ + (BM + (STAGES - 1) * BN) * ldh};
  __nv_bfloat16* sV0 = sQ + (BM + STAGES * BN) * ldh;
  __nv_bfloat16* sV[2] = {sV0, sV0 + (STAGES - 1) * BN * ldv};

  const int q0 = blockIdx.x * BM;
  const int head = blockIdx.y / n_split;
  const int b = blockIdx.z;
  const int kv_head = head / (h / kvh);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;           // fragment row group
  const int t = lane % 4;           // fragment column pair
  const int64_t qoff = (int64_t)b * sq;
  const int64_t koff = (int64_t)b * sk;

  // Q tile (rows past sq / columns past d zero-filled) + K/V tile 0
  {
    const int vec = dp / 8;
    for (int idx = threadIdx.x; idx < BM * vec; idx += NT) {
      const int r = idx / vec, c = (idx % vec) * 8;
      const bool valid = q0 + r < sq && c < d;
      const __nv_bfloat16* p =
          valid ? q + ((qoff + q0 + r) * h + head) * (int64_t)d + c : q;
      cp_async16(sQ + r * ldh + c, p, valid);
    }
  }
  int n_tiles = (sk + BN - 1) / BN;
  if (causal) {
    const int last_row = min(q0 + BM, sq) - 1;
    n_tiles = min(n_tiles, last_row / BN + 1);
  }
  load_tile_async(sK[0], k, 0, sk, kvh, kv_head, d, dp, ldh, koff);
  load_tile_async(sV[0], v, 0, sk, kvh, kv_head, d, dpv, ldv, koff, c0);
  cp_async_commit();

  const int row0 = q0 + warp * 16 + g;   // this lane's rows: row0, row0+8
  float acc[NT_O][4];
#pragma unroll
  for (int n = 0; n < NT_O; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m_r[2] = {-INFINITY, -INFINITY};
  float l_r[2] = {0.f, 0.f};             // this lane's partial row sums
  const __nv_bfloat16* qw = sQ + (warp * 16) * ldh;

  for (int tile = 0; tile < n_tiles; ++tile) {
    const int st = STAGES == 2 ? tile & 1 : 0;
    if (STAGES == 2 && tile + 1 < n_tiles) {
      const int nxt = (tile + 1) & 1;
      load_tile_async(sK[nxt], k, (tile + 1) * BN, sk, kvh, kv_head, d, dp,
                      ldh, koff);
      load_tile_async(sV[nxt], v, (tile + 1) * BN, sk, kvh, kv_head, d, dpv,
                      ldv, koff, c0);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const __nv_bfloat16* kt = sK[st];
    const __nv_bfloat16* vt = sV[st];
    const int k0 = tile * BN;

    // S = Q K^T: 16 rows x 64 keys per warp = 8 n-tiles
    float s[BN / 8][4];
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DMAX / 16; ++kk) {
      if (kk < dp / 16) {
        uint32_t a[4];
        const __nv_bfloat16* qa = qw + kk * 16 + 2 * t;
        a[0] = *reinterpret_cast<const uint32_t*>(qa + g * ldh);
        a[1] = *reinterpret_cast<const uint32_t*>(qa + (g + 8) * ldh);
        a[2] = *reinterpret_cast<const uint32_t*>(qa + g * ldh + 8);
        a[3] = *reinterpret_cast<const uint32_t*>(qa + (g + 8) * ldh + 8);
#pragma unroll
        for (int j = 0; j < BN / 8; ++j) {
          uint32_t bf[2];
          const __nv_bfloat16* kb = kt + (j * 8 + g) * ldh + kk * 16 + 2 * t;
          bf[0] = *reinterpret_cast<const uint32_t*>(kb);
          bf[1] = *reinterpret_cast<const uint32_t*>(kb + 8);
          mma_bf16(s[j], a, bf);
        }
      }
    }

    // online softmax on the accumulators, in base 2 (scores scaled by
    // scale * log2(e), one FMUL, exponentials on the SFU): element e of
    // tile j is row row0 + 8*(e/2), key k0 + 8j + 2t + (e%2). Only the
    // ragged last tile and tiles crossing this warp's causal diagonal
    // need the mask (warp-uniform test).
    const float sl2 = scale * 1.4426950408889634f;
    const bool need_mask =
        k0 + BN > sk || (causal && k0 + BN - 1 > q0 + warp * 16);
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[j][e] * sl2;
        if (need_mask) {
          const int row = row0 + 8 * (e / 2);
          const int col = k0 + 8 * j + 2 * t + (e % 2);
          if (col >= sk || (causal && col > row)) x = -INFINITY;
        }
        s[j][e] = x;
        mx[e / 2] = fmaxf(mx[e / 2], x);
      }
    }
    float alpha[2], mb[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_new = fmaxf(m_r[i], mx[i]);
      // a row with nothing visible yet keeps a finite base: ex2(-inf) = 0
      mb[i] = (m_new == -INFINITY) ? 0.f : m_new;
      alpha[i] = ex2(m_r[i] - mb[i]);
      m_r[i] = m_new;
      l_r[i] *= alpha[i];
    }
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = ex2(s[j][e] - mb[e / 2]);
        s[j][e] = p;
        l_r[e / 2] += p;   // unrounded, as the TPU kernel sums
      }
    }
#pragma unroll
    for (int n = 0; n < NT_O; ++n) {
      acc[n][0] *= alpha[0];
      acc[n][1] *= alpha[0];
      acc[n][2] *= alpha[1];
      acc[n][3] *= alpha[1];
    }

    // O += P V: P's accumulators repack as A fragments (16 keys per step)
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      uint32_t a[4];
      a[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      a[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      a[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      a[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
      // ldmatrix.x4.trans: lanes 0-7 / 8-15 address keys +0..7 / +8..15
      // of d-tile n, lanes 16-31 the same for d-tile n+1
      // the next pair's fragments load before this pair's products
      const __nv_bfloat16* vrow =
          vt + (kk * 16 + (lane % 8) + 8 * ((lane / 8) % 2)) * ldv +
          (lane / 16) * 8;
      uint32_t bf[2][4];
      ldmatrix_x4_trans(bf[0], vrow);
#pragma unroll
      for (int n = 0; n < NT_O; n += 2) {
        if (n < dpv / 8) {
          const int cur = (n / 2) % 2;
          if (n + 2 < dpv / 8) ldmatrix_x4_trans(bf[cur ^ 1], vrow + (n + 2) * 8);
          mma_bf16(acc[n], a, bf[cur]);
          mma_bf16(acc[n + 1], a, bf[cur] + 2);
        }
      }
    }
    __syncthreads();  // this stage is refilled two tiles from now
    if (STAGES == 1 && tile + 1 < n_tiles) {   // (one: the next tile)
      load_tile_async(sK[0], k, (tile + 1) * BN, sk, kvh, kv_head, d, dp,
                      ldh, koff);
      load_tile_async(sV[0], v, (tile + 1) * BN, sk, kvh, kv_head, d, dpv,
                      ldv, koff, c0);
      cp_async_commit();
    }
  }

  // finalize: full row sums over the quad, O / l, LSE = m + log(l)
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l_r[i] += __shfl_xor_sync(0xffffffffu, l_r[i], 1);
    l_r[i] += __shfl_xor_sync(0xffffffffu, l_r[i], 2);
    if (l_r[i] == 0.f) l_r[i] = 1.f;    // fully masked row
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + 8 * i;
    if (row >= sq) continue;
    __nv_bfloat16* dst = o + ((qoff + row) * h + head) * (int64_t)d + c0;
#pragma unroll
    for (int n = 0; n < NT_O; ++n) {
      const int col = n * 8 + 2 * t;
      if (c0 + n * 8 < d) {
        const float inv = l_r[i];
        *reinterpret_cast<__nv_bfloat162*>(dst + col) = __floats2bfloat162_rn(
            acc[n][2 * i] / inv, acc[n][2 * i + 1] / inv);
      }
    }
    if (t == 0 && c0 == 0)   // m_r is in base 2
      lse[((int64_t)b * h + head) * sq + row] =
          m_r[i] * 0.6931471805599453f + logf(l_r[i]);
  }
}

template <int DMAX, int OC, int STAGES>
int launch(const void* q, const void* k, const void* v, void* o, void* lse,
           int b, int sq, int sk, int h, int kvh, int d, float scale,
           int causal, cudaStream_t stream) {
  const int dp = (d + 15) / 16 * 16;
  const int n_split = (dp + OC - 1) / OC;
  const int smem = ((BM + STAGES * BN) * (dp + 8) +
                    STAGES * BN * ((dp < OC ? dp : OC) + 8)) *
                   (int)sizeof(__nv_bfloat16);
  // raise the dynamic shared-memory cap once per size (not per launch:
  // the attribute call is host work, and launches may be graph-captured)
  static int configured = 0;
  if (smem > configured) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_kernel<DMAX, OC, STAGES>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    configured = smem;
  }
  dim3 grid((sq + BM - 1) / BM, h * n_split, b);
  flash_fwd_kernel<DMAX, OC, STAGES><<<grid, NT, smem, stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
      (const __nv_bfloat16*)v, (__nv_bfloat16*)o, (float*)lse, sq, sk, h,
      kvh, d, scale, causal);
  return (int)cudaGetLastError();
}

// ---- the Hopper-native variant: TMA, mbarrier ring, wgmma ------------

constexpr int WG_BM = 128;           // q rows a block, 64 a consumer
constexpr int WG_BN = 128;           // keys a K/V stage
constexpr int WG_STAGES = 2;
constexpr int WG_NT = 384;           // producer + 2 consumer warpgroups
constexpr int WG_HALF = WG_BN * 128; // bytes of 128 rows x 64 bf16 columns

// D = 64 or 128: NH = D / 64 halves of 64 columns in every tile
template <int D>
__global__ void __launch_bounds__(WG_NT, 1)
flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                       const __grid_constant__ CUtensorMap tm_k,
                       const __grid_constant__ CUtensorMap tm_v,
                       __nv_bfloat16* __restrict__ o,
                       float* __restrict__ lse, int s, int h, int kvh,
                       float scale, int causal) {
  constexpr int NH = D / 64;
  constexpr int TILE = NH * WG_HALF;          // bytes of a 128-row tile
  extern __shared__ unsigned char smem_raw[];
  // TMA's 128-byte swizzle and the descriptors need 1024-byte atoms
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~(uintptr_t)1023);
  unsigned char* sq = smem;                   // then K0, V0, K1, V1
  uint64_t* bars =
      reinterpret_cast<uint64_t*>(smem + TILE * (1 + 2 * WG_STAGES));
  uint64_t* full_q = bars;
  uint64_t* full_k = bars + 1;
  uint64_t* full_v = bars + 1 + WG_STAGES;
  uint64_t* empty = bars + 1 + 2 * WG_STAGES;

  const int q0 = ((int)gridDim.z - 1 - (int)blockIdx.z) * WG_BM;
  const int head = blockIdx.x;
  const int b = blockIdx.y;
  const int kv_head = head / (h / kvh);
  int n_tiles = (s + WG_BN - 1) / WG_BN;
  if (causal) n_tiles = min(n_tiles, (min(q0 + WG_BM, s) - 1) / WG_BN + 1);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    mbar_init(full_q, 1);
    for (int st = 0; st < WG_STAGES; ++st) {
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
      mbar_expect_tx(full_q, TILE);
      for (int hf = 0; hf < NH; ++hf)
        tma_load_4d(sq + hf * WG_HALF, &tm_q, full_q, 64 * hf, head, q0, b);
      for (int t = 0; t < n_tiles; ++t) {
        const int st = t % WG_STAGES;
        // stage st was last read by tile t - 2: its release is the
        // (t / 2 - 1)-th completion of empty[st]
        if (t >= WG_STAGES) mbar_wait(empty + st, (t / WG_STAGES - 1) & 1);
        unsigned char* sk = sq + TILE * (1 + 2 * st);
        unsigned char* sv = sk + TILE;
        mbar_expect_tx(full_k + st, TILE);
        for (int hf = 0; hf < NH; ++hf)
          tma_load_4d(sk + hf * WG_HALF, &tm_k, full_k + st, 64 * hf,
                      kv_head, t * WG_BN, b);
        mbar_expect_tx(full_v + st, TILE);
        for (int hf = 0; hf < NH; ++hf)
          tma_load_4d(sv + hf * WG_HALF, &tm_v, full_v + st, 64 * hf,
                      kv_head, t * WG_BN, b);
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
    const unsigned char* qa = sq + 64 * wgc * 128;
    const float sl2 = scale * 1.4426950408889634f;

    // accumulator i of an m64nN wgmma: n8 block j = i / 4, element
    // e = i % 4 at row row0 + 8 * (e / 2), column 8j + 2tq + e % 2
    float acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
    float m_r[2] = {-INFINITY, -INFINITY};
    float l_r[2] = {0.f, 0.f};              // this lane's partial sums

    // the consumers take turns issuing their products (named barriers 1
    // and 2), so one's softmax runs under the other's wgmma; warpgroup
    // 0 goes first
    if (wgc == 1) bar_arrive(1);
    mbar_wait(full_q, 0);
    for (int t = 0; t < n_tiles; ++t) {
      const int st = t % WG_STAGES;
      const int ph = (t / WG_STAGES) & 1;
      const unsigned char* sk = sq + TILE * (1 + 2 * st);
      const unsigned char* sv = sk + TILE;
      const int k0 = t * WG_BN;

      // S = Q K^T: 64 rows x 128 keys, D / 16 k-steps of 32 bytes
      float sc[64];
      mbar_wait(full_k + st, ph);
      bar_sync(1 + wgc);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks) {
        const int off = (ks / 4) * WG_HALF + 32 * (ks % 4);
        wgmma_ss_n128(sc, sw128_desc(qa + off, 16), sw128_desc(sk + off, 16),
                      ks > 0);
      }
      wgmma_commit();
      bar_arrive(2 - wgc);
      wgmma_wait<0>();
#pragma unroll
      for (int i = 0; i < 64; ++i) reg_fence(sc[i]);

      // online softmax in base 2; only the ragged last tile and tiles
      // crossing this warp's causal diagonal need the mask
      const bool need_mask =
          k0 + WG_BN > s || (causal && k0 + WG_BN - 1 > wrow);
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int i = 0; i < 64; ++i) {
        const int e = i % 4;
        float x = sc[i] * sl2;
        if (need_mask) {
          const int row = row0 + 8 * (e / 2);
          const int col = k0 + 8 * (i / 4) + 2 * tq + (e % 2);
          if (col >= s || (causal && col > row)) x = -INFINITY;
        }
        sc[i] = x;
        mx[e / 2] = fmaxf(mx[e / 2], x);
      }
      float alpha[2], mb[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float m_new = fmaxf(m_r[r], mx[r]);
        // a row with nothing visible yet keeps a finite base
        mb[r] = (m_new == -INFINITY) ? 0.f : m_new;
        alpha[r] = ex2(m_r[r] - mb[r]);
        m_r[r] = m_new;
        l_r[r] *= alpha[r];
      }
      // P rounded to bf16 as the A operand of P V: k-step kk covers
      // keys 16kk..16kk+15, n8 blocks 2kk and 2kk+1 of S
      uint32_t pa[32];
#pragma unroll
      for (int i = 0; i < 64; i += 2) {
        const int r = (i % 4) / 2;
        const float p0 = ex2(sc[i] - mb[r]);
        const float p1 = ex2(sc[i + 1] - mb[r]);
        l_r[r] += p0 + p1;                  // unrounded, as the TPU sums
        pa[i / 2] = pack_bf16(p0, p1);
      }
#pragma unroll
      for (int i = 0; i < D / 2; ++i) acc[i] *= alpha[(i % 4) / 2];

      // O += P V: V's [keys][D] tile as an MN-major B operand
      mbar_wait(full_v + st, ph);
#pragma unroll
      for (int i = 0; i < D / 2; ++i) reg_fence(acc[i]);
      bar_sync(1 + wgc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < WG_BN / 16; ++kk) {
        const uint64_t dv = sw128_desc(sv + kk * 16 * 128, WG_HALF);
        if constexpr (D == 128)
          wgmma_rs_n128(acc, pa + 4 * kk, dv);
        else
          wgmma_rs_n64(acc, pa + 4 * kk, dv);
      }
      wgmma_commit();
      bar_arrive(2 - wgc);
      wgmma_wait<0>();
#pragma unroll
      for (int i = 0; i < D / 2; ++i) reg_fence(acc[i]);
      if (lane == 0) mbar_arrive(empty + st);
    }

    // finalize: full row sums over the quad, O / l, LSE = m + log(l)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l_r[r] += __shfl_xor_sync(0xffffffffu, l_r[r], 1);
      l_r[r] += __shfl_xor_sync(0xffffffffu, l_r[r], 2);
      if (l_r[r] == 0.f) l_r[r] = 1.f;      // fully masked row
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 8 * r;
      if (row >= s) continue;
      __nv_bfloat16* dst = o + (((int64_t)b * s + row) * h + head) * D;
      const float inv = 1.f / l_r[r];
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<__nv_bfloat162*>(dst + 8 * j + 2 * tq) =
            __floats2bfloat162_rn(acc[4 * j + 2 * r] * inv,
                                  acc[4 * j + 2 * r + 1] * inv);
      if (tq == 0)   // m_r is in base 2
        lse[((int64_t)b * h + head) * s + row] =
            m_r[r] * 0.6931471805599453f + logf(l_r[r]);
    }
  }
}

template <int D>
int launch_wgmma(const void* q, const void* k, const void* v, void* o,
                 void* lse, int b, int s, int h, int kvh, float scale,
                 int causal, cudaStream_t stream) {
  // encoded on the host for each launch (a few microseconds) and passed
  // by value, so a captured CUDA graph holds its own copies
  CUtensorMap tm_q, tm_k, tm_v;
  if (!make_map(&tm_q, q, b, s, h, D, WG_BM) ||
      !make_map(&tm_k, k, b, s, kvh, D, WG_BN) ||
      !make_map(&tm_v, v, b, s, kvh, D, WG_BN))
    return (int)cudaErrorInvalidValue;
  constexpr int smem = (D / 64) * WG_HALF * (1 + 2 * WG_STAGES) +
                       8 * (1 + 3 * WG_STAGES) + 1024;
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_wgmma_kernel<D>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  const dim3 grid(h, b, (s + WG_BM - 1) / WG_BM);
  flash_fwd_wgmma_kernel<D><<<grid, WG_NT, smem, stream>>>(
      tm_q, tm_k, tm_v, (__nv_bfloat16*)o, (float*)lse, s, h, kvh, scale,
      causal);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int flash_fwd_bf16(const void* q, const void* k, const void* v,
                              void* o, void* lse, int b, int sq, int sk,
                              int h, int kvh, int d, float scale, int causal,
                              void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (d % 8 != 0 || d < 8 || d > 512) return (int)cudaErrorInvalidValue;
  if (d <= 128)
    return launch<128, 128, 2>(q, k, v, o, lse, b, sq, sk, h, kvh, d, scale,
                               causal, st);
  if (d <= 256)
    return launch<256, 256, 2>(q, k, v, o, lse, b, sq, sk, h, kvh, d, scale,
                               causal, st);
  return launch<512, 256, 1>(q, k, v, o, lse, b, sq, sk, h, kvh, d, scale,
                             causal, st);
}

// The Hopper-native variant: head_dim 64 or 128 and q_len == k_len;
// the same arguments as flash_fwd_bf16.
extern "C" int flash_fwd_wgmma_bf16(const void* q, const void* k,
                                    const void* v, void* o, void* lse,
                                    int b, int sq, int sk, int h, int kvh,
                                    int d, float scale, int causal,
                                    void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (sq != sk || sq < 1 || b < 1 || kvh < 1 || h % kvh != 0)
    return (int)cudaErrorInvalidValue;
  if (d == 64)
    return launch_wgmma<64>(q, k, v, o, lse, b, sq, h, kvh, scale, causal,
                            st);
  if (d == 128)
    return launch_wgmma<128>(q, k, v, o, lse, b, sq, h, kvh, scale, causal,
                             st);
  return (int)cudaErrorInvalidValue;
}
