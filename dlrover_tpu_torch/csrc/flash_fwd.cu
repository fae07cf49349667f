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
// Design: one block of 4 warps per (64-row q tile, q head, batch row);
// each warp owns 16 q rows. The TPU kernel carries its running max,
// sum and accumulator across sequential grid steps in VMEM scratch;
// here they live in registers for the whole walk over the K/V tiles
// (64 keys each, up to the causal diagonal of the q tile). Both
// products run on the tensor cores as mma.sync m16n8k16 (bf16 in, f32
// accumulate), whose documented fragment layout lets the softmax work
// on the accumulators in place: each lane holds 2 rows x 2 columns of
// every 16x8 tile, a row's max and sum reduce over the 4 lanes of a
// quad, the rescale of O by exp(m_old - m_new) is a per-row register
// multiply, and S's accumulators repack straight into the A operand of
// P V (P rounded to bf16, as the TPU kernel feeds its MXU). K/V tiles
// are double-buffered in shared memory with cp.async, so the next
// tile's loads overlap this tile's math; V's B fragments come from
// ldmatrix.trans. GQA reads KV head h / n_rep; nothing is repeated in
// memory. Keys past S_k, q rows past S_q and head_dim columns past D
// are masked or zero-filled, so any length and any D multiple of 8
// up to 256 runs. Not yet: wgmma, TMA, warp specialisation.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;       // q rows per block (16 per warp)
constexpr int BN = 64;       // keys per tile
constexpr int NWARPS = 4;
constexpr int NT = NWARPS * 32;

__device__ inline uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ inline void mma_bf16(float* c, const uint32_t* a,
                                const uint32_t* b) {
  // not volatile: a pure register op the compiler may schedule freely
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// 2^x on the special-function unit (2 ulp; ex2(-inf) = 0)
__device__ inline float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ inline void ldmatrix_x4_trans(uint32_t* r, const void* smem) {
  uint32_t addr = (uint32_t)__cvta_generic_to_shared(smem);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ inline void cp_async16(void* smem, const void* gmem, bool valid) {
  uint32_t addr = (uint32_t)__cvta_generic_to_shared(smem);
  int src_size = valid ? 16 : 0;  // 0: zero-fill, nothing read
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(addr), "l"(gmem), "r"(src_size));
}

__device__ inline void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ inline void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

// rows [r0, r0 + BN) of a [*, seq, heads, d] tensor at `head` into a
// shared tile (leading dim ldh), asynchronously; rows past `seq` and
// columns past d are zero-filled
__device__ inline void load_tile_async(__nv_bfloat16* dst,
                                       const __nv_bfloat16* src, int r0,
                                       int seq, int heads, int head, int d,
                                       int dp, int ldh, int64_t batch_off) {
  const int vec = dp / 8;
  for (int idx = threadIdx.x; idx < BN * vec; idx += NT) {
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

// DMAX: largest padded head_dim this instantiation holds in registers
template <int DMAX>
__global__ void __launch_bounds__(NT)
flash_fwd_kernel(const __nv_bfloat16* __restrict__ q,
                 const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v,
                 __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                 int sq, int sk, int h, int kvh, int d, float scale,
                 int causal) {
  constexpr int NT_O = DMAX / 8;    // 8-wide output column tiles
  extern __shared__ __align__(128) unsigned char smem[];
  const int dp = (d + 15) / 16 * 16;
  const int ldh = dp + 8;           // bf16 elements; breaks bank conflicts
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* sK[2] = {sQ + BM * ldh, sQ + (BM + BN) * ldh};
  __nv_bfloat16* sV[2] = {sQ + (BM + 2 * BN) * ldh,
                          sQ + (BM + 3 * BN) * ldh};

  const int q0 = blockIdx.x * BM;
  const int head = blockIdx.y;
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
  load_tile_async(sV[0], v, 0, sk, kvh, kv_head, d, dp, ldh, koff);
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
    const int st = tile & 1;
    if (tile + 1 < n_tiles) {
      const int nxt = (tile + 1) & 1;
      load_tile_async(sK[nxt], k, (tile + 1) * BN, sk, kvh, kv_head, d, dp,
                      ldh, koff);
      load_tile_async(sV[nxt], v, (tile + 1) * BN, sk, kvh, kv_head, d, dp,
                      ldh, koff);
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
          vt + (kk * 16 + (lane % 8) + 8 * ((lane / 8) % 2)) * ldh +
          (lane / 16) * 8;
      uint32_t bf[2][4];
      ldmatrix_x4_trans(bf[0], vrow);
#pragma unroll
      for (int n = 0; n < NT_O; n += 2) {
        if (n < dp / 8) {
          const int cur = (n / 2) % 2;
          if (n + 2 < dp / 8) ldmatrix_x4_trans(bf[cur ^ 1], vrow + (n + 2) * 8);
          mma_bf16(acc[n], a, bf[cur]);
          mma_bf16(acc[n + 1], a, bf[cur] + 2);
        }
      }
    }
    __syncthreads();  // this stage is refilled two tiles from now
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
    __nv_bfloat16* dst = o + ((qoff + row) * h + head) * (int64_t)d;
#pragma unroll
    for (int n = 0; n < NT_O; ++n) {
      const int col = n * 8 + 2 * t;
      if (n * 8 < d) {
        const float inv = l_r[i];
        *reinterpret_cast<__nv_bfloat162*>(dst + col) = __floats2bfloat162_rn(
            acc[n][2 * i] / inv, acc[n][2 * i + 1] / inv);
      }
    }
    if (t == 0)   // m_r is in base 2
      lse[((int64_t)b * h + head) * sq + row] =
          m_r[i] * 0.6931471805599453f + logf(l_r[i]);
  }
}

template <int DMAX>
int launch(const void* q, const void* k, const void* v, void* o, void* lse,
           int b, int sq, int sk, int h, int kvh, int d, float scale,
           int causal, cudaStream_t stream) {
  const int dp = (d + 15) / 16 * 16;
  const int smem = (BM + 4 * BN) * (dp + 8) * (int)sizeof(__nv_bfloat16);
  // raise the dynamic shared-memory cap once per size (not per launch:
  // the attribute call is host work, and launches may be graph-captured)
  static int configured = 0;
  if (smem > configured) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_kernel<DMAX>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return (int)err;
    configured = smem;
  }
  dim3 grid((sq + BM - 1) / BM, h, b);
  flash_fwd_kernel<DMAX><<<grid, NT, smem, stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
      (const __nv_bfloat16*)v, (__nv_bfloat16*)o, (float*)lse, sq, sk, h,
      kvh, d, scale, causal);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int flash_fwd_bf16(const void* q, const void* k, const void* v,
                              void* o, void* lse, int b, int sq, int sk,
                              int h, int kvh, int d, float scale, int causal,
                              void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (d % 8 != 0 || d < 8 || d > 256) return (int)cudaErrorInvalidValue;
  if (d <= 128)
    return launch<128>(q, k, v, o, lse, b, sq, sk, h, kvh, d, scale, causal,
                       st);
  return launch<256>(q, k, v, o, lse, b, sq, sk, h, kvh, d, scale, causal,
                     st);
}
