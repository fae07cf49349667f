// Fused int8-weight dequant-matmul (W8A16) for Hopper (sm_90a).
//
// Replaces: dlrover_tpu/ops/quantization.py `_dqmm_kernel`, launched by
// `quantized_matmul_kernel` (the Pallas TPU kernel: a grid over 256-row
// output tiles, each instance holding all of K in VMEM, dequantizing
// its int8 tile with `_dq_weight` and running one MXU dot with f32
// accumulation).
//
// Function: y[t, o] = bf16( sum_k x[t, k] * bf16(f32(q8[o, k]) *
// s8[o, k / block]) ), x [T, K] bf16, q8 [O, K] int8 (output-major),
// s8 [O, K / block] f32, sums in f32, one rounding of the output. The
// dequantized weight is rounded to bf16 (round to nearest even) before
// the product, as the JAX body casts it to x's dtype.
//
// What bounds it on this card: at decode (T = 8, one row per slot) the
// bytes of the weight, O*K int8 plus 4*O*K/block of scales, against
// 3.35 TB/s: every projection of a decode step reads its weight once
// and does 16 FLOPs per weight byte. At prefill (T = 16..1024 tokens)
// the 2*T*K*O operations against 989 TFLOP/s of bf16 tensor cores.
//
// Decode design. The product runs on the tensor cores as mma.sync
// m16n8k16 (bf16 in, f32 accumulate), with the activations as the A
// operand (16 tokens) and the weight as B (8 output rows). K is walked
// in 64-wide chunks, and inside a chunk the 64 contraction indices are
// permuted (the sum does not care about their order, as long as A and
// B agree): lane (g = lane / 4, t = lane % 4) owns the 16 consecutive
// values k = 16t .. 16t + 15 of its rows, and mma k-step j takes values
// 16t + 4j .. 16t + 4j + 3 as the fragment's (2t, 2t + 1, 2t + 8,
// 2t + 9). So
// each lane reads its weight row straight from device memory into
// registers with ONE 16-byte load per output row and chunk (8 rows x
// 64 contiguous bytes per warp load: whole 32-byte sectors), converts
// the 16 int8 with the row's scale into 8 bf16 pairs (`dequant16`: the
// int8 to f32 step is a byte permute and a subtraction, not an I2F,
// which runs at 16 a clock an SM), and feeds them to four mma k-steps;
// the weight never passes through shared memory and each byte is read
// once. Activation rows in shared memory are padded by 16 bytes, so
// the lanes' 16-byte reads hit all 32 banks once.
//
// Decode (T <= 16): `dqmm_decode_kernel`, one 16-token m-tile and 16
// outputs a warp (64 a block). The block stages its activation slab (8
// or 16 token rows by at most 1024 K values) in shared memory once;
// then each warp issues the weight loads of two chunks before it uses
// either, with no further barrier. The K range of a block is split
// (blockIdx.z) into 256 to 1024 values so the grid holds ~8 blocks an
// SM (wk and wv alone give 16 blocks): each split writes f32 partials
// and a second kernel sums them in split order and rounds once. Also
// tried on the card, and slower: the prefill kernel's shape (a tile
// per chunk behind a block barrier), register rings 1 to 8 chunks deep
// with activations from L1, and weights staged through shared memory
// with cp.async.
//
// Prefill (T > 16): `dqmm_wgmma_kernel`, on Hopper's warpgroup MMA.
// A block of 1 (T < 256) or 2 warpgroups computes 128 or 256 tokens x
// 128 outputs; each warpgroup holds two m64n128 f32 accumulators. Per
// 64-wide chunk the activation tile arrives by cp.async and the int8
// weight tile is read into registers (the decode lane pattern),
// dequantized as above and stored as bf16, once for all the block's
// tokens; both tiles are K-major with 128-byte rows under the 128-byte
// swizzle that the wgmma descriptors name, double-buffered, so chunk
// c's 8 wgmma a warpgroup run asynchronously while the block
// dequantizes chunk c + 1 and loads the weights of chunk c + 2. The 256-token block halves the dequant work
// per product and wins from T = 256 up; below, its idle rows cost
// more. An mma.sync version of the prefill kernel (128 x 128 blocks)
// ran 1.0-1.4x slower at every prefill shape, and staging its weights
// through a cp.async ring slower still (chip_smoke.py and PERF.md, on
// an H100 80GB HBM3 at a 700 W power limit). Not yet: TMA, a
// producer warp, a persistent schedule.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NWARPS = 4;
constexpr int NT = NWARPS * 32;
constexpr int KC = 64;          // contraction values per chunk

__device__ inline uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ inline void mma_bf16(float* c, const uint32_t* a,
                                const uint32_t* b) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
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

// int8 byte `sel` (0..3) of a word whose sign bits were flipped (so
// the byte is q + 128), as the exact f32 q: the byte becomes the low
// mantissa of 2^23 (f32 bits 0x4B0000uu = 2^23 + u, one byte permute)
// and 2^23 + 128 is subtracted (exact). This keeps the conversion
// off the SM's 16-per-clock conversion unit, which an I2F per weight
// saturates before the memory does.
__device__ inline float q8_to_f32(uint32_t flipped, int sel) {
  return __uint_as_float(__byte_perm(flipped, 0x4B000000u, 0x7540 + sel)) -
         8388736.0f;
}

// 16 int8 weights (one lane's share of a row's chunk) times their
// scale, rounded to bf16, as 8 packed pairs: pair 2j / 2j + 1 are the
// B fragment (b0, b1) of k-step j. The f32 product q * s and its
// rounding to nearest even are the plain version's, bit for bit.
__device__ inline void dequant16(uint4 raw, float s, uint32_t* out) {
  const uint32_t w[4] = {raw.x ^ 0x80808080u, raw.y ^ 0x80808080u,
                         raw.z ^ 0x80808080u, raw.w ^ 0x80808080u};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float f0 = q8_to_f32(w[j], 0) * s;
    const float f1 = q8_to_f32(w[j], 1) * s;
    const float f2 = q8_to_f32(w[j], 2) * s;
    const float f3 = q8_to_f32(w[j], 3) * s;
    out[2 * j] = pack_bf16(f0, f1);
    out[2 * j + 1] = pack_bf16(f2, f3);
  }
}

// one accumulator pair: outputs o, o + 1 of token `tok`, as bf16 into
// y, or as f32 into this split's partials when the K walk is split
__device__ inline void store_pair(float v0, float v1, int tok, int o, int T,
                                  int O, __nv_bfloat16* y, float* part,
                                  int split) {
  if (tok >= T || o >= O) return;
  const bool pair = o + 1 < O && (O % 2 == 0);
  if (part != nullptr) {
    float* dst = part + ((int64_t)split * T + tok) * O + o;
    if (pair) {
      *reinterpret_cast<float2*>(dst) = make_float2(v0, v1);
    } else {
      dst[0] = v0;
      if (o + 1 < O) dst[1] = v1;
    }
  } else {
    __nv_bfloat16* dst = y + (int64_t)tok * O + o;
    if (pair) {
      *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(v0, v1);
    } else {
      dst[0] = __float2bfloat16_rn(v0);
      if (o + 1 < O) dst[1] = __float2bfloat16_rn(v1);
    }
  }
}

// Decode variant (T <= 16): one 16-token m-tile. The block first
// copies its activation slab, token rows [0, 8) (or [0, 16) when HI)
// by its split's K range (at most DEC_MAX_CHUNKS chunks), into shared
// memory with cp.async, once; then there is no block barrier. Each
// warp owns NO n-tiles (8 * NO outputs) and walks its split in batches
// of UNR chunks: the batch's weight loads (UNR * NO 16-byte loads a
// lane) are all issued before any of them is used, then each chunk
// dequantizes and multiplies with A fragments read from the slab.
template <int NO, int UNR, bool HI>
__global__ void __launch_bounds__(NT)
dqmm_decode_kernel(const __nv_bfloat16* __restrict__ x,
                   const int8_t* __restrict__ q8,
                   const float* __restrict__ s8,
                   __nv_bfloat16* __restrict__ y, float* __restrict__ part,
                   int T, int K, int O, int block, int chunks_per_split) {
  constexpr int XR = HI ? 16 : 8;
  extern __shared__ __align__(16) __nv_bfloat16 xs[];  // [XR][xp]
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int o_w = (blockIdx.y * NWARPS + warp) * 8 * NO;
  const int c_begin = blockIdx.z * chunks_per_split;
  const int c_end = min(K / KC, c_begin + chunks_per_split);
  // slab rows padded by 16 bytes: the lanes' 16-byte reads of rows g
  // (32 bytes apart within a row) hit all 32 banks once
  const int xp = chunks_per_split * KC + 8;
  const int k0 = c_begin * KC;
  const int klen = (c_end - c_begin) * KC;
  for (int idx = threadIdx.x; idx < XR * (klen / 8); idx += NT) {
    const int r = idx / (klen / 8);
    const int col = (idx % (klen / 8)) * 8;
    const bool valid = r < T;
    cp_async16(xs + r * xp + col, valid ? x + (int64_t)r * K + k0 + col : x,
               valid);
  }
  cp_async_commit();
  const int nblk = K / block;

  float acc[NO][4];
#pragma unroll
  for (int r = 0; r < NO; ++r)
    acc[r][0] = acc[r][1] = acc[r][2] = acc[r][3] = 0.f;

  for (int c = c_begin; c < c_end; c += UNR) {
    uint4 wv[UNR][NO];
    float sc[UNR][NO];
#pragma unroll
    for (int u = 0; u < UNR; ++u) {
#pragma unroll
      for (int r = 0; r < NO; ++r) {
        const int o = o_w + 8 * r + g;
        const int k = (c + u) * KC + 16 * t;
        const bool ok = c + u < c_end && o < O;
        wv[u][r] = ok ? __ldg(reinterpret_cast<const uint4*>(
                            q8 + (int64_t)o * K + k))
                      : make_uint4(0u, 0u, 0u, 0u);
        sc[u][r] = ok ? __ldg(s8 + (int64_t)o * nblk + k / block) : 0.f;
      }
    }
    if (c == c_begin) {
      cp_async_wait<0>();
      __syncthreads();
    }
#pragma unroll
    for (int u = 0; u < UNR; ++u) {
      if (c + u >= c_end) break;
      const __nv_bfloat16* xr = xs + g * xp + (c + u - c_begin) * KC + 16 * t;
      const uint4 l0 = *reinterpret_cast<const uint4*>(xr);
      const uint4 l1 = *reinterpret_cast<const uint4*>(xr + 8);
      const uint32_t rg[8] = {l0.x, l0.y, l0.z, l0.w, l1.x, l1.y, l1.z, l1.w};
      uint32_t rh[8] = {0u, 0u, 0u, 0u, 0u, 0u, 0u, 0u};
      if (HI) {
        const uint4 h0 = *reinterpret_cast<const uint4*>(xr + 8 * xp);
        const uint4 h1 = *reinterpret_cast<const uint4*>(xr + 8 * xp + 8);
        rh[0] = h0.x; rh[1] = h0.y; rh[2] = h0.z; rh[3] = h0.w;
        rh[4] = h1.x; rh[5] = h1.y; rh[6] = h1.z; rh[7] = h1.w;
      }
      uint32_t bw[NO][8];
#pragma unroll
      for (int r = 0; r < NO; ++r) dequant16(wv[u][r], sc[u][r], bw[r]);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const uint32_t a[4] = {rg[2 * j], rh[2 * j], rg[2 * j + 1],
                               rh[2 * j + 1]};
#pragma unroll
        for (int r = 0; r < NO; ++r) mma_bf16(acc[r], a, &bw[r][2 * j]);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < NO; ++r) {
    const int o = o_w + 8 * r + 2 * t;
    store_pair(acc[r][0], acc[r][1], g, o, T, O, y, part, blockIdx.z);
    store_pair(acc[r][2], acc[r][3], g + 8, o, T, O, y, part, blockIdx.z);
  }
}

// ---- prefill on wgmma ------------------------------------------------

__device__ inline void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ inline void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ inline void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// make this thread's generic-proxy shared-memory writes (st.shared,
// cp.async) visible to the async proxy that wgmma reads through
__device__ inline void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// descriptor of a K-major tile with 128-byte rows, 128-byte swizzle
// (8-row atoms of 1024 bytes): start >> 4, LBO unused (1), SBO = 1024
// bytes >> 4, layout type 1 (B128) in bits 62-63
__device__ inline uint64_t sw128_desc(const void* smem_ptr) {
  const uint32_t addr = (uint32_t)__cvta_generic_to_shared(smem_ptr);
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

// D[64 x 128] f32 += A[64 x 16] (bf16, smem) . B[16 x 128] (bf16, smem)
__device__ inline void wgmma_m64n128k16(float* d, uint64_t da, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

// byte offset of 16-byte group `kg` (0..7) of row `r` in a 128-byte-row
// tile under the 128-byte swizzle: group index XOR (row % 8)
__device__ inline int sw128(int r, int kg) {
  return r * 128 + ((kg ^ (r & 7)) << 4);
}

// Prefill variant on wgmma: one warpgroup a block, 128 tokens x 128
// outputs (two m64n128 accumulators, 128 f32 registers a thread). Per
// 64-wide chunk the activation tile [128, 64] bf16 arrives by cp.async
// and the weight tile [128, 64] int8 is read into registers (lane
// pattern of the decode kernel: 8 rows x 64 contiguous bytes a warp
// load), dequantized exactly as elsewhere and stored as bf16; both
// tiles are K-major with 128-byte rows, 128-byte swizzled, double
// buffered. The 8 wgmma (2 m-halves x 4 k-steps) of chunk c run
// asynchronously while the block loads and dequantizes chunk c + 1.
template <int WG>
__global__ void __launch_bounds__(128 * WG)
dqmm_wgmma_kernel(const __nv_bfloat16* __restrict__ x,
                  const int8_t* __restrict__ q8,
                  const float* __restrict__ s8,
                  __nv_bfloat16* __restrict__ y, float* __restrict__ part,
                  int T, int K, int O, int block, int chunks_per_split) {
  constexpr int NTH = 128 * WG;              // threads
  constexpr int BT = 128 * WG, BO = 128;     // tokens, outputs a block
  constexpr int X_TILE = BT * 128, W_TILE = BO * 128;   // bytes
  constexpr int P = 4 / WG;                  // weight rows-of-8 a warp
  extern __shared__ unsigned char smem_raw[];
  // swizzle atoms need 1024-byte alignment
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~(uintptr_t)1023);
  unsigned char* xs[2] = {smem, smem + X_TILE};
  unsigned char* ws[2] = {smem + 2 * X_TILE, smem + 2 * X_TILE + W_TILE};

  const int warp = threadIdx.x / 32;
  const int wg = warp / 4;                   // this warp's warpgroup
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int t0 = blockIdx.x * BT;
  const int o0 = blockIdx.y * BO;
  const int c_begin = blockIdx.z * chunks_per_split;
  const int c_end = min(K / KC, c_begin + chunks_per_split);
  const int nblk = K / block;

  auto load_x = [&](int stage, int c) {
    const int k0 = c * KC;
    for (int idx = threadIdx.x; idx < BT * 8; idx += NTH) {
      const int r = idx / 8;
      const int kg = idx % 8;
      const bool valid = t0 + r < T;
      cp_async16(xs[stage] + sw128(r, kg),
                 valid ? x + (int64_t)(t0 + r) * K + k0 + kg * 8 : x, valid);
    }
    cp_async_commit();
  };
  // this lane's weight rows: warp * 8P + g + 8p, bytes 16t .. 16t + 15
  uint4 wv[P];
  float wsc[P];
  auto load_w = [&](int c) {
    const int k = c * KC + 16 * t;
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const int o = o0 + warp * 8 * P + g + 8 * p;
      const bool ok = o < O;
      wv[p] = ok ? __ldg(reinterpret_cast<const uint4*>(
                       q8 + (int64_t)o * K + k))
                 : make_uint4(0u, 0u, 0u, 0u);
      wsc[p] = ok ? __ldg(s8 + (int64_t)o * nblk + k / block) : 0.f;
    }
  };
  auto store_w = [&](int stage) {
#pragma unroll
    for (int p = 0; p < P; ++p) {
      uint32_t bw[8];
      dequant16(wv[p], wsc[p], bw);
      const int r = warp * 8 * P + g + 8 * p;
      *reinterpret_cast<uint4*>(ws[stage] + sw128(r, 2 * t)) =
          make_uint4(bw[0], bw[1], bw[2], bw[3]);
      *reinterpret_cast<uint4*>(ws[stage] + sw128(r, 2 * t + 1)) =
          make_uint4(bw[4], bw[5], bw[6], bw[7]);
    }
  };

  float acc[2][64];
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[h][i] = 0.f;

  // the weight registers run one chunk ahead of the shared-memory
  // tiles: chunk c + 2 loads while chunk c multiplies, so its device-
  // memory latency hides behind a whole chunk, not behind the dequant
  if (c_begin < c_end) {
    load_x(0, c_begin);
    load_w(c_begin);
    store_w(0);
    if (c_begin + 1 < c_end) load_w(c_begin + 1);
  }
  for (int c = c_begin; c < c_end; ++c) {
    const int st = (c - c_begin) & 1;
    cp_async_wait<0>();
    fence_proxy_async();
    __syncthreads();  // both tiles of chunk c are in shared memory
    wgmma_fence();
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        // k-step ks: 32 bytes further along the swizzled rows
        wgmma_m64n128k16(
            acc[h], sw128_desc(xs[st] + (128 * wg + 64 * h) * 128 + 32 * ks),
            sw128_desc(ws[st] + 32 * ks));
      }
    }
    wgmma_commit();
    if (c + 1 < c_end) {   // the other stage was last read by chunk c-1
      load_x(st ^ 1, c + 1);
      store_w(st ^ 1);       // chunk c + 1, loaded one iteration ago
      if (c + 2 < c_end) load_w(c + 2);
    }
    wgmma_wait_all();
    __syncthreads();  // nobody refills stage st before all its reads end
  }

  // accumulator i of half h: n8 block j = i / 4, element e = i % 4:
  // token row 64h + 16 * warp + g + 8 * (e / 2), output 8j + 2t + e % 2
#pragma unroll
  for (int h = 0; h < 2; ++h) {
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int tok = t0 + 128 * wg + 64 * h + 16 * (warp % 4) + g;
      const int o = o0 + 8 * j + 2 * t;
      store_pair(acc[h][4 * j], acc[h][4 * j + 1], tok, o, T, O, y, part,
                 blockIdx.z);
      store_pair(acc[h][4 * j + 2], acc[h][4 * j + 3], tok + 8, o, T, O, y,
                 part, blockIdx.z);
    }
  }
}

// y = bf16(sum over splits of part[split]), summed in split order
__global__ void __launch_bounds__(256)
dqmm_combine_kernel(const float* __restrict__ part,
                    __nv_bfloat16* __restrict__ y, int64_t n, int splits) {
  for (int64_t i = (int64_t)blockIdx.x * 256 + threadIdx.x; i < n;
       i += (int64_t)gridDim.x * 256) {
    float sum = 0.f;
    for (int z = 0; z < splits; ++z) sum += part[(int64_t)z * n + i];
    y[i] = __float2bfloat16_rn(sum);
  }
}

constexpr int DEC_NO = 2;            // decode: 8 * 2 outputs per warp
constexpr int DEC_UNR = 2;           // decode: chunks per load batch
constexpr int DEC_MAX_CHUNKS = 16;   // decode: K range of one block

// one- or two-warpgroup prefill kernel: 128 * WG tokens x 128 outputs
template <int WG>
int launch_wgmma(const __nv_bfloat16* x, const int8_t* q8, const float* s8,
                 __nv_bfloat16* y, float* part, int T, int K, int O,
                 int block, int splits, int chunks_per_split,
                 cudaStream_t stream) {
  constexpr int smem = 2 * (128 * WG + 128) * 128 + 1024;
  // raise the dynamic shared-memory cap once (not per launch: the
  // attribute call is host work, and launches may be graph-captured)
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        dqmm_wgmma_kernel<WG>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  const dim3 grid((T + 128 * WG - 1) / (128 * WG), (O + 127) / 128, splits);
  dqmm_wgmma_kernel<WG><<<grid, 128 * WG, smem, stream>>>(
      x, q8, s8, y, part, T, K, O, block, chunks_per_split);
  return 0;
}

// variant 0: the decode kernel (T <= 16); 1: the one-warpgroup prefill
// kernel; 2: the two-warpgroup prefill kernel
int launch(int variant, const void* x, const void* q8, const void* s8,
           void* y, void* part, int T, int K, int O, int block, int splits,
           int chunks_per_split, cudaStream_t stream) {
  const __nv_bfloat16* xp = (const __nv_bfloat16*)x;
  const int8_t* qp = (const int8_t*)q8;
  const float* sp = (const float*)s8;
  __nv_bfloat16* yp = (__nv_bfloat16*)y;
  float* pp = splits > 1 ? (float*)part : nullptr;
  int err = 0;
  if (variant == 0) {
    constexpr int BO = NWARPS * 8 * DEC_NO;
    const dim3 grid(1, (O + BO - 1) / BO, splits);
    const int rows = T > 8 ? 16 : 8;
    const int smem = rows * (chunks_per_split * KC + 8) * 2;  // <= 33 KB
    if (T > 8)
      dqmm_decode_kernel<DEC_NO, DEC_UNR, true><<<grid, NT, smem, stream>>>(
          xp, qp, sp, yp, pp, T, K, O, block, chunks_per_split);
    else
      dqmm_decode_kernel<DEC_NO, DEC_UNR, false><<<grid, NT, smem, stream>>>(
          xp, qp, sp, yp, pp, T, K, O, block, chunks_per_split);
  } else if (variant == 1) {
    err = launch_wgmma<1>(xp, qp, sp, yp, pp, T, K, O, block, splits,
                          chunks_per_split, stream);
  } else {
    err = launch_wgmma<2>(xp, qp, sp, yp, pp, T, K, O, block, splits,
                          chunks_per_split, stream);
  }
  if (err != 0) return err;
  cudaError_t cerr = cudaGetLastError();
  if (cerr != cudaSuccess || splits == 1) return (int)cerr;
  const int64_t n = (int64_t)T * O;
  const int blocks = (int)((n + 255) / 256 < 4096 ? (n + 255) / 256 : 4096);
  dqmm_combine_kernel<<<blocks, 256, 0, stream>>>(
      (const float*)part, (__nv_bfloat16*)y, n, splits);
  return (int)cudaGetLastError();
}

}  // namespace

// x [T, K] bf16, q8 [O, K] int8, s8 [O, K / block] f32, y [T, O] bf16,
// all contiguous and 16-byte aligned; part [splits, T, O] f32 scratch
// when splits > 1. variant 0: T <= 16 tiles, 1: 64-token tiles. The
// wrapper (ops/quantization.py) checks shapes and picks variant and
// split; this refuses what would read out of bounds.
extern "C" int dqmm_bf16(const void* x, const void* q8, const void* s8,
                         void* y, void* part, int T, int K, int O,
                         int block, int variant, int splits,
                         int chunks_per_split, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (T < 1 || O < 1 || K < KC || K % KC != 0 || block < 16 ||
      (block & (block - 1)) != 0 || K % block != 0 || splits < 1 ||
      chunks_per_split < 1 ||
      (long long)splits * chunks_per_split < K / KC ||
      (splits > 1 && part == nullptr))
    return (int)cudaErrorInvalidValue;
  if ((variant == 0 && (T > 16 || chunks_per_split > DEC_MAX_CHUNKS)) ||
      variant < 0 || variant > 2)
    return (int)cudaErrorInvalidValue;
  return launch(variant, x, q8, s8, y, part, T, K, O, block, splits,
                chunks_per_split, st);
}
