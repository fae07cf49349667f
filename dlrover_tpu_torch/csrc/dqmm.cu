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
// and does 16 FLOPs per weight byte. The dequantize arithmetic (a byte
// permute, a subtraction, a product and half a pack: 3.5 instructions a
// weight byte) is what keeps the decode kernels below it. At prefill
// (T = 17..2048 tokens) the 2*T*K*O operations against 989 TFLOP/s of
// bf16 tensor cores.
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
// Decode (T <= 16) at blocks of 64 or more (every decode product of the
// engine): `dqmm_dec_tma_kernel`, one launch. What held the kernel below
// back (it stays for blocks 16 and 32): a second launch for every
// product (its K splits write f32 partials that `dqmm_combine_kernel`
// sums: 16 MB written and read again for the lm_head), short-lived
// blocks with two chunks of loads in flight a warp behind a cp.async
// slab prologue, and a partial second wave (w_gate: 1120 blocks). The
// design answers each:
//  - at most two blocks an SM, each an even share of the sequence of
//    (64-output tile, 256-value K range) stages (`share_start`), or,
//    where the tiles fill fewer than two an SM, the tiles times the K
//    splits that fit (so a tile's pieces are equal and end together:
//    one block a tile for w_gate and w_up, four for wq, wo and w_down,
//    eight for wk and wv): every block streams the same bytes, no
//    second wave;
//  - one thread keeps 4 stages in flight by TMA (the tensor maps
//    prefetched at the block's start; the int8 tile [64,
//    256], the prefill kernel's scale quad box [64, 4 blocks] from
//    `_s8q`, and the activation tile [8 or 16 rows, 256] from L2): the
//    bytes in flight cost no registers or instructions, which is where
//    the first decode kernel's register rings and cp.async staging lost;
//  - 8 consumer warps of 8 outputs each dequantize with `dequant16`
//    and multiply on mma.sync in two accumulator chains;
//  - a tile cut by a share's edge writes an f32 partial to its share's
//    slot and one thread adds one to the tile's counter (a gpu-scope
//    acq_rel fence around it); the block that finds itself last at the
//    end of its share sums the pieces in block order and rounds once,
//    and resets the counter: the same bits every run, no second launch.
// Tried on the card and dropped (variants side by side in one call
// each; PERF.md has the rankings): 64-bit share arithmetic (a
// software division: a few dozen in an epilogue cost more than the
// small products' whole stream), `__threadfence()` in every thread and
// waiting on the counter's atomic mid-stream (the consumers stalled at
// every cut tile), even shares where the tiles fill fewer than two
// blocks an SM (cut tiles whose pieces end far apart), a thread-block
// cluster of 4 or 8 blocks along K a tile with its pieces summed in
// rank 0's shared memory over DSMEM after two cluster barriers (slower
// at every split shape, w_down by more than a quarter), three blocks an
// SM with 3 stages, and grids of 4 or 8 blocks an SM (more pieces to
// sum; slower every time).
//
// Decode (T <= 16) at blocks 16 and 32: `dqmm_decode_kernel`, one
// 16-token m-tile and 16 outputs a warp (64 a block). The block stages
// its activation slab (8 or 16 token rows by at most 1024 K values) in
// shared memory once;
// then each warp issues the weight loads of two chunks before it uses
// either, with no further barrier. The K range of a block is split
// (blockIdx.z) into 256 to 1024 values so the grid holds ~8 blocks an
// SM (wk and wv alone give 16 blocks): each split writes f32 partials
// and a second kernel sums them in split order and rounds once. Also
// tried on the card, and slower: a block-wide tile per chunk behind a
// block barrier (the first prefill kernel's shape), register rings 1
// to 8 chunks deep
// with activations from L1, and weights staged through shared memory
// with cp.async.
//
// Prefill (T > 16): `dqmm_ws_kernel`, persistent and warp-specialised
// on Hopper's TMA, mbarriers and warpgroup MMA. One block an SM (384
// threads) walks work units: output tiles of 128 (T <= 128) or 256
// tokens x 128 outputs, times a K split where the tiles alone would
// leave SMs idle. The token tiles of one output tile are adjacent
// units, so the blocks that run at once share each weight tile (one
// read from device memory, the others from L2), and the activations
// stay in L2. A ring of 4 (256-token tiles) or 6 stages: a stage holds
// the activation tile [tokens, 64] bf16, the bf16 weight tile [128, 64]
// and the scale box of the tile's rows [128, 4 blocks].
//  - Warp 0 of the producer warpgroup: its thread 0 refills a stage by
//    TMA as soon as the consumers free it (the int8 weight tile into
//    the upper half of the bf16 tile's bytes, the scale box, the
//    activation tile under the 128-byte swizzle), all completing on
//    the stage's "full" barrier.
//  - Warps 1-3 dequantize in place: they read all of the chunk's int8
//    and scales, meet at a named barrier, write the bf16 tile K-major
//    under the 128-byte swizzle that the wgmma descriptor names, with
//    `dequant16`'s arithmetic, fence the writes to the async proxy and
//    arrive on the stage's "ready" barrier.
//  - Warpgroups 1 and 2 consume: each owns 64 or 128 of the tile's
//    tokens by all 128 outputs (64 or 128 f32 accumulators a thread),
//    issues 4 or 8 m64n128k16 wgmma a stage from shared memory, keeps
//    one stage's group in flight and frees the stage before it through
//    its "empty" barrier. No block-wide barrier runs after the set-up;
//    a unit's epilogue overlaps the next unit's loads and dequant.
// `setmaxnreg` gives the producer 96 registers and each consumer 200
// (compiled at 168 for 384 threads). TMA needs scale rows of a 16-byte
// multiple: where K / block is not a multiple of 4, the wrapper hands
// the kernel a copy of the scales padded to one. Split K writes f32
// partials [splits, T, O] that `dqmm_combine_kernel` sums in split
// order and rounds once; it stays for the shapes whose tiles fill less
// than one wave (wq, wk, wv, wo and w_down at T = 128 to 512, wk and
// wv at T = 1024).
//
// What bounds it (PERF.md): the tensor cores at T >= 256 (2*T*K*O
// operations), the weight bytes at T = 128 (256 operations a weight
// byte, below the card's ~295). The kernel reaches about 0.4 of the
// first. Taken apart on the card, the wgmma loop alone takes most of
// the time, the TMA ring adds little and the dequant arithmetic the
// rest, whichever warps run it: only fewer dequantized weights (a
// cluster sharing each tile) could cut that. Tried on the card against
// this design in one call each, and slower or no faster: the producer's
// four warps dequantizing with thread 0 loading between its own chunks
// (a chunk's TMA then leaves only 2 chunks before its use, and the ring
// runs dry behind its ~µs latency); the scales loaded per chunk by the
// dequantizing threads (__ldg or cp.async) or by warp 0's lanes
// (cp.async) instead of TMA; the operand swap (y^T = W x^T with the
// weight dequantized by the consumers into wgmma's register A operand,
// so no bf16 weight touches shared memory: slower at every shape, with
// a fence, commit and wait every k-step); the consumers dequantizing
// half of each weight tile under their own wgmma; four dequantizing
// warps with the loads issued by a consumer thread; separate activation
// and weight rings of different depths; 64 to 136 producer registers;
// shifts or I2F in place of the byte permute.

#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int NWARPS = 4;
constexpr int NT = NWARPS * 32;
constexpr int KC = 64;          // contraction values per chunk

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

// ---- prefill: TMA ring, dequantizing producer, wgmma consumers ------

constexpr int WS_NT = 384;               // producer + 2 consumer warpgroups
constexpr int WS_BO = 128;               // outputs a tile
constexpr int W8_TILE = WS_BO * KC;      // bytes of a staged int8 tile
constexpr int B_TILE = WS_BO * 128;      // bytes of its bf16 tile
constexpr int S_TILE = WS_BO * 4 * 4;    // a chunk's scale box, f32
constexpr int DQ_THREADS = 96;           // the 3 dequantizing warps
constexpr int DQ_ROWS = 6;               // rows a dequantizing thread takes

// byte offset of 16-byte group `kg` (0..7) of row `r` in a 128-byte-row
// tile under the 128-byte swizzle: group index XOR (row % 8)
__device__ inline int sw128(int r, int kg) {
  return r * 128 + ((kg ^ (r & 7)) << 4);
}

// MH m64 halves a consumer: 128 * MH tokens a tile. A stage holds the
// activation tile, the weight tile (the int8 tile lands in the upper
// half of its bytes and is dequantized in place), both at 1024-byte
// offsets (the swizzle atoms), and the scale box of the tile's rows:
// 4 blocks from the aligned quad that holds the chunk's first block
template <int MH>
struct WsShape {
  static constexpr int BT = 128 * MH;
  static constexpr int STAGES = MH == 2 ? 4 : 6;
  static constexpr int X_TILE = BT * 128;
  static constexpr int STAGE = X_TILE + B_TILE + S_TILE;
  static constexpr int BYTES = X_TILE + W8_TILE + S_TILE;   // TMA a stage
  static constexpr int SMEM = STAGES * STAGE + 3 * STAGES * 8 + 1024;
};

// work unit u: token tile m (fastest), K split z, output tile n
struct WsUnit {
  int t0, o0, z, c_begin, c_end;
};

__device__ inline WsUnit ws_unit(int u, int mt, int splits, int per_split,
                                 int chunks, int bt) {
  WsUnit w;
  const int rest = u / mt;
  w.t0 = (u % mt) * bt;
  w.z = rest % splits;
  w.o0 = (rest / splits) * WS_BO;
  w.c_begin = w.z * per_split;
  w.c_end = min(chunks, w.c_begin + per_split);
  return w;
}

template <int MH>
__global__ void __launch_bounds__(WS_NT, 1)
dqmm_ws_kernel(const __grid_constant__ CUtensorMap tm_x,
               const __grid_constant__ CUtensorMap tm_w,
               const __grid_constant__ CUtensorMap tm_s,
               __nv_bfloat16* __restrict__ y, float* __restrict__ part,
               int T, int K, int O, int block, int splits, int per_split) {
  using S = WsShape<MH>;
  constexpr int NS = S::STAGES;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~(uintptr_t)1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + NS * S::STAGE);
  uint64_t* ready = full + NS;
  uint64_t* empty = ready + NS;

  const int chunks = K / KC;
  const int mt = (T + S::BT - 1) / S::BT;
  const int units = mt * ((O + WS_BO - 1) / WS_BO) * splits;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int st = 0; st < NS; ++st) {
      mbar_init(full + st, 1);                // the TMA thread
      mbar_init(ready + st, 3);               // the 3 dequantizing warps
      mbar_init(empty + st, 8);               // the 8 consumer warps
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp < 4) {
    // ---- producer warpgroup ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 96;\n" ::: "memory");
    if (warp == 0) {
      // thread 0 keeps the ring full: chunk n loads as soon as the
      // consumers have freed chunk n - NS, by TMA: the int8 weight tile
      // and the scale box (device memory) first, then the activation
      // tile (L2)
      if (lane == 0) {
        int n = 0;
        for (int u = blockIdx.x; u < units; u += gridDim.x) {
          const WsUnit w = ws_unit(u, mt, splits, per_split, chunks, S::BT);
          for (int c = w.c_begin; c < w.c_end; ++c, ++n) {
            const int st = n % NS;
            if (n >= NS) mbar_wait(empty + st, (n / NS - 1) & 1);
            unsigned char* base = smem + st * S::STAGE;
            mbar_expect_tx(full + st, S::BYTES);
            tma_load_2d(base + S::X_TILE + B_TILE - W8_TILE, &tm_w,
                        full + st, c * KC, w.o0);
            tma_load_2d(base + S::X_TILE + B_TILE, &tm_s, full + st,
                        (c * KC / block) & ~3, w.o0);
            tma_load_2d(base, &tm_x, full + st, c * KC, w.t0);
          }
        }
      }
    } else {
      // warps 1-3 dequantize in place. Thread p takes values 16j ..
      // 16j + 15 of rows p / 4 + 24i (i < 6, rows < 128; the sixth
      // only in warp 1): a warp reads 512 contiguous staged bytes, and
      // each 8-thread phase of its 16-byte stores hits 8 distinct
      // 16-byte bank groups under the swizzle. The three warps read
      // every int8 value before any writes its bf16 (named barrier 1):
      // the int8 tile shares the bytes of the bf16 one.
      const int p = threadIdx.x - 32;
      const int j = p % 4;
      int n = 0;                              // chunks dequantized
      for (int u = blockIdx.x; u < units; u += gridDim.x) {
        const WsUnit w = ws_unit(u, mt, splits, per_split, chunks, S::BT);
        for (int c = w.c_begin; c < w.c_end; ++c, ++n) {
          const int st = n % NS;
          unsigned char* wb = smem + st * S::STAGE + S::X_TILE;
          const unsigned char* w8 = wb + B_TILE - W8_TILE;
          const float* sd = reinterpret_cast<const float*>(wb + B_TILE);
          // this thread's scale of a row: the block of value 16j of the
          // chunk, within the box's quad
          const int q = (c * KC + 16 * j) / block - ((c * KC / block) & ~3);
          mbar_wait(full + st, (n / NS) & 1);
          uint4 raw[DQ_ROWS];
          float sc[DQ_ROWS];
#pragma unroll
          for (int i = 0; i < DQ_ROWS; ++i) {
            const int r = p / 4 + 24 * i;
            if (r < WS_BO) {
              raw[i] = *reinterpret_cast<const uint4*>(w8 + r * KC + 16 * j);
              sc[i] = sd[4 * r + q];
            }
          }
          asm volatile("bar.sync 1, %0;\n" :: "n"(DQ_THREADS) : "memory");
#pragma unroll
          for (int i = 0; i < DQ_ROWS; ++i) {
            const int r = p / 4 + 24 * i;
            if (r >= WS_BO) continue;
            uint32_t bw[8];
            dequant16(raw[i], sc[i], bw);
            *reinterpret_cast<uint4*>(wb + sw128(r, 2 * j)) =
                make_uint4(bw[0], bw[1], bw[2], bw[3]);
            *reinterpret_cast<uint4*>(wb + sw128(r, 2 * j + 1)) =
                make_uint4(bw[4], bw[5], bw[6], bw[7]);
          }
          fence_proxy_async();
          __syncwarp();
          if (lane == 0) mbar_arrive(ready + st);
        }
      }
    }
  } else {
    // ---- consumer warpgroups: 64 * MH tokens x 128 outputs each ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 200;\n" ::: "memory");
    const int wgc = warp / 4 - 1;             // 0 or 1
    const int wq = warp % 4;                  // 16-row slice of an m64
    const int g = lane / 4;
    const int tq = lane % 4;
    float acc[MH][64];
#pragma unroll
    for (int h = 0; h < MH; ++h)
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[h][i] = 0.f;
    int n = 0;                                // chunks consumed
    for (int u = blockIdx.x; u < units; u += gridDim.x) {
      const WsUnit w = ws_unit(u, mt, splits, per_split, chunks, S::BT);
      for (int c = w.c_begin; c < w.c_end; ++c, ++n) {
        const int st = n % NS;
        const int ph = (n / NS) & 1;
        unsigned char* base = smem + st * S::STAGE;
        const uint32_t xa = sw128_lo(base + 64 * MH * wgc * 128, 16);
        const uint32_t wb = sw128_lo(base + S::X_TILE, 16);
        mbar_wait(full + st, ph);
        mbar_wait(ready + st, ph);
        wgmma_fence();
#pragma unroll
        for (int h = 0; h < MH; ++h) {
#pragma unroll
          for (int ks = 0; ks < 4; ++ks)
            // k-step ks: 32 bytes further along the swizzled rows; the
            // first of a unit overwrites the accumulators
            wgmma_ss_n128(acc[h], desc_at(xa, 64 * 128 * h + 32 * ks),
                          desc_at(wb, 32 * ks), c > w.c_begin || ks > 0);
        }
        wgmma_commit();
        wgmma_wait<1>();
        // the group of the chunk before is done: free its stage
        if (c > w.c_begin && lane == 0) mbar_arrive(empty + (n - 1) % NS);
      }
      wgmma_wait<0>();
#pragma unroll
      for (int h = 0; h < MH; ++h)
#pragma unroll
        for (int i = 0; i < 64; ++i) reg_fence(acc[h][i]);
      if (lane == 0) mbar_arrive(empty + (n - 1) % NS);

      // accumulator i of half h: n8 block jn = i / 4, element e = i % 4
      // at token row 64 (MH wgc + h) + 16 wq + g + 8 (e / 2), output
      // 8 jn + 2 tq + e % 2
#pragma unroll
      for (int h = 0; h < MH; ++h) {
        const int tok = w.t0 + 64 * (MH * wgc + h) + 16 * wq + g;
#pragma unroll
        for (int jn = 0; jn < 16; ++jn) {
          const int o = w.o0 + 8 * jn + 2 * tq;
          store_pair(acc[h][4 * jn], acc[h][4 * jn + 1], tok, o, T, O, y,
                     part, w.z);
          store_pair(acc[h][4 * jn + 2], acc[h][4 * jn + 3], tok + 8, o, T,
                     O, y, part, w.z);
        }
      }
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

// ---- decode: even shares of a TMA ring (dqmm_dec_tma_kernel) ---------

constexpr int DT_BO = 64;                 // outputs a tile
constexpr int DT_KS = 256;                // K values a stage
constexpr int DT_CW = 8;                  // consumer warps, 8 outputs each
constexpr int DT_NT = 32 * (DT_CW + 1);   // and the loading warp
constexpr int DT_NS = 4;                  // ring stages
constexpr int DT_W = DT_BO * DT_KS;       // a stage's int8 tile, 16 KB
constexpr int DT_S = DT_BO * 4 * 4;       // its scale box [64 rows, 4]
constexpr int DT_SLOT = DT_CW * 32 * 4;   // f32 values of a partial

// XR activation rows a stage (8 for T <= 8, else 16), every part at a
// 1024-byte offset; TMA counts whole boxes, rows past T and K included
template <int XR>
struct DtShape {
  static constexpr int X = XR * DT_KS * 2;
  static constexpr int STAGE = DT_W + DT_S + X;
  static constexpr int SMEM = DT_NS * STAGE + 2 * DT_NS * 8 + 16 + 1024;
};

// The decode kernel on a TMA ring (the design is in the header). Warp 8's
// lane 0 loads, warps 0-7 compute (the decode kernel's k permutation:
// lane (g, t) takes values 16t .. 16t + 15 of each 64-value chunk of
// weight row 8 * warp + g); slot 2b of the partials holds share b's
// first tile when the share cuts it, slot 2b + 1 its last.
template <bool HI>
__global__ void __launch_bounds__(DT_NT, 2)
dqmm_dec_tma_kernel(const __grid_constant__ CUtensorMap tm_x,
                    const __grid_constant__ CUtensorMap tm_w,
                    const __grid_constant__ CUtensorMap tm_s,
                    __nv_bfloat16* __restrict__ y, float* __restrict__ part,
                    int* __restrict__ counters, int T, int K, int O,
                    int block) {
  using S = DtShape<HI ? 16 : 8>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~(uintptr_t)1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + DT_NS * S::STAGE);
  uint64_t* empty = full + DT_NS;
  volatile int* last_flag = reinterpret_cast<volatile int*>(empty + DT_NS);

  const int kst = (K + DT_KS - 1) / DT_KS;
  const int total = (O + DT_BO - 1) / DT_BO * kst;
  const int grid = gridDim.x;
  const int s0 = share_start(blockIdx.x, total, grid);
  const int s1 = share_start(blockIdx.x + 1, total, grid);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int st = 0; st < DT_NS; ++st) {
      mbar_init(full + st, 1);                // the loading thread
      mbar_init(empty + st, DT_CW);           // the consumer warps
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp == DT_CW) {
    if (lane == 0) {
      prefetch_map(&tm_w);
      prefetch_map(&tm_s);
      prefetch_map(&tm_x);
      for (int s = s0, tile = s0 / kst, kc = s0 % kst; s < s1; ++s) {
        const int n = s - s0;
        const int st = n % DT_NS;
        if (n >= DT_NS) mbar_wait(empty + st, (n / DT_NS - 1) & 1);
        unsigned char* base = smem + st * S::STAGE;
        const int o0 = tile * DT_BO;
        const int k0 = kc * DT_KS;
        if (++kc == kst) {
          kc = 0;
          ++tile;
        }
        mbar_expect_tx(full + st, S::STAGE);
        tma_load_2d(base, &tm_w, full + st, k0, o0);
        tma_load_2d(base + DT_W, &tm_s, full + st, (k0 / block) & ~3, o0);
        tma_load_2d(base + DT_W + DT_S, &tm_x, full + st, k0, 0);
      }
    }
    return;
  }

  const int g = lane / 4;
  const int t = lane % 4;
  const int row = warp * 8 + g;               // this lane's weight row
  const int lb = __ffs(block) - 1;            // block = 2^lb
  // two accumulator chains (even and odd chunks), added at the tile's end
  float acc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
  // the tiles this share cuts (at most its first and its last): each
  // writes its partial as it ends and thread 0 adds one to its counter;
  // whether this block was the last to do so is read at the share's end,
  // so no warp waits on the atomic's round trip mid-stream
  int cut0 = -1, cut1 = -1, old0 = 0, old1 = 0;
  for (int s = s0, tile = s0 / kst, kc = s0 % kst; s < s1;
       ++s, kc = kc + 1 == kst ? 0 : kc + 1, tile += kc == 0) {
    const int n = s - s0;
    const int st = n % DT_NS;
    const int k0 = kc * DT_KS;
    const unsigned char* base = smem + st * S::STAGE;
    const unsigned char* w8 = base + row * DT_KS;
    const float* sc = reinterpret_cast<const float*>(base + DT_W) + row * 4 -
                      ((k0 >> lb) & ~3);
    const __nv_bfloat16* xs =
        reinterpret_cast<const __nv_bfloat16*>(base + DT_W + DT_S);
    // one 64-value chunk: this lane's 16 weights of its row, dequantized,
    // times the activations' matching 16 values of rows g and g + 8
    auto chunk = [&](int c, float* ac) {
      const int kk = c * KC + 16 * t;
      uint32_t bw[8];
      dequant16(*reinterpret_cast<const uint4*>(w8 + kk),
                sc[(k0 + kk) >> lb], bw);
      const __nv_bfloat16* xr = xs + g * DT_KS + kk;
      const uint4 l0 = *reinterpret_cast<const uint4*>(xr);
      const uint4 l1 = *reinterpret_cast<const uint4*>(xr + 8);
      const uint32_t rg[8] = {l0.x, l0.y, l0.z, l0.w, l1.x, l1.y, l1.z, l1.w};
      uint32_t rh[8] = {0u, 0u, 0u, 0u, 0u, 0u, 0u, 0u};
      if (HI) {
        const uint4 h0 = *reinterpret_cast<const uint4*>(xr + 8 * DT_KS);
        const uint4 h1 = *reinterpret_cast<const uint4*>(xr + 8 * DT_KS + 8);
        rh[0] = h0.x; rh[1] = h0.y; rh[2] = h0.z; rh[3] = h0.w;
        rh[4] = h1.x; rh[5] = h1.y; rh[6] = h1.z; rh[7] = h1.w;
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const uint32_t a[4] = {rg[2 * j], rh[2 * j], rg[2 * j + 1],
                               rh[2 * j + 1]};
        mma_bf16(ac, a, &bw[2 * j]);
      }
    };
    mbar_wait(full + st, (n / DT_NS) & 1);
    if (K - k0 >= DT_KS) {
#pragma unroll
      for (int c = 0; c < DT_KS / KC; ++c) chunk(c, acc[c & 1]);
    } else {
      for (int c = 0; c < (K - k0) / KC; ++c) chunk(c, acc[0]);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + st);
    if (kc != kst - 1 && s != s1 - 1) continue;

    // the tile ends here, or the share does
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      acc[0][e] += acc[1][e];
      acc[1][e] = 0.f;
    }
    const int ts = tile * kst;
    if (ts >= s0 && ts + kst <= s1) {
      const int o = tile * DT_BO + warp * 8 + 2 * t;
      store_pair(acc[0][0], acc[0][1], g, o, T, O, y, nullptr, 0);
      store_pair(acc[0][2], acc[0][3], g + 8, o, T, O, y, nullptr, 0);
    } else {
      const int slot = 2 * blockIdx.x + (ts > s0 ? 1 : 0);
      __stcg(reinterpret_cast<float4*>(part + (int64_t)slot * DT_SLOT) +
                 threadIdx.x,
             make_float4(acc[0][0], acc[0][1], acc[0][2], acc[0][3]));
      bar_sync_n(1, DT_CW * 32);
      // (the atomic's result lands in old0 / old1 and is not read until
      // the share's end: no move of it stalls the warp here)
      if (threadIdx.x == 0) fence_acq_rel_gpu();   // release the partials
      if (cut0 < 0) {
        if (threadIdx.x == 0) old0 = atomicAdd(counters + tile, 1);
        cut0 = tile;
      } else {
        if (threadIdx.x == 0) old1 = atomicAdd(counters + tile, 1);
        cut1 = tile;
      }
    }
    acc[0][0] = acc[0][1] = acc[0][2] = acc[0][3] = 0.f;
  }
  if (cut0 < 0) return;

  // the cut tiles this block finished last: their pieces in block order,
  // 8 loads in flight at a time, rounded once
  if (threadIdx.x == 0) {
    int flags = 0;
    if (old0 == share_count(cut0 * kst, cut0 * kst + kst - 1, total, grid) - 1)
      flags |= 1;
    if (cut1 >= 0 &&
        old1 == share_count(cut1 * kst, cut1 * kst + kst - 1, total, grid) - 1)
      flags |= 2;
    if (flags) fence_acq_rel_gpu();           // acquire the others' partials
    *last_flag = flags;
  }
  bar_sync_n(1, DT_CW * 32);
  const int flags = *last_flag;
  for (int i = 0; i < 2; ++i) {
    if (!(flags >> i & 1)) continue;
    const int tile = i == 0 ? cut0 : cut1;
    const int ts = tile * kst;
    const int bf = share_block(ts, total, grid);
    const int bl = share_block(ts + kst - 1, total, grid);
    const bool mid = ts > (int)share_start(bf, total, grid);
    float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int b0 = bf; b0 <= bl; b0 += 8) {
      float4 v[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int b = b0 + j;
        const int sl = 2 * b + (b == bf && mid ? 1 : 0);
        v[j] = b <= bl && share_any(b, total, grid)
                   ? __ldcg(reinterpret_cast<const float4*>(
                                part + (int64_t)sl * DT_SLOT) +
                            threadIdx.x)
                   : make_float4(0.f, 0.f, 0.f, 0.f);
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (b0 + j > bl) break;
        if (!share_any(b0 + j, total, grid)) continue;
        sum.x += v[j].x; sum.y += v[j].y;
        sum.z += v[j].z; sum.w += v[j].w;
      }
    }
    const int o = tile * DT_BO + warp * 8 + 2 * t;
    store_pair(sum.x, sum.y, g, o, T, O, y, nullptr, 0);
    store_pair(sum.z, sum.w, g + 8, o, T, O, y, nullptr, 0);
    if (threadIdx.x == 0) counters[tile] = 0;   // for the next launch
  }
}

constexpr int DEC_NO = 2;            // decode: 8 * 2 outputs per warp
constexpr int DEC_UNR = 2;           // decode: chunks per load batch
constexpr int DEC_MAX_CHUNKS = 16;   // decode: K range of one block

// the prefill kernel with 128 * MH-token tiles on `grid` persistent
// blocks; the tensor maps are encoded on the host for each launch (a
// few microseconds) and passed by value, so a captured CUDA graph
// holds its own copies
template <int MH>
int launch_ws(const void* x, const void* q8, const float* s8q,
              __nv_bfloat16* y, float* part, int T, int K, int O, int block,
              int splits, int per_split, int grid, cudaStream_t stream) {
  using S = WsShape<MH>;
  // the scales as [O, quads of 4 blocks] (a row pitch of 16 bytes'
  // multiple, as TMA needs: the wrapper pads K / block to a multiple
  // of 4 where it is not)
  const int nblk4 = (K / block + 3) & ~3;
  CUtensorMap tm_x, tm_w, tm_s;
  if (!make_map_2d(&tm_x, x, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, T, K,
                   S::BT, KC, CU_TENSOR_MAP_SWIZZLE_128B) ||
      !make_map_2d(&tm_w, q8, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, O, K, WS_BO,
                   KC, CU_TENSOR_MAP_SWIZZLE_NONE) ||
      !make_map_2d(&tm_s, s8q, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, O, nblk4,
                   WS_BO, 4, CU_TENSOR_MAP_SWIZZLE_NONE))
    return (int)cudaErrorInvalidValue;
  // raise the dynamic shared-memory cap once (not per launch: the
  // attribute call is host work, and launches may be graph-captured)
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        dqmm_ws_kernel<MH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        S::SMEM);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  dqmm_ws_kernel<MH><<<grid, WS_NT, S::SMEM, stream>>>(
      tm_x, tm_w, tm_s, y, part, T, K, O, block, splits, per_split);
  return 0;
}

// variant 0: the decode kernel (T <= 16); 1: the prefill kernel with
// 128-token tiles; 2: with 256-token tiles
int launch(int variant, const void* x, const void* q8, const void* s8,
           const void* s8q, void* y, void* part, int T, int K, int O,
           int block, int splits, int chunks_per_split, int grid,
           cudaStream_t stream) {
  const __nv_bfloat16* xp = (const __nv_bfloat16*)x;
  const int8_t* qp = (const int8_t*)q8;
  const float* sp = (const float*)s8;
  __nv_bfloat16* yp = (__nv_bfloat16*)y;
  float* pp = splits > 1 ? (float*)part : nullptr;
  int err = 0;
  if (variant == 0) {
    constexpr int BO = NWARPS * 8 * DEC_NO;
    const dim3 dgrid(1, (O + BO - 1) / BO, splits);
    const int rows = T > 8 ? 16 : 8;
    const int smem = rows * (chunks_per_split * KC + 8) * 2;  // <= 33 KB
    if (T > 8)
      dqmm_decode_kernel<DEC_NO, DEC_UNR, true><<<dgrid, NT, smem, stream>>>(
          xp, qp, sp, yp, pp, T, K, O, block, chunks_per_split);
    else
      dqmm_decode_kernel<DEC_NO, DEC_UNR, false><<<dgrid, NT, smem, stream>>>(
          xp, qp, sp, yp, pp, T, K, O, block, chunks_per_split);
  } else if (variant == 1) {
    err = launch_ws<1>(x, q8, (const float*)s8q, yp, pp, T, K, O, block,
                       splits, chunks_per_split, grid, stream);
  } else {
    err = launch_ws<2>(x, q8, (const float*)s8q, yp, pp, T, K, O, block,
                       splits, chunks_per_split, grid, stream);
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

template <bool HI>
int launch_dec_tma(const void* x, const void* q8, const float* s8q,
                   __nv_bfloat16* y, float* part, int* counters, int T,
                   int K, int O, int block, int grid, cudaStream_t stream) {
  using S = DtShape<HI ? 16 : 8>;
  const int nblk4 = (K / block + 3) & ~3;
  CUtensorMap tm_x, tm_w, tm_s;
  if (!make_map_2d(&tm_x, x, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, T, K,
                   HI ? 16 : 8, DT_KS, CU_TENSOR_MAP_SWIZZLE_NONE) ||
      !make_map_2d(&tm_w, q8, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, O, K, DT_BO,
                   DT_KS, CU_TENSOR_MAP_SWIZZLE_NONE) ||
      !make_map_2d(&tm_s, s8q, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, O, nblk4,
                   DT_BO, 4, CU_TENSOR_MAP_SWIZZLE_NONE))
    return (int)cudaErrorInvalidValue;
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        dqmm_dec_tma_kernel<HI>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        S::SMEM);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  dqmm_dec_tma_kernel<HI><<<grid, DT_NT, S::SMEM, stream>>>(
      tm_x, tm_w, tm_s, y, part, counters, T, K, O, block);
  return (int)cudaGetLastError();
}

}  // namespace

// The decode kernel on a TMA ring (T <= 16): x [T, K] bf16, q8 [O, K]
// int8, s8q [O, K / block padded to 4] f32 (the prefill kernel's
// scales), y [T, O] bf16, all contiguous and 16-byte aligned; `grid`
// blocks (at most two an SM) take even shares of the (64-output tile,
// 256-value K range) stages; part [2 * grid, 1024] f32 scratch for the
// tiles a share's edge cuts; counters [ceil(O / 64)] int32, zero before
// the launch and zero again after it (the kernel resets what it uses).
// Launches of it on one device must not overlap (one stream): they
// share the counters. Takes a block of at least 64 (the scale quad box
// covers a stage's blocks); one launch, no second kernel.
extern "C" int dqmm_decode_tma_bf16(const void* x, const void* q8,
                                    const void* s8q, void* y, void* part,
                                    void* counters, int T, int K, int O,
                                    int block, int grid, void* stream) {
  if (T < 1 || T > 16 || O < 1 || K < KC || K % KC != 0 || block < 64 ||
      (block & (block - 1)) != 0 || K % block != 0 || grid < 1 ||
      s8q == nullptr || part == nullptr || counters == nullptr ||
      (uint64_t)((O + DT_BO - 1) / DT_BO) * ((K + DT_KS - 1) / DT_KS) *
              (grid + 1) >= (1ull << 32))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (T > 8)
    return launch_dec_tma<true>(x, q8, (const float*)s8q, (__nv_bfloat16*)y,
                                (float*)part, (int*)counters, T, K, O, block,
                                grid, st);
  return launch_dec_tma<false>(x, q8, (const float*)s8q, (__nv_bfloat16*)y,
                               (float*)part, (int*)counters, T, K, O, block,
                               grid, st);
}

// x [T, K] bf16, q8 [O, K] int8, s8 [O, K / block] f32, y [T, O] bf16,
// all contiguous and 16-byte aligned; s8q the same scales with rows
// padded to a multiple of 4 blocks (s8 itself where K / block is one),
// read by the prefill kernel; part [splits, T, O] f32 scratch when
// splits > 1. variant 0: the decode kernel (T <= 16), 1 and 2: the
// prefill kernel with 128- and 256-token tiles on `grid` blocks. The
// wrapper (ops/quantization.py) checks shapes and picks variant, split
// and grid; this refuses what would read out of bounds.
extern "C" int dqmm_bf16(const void* x, const void* q8, const void* s8,
                         const void* s8q, void* y, void* part, int T, int K,
                         int O, int block, int variant, int splits,
                         int chunks_per_split, int grid, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (T < 1 || O < 1 || K < KC || K % KC != 0 || block < 16 ||
      (block & (block - 1)) != 0 || K % block != 0 || splits < 1 ||
      chunks_per_split < 1 ||
      (long long)splits * chunks_per_split < K / KC ||
      (long long)(splits - 1) * chunks_per_split >= K / KC ||
      (splits > 1 && part == nullptr))
    return (int)cudaErrorInvalidValue;
  if ((variant == 0 && (T > 16 || chunks_per_split > DEC_MAX_CHUNKS)) ||
      (variant != 0 && grid < 1) || variant < 0 || variant > 2)
    return (int)cudaErrorInvalidValue;
  if (variant != 0 && s8q == nullptr) return (int)cudaErrorInvalidValue;
  return launch(variant, x, q8, s8, s8q, y, part, T, K, O, block, splits,
                chunks_per_split, grid, st);
}
