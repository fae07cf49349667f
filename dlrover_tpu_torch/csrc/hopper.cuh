// Hopper (sm_90a) building blocks shared by the attention kernels
// (flash_fwd.cu, flash_bwd.cu) and the dequant-matmul (dqmm.cu):
// mma.sync helpers, the mbarrier ring, TMA tensor maps and loads,
// named barriers and the wgmma forms with their 128-byte-swizzle
// shared-memory descriptors.
//
// Each source that includes this header builds into its own library;
// ops/_build.py hashes the header into every library name that
// includes it, so an edited header rebuilds them all.

#pragma once

#include <cuda.h>           // CUtensorMap (no libcuda call is linked)
#include <cudaTypedefs.h>   // PFN_cuTensorMapEncodeTiled
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace hopper {

// ---- mma.sync m16n8k16 (the kernels for shapes the wgmma ones refuse)

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

// int8 byte `sel` (0..3) of a word whose sign bits were flipped (so
// the byte is q + 128), as the exact f32 q: the byte becomes the low
// mantissa of 2^23 (f32 bits 0x4B0000uu = 2^23 + u, one byte permute)
// and 2^23 + 128 is subtracted (exact). This keeps the conversion off
// the SM's 16-per-clock conversion unit, which an I2F per value
// saturates before the memory does.
__device__ inline float q8_to_f32(uint32_t flipped, int sel) {
  return __uint_as_float(__byte_perm(flipped, 0x4B000000u, 0x7540 + sel)) -
         8388736.0f;
}

__device__ inline void ldmatrix_x4(uint32_t* r, const void* smem) {
  uint32_t addr = (uint32_t)__cvta_generic_to_shared(smem);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
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

// ---- mbarriers and TMA -------------------------------------------------

constexpr uint32_t SPIN_LIMIT = 1u << 24;

__device__ inline uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ inline void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
}

// make the barriers' initialisation visible to the async proxy (TMA)
__device__ inline void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// the one arrival a "full" barrier expects from the thread that issues
// its TMA loads, with the bytes those loads will complete
__device__ inline void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

// an arrival (release: this thread's shared-memory writes before it are
// visible to a thread whose wait sees the phase complete)
__device__ inline void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(smem_u32(bar)) : "memory");
}

// wait until the phase of parity `parity` has completed; a wait that
// never ends (a lost arrival) faults the launch instead of hanging
__device__ inline void mbar_wait(uint64_t* bar, int parity) {
  const uint32_t addr = smem_u32(bar);
  for (uint32_t spins = 0;; ++spins) {
    uint32_t done;
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done) : "r"(addr), "r"(parity) : "memory");
    if (done) return;
    if (spins == SPIN_LIMIT) __trap();
  }
}

// one box of a 4-D tensor map (coordinates innermost first) into
// shared memory, completing its bytes on `bar`
__device__ inline void tma_load_4d(void* dst, const CUtensorMap* map,
                                   uint64_t* bar, int c0, int c1, int c2,
                                   int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// one box of a 2-D tensor map (coordinates innermost first) into
// shared memory, completing its bytes on `bar`
__device__ inline void tma_load_2d(void* dst, const CUtensorMap* map,
                                   uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

// `bytes` contiguous bytes (a multiple of 16, both addresses 16-byte
// aligned) into shared memory by the bulk-copy engine, completing on
// `bar` as a TMA box does
__device__ inline void bulk_load(void* dst, const void* src, uint32_t bytes,
                                 uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :: "r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// make this thread's generic-proxy shared-memory writes (st.shared)
// visible to the async proxy that wgmma and TMA read through
__device__ inline void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// named barrier `id` over two consumer warpgroups (256 threads): one
// waits in bar_sync until the other has passed its bar_arrive (turns
// in the forward, a P tile handed over in the dK/dV backward)
__device__ inline void bar_sync(int id) {
  asm volatile("bar.sync %0, 256;\n" :: "r"(id) : "memory");
}
__device__ inline void bar_arrive(int id) {
  asm volatile("bar.arrive %0, 256;\n" :: "r"(id) : "memory");
}

// named barrier `id` over the first `n` threads of the block (whole
// warps): the consumer warps of a kernel whose loading warp runs apart
__device__ inline void bar_sync_n(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(n) : "memory");
}

// ---- even shares of a work sequence (the decode kernels) ----------------
//
// `total` work units in a fixed order split over `grid` blocks: block b
// takes units [share_start(b), share_start(b + 1)), so shares differ by
// at most one unit and no block waits on a second wave. A run of units
// that several blocks share (a dqmm output tile's K range, a paged
// row's pages) is summed by the last of them to finish, in block order
// (`share_block`: the block whose share holds unit s; `share_count`:
// how many blocks hold a piece of a run). The host keeps
// total * (grid + 1) below 2^32, so the divisions are 32-bit ones (a
// 64-bit division is a long software routine: dozens of them in one
// epilogue cost microseconds).

__host__ __device__ inline uint32_t share_start(uint32_t b, uint32_t total,
                                                uint32_t grid) {
  return b * total / grid;
}

__host__ __device__ inline uint32_t share_block(uint32_t s, uint32_t total,
                                                uint32_t grid) {
  return ((s + 1) * grid - 1) / total;
}

// whether block b's share holds any unit (a grid larger than the work
// leaves some empty: they hold no piece of a run they fall inside)
__host__ __device__ inline bool share_any(uint32_t b, uint32_t total,
                                          uint32_t grid) {
  return total >= grid ||
         share_start(b + 1, total, grid) > share_start(b, total, grid);
}

// the blocks whose shares hold some of units [first, last]
__device__ inline int share_count(uint32_t first, uint32_t last,
                                  uint32_t total, uint32_t grid) {
  const uint32_t bf = share_block(first, total, grid);
  const uint32_t bl = share_block(last, total, grid);
  if (total >= grid) return (int)(bl - bf + 1);
  int n = 0;
  for (uint32_t b = bf; b <= bl; ++b) n += share_any(b, total, grid);
  return n;
}

// have the TMA unit fetch a tensor map before its first load needs it
__device__ inline void prefetch_map(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n"
               :: "l"(reinterpret_cast<uint64_t>(map)) : "memory");
}

// the gpu-scope acquire-release fence one thread puts around the counter
// of a shared run (the writers' stores reach it through the CTA barrier
// before it: cumulativity), far cheaper than a sequentially consistent
// __threadfence() in every thread
__device__ inline void fence_acq_rel_gpu() {
  asm volatile("fence.acq_rel.gpu;\n" ::: "memory");
}

// ---- wgmma ---------------------------------------------------------------

__device__ inline void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ inline void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// wait until at most N committed wgmma groups are pending
template <int N>
__device__ inline void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}
// a shared-memory load the compiler keeps where it is written: after
// the wgmma wait before it, so the value is not held in a register
// beside accumulators that are still in flight
__device__ inline float lds_f32(const float* p) {
  float v;
  asm volatile("ld.shared.f32 %0, [%1];\n" : "=f"(v) : "r"(smem_u32(p)));
  return v;
}
// keep the compiler from moving reads or writes of an accumulator
// register across the asynchronous wgmma that owns it
__device__ inline void reg_fence(float& r) {
  asm volatile("" : "+f"(r) :: "memory");
}

// descriptor of a tile of 128-byte rows under the 128-byte swizzle
// (8-row atoms of 1024 bytes; layout type 1 in bits 62-63): start >> 4,
// leading byte offset >> 4 in bits 16-29, stride byte offset (1024,
// the next 8-row atom) >> 4 in bits 32-45. K-major (the operand's K
// along the rows' bytes) leaves the leading offset unused (1);
// MN-major (N along the rows' bytes, K down the rows) reaches the
// next 64 columns of N at the leading offset, the next 64-column half
// of the tile
__device__ inline uint64_t sw128_desc(const void* p, uint32_t lbo) {
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) |
         ((uint64_t)(lbo >> 4) << 16) | ((uint64_t)(1024 >> 4) << 32) |
         ((uint64_t)1 << 62);
}

// the same descriptor in two 32-bit halves: `lo` (start >> 4 and the
// leading byte offset) of a tile's base, to which `desc_at` adds a byte
// offset inside the tile, and the constant `hi`
__device__ inline uint32_t sw128_lo(const void* p, uint32_t lbo) {
  return ((smem_u32(p) & 0x3FFFF) >> 4) | ((lbo >> 4) << 16);
}
constexpr uint32_t SW128_HI = (1024 >> 4) | (1u << 30);

// the descriptor `off` bytes into the tile whose base half is `lo`,
// built by volatile asm where it is used: the compiler can neither
// hoist it out of a loop nor keep a set of them live in registers
// beside the accumulators of the wgmma that reads it
__device__ inline uint64_t desc_at(uint32_t lo, uint32_t off) {
  uint64_t d;
  asm volatile(
      "{\n"
      ".reg .b32 l;\n"
      "add.u32 l, %1, %2;\n"
      "mov.b64 %0, {l, %3};\n"
      "}\n"
      : "=l"(d) : "r"(lo), "r"(off >> 4), "r"(SW128_HI));
  return d;
}

// D[64 x 128] f32 (+)= A[64 x 16] . B[16 x 128], both bf16 in shared
// memory, both K-major; scale_d 0 overwrites D
__device__ inline void wgmma_ss_n128(float* d, uint64_t da, uint64_t db,
                                     int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D[64 x 64] f32 (+)= A[64 x 16] . B[16 x 64], both bf16 in shared
// memory, both K-major; scale_d 0 overwrites D
__device__ inline void wgmma_ss_n64(float* d, uint64_t da, uint64_t db,
                                    int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D[64 x 128] f32 += A[64 x 16] (bf16, registers: the accumulator
// layout of a k16 slice) . B[16 x 128] (bf16 in shared memory, MN-major:
// imm-trans-b 1)
__device__ inline void wgmma_rs_n128(float* d, const uint32_t* a,
                                     uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n"
      "}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D[64 x 64] f32 += A[64 x 16] (bf16, registers: the accumulator
// layout of a k16 slice) . B[16 x 64] (bf16 in shared memory, MN-major:
// imm-trans-b 1)
__device__ inline void wgmma_rs_n64(float* d, const uint32_t* a,
                                    uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// ---- tensor maps (host) ----------------------------------------------

typedef CUresult (*EncodeTiled)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, fetched at run time by its entry-point name, so
// the library links no libcuda
inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// a tensor map over a contiguous [B, S, heads, D] bf16 tensor: dims
// (D, heads, S, B) innermost first, boxes of 64 columns x 1 head x
// `rows` rows x 1, 128-byte swizzle; rows past S read as zeros (a box
// still completes its whole size in bytes on its barrier)
inline bool make_map(CUtensorMap* map, const void* ptr, int b, int s,
                     int heads, int d, int rows) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t row = (cuuint64_t)d * sizeof(__nv_bfloat16);
  const cuuint64_t dims[4] = {(cuuint64_t)d, (cuuint64_t)heads,
                              (cuuint64_t)s, (cuuint64_t)b};
  const cuuint64_t strides[3] = {row, row * heads, row * heads * s};
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)rows, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
            dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// a tensor map over a contiguous row-major [rows, cols] matrix of
// `elem_bytes`-byte values: boxes of `box_cols` x `box_rows` values,
// under `swizzle`; rows past `rows` read as zeros (a box still
// completes its whole size in bytes on its barrier)
inline bool make_map_2d(CUtensorMap* map, const void* ptr,
                        CUtensorMapDataType type, int elem_bytes, int rows,
                        int cols, int box_rows, int box_cols,
                        CUtensorMapSwizzle swizzle) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * elem_bytes};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  const cuuint32_t unit[2] = {1, 1};
  return fn(map, type, 2, const_cast<void*>(ptr), dims, strides, box, unit,
            CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace hopper
