// Hopper (sm_90a) building blocks of the slab_tc kernel (slab.cu) and the
// bfloat16 contraction (bf16.cu), one or two PTX instructions each (PTX
// ISA 8.0):
//
// * mbarriers: a phase completes when its expected arrivals have arrived
//   and the bytes a TMA copy announced (expect_tx) have landed;
// * TMA bulk copies (cp.async.bulk) from device to shared memory that
//   report to an mbarrier, and 2-D tiled TMA loads through a tensor map;
// * register reallocation between warpgroups (setmaxnreg); named
//   barriers over part of a block;
// * warpgroup MMAs in TF32 (wgmma.mma_async m64n128k8, A from registers,
//   B from shared memory by descriptor) and in BF16 (m64nNk16, A from
//   registers or shared memory), their fences, groups and waits, and the
//   descriptors of K-major operands in the 32-, 64- and 128-byte swizzles.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace tabcorr {
namespace hopper {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- mbarriers (addresses in the shared window) ----------------------
__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count)
               : "memory");
}

// Make the initialised barriers visible to the TMA unit (and the rest of
// the cluster) before anyone arrives on them.
__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// Whether the phase of parity `parity` has completed (try_wait may first
// suspend the thread for a while).
__device__ __forceinline__ bool mbar_try_wait(uint32_t bar,
                                              uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n\t.reg .pred p;\n\t"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
      "selp.b32 %0, 1, 0, p;\n}"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

// Cycles a wait may last before the kernel gives up (~2 s at the H100's
// clocks; a whole slab_tc launch takes tens of milliseconds).  A barrier
// that never completes then ends the launch with an error the wrapper
// reports, not a hung card.
constexpr long long kWaitLimit = 1ll << 32;

// Block until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  const long long start = clock64();
  while (!mbar_try_wait(bar, parity))
    if (clock64() - start > kWaitLimit) __trap();
}

// One arrival that also announces `bytes` of TMA traffic for the phase.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar,
                                                      uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}

// ---- TMA bulk copies -------------------------------------------------
// Copy `bytes` (a multiple of 16, both addresses 16-byte aligned) from
// device memory to shared memory; the bytes complete on `bar`.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// ---- register reallocation (every thread of the warpgroup) -----------
template <int N>
__device__ __forceinline__ void regs_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(N));
}

template <int N>
__device__ __forceinline__ void regs_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(N));
}

// ---- warpgroup MMAs --------------------------------------------------
// Order the warpgroup's register and shared-memory writes before the
// wgmma that follows (required after writing its A registers).
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}

// Wait until at most N committed groups of this warpgroup are pending.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// Keep the compiler from moving an accumulator's reads or writes across
// the asynchronous MMAs that own it.
__device__ __forceinline__ void fence_operand(float& r) {
  asm volatile("" : "+f"(r)::"memory");
}

// Descriptor of a K-major operand in the 32-byte swizzle at shared
// address `addr` (256-byte aligned): each row (an N index) holds 8 TF32
// values of K, 32 bytes, its two 16-byte halves swapped in rows 4-7 of
// every 8-row group (address bit 4 ^= bit 7); 8-row groups 256 bytes
// apart (the stride byte offset); the leading byte offset is unused.
__device__ __forceinline__ uint64_t desc_kmajor_sw32(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) |
         (static_cast<uint64_t>(256 >> 4) << 32) | (3ull << 62);
}

// d (+)= a b on one m64n128k8 tile: A from registers (TF32, the
// m16n8k8 fragment layout per warp), B from shared memory by descriptor.
__device__ __forceinline__ void wgmma_tf32_n128(float (&d)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
        "r"(scale_d));
}

// ---- 2-D tensor copies, named barriers, prefetch ---------------------
// Copy the box at (c0, c1) (innermost coordinate first) of the tensor
// map at generic address `tmap` (a __grid_constant__ kernel parameter)
// to shared memory at `dst`; the box's bytes, out-of-range elements
// included as zeros, complete on `bar`.
__device__ __forceinline__ void tensor_load_2d(uint32_t dst, const void* tmap,
                                               int c0, int c1,
                                               uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];" ::"r"(dst),
      "l"(tmap), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}

// Barrier `id` (1..15) over `threads` threads of the block (whole warps).
__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void prefetch_l2(const void* p) {
  asm volatile("prefetch.global.L2 [%0];" ::"l"(p));
}

// ---- BF16 warpgroup MMAs ---------------------------------------------
// Descriptor of a K-major operand at shared address `addr` in the swizzle
// of `row_bytes` (128 or 64): each row (an M or N index) holds row_bytes
// of K, the 16-byte units of its address XORed with the row's index
// within its 8-row group (Swizzle<3 or 2, 4, 3> of the absolute address:
// the group must be 8 row_bytes aligned); 8-row groups 8 row_bytes apart
// (the stride byte offset); the leading byte offset is unused.  A k16
// step further along K within a row is `addr` + 32 bytes.
__device__ __forceinline__ uint64_t desc_kmajor(uint32_t addr,
                                                int row_bytes) {
  const uint64_t layout = row_bytes == 128 ? 1 : 2;
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) |
         (static_cast<uint64_t>((8 * row_bytes) >> 4) << 32) |
         (layout << 62);
}

// Operand lists of an accumulator of 4 Q floats d[0 .. 4 Q), Q <= 16:
// TC_SQ its "%0, ..., %(4 Q - 1)", TC_CQ its "+f" constraints.
#define TC_D4(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define TC_S1 "%0, %1, %2, %3"
#define TC_C1 TC_D4(0)
#define TC_S2 TC_S1 ", %4, %5, %6, %7"
#define TC_C2 TC_C1, TC_D4(4)
#define TC_S3 TC_S2 ", %8, %9, %10, %11"
#define TC_C3 TC_C2, TC_D4(8)
#define TC_S4 TC_S3 ", %12, %13, %14, %15"
#define TC_C4 TC_C3, TC_D4(12)
#define TC_S5 TC_S4 ", %16, %17, %18, %19"
#define TC_C5 TC_C4, TC_D4(16)
#define TC_S6 TC_S5 ", %20, %21, %22, %23"
#define TC_C6 TC_C5, TC_D4(20)
#define TC_S7 TC_S6 ", %24, %25, %26, %27"
#define TC_C7 TC_C6, TC_D4(24)
#define TC_S8 TC_S7 ", %28, %29, %30, %31"
#define TC_C8 TC_C7, TC_D4(28)
#define TC_S9 TC_S8 ", %32, %33, %34, %35"
#define TC_C9 TC_C8, TC_D4(32)
#define TC_S10 TC_S9 ", %36, %37, %38, %39"
#define TC_C10 TC_C9, TC_D4(36)
#define TC_S11 TC_S10 ", %40, %41, %42, %43"
#define TC_C11 TC_C10, TC_D4(40)
#define TC_S12 TC_S11 ", %44, %45, %46, %47"
#define TC_C12 TC_C11, TC_D4(44)
#define TC_S13 TC_S12 ", %48, %49, %50, %51"
#define TC_C13 TC_C12, TC_D4(48)
#define TC_S14 TC_S13 ", %52, %53, %54, %55"
#define TC_C14 TC_C13, TC_D4(52)
#define TC_S15 TC_S14 ", %56, %57, %58, %59"
#define TC_C15 TC_C14, TC_D4(56)
#define TC_S16 TC_S15 ", %60, %61, %62, %63"
#define TC_C16 TC_C15, TC_D4(60)

template <int N>
__device__ void wgmma_bf16_rs(float (&d)[N / 2], const uint32_t (&a)[4],
                              uint64_t desc_b, int scale_d);
template <int N>
__device__ void wgmma_bf16_ss(float (&d)[N / 2], uint64_t desc_a,
                              uint64_t desc_b, int scale_d);

// d (+)= a b on one m64nNk16 tile, float32 accumulators: A (bf16) from
// registers, the m16n8k16 fragment of each warp's 16 rows; B (bf16)
// K-major from shared memory by descriptor.  Q = N / 8; A0..P are the
// operand numbers that follow the accumulator's 4 Q.
#define TC_WGMMA_RS(N, Q, A0, A1, A2, A3, B, P)                             \
  template <>                                                               \
  __device__ __forceinline__ void wgmma_bf16_rs<N>(                         \
      float(&d)[N / 2], const uint32_t(&a)[4], uint64_t desc_b,             \
      int scale_d) {                                                        \
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %" #P ", 0;\n"           \
                 "wgmma.mma_async.sync.aligned.m64n" #N                     \
                 "k16.f32.bf16.bf16 {" TC_S##Q "}, {%" #A0 ", %" #A1        \
                 ", %" #A2 ", %" #A3 "}, %" #B ", p, 1, 1, 0;\n}\n"         \
                 : TC_C##Q                                                  \
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]),              \
                   "l"(desc_b), "r"(scale_d));                              \
  }
TC_WGMMA_RS(64, 8, 32, 33, 34, 35, 36, 37)
TC_WGMMA_RS(80, 10, 40, 41, 42, 43, 44, 45)
TC_WGMMA_RS(96, 12, 48, 49, 50, 51, 52, 53)
TC_WGMMA_RS(128, 16, 64, 65, 66, 67, 68, 69)
#undef TC_WGMMA_RS

// d (+)= a b on one m64nNk16 tile, float32 accumulators: A and B (bf16)
// K-major from shared memory by descriptor.
#define TC_WGMMA_SS(N, Q, A, B, P)                                          \
  template <>                                                               \
  __device__ __forceinline__ void wgmma_bf16_ss<N>(                         \
      float(&d)[N / 2], uint64_t desc_a, uint64_t desc_b, int scale_d) {    \
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %" #P ", 0;\n"           \
                 "wgmma.mma_async.sync.aligned.m64n" #N                     \
                 "k16.f32.bf16.bf16 {" TC_S##Q "}, %" #A ", %" #B           \
                 ", p, 1, 1, 0, 0;\n}\n"                                    \
                 : TC_C##Q                                                  \
                 : "l"(desc_a), "l"(desc_b), "r"(scale_d));                 \
  }
TC_WGMMA_SS(64, 8, 32, 33, 34)
TC_WGMMA_SS(128, 16, 64, 65, 66)
#undef TC_WGMMA_SS

}  // namespace hopper
}  // namespace tabcorr
