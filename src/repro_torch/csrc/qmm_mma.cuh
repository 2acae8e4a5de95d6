// The tensor-core QMM mainloop's device helpers, shared by K1
// binary_qmm.cu, K3 popcount_qmm.cu, K4 bitserial_qmm.cu and the scores
// kernel binary_attn.cu.  The int8
// design is K2 fused_qmm.cu's, which keeps its own copies of the staging and
// expansion helpers:
//  * cp.async copies of packed words (or int8 bytes) into shared memory,
//    zero-filled past the ragged edges, so the later phases need no edge
//    branches;
//  * expansion of unsigned mantissa bit-planes into u8 tiles, K contiguous
//    (a row per output row or column, rows padded by 16 bytes so ldmatrix
//    and the stores hit every bank);
//  * ldmatrix fragments multiplied by mma.sync m16n8k32 into int32.
// K3 and the scores kernel multiply the packed words themselves (mma_b1:
// AND, then popcount).
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace qmm {

// ---- staging -------------------------------------------------------------

// 16 bytes from src to shared dst, or 16 zero bytes (src is not read) when !ok.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool ok) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(ok ? 16 : 0));
}

// 4 bytes from src to shared dst, or 4 zero bytes when !ok.
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool ok) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src),
               "r"(ok ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// ---- fragments and products ----------------------------------------------

__device__ __forceinline__ void ldsm_x4(uint32_t& r0, uint32_t& r1, uint32_t& r2, uint32_t& r3,
                                        const void* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
               : "r"(s));
}

// c += a (16x32, row) * b (32x8, col): u8 x u8, or s8 x u8 (signed A, the
// activations; unsigned B, the weight bytes) where SIGNED_A.
template <bool SIGNED_A>
__device__ __forceinline__ void mma_k32(int (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                        uint32_t b1) {
  if constexpr (SIGNED_A) {
    asm volatile(
        "mma.sync.aligned.m16n8k32.row.col.s32.s8.u8.s32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  } else {
    asm volatile(
        "mma.sync.aligned.m16n8k32.row.col.s32.u8.u8.s32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
}

// c += popc(a & b) summed over K: a (16x256 bits, row), b (256x8 bits, col).
// A word of a register holds 32 consecutive K bits; the fragments are the
// u8 ones of mma_k32 with words for bytes: a = a[g][t], a[g+8][t],
// a[g][t+4], a[g+8][t+4] and b = b[t][g], b[t+4][g] of an 8-word K step
// (g = lane / 4, t = lane % 4).
__device__ __forceinline__ void mma_b1(int (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// ---- bits to bytes -------------------------------------------------------

// The 4 bits of a nibble n (0 .. 15) as bytes 0 .. 3, each 0 or 1.
__device__ __forceinline__ uint32_t nibble_bytes(uint32_t n) {
  return (n * 0x00204081u) & 0x01010101u;
}

// 8x8 bit-matrix transpose of x = lo | hi << 32: bit 8r + c goes to bit
// 8c + r (three block-swap rounds, in 32-bit halves).
__device__ __forceinline__ void transpose8x8(uint32_t& lo, uint32_t& hi) {
  uint32_t t = (lo ^ (lo >> 7)) & 0x00AA00AAu;
  lo ^= t ^ (t << 7);
  t = (hi ^ (hi >> 7)) & 0x00AA00AAu;
  hi ^= t ^ (t << 7);
  t = (lo ^ (lo >> 14)) & 0x0000CCCCu;
  lo ^= t ^ (t << 14);
  t = (hi ^ (hi >> 14)) & 0x0000CCCCu;
  hi ^= t ^ (t << 14);
  t = (lo ^ (hi << 4)) & 0xF0F0F0F0u;
  lo ^= t;
  hi ^= t >> 4;
}

// Byte b of y[b'] = byte b' of x_b: a 4x4 byte transpose.
__device__ __forceinline__ void transpose4x4_bytes(uint32_t x0, uint32_t x1, uint32_t x2,
                                                   uint32_t x3, uint32_t (&y)[4]) {
  const uint32_t t0 = __byte_perm(x0, x1, 0x5140), t1 = __byte_perm(x0, x1, 0x7362);
  const uint32_t t2 = __byte_perm(x2, x3, 0x5140), t3 = __byte_perm(x2, x3, 0x7362);
  y[0] = __byte_perm(t0, t2, 0x5410);
  y[1] = __byte_perm(t0, t2, 0x7632);
  y[2] = __byte_perm(t1, t3, 0x5410);
  y[3] = __byte_perm(t1, t3, 0x7632);
}

// The staged words of one K word position (P = 1 plane, or 8 plane slots
// `stride` apart), masked.
template <int P>
__device__ __forceinline__ void gather_planes(const uint32_t* src, int stride, uint32_t mask,
                                              uint32_t (&w)[P]) {
#pragma unroll
  for (int i = 0; i < P; ++i) w[i] = src[i * stride] & mask;
}

// The 32 mantissas of one word position as bytes: byte v of o[q] is
// sum_i bit (4q + v) of w[i] << i.  One plane by the nibble spread, 8 by
// two 4x4 byte transposes and four 8x8 bit transposes.
template <int P>
__device__ __forceinline__ void spread_planes(const uint32_t (&w)[P], uint32_t (&o)[8]) {
  static_assert(P == 1 || P == 8, "one plane, or 8 plane slots");
  if constexpr (P == 1) {
    // nibble 2b of w is byte b of lo, nibble 2b+1 byte b of hi
    const uint32_t lo = w[0] & 0x0F0F0F0Fu, hi = (w[0] >> 4) & 0x0F0F0F0Fu;
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      o[2 * b] = nibble_bytes(__byte_perm(lo, 0u, 0x4440 | b));
      o[2 * b + 1] = nibble_bytes(__byte_perm(hi, 0u, 0x4440 | b));
    }
  } else {
    uint32_t lo[4], hi[4];
    transpose4x4_bytes(w[0], w[1], w[2], w[3], lo);
    transpose4x4_bytes(w[4], w[5], w[6], w[7], hi);
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      // byte i = byte b of plane i: row i of an 8x8 bit matrix over K 8b .. 8b+7
      transpose8x8(lo[b], hi[b]);
      o[2 * b] = lo[b];
      o[2 * b + 1] = hi[b];
    }
  }
}

// 32 bytes to a u8 tile row; the two 16-byte halves go out in an order that
// alternates every 4 words, so a quarter-warp's stores hit all 32 banks.
__device__ __forceinline__ void store_row32(uint8_t* dst, const uint32_t (&o)[8], int ww) {
  const uint4 h0 = make_uint4(o[0], o[1], o[2], o[3]);
  const uint4 h1 = make_uint4(o[4], o[5], o[6], o[7]);
  uint4* d = reinterpret_cast<uint4*>(dst);
  if (ww & 4) {
    d[1] = h1;
    d[0] = h0;
  } else {
    d[0] = h0;
    d[1] = h1;
  }
}

// ---- the block's tile ----------------------------------------------------

// BM x BN output tile; warps WM x WN over it, times KS warp groups that
// split each stage's k32 steps (their sums are added at the end); KC words
// of K (32 KC bytes of the u8 tiles) per stage, ST stages in flight.
template <int BM_, int BN_, int WM_, int WN_, int KS_, int KC_, int ST_>
struct Tile {
  static constexpr int BM = BM_, BN = BN_, WM = WM_, WN = WN_, KS = KS_, KC = KC_, ST = ST_;
  static constexpr int THREADS = 32 * WM * WN * KS;
  static constexpr int MIN_BLOCKS = 65536 / (THREADS * 128);  // at most 128 registers a thread
  static constexpr int TM = BM / WM, TN = BN / WN;  // one warp's tile
  static constexpr int MI = TM / 16, NI = TN / 8;   // its m16n8 fragments
  static constexpr int LDS = 32 * KC + 16;          // u8 tile row stride in bytes
  // int32 sums the warp groups 1.. hand to group 0
  static constexpr int RED_BYTES = (KS - 1) * WM * WN * 32 * MI * NI * 16;
  static_assert(TM % 16 == 0 && TN % 16 == 0 && KC % 4 == 0 && KC % KS == 0 && BN % 4 == 0,
                "tile shape (B fragments are loaded two m16n8 tiles at a time)");
  static_assert(THREADS % BN == 0, "a fixed weight column per thread");
  static_assert(ST >= 3, "a stage is staged, expanded and multiplied in three iterations");
};

// One stage on the tensor cores: this warp's k32 steps of the u8 tiles sA
// (rows of K bytes, LDS apart) and sB (W^T, the same).  Rows of sA from
// a_rows on are read as row a_rows - 1: they reach only output rows that
// are never stored, and the buffer need not hold them.
template <class T, bool SIGNED_A>
__device__ __forceinline__ void mma_stage(int (&acc)[T::MI][T::NI][4], const uint8_t* sA,
                                          const uint8_t* sB, int a_rows, int lane, int wm,
                                          int wn, int wk) {
  constexpr int LDS = T::LDS;
#pragma unroll
  for (int j = 0; j < T::KC / T::KS; ++j) {
    const int kk = j * T::KS + wk;
    uint32_t af[T::MI][4], bf[T::NI][2];
#pragma unroll
    for (int mi = 0; mi < T::MI; ++mi) {
      const int row = min(wm * T::TM + mi * 16 + (lane & 7) + ((lane >> 3) & 1) * 8, a_rows - 1);
      ldsm_x4(af[mi][0], af[mi][1], af[mi][2], af[mi][3],
              sA + row * LDS + kk * 32 + (lane >> 4) * 16);
    }
#pragma unroll
    for (int ni = 0; ni + 1 < T::NI; ni += 2) {
      const int col = wn * T::TN + ni * 8 + (lane & 7) + (lane >> 4) * 8;
      ldsm_x4(bf[ni][0], bf[ni][1], bf[ni + 1][0], bf[ni + 1][1],
              sB + col * LDS + kk * 32 + ((lane >> 3) & 1) * 16);
    }
#pragma unroll
    for (int mi = 0; mi < T::MI; ++mi)
#pragma unroll
      for (int ni = 0; ni < T::NI; ++ni)
        mma_k32<SIGNED_A>(acc[mi][ni], af[mi], bf[ni][0], bf[ni][1]);
  }
}

// After the last stage: warp groups 1.. leave their sums in `red`
// (T::RED_BYTES of shared memory no longer in use) and group 0 adds them.
// Every thread calls it; returns true in the warps of group 0, which then
// hold the block's tile.
template <class T>
__device__ __forceinline__ bool reduce_ks(int (&acc)[T::MI][T::NI][4], int* red, int lane,
                                          int wm, int wn, int wk) {
  if constexpr (T::KS == 1) {
    return true;
  } else {
    constexpr int PER = T::MI * T::NI * 4;
    __syncthreads();  // every warp is done with the tiles `red` overlays
    if (wk > 0) {
      int* dst = red + (((wk - 1) * T::WM * T::WN + wm * T::WN + wn) * 32 + lane) * PER;
#pragma unroll
      for (int mi = 0; mi < T::MI; ++mi)
#pragma unroll
        for (int ni = 0; ni < T::NI; ++ni)
#pragma unroll
          for (int e = 0; e < 4; ++e) dst[(mi * T::NI + ni) * 4 + e] = acc[mi][ni][e];
    }
    __syncthreads();
    if (wk > 0) return false;
#pragma unroll
    for (int q = 1; q < T::KS; ++q) {
      const int* src = red + (((q - 1) * T::WM * T::WN + wm * T::WN + wn) * 32 + lane) * PER;
#pragma unroll
      for (int mi = 0; mi < T::MI; ++mi)
#pragma unroll
        for (int ni = 0; ni < T::NI; ++ni)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mi][ni][e] += src[(mi * T::NI + ni) * 4 + e];
    }
    return true;
  }
}

// The warp's int32 fragments to out (M, N) row-major at the block's corner
// (m0, n0), masked at the ragged edges; added atomically where `atomic`
// (blocks that split K add their partial sums: exact, in any order).
// c0, c1 of an m16n8 fragment sit at row g, columns 2*t4 + {0, 1}; c2, c3
// eight rows lower.
template <class T>
__device__ __forceinline__ void store_tile(const int (&acc)[T::MI][T::NI][4], int32_t* out,
                                           int m0, int n0, int M, int N, bool atomic, int lane,
                                           int wm, int wn) {
  const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int mi = 0; mi < T::MI; ++mi) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + wm * T::TM + mi * 16 + g + 8 * h;
      if (m >= M) continue;
#pragma unroll
      for (int ni = 0; ni < T::NI; ++ni) {
        const int n = n0 + wn * T::TN + ni * 8 + 2 * t4;
        int32_t* o = out + static_cast<size_t>(m) * N + n;
        const int v0 = acc[mi][ni][2 * h], v1 = acc[mi][ni][2 * h + 1];
        if (atomic) {
          if (n < N) atomicAdd(o, v0);
          if (n + 1 < N) atomicAdd(o + 1, v1);
        } else if (n + 1 < N && !(N & 1)) {
          *reinterpret_cast<int2*>(o) = make_int2(v0, v1);
        } else {
          if (n < N) o[0] = v0;
          if (n + 1 < N) o[1] = v1;
        }
      }
    }
  }
}

// ---- host ----------------------------------------------------------------

// Lets `kernel` take up to `bytes` of dynamic shared memory, once per device
// (`done` keeps one bit a device for this kernel).  A failed call's error is
// cleared here, where it is reported, so a later launch does not report it
// again.
template <class F>
inline cudaError_t allow_smem(F* kernel, size_t bytes, unsigned& done) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 32 && (done & (1u << dev))) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(bytes));
  if (err != cudaSuccess) {
    cudaGetLastError();
    return err;
  }
  if (dev < 32) done |= 1u << dev;
  return cudaSuccess;
}

}  // namespace qmm
