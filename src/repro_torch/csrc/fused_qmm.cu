// K2 fused_qmm: bit-serial QMM with the affine epilogue fused.
//
// Replaces the Pallas TPU kernel src/repro/kernels/fused_qmm.py
// (fused_qmm / _kernel, pallas_call at :180).  Same function as
// repro_torch.kernels.ref.fused_qmm_ref:
//     acc[m, n] = sum_ij 2^(i+j) sum_w popc(A_i[m, w] & B_j[w, n])
//     row[m]    = sum_i  2^i     sum_w popc(A_i[m, w])
//     col[n]    = sum_j  2^j     sum_w popc(B_j[w, n])
//     out = ((acc*(a1*a2) + (a1*g2)*row) + (g1*a2)*col) + (g1*g2)*K
// a_planes (a_bits, M, Kw) and b_planes (b_bits, Kw, N) are 32-bit words of
// unsigned mantissa bit-planes, bit v of word w holding K index 32w + v;
// a_scale/a_offset (M), w_scale/w_offset (N) float32; out (M, N) float32 is
// the only write to device memory.
//
// What bounds it on an H100: at decode (M <= 16) the packed weight planes,
// read once from device memory (3.35 TB/s); at prefill the operations.  The
// cross-plane sum sum_ij 2^(i+j) A_i B_j is the product X @ W of the unsigned
// mantissas X = sum_i 2^i A_i and W = sum_j 2^j B_j (both below 256), so the
// integer core runs on the int8 tensor cores, exactly, in int32.  What the
// kernel spends its time on is turning bits into those bytes on the CUDA
// cores (about one operation per weight bit, a few per activation byte),
// latency-bound at 8-16 warps an SM, not the tensor cores.
//
// Design:
//  * One block owns a BM x BN tile of out and walks the whole of K, so the
//    MM, rowsum and colsum are finished in the block and the epilogue runs
//    in the same launch (no split-K across blocks).  Every N-block expands
//    its activation rows again and every M-block its weight columns, so the
//    tiles trade the two: 16 rows for M <= 64 (32 or 64 columns), 32 or 64
//    rows x 128 columns above (see the tile list).  KS warp groups split
//    each stage's k32 steps and add their sums at the end.
//  * Staging: each stage copies KC words of every plane of the block's
//    rows and columns into shared memory with cp.async (16-byte copies
//    where Kw / N and the base address allow, else 4-byte).  Copies past
//    the ragged M / N / Kw edges and into the plane slots past a_bits /
//    b_bits zero-fill, so the expansion and the mma need no edge branches.
//    ST stages are in flight.
//  * Expansion: the staged words become u8 mantissa tiles X[BM][32*KC] and
//    W^T[BN][32*KC], K contiguous (the row / col operands of mma), a word
//    per thread: one plane by a nibble spread (n * 0x00204081 & 0x01010101
//    puts 4 bits in 4 bytes), 2 .. 8 planes by two 4x4 byte transposes and
//    four 8x8 bit transposes over 8 plane slots.  Row and column sums come
//    from the same words (__popc) or bytes (__dp4a).  The last word's bits
//    past K are masked.
//  * Product: mma.sync m16n8k32 u8 x u8 -> s32 on ldmatrix fragments (rows
//    padded by 16 bytes: conflict-free); one packed word is one k32 step.
//    The int32 sum wraps past 2^31 like the TPU kernel's.
//  * Software pipeline, one barrier per stage: the tensor cores take stage
//    s from one u8 buffer while the CUDA cores fill the other with stage s+1.
//  * Epilogue in registers on the mma fragments, with __fmul_rn / __fadd_rn:
//    nvcc would otherwise contract mul+add into fma, and the result would not
//    equal the plain version, which rounds every product and sum on its own.
//    The scales and offsets are staged with the first stage.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int MAX_BITS = 8;

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool ok) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(ok ? 16 : 0));
}

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

__device__ __forceinline__ void ldsm_x4(uint32_t& r0, uint32_t& r1, uint32_t& r2, uint32_t& r3,
                                        const void* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
               : "r"(s));
}

__device__ __forceinline__ void mma_u8(int (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.u8.u8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

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
// two 4x4 byte transposes and four 8x8 bit transposes.  Returns the sum of
// the 32 bytes (P = 8; one plane's is its popcount).
template <int P>
__device__ __forceinline__ int spread_planes(const uint32_t (&w)[P], uint32_t (&o)[8]) {
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
  if constexpr (P == 1) {
    return __popc(w[0]);
  } else {
    unsigned sum = 0u;
#pragma unroll
    for (int q = 0; q < 8; ++q) sum = __dp4a(o[q], 0x01010101u, sum);
    return static_cast<int>(sum);
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

// BM x BN output tile; warps WM x WN over it, times KS warp groups that
// split each stage's k32 steps (their sums are added at the end); KC words
// of K per stage, ST stages in flight.
template <int BM_, int BN_, int WM_, int WN_, int KS_, int KC_, int ST_>
struct Tile {
  static constexpr int BM = BM_, BN = BN_, WM = WM_, WN = WN_, KS = KS_, KC = KC_, ST = ST_;
  static constexpr int THREADS = 32 * WM * WN * KS;
  static constexpr int MIN_BLOCKS = 65536 / (THREADS * 128);  // at most 128 registers a thread
  static constexpr int TM = BM / WM, TN = BN / WN;  // one warp's tile
  static constexpr int MI = TM / 16, NI = TN / 8;   // its m16n8 fragments
  static constexpr int LDS = 32 * KC + 16;          // u8 tile row stride in bytes
  static constexpr int U8 = (BM + BN) * LDS;        // one u8 buffer: X rows, then W^T rows
  static_assert(TM % 16 == 0 && TN % 16 == 0 && KC % 4 == 0 && KC % KS == 0 && BN % 4 == 0,
                "tile shape (B fragments are loaded two m16n8 tiles at a time)");
  static_assert(THREADS % BN == 0, "a fixed weight column per thread");
  static_assert(ST >= 3, "a stage is staged, expanded and multiplied in three iterations");
  static_assert((KS - 1) * WM * WN * 32 * MI * NI * 16 <= 2 * U8,
                "the warp groups' sums fit where the u8 tiles were");

  // Dynamic shared memory: ST raw stages (plane slots of each side), two u8
  // buffers, the sums, the scales and offsets.
  static size_t smem_bytes(int a_slots, int b_slots, int bmr) {
    return static_cast<size_t>(ST) * 4 * (a_slots * bmr * KC + b_slots * KC * BN) + 2 * U8 +
           12 * (BM + BN);
  }
};

// PA / PB: plane slots staged for each side, 1 (one plane) or 8 (2 .. 8
// planes, the slots past a_bits / b_bits zero).
template <class T, int PA, int PB>
__global__ void __launch_bounds__(T::THREADS, T::MIN_BLOCKS)
fused_qmm_kernel(const uint32_t* __restrict__ ap, const uint32_t* __restrict__ bp,
                 const float* __restrict__ a_scale, const float* __restrict__ a_offset,
                 const float* __restrict__ w_scale, const float* __restrict__ w_offset,
                 float* __restrict__ out, int a_bits, int b_bits, int M, int KW, int N,
                 int k_logical, int bmr, int a_vec, int b_vec) {
  constexpr int BM = T::BM, BN = T::BN, KC = T::KC, ST = T::ST, LDS = T::LDS, U8 = T::U8;
  constexpr int THREADS = T::THREADS;
  extern __shared__ __align__(16) unsigned char smem[];
  const int a_words = PA * bmr * KC;
  const int stage_words = a_words + PB * KC * BN;
  uint32_t* raw = reinterpret_cast<uint32_t*>(smem);
  uint8_t* u8 = smem + static_cast<size_t>(ST) * stage_words * 4;
  int* srow = reinterpret_cast<int*>(u8 + 2 * U8);
  int* scol = srow + BM;
  float* sa_scale = reinterpret_cast<float*>(scol + BN);
  float* sa_offset = sa_scale + BM;
  float* sw_scale = sa_offset + BM;
  float* sw_offset = sw_scale + BN;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int wk = warp / (T::WM * T::WN), wm = (warp / T::WN) % T::WM, wn = warp % T::WN;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const int nst = (KW + KC - 1) / KC;
  const uint32_t tail = (k_logical & 31) ? (1u << (k_logical & 31)) - 1u : ~0u;

  for (int i = tid; i < BM + BN; i += THREADS) srow[i] = 0;
  // the epilogue's scales and offsets travel with the first stage
  for (int i = tid; i < BM; i += THREADS) {
    const bool ok = m0 + i < M;
    cp_async4(sa_scale + i, ok ? a_scale + m0 + i : a_scale, ok);
    cp_async4(sa_offset + i, ok ? a_offset + m0 + i : a_offset, ok);
  }
  for (int i = tid; i < BN; i += THREADS) {
    const bool ok = n0 + i < N;
    cp_async4(sw_scale + i, ok ? w_scale + n0 + i : w_scale, ok);
    cp_async4(sw_offset + i, ok ? w_offset + n0 + i : w_offset, ok);
  }
  __syncthreads();

  // Stage s: KC words of each plane of the block's bmr rows and BN columns,
  // zero past the ragged edges and in the plane slots past a_bits / b_bits.
  auto load_stage = [&](int s) {
    if (s < nst) {
      uint32_t* dA = raw + (s % ST) * stage_words;
      uint32_t* dB = dA + a_words;
      const int w0 = s * KC;
      const size_t a_plane = static_cast<size_t>(M) * KW, b_plane = static_cast<size_t>(KW) * N;
      constexpr int AV = KC / 4, BV = BN / 4;  // 16-byte chunks per row
      if (a_vec) {
        for (int i = tid; i < bmr * AV; i += THREADS) {
          const int r = i / AV, c = 4 * (i % AV);
          const bool ok = m0 + r < M && w0 + c < KW;
          const uint32_t* src = ap + (ok ? static_cast<size_t>(m0 + r) * KW + w0 + c : 0);
#pragma unroll
          for (int p = 0; p < PA; ++p) {
            const bool q = ok && p < a_bits;
            cp_async16(dA + (p * bmr + r) * KC + c, q ? src + p * a_plane : ap, q);
          }
        }
      } else {
        for (int i = tid; i < bmr * KC; i += THREADS) {
          const int r = i / KC, c = i % KC;
          const bool ok = m0 + r < M && w0 + c < KW;
          const uint32_t* src = ap + (ok ? static_cast<size_t>(m0 + r) * KW + w0 + c : 0);
#pragma unroll
          for (int p = 0; p < PA; ++p) {
            const bool q = ok && p < a_bits;
            cp_async4(dA + (p * bmr + r) * KC + c, q ? src + p * a_plane : ap, q);
          }
        }
      }
      if (b_vec) {
        for (int i = tid; i < KC * BV; i += THREADS) {
          const int ww = i / BV, c = 4 * (i % BV);
          const bool ok = w0 + ww < KW && n0 + c < N;
          const uint32_t* src = bp + (ok ? static_cast<size_t>(w0 + ww) * N + n0 + c : 0);
#pragma unroll
          for (int p = 0; p < PB; ++p) {
            const bool q = ok && p < b_bits;
            cp_async16(dB + (p * KC + ww) * BN + c, q ? src + p * b_plane : bp, q);
          }
        }
      } else {
        for (int i = tid; i < KC * BN; i += THREADS) {
          const int ww = i / BN, c = i % BN;
          const bool ok = w0 + ww < KW && n0 + c < N;
          const uint32_t* src = bp + (ok ? static_cast<size_t>(w0 + ww) * N + n0 + c : 0);
#pragma unroll
          for (int p = 0; p < PB; ++p) {
            const bool q = ok && p < b_bits;
            cp_async4(dB + (p * KC + ww) * BN + c, q ? src + p * b_plane : bp, q);
          }
        }
      }
    }
    cp_async_commit();
  };

  int acc[T::MI][T::NI][4];
#pragma unroll
  for (int mi = 0; mi < T::MI; ++mi)
#pragma unroll
    for (int ni = 0; ni < T::NI; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0;
  // A thread expands words of the same weight column, and of the same
  // activation row for each u, at every stage, so registers hold its share
  // of their sums.
  constexpr int NA = (BM * KC + THREADS - 1) / THREADS;
  int rs[NA];
#pragma unroll
  for (int u = 0; u < NA; ++u) rs[u] = 0;
  int cs = 0;
  const int cb = tid % BN;

  // Stage s: staged words -> u8 buffer s % 2, and the row and column sums.
  // (u8 rows past bmr are never written: they reach only output rows that
  // are never stored.)
  auto expand = [&](int s) {
    const uint32_t* rA = raw + (s % ST) * stage_words;
    const uint32_t* rB = rA + a_words;
    uint8_t* sA8 = u8 + (s & 1) * U8;
    uint8_t* sB8 = sA8 + BM * LDS;
    const int w0 = s * KC;
#pragma unroll
    for (int u = 0; u < NA; ++u) {
      const int idx = tid + u * THREADS;
      const int r = idx / KC, ww = idx % KC;
      if (idx < BM * KC && r < bmr) {
        uint32_t w[PA], o[8];
        gather_planes<PA>(rA + r * KC + ww, bmr * KC, w0 + ww == KW - 1 ? tail : ~0u, w);
        rs[u] += spread_planes<PA>(w, o);
        store_row32(sA8 + r * LDS + ww * 32, o, ww);
      }
    }
#pragma unroll
    for (int u = 0; u < (BN * KC + THREADS - 1) / THREADS; ++u) {
      const int idx = tid + u * THREADS;
      const int ww = idx / BN;
      if (idx < BN * KC) {
        uint32_t w[PB], o[8];
        gather_planes<PB>(rB + ww * BN + cb, KC * BN, w0 + ww == KW - 1 ? tail : ~0u, w);
        cs += spread_planes<PB>(w, o);
        store_row32(sB8 + cb * LDS + ww * 32, o, ww);
      }
    }
  };

  // Stage s: this warp's k32 steps of u8 buffer s % 2 on the tensor cores.
  auto multiply = [&](int s) {
    const uint8_t* sA8 = u8 + (s & 1) * U8;
    const uint8_t* sB8 = sA8 + BM * LDS;
#pragma unroll
    for (int j = 0; j < KC / T::KS; ++j) {
      const int kk = j * T::KS + wk;  // past KW the u8 tiles hold zero bytes
      uint32_t af[T::MI][4], bf[T::NI][2];
#pragma unroll
      for (int mi = 0; mi < T::MI; ++mi) {
        const int row = wm * T::TM + mi * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
        ldsm_x4(af[mi][0], af[mi][1], af[mi][2], af[mi][3],
                sA8 + row * LDS + kk * 32 + (lane >> 4) * 16);
      }
#pragma unroll
      for (int ni = 0; ni + 1 < T::NI; ni += 2) {
        const int col = wn * T::TN + ni * 8 + (lane & 7) + (lane >> 4) * 8;
        ldsm_x4(bf[ni][0], bf[ni][1], bf[ni + 1][0], bf[ni + 1][1],
                sB8 + col * LDS + kk * 32 + ((lane >> 3) & 1) * 16);
      }
#pragma unroll
      for (int mi = 0; mi < T::MI; ++mi)
#pragma unroll
        for (int ni = 0; ni < T::NI; ++ni) mma_u8(acc[mi][ni], af[mi], bf[ni][0], bf[ni][1]);
    }
  };

  // Software pipeline, one barrier per stage: while the tensor cores take
  // stage s, the CUDA cores expand stage s+1 and stage s+ST-1 is in flight.
  for (int s = 0; s < ST - 1; ++s) load_stage(s);
  cp_async_wait<ST - 2>();
  __syncthreads();
  if (nst > 0) expand(0);
  for (int s = 0; s < nst; ++s) {
    cp_async_wait<ST - 3>();
    __syncthreads();  // stage s+1 landed, stage s expanded, stage s-1 multiplied
    load_stage(s + ST - 1);
    multiply(s);
    if (s + 1 < nst) expand(s + 1);
  }
  cp_async_wait<0>();

#pragma unroll
  for (int u = 0; u < NA; ++u) {
    if (rs[u]) atomicAdd(&srow[(tid + u * THREADS) / KC], rs[u]);
  }
  if (cs) atomicAdd(&scol[cb], cs);
  __syncthreads();
  if (T::KS > 1) {
    // warp groups 1.. leave their sums where the u8 tiles were; group 0 adds them
    int* red = reinterpret_cast<int*>(u8);
    constexpr int PER = T::MI * T::NI * 4;
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
    if (wk > 0) return;
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
  }

  // c0, c1 of an m16n8 fragment sit at row g, columns 2*t4 + {0, 1}; c2, c3
  // eight rows lower.
  const float kf = static_cast<float>(k_logical);
#pragma unroll
  for (int mi = 0; mi < T::MI; ++mi) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = wm * T::TM + mi * 16 + g + 8 * h;
      const int m = m0 + r;
      if (m >= M) continue;
      const float a1 = sa_scale[r], g1 = sa_offset[r];
      const float rowf = __int2float_rn(srow[r]);
#pragma unroll
      for (int ni = 0; ni < T::NI; ++ni) {
        const int c = wn * T::TN + ni * 8 + 2 * t4;
        float v[2] = {0.f, 0.f};
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          if (n0 + c + e >= N) continue;
          const float a2 = sw_scale[c + e], g2 = sw_offset[c + e];
          const float t0 = __fmul_rn(__int2float_rn(acc[mi][ni][2 * h + e]), __fmul_rn(a1, a2));
          const float t1 = __fmul_rn(__fmul_rn(a1, g2), rowf);
          const float t2 = __fmul_rn(__fmul_rn(g1, a2), __int2float_rn(scol[c + e]));
          const float t3 = __fmul_rn(__fmul_rn(g1, g2), kf);
          v[e] = __fadd_rn(__fadd_rn(__fadd_rn(t0, t1), t2), t3);
        }
        float* o = out + static_cast<size_t>(m) * N + n0 + c;
        if (n0 + c + 1 < N && !(N & 1)) {
          *reinterpret_cast<float2*>(o) = make_float2(v[0], v[1]);
        } else {
          if (n0 + c < N) o[0] = v[0];
          if (n0 + c + 1 < N) o[1] = v[1];
        }
      }
    }
  }
}

struct Args {
  const uint32_t *ap, *bp;
  const float *as, *ao, *ws, *wo;
  float* out;
  int a_bits, b_bits, M, KW, N, k;
  cudaStream_t stream;
};

template <class T, int PA, int PB>
cudaError_t launch(const Args& a) {
  const int bmr = a.M < T::BM ? a.M : T::BM;
  const size_t smem = T::smem_bytes(PA, PB, bmr);
  if (smem > 48 * 1024) {
    // once per device, for the largest request this kernel can make
    static unsigned done = 0;
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    if (dev >= 32 || !(done & (1u << dev))) {
      err = cudaFuncSetAttribute(fused_qmm_kernel<T, PA, PB>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(T::smem_bytes(PA, PB, T::BM)));
      if (err != cudaSuccess) {
        cudaGetLastError();  // reported here, not again by a later launch
        return err;
      }
      if (dev < 32) done |= 1u << dev;
    }
  }
  const int a_vec = a.KW % 4 == 0 && reinterpret_cast<uintptr_t>(a.ap) % 16 == 0;
  const int b_vec = a.N % 4 == 0 && reinterpret_cast<uintptr_t>(a.bp) % 16 == 0;
  dim3 grid((a.N + T::BN - 1) / T::BN, (a.M + T::BM - 1) / T::BM);
  fused_qmm_kernel<T, PA, PB><<<grid, T::THREADS, smem, a.stream>>>(
      a.ap, a.bp, a.as, a.ao, a.ws, a.wo, a.out, a.a_bits, a.b_bits, a.M, a.KW, a.N, a.k, bmr,
      a_vec, b_vec);
  return cudaGetLastError();
}

// One kernel per side's plane slots: 1, or 8 for 2 .. 8 planes; T8, a tile
// with less shared memory, where the weights take 8 slots.
template <class T, class T8 = T>
cudaError_t launch_tile(const Args& a) {
  if (a.a_bits == 1) return a.b_bits == 1 ? launch<T, 1, 1>(a) : launch<T8, 1, 8>(a);
  return a.b_bits == 1 ? launch<T, 8, 1>(a) : launch<T8, 8, 8>(a);
}

// Tiles by M (BM, BN, warps along M and N, warp groups along K, words per
// stage, stages in flight, byte-split activation expansion).
// M <= 64 (decode, bound by the weight bytes, and short prompts): 16-row
// tiles, so a block expands at most 16 activation rows.  Where 32 columns
// make a grid of one block an SM at most, 32 x 32 words a stage; on larger
// grids 64 columns and 16 words a stage (half the blocks, two an SM); for
// weights of 2 .. 8 bits 32 columns and 16 words (shared memory).
using SmallTile = Tile<16, 32, 1, 2, 4, 32, 3>;
using SmallTileWide = Tile<16, 64, 1, 4, 2, 16, 4>;
using SmallTile16 = Tile<16, 32, 1, 2, 4, 16, 4>;
// Bound by the operations: 32 x 128, or 64 x 128 (half the blocks, each
// expanding a weight column for twice the rows) on grids of more than one
// block an SM.
using PrefillTile = Tile<32, 128, 2, 4, 2, 8, 3>;
using PrefillTile64 = Tile<64, 128, 2, 4, 2, 8, 3>;

// Streaming multiprocessors of the current device, read once per device.
int sm_count() {
  static int count[32] = {0};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev >= 32) return 132;
  if (!count[dev] &&
      cudaDeviceGetAttribute(&count[dev], cudaDevAttrMultiProcessorCount, dev) != cudaSuccess) {
    cudaGetLastError();
    return 132;
  }
  return count[dev];
}

}  // namespace

extern "C" {

// Returns the cudaError_t of the launch; a_bits and b_bits must be 1..8.
int fused_qmm_launch(const void* a_planes, const void* b_planes, const void* a_scale,
                     const void* a_offset, const void* w_scale, const void* w_offset,
                     void* out, int a_bits, int b_bits, int M, int KW, int N,
                     int k_logical, void* stream) {
  if (a_bits < 1 || a_bits > MAX_BITS || b_bits < 1 || b_bits > MAX_BITS) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Args a{static_cast<const uint32_t*>(a_planes), static_cast<const uint32_t*>(b_planes),
               static_cast<const float*>(a_scale),     static_cast<const float*>(a_offset),
               static_cast<const float*>(w_scale),     static_cast<const float*>(w_offset),
               static_cast<float*>(out),               a_bits, b_bits, M, KW, N, k_logical,
               static_cast<cudaStream_t>(stream)};
  if (M <= 64) {
    const long blocks = static_cast<long>((N + SmallTile::BN - 1) / SmallTile::BN) *
                        ((M + SmallTile::BM - 1) / SmallTile::BM);
    return blocks <= sm_count() ? launch_tile<SmallTile, SmallTile16>(a)
                                : launch_tile<SmallTileWide, SmallTile16>(a);
  }
  const long blocks = static_cast<long>((N + PrefillTile::BN - 1) / PrefillTile::BN) *
                      ((M + PrefillTile::BM - 1) / PrefillTile::BM);
  return blocks > sm_count() ? launch_tile<PrefillTile64, PrefillTile>(a)
                             : launch_tile<PrefillTile>(a);
}

}  // extern "C"
