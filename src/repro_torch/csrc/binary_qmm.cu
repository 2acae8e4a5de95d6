// K1 binary_qmm: int8 activations x packed 1-bit weights -> int32.
//
// Replaces the Pallas TPU kernel src/repro/kernels/binary_qmm.py
// (binary_qmm / _kernel, pallas_call at :95).  Same function as
// repro_torch.kernels.ref.binary_qmm_ref:
//     out[m, n] = sum_k a[m, k] * bit(w_packed[k / 32, n], k % 32)
// a (M, K) int8 row-major, w_packed (ceil(K/32), N) 32-bit words row-major,
// out (M, N) int32.  The affine epilogue runs after the kernel
// (repro_torch.core.flow_abstraction.qmm_flow), as on the TPU.
//
// What bounds it on an H100: at decode (M = the slot count, 1..4) the packed
// weights dominate the bytes -- K*N/8 bytes against 2*M*K*N operations -- so
// the kernel is bound by device memory (3.35 TB/s); at prefill (M = the
// prompt length, ~128) the int8 operations dominate (1,979 TOP/s on the
// tensor cores).
//
// Design (first, simple version; no tensor cores yet):
//  * One block owns a tile of BN = 64 output columns by BM = 4*RM rows and
//    loops over K inside the block: that loop replaces the TPU's sequential
//    K grid axis, since Hopper blocks run in no order.
//  * Each stage copies KC packed words x BN columns and the matching BM x
//    32*KC int8 activations into shared memory; ragged M / N / K edges are
//    masked here (zeros), so the caller pads nothing.
//  * Each thread owns one column and RM rows.  A packed word is expanded
//    4 bits at a time into four {0,1} bytes with one multiply and one mask,
//    then __dp4a multiplies them against four int8 activations and adds
//    into an int32 accumulator.  A warp shares its rows, so activation reads
//    from shared memory are broadcasts.
//  * Decode tiles are few (N / 64), so K is split over blockIdx.z until the
//    grid covers the SMs; split partials meet with integer atomicAdd, which
//    is exact and order-free.  The weights are read once either way.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int BN = 64;  // output columns per block, one per thread column
constexpr int RG = 4;   // row groups per block
constexpr int THREADS = BN * RG;
constexpr int KC = 8;   // packed words (256 K) per shared-memory stage

// Four weight bits -> four bytes in {0, 1}: bit q of the nibble moves to bit
// 8q (the shifted copies 0, 7, 14, 21 do not overlap, so no carries).
__device__ __forceinline__ int expand_nibble(uint32_t nib) {
  return static_cast<int>((nib * 0x00204081u) & 0x01010101u);
}

template <int RM>
__global__ void __launch_bounds__(THREADS)
binary_qmm_kernel(const int8_t* __restrict__ a, const uint32_t* __restrict__ wp,
                  int32_t* __restrict__ out, int M, int K, int N, int KW,
                  int kw_split, int use_atomic) {
  constexpr int BM = RG * RM;
  __shared__ uint32_t sW[KC][BN];
  __shared__ __align__(16) int8_t sA[BM][KC * 32];

  const int tx = threadIdx.x % BN;
  const int ty = threadIdx.x / BN;
  const int n0 = blockIdx.x * BN;
  const int m0 = blockIdx.y * BM;
  const int w_begin = blockIdx.z * kw_split;
  const int w_end = min(w_begin + kw_split, KW);
  const bool k_words = (K & 3) == 0;  // rows of a are whole 4-byte words

  int acc[RM];
#pragma unroll
  for (int r = 0; r < RM; ++r) acc[r] = 0;

  for (int w0 = w_begin; w0 < w_end; w0 += KC) {
    for (int i = threadIdx.x; i < KC * BN; i += THREADS) {
      const int ww = i / BN, nn = i % BN;
      const int gw = w0 + ww, gn = n0 + nn;
      sW[ww][nn] = (gw < w_end && gn < N) ? wp[(size_t)gw * N + gn] : 0u;
    }
    if (k_words) {
      int* sA32 = reinterpret_cast<int*>(&sA[0][0]);
      for (int i = threadIdx.x; i < BM * KC * 8; i += THREADS) {
        const int r = i / (KC * 8), c = i % (KC * 8);
        const int gm = m0 + r, gk = w0 * 32 + c * 4;
        sA32[i] = (gm < M && gk < K)
                      ? *reinterpret_cast<const int*>(a + (size_t)gm * K + gk)
                      : 0;
      }
    } else {
      for (int i = threadIdx.x; i < BM * KC * 32; i += THREADS) {
        const int r = i / (KC * 32), c = i % (KC * 32);
        const int gm = m0 + r, gk = w0 * 32 + c;
        sA[r][c] = (gm < M && gk < K) ? a[(size_t)gm * K + gk] : int8_t(0);
      }
    }
    __syncthreads();

#pragma unroll 2
    for (int ww = 0; ww < KC; ++ww) {
      const uint32_t bits = sW[ww][tx];
      int e[8];
#pragma unroll
      for (int q = 0; q < 8; ++q) e[q] = expand_nibble((bits >> (4 * q)) & 0xFu);
#pragma unroll
      for (int r = 0; r < RM; ++r) {
        const int4* row = reinterpret_cast<const int4*>(&sA[ty * RM + r][ww * 32]);
        const int4 v0 = row[0], v1 = row[1];
        int s = acc[r];
        s = __dp4a(v0.x, e[0], s);
        s = __dp4a(v0.y, e[1], s);
        s = __dp4a(v0.z, e[2], s);
        s = __dp4a(v0.w, e[3], s);
        s = __dp4a(v1.x, e[4], s);
        s = __dp4a(v1.y, e[5], s);
        s = __dp4a(v1.z, e[6], s);
        s = __dp4a(v1.w, e[7], s);
        acc[r] = s;
      }
    }
    __syncthreads();
  }

  const int n = n0 + tx;
  if (n >= N) return;
#pragma unroll
  for (int r = 0; r < RM; ++r) {
    const int m = m0 + ty * RM + r;
    if (m < M) {
      if (use_atomic) {
        atomicAdd(&out[(size_t)m * N + n], acc[r]);
      } else {
        out[(size_t)m * N + n] = acc[r];
      }
    }
  }
}

template <int RM>
cudaError_t launch(const int8_t* a, const uint32_t* wp, int32_t* out, int M,
                   int K, int N, int KW, int splits, cudaStream_t stream) {
  constexpr int BM = RG * RM;
  const int kw_split = (KW + splits - 1) / splits;
  const int z = (KW + kw_split - 1) / kw_split;
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, z);
  binary_qmm_kernel<RM><<<grid, THREADS, 0, stream>>>(a, wp, out, M, K, N, KW,
                                                      kw_split, z > 1);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Rows per block: 4 * binary_qmm_rows_per_thread(M).
int binary_qmm_rows_per_thread(int M) { return M <= 4 ? 1 : (M <= 16 ? 4 : 8); }

// out must be zeroed by the caller when splits > 1 (partials are atomically
// added).  Returns the cudaError_t of the launch.
int binary_qmm_launch(const void* a, const void* w_packed, void* out, int M,
                      int K, int N, int splits, void* stream) {
  const int KW = (K + 31) / 32;
  auto s = static_cast<cudaStream_t>(stream);
  auto pa = static_cast<const int8_t*>(a);
  auto pw = static_cast<const uint32_t*>(w_packed);
  auto po = static_cast<int32_t*>(out);
  switch (binary_qmm_rows_per_thread(M)) {
    case 1: return launch<1>(pa, pw, po, M, K, N, KW, splits, s);
    case 4: return launch<4>(pa, pw, po, M, K, N, KW, splits, s);
    default: return launch<8>(pa, pw, po, M, K, N, KW, splits, s);
  }
}

}  // extern "C"
