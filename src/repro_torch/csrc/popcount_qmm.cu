// K3 popcount_qmm: binary x binary AND-popcount QMM over packed operands.
//
// Replaces the Pallas TPU kernel src/repro/kernels/popcount_qmm.py
// (popcount_qmm / _kernel, pallas_call at :95).  Same function as
// repro_torch.kernels.ref.popcount_qmm_ref:
//     out[m, n] = sum_w popc(a[m, w] & b[w, n])
// a (M, KW) and b (KW, N) are row-major 32-bit words of 1-bit mantissas
// packed along K; out (M, N) int32.  The affine epilogue runs after the
// kernel (repro_torch.core.flow_abstraction.qmm_flow), as on the TPU.
//
// What bounds it on an H100: 2*M*N*K binary operations against packed
// operands of K/8 bytes a row.  At decode (M = the slot count, 4) the
// packed weights dominate the bytes and the kernel is bound by device
// memory (3.35 TB/s); at prefill (M = the prompt length, ~128) the
// operations do, counted against the dense int8 tensor-core rate (1,979
// TOP/s; Hopper publishes no binary rate).  Popcounts run on the CUDA
// cores here, 32 binary products per __popc, far below that rate.
//
// Design (first, simple version; no b1 mma.sync yet):
//  * One block owns BN = 64 output columns by BM = 4*RM rows and loops over
//    the whole of KW itself: the loop replaces the TPU's sequential K grid
//    axis and its carried accumulator, since Hopper blocks run in no order.
//    KW is 24 or 96 words on bit-bert-base, so no split-K.
//  * Each stage copies KC words of BM activation rows and KC x BN weight
//    words into shared memory, N the contiguous axis of B so that the loads
//    coalesce; ragged M / N / KW edges are masked there (zero words add
//    nothing), so the caller pads nothing.
//  * Each thread owns one column and RM rows and accumulates
//    __popc(a & b) into int32 registers.  A warp shares its rows, so the
//    activation reads from shared memory are broadcasts.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int BN = 64;  // output columns per block, one per thread column
constexpr int RG = 4;   // row groups per block
constexpr int THREADS = BN * RG;
constexpr int KC = 32;  // packed words (1024 K) per shared-memory stage

template <int RM>
__global__ void __launch_bounds__(THREADS)
popcount_qmm_kernel(const uint32_t* __restrict__ a, const uint32_t* __restrict__ b,
                    int32_t* __restrict__ out, int M, int KW, int N) {
  constexpr int BM = RG * RM;
  __shared__ uint32_t sA[BM][KC];
  __shared__ uint32_t sB[KC][BN];

  const int tx = threadIdx.x % BN;
  const int ty = threadIdx.x / BN;
  const int n0 = blockIdx.x * BN;
  const int m0 = blockIdx.y * BM;

  int acc[RM];
#pragma unroll
  for (int r = 0; r < RM; ++r) acc[r] = 0;

  for (int w0 = 0; w0 < KW; w0 += KC) {
    for (int i = threadIdx.x; i < BM * KC; i += THREADS) {
      const int r = i / KC, ww = i % KC;
      const int gm = m0 + r, gw = w0 + ww;
      sA[r][ww] = (gm < M && gw < KW) ? a[(size_t)gm * KW + gw] : 0u;
    }
    for (int i = threadIdx.x; i < KC * BN; i += THREADS) {
      const int ww = i / BN, nn = i % BN;
      const int gw = w0 + ww, gn = n0 + nn;
      sB[ww][nn] = (gw < KW && gn < N) ? b[(size_t)gw * N + gn] : 0u;
    }
    __syncthreads();

    const int nw = min(KC, KW - w0);  // a ragged last stage counts only its own words
#pragma unroll 4
    for (int ww = 0; ww < nw; ++ww) {
      const uint32_t bw = sB[ww][tx];
#pragma unroll
      for (int r = 0; r < RM; ++r) acc[r] += __popc(sA[ty * RM + r][ww] & bw);
    }
    __syncthreads();
  }

  const int n = n0 + tx;
  if (n >= N) return;
#pragma unroll
  for (int r = 0; r < RM; ++r) {
    const int m = m0 + ty * RM + r;
    if (m < M) out[(size_t)m * N + n] = acc[r];
  }
}

template <int RM>
cudaError_t launch(const uint32_t* a, const uint32_t* b, int32_t* out, int M,
                   int KW, int N, cudaStream_t stream) {
  constexpr int BM = RG * RM;
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  popcount_qmm_kernel<RM><<<grid, THREADS, 0, stream>>>(a, b, out, M, KW, N);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Returns the cudaError_t of the launch.  M and N must be positive.
int popcount_qmm_launch(const void* a_packed, const void* b_packed, void* out, int M,
                        int KW, int N, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto pa = static_cast<const uint32_t*>(a_packed);
  auto pb = static_cast<const uint32_t*>(b_packed);
  auto po = static_cast<int32_t*>(out);
  if (M <= 4) return launch<1>(pa, pb, po, M, KW, N, s);
  if (M <= 16) return launch<4>(pa, pb, po, M, KW, N, s);
  return launch<8>(pa, pb, po, M, KW, N, s);
}

}  // extern "C"
