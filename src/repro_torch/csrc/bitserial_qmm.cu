// K4 bitserial_qmm: multi-bit act x act QMM over packed bit-planes.
//
// Replaces the Pallas TPU kernel src/repro/kernels/bitserial_qmm.py
// (bitserial_qmm / _kernel, pallas_call at :83).  Same function as
// repro_torch.kernels.ref.bitserial_qmm_ref:
//     out[m, n] = sum_ij 2^(i+j) sum_w popc(A_i[m, w] & B_j[w, n])
// a_planes (a_bits, M, KW) and b_planes (b_bits, KW, N) are 32-bit words of
// unsigned mantissa bit-planes packed along K; out (M, N) int32.  The sum is
// exact in int32 while K * (2^a_bits - 1) * (2^b_bits - 1) < 2^31, which
// the wrapper checks.  The affine epilogue runs after the kernel
// (repro_torch.core.flow_abstraction.qmm_flow), as on the TPU.
//
// What bounds it on an H100: the packed planes are small (a_bits + b_bits
// planes of K/8 bytes a row), so at the act x act shapes of an attention
// head or an FFN the 2*M*N*K operations bound it, counted against the
// dense int8 tensor-core rate (1,979 TOP/s; Hopper publishes no binary
// rate).  The popcounts run on the CUDA cores, a_bits * b_bits of them per
// word pair, far below that rate.
//
// Design (first, simple version; K2 fused_qmm's integer core without its
// row/column sums and epilogue):
//  * One block owns BN = 32 columns by BM = 4*RM rows and loops over the
//    whole of KW itself, in place of the TPU's sequential K grid axis.
//  * Each stage copies KC words of every plane of both operands into shared
//    memory, N the contiguous axis of B, masked at the ragged M / N / KW
//    edges; every (i, j) plane pair reuses the staged words, so each packed
//    bit is read from device memory once per block, as the TPU kernel reads
//    it once per VMEM tile.
//  * Each thread owns one column and RM rows.  For each word it holds its
//    column's BB weight-plane words in registers and, for each activation
//    plane i and row, sums popc(A_i & B_j) << j over j and adds that << i
//    into an int32 register: the bit-serial schedule of the paper's Fig. 4,
//    with RM x BB independent popcounts per activation plane for the
//    scheduler to overlap.  BB (the weight planes, unrolled) is a template
//    argument, b_bits rounded up to 1, 2, 4 or 8; planes past b_bits are
//    zero words and add nothing.  A ragged last stage counts only its own
//    words (the per-head Q.K^T has KW = 2).
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int BN = 32;
constexpr int RG = 4;
constexpr int THREADS = BN * RG;
constexpr int KC = 16;
constexpr int MAX_BITS = 8;

template <int RM, int BB>
__global__ void __launch_bounds__(THREADS)
bitserial_qmm_kernel(const uint32_t* __restrict__ ap, const uint32_t* __restrict__ bp,
                     int32_t* __restrict__ out, int a_bits, int b_bits, int M, int KW,
                     int N) {
  constexpr int BM = RG * RM;
  __shared__ uint32_t sA[MAX_BITS][BM][KC];
  __shared__ uint32_t sB[MAX_BITS][KC][BN];

  const int tx = threadIdx.x % BN;
  const int ty = threadIdx.x / BN;
  const int n0 = blockIdx.x * BN;
  const int m0 = blockIdx.y * BM;

  int acc[RM];
#pragma unroll
  for (int r = 0; r < RM; ++r) acc[r] = 0;

  for (int w0 = 0; w0 < KW; w0 += KC) {
    for (int i = threadIdx.x; i < a_bits * BM * KC; i += THREADS) {
      const int p = i / (BM * KC), r = (i / KC) % BM, ww = i % KC;
      const int gm = m0 + r, gw = w0 + ww;
      sA[p][r][ww] = (gm < M && gw < KW) ? ap[((size_t)p * M + gm) * KW + gw] : 0u;
    }
    for (int i = threadIdx.x; i < b_bits * KC * BN; i += THREADS) {
      const int p = i / (KC * BN), ww = (i / BN) % KC, nn = i % BN;
      const int gw = w0 + ww, gn = n0 + nn;
      sB[p][ww][nn] = (gw < KW && gn < N) ? bp[((size_t)p * KW + gw) * N + gn] : 0u;
    }
    __syncthreads();

    const int nw = min(KC, KW - w0);
    for (int ww = 0; ww < nw; ++ww) {
      uint32_t bw[BB];
#pragma unroll
      for (int j = 0; j < BB; ++j) bw[j] = j < b_bits ? sB[j][ww][tx] : 0u;
      for (int i = 0; i < a_bits; ++i) {
#pragma unroll
        for (int r = 0; r < RM; ++r) {
          const uint32_t aw = sA[i][ty * RM + r][ww];
          int s = 0;
#pragma unroll
          for (int j = 0; j < BB; ++j) s += __popc(aw & bw[j]) << j;
          acc[r] += s << i;
        }
      }
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

template <int RM, int BB>
cudaError_t launch(const uint32_t* ap, const uint32_t* bp, int32_t* out, int a_bits,
                   int b_bits, int M, int KW, int N, cudaStream_t stream) {
  constexpr int BM = RG * RM;
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  bitserial_qmm_kernel<RM, BB><<<grid, THREADS, 0, stream>>>(ap, bp, out, a_bits, b_bits,
                                                             M, KW, N);
  return cudaGetLastError();
}

template <int RM>
cudaError_t launch_rows(const uint32_t* ap, const uint32_t* bp, int32_t* out, int a_bits,
                        int b_bits, int M, int KW, int N, cudaStream_t stream) {
  if (b_bits <= 1) return launch<RM, 1>(ap, bp, out, a_bits, b_bits, M, KW, N, stream);
  if (b_bits <= 2) return launch<RM, 2>(ap, bp, out, a_bits, b_bits, M, KW, N, stream);
  if (b_bits <= 4) return launch<RM, 4>(ap, bp, out, a_bits, b_bits, M, KW, N, stream);
  return launch<RM, 8>(ap, bp, out, a_bits, b_bits, M, KW, N, stream);
}

}  // namespace

extern "C" {

// Returns the cudaError_t of the launch; a_bits and b_bits must be 1..8,
// M and N positive.
int bitserial_qmm_launch(const void* a_planes, const void* b_planes, void* out,
                         int a_bits, int b_bits, int M, int KW, int N, void* stream) {
  if (a_bits < 1 || a_bits > MAX_BITS || b_bits < 1 || b_bits > MAX_BITS) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto s = static_cast<cudaStream_t>(stream);
  auto pa = static_cast<const uint32_t*>(a_planes);
  auto pb = static_cast<const uint32_t*>(b_planes);
  auto po = static_cast<int32_t*>(out);
  if (M <= 4) return launch_rows<1>(pa, pb, po, a_bits, b_bits, M, KW, N, s);
  if (M <= 16) return launch_rows<4>(pa, pb, po, a_bits, b_bits, M, KW, N, s);
  return launch_rows<8>(pa, pb, po, a_bits, b_bits, M, KW, N, s);
}

}  // extern "C"
