// K2 fused_qmm: bit-serial AND-popcount QMM with the affine epilogue fused.
//
// Replaces the Pallas TPU kernel src/repro/kernels/fused_qmm.py
// (fused_qmm / _kernel, pallas_call at :180).  Same function as
// repro_torch.kernels.ref.fused_qmm_ref:
//     acc[m, n] = sum_ij 2^(i+j) sum_w popc(A_i[m, w] & B_j[w, n])
//     row[m]    = sum_i  2^i     sum_w popc(A_i[m, w])
//     col[n]    = sum_j  2^j     sum_w popc(B_j[w, n])
//     out = ((acc*(a1*a2) + (a1*g2)*row) + (g1*a2)*col) + (g1*g2)*K
// a_planes (a_bits, M, Kw) and b_planes (b_bits, Kw, N) are 32-bit words of
// unsigned mantissa bit-planes; a_scale/a_offset (M), w_scale/w_offset (N)
// float32; out (M, N) float32 is the only write to device memory.
//
// What bounds it on an H100: the same W1A8 product as binary_qmm -- the
// packed weight planes at decode (device memory, 3.35 TB/s), the operations
// at prefill.  Popcounts run on the CUDA cores, far below the tensor cores'
// int8 rate, so at prefill this kernel sits well above its bound.
//
// Design (first, simple version):
//  * One block owns BN = 32 columns by BM = 4*RM rows and walks the whole of
//    K itself, so rowsum, colsum and the MM stay in registers and the
//    epilogue runs in the same launch.  No split-K: the epilogue needs the
//    finished sums.
//  * Each stage copies KC words of every plane into shared memory (masked
//    at the ragged M / N / Kw edges).  A warp shares its rows, so the
//    activation words are broadcasts; the weight words are one per lane.
//  * The epilogue uses __fmul_rn / __fadd_rn: nvcc would otherwise contract
//    mul+add into fma and the result would not equal the plain version,
//    which rounds every product and sum on its own.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int BN = 32;
constexpr int RG = 4;
constexpr int THREADS = BN * RG;
constexpr int KC = 16;
constexpr int MAX_BITS = 8;

template <int RM>
__global__ void __launch_bounds__(THREADS)
fused_qmm_kernel(const uint32_t* __restrict__ ap, const uint32_t* __restrict__ bp,
                 const float* __restrict__ a_scale, const float* __restrict__ a_offset,
                 const float* __restrict__ w_scale, const float* __restrict__ w_offset,
                 float* __restrict__ out, int a_bits, int b_bits, int M, int KW,
                 int N, int k_logical) {
  constexpr int BM = RG * RM;
  __shared__ uint32_t sA[MAX_BITS][BM][KC];
  __shared__ uint32_t sB[MAX_BITS][KC][BN];

  const int tx = threadIdx.x % BN;
  const int ty = threadIdx.x / BN;
  const int n0 = blockIdx.x * BN;
  const int m0 = blockIdx.y * BM;

  int acc[RM], row[RM];
#pragma unroll
  for (int r = 0; r < RM; ++r) acc[r] = row[r] = 0;
  int col = 0;

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

    for (int ww = 0; ww < KC; ++ww) {
      for (int j = 0; j < b_bits; ++j) {
        const uint32_t bw = sB[j][ww][tx];
        col += __popc(bw) << j;
#pragma unroll
        for (int r = 0; r < RM; ++r) {
          int s = 0;
          for (int i = 0; i < a_bits; ++i) s += __popc(sA[i][ty * RM + r][ww] & bw) << i;
          acc[r] += s << j;
        }
      }
#pragma unroll
      for (int r = 0; r < RM; ++r) {
        int s = 0;
        for (int i = 0; i < a_bits; ++i) s += __popc(sA[i][ty * RM + r][ww]) << i;
        row[r] += s;
      }
    }
    __syncthreads();
  }

  const int n = n0 + tx;
  if (n >= N) return;
  const float a2 = w_scale[n], g2 = w_offset[n];
  const float kf = static_cast<float>(k_logical);
#pragma unroll
  for (int r = 0; r < RM; ++r) {
    const int m = m0 + ty * RM + r;
    if (m >= M) continue;
    const float a1 = a_scale[m], g1 = a_offset[m];
    const float t0 = __fmul_rn(__int2float_rn(acc[r]), __fmul_rn(a1, a2));
    const float t1 = __fmul_rn(__fmul_rn(a1, g2), __int2float_rn(row[r]));
    const float t2 = __fmul_rn(__fmul_rn(g1, a2), __int2float_rn(col));
    const float t3 = __fmul_rn(__fmul_rn(g1, g2), kf);
    out[(size_t)m * N + n] = __fadd_rn(__fadd_rn(__fadd_rn(t0, t1), t2), t3);
  }
}

template <int RM>
cudaError_t launch(const uint32_t* ap, const uint32_t* bp, const float* as,
                   const float* ao, const float* ws, const float* wo, float* out,
                   int a_bits, int b_bits, int M, int KW, int N, int k,
                   cudaStream_t stream) {
  constexpr int BM = RG * RM;
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  fused_qmm_kernel<RM><<<grid, THREADS, 0, stream>>>(ap, bp, as, ao, ws, wo, out,
                                                     a_bits, b_bits, M, KW, N, k);
  return cudaGetLastError();
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
  auto s = static_cast<cudaStream_t>(stream);
  auto ap = static_cast<const uint32_t*>(a_planes);
  auto bp = static_cast<const uint32_t*>(b_planes);
  auto as = static_cast<const float*>(a_scale);
  auto ao = static_cast<const float*>(a_offset);
  auto ws = static_cast<const float*>(w_scale);
  auto wo = static_cast<const float*>(w_offset);
  auto po = static_cast<float*>(out);
  if (M <= 4) return launch<1>(ap, bp, as, ao, ws, wo, po, a_bits, b_bits, M, KW, N, k_logical, s);
  if (M <= 16) return launch<4>(ap, bp, as, ao, ws, wo, po, a_bits, b_bits, M, KW, N, k_logical, s);
  return launch<8>(ap, bp, as, ao, ws, wo, po, a_bits, b_bits, M, KW, N, k_logical, s);
}

}  // extern "C"
