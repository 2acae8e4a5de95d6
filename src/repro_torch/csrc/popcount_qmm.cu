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
// operands of K/8 bytes a row and an int32 output.  Hopper publishes no
// binary tensor-core rate; an m16n8k256 .b1 mma does 8x the operations of
// an int8 m16n8k32 one at about its issue rate, so 8x the dense int8 rate
// (1,979 TOP/s) is the yardstick, and at bit-bert-base's sizes device
// memory (3.35 TB/s) bounds it at decode and prefill alike.  Either bound
// is well under a microsecond there, so what sets the time is the latency
// of one pass: the launch, the copies' round trip, a short chain of
// products.
//
// Design: the binary tensor cores, mma.sync m16n8k256 .b1 .and.popc
// (qmm_mma.cuh mma_b1), on the packed words as they are -- no expansion.
//  * The words are the fragments: an A fragment is four words of a
//    row-major word tile (ldmatrix x4, each 16-byte matrix row 4 words of
//    K), a B fragment two words of the (K words, N) tile read with 32-bit
//    loads.  The bit order inside a word is immaterial: A and B map K
//    alike, and the sum over K is the same under any common permutation.
//  * Tiles: the A tile's rows are padded by 4 words (ldmatrix's 8 rows hit
//    8 distinct 16-byte bank groups), the B tile's by 8 (a warp's 4 x 8
//    word loads hit 32 banks).
//  * Staging: cp.async, 16-byte copies where KW / N and the base addresses
//    allow, else 4-byte, zero-filled past the ragged M / N / KW edges (and
//    past a block's K range), so the product needs no edge branches; ST
//    stages of KC words, ST - 1 in flight before the first product -- all
//    of K at bit-bert-base's widths.
//  * A block owns a BM x BN tile of out and a range of K words, split
//    among four warps.  One C function, popcount_qmm_plan, picks the tile
//    (32 x 64 where those fill the SMs, else 16 x 32) and splits K over
//    blockIdx.z where even those leave SMs idle and K is long; the partial
//    sums meet with integer atomicAdd, exact in any order (the launch
//    zero-fills out first).
#include "qmm_mma.cuh"

namespace {

using namespace qmm;

// BM x BN output tile; warps WM x WN over it; KC words of K per stage, ST
// stages.
template <int BM_, int BN_, int WM_, int WN_, int KC_, int ST_>
struct B1Tile {
  static constexpr int BM = BM_, BN = BN_, WM = WM_, WN = WN_, KC = KC_, ST = ST_;
  static constexpr int THREADS = 32 * WM * WN;
  static constexpr int TM = BM / WM, TN = BN / WN;  // one warp's tile
  static constexpr int MI = TM / 16, NI = TN / 8;   // its m16n8 fragments
  static constexpr int LDA = KC + 4, LDB = BN + 8;  // padded row strides, in words
  static constexpr int STAGE_WORDS = BM * LDA + KC * LDB;
  static constexpr size_t SMEM = static_cast<size_t>(ST) * STAGE_WORDS * 4;
  static_assert(TM % 16 == 0 && TN % 8 == 0 && KC % 8 == 0 && BN % 4 == 0 && ST >= 2,
                "tile shape");
};

template <class T>
__global__ void __launch_bounds__(T::THREADS)
popcount_qmm_kernel(const uint32_t* __restrict__ a, const uint32_t* __restrict__ b,
                    int32_t* __restrict__ out, int M, int KW, int N, int kw_split, int a_vec,
                    int b_vec) {
  constexpr int BM = T::BM, BN = T::BN, KC = T::KC, ST = T::ST, LDA = T::LDA, LDB = T::LDB;
  constexpr int THREADS = T::THREADS, STEPS = KC / 8;
  extern __shared__ __align__(16) uint32_t smem[];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp / T::WN, wn = warp % T::WN;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const int wb = blockIdx.z * kw_split, we = min(wb + kw_split, KW);
  const int nst = (we - wb + KC - 1) / KC;

  // Stage s: BM rows x KC words of a and KC words x BN columns of b, zero
  // past M, N and the block's K range.  (A K range is a whole number of
  // stages, so a 16-byte copy never straddles its end.)
  auto load_stage = [&](int s) {
    if (s < nst) {
      uint32_t* dA = smem + (s % ST) * T::STAGE_WORDS;
      uint32_t* dB = dA + BM * LDA;
      const int w0 = wb + s * KC;
      if (a_vec) {
        constexpr int AV = KC / 4;
        for (int i = tid; i < BM * AV; i += THREADS) {
          const int r = i / AV, c = 4 * (i % AV);
          const bool ok = m0 + r < M && w0 + c < we;
          cp_async16(dA + r * LDA + c, a + (ok ? static_cast<size_t>(m0 + r) * KW + w0 + c : 0), ok);
        }
      } else {
        for (int i = tid; i < BM * KC; i += THREADS) {
          const int r = i / KC, c = i % KC;
          const bool ok = m0 + r < M && w0 + c < we;
          cp_async4(dA + r * LDA + c, a + (ok ? static_cast<size_t>(m0 + r) * KW + w0 + c : 0), ok);
        }
      }
      if (b_vec) {
        constexpr int BV = BN / 4;
        for (int i = tid; i < KC * BV; i += THREADS) {
          const int ww = i / BV, c = 4 * (i % BV);
          const bool ok = w0 + ww < we && n0 + c < N;
          cp_async16(dB + ww * LDB + c, b + (ok ? static_cast<size_t>(w0 + ww) * N + n0 + c : 0), ok);
        }
      } else {
        for (int i = tid; i < KC * BN; i += THREADS) {
          const int ww = i / BN, c = i % BN;
          const bool ok = w0 + ww < we && n0 + c < N;
          cp_async4(dB + ww * LDB + c, b + (ok ? static_cast<size_t>(w0 + ww) * N + n0 + c : 0), ok);
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

  // One barrier per stage: stage s is multiplied while stages s+1 ..
  // s+ST-1 are in flight; the buffer of stage s-1, multiplied by every warp
  // before the barrier, is refilled after it.
  const int g = lane >> 2, t4 = lane & 3;
  for (int s = 0; s < ST - 1; ++s) load_stage(s);
  for (int s = 0; s < nst; ++s) {
    cp_async_wait<ST - 2>();
    __syncthreads();
    load_stage(s + ST - 1);
    const uint32_t* sA = smem + (s % ST) * T::STAGE_WORDS;
    const uint32_t* sB = sA + BM * LDA;
    const int steps = (min(KC, we - wb - s * KC) + 7) / 8;  // a short last stage
#pragma unroll
    for (int kk = 0; kk < STEPS; ++kk) {
      if (kk < steps) {
        uint32_t af[T::MI][4], bf[T::NI][2];
#pragma unroll
        for (int mi = 0; mi < T::MI; ++mi) {
          const int row = wm * T::TM + mi * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
          ldsm_x4(af[mi][0], af[mi][1], af[mi][2], af[mi][3],
                  sA + row * LDA + kk * 8 + (lane >> 4) * 4);
        }
#pragma unroll
        for (int ni = 0; ni < T::NI; ++ni) {
          const uint32_t* col = sB + (kk * 8 + t4) * LDB + wn * T::TN + ni * 8 + g;
          bf[ni][0] = col[0];
          bf[ni][1] = col[4 * LDB];
        }
#pragma unroll
        for (int mi = 0; mi < T::MI; ++mi)
#pragma unroll
          for (int ni = 0; ni < T::NI; ++ni) mma_b1(acc[mi][ni], af[mi], bf[ni][0], bf[ni][1]);
      }
    }
  }
  cp_async_wait<0>();
  store_tile<T>(acc, out, m0, n0, M, N, gridDim.z > 1, lane, wm, wn);
}

// Tiles (BM, BN, warps along M and N, words per stage, stages), four warps
// each: 32 x 64 (each warp 16 x 32) where those fill the SMs; else 16 x 32
// (each warp 16 x 8).
using WideTile = B1Tile<32, 64, 2, 2, 32, 4>;
using NarrowTile = B1Tile<16, 32, 1, 4, 32, 4>;

struct Plan {
  int bm, bn, splits;
};

// The tile by M and N; then K split across blocks while the grid fills
// less than one wave of the SMs, each split keeping at least two stages.
Plan make_plan(int M, int KW, int N, int sms) {
  auto tiles = [&](int bm, int bn) {
    return static_cast<long>((N + bn - 1) / bn) * ((M + bm - 1) / bm);
  };
  const bool wide = M > NarrowTile::BM && tiles(WideTile::BM, WideTile::BN) >= sms;
  const int bm = wide ? WideTile::BM : NarrowTile::BM, bn = wide ? WideTile::BN : NarrowTile::BN;
  const long t = tiles(bm, bn);
  long splits = t > 0 ? sms / t : 1;
  const int kc = wide ? WideTile::KC : NarrowTile::KC;
  if (splits > KW / (2 * kc)) splits = KW / (2 * kc);
  return Plan{bm, bn, splits < 1 ? 1 : static_cast<int>(splits)};
}

template <class T>
cudaError_t launch(const uint32_t* a, const uint32_t* b, int32_t* out, int M, int KW, int N,
                   int splits, cudaStream_t stream) {
  static unsigned smem_set = 0;
  cudaError_t err = allow_smem(popcount_qmm_kernel<T>, T::SMEM, smem_set);
  if (err != cudaSuccess) return err;
  // each split a whole number of stages
  const int kw_split = (KW + splits - 1) / splits;
  const int kw_stage = (kw_split + T::KC - 1) / T::KC * T::KC;
  const int z = kw_stage > 0 ? (KW + kw_stage - 1) / kw_stage : 1;
  const int a_vec = KW % 4 == 0 && reinterpret_cast<uintptr_t>(a) % 16 == 0;
  const int b_vec = N % 4 == 0 && reinterpret_cast<uintptr_t>(b) % 16 == 0;
  dim3 grid((N + T::BN - 1) / T::BN, (M + T::BM - 1) / T::BM, z);
  popcount_qmm_kernel<T><<<grid, T::THREADS, T::SMEM, stream>>>(a, b, out, M, KW, N,
                                                                kw_stage > 0 ? kw_stage : 1,
                                                                a_vec, b_vec);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// The launch's plan for (M, KW, N) on a device of `sms` SMs: plan[0..2] =
// block rows, block columns, K splits.
void popcount_qmm_plan(int M, int KW, int N, int sms, int* plan) {
  const Plan p = make_plan(M, KW, N, sms);
  plan[0] = p.bm;
  plan[1] = p.bn;
  plan[2] = p.splits;
}

// Returns the cudaError_t of the launch.  M and N must be positive.  With
// more than one K split the blocks add into out, zeroed here first.
int popcount_qmm_launch(const void* a_packed, const void* b_packed, void* out, int M, int KW,
                        int N, int sms, void* stream) {
  const Plan p = make_plan(M, KW, N, sms);
  auto s = static_cast<cudaStream_t>(stream);
  auto pa = static_cast<const uint32_t*>(a_packed);
  auto pb = static_cast<const uint32_t*>(b_packed);
  auto po = static_cast<int32_t*>(out);
  if (p.splits > 1) {
    const cudaError_t err = cudaMemsetAsync(po, 0, static_cast<size_t>(M) * N * sizeof(int32_t), s);
    if (err != cudaSuccess) return err;
  }
  if (p.bm == WideTile::BM) return launch<WideTile>(pa, pb, po, M, KW, N, p.splits, s);
  return launch<NarrowTile>(pa, pb, po, M, KW, N, p.splits, s);
}

}  // extern "C"
