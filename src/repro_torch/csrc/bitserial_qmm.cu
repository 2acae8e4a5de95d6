// K4 bitserial_qmm: multi-bit act x act QMM over packed bit-planes.
//
// Replaces the Pallas TPU kernel src/repro/kernels/bitserial_qmm.py
// (bitserial_qmm / _kernel, pallas_call at :83).  Same function as
// repro_torch.kernels.ref.bitserial_qmm_ref:
//     out[m, n] = sum_ij 2^(i+j) sum_w popc(A_i[m, w] & B_j[w, n])
// a_planes (a_bits, M, KW) and b_planes (b_bits, KW, N) are 32-bit words of
// unsigned mantissa bit-planes packed along K, bit v of word w holding K
// index 32w + v; out (M, N) int32.  The sum is exact in int32 while
// 32 KW (2^a_bits - 1) (2^b_bits - 1) < 2^31, which the wrapper checks.  The
// affine epilogue runs after the kernel
// (repro_torch.core.flow_abstraction.qmm_flow), as on the TPU.
//
// What bounds it on an H100: the packed planes are small (a_bits + b_bits
// planes of K/8 bytes a row), so at the act x act shapes of an attention
// head or an FFN the 2*M*N*K operations bound it, at the dense int8
// tensor-core rate (1,979 TOP/s).  The cross-plane sum is the product
// X @ W of the unsigned mantissas X = sum_i 2^i A_i and W = sum_j 2^j B_j,
// both below 256, so it runs on the int8 tensor cores, exactly, once --
// not a_bits * b_bits popcount passes on the CUDA cores.  What the kernel
// spends its time on is turning bits into those bytes (CUDA cores), and at
// the per-head shape (KW = 2) the latency of one short stage.
//
// Design: K2 fused_qmm.cu's integer core without its row and column sums
// and its epilogue, on the helpers of qmm_mma.cuh.
//  * One block owns a BM x BN tile of out and walks the whole of K (no
//    split-K).  Tiles by M and K: short K (KW <= 4, an attention head's
//    Q.K^T) 16 x 32 tiles of one stage, so the per-head shape still spreads
//    over 32 blocks; M <= 64 16-row tiles; above, 32 or 64 rows x 128
//    columns.  KS warp groups split each stage's k32 steps.
//  * Staging: each stage copies KC words of every plane of the block's
//    rows and columns into shared memory with cp.async (16-byte copies
//    where KW / N and the base address allow, else 4-byte), into PA / PB
//    plane slots: 1 for one plane, else 8, the slots past a_bits / b_bits
//    zero-filled, as are copies past the ragged M / N / KW edges.
//  * Expansion: the staged words become u8 mantissa tiles X[BM][32*KC] and
//    W^T[BN][32*KC], K contiguous: one plane by a nibble spread, 8 slots by
//    4x4 byte and 8x8 bit transposes.
//  * Product: mma.sync m16n8k32 u8 x u8 -> s32 on ldmatrix fragments; the
//    int32 fragments go straight to out.
//  * Software pipeline, one barrier per stage: the tensor cores take stage
//    s from one u8 buffer while the CUDA cores fill the other with stage
//    s+1; a single stage passes through it as well (loads of stages past
//    the last are empty).
#include "qmm_mma.cuh"

namespace {

using namespace qmm;

constexpr int MAX_BITS = 8;

template <class T>
size_t smem_bytes(int a_slots, int b_slots, int bmr) {
  return static_cast<size_t>(T::ST) * 4 * (a_slots * bmr * T::KC + b_slots * T::KC * T::BN) +
         2 * (T::BM + T::BN) * T::LDS;
}

// PA / PB: plane slots staged for each side, 1 (one plane) or 8 (2 .. 8
// planes, the slots past a_bits / b_bits zero).
template <class T, int PA, int PB>
__global__ void __launch_bounds__(T::THREADS, T::MIN_BLOCKS)
bitserial_qmm_kernel(const uint32_t* __restrict__ ap, const uint32_t* __restrict__ bp,
                     int32_t* __restrict__ out, int a_bits, int b_bits, int M, int KW, int N,
                     int bmr, int a_vec, int b_vec) {
  constexpr int BM = T::BM, BN = T::BN, KC = T::KC, ST = T::ST, LDS = T::LDS;
  constexpr int THREADS = T::THREADS, U8 = (BM + BN) * LDS;
  static_assert(T::RED_BYTES <= 2 * U8, "the warp groups' sums fit where the u8 tiles were");
  extern __shared__ __align__(16) unsigned char smem[];
  const int a_words = PA * bmr * KC;
  const int stage_words = a_words + PB * KC * BN;
  uint32_t* raw = reinterpret_cast<uint32_t*>(smem);
  uint8_t* u8 = smem + static_cast<size_t>(ST) * stage_words * 4;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wk = warp / (T::WM * T::WN), wm = (warp / T::WN) % T::WM, wn = warp % T::WN;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const int nst = (KW + KC - 1) / KC;

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

  // Stage s: staged words -> u8 buffer s % 2.  (u8 rows past bmr are never
  // written: they reach only output rows that are never stored.)
  const int cb = tid % BN;
  auto expand = [&](int s) {
    const uint32_t* rA = raw + (s % ST) * stage_words;
    const uint32_t* rB = rA + a_words;
    uint8_t* sA8 = u8 + (s & 1) * U8;
    uint8_t* sB8 = sA8 + BM * LDS;
#pragma unroll
    for (int u = 0; u < (BM * KC + THREADS - 1) / THREADS; ++u) {
      const int idx = tid + u * THREADS;
      const int r = idx / KC, ww = idx % KC;
      if (idx < BM * KC && r < bmr) {
        uint32_t w[PA], o[8];
        gather_planes<PA>(rA + r * KC + ww, bmr * KC, ~0u, w);
        spread_planes<PA>(w, o);
        store_row32(sA8 + r * LDS + ww * 32, o, ww);
      }
    }
#pragma unroll
    for (int u = 0; u < (BN * KC + THREADS - 1) / THREADS; ++u) {
      const int idx = tid + u * THREADS;
      const int ww = idx / BN;
      if (idx < BN * KC) {
        uint32_t w[PB], o[8];
        gather_planes<PB>(rB + ww * BN + cb, KC * BN, ~0u, w);
        spread_planes<PB>(w, o);
        store_row32(sB8 + cb * LDS + ww * 32, o, ww);
      }
    }
  };

  int acc[T::MI][T::NI][4];
#pragma unroll
  for (int mi = 0; mi < T::MI; ++mi)
#pragma unroll
    for (int ni = 0; ni < T::NI; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0;

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
    const uint8_t* sA8 = u8 + (s & 1) * U8;
    mma_stage<T, false>(acc, sA8, sA8 + BM * LDS, BM, lane, wm, wn, wk);
    if (s + 1 < nst) expand(s + 1);
  }
  cp_async_wait<0>();

  if (reduce_ks<T>(acc, reinterpret_cast<int*>(u8), lane, wm, wn, wk)) {
    store_tile<T>(acc, out, m0, n0, M, N, false, lane, wm, wn);
  }
}

template <class T, int PA, int PB>
cudaError_t launch(const uint32_t* ap, const uint32_t* bp, int32_t* out, int a_bits, int b_bits,
                   int M, int KW, int N, cudaStream_t stream) {
  static unsigned smem_set = 0;
  const int bmr = M < T::BM ? M : T::BM;
  // the largest request this kernel can make, allowed once per device
  cudaError_t err = allow_smem(bitserial_qmm_kernel<T, PA, PB>, smem_bytes<T>(PA, PB, T::BM),
                               smem_set);
  if (err != cudaSuccess) return err;
  const int a_vec = KW % 4 == 0 && reinterpret_cast<uintptr_t>(ap) % 16 == 0;
  const int b_vec = N % 4 == 0 && reinterpret_cast<uintptr_t>(bp) % 16 == 0;
  dim3 grid((N + T::BN - 1) / T::BN, (M + T::BM - 1) / T::BM);
  bitserial_qmm_kernel<T, PA, PB><<<grid, T::THREADS, smem_bytes<T>(PA, PB, bmr), stream>>>(
      ap, bp, out, a_bits, b_bits, M, KW, N, bmr, a_vec, b_vec);
  return cudaGetLastError();
}

// One kernel per side's plane slots: 1, or 8 for 2 .. 8 planes; T8, a tile
// with less shared memory, where the weights take 8 slots.
template <class T, class T8 = T>
cudaError_t launch_tile(const uint32_t* ap, const uint32_t* bp, int32_t* out, int a_bits,
                        int b_bits, int M, int KW, int N, cudaStream_t s) {
  if (a_bits == 1) {
    return b_bits == 1 ? launch<T, 1, 1>(ap, bp, out, a_bits, b_bits, M, KW, N, s)
                       : launch<T8, 1, 8>(ap, bp, out, a_bits, b_bits, M, KW, N, s);
  }
  return b_bits == 1 ? launch<T, 8, 1>(ap, bp, out, a_bits, b_bits, M, KW, N, s)
                     : launch<T8, 8, 8>(ap, bp, out, a_bits, b_bits, M, KW, N, s);
}

// Tiles (BM, BN, warps along M and N, warp groups along K, words per stage,
// stages in flight), K2's by M, and one for short K:
// KW <= 4 (an attention head's Q.K^T): 16 x 32, one stage of 4 words.
using ShortTile = Tile<16, 32, 1, 2, 1, 4, 3>;
// M <= 64: 16-row tiles, 64 columns and 16 words a stage; 32 columns where
// the B side takes 8 plane slots (shared memory).
using SmallTile = Tile<16, 64, 1, 4, 2, 16, 4>;
using SmallTile8 = Tile<16, 32, 1, 2, 4, 16, 4>;
// Above: 64 x 128 on grids of more than one block an SM, else 32 x 128;
// 32 x 128 where the B side takes 8 plane slots.
using PrefillTile = Tile<32, 128, 2, 4, 2, 8, 3>;
using PrefillTile64 = Tile<64, 128, 2, 4, 2, 8, 3>;

}  // namespace

extern "C" {

// Returns the cudaError_t of the launch; a_bits and b_bits must be 1..8.
// sms: the device's streaming multiprocessors.
int bitserial_qmm_launch(const void* a_planes, const void* b_planes, void* out, int a_bits,
                         int b_bits, int M, int KW, int N, int sms, void* stream) {
  if (a_bits < 1 || a_bits > MAX_BITS || b_bits < 1 || b_bits > MAX_BITS) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto s = static_cast<cudaStream_t>(stream);
  auto pa = static_cast<const uint32_t*>(a_planes);
  auto pb = static_cast<const uint32_t*>(b_planes);
  auto po = static_cast<int32_t*>(out);
  if (KW <= ShortTile::KC) return launch_tile<ShortTile>(pa, pb, po, a_bits, b_bits, M, KW, N, s);
  if (M <= 64) return launch_tile<SmallTile, SmallTile8>(pa, pb, po, a_bits, b_bits, M, KW, N, s);
  const long blocks = static_cast<long>((N + PrefillTile::BN - 1) / PrefillTile::BN) *
                      ((M + PrefillTile::BM - 1) / PrefillTile::BM);
  if (blocks > sms) {
    return launch_tile<PrefillTile64, PrefillTile>(pa, pb, po, a_bits, b_bits, M, KW, N, s);
  }
  return launch_tile<PrefillTile>(pa, pb, po, a_bits, b_bits, M, KW, N, s);
}

}  // extern "C"
