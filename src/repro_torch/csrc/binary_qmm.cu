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
// prompt length, ~128) by the int8 operations (1,979 TOP/s on the tensor
// cores).  The product therefore runs on the tensor cores: mma.sync
// m16n8k32 s8 x u8 -> s32, with A the activations as they are (signed
// bytes) and B the weight bits spread to bytes 0 / 1 (unsigned).  Only the
// weight side needs expanding, one CUDA-core operation or so per weight bit.
//
// Design: the one-weight-plane side of K2 fused_qmm.cu's mainloop, on the
// helpers of qmm_mma.cuh.
//  * A block owns a BM x BN tile of out and a range of K words: 16 x 64
//    tiles for M <= 16 (decode); above, 128 x 128 at long K and wide N,
//    else 32 x 128 (see make_plan).  Where those tiles leave the SMs idle
//    (decode, short N or short K), K is split over blockIdx.z until the
//    grid fills one wave; the partial sums meet with integer atomicAdd,
//    which is exact and order-free (the wrapper zero-fills out).  The plan
//    -- tile and splits -- is binary_qmm_plan, which the wrapper reads too.
//  * Staging, ST stages in flight with cp.async: the activations go as
//    int8 bytes straight into the A tile rows (K contiguous, the mma's row
//    operand), 16-byte copies where K % 16 == 0, 4-byte where K % 4 == 0,
//    else byte loads; every copy past K or past the block's K range is
//    zero-filled (a 16-byte copy at a row's end would otherwise read the
//    next row, or past the tensor).  KC weight words x BN columns go raw.
//  * Expansion: each weight word becomes 32 bytes of a W^T row by the
//    nibble spread (n * 0x00204081 & 0x01010101), its bits past K masked,
//    into one of two u8 buffers.
//  * Product: ldmatrix fragments, mma.sync s8 x u8 into int32 registers;
//    KS warp groups split each stage's k32 steps and add their sums at the
//    end.  Software pipeline, one barrier per stage: the tensor cores take
//    stage s while the CUDA cores expand stage s+1.
//  * At decode only the first M of the 16 rows of an m16 tile are real:
//    the A stage holds just those rows (ldmatrix reads the last one again
//    for the rest), and the mma's spare rows are free where the weights'
//    bytes bound the kernel.
#include "qmm_mma.cuh"

namespace {

using namespace qmm;

// Shared memory: ST A stages (bmr rows of LDS bytes), ST raw weight stages
// (KC x BN words), two W^T u8 buffers (BN rows of LDS bytes).
template <class T>
size_t smem_bytes(int bmr) {
  return static_cast<size_t>(T::ST) * (bmr * T::LDS + 4 * T::KC * T::BN) + 2 * T::BN * T::LDS;
}

// a_mode: 16 or 4 (cp.async copies of that many bytes), or 1 (byte loads).
template <class T>
__global__ void __launch_bounds__(T::THREADS, T::MIN_BLOCKS)
binary_qmm_kernel(const int8_t* __restrict__ a, const uint32_t* __restrict__ wp,
                  int32_t* __restrict__ out, int M, int K, int N, int KW, int kw_split,
                  int bmr, int a_mode, int b_vec) {
  constexpr int BN = T::BN, KC = T::KC, ST = T::ST, LDS = T::LDS, THREADS = T::THREADS;
  static_assert(T::RED_BYTES <= 2 * BN * LDS, "the warp groups' sums fit in the W^T buffers");
  extern __shared__ __align__(16) unsigned char smem[];
  const int a_stage = bmr * LDS;
  uint8_t* sA = smem;
  uint32_t* rawW = reinterpret_cast<uint32_t*>(smem + static_cast<size_t>(ST) * a_stage);
  uint8_t* sW8 = reinterpret_cast<uint8_t*>(rawW + ST * KC * BN);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wk = warp / (T::WM * T::WN), wm = (warp / T::WN) % T::WM, wn = warp % T::WN;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * T::BM;
  const int wb = blockIdx.z * kw_split, we = min(wb + kw_split, KW);
  const int nst = (we - wb + KC - 1) / KC;
  const int rows = min(bmr, M - m0);  // rows past it are read, never stored
  const int kend = min(32 * we, K);   // bytes of a row this block takes
  const uint32_t tail = (K & 31) ? (1u << (K & 31)) - 1u : ~0u;

  // Stage s: the block's rows' bytes of KC words of K, and KC words x BN
  // columns of weights, zero past K, past the block's K range and past N.
  auto load_stage = [&](int s) {
    if (s < nst) {
      uint8_t* dA = sA + (s % ST) * a_stage;
      uint32_t* dW = rawW + (s % ST) * KC * BN;
      const int w0 = wb + s * KC, k0 = 32 * w0;
      const int8_t* a0 = a + static_cast<size_t>(m0) * K + k0;
      if (a_mode == 16) {
        constexpr int AV = 2 * KC;
        for (int i = tid; i < rows * AV; i += THREADS) {
          const int r = i / AV, c = 16 * (i % AV);
          const bool ok = k0 + c < kend;
          cp_async16(dA + r * LDS + c, ok ? a0 + static_cast<size_t>(r) * K + c : a, ok);
        }
      } else if (a_mode == 4) {
        constexpr int AV = 8 * KC;
        for (int i = tid; i < rows * AV; i += THREADS) {
          const int r = i / AV, c = 4 * (i % AV);
          const bool ok = k0 + c < kend;
          cp_async4(dA + r * LDS + c, ok ? a0 + static_cast<size_t>(r) * K + c : a, ok);
        }
      } else {
        // rows not 4-byte aligned: four byte loads a word, stored at once
        constexpr int AV = 8 * KC;
        for (int i = tid; i < rows * AV; i += THREADS) {
          const int r = i / AV, c = 4 * (i % AV);
          const int8_t* src = a0 + static_cast<size_t>(r) * K + c;
          uint32_t v = 0;
#pragma unroll
          for (int b = 0; b < 4; ++b) {
            if (k0 + c + b < kend) {
              v |= static_cast<uint32_t>(static_cast<uint8_t>(src[b])) << (8 * b);
            }
          }
          *reinterpret_cast<uint32_t*>(dA + r * LDS + c) = v;
        }
      }
      if (b_vec) {
        constexpr int BV = BN / 4;
        for (int i = tid; i < KC * BV; i += THREADS) {
          const int ww = i / BV, c = 4 * (i % BV);
          const bool ok = w0 + ww < we && n0 + c < N;
          const uint32_t* src = wp + (ok ? static_cast<size_t>(w0 + ww) * N + n0 + c : 0);
          cp_async16(dW + ww * BN + c, src, ok);
        }
      } else {
        for (int i = tid; i < KC * BN; i += THREADS) {
          const int ww = i / BN, c = i % BN;
          const bool ok = w0 + ww < we && n0 + c < N;
          const uint32_t* src = wp + (ok ? static_cast<size_t>(w0 + ww) * N + n0 + c : 0);
          cp_async4(dW + ww * BN + c, src, ok);
        }
      }
    }
    cp_async_commit();
  };

  // Stage s: raw weight words -> W^T bytes in u8 buffer s % 2.  A thread
  // keeps one weight column.
  const int cb = tid % BN;
  auto expand = [&](int s) {
    const uint32_t* rW = rawW + (s % ST) * KC * BN;
    uint8_t* dst = sW8 + (s & 1) * BN * LDS + cb * LDS;
    const int w0 = wb + s * KC;
#pragma unroll
    for (int u = 0; u < (BN * KC + THREADS - 1) / THREADS; ++u) {
      const int idx = tid + u * THREADS;
      const int ww = idx / BN;
      if (idx < BN * KC) {
        uint32_t w[1], o[8];
        gather_planes<1>(rW + ww * BN + cb, 0, w0 + ww == KW - 1 ? tail : ~0u, w);
        spread_planes<1>(w, o);
        store_row32(dst + ww * 32, o, ww);
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
  // The A stage s is read until iteration s and refilled at s+1.
  for (int s = 0; s < ST - 1; ++s) load_stage(s);
  cp_async_wait<ST - 2>();
  __syncthreads();
  if (nst > 0) expand(0);
  for (int s = 0; s < nst; ++s) {
    cp_async_wait<ST - 3>();
    __syncthreads();  // stage s+1 landed, stage s expanded, stage s-1 multiplied
    load_stage(s + ST - 1);
    mma_stage<T, true>(acc, sA + (s % ST) * a_stage, sW8 + (s & 1) * BN * LDS, bmr, lane, wm,
                       wn, wk);
    if (s + 1 < nst) expand(s + 1);
  }
  cp_async_wait<0>();

  if (reduce_ks<T>(acc, reinterpret_cast<int*>(sW8), lane, wm, wn, wk)) {
    store_tile<T>(acc, out, m0, n0, M, N, gridDim.z > 1, lane, wm, wn);
  }
}

// Tiles (BM, BN, warps along M and N, warp groups along K, words per stage,
// stages in flight), with the blocks an SM holds at once.
// M <= 16 (decode, bound by the weights' bytes): 16 x 64, 16 words a stage,
// 4 stages, two blocks an SM.
using DecodeTile = Tile<16, 64, 1, 4, 2, 16, 4>;
constexpr int DECODE_PER_SM = 2;
// Above (prefill, bound by the operations), one block an SM, 8 words a
// stage: 128 x 128 (each weight column expanded once for 128 rows) where K
// is long and the columns give a grid of at least an eighth of the SMs;
// else 32 x 128, whose four times as many blocks fill the SMs at short K
// or few columns without splitting K as far.
using PrefillTile = Tile<128, 128, 4, 4, 1, 8, 3>;
using PrefillTile32 = Tile<32, 128, 2, 4, 2, 8, 3>;

struct Plan {
  int bm, bn, splits;
};

// The tile by M, K and N; then K split across blocks while the grid fills
// less than one wave of the SMs, each split keeping at least one stage of
// words.
Plan make_plan(int M, int K, int N, int sms) {
  const int kw = (K + 31) / 32;
  int bm = DecodeTile::BM, bn = DecodeTile::BN, kc = DecodeTile::KC;
  int wave = sms * DECODE_PER_SM;
  if (M > 16) {
    const long tiles128 = static_cast<long>((N + PrefillTile::BN - 1) / PrefillTile::BN) *
                          ((M + PrefillTile::BM - 1) / PrefillTile::BM);
    const bool big = M > 64 && kw >= 128 && 8 * tiles128 >= sms;
    bm = big ? PrefillTile::BM : PrefillTile32::BM;
    bn = PrefillTile::BN;
    kc = PrefillTile::KC;
    wave = sms;
  }
  const long tiles = static_cast<long>((N + bn - 1) / bn) * ((M + bm - 1) / bm);
  long splits = tiles > 0 ? wave / tiles : 1;
  if (splits > kw / kc) splits = kw / kc;
  return Plan{bm, bn, splits < 1 ? 1 : static_cast<int>(splits)};
}

template <class T>
cudaError_t launch(const int8_t* a, const uint32_t* wp, int32_t* out, int M, int K, int N,
                   int splits, cudaStream_t stream) {
  static unsigned smem_set = 0;
  cudaError_t err = allow_smem(binary_qmm_kernel<T>, smem_bytes<T>(T::BM), smem_set);
  if (err != cudaSuccess) return err;
  const int KW = (K + 31) / 32;
  const int kw_split = (KW + splits - 1) / splits;
  const int z = kw_split > 0 ? (KW + kw_split - 1) / kw_split : 1;
  const int bmr = M < T::BM ? M : T::BM;
  const uintptr_t base = reinterpret_cast<uintptr_t>(a);
  const int a_mode = (K % 16 == 0 && base % 16 == 0) ? 16 : (K % 4 == 0 && base % 4 == 0) ? 4 : 1;
  const int b_vec = N % 4 == 0 && reinterpret_cast<uintptr_t>(wp) % 16 == 0;
  dim3 grid((N + T::BN - 1) / T::BN, (M + T::BM - 1) / T::BM, z);
  binary_qmm_kernel<T><<<grid, T::THREADS, smem_bytes<T>(bmr), stream>>>(
      a, wp, out, M, K, N, KW, kw_split, bmr, a_mode, b_vec);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// The launch's plan for (M, K, N) on a device of `sms` SMs: plan[0..2] =
// block rows, block columns, K splits.  With more than one split the
// blocks add into out, which must start at zero.
void binary_qmm_plan(int M, int K, int N, int sms, int* plan) {
  const Plan p = make_plan(M, K, N, sms);
  plan[0] = p.bm;
  plan[1] = p.bn;
  plan[2] = p.splits;
}

// Returns the cudaError_t of the launch.  out must be zeroed by the caller
// when binary_qmm_plan gives more than one split.
int binary_qmm_launch(const void* a, const void* w_packed, void* out, int M, int K, int N,
                      int sms, void* stream) {
  const Plan p = make_plan(M, K, N, sms);
  auto s = static_cast<cudaStream_t>(stream);
  auto pa = static_cast<const int8_t*>(a);
  auto pw = static_cast<const uint32_t*>(w_packed);
  auto po = static_cast<int32_t*>(out);
  if (p.bm == DecodeTile::BM) return launch<DecodeTile>(pa, pw, po, M, K, N, p.splits, s);
  if (p.bm == PrefillTile32::BM) return launch<PrefillTile32>(pa, pw, po, M, K, N, p.splits, s);
  return launch<PrefillTile>(pa, pw, po, M, K, N, p.splits, s);
}

}  // extern "C"
