// binary_attn: rank-4 AND-popcount attention scores over packed Q / K planes.
//
// Replaces no Pallas kernel: the reference computes these scores in plain
// jnp, src/repro/kernels/binary_attn.py (binary_attn_scores_planes, :39),
// the "binary" core of its scores backend family.  Same function as
// repro_torch.kernels.ref.binary_attn_scores_ref:
//     out[b, h, s, t] = sum_w popc(q[b, h, s, w] & k[b, h / (H/G), t, w])
// q (B, H, S, DW) and k (B, G, T, DW) are 32-bit words of 1-bit mantissas
// packed along d_head, read through their strides (the last one 1): the K
// operand is the packed K cache (B, T, kvH, DW) seen as (B, kvH, T, DW),
// read in place, with no copy of the cache in each layer and step.  out
// (B, H, S, T) int32, contiguous.  The affine epilogue back to real-valued
// scores runs after the kernel (repro_torch.models.attention).
//
// What bounds it on an H100: the int32 output, at every shape of
// chip_smoke.py [12a].  Per output it reads at most 2 * DW words, shared by
// a tile, and writes one: bit-bert-base's decode (4 x 12 heads x 1 x 512
// keys, dh 64) writes 98 KB (0.09 us at 3.35 TB/s), its 128-token prefill
// 786 KB (0.24 us), a GQA decode (32 heads over 8, dh 128) 262 KB (0.16
// us), MLA's latent decode (16 heads x 2,048 keys, dh 512) 524 KB beside
// 524 KB of K (0.31 us), bit-bert's 512-token prefill 12.6 MB (3.8 us),
// granite-8b's 1,024-token prefill (32 heads over 8, dh 128) 134 MB (40
// us), MLA's latent decode over 32,768 keys 8.4 MB beside 8.4 MB of K (5
// us).  The binary tensor cores need under 1 us for the largest.  So the
// decodes and the 128-token prefill are set by a launch and one pass's
// latency, the long prefills by the rate the output reaches device memory
// (out.fill_ of the same bytes is the yardstick), the long decode by its K
// loads' latency as much as by its bytes.
//
// Design.  It replaces an earlier __popc loop on the CUDA cores (128 keys a
// block, one a thread: 24 blocks at bit-bert's prefill, 64 at MLA's decode,
// two barriers a 32-word pass, each Q word read from shared memory once a
// row; it turned the tensor cores down because dh 64's two words pad to a
// k-step's eight, but the padding costs only tensor-core time, which is
// not what bounds the kernel).
//  * The sums run on the binary tensor cores, mma.sync m16n8k256 .b1
//    .and.popc (qmm_mma.cuh mma_b1), on the packed words as they lie.  Keys
//    are the fragment's 16 rows (ldmatrix x4 from the K tile), folded query
//    rows its 8 columns (32-bit loads from the Q tile): each operand's row
//    is contiguous along d_head.  A k-step takes 8 words: dh 64 uses 2,
//    dh 128 4, MLA's 512 fills two steps.  Q's words past DW are zeroed in
//    registers, so whatever a tile holds there ANDs to 0; nothing is read
//    past a row.
//  * Each kv head's query group is folded onto the rows, m = x * S + s for
//    query head g * (H/G) + x, as the reference folds it, so the H/G heads
//    of a group share every K tile.  A tile is RT folded rows x KT keys of
//    one (b, g), RT in {8, 16, 32, 64}, KT in {32, 64, 128}: one or two
//    16-key x 8-row fragments a warp, at most 4 warps.
//  * The plan comes from Python (kernels/binary_attn.py::plan): the largest
//    tile whose count fills the 132 SMs, on a grid (key tile groups, row
//    tiles, B * G).  A block loads its Q tile once and walks `per`
//    consecutive key tiles through a ring of up to 3 K tiles, the next
//    tiles' cp.async copies in flight while the current one is multiplied
//    and stored.  The plan walks (up to 4) only at a decode, where a K tile
//    weighs as much as its output: there it was 10-20% faster on an H100;
//    at every prefill measured one key tile a block was as fast or faster,
//    the SM overlapping one block's loads with another's stores.
//  * Copies: cp.async of 16, 8 or 4 bytes, as DW, the strides and the base
//    addresses allow; rows past M or T are not loaded (they reach only
//    outputs never stored).  Tile rows are DW rounded up to 8 words plus 4,
//    so ldmatrix's and the Q loads' 8 rows hit 32 distinct banks.  (TMA does
//    not fit: at dh 64 a K row is 8 bytes inside a 96-byte cache row, under
//    a TMA box's 16-byte inner extent.)
//  * Stores: lane (g, t) holds keys g and g + 8 of rows 2t and 2t + 1 of a
//    fragment, so a warp's 8-row slice goes through a small shared buffer
//    and out as 16 bytes a lane, whole 128-byte lines along T where the
//    warp holds 32 keys (4-byte stores straight from the fragments, 32-byte
//    sectors, were slower at the long prefills).  Ragged T past a multiple
//    of 4 is stored a word at a time.
#include "qmm_mma.cuh"

namespace {

using namespace qmm;

constexpr int kMaxStages = 3;

struct Args {
  const uint32_t* q;
  const uint32_t* k;
  int32_t* out;
  int H, G, S, T, DW, M, hg;  // M = hg * S folded rows, hg = H / G
  long long qb, qh, qs, kb, kg, kt;
  int ld, ksteps;             // tile row stride in words (DW rounded up to 8, plus 4); 8-word k-steps
  int key_tiles, per;         // key tiles; a block walks `per` of them
  int ring;                   // stages in the ring (2 or 3)
  int qvec, kvec;             // words a cp.async: 4, 2 or 1
  int qdr, qdc, kdr, kdc;     // a thread's step through a tile's copies (Walk)
};

// 8 bytes from src to shared dst.
__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s), "l"(src));
}

// A thread's share of a tile's copies: chunks (r, c) from (r0, c0), then
// every `threads`-th, cpr chunks of V words a row -- no division a copy.
struct Walk {
  int r0, c0, dr, dc, cpr;
};

__device__ __forceinline__ Walk make_walk(int tid, int cpr, int dr, int dc) {
  return cpr == 1 ? Walk{tid, 0, dr, dc, 1} : Walk{tid / cpr, tid % cpr, dr, dc, cpr};
}

// Rows 0 .. min(rows, valid) - 1 of DW words into a tile of row stride ld,
// V words a copy; row r comes from base + off(r).  Rows past `valid` are
// not loaded: they reach only outputs that are never stored.
template <int V, class Off>
__device__ __forceinline__ void copy_rows(uint32_t* dst, int ld, const uint32_t* base, int rows,
                                          int valid, const Walk& w, Off off) {
  const int n = min(rows, valid);
  for (int r = w.r0, c = w.c0; r < n;) {
    const uint32_t* src = base + off(r) + c * V;
    if constexpr (V == 4) cp_async16(dst + r * ld + c * V, src, true);
    else if constexpr (V == 2) cp_async8(dst + r * ld + c * V, src);
    else cp_async4(dst + r * ld + c * V, src, true);
    r += w.dr;
    c += w.dc;
    if (c >= w.cpr) {
      c -= w.cpr;
      ++r;
    }
  }
}

template <class Off>
__device__ __forceinline__ void copy_rows_v(int vec, uint32_t* dst, int ld, const uint32_t* base,
                                            int rows, int valid, const Walk& w, Off off) {
  if (vec == 4) copy_rows<4>(dst, ld, base, rows, valid, w, off);
  else if (vec == 2) copy_rows<2>(dst, ld, base, rows, valid, w, off);
  else copy_rows<1>(dst, ld, base, rows, valid, w, off);
}

// RT folded rows x KT keys a tile; warps WK along the keys x WR along the
// rows, each MI 16-key x NI 8-row fragments, and an 8-row buffer of its KW
// keys for the stores.
template <int RT_, int KT_>
struct AttnTile {
  static constexpr int RT = RT_, KT = KT_;
  static constexpr int WK = KT / 16 < 4 ? KT / 16 : 4;
  static constexpr int WR = RT / 8 < 4 / WK ? RT / 8 : 4 / WK;
  static constexpr int THREADS = 32 * WK * WR;
  static constexpr int MI = KT / 16 / WK, NI = RT / 8 / WR;
  static constexpr int KW = 16 * MI;  // a warp's keys
  static constexpr int OLD = KW + 4;  // buffer row stride in words: its writes hit 32 banks
  static_assert(MI * 16 * WK == KT && NI * 8 * WR == RT, "tile shape");
};

template <class T>
__global__ void __launch_bounds__(T::THREADS)
binary_attn_scores_planes_kernel(const Args a) {
  constexpr int RT = T::RT, KT = T::KT, MI = T::MI, NI = T::NI;
  extern __shared__ __align__(16) uint32_t smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wk = warp % T::WK, wr = warp / T::WK;
  const int g8 = lane >> 2, t4 = lane & 3;
  const int ld = a.ld;
  // This block: folded rows m0 .. m0 + RT - 1 of (b, g), key tiles kt0 ..
  // kt0 + n - 1.
  const int m0 = blockIdx.y * RT, kt0 = blockIdx.x * a.per;
  const int n = min(a.per, a.key_tiles - kt0);
  const int b = blockIdx.z / a.G, g = blockIdx.z - b * a.G;
  // Shared memory: the Q tile (loaded once), each warp's store buffer, the
  // K tiles' ring (as many slots as the plan's stages).
  uint32_t* sq = smem;
  uint32_t* obuf = smem + RT * ld + warp * 8 * T::OLD;
  uint32_t* ring = smem + RT * ld + (T::THREADS / 32) * 8 * T::OLD;

  // Stage j: key tile kt0 + j into ring slot j % ring; the Q tile with the first.
  auto load = [&](int j) {
    if (j < n) {
      if (j == 0) {
        const uint32_t* qbase = a.q + b * a.qb + static_cast<long long>(g) * a.hg * a.qh;
        const Walk qw = make_walk(tid, a.DW / a.qvec, a.qdr, a.qdc);
        const int S = a.S;
        const long long qh = a.qh, qs = a.qs;
        if (S == 1) {
          copy_rows_v(a.qvec, sq, ld, qbase, RT, a.M - m0, qw, [=](int r) { return (m0 + r) * qh; });
        } else if (S >= RT) {  // a tile's rows wrap past S at most once
          const int x0 = m0 / S, s0 = m0 - x0 * S;
          copy_rows_v(a.qvec, sq, ld, qbase, RT, a.M - m0, qw, [=](int r) {
            const int s = s0 + r, wrap = s >= S;
            return (x0 + wrap) * qh + (s - (wrap ? S : 0)) * qs;
          });
        } else {
          copy_rows_v(a.qvec, sq, ld, qbase, RT, a.M - m0, qw, [=](int r) {
            const int m = m0 + r, x = m / S;
            return x * qh + (m - x * S) * qs;
          });
        }
      }
      const int t0 = (kt0 + j) * KT;
      const long long kt = a.kt;
      copy_rows_v(a.kvec, ring + (j % a.ring) * KT * ld, ld,
                  a.k + b * a.kb + g * a.kg + static_cast<long long>(t0) * kt, KT, a.T - t0,
                  make_walk(tid, a.DW / a.kvec, a.kdr, a.kdc), [=](int r) { return r * kt; });
    }
    cp_async_commit();
  };

  int32_t* obase = a.out + (static_cast<long long>(b) * a.H + g * a.hg) * a.S * a.T;
  for (int j = 0; j < a.ring - 1; ++j) load(j);
  for (int j = 0; j < n; ++j) {
    if (a.ring == 3) cp_async_wait<1>();
    else cp_async_wait<0>();
    __syncthreads();          // tile j has landed; every warp is done with tile j - 1
    load(j + a.ring - 1);     // into tile j - 1's slot
    const uint32_t* sk = ring + (j % a.ring) * KT * ld;

    int acc[MI][NI][4];
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
#pragma unroll
      for (int ni = 0; ni < NI; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0;

    // Words past DW of the last k-step are whatever the tiles hold; Q's
    // are zeroed in registers, so their AND with K's is 0.
    for (int kk = 0; kk < a.ksteps; ++kk) {
      const bool lo = kk * 8 + t4 < a.DW, hi = kk * 8 + 4 + t4 < a.DW;
      uint32_t af[MI][4], bf[NI][2];
#pragma unroll
      for (int mi = 0; mi < MI; ++mi) {
        const int row = (wk * MI + mi) * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
        ldsm_x4(af[mi][0], af[mi][1], af[mi][2], af[mi][3], sk + row * ld + kk * 8 + (lane >> 4) * 4);
      }
#pragma unroll
      for (int ni = 0; ni < NI; ++ni) {
        const uint32_t* col = sq + ((wr * NI + ni) * 8 + g8) * ld + kk * 8 + t4;
        bf[ni][0] = lo ? col[0] : 0u;
        bf[ni][1] = hi ? col[4] : 0u;
      }
#pragma unroll
      for (int mi = 0; mi < MI; ++mi)
#pragma unroll
        for (int ni = 0; ni < NI; ++ni) mma_b1(acc[mi][ni], af[mi], bf[ni][0], bf[ni][1]);
    }

    // Lane (g8, t4) holds keys g8 and g8 + 8 of rows 2 t4 and 2 t4 + 1 of
    // each fragment.  Each 8-row slice goes through the warp's buffer (rows
    // OLD words apart), then out 4 keys (16 bytes) a lane, KW / 4 lanes a
    // row: whole 128-byte lines along T where the warp has 32 keys.
    constexpr int LPR = T::KW / 4, RPI = 32 / LPR;
    const int orow = lane / LPR, ocol = (lane % LPR) * 4;
    const int wm0 = m0 + wr * NI * 8, t = (kt0 + j) * KT + wk * T::KW + ocol;
    const bool vec = (a.T & 3) == 0 && t + 3 < a.T;
#pragma unroll
    for (int ni = 0; ni < NI; ++ni) {
#pragma unroll
      for (int mi = 0; mi < MI; ++mi)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          obuf[(2 * t4 + (e & 1)) * T::OLD + mi * 16 + g8 + 8 * (e >> 1)] = acc[mi][ni][e];
      __syncwarp();
#pragma unroll
      for (int i = 0; i < 8 / RPI; ++i) {
        const int r = i * RPI + orow, m = wm0 + ni * 8 + r;
        if (m < a.M && t < a.T) {
          const int4 v = *reinterpret_cast<const int4*>(obuf + r * T::OLD + ocol);
          int32_t* o = obase + static_cast<long long>(m) * a.T + t;
          if (vec) {
            *reinterpret_cast<int4*>(o) = v;
          } else {
            o[0] = v.x;
            if (t + 1 < a.T) o[1] = v.y;
            if (t + 2 < a.T) o[2] = v.z;
            if (t + 3 < a.T) o[3] = v.w;
          }
        }
      }
      __syncwarp();
    }
  }
  cp_async_wait<0>();
}

// Words a cp.async for rows at p, strides s0..s2 (in words) and DW words a row.
int vec_words(const void* p, int dw, long long s0, long long s1, long long s2) {
  for (int v = 4; v > 1; v /= 2)
    if (dw % v == 0 && s0 % v == 0 && s1 % v == 0 && s2 % v == 0 &&
        reinterpret_cast<uintptr_t>(p) % (4 * v) == 0)
      return v;
  return 1;
}

template <int RT, int KT>
cudaError_t launch(Args a, int B, int stages, cudaStream_t s) {
  using T = AttnTile<RT, KT>;
  static unsigned smem_set = 0;
  a.qdr = T::THREADS / (a.DW / a.qvec);
  a.qdc = T::THREADS % (a.DW / a.qvec);
  a.kdr = T::THREADS / (a.DW / a.kvec);
  a.kdc = T::THREADS % (a.DW / a.kvec);
  const size_t smem = (static_cast<size_t>(RT + stages * KT) * a.ld + (T::THREADS / 32) * 8 * T::OLD) * 4;
  const cudaError_t err = allow_smem(binary_attn_scores_planes_kernel<T>, smem, smem_set);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.key_tiles + a.per - 1) / a.per, (a.M + RT - 1) / RT, B * a.G);
  binary_attn_scores_planes_kernel<T><<<grid, T::THREADS, smem, s>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Returns the cudaError_t of the launch.  Every count must be positive, G
// must divide H, and strides are in words.  The plan (kernels/
// binary_attn.py::plan): rows x keys a tile, `per` key tiles a block,
// `stages` K tiles in its ring; an RT x KT pair the kernel is not built
// for, a stage count outside 1..3, or 1 stage where a block walks more
// than one tile, is cudaErrorInvalidValue.
int binary_attn_launch(const void* q, const void* k, void* out, int B, int H, int G, int S,
                       int T, int DW, long long qb, long long qh, long long qs, long long kb,
                       long long kg, long long kt, int rows, int keys, int per, int stages,
                       void* stream) {
  if (stages < 1 || stages > kMaxStages || per < 1 || (stages == 1 && per > 1))
    return cudaErrorInvalidValue;
  Args a{static_cast<const uint32_t*>(q), static_cast<const uint32_t*>(k),
         static_cast<int32_t*>(out), H, G, S, T, DW, (H / G) * S, H / G, qb, qh, qs, kb, kg, kt};
  a.ksteps = (DW + 7) / 8;
  a.ld = a.ksteps * 8 + 4;
  a.key_tiles = (T + keys - 1) / keys;
  a.per = per;
  a.ring = stages < 2 ? 2 : stages;
  a.qvec = vec_words(q, DW, qb, qh, qs);
  a.kvec = vec_words(k, DW, kb, kg, kt);
  auto s = static_cast<cudaStream_t>(stream);
#define BINARY_ATTN_TILE(R, K) \
  if (rows == R && keys == K) return launch<R, K>(a, B, stages, s);
  BINARY_ATTN_TILE(64, 128) BINARY_ATTN_TILE(64, 64) BINARY_ATTN_TILE(64, 32)
  BINARY_ATTN_TILE(32, 128) BINARY_ATTN_TILE(32, 64) BINARY_ATTN_TILE(32, 32)
  BINARY_ATTN_TILE(16, 128) BINARY_ATTN_TILE(16, 64) BINARY_ATTN_TILE(16, 32)
  BINARY_ATTN_TILE(8, 128) BINARY_ATTN_TILE(8, 64) BINARY_ATTN_TILE(8, 32)
#undef BINARY_ATTN_TILE
  return cudaErrorInvalidValue;
}

}  // extern "C"
