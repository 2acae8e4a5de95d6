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
// What bounds it on an H100: the int32 output.  A bit-bert-base decode
// (4 x 12 heads x 1 x 512 keys, 2 words a row) writes 98 KB and reads
// 196 KB of K: about 0.1 us at 3.35 TB/s, against 2 x 64 binary operations
// an output.  So the launch and one pass's latency set the time.
//
// Design (simple and exact; the binary tensor cores, mma.sync m16n8k256,
// would pad d_head 64's two words to eight):
//  * Each kv head's query group is folded onto the rows, m = x * S + s for
//    query head g * (H/G) + x, as the reference folds it: the H/G heads of
//    a group share every K row the block loads.
//  * A block owns 128 keys (one a thread) of one (b, g) and up to R folded
//    rows, R the smallest of 1, 4, 16, 64 that holds them all (64 rows a
//    block past that).  K rows and Q rows are staged in shared memory 32
//    words of d_head at a time; the K tile's rows are padded to 33 words,
//    so a warp's reads of its 32 keys' word w hit 32 banks, and every
//    thread reads the same Q word (a broadcast).  Each thread keeps R sums
//    in registers.
//  * Ragged S, T and DW are masked by counts, not padded: rows past M and
//    keys past T are neither loaded nor written, and the last pass stages
//    only the words left.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kKeys = 128;  // keys a block, one a thread
constexpr int kWords = 32;  // words of d_head staged a pass

struct Args {
  const uint32_t* q;
  const uint32_t* k;
  int32_t* out;
  int H, G, S, T, DW, M;  // M = (H / G) * S folded rows
  long long qb, qh, qs, kb, kg, kt;
};

template <int R>
__global__ void __launch_bounds__(kKeys) binary_attn_scores_planes_kernel(const Args a) {
  __shared__ uint32_t ks[kKeys][kWords + 1];
  __shared__ uint32_t qt[R][kWords];
  const int tid = threadIdx.x;
  const int t0 = blockIdx.x * kKeys;
  const int m0 = blockIdx.y * R;
  const int b = blockIdx.z / a.G, g = blockIdx.z % a.G;
  const int hg = a.H / a.G;
  const int keys = min(kKeys, a.T - t0);
  const int rows = min(R, a.M - m0);
  const uint32_t* kbase = a.k + b * a.kb + g * a.kg;
  const uint32_t* qbase = a.q + b * a.qb + static_cast<long long>(g) * hg * a.qh;

  int acc[R];
#pragma unroll
  for (int r = 0; r < R; ++r) acc[r] = 0;

  for (int w0 = 0; w0 < a.DW; w0 += kWords) {
    const int nw = min(kWords, a.DW - w0);
    for (int i = tid; i < keys * nw; i += kKeys) {
      const int row = i / nw, w = i - row * nw;
      ks[row][w] = kbase[static_cast<long long>(t0 + row) * a.kt + w0 + w];
    }
    for (int i = tid; i < rows * nw; i += kKeys) {
      const int r = i / nw, w = i - r * nw;
      const int m = m0 + r, x = m / a.S, s = m - x * a.S;
      qt[r][w] = qbase[x * a.qh + s * a.qs + w0 + w];
    }
    __syncthreads();
    if (tid < keys) {
      for (int w = 0; w < nw; ++w) {
        const uint32_t kw = ks[tid][w];
#pragma unroll
        for (int r = 0; r < R; ++r) acc[r] += __popc(qt[r][w] & kw);
      }
    }
    __syncthreads();
  }
  if (tid < keys) {
    int32_t* o = a.out + ((static_cast<long long>(b) * a.H + g * hg) * a.S + m0) * a.T + t0 + tid;
#pragma unroll
    for (int r = 0; r < R; ++r)
      if (r < rows) o[static_cast<long long>(r) * a.T] = acc[r];
  }
}

int rows_per_block(int M) {
  if (M <= 1) return 1;
  if (M <= 4) return 4;
  if (M <= 16) return 16;
  return 64;
}

template <int R>
cudaError_t launch(const Args& a, int B, cudaStream_t s) {
  dim3 grid((a.T + kKeys - 1) / kKeys, (a.M + R - 1) / R, B * a.G);
  binary_attn_scores_planes_kernel<R><<<grid, kKeys, 0, s>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// The launch's plan for M folded rows, T keys and BG = B * G (b, g) pairs:
// plan[0..4] = rows a block, keys a block, grid x, y, z.
void binary_attn_plan(int M, int T, int BG, int* plan) {
  const int r = rows_per_block(M);
  plan[0] = r;
  plan[1] = kKeys;
  plan[2] = (T + kKeys - 1) / kKeys;
  plan[3] = (M + r - 1) / r;
  plan[4] = BG;
}

// Returns the cudaError_t of the launch.  Every count must be positive,
// G must divide H, and strides are in words.
int binary_attn_launch(const void* q, const void* k, void* out, int B, int H, int G, int S,
                       int T, int DW, long long qb, long long qh, long long qs, long long kb,
                       long long kg, long long kt, void* stream) {
  const Args a{static_cast<const uint32_t*>(q), static_cast<const uint32_t*>(k),
               static_cast<int32_t*>(out), H, G, S, T, DW, (H / G) * S, qb, qh, qs, kb, kg, kt};
  auto s = static_cast<cudaStream_t>(stream);
  switch (rows_per_block(a.M)) {
    case 1: return launch<1>(a, B, s);
    case 4: return launch<4>(a, B, s);
    case 16: return launch<16>(a, B, s);
    default: return launch<64>(a, B, s);
  }
}

}  // extern "C"
