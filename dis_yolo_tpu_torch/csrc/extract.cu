// Score-map channel extraction: kernel K4.
//
// Replaces the Pallas TPU kernel of dis_yolo_tpu/ops/pallas_assembly.py
// (_extract_kernel/_extract_planes, reached through assemble_masks_pallas
// with use_extract=True): the exact selection
//
//   out[b, ch, r, c] = in[b, r, c * k*k + ch]
//
// of a batch of head outputs [B, S, S*k*k] (bf16 or f32; the free reshape
// of the NHWC [B, S, S, k*k] map) into channel planes [B, k*k, S, S] f32,
// the layout K1 reads in its planes mode.  The TPU kernel did it as one
// one-hot MXU matmul per channel, exact because each output is a single
// input; here it is a copy.  The TPU's VMEM fit test (_extract_fits) and
// its layout knobs (force_tiled, operand_barrier) have no counterpart:
// this kernel runs at every S.
//
// Bound on an H100 SXM (3.35 TB/s): pure data movement, each input read
// once and each output written once.  At S=288, k=3, B=1: 1.49 MB of
// bf16 in + 2.99 MB of f32 out, about 1.34 us (1.78 us for f32 in).  At
// that size the call is about one round trip to memory plus the launch,
// so what counts is that every block issues all its loads at once, waits
// once, and stores in wide transactions.
//
// Design.  One block of 128 threads per (image b, row r, column tile) of
// about 864 inputs (96 pixels at k=3, three tiles per row), so at S=288
// the grid is 864 small blocks, all resident at once: each block's chain
// (load, wait, scatter, barrier, store) is short, and the 132 SMs share
// the blocks evenly.  Whole-row tiles of 256 threads (288 blocks) were
// slower on the card.
//   * Load: the tile's TC*k*k contiguous inputs as 16-byte vector loads
//     (8 bf16 or 4 f32 a thread), up to kUnroll of them per thread issued
//     before any is used, with a scalar head and tail for the elements
//     before the first 16-byte boundary and after the last (an input view
//     at a storage offset, a row length S*k*k*itemsize not a multiple of
//     16, odd k*k).
//   * bf16 is widened by the 16-bit shift, which is exact, and each value
//     is scattered into its channel's plane row in shared memory,
//     [k*k][TCp] f32 with TCp = TC rounded up to 8, plus 4: the stride
//     keeps the scatter at about two-way bank conflicts for k=3 (one-way
//     would need a stride that breaks 16-byte alignment).
//   * Store: each of the k*k plane rows (TC f32, 384 B at S=288) with
//     16-byte stores, read as 16-byte vectors from shared memory.  A plane
//     row whose start is not 16-byte aligned (S odd) is kept in shared
//     memory shifted by the same number of floats, so its body still moves
//     in 16-byte vectors and only its head and tail (at most 3 floats
//     each) are scalar.
//   * Dynamic shared memory is sized to the tile (3.6 KB at S=288, k=3).
//
// Exactness: bf16 -> f32 is the exact bit widening (bits << 16), and f32
// is copied, so the output is bit-exact against the plain version.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kTileElems = 864;        // inputs per block: 96 pixels at k=3
constexpr int kUnroll = 4;             // 16-byte loads in flight per thread
constexpr int kMaxKK = 256;            // k <= 16
constexpr int kSmemBytes = 45056;      // tile budget, under the 48 KB default

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(uint16_t v) {
  return __uint_as_float(((uint32_t)v) << 16);     // bf16 bits -> f32
}

// the per-element values of one 16-byte chunk
__device__ __forceinline__ void unpack(const uint4& v, const float*,
                                       float (&f)[4]) {
  f[0] = __uint_as_float(v.x);
  f[1] = __uint_as_float(v.y);
  f[2] = __uint_as_float(v.z);
  f[3] = __uint_as_float(v.w);
}
__device__ __forceinline__ void unpack(const uint4& v, const uint16_t*,
                                       float (&f)[8]) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);             // low half first
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
extract_kernel(const T* __restrict__ in, float* __restrict__ out, int size,
               int kk, int tc, int tcp) {
  extern __shared__ float4 smem4[];
  float* tile = reinterpret_cast<float*>(smem4);    // [kk][tcp]
  constexpr int kPer = 16 / sizeof(T);              // values per 16 bytes
  const int c0 = blockIdx.x * tc;
  const int r = blockIdx.y;
  const int b = blockIdx.z;
  const int cols = min(tc, size - c0);
  const int n = cols * kk;
  const size_t plane = (size_t)size * size;
  const T* src = in + (((size_t)b * size + r) * size + c0) * kk;
  float* dst0 = out + ((size_t)b * kk * size + r) * size + c0;
  // plane ch's row starts (sh0 + ch * S*S) mod 4 floats past a 16-byte
  // boundary; it is kept in shared memory at the same offset mod 4
  const int sh0 = (int)(((uintptr_t)dst0 >> 2) & 3);
  const int ssq = (int)(plane & 3);

  int head = (int)(((16 - ((uintptr_t)src & 15)) & 15) / sizeof(T));
  head = min(head, n);
  const int nv = (n - head) / kPer;

  // input element e is pixel e / kk, channel e % kk
  auto put = [&](int c, int ch, float v) {
    tile[ch * tcp + ((sh0 + ch * ssq) & 3) + c] = v;
  };
  const uint4* src4 = reinterpret_cast<const uint4*>(src + head);
  for (int j0 = threadIdx.x; j0 < nv; j0 += kUnroll * kThreads) {
    uint4 v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int j = j0 + u * kThreads;
      if (j < nv) v[u] = __ldg(src4 + j);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int j = j0 + u * kThreads;
      if (j < nv) {
        float f[kPer];
        unpack(v[u], src, f);
        const int e = head + j * kPer;
        int c = e / kk, ch = e - c * kk;
#pragma unroll
        for (int i = 0; i < kPer; ++i) {
          put(c, ch, f[i]);
          if (++ch == kk) { ch = 0; ++c; }
        }
      }
    }
  }
  for (int e = threadIdx.x; e < head; e += kThreads)
    put(e / kk, e % kk, widen(src[e]));
  for (int e = head + nv * kPer + threadIdx.x; e < n; e += kThreads)
    put(e / kk, e % kk, widen(src[e]));
  __syncthreads();

  // plane rows: 16-byte body, then the scalar heads and tails
  const int nvo_max = cols >> 2;
  for (int i = threadIdx.x; i < kk * nvo_max; i += kThreads) {
    const int ch = i / nvo_max;
    const int j = i - ch * nvo_max;
    const int sh = (sh0 + ch * ssq) & 3;
    const int hd = min((4 - sh) & 3, cols);
    if (j < (cols - hd) >> 2) {
      const float4 v =
          *reinterpret_cast<const float4*>(tile + ch * tcp + sh + hd + 4 * j);
      *reinterpret_cast<float4*>(dst0 + ch * plane + hd + 4 * j) = v;
    }
  }
  for (int i = threadIdx.x; i < kk * 8; i += kThreads) {
    const int ch = i >> 3;
    const int q = i & 7;
    const int sh = (sh0 + ch * ssq) & 3;
    const int hd = min((4 - sh) & 3, cols);
    const int e = q < 4 ? q : hd + ((cols - hd) & ~3) + (q - 4);
    if (q < 4 ? q < hd : e < cols)
      dst0[ch * plane + e] = tile[ch * tcp + sh + e];
  }
}

}  // namespace

// in [B, S, S*kk] (bf16 bits when in_bf16 != 0, else f32), out [B, kk, S, S]
// f32.  Returns the cudaError_t of the launch (0 on success).
extern "C" int dis_extract_planes(const void* in, float* out, int batch,
                                  int size, int kk, int in_bf16,
                                  void* stream) {
  if (kk < 1 || kk > kMaxKK) return (int)cudaErrorInvalidValue;
  if (batch == 0 || size == 0) return 0;
  // column tiles of about kTileElems inputs, no wider than the kk padded
  // plane rows that fit the budget, split evenly over the row
  const int tcp_max = kSmemBytes / (4 * kk);
  int tc = (kTileElems + kk - 1) / kk;
  tc = tc < (tcp_max - 4) / 8 * 8 ? tc : (tcp_max - 4) / 8 * 8;
  const int n_tiles = (size + tc - 1) / tc;
  tc = (size + n_tiles - 1) / n_tiles;
  const int tcp = (tc + 7) / 8 * 8 + 4;
  const size_t smem = sizeof(float) * kk * tcp;
  const dim3 grid(n_tiles, size, batch);
  if (in_bf16) {
    extract_kernel<uint16_t><<<grid, kThreads, smem, (cudaStream_t)stream>>>(
        (const uint16_t*)in, out, size, kk, tc, tcp);
  } else {
    extract_kernel<float><<<grid, kThreads, smem, (cudaStream_t)stream>>>(
        (const float*)in, out, size, kk, tc, tcp);
  }
  return (int)cudaGetLastError();
}
