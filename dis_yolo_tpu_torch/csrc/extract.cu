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
// Per (image b, row r, column tile) block: the threads read the tile's
// TC*k*k contiguous input values (coalesced) into shared memory as f32,
// then write the k*k output rows' TC columns (coalesced; the shared
// reads stride k*k, which is odd and conflict-free for odd k).
//
// Exactness: bf16 -> f32 is the exact bit widening (bits << 16), and f32
// is copied, so the output is bit-exact against the plain version.
//
// Bound on an H100 SXM (3.35 TB/s): pure data movement, each input read
// once and each output written once.  At S=288, k=3, B=1: 1.49 MB of
// bf16 in + 2.99 MB of f32 out, about 1.34 us (1.78 us for f32 in).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kSmemFloats = 8192;      // 32 KB: TC * k*k values per block

template <typename T>
__device__ __forceinline__ float widen(T v);

template <>
__device__ __forceinline__ float widen<float>(float v) { return v; }

template <>
__device__ __forceinline__ float widen<uint16_t>(uint16_t v) {
  return __uint_as_float(((uint32_t)v) << 16);     // bf16 bits -> f32
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
extract_kernel(const T* __restrict__ in, float* __restrict__ out, int size,
               int kk, int tc) {
  __shared__ float tile[kSmemFloats];
  const int c0 = blockIdx.x * tc;
  const int r = blockIdx.y;
  const int b = blockIdx.z;
  const int cols = min(tc, size - c0);
  const int n = cols * kk;
  const T* src = in + ((size_t)b * size + r) * (size_t)size * kk
                 + (size_t)c0 * kk;
  for (int i = threadIdx.x; i < n; i += kThreads) tile[i] = widen<T>(src[i]);
  __syncthreads();
  float* dst = out + (size_t)b * kk * size * size + (size_t)r * size + c0;
  const size_t plane = (size_t)size * size;
  for (int i = threadIdx.x; i < kk * cols; i += kThreads) {
    const int ch = i / cols;
    const int c = i - ch * cols;
    dst[ch * plane + c] = tile[c * kk + ch];
  }
}

}  // namespace

// in [B, S, S*kk] (bf16 bits when in_bf16 != 0, else f32), out [B, kk, S, S]
// f32.  Returns the cudaError_t of the launch (0 on success).
extern "C" int dis_extract_planes(const void* in, float* out, int batch,
                                  int size, int kk, int in_bf16,
                                  void* stream) {
  if (kk < 1 || kk > kSmemFloats / 32) return (int)cudaErrorInvalidValue;
  if (batch == 0 || size == 0) return 0;
  // widest column tile (a multiple of 32, at most 128) that fits
  int tc = (kSmemFloats / kk) / 32 * 32;
  tc = tc < 128 ? tc : 128;
  const dim3 grid((size + tc - 1) / tc, size, batch);
  if (in_bf16) {
    extract_kernel<uint16_t><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        (const uint16_t*)in, out, size, kk, tc);
  } else {
    extract_kernel<float><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        (const float*)in, out, size, kk, tc);
  }
  return (int)cudaGetLastError();
}
