// Position-sensitive mask assembly (+ sigmoid), forward: kernel K1.
//
// Replaces the Pallas TPU kernels of dis_yolo_tpu/ops/pallas_assembly.py
// (_assembly_kernel/_assemble_one/_bin_indicators, the resident layout, and
// _assembly_tiled_kernel, the row-tiled layout, both through _call_assembly).
// One kernel serves every score-map size S: the TPU needed two layouts for
// its 16 MB of VMEM, a Hopper block only needs a row tile of one box.
//
// Per (image b, box d, row tile t) block:
//   * thread 0 rounds the normalized box to score-map pixels
//     (round(norm * S), half to even) -- or, in pixel-box mode (the
//     training forward, _assembly_px), takes the already-rounded pixel box
//     as it is -- and computes the k+1 grid lines per axis,
//     g_i = round(y1 + i * (y2 - y1) / k), into shared memory;
//   * a tile that the box's row span misses, and every padding row (a zero
//     box), writes zeros with no bin math (the TPU kernel's `intersects`);
//   * otherwise each thread takes pixels of the tile, finds the half-open
//     row and column bins, reads channel ky*k+kx straight from the NHWC
//     [S, S, k*k] map (no transpose) -- or, in planes mode, from channel
//     planes [k*k, S, S], the layout K4 (extract.cu) writes, as the TPU
//     kernel read _extract_planes' output -- and writes 1/(1+exp(-x))
//     inside the box (or the raw logit) and an exact 0 outside.
//
// Exactness: the grid-line arithmetic uses __fmul_rn/__fdiv_rn/__fadd_rn
// and rintf, and the file is built with -fmad=false, so every rounding
// matches float32 on the CPU bit for bit; the logits are copies of score
// map values, so they are bit-exact too.
//
// Bound on an H100 SXM (3.35 TB/s): the work is pure data movement.  At
// S=288, D=30, B=1 it reads the 3.0 MB score map once and writes 9.95 MB
// of masks: about 3.9 us.  This first version aims at coalesced stores
// along a row; the score-map reads are strided (one channel of nine per
// pixel) and are served from L2 across the 30 boxes of an image.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kMaxK = 16;
constexpr int kThreads = 256;
constexpr int kTileRows = 4;

__device__ __forceinline__ int bin_of(const float* lines, int k, float pos) {
  int b = 0;
  for (int i = 1; i < k; ++i) b += (pos >= lines[i]) ? 1 : 0;
  return b < k - 1 ? b : k - 1;
}

__global__ void __launch_bounds__(kThreads)
assembly_kernel(const float* __restrict__ sm, const float* __restrict__ boxes,
                float* __restrict__ out, int n_box, int size, int k,
                int apply_sigmoid, int pixel_boxes, int planes) {
  __shared__ float gy[kMaxK + 1];
  __shared__ float gx[kMaxK + 1];
  const int tile = blockIdx.x;
  const int d = blockIdx.y;
  const int b = blockIdx.z;
  const int kk = k * k;
  const float fs = (float)size;

  if (threadIdx.x == 0) {
    const float* box = boxes + ((size_t)b * n_box + d) * 4;
    const float y1 = pixel_boxes ? box[0] : rintf(__fmul_rn(box[0], fs));
    const float x1 = pixel_boxes ? box[1] : rintf(__fmul_rn(box[1], fs));
    const float y2 = pixel_boxes ? box[2] : rintf(__fmul_rn(box[2], fs));
    const float x2 = pixel_boxes ? box[3] : rintf(__fmul_rn(box[3], fs));
    const float sub_h = __fdiv_rn(__fsub_rn(y2, y1), (float)k);
    const float sub_w = __fdiv_rn(__fsub_rn(x2, x1), (float)k);
    gy[0] = y1;
    gx[0] = x1;
    for (int i = 1; i < k; ++i) {
      gy[i] = rintf(__fadd_rn(y1, __fmul_rn((float)i, sub_h)));
      gx[i] = rintf(__fadd_rn(x1, __fmul_rn((float)i, sub_w)));
    }
    gy[k] = y2;
    gx[k] = x2;
  }
  __syncthreads();

  const int row0 = tile * kTileRows;
  const int rows = min(kTileRows, size - row0);
  const int n_pix = rows * size;
  float* dst = out + (((size_t)b * n_box + d) * size + row0) * size;
  const float top = gy[0], bottom = gy[k], left = gx[0], right = gx[k];

  // the box's row span misses this tile (padding rows always do)
  if (!(bottom > (float)row0 && top < (float)(row0 + rows))) {
    for (int p = threadIdx.x; p < n_pix; p += kThreads) dst[p] = 0.0f;
    return;
  }

  const float* src = sm + (size_t)b * size * size * kk;
  for (int p = threadIdx.x; p < n_pix; p += kThreads) {
    const int r = row0 + p / size;
    const int c = p - (p / size) * size;
    const float fr = (float)r, fc = (float)c;
    float v = 0.0f;
    if (fr >= top && fr < bottom && fc >= left && fc < right) {
      const int ch = bin_of(gy, k, fr) * k + bin_of(gx, k, fc);
      v = planes ? src[((size_t)ch * size + r) * size + c]
                 : src[((size_t)r * size + c) * kk + ch];
      if (apply_sigmoid) v = 1.0f / (1.0f + expf(-v));
    }
    dst[p] = v;
  }
}

}  // namespace

// scoremaps [B,S,S,k*k] f32 (or [B,k*k,S,S] when planes != 0), boxes
// [B,D,4] f32 yxyx (normalized, or rounded score-map pixels when
// pixel_boxes != 0), out [B,D,S,S] f32.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int dis_assemble_masks(const float* scoremaps,
                                  const float* boxes, float* out,
                                  int batch, int n_box, int size, int k,
                                  int apply_sigmoid, int pixel_boxes,
                                  int planes, void* stream) {
  if (k < 1 || k > kMaxK) return (int)cudaErrorInvalidValue;
  if (batch == 0 || n_box == 0 || size == 0) return 0;
  const dim3 grid((size + kTileRows - 1) / kTileRows, n_box, batch);
  assembly_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      scoremaps, boxes, out, n_box, size, k, apply_sigmoid, pixel_boxes,
      planes);
  return (int)cudaGetLastError();
}
